"""The least time the chip could take for the list scan's work over
``list_scan_ms``: the larger of its bytes at the HBM rate and its operations
at the fp32 rate, counted by ``costs/list_scan.py`` from each traced batch's
probe sets and list lengths as the reference derives them from the
centroids, whatever kernel does the scan."""

from core import peaks


def read(ctx):
    ms = ctx.read("list_scan_ms")
    if ms is None:
        return None
    cost = ctx.module("costs", "list_scan")
    least = cost.per_slot(ctx, lambda ops, nbytes: max(nbytes / peaks.HBM_BYTES_S,
                                                       ops / peaks.FP32_FLOP_S))
    slots = [n % ctx.pool_batches for n in ctx.trace.index]
    return 100.0 * sum(least[s] for s in slots) / len(slots) * 1e3 / ms
