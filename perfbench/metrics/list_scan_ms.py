"""Device time a batch of the list-scan kernels: those defined in the
port's ivf_list_scan*.cu, invert_probes.cu and prefloor.cu, and the merges
of fused_scan.cu (device trace). Nothing where no such kernel ran."""

from core.trace import kernel_base

SOURCES = ("ivf_list_scan", "invert_probes", "prefloor")
MERGES = ("merge_partials_kernel", "merge_wide_kernel")


def names(kernels: dict) -> set:
    return {n for n, src in kernels.items() if src.startswith(SOURCES) or n in MERGES}


def read(ctx):
    mine = names(ctx.kernels)
    s = ctx.trace.time_s(lambda n: kernel_base(n) in mine)
    return s * 1e3 / ctx.trace.batches if s > 0 else None
