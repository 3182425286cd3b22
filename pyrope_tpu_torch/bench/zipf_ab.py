"""Two questions of the Zipf corpora on the card, in turns (A B B A).

    python3 -m pyrope_tpu_torch.bench.zipf_ab [--out FILE]

From the repo root, after the kernels build. On chip_smoke phase 23's
indexes (IvfFlatIndex over ``synthetic_zipf(1M, 128, 1000)``, nlist 1000,
bf16 training; and over ``synthetic_zipf(100k, 128, 100)``, nlist 100):

- ``grid``: the list scan's launched grid. A is the wrapper's shape-only
  bound ((ceil(B·P/64) + min(kp, B·P)) · ceil(max_len/seg) blocks, most of
  them empty under one long list); B the tighter bound that also takes the
  slab's rows (ceil(B·P/64) + min(kp, B·P) + ceil(B/64) · (rows // seg)),
  both with the same tables. The hits must be bit-equal; each turn gives
  the CUDA-event ms (median of 50) and the device ms (torch.profiler) of a
  call at b1024, b256, b64 and b8 (1M) and b64, b1024 (100k).
- ``probe``: the probe route at b256 on the 1M index, its gather walked in
  query blocks (``index/ivf_flat.DENSE_MAX_ELEMS``: A) against one block of
  all 256 queries (B): ms a batch (host clock around the call and a sync,
  median of 5), the device's peak bytes, and the hits against the first
  turn's (chip_smoke's ``compare``: equal hit sets but for k-th place
  ties, scores within its tolerance; on the card the batched product's
  kernel, and so its rounding, may change with the block's size).

Prints one JSON object with the card's name and power limit, and writes it
to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import chip_smoke as cs
from pyrope_tpu_torch.index import ivf_flat
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex, rank_probes
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.types import Metric


def tight_call(orig):
    """``fs._list_call`` with the grid cut to the bound that takes the
    slab's rows (the tables' item_c piece cut with it)."""

    def call(k, mode, promote, b, nprobe, kp, max_len, d, n_rows, sms):
        c = orig(k, mode, promote, b, nprobe, kp, max_len, d, n_rows, sms)
        chunks = -(-(b * nprobe) // fs.QUERY_TILE) + min(kp, b * nprobe)
        grid = min(c.grid, chunks + -(-b // fs.QUERY_TILE) * (n_rows // c.plan.seg))
        pieces = tuple((n, grid if n == "item_c" else s) for n, s in c.pieces)
        spans, total = fs.layout(pieces)
        return fs.ListCall(c.plan, c.prefloor, c.pub_c, c.pub_g, grid, c.segs, c.slots,
                           pieces, spans, total)

    return call


def grid_ab(dev, ix, queries, batches, name, out) -> None:
    t = ix._sync()
    kp, n_rows = t["cents"].shape[0], t["alive"].shape[0]
    orig = fs._list_call
    try:
        for b in batches:
            q = torch.from_numpy(queries[:b]).to(dev)
            probe = rank_probes(q, t["cents"], t["cvalid"], t["offsets"], t["lens"], 3,
                                n_rows, Metric.L2)[0]

            def fn():
                return fs.fused_ivf_topk(q, t["xperm"], t["sqnorm"], t["alive"], t["crow"],
                                         t["offsets"], t["lens"], probe, kp, 10,
                                         max_len=t["l_pad"])

            ref = fn()
            for turn, variant in enumerate("ABBA"):
                fs._list_call = orig if variant == "A" else tight_call(orig)
                fs._CALLS.clear()
                got = fn()
                if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                    raise RuntimeError(f"{name} b{b}: the grids' hits differ")
                call = fs.list_call(10, fs.LIST_IVF, False, b, 3, kp, t["l_pad"], 128,
                                    n_rows, fs.device_sms(dev))
                split = cs.device_split(fn, 10)
                out[f"{name}_b{b}_{variant}{turn}"] = {
                    "grid": call.grid, "ms": round(cs.cuda_ms(fn, 50), 4),
                    "device_ms": round(split.get("device_ms", 0.0), 4)}
                print(name, b, variant, out[f"{name}_b{b}_{variant}{turn}"], flush=True)
    finally:
        fs._list_call = orig
        fs._CALLS.clear()


def probe_ab(dev, ix, queries, out) -> None:
    q = torch.from_numpy(queries[:256]).to(dev)
    cap = ivf_flat.DENSE_MAX_ELEMS
    ix.scan_mode = "probe"
    try:
        ref = ix.device_search(q, 10)
        for turn, variant in enumerate("ABBA"):
            ivf_flat.DENSE_MAX_ELEMS = cap if variant == "A" else 1 << 62
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                got = ix.device_search(q, 10)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            err, swaps = cs.compare(got, ref, f"probe route, {variant} against A")
            out[f"probe_b256_{variant}{turn}"] = {
                "max_abs_err": err, "kth_ties": swaps,
                "bit_equal": bool(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])),
                "block_queries": max(1, ivf_flat.DENSE_MAX_ELEMS // (ix._sync()["l_pad"] * 128)),
                "ms": round(statistics.median(times), 2),
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
            print("probe", variant, out[f"probe_b256_{variant}{turn}"], flush=True)
    finally:
        ivf_flat.DENSE_MAX_ELEMS = cap
        ix.scan_mode = "auto"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("zipf_ab measures on a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    out: dict = {}
    for n, nc, batches in ((1_000_000, 1000, (1024, 256, 64, 8)), (100_000, 100, (64, 1024))):
        base, queries, _ = cs.zipf_data(n, nc, dev)
        ix = IvfFlatIndex(128, "L2", device=dev, nlist=nc,
                          train_dtype="bfloat16" if nc == 1000 else None)
        ix.add_batch([str(i) for i in range(n)], base)
        ix.build()
        grid_ab(dev, ix, queries, batches, f"zipf{n // 1000}k", out)
        if nc == 1000:
            probe_ab(dev, ix, queries, out)
        del ix
    text = json.dumps({"card": smi, "rows": out})
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
