"""IVF nlist/nprobe sweep and HNSW ef sweep, with recall@10 and QPS.

The port's twin of ``scripts/sweep_indexes.py``: on ``synthetic(n, dim)``
and ``--batch`` queries, IvfFlatIndex at nlist 50, 100, 200 x nprobe 3, 8,
16 and HnswIndex (m 16, ef_construction 200) at ef_search 10, 50, 100.
QPS is pipelined ``device_search`` (50 calls, one synchronize) on the
device the row names.

    python -m pyrope_tpu_torch.scripts.sweep_indexes [--n 100000] [--dim 128]
        [--batch 64] [--topk 10] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device, sync

NLISTS = (50, 100, 200)
NPROBES = (3, 8, 16)
EFS = (10, 50, 100)


def measure(idx, q_dev, topk, truth, options, iters: int = 50) -> tuple[float, float]:
    """(pipelined QPS, recall@topk) of ``idx.device_search`` on ``q_dev``."""
    from pyrope_tpu_torch.utils.datasets import id_lists_to_rows, recall_at_k

    _, r = idx.device_search(q_dev, topk, options)
    sync(q_dev.device)
    t0 = time.perf_counter()
    outs = [idx.device_search(q_dev, topk, options) for _ in range(iters)]
    sync(q_dev.device)
    qps = iters * q_dev.shape[0] / (time.perf_counter() - t0)
    del outs
    rows = id_lists_to_rows(idx.resolve_rows(r.cpu().numpy()), topk)
    return round(qps, 1), round(recall_at_k(rows, truth, topk), 4)


def run(n: int = 100_000, dim: int = 128, batch: int = 64, topk: int = 10,
        device: str = "cuda") -> list:
    from pyrope_tpu_torch.index.hnsw import HnswIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.types import SearchOptions
    from pyrope_tpu_torch.utils.datasets import ground_truth, synthetic, synthetic_queries

    base = synthetic(n, dim)
    queries = synthetic_queries(batch, dim)
    truth = ground_truth(base, queries, topk, "L2")
    ids = [str(i) for i in range(n)]
    q_dev = torch.from_numpy(queries).to(device)
    rows = []
    for nlist in NLISTS:
        idx = IvfFlatIndex(dim, "L2", nlist=nlist, device=device)
        idx.add_batch(ids, base)
        t0 = time.perf_counter()
        idx.build()
        sync(q_dev.device)
        build_s = time.perf_counter() - t0
        for nprobe in NPROBES:
            opts = SearchOptions(nprobe=nprobe)
            qps, rec = measure(idx, q_dev, topk, truth, opts)
            rows.append({"index": "IVF_FLAT", "nlist": nlist, "nprobe": nprobe,
                         "route": idx.describe_scan(batch, nprobe, top_k=topk),
                         "build_s": round(build_s, 2), "qps": qps, "recall": rec})
            print(rows[-1], file=sys.stderr)
    idx = HnswIndex(dim, "L2", m=16, ef_construction=200, device=device)
    t0 = time.perf_counter()
    idx.add_batch(ids, base)
    build_s = time.perf_counter() - t0
    for ef in EFS:
        qps, rec = measure(idx, q_dev, topk, truth, SearchOptions(ef_search=ef))
        rows.append({"index": "HNSW", "m": 16, "ef_search": ef,
                     "build_s": round(build_s, 2), "qps": qps, "recall": rec})
        print(rows[-1], file=sys.stderr)
    return rows


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--topk", type=int, default=10)
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    rows = run(args.n, args.dim, args.batch, args.topk, args.device)
    emit("sweep_indexes", {"device": device_info(dev), "n": args.n, "dim": args.dim,
                           "batch": args.batch, "topk": args.topk, "rows": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
