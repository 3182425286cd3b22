"""Per-shard scan work of the two sharded IVF layouts, on clustered and Zipf
corpora.

The port's twin of ``scripts/measure_sharded_ivf_skew.py``. It builds the
IVF partition (seeded k-means on ``--device``), ranks each query's probes,
and counts, for every shard of ``parallel/sharded_ivf.py``'s layouts (rows
dealt round-robin, ``roundrobin_layout``; whole lists by greedy LPT,
``cluster_layout``):
  - ``rows``: the rows the list scan reads for the batch over the shard's
    own local CSR (round-robin: every shard its local part of each probed
    list; cluster: the owner the whole list), summed over queries;
  - ``padded``: the JAX package's padded probe shapes, for comparison
    (round-robin: nprobe slices of l_pad a query on every shard; cluster:
    min(owned, p_cap) slots of l_pad), and the probes p_cap drops.
Counts only: no clock, and it runs on the CPU too.

    python -m pyrope_tpu_torch.scripts.measure_sharded_ivf_skew [--n 100000]
        [--dim 32] [--nlist 100] [--nprobe 8] [--nd 8] [--queries 1024]
        [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device

CASES = (("clustered", "clustered"), ("zipf", "clustered"), ("zipf", "zipf"))


def ivf_partition(x: np.ndarray, nlist: int, device: str):
    """(centroids, lens, offsets) of the seeded k-means partition."""
    from pyrope_tpu_torch.ops.kmeans import kmeans_build
    from pyrope_tpu_torch.types import Metric

    cents, assign, _ = kmeans_build(x, nlist, Metric.L2, device=device, seed=42)
    lens = np.bincount(assign, minlength=nlist).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return np.asarray(cents), lens, offsets


def probe_sets(q: np.ndarray, cents: np.ndarray, nprobe: int) -> np.ndarray:
    d2 = ((q * q).sum(1)[:, None] - 2 * q @ cents.T
          + (cents * cents).sum(1)[None, :])
    return np.argsort(d2, axis=1)[:, :nprobe]


def shard_rows(lens: np.ndarray, offsets: np.ndarray, probes: np.ndarray, nlist: int,
               nd: int) -> dict:
    """Both layouts' per-shard counts for ``probes`` [B, nprobe] over the
    partition (``lens``, ``offsets``) of ``nlist`` lists."""
    from pyrope_tpu_torch.parallel.sharded_ivf import cluster_layout, roundrobin_layout
    from pyrope_tpu_torch.utils.shapes import round_up

    b, nprobe = probes.shape
    kpad = int(round_up(nlist, 8))
    lens_p = np.zeros(kpad, np.int32)
    lens_p[:nlist] = lens
    offs_p = np.zeros(kpad, np.int32)
    offs_p[:nlist] = offsets

    rr_lens, _, l_pad_rr, _, _ = roundrobin_layout(lens_p, offs_p, nd, kpad)
    rr_rows = rr_lens[:, probes].reshape(nd, -1).sum(axis=1, dtype=np.int64)
    rr_padded = np.full(nd, b * nprobe * l_pad_rr, np.int64)

    cl_lens, _, l_pad_cl, _, _, owner = cluster_layout(lens_p, offs_p, nd, kpad)
    cl_rows = cl_lens[:, probes].reshape(nd, -1).sum(axis=1, dtype=np.int64)
    p_cap = min(4 * (-(-nprobe // nd)), nprobe)   # the index's default
    own = owner[probes]
    cl_padded = np.zeros(nd, np.int64)
    dropped = 0
    for s in range(nd):
        counts = (own == s).sum(axis=1)
        cl_padded[s] = int(np.minimum(counts, p_cap).sum()) * l_pad_cl
        dropped += int(np.maximum(counts - p_cap, 0).sum())
    return {"l_pad_rr": l_pad_rr, "l_pad_cl": l_pad_cl, "p_cap": p_cap,
            "rr_rows": rr_rows.tolist(), "cl_rows": cl_rows.tolist(),
            "rr_padded": rr_padded.tolist(), "cl_padded": cl_padded.tolist(),
            "drop_pct": 100.0 * dropped / probes.size}


def spread(work) -> dict:
    w = np.asarray(work, np.float64)
    m = w.mean()
    return {"min": int(w.min()), "mean": round(float(m), 1), "max": int(w.max()),
            "max_over_mean": round(float(w.max() / m), 4) if m else None}


def measure(corpus: str, queries: str, n: int, dim: int, nlist: int, nprobe: int, nd: int,
            n_queries: int, device: str) -> dict:
    from pyrope_tpu_torch.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
        synthetic_zipf,
        synthetic_zipf_queries,
    )

    x = (synthetic_zipf if corpus == "zipf" else synthetic_clustered)(n, dim, n_clusters=nlist)
    q = (synthetic_zipf_queries if queries == "zipf" else synthetic_clustered_queries)(
        n_queries, dim, n_clusters=nlist)
    cents, lens, offsets = ivf_partition(x, nlist, device)
    out = shard_rows(lens, offsets, probe_sets(q, cents, nprobe), nlist, nd)
    out.update(corpus=corpus, queries=queries, longest_list=int(lens.max()),
               empty_lists=int((lens == 0).sum()))
    for key in ("rr_rows", "cl_rows", "rr_padded", "cl_padded"):
        out[key + "_spread"] = spread(out[key])
    return out


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--nlist", type=int, default=100)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--nd", type=int, default=8)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    rows = []
    for corpus, queries in CASES:
        r = measure(corpus, queries, args.n, args.dim, args.nlist, args.nprobe, args.nd,
                    args.queries, args.device)
        print(f"[corpus={corpus} queries={queries}] longest list {r['longest_list']}; "
              f"rows/shard round-robin {r['rr_rows_spread']}, "
              f"cluster {r['cl_rows_spread']}", file=sys.stderr)
        rows.append(r)
    emit("measure_sharded_ivf_skew", {"device": device_info(dev), "n": args.n,
                                      "dim": args.dim, "nlist": args.nlist,
                                      "nprobe": args.nprobe, "nd": args.nd,
                                      "queries": args.queries, "cases": rows}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
