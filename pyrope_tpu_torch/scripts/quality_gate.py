"""Clustered-proxy quality gate: recall floors of every ANN family.

The port's twin of ``scripts/quality_gate.py``. On a seeded clustered
corpus (``utils/datasets.synthetic_clustered``, 100 centers) each ANN
family at its bench settings must reach:

    IVF-Flat  nprobe 3           recall@10 >= 0.95
    IVF-PQ    m 4 + exact rerank recall@10 >= 0.60 and >= min(2x, +0.1) the
                                 reference's pure-ADC recall at the same
                                 settings (the rerank must dominate)
    HNSW      ef 50              recall@10 >= 0.70
    and IVF and HNSW no lower than the reference-semantics oracle
    (``utils/ref_oracle.py``) less 0.02.

Exit code 0: every floor holds. The rows go to ``--out``/quality_gate.json.

    python -m pyrope_tpu_torch.scripts.quality_gate [--n 100000]
        [--queries 64] [--no-oracle] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device


def run(n: int = 100_000, n_queries: int = 64, oracle: bool = True,
        device: str = "cuda") -> dict:
    from pyrope_tpu_torch.index.hnsw import HnswIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
    from pyrope_tpu_torch.types import SearchOptions
    from pyrope_tpu_torch.utils import ref_oracle as ro
    from pyrope_tpu_torch.utils.datasets import (
        ground_truth,
        recall_at_k,
        synthetic_clustered,
        synthetic_clustered_queries,
    )

    dim, k = 128, 10
    base = synthetic_clustered(n, dim)
    queries = synthetic_clustered_queries(n_queries, dim)
    truth = ground_truth(base, queries, k, "L2")
    ids = [str(i) for i in range(n)]

    def measure(idx, opts, label):
        t0 = time.perf_counter()
        idx.add_batch(ids, base)
        idx.build()
        build_s = time.perf_counter() - t0
        res = idx.search_batch(queries, k, opts)
        rows = np.array([[int(h.id) for h in r] + [-1] * (k - len(r)) for r in res])
        r = recall_at_k(rows, truth, k)
        print(f"[{label}] recall@10={r:.4f} build={build_s:.1f}s", file=sys.stderr)
        return r, build_s

    failures, rows = [], []
    r_ivf, b_ivf = measure(IvfFlatIndex(dim, "L2", nlist=100, device=device),
                           SearchOptions(), "ivf nprobe=3")
    if r_ivf < 0.95:
        failures.append(f"IVF clustered recall {r_ivf:.4f} < 0.95")
    rows.append(("quality_gate_ivf_clustered", "IVF_FLAT", r_ivf, b_ivf))

    r_pq, b_pq = measure(IvfPqIndex(dim, "L2", nlist=100, pq_m=4, device=device),
                         SearchOptions(), "ivfpq m4+rerank")
    if r_pq < 0.60:
        failures.append(f"IVF-PQ clustered recall {r_pq:.4f} < 0.60")
    rows.append(("quality_gate_ivfpq_clustered", "IVF_PQ", r_pq, b_pq))

    hnsw = HnswIndex(dim, "L2", m=16, ef_construction=200, ef_search=50, device=device)
    r_hnsw, b_hnsw = measure(hnsw, SearchOptions(ef_search=50), "hnsw ef=50")
    if r_hnsw < 0.70:
        failures.append(f"HNSW clustered recall {r_hnsw:.4f} < 0.70")
    rows.append(("quality_gate_hnsw_clustered", "HNSW", r_hnsw, b_hnsw))

    oracle_out = None
    if oracle:
        cents, lists = ro.ref_ivf_build(base, 100, seed=42)
        r_ref = recall_at_k(np.stack([ro.ref_ivf_search(base, cents, lists, q, 3, k)
                                      for q in queries]), truth, k)
        if r_ivf < r_ref - 0.02:
            failures.append(f"IVF {r_ivf:.4f} below reference oracle {r_ref:.4f}")
        pc, pl, pcb, pco = ro.ref_ivfpq_build(base, 100, 4, 256)
        r_pq_ref = recall_at_k(np.stack([ro.ref_ivfpq_search(pc, pl, pcb, pco, q, 3, k)
                                         for q in queries]), truth, k)
        # past an oracle ADC recall of 0.5 doubling cannot be met even at
        # recall 1.0: require a +0.1 margin there instead
        if r_pq < min(2.0 * r_pq_ref, r_pq_ref + 0.1):
            failures.append(f"IVF-PQ rerank {r_pq:.4f} fails to clearly beat the "
                            f"reference's pure ADC {r_pq_ref:.4f}")
        r_seq = recall_at_k(np.stack([ro.ref_hnsw_search(hnsw, q, 50, k) for q in queries]),
                            truth, k)
        if r_hnsw < r_seq - 0.02:
            failures.append(f"HNSW beam {r_hnsw:.4f} below sequential ref {r_seq:.4f}")
        oracle_out = {"ivf_nprobe3": r_ref, "ivfpq_m4_pure_adc": r_pq_ref,
                      "hnsw_ef50_sequential": r_seq}
        print(f"[oracle] {oracle_out}", file=sys.stderr)

    return {"n": n, "dim": dim, "queries": n_queries, "topk": k,
            "rows": [{"config": cfg, "algo": algo, "recall_at_k": rec,
                      "build_s": round(build_s, 3)} for cfg, algo, rec, build_s in rows],
            "oracle": oracle_out, "failures": failures, "passed": not failures}


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--no-oracle", action="store_true")
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    out = run(args.n, args.queries, not args.no_oracle, args.device)
    out["device"] = device_info(dev)
    print("QUALITY GATE PASSED" if out["passed"] else
          "QUALITY GATE FAILED:\n - " + "\n - ".join(out["failures"]), file=sys.stderr)
    emit("quality_gate", out, args.out)
    return 0 if out["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
