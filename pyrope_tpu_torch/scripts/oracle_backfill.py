"""Backfill ``recall_ref`` for bench rows above the oracle's default cap.

The twin of ``scripts/oracle_backfill.py``: for each named row of the port's
bench twin (``scripts/bench.py``) it remakes the row's corpus (the same
generators and seeds), takes the exact truth of the row's oracle queries
and runs the reference-semantics oracle (``utils/ref_oracle.py``). All of
it is numpy on the host and touches no device, as the JAX script pins jax
to the CPU. The oracle queries are run_config's: the first 256 of its
n_eval = max(batch, min(1024, 256)) queries, so a backfilled value is the
one the row's own oracle would give with the cap raised. (The JAX script
takes the first ``batch`` of them, 64 at the default batch.)

Each result is merged into the row of the same (config, batch) in
``--out``/bench_detail.json (``recall_ref`` and ``n_oracle``); a row not
there yet is reported and skipped. The 1M rows take hours on one core.

    python -m pyrope_tpu_torch.scripts.oracle_backfill ivfpq1m_adc [...] --out DIR
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from pyrope_tpu_torch.scripts import bench


def backfill(name: str, topk: int = 10, n_queries: int = 1024) -> dict:
    """recall_ref of one CONFIGS row whose oracle needs no built index."""
    from pyrope_tpu_torch.utils.datasets import ground_truth

    algo, _, _, kwargs = bench.CONFIGS[name]
    kwargs = dict(kwargs)
    batch = kwargs.pop("batch", 64)   # bench's default --batch
    kwargs.pop("topk", None)
    opt_kwargs = kwargs.pop("opts", {})
    if algo not in ("IVF_FLAT", "IVF_PQ", "DELTA", "FLAT_SQ8"):
        raise SystemExit(f"{name}: algo {algo} needs the built index; "
                         "run its oracle inside the bench twin instead")
    base, queries, _, _ = bench.row_data(name, batch, n_queries)
    n_eval = max(batch, min(len(queries), 256))
    gt_q = queries[:n_eval][:256]
    print(f"[{name}] ground truth over {len(gt_q)} queries x {base.shape[0]} rows...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    truth = ground_truth(base, gt_q, topk, "L2")
    print(f"[{name}] ground truth: {time.perf_counter() - t0:.1f}s", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    recall_ref = bench.oracle_recall(algo, {**kwargs, **opt_kwargs}, base, gt_q, truth,
                                     topk, idx=None, oracle_max_n=base.shape[0])
    print(f"[{name}] oracle: recall_ref={recall_ref} ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr, flush=True)
    return {"config": name, "batch": batch, "recall_ref": recall_ref, "n_oracle": len(gt_q)}


def merge(results: list[dict], path: Path) -> list[str]:
    """Write each result into the row of the same (config, batch) in
    ``path``; returns the configs that had no such row."""
    detail = json.loads(path.read_text()) if path.exists() else []
    by_key = {(r["config"], r.get("batch")): r for r in detail}
    missing = []
    for res in results:
        row = by_key.get((res["config"], res["batch"]))
        if row is None:
            missing.append(res["config"])
            continue
        row["recall_ref"] = res["recall_ref"]
        row["n_oracle"] = res["n_oracle"]
    if len(missing) < len(results):
        path.write_text(json.dumps(detail, indent=2))
    return missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="+", help="CONFIGS rows")
    ap.add_argument("--out", required=True,
                    help="directory of the bench twin's bench_detail.json")
    args = ap.parse_args(argv)
    results = [backfill(n) for n in args.names]
    for name in merge(results, Path(args.out) / "bench_detail.json"):
        print(f"WARNING: no bench row for {name} at its batch; not merged "
              "(run the bench row first)", file=sys.stderr, flush=True)
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
