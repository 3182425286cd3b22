"""End-to-end RESP serving benchmark at the reference's workload.

The port's twin of ``scripts/serving_bench.py``: the same 100k x 128
corpus (normal rows, seed 42), IVF_FLAT nlist 100, concurrent RESP clients
against the whole app (``load_test.start_app``) with the micro-batcher
coalescing single queries into shared device batches. Three cell families
(``--cells``):
  search    — concurrent VEC.SEARCH, cache off (every request reaches the
              index), one cell a (nprobe, concurrency)
  upsert    — VEC.UPSERT of every corpus row by ``--writers`` client
              processes (``bench/resp_load.py``: the model of remote
              writers, outside this process's interpreter lock), vec/s
  cache_hit — one query repeated, cache on (L0 result-cache hits, served
              on the host)

    python -m pyrope_tpu_torch.scripts.serving_bench [--n 100000] [--dim 128]
        [--nprobe 3 96] [--concurrency 4 16 64] [--duration 10]
        [--cells search upsert cache_hit] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from pyrope_tpu_torch.bench import resp_load
from pyrope_tpu_torch.cache import CachePolicyConfig
from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device
from pyrope_tpu_torch.scripts.load_test import run_cell, start_app
from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.types import IndexConfig, IndexParams, SearchOptions
from pyrope_tpu_torch.utils.parsing import encode_vector


def run_upsert_cell(port: int, index: str, base: np.ndarray, writers: int) -> dict:
    """Load ``base`` through ``writers`` client processes, one connection
    each, disjoint ids (``v<row>``): vec/s over the whole load, p50/p99."""
    out = resp_load.drive(port, "upsert", base, [[i, i] for i in range(len(base))],
                          writers, tenant="lt", index=index, prefix="v", procs=writers)
    bad = [r for r, reply in out["replies"].items() if reply != "VEC_OK"]
    return {"cell": "upsert", "writers": writers, "writer_procs": True, "n": len(base),
            "vec_per_s": round(out["qps"], 1), "p50_ms": round(out["p50_ms"], 2),
            "p99_ms": round(out["p99_ms"], 2), "requests": len(out["replies"]),
            "errors": len(bad), "error_sample": [out["replies"][r] for r in bad[:3]]}


def microbatch_delta(engine, before: dict) -> dict:
    """The micro-batcher's batches and queries since ``before`` (its
    counters run from the process's start)."""
    now = engine.batcher.to_dict()
    bt = now["batches"] - before.get("batches", 0)
    qn = now["queries"] - before.get("queries", 0)
    return {"batches": bt, "queries": qn, "max_batch_seen_cum": now["max_batch_seen"],
            "avg_batch": round(qn / bt, 2) if bt else 0.0}


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--nprobe", type=int, nargs="+", default=[3, 96])
    ap.add_argument("--concurrency", type=int, nargs="+", default=[4, 16, 64])
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--pool", type=int, default=4096,
                    help="distinct queries (a large pool and cache off: every "
                         "request reaches the index)")
    ap.add_argument("--cells", nargs="+", default=["search", "upsert", "cache_hit"],
                    choices=["search", "upsert", "cache_hit"])
    ap.add_argument("--writers", type=int, default=4)
    args = ap.parse_args(argv)

    dev = start_device(args.device)
    run = start_app(args.device)
    app, port = run.app, run.port
    out = {"device": device_info(dev), "n": args.n, "dim": args.dim, "cells": []}
    try:
        # cache off for every cell but cache_hit: the serving path to the index
        app.engine.policy.store.update(
            CachePolicyConfig(enable_cache=False, default_ttl_seconds=60))
        rng = np.random.default_rng(42)
        base = rng.standard_normal((args.n, args.dim)).astype(np.float32)
        queries = rng.standard_normal((args.pool, args.dim)).astype(np.float32)

        if "upsert" in args.cells:
            # writes land in a fresh index's buffer (no build), as the
            # reference's load phase
            app.engine.create_index("lt", "ingest", IndexConfig(
                dim=args.dim, algorithm="IVF_FLAT",
                params=IndexParams.from_dict({"nlist": 100})))
            cell = run_upsert_cell(port, "ingest", base, args.writers)
            cell["coalescer"] = app.resp.write_coalescer.to_dict()
            out["cells"].append(cell)
            print(cell, file=sys.stderr)

        for nprobe in args.nprobe if {"search", "cache_hit"} & set(args.cells) else ():
            name = f"idx_np{nprobe}"
            app.engine.create_index("lt", name, IndexConfig(
                dim=args.dim, algorithm="IVF_FLAT",
                params=IndexParams.from_dict({"nlist": 100, "nprobe": nprobe})))
            t0 = time.perf_counter()
            app.engine.add_batch("lt", name, [f"v{i}" for i in range(args.n)], base)
            ok = app.engine.build_index("lt", name)
            print(f"[{name}] load+build {time.perf_counter() - t0:.1f}s ok={ok}",
                  file=sys.stderr)
            with RespClient("127.0.0.1", port, timeout=300) as c:
                c.vec_search("lt", name, encode_vector(queries[0]), 10)
            # the first call at each batch bucket the micro-batcher can form
            # (plans, allocator) before the timed cells
            st = app.engine.registry.try_get("lt", name)
            mb = app.engine.batcher.max_batch if app.engine.batcher else 64
            for b in (8, 16, 32, 64, 128, 256):
                if b > max(mb, 64):
                    break
                st.index.search_batch(np.repeat(queries[:1], b, axis=0), 10, SearchOptions())

            if "search" in args.cells:
                for conc in args.concurrency:
                    app.engine.flush_cache()
                    mb0 = app.engine.batcher.to_dict() if app.engine.batcher else {}
                    cell = run_cell(port, queries, conc, args.duration, index=name)
                    # the engine's index is Delta(Flat head, IVF tail): the
                    # tail's route for a single query
                    cell.update(cell="search", nprobe=nprobe,
                                route_b1=st.index.tail.describe_scan(1, nprobe))
                    if app.engine.batcher:
                        cell["microbatch"] = microbatch_delta(app.engine, mb0)
                    out["cells"].append(cell)
                    print(cell, file=sys.stderr)

            if "cache_hit" in args.cells:
                app.engine.policy.store.update(
                    CachePolicyConfig(enable_cache=True, default_ttl_seconds=300))
                app.engine.flush_cache()
                for conc in args.concurrency:
                    cell = run_cell(port, queries[:1], conc, args.duration, index=name)
                    cell.update(cell="cache_hit", nprobe=nprobe)
                    out["cells"].append(cell)
                    print(cell, file=sys.stderr)
                app.engine.policy.store.update(
                    CachePolicyConfig(enable_cache=False, default_ttl_seconds=60))
    finally:
        run.close()
    emit("serving_bench", out, args.out)
    return 0 if all(c["errors"] == 0 for c in out["cells"]) else 1


if __name__ == "__main__":
    sys.exit(main())
