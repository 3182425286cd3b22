"""End-to-end RESP serving benchmark at the reference's workload.

The port's twin of ``scripts/serving_bench.py``: the same 100k x 128
corpus (normal rows, seed 42), IVF_FLAT nlist 100, concurrent RESP clients
against the whole app (``load_test.start_app``) with the micro-batcher
coalescing single queries into shared device batches. Three cell families
(``--cells``):
  search    — concurrent VEC.SEARCH, cache off (every request reaches the
              index), one cell a (nprobe, concurrency)
  upsert    — VEC.UPSERT of every corpus row by ``--writers`` writers,
              disjoint ids, each keeping up to ``--pipeline`` commands in
              flight (RESP pipelining), vec/s: threads in this process, or
              with ``--writer-procs`` client processes
              (``bench/resp_load.py``) that encode their commands first:
              outside this process's interpreter lock, the model of remote
              writers
  cache_hit — one query repeated, cache on (L0 result-cache hits, served
              on the host)
``--inflight``, ``--linger-ms`` and ``--max-batch`` replace the engine's
micro-batcher once the app has started (``server/batcher.py``
``MicroBatcher``); the batcher a run used is reported under
``microbatcher``.

    python -m pyrope_tpu_torch.scripts.serving_bench [--n 100000] [--dim 128]
        [--nprobe 3 96] [--concurrency 4 16 64] [--duration 10]
        [--cells search upsert cache_hit] [--writers 4] [--pipeline 1]
        [--writer-procs] [--inflight N] [--linger-ms MS] [--max-batch N]
        [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np

from pyrope_tpu_torch.bench import resp_load
from pyrope_tpu_torch.cache import CachePolicyConfig
from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device
from pyrope_tpu_torch.scripts.load_test import run_cell, start_app
from pyrope_tpu_torch.server.batcher import MicroBatcher
from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.types import IndexConfig, IndexParams, SearchOptions
from pyrope_tpu_torch.utils.parsing import encode_vector
from pyrope_tpu_torch.utils.stats import LatencySummary


def _upsert_worker(port: int, index: str, ids: list[str], vecs: np.ndarray,
                   out: list, errors: list, pipeline: int) -> None:
    """One writer thread: its rows as VEC.UPSERT, up to ``pipeline`` in
    flight; each latency from the command's send to its reply (queueing
    behind the window included)."""
    lat: list[float] = []
    try:
        with RespClient("127.0.0.1", port, timeout=120) as c:
            sent: list[float] = []
            i_send = 0
            for i_read in range(len(ids)):
                while i_send < len(ids) and i_send - i_read < pipeline:
                    sent.append(time.perf_counter())
                    c.send("VEC.UPSERT", "lt", index, ids[i_send], "VECTOR",
                           encode_vector(vecs[i_send]))
                    i_send += 1
                reply = c.read_reply()
                if reply != "VEC_OK":
                    raise RuntimeError(f"upsert reply: {reply!r}")
                lat.append((time.perf_counter() - sent[i_read]) * 1000)
    except Exception as e:  # a dead writer must fail the cell
        errors.append(repr(e))
    out.append(lat)


def run_upsert_cell(port: int, index: str, base: np.ndarray, writers: int = 4,
                    pipeline: int = 1, procs: bool = False) -> dict:
    """Load ``base`` through ``writers`` concurrent writers, one connection
    each, disjoint ids (``v<row>``): vec/s over the whole load, p50/p99 of
    a write. ``procs``: client processes, timed from their first send to
    their last reply (their start-up and encoding outside the span);
    otherwise threads, timed from their start to their end."""
    n = len(base)
    if procs:
        try:
            got = resp_load.drive(port, "upsert", base, [[i, i] for i in range(n)], writers,
                                  tenant="lt", index=index, prefix="v", procs=writers,
                                  pipeline=pipeline)
        except RuntimeError as e:   # a failed client process
            got = {"replies": {}, "qps": 0.0, "p50_ms": 0.0, "p99_ms": 0.0, "error": repr(e)}
        errors = [f"v{r}: {reply!r}" for r, reply in got["replies"].items()
                  if reply != "VEC_OK"] + ([got["error"]] if "error" in got else [])
        return {"cell": "upsert", "writers": writers, "pipeline": pipeline,
                "writer_procs": True, "n": n, "vec_per_s": round(got["qps"], 1),
                "p50_ms": round(got["p50_ms"], 2), "p99_ms": round(got["p99_ms"], 2),
                "requests": len(got["replies"]), "errors": len(errors),
                "error_sample": errors[:3]}
    bounds = np.linspace(0, n, writers + 1, dtype=int)
    results: list = []
    errors: list = []
    threads = [
        threading.Thread(target=_upsert_worker,
                         args=(port, index, [f"v{i}" for i in range(bounds[w], bounds[w + 1])],
                               base[bounds[w]:bounds[w + 1]], results, errors, pipeline))
        for w in range(writers)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    total = sum(len(lat) for lat in results)
    s = LatencySummary.from_samples([x for lat in results for x in lat] or [0.0])
    return {"cell": "upsert", "writers": writers, "pipeline": pipeline, "n": n,
            "vec_per_s": round(total / wall, 1), "p50_ms": round(s.p50_ms, 2),
            "p99_ms": round(s.p99_ms, 2), "requests": total, "errors": len(errors),
            "error_sample": errors[:3]}


def batcher_settings(config, max_batch=None, linger_ms=None, inflight=None) -> dict:
    """The micro-batcher's settings: the flags given over the engine's
    (``EngineConfig.microbatch_*``)."""
    return {"max_batch": config.microbatch_max if max_batch is None else max_batch,
            "max_wait_ms": config.microbatch_wait_ms,
            "max_inflight": config.microbatch_inflight if inflight is None else inflight,
            "linger_ms": config.microbatch_linger_ms if linger_ms is None else linger_ms}


def microbatch_delta(engine, before: dict) -> dict:
    """The micro-batcher's batches and queries since ``before`` (its
    counters run from the process's start)."""
    now = engine.batcher.to_dict()
    bt = now["batches"] - before.get("batches", 0)
    qn = now["queries"] - before.get("queries", 0)
    return {"batches": bt, "queries": qn, "max_batch_seen_cum": now["max_batch_seen"],
            "avg_batch": round(qn / bt, 2) if bt else 0.0}


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--pipeline", type=int, default=1,
                    help="outstanding VEC.UPSERTs per writer (RESP pipelining)")
    ap.add_argument("--writer-procs", action="store_true",
                    help="writers as client processes, not threads of this process "
                         "(outside its interpreter lock: the model of a remote "
                         "load generator)")
    ap.add_argument("--inflight", type=int, default=None,
                    help="the micro-batcher's max_inflight (device batches at once)")
    ap.add_argument("--linger-ms", type=float, default=None,
                    help="the micro-batcher's post-acquire hold that merges "
                         "closed-loop cohorts (MicroBatcher.linger_ms)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="the micro-batcher's max_batch (pair with concurrency >= "
                         "max_batch; the batch buckets up to it are warmed)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """The cells ``args`` asks for against an app started here on
    ``args.device`` (built or loaded kernels: ``start_device``)."""
    running = start_app(args.device)
    app, port = running.app, running.port
    out = {"n": args.n, "dim": args.dim, "cells": []}
    try:
        if app.engine.batcher is not None:
            mb = batcher_settings(app.engine.config, args.max_batch, args.linger_ms,
                                  args.inflight)
            if (args.max_batch, args.linger_ms, args.inflight) != (None, None, None):
                app.engine.batcher = MicroBatcher(
                    mb["max_batch"], mb["max_wait_ms"], max_inflight=mb["max_inflight"],
                    linger_ms=mb["linger_ms"])
            out["microbatcher"] = mb
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
            cell = run_upsert_cell(port, "ingest", base, args.writers, args.pipeline,
                                   args.writer_procs)
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
        running.close()
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = start_device(args.device)
    out = {"device": device_info(dev), **run(args)}
    emit("serving_bench", out, args.out)
    return 0 if all(c["errors"] == 0 for c in out["cells"]) else 1


if __name__ == "__main__":
    sys.exit(main())
