"""E2E load test: SLO compliance matrix over concurrency x cache on/off.

The port's twin of ``scripts/load_test.py``: starts the whole app
(``PyropeApp``: RESP and HTTP on one event loop) in this process on a
thread, fans out concurrent RESP clients (threads), and reports QPS and
latency quantiles against an SLO target (env SLO_P99_MS, default 50) for
each (concurrency, cache) cell.

    python -m pyrope_tpu_torch.scripts.load_test [--n 5000] [--dim 32]
        [--duration 5] [--concurrency 1 4 16] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import sys
import threading
import time

import numpy as np

from pyrope_tpu_torch.cache import CachePolicyConfig
from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.app import PyropeApp
from pyrope_tpu_torch.server.engine import EngineConfig
from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.utils.parsing import encode_vector
from pyrope_tpu_torch.utils.stats import LatencySummary


class RunningApp:
    """A ``PyropeApp`` on ports picked by the OS, its event loop on a thread
    of its own; ``close()`` stops the app and the loop and joins the
    thread."""

    def __init__(self, device: str):
        self.app = PyropeApp(
            config=EngineConfig(auth=AuthSettings(enabled=False), device=device),
            resp_port=0, http_port=0,
        )
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, name="app-loop",
                                       daemon=True)
        self.thread.start()
        try:
            asyncio.run_coroutine_threadsafe(self.app.start(), self.loop).result(600)
        except BaseException:
            self._stop_loop()
            self.loop.close()
            raise

    @property
    def port(self) -> int:
        return self.app.resp.port

    def _stop_loop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(60)

    def close(self) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(60)
        finally:
            self._stop_loop()
            self.loop.close()


def start_app(device: str = "cuda") -> RunningApp:
    return RunningApp(device)


def worker(port: int, queries: np.ndarray, stop_at: float, out: list,
           errors: list, index: str = "idx") -> None:
    lat = []
    n = 0
    rng = np.random.default_rng(threading.get_ident() % 2**32)
    try:
        with RespClient("127.0.0.1", port, timeout=120) as c:
            while time.time() < stop_at:
                q = queries[rng.integers(0, len(queries))]
                t0 = time.perf_counter()
                c.vec_search("lt", index, encode_vector(q), 10)
                lat.append((time.perf_counter() - t0) * 1000)
                n += 1
    except Exception as e:  # a dead worker must fail the cell
        errors.append(repr(e))
    out.append((n, lat))


def run_cell(port: int, queries: np.ndarray, concurrency: int, duration: float,
             index: str = "idx") -> dict:
    """``concurrency`` client threads sending VEC.SEARCH top-10 of random
    rows of ``queries`` for ``duration`` seconds: QPS, p50/p99 ms, the
    requests and errors."""
    stop_at = time.time() + duration
    results: list = []
    errors: list = []
    threads = [
        threading.Thread(target=worker,
                         args=(port, queries, stop_at, results, errors, index))
        for _ in range(concurrency)
    ]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join(duration + 300)
        if t.is_alive():
            errors.append("a client thread did not finish")
    wall = time.time() - t0
    total = sum(n for n, _ in results)
    lat = [x for _, ls in results for x in ls]
    s = LatencySummary.from_samples(lat or [0.0])
    return {
        "concurrency": concurrency,
        "qps": round(total / wall, 1),
        "p50_ms": round(s.p50_ms, 2),
        "p99_ms": round(s.p99_ms, 2),
        "requests": total,
        "errors": len(errors),
        "error_sample": errors[:3],
    }


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--pool", type=int, default=32,
                    help="distinct query pool size (small pool => cache-on "
                         "cells exercise the hit path)")
    args = ap.parse_args(argv)
    slo_p99 = float(os.environ.get("SLO_P99_MS", "50"))

    dev = start_device(args.device)
    run = start_app(args.device)
    try:
        app, port = run.app, run.port
        rng = np.random.default_rng(42)
        base = rng.random((args.n, args.dim), dtype=np.float32)
        print(f"loading {args.n} x {args.dim} ...", file=sys.stderr)
        app.engine.add_batch("lt", "idx", [f"v{i}" for i in range(args.n)], base)
        queries = rng.random((args.pool, args.dim), dtype=np.float32)
        with RespClient("127.0.0.1", port, timeout=300) as c:   # the first search
            c.vec_search("lt", "idx", encode_vector(queries[0]), 10)

        rows = []
        for cache_on in (False, True):
            app.engine.policy.store.update(
                CachePolicyConfig(enable_cache=cache_on, default_ttl_seconds=60)
            )
            app.engine.flush_cache()
            for conc in args.concurrency:
                cell = run_cell(port, queries, conc, args.duration)
                cell["cache"] = "on" if cache_on else "off"
                cell["slo_p99_ms"] = slo_p99
                # zero successful requests (or any worker error) meet no SLO
                cell["slo_met"] = (cell["requests"] > 0 and cell["errors"] == 0
                                   and cell["p99_ms"] <= slo_p99)
                rows.append(cell)
                print(cell, file=sys.stderr)
    finally:
        run.close()
    met = sum(r["slo_met"] for r in rows)
    print(f"SLO met in {met}/{len(rows)} cells", file=sys.stderr)
    emit("load_test", {"device": device_info(dev), "n": args.n, "dim": args.dim,
                       "slo_p99_ms": slo_p99, "slo_met_cells": met, "cells": rows}, args.out)
    return 0 if all(r["errors"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
