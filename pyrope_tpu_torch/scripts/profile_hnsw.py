"""Where a batched HNSW beam search spends its time.

The port's twin of ``scripts/profile_hnsw.py``: builds HnswIndex (m 16,
ef_construction 200) on ``synthetic_clustered(n, dim)`` and times one
``--batch`` of queries at ``--ef``:
  - the whole search, ``--reps`` pipelined batches (QPS) and each batch
    alone (CUDA events, median);
  - the upper-layer descent: the beam with its layer-0 loop cut to 0 steps
    (the descent, the pool's set-up and the final selection);
  - the layer-0 steps: the whole search less the descent, and a step's
    share at the steps this batch ran;
  - the visited set, alone at a step's shapes: the pool-membership test the
    beam runs ('pool' mode) and the [B, N] bitmap's gather and scatter
    ('bitmap' mode);
  - the fetch: the hits' copy to the host and their ids' resolution.
With ``--trace DIR`` a torch.profiler trace of one batch goes to
DIR/profile_hnsw_trace.json, and the kernels' count and device time are
printed. On the CPU the same stages are timed with the host clock.

    python -m pyrope_tpu_torch.scripts.profile_hnsw [--n 100000] [--batch 256]
        [--ef 50] [--reps 20] [--trace DIR] [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device, sync


def timed_ms(fn, dev: torch.device, reps: int = 10) -> float:
    """Median ms of ``fn`` after one warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(n: int = 100_000, dim: int = 128, batch: int = 256, ef: int = 50, reps: int = 20,
        trace: str | None = None, device: str = "cuda") -> dict:
    from pyrope_tpu_torch.index.hnsw import (
        EXPAND_PER_STEP,
        HnswIndex,
        beam_schedule,
        beam_search_body,
    )
    from pyrope_tpu_torch.types import SearchOptions
    from pyrope_tpu_torch.utils.datasets import (
        synthetic_clustered,
        synthetic_clustered_queries,
    )

    base = synthetic_clustered(n, dim)
    queries = synthetic_clustered_queries(batch, dim)
    idx = HnswIndex(dim, "L2", m=16, ef_construction=200, ef_search=ef, device=device)
    t0 = time.perf_counter()
    idx.add_batch([str(i) for i in range(n)], base)
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f}s", file=sys.stderr)

    q = torch.from_numpy(queries).to(idx.device)
    dev = q.device
    opts = SearchOptions(ef_search=ef)
    pool, steps = beam_schedule(ef, 10)
    st = idx._sync()

    def beam(max_steps: int, counts=None, visited_mode=idx.visited_mode):
        return beam_search_body(
            st["x"], st["x_exact"], st["sqnorm"], st["adj0"], st["adj_up"], st["alive"],
            idx._entry, q, metric=idx._search_metric(), k=10, pool=pool, steps=max_steps,
            n_upper=st["n_upper"], visited_mode=visited_mode,
            rerank=idx.search_dtype == "bfloat16", counts=counts)

    vals, rows = idx.device_search(q, 10, opts)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        vals, rows = idx.device_search(q, 10, opts)
    sync(dev)
    pipelined_s = time.perf_counter() - t0
    counts: dict = {}
    beam(steps, counts)
    search_ms = timed_ms(lambda: idx.device_search(q, 10, opts), dev)
    upper_ms = timed_ms(lambda: beam(0), dev)
    bitmap_ms = timed_ms(lambda: beam(steps, visited_mode="bitmap"), dev)

    # the visited set alone, at one step's shapes: a step's E·deg candidates
    # against the pool (the 'pool' mode's test), and the bitmap's gather and
    # scatter over [B, N + 1]
    deg = st["adj0"].shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_nodes = st["x"].shape[0]
    nbrs = torch.randint(0, n_nodes, (batch, EXPAND_PER_STEP * deg), generator=gen,
                         device=dev, dtype=torch.int32)
    pool_ids = torch.randint(0, n_nodes, (batch, pool), generator=gen, device=dev,
                             dtype=torch.int32)
    visited = torch.zeros((batch, n_nodes + 1), dtype=torch.bool, device=dev)
    pool_test_ms = timed_ms(lambda: (nbrs[:, :, None] == pool_ids[:, None, :]).any(2), dev)

    def bitmap_step():
        safe = nbrs.long()
        seen = visited.gather(1, safe)
        visited.scatter_(1, safe, True)
        return seen

    bitmap_test_ms = timed_ms(bitmap_step, dev)
    fetch_ms = timed_ms(lambda: (vals.cpu(), rows.cpu()), dev)
    t0 = time.perf_counter()
    idx.resolve_rows(rows.cpu().numpy())
    resolve_ms = (time.perf_counter() - t0) * 1e3

    out = {"n": n, "dim": dim, "batch": batch, "ef": ef, "pool": pool, "steps_cap": steps,
           "steps_run": {"upper": counts.get("upper", 0), "layer0": counts.get("layer0", 0)},
           "build_s": round(build_s, 2), "visited_mode": idx.visited_mode,
           "qps": round(reps * batch / pipelined_s, 1),
           "search_ms": round(search_ms, 3), "upper_descent_ms": round(upper_ms, 3),
           "layer0_ms": round(search_ms - upper_ms, 3),
           "layer0_ms_a_step": round((search_ms - upper_ms) / max(counts.get("layer0", 0), 1),
                                     4),
           "search_bitmap_mode_ms": round(bitmap_ms, 3),
           "visited_pool_test_ms_a_step": round(pool_test_ms, 4),
           "visited_bitmap_ms_a_step": round(bitmap_test_ms, 4),
           "fetch_ms": round(fetch_ms, 4), "resolve_rows_ms": round(resolve_ms, 3),
           "timer": "cuda events" if dev.type == "cuda" else "host clock"}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            idx.device_search(q, 10, opts)
            sync(dev)
        Path(trace).mkdir(parents=True, exist_ok=True)
        path = Path(trace) / "profile_hnsw_trace.json"
        prof.export_chrome_trace(str(path))
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out["trace"] = {"path": str(path), "kernels": len(kernels),
                        "device_ms": round(sum(e.time_range.elapsed_us()
                                               for e in kernels) / 1e3, 3)
                        if kernels else "not measured"}
    return out


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ef", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of one batch")
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    out = run(args.n, args.dim, args.batch, args.ef, args.reps, args.trace, args.device)
    out["device"] = device_info(dev)
    emit("profile_hnsw", out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
