"""Three end-to-end feature scenarios on ``PyropeEngine`` (no sockets).

The port's twin of ``scripts/phase6_eval.py``:

1. delta write-heavy: bulk adds land in the index's buffer and are searched
   exactly; a build compacts them; search p50 before and after the build;
2. semantic-cache repeat query: a cold search, then the same query 50
   times, each of them a cache hit (checked);
3. prefetch A -> B: the Markov predictor is taught that cluster A is
   followed by B; a search in A queues a prefetch of B's centroid query,
   which then is served from the cache (``prefetch_hit``).

    python -m pyrope_tpu_torch.scripts.phase6_eval [--device cuda|cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device


def mk_engine(device: str):
    from pyrope_tpu_torch.cache import StaticPolicyEngine
    from pyrope_tpu_torch.security import AuthSettings
    from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine

    eng = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False), device=device))
    eng.policy = StaticPolicyEngine(ttl_seconds=300)
    return eng


def timed_search(eng, tenant, index, q, reps=20) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = eng.search(tenant, index, q, 10)
        if not r.ok:
            raise RuntimeError(f"search failed: {r.error_message}")
        ts.append((time.perf_counter() - t0) * 1000)
    return sorted(ts)[len(ts) // 2]


def scenario_delta(device: str, n=5000, dim=32) -> dict:
    """Write-heavy Delta: query the unbuilt buffer, then the built index."""
    from pyrope_tpu_torch.types import IndexConfig, IndexParams

    eng = mk_engine(device)
    rng = np.random.default_rng(42)
    base = rng.random((n, dim), dtype=np.float32)
    eng.create_index("p6", "delta", IndexConfig(dim=dim, algorithm="IVF_FLAT",
                                                params=IndexParams(nlist=100)))
    eng.add_batch("p6", "delta", [f"v{i}" for i in range(n)], base)
    q = base[17] + 1e-4
    pre_ms = timed_search(eng, "p6", "delta", q)
    pre_top = eng.search("p6", "delta", q, 1).hits[0].id
    t0 = time.perf_counter()
    eng.build_index("p6", "delta")
    build_s = time.perf_counter() - t0
    post_ms = timed_search(eng, "p6", "delta", q)
    post_top = eng.search("p6", "delta", q, 1).hits[0].id
    return {"scenario": "delta_compaction", "pre_build_p50_ms": round(pre_ms, 3),
            "post_build_p50_ms": round(post_ms, 3), "build_s": round(build_s, 3),
            "top_hit_before": pre_top, "top_hit_after": post_top,
            "ok": pre_top == post_top == "v17"}


def scenario_semantic_cache(device: str, n=5000, dim=32) -> dict:
    """Repeat query: a miss reaches the index; repeats are cache hits."""
    from pyrope_tpu_torch.types import IndexConfig

    eng = mk_engine(device)
    rng = np.random.default_rng(43)
    base = rng.random((n, dim), dtype=np.float32)
    eng.create_index("p6", "cache", IndexConfig(dim=dim, algorithm="FLAT"))
    eng.add_batch("p6", "cache", [f"v{i}" for i in range(n)], base)
    # a first search with ANOTHER query, so q's cache line stays cold
    eng.search("p6", "cache", base[7] + 2e-4, 10)
    q = base[99] + 1e-4
    t0 = time.perf_counter()
    cold = eng.search("p6", "cache", q, 10, trace=True)
    cold_ms = (time.perf_counter() - t0) * 1000
    hits, levels = [], set()
    for _ in range(50):
        t0 = time.perf_counter()
        r = eng.search("p6", "cache", q, 10, trace=True)
        hits.append((time.perf_counter() - t0) * 1000)
        if not r.trace.cache_hit:
            raise RuntimeError("a repeated query missed the cache")
        levels.add(r.trace.cache_level)
    hit_ms = sorted(hits)[len(hits) // 2]
    return {"scenario": "semantic_cache_repeat", "cold_ms": round(cold_ms, 3),
            "cold_cache_hit": bool(cold.trace.cache_hit), "hit_p50_ms": round(hit_ms, 4),
            "hit_levels": sorted(levels), "speedup": round(cold_ms / max(hit_ms, 1e-6), 1),
            "ok": not cold.trace.cache_hit}


def scenario_prefetch(device: str, dim=16) -> dict:
    """A -> B cluster sequence: the predicted next cluster is served warm."""
    from pyrope_tpu_torch.types import IndexConfig, IndexParams

    eng = mk_engine(device)
    rng = np.random.default_rng(44)
    a = rng.normal(0, 0.01, (40, dim)).astype(np.float32)
    b = (rng.normal(0, 0.01, (40, dim)) + 5).astype(np.float32)
    eng.create_index("p6", "pf", IndexConfig(dim=dim, algorithm="IVF_FLAT",
                                             params=IndexParams(nlist=2)))
    eng.add_batch("p6", "pf", [f"v{i}" for i in range(80)], np.concatenate([a, b]))
    eng.build_index("p6", "pf")
    ca = eng.clusters.find_nearest_cluster("p6", "pf", a[0])[0]
    cb = eng.clusters.find_nearest_cluster("p6", "pf", b[0])[0]
    eng.prefetcher.set_rules_for_test({("p6", "pf", ca): cb})
    # touching cluster A queues a background prefetch of B's centroid
    eng.search("p6", "pf", a[0], 10)
    eng.prefetch_queue.run_pending()
    cents = eng.clusters.get_centroids("p6", "pf")
    t0 = time.perf_counter()
    r = eng.search("p6", "pf", np.asarray(cents[cb]), 10, trace=True)
    warm_ms = (time.perf_counter() - t0) * 1000
    return {"scenario": "prefetch_a_to_b", "clusters": [int(ca), int(cb)],
            "prefetch_hit": bool(r.trace.cache_hit), "hit_level": r.trace.cache_level,
            "warm_ms": round(warm_ms, 3), "ok": bool(r.trace.cache_hit) and ca != cb}


def run(device: str = "cuda") -> list:
    return [scenario_delta(device), scenario_semantic_cache(device),
            scenario_prefetch(device)]


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    report = run(args.device)
    emit("phase6_eval", {"device": device_info(dev), "scenarios": report,
                         "ok": all(s["ok"] for s in report)}, args.out)
    return 0 if all(s["ok"] for s in report) else 1


if __name__ == "__main__":
    sys.exit(main())
