"""End-to-end tour of pyrope_tpu_torch: the twin of ``examples/quickstart.py``.

Covers the embedded index API (every index family on the card), snapshot
and load, the engine's cache cascade and quotas, and the wire protocol.
The printed sections match the JAX quickstart's; the last line is one JSON
object with the top hits each section prints (``hits``: the Flat scan's
three, every other section's first), which on the same seeded rows name
the ids the JAX quickstart prints, up to fp32 ties (section 5's fresh
document is the query itself, and ties with doc123 in fp32).

    python -m pyrope_tpu_torch.scripts.quickstart [--device cuda|cpu] [--out DIR]

The snapshot of section 6 goes under ``--out`` (a temporary directory,
removed at the end, without it).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from pyrope_tpu_torch.scripts import add_common, device_info, emit, start_device


def section(title):
    print(f"\n=== {title} ===", file=sys.stderr)


def tour(device: str, snap_dir: str) -> dict:
    """The quickstart's sections on ``device``; returns their top hits, the
    restored snapshot's count and the engine's miss and hit times."""
    import pyrope_tpu_torch as pt
    from pyrope_tpu_torch.cache import StaticPolicyEngine
    from pyrope_tpu_torch.index.delta import DeltaIndex
    from pyrope_tpu_torch.native import native_available
    from pyrope_tpu_torch.ops import score_convention
    from pyrope_tpu_torch.security import AuthSettings
    from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
    from pyrope_tpu_torch.service import TenantQuota

    rng = np.random.default_rng(42)
    hits: dict = {}

    section("1. Embedded index API — exact Flat scan")
    n, dim = 20_000, 128
    base = rng.random((n, dim), dtype=np.float32)
    ids = [f"doc{i}" for i in range(n)]
    flat = pt.FlatIndex(dim, "L2", device=device)
    flat.add_batch(ids, base)
    q = base[123] + 1e-4
    print(f"  scores: {score_convention('L2')}", file=sys.stderr)
    hits["flat_top3"] = [h.id for h in flat.search(q, top_k=3)]
    for hit in flat.search(q, top_k=3):
        print(f"  {hit.id}  score={hit.score:.4f}", file=sys.stderr)

    section("2. IVF-Flat — build + probed search")
    ivf = pt.IvfFlatIndex(dim, "L2", nlist=64, device=device)
    ivf.add_batch(ids, base)
    t0 = time.perf_counter()
    ivf.build()
    print(f"  built in {time.perf_counter() - t0:.1f}s; "
          f"centroids: {ivf.get_centroids().shape}", file=sys.stderr)
    hits["ivf_nprobe8_top"] = ivf.search(q, 3, pt.SearchOptions(nprobe=8))[0].id
    print("  nprobe=8 top hit:", hits["ivf_nprobe8_top"], file=sys.stderr)

    section("3. IVF-PQ — 32x compression with ADC scan")
    pq = pt.IvfPqIndex(dim, "L2", nlist=64, pq_m=8, ksub=256, device=device)
    pq.add_batch(ids, base)
    pq.build()
    hits["ivfpq_top"] = pq.search(q, 3)[0].id
    print("  top hit:", hits["ivfpq_top"], file=sys.stderr)

    section("4. HNSW — native C++ graph build, beam search on the device")
    available = native_available()
    print("  native builder available:", available, file=sys.stderr)
    hnsw = pt.HnswIndex(dim, "L2", m=16, ef_construction=100, ef_search=50, device=device)
    t0 = time.perf_counter()
    hnsw.add_batch(ids[:5000], base[:5000])
    print(f"  built 5000 in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    hits["hnsw_top"] = hnsw.search(q, 3)[0].id
    print("  top hit:", hits["hnsw_top"], file=sys.stderr)

    section("5. Delta LSM — streaming adds, merged search, compaction")
    delta = DeltaIndex(pt.FlatIndex(dim, "L2", device=device),
                       pt.IvfFlatIndex(dim, "L2", nlist=64, device=device))
    delta.add_batch(ids, base)
    delta.add("fresh-doc", q)   # lands in the mutable head
    hits["delta_pre_compaction"] = delta.search(q, 1)[0].id
    delta.build()               # compaction: head rows migrate into the IVF tail
    hits["delta_post_compaction"] = delta.search(q, 1)[0].id
    print("  pre-compaction:", hits["delta_pre_compaction"], file=sys.stderr)
    print("  post-compaction:", hits["delta_post_compaction"], file=sys.stderr)

    section("6. Snapshot / load (all families support it)")
    path = str(Path(snap_dir) / "flat.npz")
    flat.snapshot(path)
    restored = pt.FlatIndex(dim, "L2", device=device)
    restored.load(path)
    restored_count = restored.get_stats().count
    print("  restored count:", restored_count, file=sys.stderr)

    section("7. Full engine — cache cascade, quotas, trace")
    eng = PyropeEngine(EngineConfig(auth=AuthSettings(enabled=False), device=device))
    eng.policy = StaticPolicyEngine(ttl_seconds=60)
    eng.tenants.create("demo", api_key="demo-key",
                       quotas=TenantQuota(max_qps=10_000, priority=0))
    eng.create_index("demo", "docs", pt.IndexConfig(dim=dim, algorithm="IVF_FLAT"))
    eng.add_batch("demo", "docs", ids, base)
    r1 = eng.search("demo", "docs", q, 5, trace=True, request_id="demo-1")
    r2 = eng.search("demo", "docs", q, 5, trace=True, request_id="demo-2")
    print(f"  miss: {r1.trace.latency_ms:.2f} ms (engine {r1.trace.engine_ms:.2f} ms)",
          file=sys.stderr)
    print(f"  hit:  {r2.trace.latency_ms:.2f} ms via {r2.trace.cache_level}", file=sys.stderr)

    section("8. The wire protocol (same grammar as the reference)")
    print("""  redis-cli VEC.ADD demo docs doc1 VECTOR '[0.1, ...]' META '{"lang":"en"}' TAGS a,b
  redis-cli VEC.SEARCH demo docs TOPK 10 VECTOR '[0.1, ...]' FILTER a WITH_META TRACE
  curl -H 'X-API-KEY: ...' localhost:8080/v1/indexes/demo/docs/stats
  (start with: python -m pyrope_tpu_torch.server)""", file=sys.stderr)
    return {"hits": hits, "native_available": available, "restored_count": restored_count,
            "engine": {"miss_ms": round(r1.trace.latency_ms, 3),
                       "engine_ms": round(r1.trace.engine_ms, 3),
                       "hit_ms": round(r2.trace.latency_ms, 3),
                       "hit_level": r2.trace.cache_level}}


def run(device: str = "cuda", out: str | None = None) -> dict:
    if out:
        Path(out).mkdir(parents=True, exist_ok=True)
        return tour(device, out)
    with tempfile.TemporaryDirectory(prefix="pyrope_quickstart_") as tmp:
        return tour(device, tmp)


def main(argv=None) -> int:
    ap = add_common(argparse.ArgumentParser(description=__doc__.splitlines()[0]))
    args = ap.parse_args(argv)
    dev = start_device(args.device)
    out = run(args.device, args.out)
    out["device"] = device_info(dev)
    print("\nDone.", file=sys.stderr)
    emit("quickstart", out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
