#!/usr/bin/env python3
"""The JAX package's fp32 and bf16 HNSW beams on hnsw100k_clustered, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_hnsw_bf16_gap.py

Builds bench.py's hnsw100k_clustered graph (synthetic_clustered(100_000,
128, 100 centers), m 16, ef_construction 200) with the native C++ builder
in both packages, the JAX package's HnswIndex and the port's
(pyrope_tpu_torch, device "cpu"), and checks that the two graphs are the
same: the SHA-256 of layer 0's adjacency, of the upper layers', and of the
whole graph (levels, adjacency, entry, top level), as chip_smoke.py's
``graph_hash`` computes it. Then searches the JAX package's graph with its
fp32 beam and its bf16 beam (``search_dtype="bfloat16"``, the final pool
re-scored in fp32) at ef 50, in batches of 64, over the 256 queries of
chip_smoke.py phase 15, and prints recall@10 of each against exact truth,
and their gap. chip_smoke.py keeps the printed values as
``HNSW100K_GRAPH_SHA256`` and ``HNSW_BF16_GAP_JAX``; phase 15 holds the
card's graph to the hash and its bf16 beam to the recalls.

Prints one JSON object. Takes a few minutes on one core (the build).
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from pyrope_tpu.index.hnsw import HnswIndex as JaxHnswIndex  # noqa: E402
from pyrope_tpu.utils.datasets import (  # noqa: E402
    ground_truth,
    recall_at_k,
    synthetic_clustered,
    synthetic_clustered_queries,
)
from pyrope_tpu_torch.index.hnsw import HnswIndex  # noqa: E402

N, D, CENTERS, QUERIES, EF, K, BATCH = 100_000, 128, 100, 256, 50, 10, 64


def graph_hash(ix) -> dict:
    """SHA-256 of an HNSW graph as both packages hold it on the host:
    layer 0's adjacency [n, 2m] int32, the upper layers' [L, n, m], and the
    whole graph (levels, both adjacencies, entry row and top level)."""
    n = ix._count
    adj0 = np.ascontiguousarray(ix._adj0[:n], dtype=np.int32)
    up = np.ascontiguousarray(np.stack([a[:n] for a in ix._adj_up]) if ix._adj_up
                              else np.zeros((0, n, ix.m), np.int32), dtype=np.int32)
    levels = np.ascontiguousarray(ix._levels[:n], dtype=np.int32)
    whole = hashlib.sha256()
    for part in (levels, adj0, up, np.array([ix._entry, ix._top_level], np.int64)):
        whole.update(part.tobytes())
    return {"adj0": hashlib.sha256(adj0.tobytes()).hexdigest(),
            "adj_up": hashlib.sha256(up.tobytes()).hexdigest(),
            "graph": whole.hexdigest()}


def recall(ix, queries, truth) -> float:
    rows = np.full((len(queries), K), -1, np.int64)
    for s in range(0, len(queries), BATCH):
        for i, hits in enumerate(ix.search_batch(queries[s:s + BATCH], K)):
            ids = [int(h.id) for h in hits[:K]]
            rows[s + i, :len(ids)] = ids
    return float(recall_at_k(rows, truth, K))


def main() -> int:
    base = synthetic_clustered(N, D, n_clusters=CENTERS)
    queries = synthetic_clustered_queries(QUERIES, D, n_clusters=CENTERS)
    truth = ground_truth(base, queries, K)
    ids = [str(i) for i in range(N)]
    out = {}
    t0 = time.perf_counter()
    jix = JaxHnswIndex(D, "L2", m=16, ef_construction=200, ef_search=EF)
    jix.add_batch(ids, base)
    out["jax_build_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    tix = HnswIndex(D, "L2", device="cpu", m=16, ef_construction=200, ef_search=EF)
    tix.add_batch(ids, base)
    out["port_build_s"] = round(time.perf_counter() - t0, 1)
    jh, th = graph_hash(jix), graph_hash(tix)
    out.update(hash_jax=jh, hash_port=th, same_graph=jh == th,
               top_level=int(jix._top_level))
    j16 = JaxHnswIndex(D, "L2", ef_search=EF, search_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as tmp:   # the same graph, a bf16 beam slab
        jix.snapshot(f"{tmp}/g.npz")
        j16.load(f"{tmp}/g.npz")
    fp32 = recall(jix, queries, truth)
    bf16 = recall(j16, queries, truth)
    out.update(ef=EF, queries=QUERIES, recall_fp32_jax=fp32, recall_bf16_jax=bf16,
               gap_jax=round(fp32 - bf16, 8))
    print(json.dumps(out))
    return 0 if jh == th else 1


if __name__ == "__main__":
    sys.exit(main())
