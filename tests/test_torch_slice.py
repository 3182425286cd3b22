"""The port's whole slice on the CPU, against the JAX package's.

Both registries build the default composite Delta(head=Flat, tail=IVF_FLAT),
and Delta(head=Flat, tail=IVF_PQ) with the residual-SQ8 rerank slab, with
``train_init="sample"`` on the same data: writes land in the head,
``build()`` compacts them into the tail (k-means -> cluster-major slab),
and searches merge head and tail. The two k-means runs start from the same
rows but sum in a different order, so a boundary row may land in another
list: hits must agree on >= 99% (recall of the port's hits against the
JAX package's), scores of shared hits within rtol 1e-5 / atol 1e-4. On the
IVF_PQ slab a row's residual is taken against those slightly different
centroids, so its SQ8 code may round to the next step (about 1e-3 at this
data's cluster radius): shared scores there agree within atol 2e-3.
"""

import numpy as np
import pytest
import torch
from _torch_parity import port_config, port_options

from pyrope_tpu import registry as jreg
from pyrope_tpu.types import IndexConfig, IndexParams, SearchOptions
from pyrope_tpu.utils.datasets import synthetic_clustered, synthetic_clustered_queries
from pyrope_tpu_torch import registry as treg
from pyrope_tpu_torch import types as tt

N, D, NLIST = 8000, 32, 32


def _config():
    return IndexConfig(dim=D, algorithm="IVF_FLAT", params=IndexParams(
        nlist=NLIST, nprobe=4, scan_mode="dense", train_init="sample"))


def _pq_config():
    return IndexConfig(dim=D, algorithm="IVF_PQ", params=IndexParams(
        nlist=NLIST, nprobe=4, pq_m=8, k=256, refine_storage="sq8res",
        scan_mode="dense", train_init="sample"))


def _agreement(res_a, res_b, atol=1e-4):
    hits = total = 0
    for ra, rb in zip(res_a, res_b):
        sb = {h.id: h.score for h in rb}
        for h in ra:
            if h.id in sb:
                hits += 1
                assert np.isclose(h.score, sb[h.id], rtol=1e-5, atol=atol)
        total += len(rb)
    return hits / total


@pytest.fixture(scope="module")
def pair():
    base = synthetic_clustered(N, D, n_clusters=NLIST, seed=3)
    q = synthetic_clustered_queries(64, D, n_clusters=NLIST, base_seed=3)
    jr, tr = jreg.VectorIndexRegistry(), treg.VectorIndexRegistry("cpu")
    jd = jr.create("t", "ix", _config()).index
    td = tr.create("t", "ix", port_config(_config())).index
    ids = [str(i) for i in range(N)]
    for d in (jd, td):
        d.add_batch(ids, base)
        d.build()                  # compaction: head -> IVF tail
    return jd, td, base, q


def test_compacted_slice_matches_jax(pair):
    jd, td, _, q = pair
    assert td.head.get_stats().count == 0 and td.get_stats().count == N
    assert td.tail.describe_scan(64) == jd.tail.describe_scan(64) == "dense-pallas"
    assert _agreement(td.search_batch(q, 10), jd.search_batch(q, 10)) >= 0.99
    # device_search on the compacted composite: tail rows -> ids
    vals, rows = td.device_search(torch.from_numpy(q), 10)
    ids = td.resolve_rows(rows.numpy())
    assert ids == [[h.id for h in r] for r in td.search_batch(q, 10)]


def test_head_writes_merge_with_tail(pair):
    jd, td, base, q = pair
    for d in (jd, td):
        d.upsert("fresh", q[0])    # head shadows nothing: a new id
        d.delete("17")
    try:
        res_t, res_j = td.search_batch(q, 10), jd.search_batch(q, 10)
        assert res_t[0][0].id == "fresh"
        assert all(h.id != "17" for r in res_t for h in r)
        assert _agreement(res_t, res_j) >= 0.99
        opts = SearchOptions(nprobe=NLIST)  # every list: exact over the tail
        assert _agreement(td.search_batch(q, 10, port_options(opts)),
                          jd.search_batch(q, 10, opts)) >= 0.99
    finally:
        for d in (jd, td):
            d.delete("fresh")
            d.upsert("17", base[17])


@pytest.fixture(scope="module")
def pq_pair(pair):
    _, _, base, q = pair
    jd = jreg.create_index(_pq_config())
    td = treg.create_index(port_config(_pq_config()), "cpu")
    ids = [str(i) for i in range(N)]
    for d in (jd, td):
        d.add_batch(ids, base)
        d.build()
    return jd, td, q


def test_compacted_ivf_pq_sq8res_slice_matches_jax(pq_pair):
    jd, td, q = pq_pair
    assert type(td.tail).__name__ == "IvfPqIndex"
    assert td.head.get_stats().count == 0 and td.get_stats().count == N
    assert td.tail.describe_scan(64) == jd.tail.describe_scan(64) == "dense-sq8-pallas"
    assert td.tail.memory_bytes() == jd.tail.memory_bytes()
    assert _agreement(td.search_batch(q, 10), jd.search_batch(q, 10), atol=2e-3) >= 0.99
    vals, rows = td.device_search(torch.from_numpy(q), 10)
    assert td.resolve_rows(rows.numpy()) == [[h.id for h in r] for r in td.search_batch(q, 10)]
    # the probe route: ADC shortlist, reranked off the SQ8 slab
    for d in (jd, td):
        d.tail.scan_mode = "probe"
    try:
        assert td.tail.describe_scan(64) == "probe-adc+rerank-sq8"
        assert _agreement(td.search_batch(q, 10), jd.search_batch(q, 10), atol=2e-3) >= 0.99
    finally:
        for d in (jd, td):
            d.tail.scan_mode = "dense"


def test_registry_surface():
    tr = treg.VectorIndexRegistry("cpu")
    st = tr.get_or_create("t", "a", 8)
    assert tr.get_or_create("t", "a", 8) is st
    with pytest.raises(ValueError, match="dim"):
        tr.get_or_create("t", "a", 9)
    with pytest.raises(ValueError, match="exists"):
        tr.create("t", "a", tt.IndexConfig(dim=8))
    assert tr.increment_epoch("t", "a") == 1 and tr.get_epoch("t", "a") == 1
    assert tr.list_indexes() == [("t", "a")]
    assert tr.drop("t", "a") and tr.try_get("t", "a") is None
    flat = treg.create_index(tt.IndexConfig(dim=8, algorithm="FLAT"), "cpu")
    assert type(flat.tail).__name__ == "FlatIndex"
    pq = treg.create_index(tt.IndexConfig(dim=8, algorithm="IVF_PQ", params=tt.IndexParams(
        nlist=4, pq_m=2, k=16, refine=8, refine_storage="sq8res")), "cpu")
    tail = pq.tail
    assert type(tail).__name__ == "IvfPqIndex"
    assert (tail.nlist, tail.pq.m, tail.pq.ksub, tail.refine, tail.refine_storage) == (
        4, 2, 16, 8, "sq8res")
    assert type(treg.create_index(tt.IndexConfig(dim=8, algorithm="ivfpq"), "cpu").tail
                ).__name__ == "IvfPqIndex"
    hp = tt.IndexParams(m=8, ef_construction=40, ef_search=20, neighbor_heuristic=False,
                        build_mode="incremental", search_dtype="bfloat16")
    hnsw = treg.create_index(tt.IndexConfig(dim=8, algorithm="HNSW", params=hp), "cpu")
    head = treg.create_index(tt.IndexConfig(dim=8, head_algorithm="HNSW", params=hp), "cpu")
    for ix, build_mode in ((hnsw.tail, "incremental"), (head.head, "auto")):
        assert type(ix).__name__ == "HnswIndex"
        assert (ix.m, ix.ef_construction, ix.ef_search, ix.neighbor_heuristic,
                ix.build_mode, ix.search_dtype) == (8, 40, 20, False, build_mode, "bfloat16")
    with pytest.raises(ValueError, match="unknown algorithm"):
        treg.create_index(tt.IndexConfig(dim=8, algorithm="LSH"), "cpu")
