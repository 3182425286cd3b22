"""Port parity of HNSW's builders and registry branches against the JAX
package: the native C++ builder (the same source and flags give the same
graph, bit for bit), the device bootstrap (``ops/hnsw_bootstrap.py``),
and Delta composites with an HNSW tail and an HNSW head.

The bootstrap graphs are not compared bit for bit: its k-means sums
Lloyd's update in another order than the JAX package's (see
test_torch_build_parity.py), so a row near a cluster boundary may take
other candidates. They are held to recall within 0.01 of the JAX graph's
and to a graph overlap (the share of adj0 links both graphs hold) of at
least 0.99; measured 0.99983 on the 4000 x 16 corpus below.
"""

import numpy as np
import pytest
import torch

import pyrope_tpu as jpt
from pyrope_tpu import registry as jreg
from pyrope_tpu.types import IndexConfig, IndexParams
from pyrope_tpu_torch import registry as treg
from pyrope_tpu_torch.index.hnsw import HnswIndex
from pyrope_tpu_torch.native import build as native_build
from pyrope_tpu_torch.native import hnsw_build_native
from pyrope_tpu_torch.ops.hnsw_bootstrap import _fill_tail_slots
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
)
from _torch_parity import (  # noqa: F401 (jax_native_build_dir: an autouse fixture)
    assert_hits_but_kth_ties,
    hits_to_arrays,
    jax_native_build_dir,
    port_config,
)

GRAPH_OVERLAP_MIN = 0.99


def rows_of(results, k=10):
    return id_lists_to_rows([[h.id for h in r] for r in results], k)


# ---- the native builder ---------------------------------------------------


@pytest.mark.parametrize("metric,heuristic", [
    ("L2", True), ("L2", False), ("IP", True), ("COSINE", True),
])
def test_native_graph_is_bit_equal_to_jax(metric, heuristic):
    from pyrope_tpu.native import hnsw_build_native as jax_build, native_available

    n, dim, m = 1500, 16, 8
    base = synthetic(n, dim)
    ids = [str(i) for i in range(n)]
    jix = jpt.HnswIndex(dim, metric, m=m, ef_construction=60,
                        neighbor_heuristic=heuristic)
    tix = HnswIndex(dim, metric, device="cpu", m=m, ef_construction=60,
                    neighbor_heuristic=heuristic)
    jix.add_batch(ids, base)
    tix.add_batch(ids, base)
    assert native_available()  # the JAX side ran its native builder too
    assert (tix._entry, tix._top_level) == (jix._entry, jix._top_level)
    assert np.array_equal(tix._levels[:n], jix._levels[:n])
    assert np.array_equal(tix._adj0[:n], jix._adj0[:n])
    assert len(tix._adj_up) == len(jix._adj_up)
    for a, b in zip(tix._adj_up, jix._adj_up):
        assert np.array_equal(a[:n], b[:n])
    # and the wrappers alone, on the index's levels
    levels = tix._levels[:n]
    got = hnsw_build_native(base, levels, m, 60, metric == "L2", heuristic)
    want = jax_build(base, levels, m, 60, metric == "L2", heuristic)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a build that fails raises with g++'s stderr."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "hnsw_builder.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native_build, "_SRC_DIR", src)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native_build, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        native_build.load_native()
    assert not list((tmp_path / "out").iterdir())  # no partial library left
    ix = HnswIndex(8, device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        ix.add_batch(["a", "b"], np.eye(2, 8, dtype=np.float32))


# ---- the device bootstrap ---------------------------------------------------


def test_bootstrap_build_recall_parity():
    """The port's bootstrap against the JAX package's on the same corpus
    and level draws: recall within 0.01 (and >= 0.85, the JAX test's
    bound against the incremental builder), graph overlap >= 0.99."""
    n, dim = 4000, 16
    base = synthetic_clustered(n, dim, n_clusters=20)
    q = synthetic_clustered_queries(32, dim, n_clusters=20)
    truth = ground_truth(base, q, 10, "L2")
    ids = [str(i) for i in range(n)]
    kw = dict(m=16, ef_construction=100, ef_search=50, build_mode="bootstrap")
    jix = jpt.HnswIndex(dim, "L2", **kw)
    tix = HnswIndex(dim, "L2", device="cpu", **kw)
    jix.add_batch(ids, base)
    tix.add_batch(ids, base)
    rj = recall_at_k(rows_of(jix.search_batch(q, 10)), truth, 10)
    rt = recall_at_k(rows_of(tix.search_batch(q, 10)), truth, 10)
    assert abs(rt - rj) <= 0.01 and rt >= 0.85, (rt, rj)
    a, b = tix._adj0[:n], jix._adj0[:n]
    common = sum(len(set(x[x >= 0]) & set(y[y >= 0])) for x, y in zip(a, b))
    overlap = common / int((b >= 0).sum())
    print(f"bootstrap recall@10 port {rt} jax {rj}; adj0 overlap {overlap:.5f}")
    assert overlap >= GRAPH_OVERLAP_MIN
    assert np.array_equal(tix._levels[:n], jix._levels[:n])  # promotions too


def test_bootstrap_graph_structure():
    """In-range ids, no self loops, entry at the top level, upper-layer
    links only among nodes of that level; per-row writes after the bulk
    build go through the incremental insert."""
    n, dim = 2000, 8
    base = synthetic(n, dim)
    idx = HnswIndex(dim, "L2", device="cpu", m=8, build_mode="bootstrap")
    idx.add_batch([str(i) for i in range(n)], base)
    adj0 = idx._adj0[:n]
    assert adj0.max() < n
    assert not (adj0 == np.arange(n)[:, None]).any()
    assert idx._levels[idx._entry] == idx._top_level
    for lev, a in enumerate(idx._adj_up, start=1):
        rows = np.flatnonzero((a[:n] >= 0).any(axis=1))
        assert (idx._levels[rows] >= lev).all()
        nbrs = a[rows]
        assert (idx._levels[nbrs[nbrs >= 0]] >= lev).all()
    idx.add("new", np.full(dim, 0.5, np.float32))
    assert idx.search(np.full(dim, 0.5, np.float32), 1)[0].id == "new"
    idx.delete("17")
    assert all(h.id != "17" for h in idx.search(base[17], 10))


def test_bootstrap_requires_heuristic_falls_back():
    """closest-M indexes take the native builder even in bootstrap mode."""
    base = synthetic(500, 8)
    idx = HnswIndex(8, "L2", device="cpu", m=8, neighbor_heuristic=False,
                    build_mode="bootstrap")
    idx.add_batch([str(i) for i in range(500)], base)
    assert idx.get_stats().count == 500
    assert idx.search(base[3], 1)[0].id == "3"


def test_fill_tail_slots_no_collision():
    row = np.array([10, 11, 12, 13, -1, -1], np.int32)  # free = tail slots
    _fill_tail_slots(row, [100, 101, 102, 103])
    assert sorted(x for x in row if x >= 100) == [100, 101, 102, 103]
    assert row[4] == 100 and row[5] == 101
    assert row[3] == 102 and row[2] == 103
    assert row[0] == 10 and row[1] == 11
    row2 = np.array([-1, 20, -1, 21], np.int32)
    _fill_tail_slots(row2, [7])
    assert list(row2) == [7, 20, -1, 21]


# ---- the registry's HNSW branches, through a Delta compaction ---------------


N, D = 3000, 16
PARAMS = dict(m=8, ef_construction=64, ef_search=40)


def test_registry_hnsw_tail_matches_jax():
    """Delta(Flat, HNSW): writes land in the Flat head, build() compacts
    them into the HNSW tail (one native build: the same graph in both)."""
    cfg = IndexConfig(dim=D, algorithm="HNSW", params=IndexParams(**PARAMS))
    jd, td = jreg.create_index(cfg), treg.create_index(port_config(cfg), "cpu")
    base = synthetic_clustered(N, D, n_clusters=20)
    q = synthetic_clustered_queries(16, D, n_clusters=20)
    for d in (jd, td):
        d.add_batch([str(i) for i in range(N)], base)
        d.build()
        d.add("fresh", q[0])   # a head write after the compaction
    assert td.head.get_stats().count == 1 and td.tail.get_stats().count == N
    assert np.array_equal(td.tail._adj0[:N], jd.tail._adj0[:N])
    res = td.search_batch(q, 10)
    assert res[0][0].id == "fresh"
    assert_hits_but_kth_ties(*hits_to_arrays(res), *hits_to_arrays(jd.search_batch(q, 10)))


def test_registry_hnsw_head_compacts_into_ivf_pq():
    """Delta(HNSW, IVF_PQ): bulk writes build the HNSW head natively (the
    same graph in both), searches before compaction match the JAX
    package's, build() compacts into IVF-PQ, and streamed adds land in
    the head's graph again."""
    cfg = IndexConfig(dim=D, algorithm="IVF_PQ", head_algorithm="HNSW", params=IndexParams(
        nlist=16, pq_m=4, k=64, nprobe=16, **PARAMS))
    jd, td = jreg.create_index(cfg), treg.create_index(port_config(cfg), "cpu")
    base = synthetic_clustered(N, D, n_clusters=20)
    q = synthetic_clustered_queries(16, D, n_clusters=20)
    for d in (jd, td):
        d.add_batch([str(i) for i in range(N)], base)
    assert type(td.head).__name__ == "HnswIndex"
    assert np.array_equal(td.head._adj0[:N], jd.head._adj0[:N])
    assert_hits_but_kth_ties(*hits_to_arrays(td.search_batch(q, 10)),
                             *hits_to_arrays(jd.search_batch(q, 10)))
    td.build()
    assert td.head.get_stats().count == 0 and td.tail.get_stats().count == N
    truth = ground_truth(base, q, 10, "L2")
    assert recall_at_k(rows_of(td.search_batch(q, 10)), truth, 10) >= 0.9
    vals, rows = td.device_search(torch.from_numpy(q), 10)
    assert td.resolve_rows(rows.numpy()) == [[h.id for h in r] for r in td.search_batch(q, 10)]
    for i in range(20):
        assert td.add(f"s{i}", q[i % 16] + 0.001 * i)
    assert td.search(q[3] + 0.003, 1)[0].id == "s3"
    assert td.get_stats().count == N + 20
