"""Port parity: index/hnsw.py against the JAX package's HnswIndex.

Two kinds of test. Each test of tests/test_hnsw.py has a counterpart here
on the port (``device="cpu"``, the same shapes and bounds). And one graph,
two searches: the JAX package builds a graph, ``convert.hnsw_from_arrays``
carries it across, and both beams search it. The port's node scores are
fp32 sums in another order than XLA's, so a hit may differ only as a k-th
place tie (``assert_hits_but_kth_ties``); scores within rtol 1e-5.
"""

import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401 (jax_native_build_dir: an autouse fixture)
    assert_hits_but_kth_ties,
    hits_to_arrays,
    jax_native_build_dir,
    port_options,
)

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions as JaxOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.hnsw import HnswIndex, beam_schedule, beam_search_body
from pyrope_tpu_torch.types import Metric, SearchOptions
from pyrope_tpu_torch.utils import ref_oracle
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_queries,
)


def built(n=500, dim=16, metric=Metric.L2, **kw):
    base = synthetic(n, dim)
    idx = HnswIndex(dim, metric, device="cpu", **kw)
    for i, v in enumerate(base):
        idx.add(str(i), v)
    return idx, base


def rows_of(results, k):
    return id_lists_to_rows([[h.id for h in r] for r in results], k)


# ---- counterparts of tests/test_hnsw.py -------------------------------------


def test_exact_match_found():
    idx, base = built(n=200)
    hits = idx.search(base[50], 5, SearchOptions(ef_search=50))
    assert hits[0].id == "50"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)


def test_nearest_neighbor_quality():
    idx, base = built(n=500)
    q = synthetic(16, 16, seed=5)
    truth = ground_truth(base, q, 10, "L2")
    res = idx.search_batch(q, 10, SearchOptions(ef_search=64))
    assert recall_at_k(rows_of(res, 10), truth, 10) >= 0.85


def test_upsert_on_duplicate_updates_vector():
    idx, base = built(n=100)
    nv = np.full(16, 5.0, np.float32)
    idx.upsert("30", nv)
    hits = idx.search(nv, 1, SearchOptions(ef_search=50))
    assert hits[0].id == "30"
    assert idx.get_stats().count == 100


def test_tombstone_delete():
    idx, base = built(n=150)
    assert idx.delete("60")
    assert not idx.delete("60")
    hits = idx.search(base[60], 10, SearchOptions(ef_search=50))
    assert all(h.id != "60" for h in hits)
    assert idx.get_stats().count == 149


def test_cosine_normalized_at_insert_and_query():
    idx, base = built(n=200, metric=Metric.COSINE)
    hits = idx.search(base[40] * 9.0, 1, SearchOptions(ef_search=50))
    assert hits[0].id == "40"
    assert hits[0].score == pytest.approx(1.0, abs=1e-3)


def test_inner_product_metric():
    idx, base = built(n=300, metric=Metric.INNER_PRODUCT)
    q = synthetic(4, 16, seed=8)
    truth = ground_truth(base, q, 5, "IP")
    res = idx.search_batch(q, 5, SearchOptions(ef_search=64))
    assert recall_at_k(rows_of(res, 5), truth, 5) >= 0.7


def test_empty_index():
    idx = HnswIndex(8, device="cpu")
    assert idx.search(np.ones(8, np.float32), 5) == []
    with pytest.raises(RuntimeError):
        idx.device_search(torch.ones(1, 8), 5)


def test_single_node():
    idx = HnswIndex(8, device="cpu")
    idx.add("only", np.ones(8, np.float32))
    hits = idx.search(np.ones(8, np.float32), 5)
    assert [h.id for h in hits] == ["only"]


def test_snapshot_load_roundtrip(tmp_path):
    idx, base = built(n=200)
    idx.delete("9")
    p = str(tmp_path / "hnsw.npz")
    idx.snapshot(p)
    fresh = HnswIndex(16, device="cpu")
    fresh.load(p)
    assert fresh.get_stats().count == 199
    hits = fresh.search(base[100], 3, SearchOptions(ef_search=50))
    assert hits[0].id == "100"
    assert all(h.id != "9" for h in fresh.search(base[9], 20, SearchOptions(ef_search=50)))
    # the format is the JAX package's: it loads the port's snapshot
    jix = jpt.HnswIndex(16)
    jix.load(p)
    assert jix.get_stats().count == 199
    assert np.array_equal(jix._adj0[:200], fresh._adj0[:200])


def test_batch_matches_single():
    idx, base = built(n=300)
    q = base[:4] + 0.001
    batch = idx.search_batch(q, 5, SearchOptions(ef_search=50))
    for i in range(4):
        single = idx.search(q[i], 5, SearchOptions(ef_search=50))
        assert [h.id for h in batch[i]] == [h.id for h in single]


def test_visited_pool_matches_bitmap_exactly():
    """In-pool dedup returns the bitmap's ids in the bitmap's order."""
    for data, qs in (
        (synthetic(5000, 24), synthetic_queries(64, 24)),
        (synthetic_clustered(5000, 24), synthetic_clustered_queries(64, 24)),
    ):
        ids = [str(i) for i in range(len(data))]
        a = HnswIndex(24, "L2", device="cpu", m=8, ef_construction=100,
                      visited_mode="pool")
        b = HnswIndex(24, "L2", device="cpu", m=8, ef_construction=100,
                      visited_mode="bitmap")
        a.add_batch(ids, data)
        b.add_batch(ids, data)
        for ef in (10, 50, 120):
            ra = a.search_batch(qs, 10, SearchOptions(ef_search=ef))
            rb = b.search_batch(qs, 10, SearchOptions(ef_search=ef))
            for i in range(len(qs)):
                assert [h.id for h in ra[i]] == [h.id for h in rb[i]], (ef, i)
                assert np.allclose([h.score for h in ra[i]],
                                   [h.score for h in rb[i]])


def test_bf16_beam_returns_fp32_exact_scores():
    """A bf16 beam's returned scores come from the fp32 rerank: equal to
    host fp32 scoring of the same rows."""
    idx, base = built(n=400, search_dtype="bfloat16")
    assert idx._sync()["x"].dtype == torch.bfloat16
    q = synthetic(8, 16, seed=9)
    res = idx.search_batch(q, 5, SearchOptions(ef_search=64))
    for qi, hits in enumerate(res):
        for h in hits:
            row = idx._id_to_row[h.id]
            exact = float(idx._scores(q[qi], np.array([row]))[0])
            assert h.score == pytest.approx(exact, rel=1e-6, abs=1e-5), (qi, h.id)


def test_bf16_matches_fp32_search():
    base = synthetic(600, 16)
    ids = [str(i) for i in range(len(base))]
    a = HnswIndex(16, "L2", device="cpu", m=8, ef_construction=100,
                  search_dtype="bfloat16")
    b = HnswIndex(16, "L2", device="cpu", m=8, ef_construction=100,
                  search_dtype="float32")
    a.add_batch(ids, base)
    b.add_batch(ids, base)
    q = synthetic(32, 16, seed=3)
    ra = a.search_batch(q, 10, SearchOptions(ef_search=80))
    rb = b.search_batch(q, 10, SearchOptions(ef_search=80))
    same = sum([h.id for h in ra[i]] == [h.id for h in rb[i]] for i in range(len(q)))
    assert same >= int(0.9 * len(q)), same
    for i in range(len(q)):
        for ha, hb in zip(ra[i], rb[i]):
            if ha.id == hb.id:
                assert ha.score == pytest.approx(hb.score, rel=1e-5)


@pytest.mark.parametrize("kw", [
    {"search_dtype": "fp16"}, {"visited_mode": "set"}, {"build_mode": "eager"},
])
def test_search_dtype_validation(kw):
    with pytest.raises(ValueError):
        HnswIndex(16, "L2", device="cpu", **kw)


def test_early_exit_is_a_fixed_point():
    """Twice the layer-0 budget gives the same ids: the loop stops at its
    fixed point, not at the cap."""
    idx, base = built(n=800)
    q = torch.from_numpy(synthetic(16, 16, seed=11))
    pool, steps = beam_schedule(48, 10)
    dev = idx._sync()
    args = (dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"], dev["adj_up"],
            dev["alive"], idx._entry, q)
    kw = dict(metric=Metric.L2, k=10, pool=pool, n_upper=dev["n_upper"], rerank=True)
    v1, r1 = beam_search_body(*args, steps=steps, **kw)
    v2, r2 = beam_search_body(*args, steps=steps * 2, **kw)
    assert torch.equal(r1, r2)
    assert torch.allclose(v1, v2)



def test_beam_counts_the_steps_it_ran():
    """``counts`` records the steps the loops ran (the beam's bound in
    chip_smoke reads them) and changes no result; the layer-0 count stops
    at the fixed point, short of its cap."""
    idx, base = built(n=800)
    q = torch.from_numpy(synthetic(16, 16, seed=11))
    pool, steps = beam_schedule(48, 10)
    dev = idx._sync()
    args = (dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"], dev["adj_up"],
            dev["alive"], idx._entry, q)
    kw = dict(metric=Metric.L2, k=10, pool=pool, n_upper=dev["n_upper"], steps=steps * 2)
    counts = {}
    v1, r1 = beam_search_body(*args, counts=counts, **kw)
    v2, r2 = beam_search_body(*args, **kw)
    assert torch.equal(r1, r2) and torch.equal(v1, v2)
    assert 0 < counts["layer0"] < steps * 2
    assert counts.get("upper", 0) <= dev["n_upper"] * 16

class TestRelabel:
    """relabel() permutes rows; results are INVARIANT."""

    def _built(self, n=1200, dim=16):
        rng = np.random.default_rng(3)
        base = rng.random((n, dim), dtype=np.float32)
        idx = HnswIndex(dim, "L2", device="cpu", m=8, ef_construction=64, ef_search=32)
        idx.add_batch([str(i) for i in range(n)], base)
        return idx, base, rng.random((16, dim), dtype=np.float32)

    @pytest.mark.parametrize("order", ["cluster", "bfs", "random"])
    def test_results_invariant(self, order):
        idx, base, q = self._built()
        before = [[(h.id, round(h.score, 5)) for h in r] for r in idx.search_batch(q, 10)]
        idx.relabel(order)
        after = [[(h.id, round(h.score, 5)) for h in r] for r in idx.search_batch(q, 10)]
        assert before == after

    def test_delete_upsert_after_relabel(self):
        idx, base, q = self._built(n=400)
        idx.relabel("cluster")
        assert idx.search(base[7], 1)[0].id == "7"
        assert idx.delete("7")
        assert all(h.id != "7" for h in idx.search(base[7], 10))
        idx.upsert("42", base[42] * 0.0 + 9.0)
        nv = np.full(16, 9.0, np.float32)
        assert idx.search(nv, 1)[0].id == "42"


# ---- one graph, two searches --------------------------------------------------


def _carried(tmp_path, metric, n=600, dim=16, **kw):
    """A JAX-built graph with tombstones, and the port's index over it."""
    base = synthetic(n, dim)
    jix = jpt.HnswIndex(dim, metric, m=8, ef_construction=64, ef_search=32, **kw)
    jix.add_batch([str(i) for i in range(n)], base)
    for i in range(0, n, 37):
        jix.delete(str(i))
    path = str(tmp_path / "jax.npz")
    jix.snapshot(path)
    if kw:  # options the snapshot does not record: set, then load
        tix = HnswIndex(dim, metric, device="cpu", **kw)
        tix.load(path)
    else:
        with np.load(path) as z:
            tix = convert.hnsw_from_arrays(z, "cpu")
    return jix, tix, base


@pytest.mark.parametrize("metric,visited_mode,search_dtype", [
    ("L2", "pool", "float32"), ("L2", "bitmap", "float32"),
    ("L2", "pool", "bfloat16"), ("L2", "bitmap", "bfloat16"),
    ("IP", "pool", "float32"), ("IP", "bitmap", "bfloat16"),
    ("COSINE", "pool", "float32"), ("COSINE", "bitmap", "bfloat16"),
])
def test_one_graph_two_searches(tmp_path, metric, visited_mode, search_dtype):
    jix, tix, base = _carried(tmp_path, metric, visited_mode=visited_mode,
                              search_dtype=search_dtype)
    assert tix.get_stats().count == jix.get_stats().count
    q = synthetic_queries(16, 16)
    assert_hits_but_kth_ties(*hits_to_arrays(tix.search_batch(q, 10)),
                             *hits_to_arrays(jix.search_batch(q, 10)))


def test_ef_search_override_matches_jax(tmp_path):
    jix, tix, _ = _carried(tmp_path, "L2")
    q = synthetic_queries(16, 16)
    for ef in (16, 100):
        opts = JaxOptions(ef_search=ef)
        assert_hits_but_kth_ties(*hits_to_arrays(tix.search_batch(q, 10, port_options(opts))),
                                 *hits_to_arrays(jix.search_batch(q, 10, opts)))


def test_beam_search_body_matches_jax_on_the_same_arrays(tmp_path):
    """beam_search_body on the JAX index's own device arrays, at the step
    cap and at twice it, against the JAX body at the same caps: the same
    ids, id for id."""
    import jax.numpy as jnp
    from pyrope_tpu.index.hnsw import _hnsw_search_fn
    from pyrope_tpu.ops.scalars import device_i32
    from pyrope_tpu.types import Metric as JaxMetric

    jix, _, _ = _carried(tmp_path, "L2", n=800)
    q = synthetic_queries(16, 16)
    pool, steps = beam_schedule(48, 10)
    jd = jix._sync()
    names = ("x", "x_exact", "sqnorm", "adj0", "adj_up", "alive")
    jargs = [jd[k] for k in names]
    ref = [_hnsw_search_fn(JaxMetric.L2, 10, pool, s, jd["n_upper"], "pool", False)(
        *jargs, device_i32(jix._entry), jnp.asarray(q)) for s in (steps, 2 * steps)]
    rv, ri = (np.asarray(a) for a in ref[0])
    assert np.array_equal(ri, np.asarray(ref[1][1]))
    targs = [torch.from_numpy(np.array(a)) for a in jargs]
    for s in (steps, 2 * steps):
        tv, ti = beam_search_body(
            *targs, jix._entry, torch.from_numpy(q), metric=Metric.L2, k=10,
            pool=pool, steps=s, n_upper=jd["n_upper"])
        assert np.array_equal(ti.numpy(), ri)
        np.testing.assert_allclose(tv.numpy(), rv, rtol=1e-5, atol=1e-4)


def test_oracle_runs_on_the_ports_graph(tmp_path):
    """The copied oracle's sequential search reads the port's index as the
    JAX package's oracle reads the JAX index: the same rows."""
    from pyrope_tpu.utils import ref_oracle as jax_oracle

    jix, tix, _ = _carried(tmp_path, "L2")
    for qv in synthetic_queries(4, 16):
        assert np.array_equal(ref_oracle.ref_hnsw_search(tix, qv, 32, 10),
                              jax_oracle.ref_hnsw_search(jix, qv, 32, 10))


def test_bf16_beam_trails_fp32_as_in_the_jax_package(tmp_path):
    """On clustered rows the bf16 beam's rounded node scores are coarser
    than the margins between neighbours, so its walk reaches fewer true
    neighbours than the fp32 walk. The JAX package's two beams, on one
    graph on the CPU (IEEE fp32), trail by the same recall as the port's:
    the gap is the algorithm's, not the port's."""
    n, d, k = 10_000, 128, 10
    base = synthetic_clustered(n, d, n_clusters=100)
    q = synthetic_clustered_queries(256, d, n_clusters=100)
    truth = ground_truth(base, q, k)
    tix = HnswIndex(d, "L2", device="cpu", m=16, ef_construction=200, ef_search=16)
    tix.add_batch([str(i) for i in range(n)], base)
    path = str(tmp_path / "g.npz")
    tix.snapshot(path)
    t16 = HnswIndex(d, "L2", device="cpu", search_dtype="bfloat16")
    t16.load(path)
    recalls = {}
    for name, ix in (("port fp32", tix), ("port bf16", t16)):
        recalls[name] = recall_at_k(rows_of(ix.search_batch(q, k), k), truth, k)
    for dtype in ("float32", "bfloat16"):
        jix = jpt.HnswIndex(d, "L2", search_dtype=dtype)
        jix.load(path)
        recalls[f"jax {dtype}"] = recall_at_k(
            rows_of(jix.search_batch(q, k), k), truth, k)
    print(recalls)
    assert recalls["port fp32"] == recalls["jax float32"]
    assert recalls["port bf16"] == recalls["jax bfloat16"]
    assert recalls["port bf16"] < recalls["port fp32"]
