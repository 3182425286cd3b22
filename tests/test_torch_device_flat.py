"""Port parity: index/device_flat.py (DeviceFlatIndex) against the JAX package.

Twins of tests/test_device_flat.py: the same numpy corpus goes into the JAX
DeviceFlatIndex and the port's (``device="cpu"``), and each check of the
JAX test runs on both, with the hits held equal: ``selection="exact"``
(plain torch against XLA) and ``selection="pallas"`` (the flat scan's
plain version on the CPU against the Pallas kernel in interpret mode; a
bf16 slab through the kernel's bf16 mode). fp32 on both sides, other
summation order: scores within rtol 1e-5 / atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import assert_hits_but_kth_ties, assert_same_results, hits_to_arrays

import pyrope_tpu as jpt
from pyrope_tpu.ops.topk import chunked_exact_topk as jax_chunked_exact_topk
from pyrope_tpu.utils.datasets import ground_truth
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.ops.topk import chunked_exact_topk
from pyrope_tpu_torch.types import Metric, SearchOptions


def make_corpus(n=60, dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, dim)).astype(np.float32)


def both(vecs, metric="L2", **kw):
    """(JAX index, port index) over the same corpus."""
    return (jpt.DeviceFlatIndex(jnp.asarray(vecs), metric, **kw),
            DeviceFlatIndex(torch.from_numpy(vecs), metric, **kw))


@pytest.mark.parametrize("selection", ["exact", "pallas"])
def test_parity_with_flat_index(selection):
    vecs = make_corpus()
    q = make_corpus(n=8, dim=16, seed=1)
    host = FlatIndex(16, "L2", device="cpu")
    host.add_batch([str(i) for i in range(len(vecs))], vecs)
    jdev, dev = both(vecs, selection=selection)
    assert_same_results(dev.search_batch(q, 5), host.search_batch(q, 5))
    assert_same_results(dev.search_batch(q, 5), jdev.search_batch(q, 5))


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_pallas_selection_matches_ground_truth(metric):
    vecs = make_corpus(n=100)
    q = make_corpus(n=4, dim=16, seed=2)
    jdev, dev = both(vecs, metric, selection="pallas")
    assert dev.describe_scan() == jdev.describe_scan() == "device-pallas"
    truth = ground_truth(vecs, q, 5, metric)
    got = np.array([[int(h.id) for h in row] for row in dev.search_batch(q, 5)])
    assert (got == truth).all()
    assert_same_results(dev.search_batch(q, 5), jdev.search_batch(q, 5))


def test_bf16_slab_matches_jax():
    """A bf16 slab adopted as it is: the scan kernel's bf16 mode (bf16(q)
    against the bf16 rows, fp32 sums) against the JAX kernel's bf16 branch,
    sqnorms of the bf16 rows widened on both sides."""
    vecs = make_corpus(n=300, dim=32)
    q = make_corpus(n=8, dim=32, seed=9)
    jdev = jpt.DeviceFlatIndex(jnp.asarray(vecs, jnp.bfloat16), "L2", selection="pallas")
    dev = DeviceFlatIndex(torch.from_numpy(vecs).bfloat16(), "L2", selection="pallas")
    assert dev._dev["vecs"].dtype == torch.bfloat16
    assert_hits_but_kth_ties(*hits_to_arrays(dev.search_batch(q, 10)),
                             *hits_to_arrays(jdev.search_batch(q, 10)))


def test_tensor_adopted_in_place():
    x = torch.from_numpy(make_corpus(n=50))
    dev = DeviceFlatIndex(x, "L2")
    assert dev._dev["vecs"] is x
    assert dev.device == torch.device("cpu")


def test_numpy_input_uploaded():
    vecs = make_corpus(n=20)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact", device="cpu")
    hits = dev.search(vecs[7], 1)
    assert hits[0].id == "7"
    assert hits[0].score == pytest.approx(0.0, abs=1e-3)
    assert hits[0].score == pytest.approx(
        jpt.DeviceFlatIndex(vecs, "L2", selection="exact").search(vecs[7], 1)[0].score,
        abs=1e-4)


@pytest.mark.parametrize("selection", ["exact", "pallas"])
def test_n_valid_masks_padding_tail(selection):
    vecs = make_corpus(n=32)
    padded = np.concatenate([vecs, np.zeros((8, 16), np.float32)])
    jdev, dev = both(padded, n_valid=32, selection=selection)
    # a zero query would otherwise hit the zero pad rows at distance 0
    hits = dev.search(np.zeros(16, np.float32), 40)
    assert len(hits) == 32
    assert all(int(h.id) < 32 for h in hits)
    assert len(dev) == len(jdev) == 32
    assert_same_results([hits], [jdev.search(np.zeros(16, np.float32), 40)])


def test_frozen_mutation_raises():
    dev = DeviceFlatIndex(make_corpus(n=10), "L2", device="cpu")
    with pytest.raises(RuntimeError, match="frozen"):
        dev.add("x", np.zeros(16, np.float32))
    with pytest.raises(RuntimeError, match="frozen"):
        dev.upsert("0", np.zeros(16, np.float32))
    with pytest.raises(RuntimeError, match="frozen"):
        dev.delete("0")


def test_explicit_ids_and_scan():
    vecs = make_corpus(n=6)
    ids = [f"doc-{i}" for i in range(6)]
    jdev, dev = both(vecs, ids=ids, selection="exact")
    hits = dev.search(vecs[3], 1)
    assert hits[0].id == "doc-3"
    scanned = dict(dev.scan())
    assert set(scanned) == set(ids) == set(dict(jdev.scan()))
    np.testing.assert_allclose(scanned["doc-2"], vecs[2], rtol=1e-6)


def test_cosine_normalizes_at_ingest():
    vecs = make_corpus(n=30, dim=12)
    q = make_corpus(n=1, dim=12, seed=3)[0]
    jdev, dev = both(vecs, "COSINE", selection="exact")
    hits = dev.search(q, 5)
    cos = (vecs @ q) / (np.linalg.norm(vecs, axis=1) * np.linalg.norm(q))
    order = np.argsort(-cos)[:5]
    assert [int(h.id) for h in hits] == [int(i) for i in order]
    for h, i in zip(hits, order):
        assert h.score == pytest.approx(float(cos[i]), rel=1e-3, abs=1e-3)
    assert_same_results([hits], [jdev.search(q, 5)])


@pytest.mark.parametrize("selection", ["exact", "pallas"])
def test_max_scans_budget(selection):
    vecs = make_corpus(n=50)
    jdev, dev = both(vecs, selection=selection)
    q = vecs[40]
    opts = SearchOptions(max_scans=10)
    hits = dev.search(q, 1, opts)
    # row 40 is beyond the scan budget: the best hit must come from rows <10
    assert int(hits[0].id) < 10
    assert_same_results(dev.search_batch(vecs[30:38], 4, opts),
                        jdev.search_batch(vecs[30:38], 4, jpt.SearchOptions(max_scans=10)))


def test_snapshot_roundtrip_into_flat_index(tmp_path):
    """The port's snapshot loads into the port's FlatIndex and the JAX
    package's; the JAX DeviceFlatIndex's into the port's FlatIndex."""
    vecs = make_corpus(n=25)
    q = make_corpus(n=3, dim=16, seed=4)
    jdev, dev = both(vecs, selection="exact")
    dev.snapshot(str(tmp_path / "t.npz"))
    jdev.snapshot(str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        host = FlatIndex(16, "L2", device="cpu")
        host.load(str(tmp_path / path))
        jhost = jpt.FlatIndex(16, "L2")
        jhost.load(str(tmp_path / path))
        assert_same_results(host.search_batch(q, 5), dev.search_batch(q, 5))
        assert_same_results(jhost.search_batch(q, 5), dev.search_batch(q, 5))


def test_device_load_roundtrip(tmp_path):
    vecs = make_corpus(n=25)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact", device="cpu")
    path = str(tmp_path / "snap.npz")
    dev.snapshot(path)
    dev2 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2", selection="exact",
                           device="cpu")
    dev2.load(path)
    q = make_corpus(n=3, dim=16, seed=5)
    assert_same_results(dev.search_batch(q, 5), dev2.search_batch(q, 5))


def test_device_load_keeps_implicit_ids(tmp_path):
    vecs = make_corpus(n=25)
    dev = DeviceFlatIndex(vecs, "L2", selection="exact", device="cpu")
    assert dev._row_ids is None
    path = str(tmp_path / "snap.npz")
    dev.snapshot(path)
    dev2 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2", selection="exact",
                           device="cpu")
    dev2.load(path)
    assert dev2._row_ids is None and dev2._id_to_row is None
    assert dev2.search(vecs[7], 1)[0].id == "7"
    # explicit-id snapshots keep their ids through load
    dev3 = DeviceFlatIndex(vecs, "L2", ids=[f"d{i}" for i in range(25)],
                           selection="exact", device="cpu")
    path2 = str(tmp_path / "snap2.npz")
    dev3.snapshot(path2)
    dev4 = DeviceFlatIndex(np.zeros((4, 16), np.float32), "L2", selection="exact",
                           device="cpu")
    dev4.load(path2)
    assert dev4.search(vecs[7], 1)[0].id == "d7"


@pytest.mark.parametrize("storage", ["fp32", "bf16"])
def test_jax_snapshot_carries_across(tmp_path, storage):
    """convert.device_flat_from_arrays re-adopts a JAX DeviceFlatIndex's
    snapshot (implicit ids, the storage's dtype) and searches as it does."""
    vecs = make_corpus(n=120, dim=16)
    q = make_corpus(n=6, dim=16, seed=8)
    jx = jnp.asarray(vecs, jnp.bfloat16 if storage == "bf16" else jnp.float32)
    jdev = jpt.DeviceFlatIndex(jx, "IP", selection="pallas")
    jdev.snapshot(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as z:
        dev = convert.device_flat_from_arrays(z, "cpu")
    assert dev._row_ids is None and dev.metric == Metric.INNER_PRODUCT
    assert dev._dev["vecs"].dtype == (torch.bfloat16 if storage == "bf16" else torch.float32)
    check = assert_hits_but_kth_ties if storage == "bf16" else assert_same_results
    if storage == "bf16":
        check(*hits_to_arrays(dev.search_batch(q, 10)),
              *hits_to_arrays(jdev.search_batch(q, 10)))
    else:
        check(dev.search_batch(q, 10), jdev.search_batch(q, 10))


def test_stats_and_memory():
    jdev, dev = both(make_corpus(n=40))
    st = dev.get_stats()
    assert st.count == 40 and st.dim == 16 and st.metric == Metric.L2
    # the port adopts the slab unpadded: the JAX package pads to 4096 rows
    assert dev.memory_bytes() == 40 * 16 * 4 + 40 * 4 + 40
    assert jdev.memory_bytes() == 4096 * 16 * 4 + 4096 * 4 + 4096
    assert dev.describe_scan() == jdev.describe_scan() == "device-pallas"
    assert (DeviceFlatIndex(torch.zeros(4, 16), "L2", selection="exact").describe_scan()
            == "device-exact")


def test_bad_inputs():
    vecs = make_corpus(n=10)
    with pytest.raises(ValueError, match="n_valid"):
        DeviceFlatIndex(vecs, "L2", n_valid=11, device="cpu")
    with pytest.raises(ValueError, match="ids"):
        DeviceFlatIndex(vecs, "L2", ids=["a"], device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        DeviceFlatIndex(vecs, "L2", ids=["a"] * 10, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        DeviceFlatIndex(torch.from_numpy(vecs).int(), "L2")
    with pytest.raises(ValueError, match="selection"):
        DeviceFlatIndex(vecs, "L2", selection="bogus", device="cpu")


# ---- chunked exact ground truth (the port's ops/topk.chunked_exact_topk) ----


def _slab(vecs):
    x = torch.from_numpy(vecs)
    return x, (x * x).sum(-1)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_chunked_exact_topk_matches_host(metric):
    vecs = make_corpus(n=300, dim=8)
    q = make_corpus(n=7, dim=8, seed=6)
    x, sq = _slab(vecs)
    alive = torch.ones(300, dtype=torch.bool)
    vals, idx = chunked_exact_topk(x, sq, alive, torch.from_numpy(q), 10, metric,
                                   chunk_rows=64)
    assert (idx == ground_truth(vecs, q, 10, metric)).all()
    v1, i1 = chunked_exact_topk(x, sq, alive, torch.from_numpy(q), 10, metric,
                                chunk_rows=1024)
    assert (i1 == idx).all()
    np.testing.assert_allclose(v1, vals, rtol=1e-5, atol=1e-5)
    jx = jnp.asarray(vecs)
    jv, ji = jax_chunked_exact_topk(jx, jnp.sum(jx * jx, axis=-1), jnp.ones(300, bool),
                                    jnp.asarray(q), 10, metric, chunk_rows=64)
    assert (np.asarray(ji) == idx).all()
    np.testing.assert_allclose(vals, np.asarray(jv), rtol=1e-5, atol=1e-4)


def test_chunked_exact_topk_short_tail_chunk():
    vecs = make_corpus(n=130, dim=8)
    q = make_corpus(n=3, dim=8, seed=7)
    x, sq = _slab(vecs)
    vals, idx = chunked_exact_topk(x, sq, torch.ones(130, dtype=torch.bool),
                                   torch.from_numpy(q), 10, "L2", chunk_rows=128)
    assert (idx == ground_truth(vecs, q, 10, "L2")).all()
    assert np.isfinite(vals).all()


def test_chunked_exact_topk_respects_alive_mask():
    vecs = make_corpus(n=50, dim=8)
    x, sq = _slab(vecs)
    alive = torch.from_numpy(np.arange(50) < 40)
    _, idx = chunked_exact_topk(x, sq, alive, torch.from_numpy(vecs[45:46]), 5, "L2",
                                chunk_rows=16)
    assert (idx[idx >= 0] < 40).all()
