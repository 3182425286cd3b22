"""Port parity: index/flat.py against the JAX package's FlatIndex.

The same writes go to both indexes and every search must return the same
hits: ``selection="exact"`` (plain torch against XLA) and
``selection="pallas"`` (the plain twin of the CUDA kernel on the CPU
against the Pallas kernel in interpret mode). fp32 on both sides with a
different summation order: scores within rtol 1e-5 / atol 1e-4.
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_same_results, port_options, stats_tuple

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.flat import FlatIndex


def _mutate(ix, base):
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix.delete("4")
    ix.delete("9")
    ix.add("9", base[0] + 0.5)         # revive a tombstone in place
    ix.upsert("11", base[1])
    ix.add("extra", base[2] * 0.5)     # new row after the bulk load


@pytest.mark.parametrize("selection,metric", [
    ("exact", "L2"), ("exact", "COSINE"), ("pallas", "L2"), ("pallas", "IP"),
])
def test_flat_matches_jax_after_mutations(selection, metric):
    rng = np.random.default_rng(0)
    base = rng.random((1500, 16), np.float32)
    q = rng.random((8, 16), np.float32)
    jix = jpt.FlatIndex(16, metric, selection=selection)
    tix = FlatIndex(16, metric, device="cpu", selection=selection)
    for ix in (jix, tix):
        _mutate(ix, base)
    assert stats_tuple(tix.get_stats()) == stats_tuple(jix.get_stats())
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10))
    opts = SearchOptions(max_scans=700)
    assert_same_results(tix.search_batch(q, 10, port_options(opts)),
                        jix.search_batch(q, 10, opts))


def test_incremental_sync_scatters_rows():
    rng = np.random.default_rng(1)
    base = rng.random((500, 8), np.float32)
    ix = FlatIndex(8, "L2", device="cpu", selection="pallas")
    ix.add_batch([str(i) for i in range(500)], base)
    ix.search(base[0], 1)               # full upload
    slab = ix._dev["vecs"]
    ix.delete("3")
    ix.upsert("5", base[7])
    assert ix._dirty_rows == {3, 5}
    assert [h.id for h in ix.search(base[7], 2)] in (["5", "7"], ["7", "5"])
    assert ix._dev["vecs"] is slab     # updated in place, not re-uploaded
    assert all(h.id != "3" for h in ix.search(base[3], 5))
    np.testing.assert_allclose(ix._dev["sqnorm"][5].item(),
                               float(base[7] @ base[7]), rtol=1e-6)


def test_k_beyond_count_and_device_search():
    ix = FlatIndex(4, "L2", device="cpu", selection="pallas")
    ix.add_batch(["a", "b"], np.eye(2, 4, dtype=np.float32))
    assert [h.id for h in ix.search(np.eye(1, 4, dtype=np.float32)[0], 5)] == ["a", "b"]
    vals, rows = ix.device_search(torch.zeros((3, 4)), 4)
    assert rows.shape == (3, 4) and (rows[:, 2:] == -1).all()
    assert ix.resolve_rows(rows.numpy())[0][2:] == ["", ""]
    assert ix.describe_scan() == "flat-pallas"
    assert FlatIndex(4, "COSINE", device="cpu", selection="pallas").describe_scan() == "flat-exact"


def test_snapshot_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(2)
    base = rng.random((300, 8), np.float32)
    q = rng.random((4, 8), np.float32)
    jix = jpt.FlatIndex(8, "IP")
    _mutate(jix, base)
    jix.snapshot(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as z:
        tix = convert.flat_from_arrays(z, "cpu")
    assert tix.metric.value == jix.metric.value
    assert_same_results(tix.search_batch(q, 5), jix.search_batch(q, 5))
    tix.snapshot(str(tmp_path / "t.npz"))
    back = jpt.FlatIndex(8, "L2")
    back.load(str(tmp_path / "t.npz"))
    assert_same_results(back.search_batch(q, 5), jix.search_batch(q, 5))


def test_not_yet_ported_options_raise():
    """The storage options and their refusals match the JAX package's: no
    storage is left unported, so sq8 builds (its parity tests are in
    test_torch_flat_sq8.py), and what the JAX package refuses still
    raises."""
    assert FlatIndex(8, "L2", device="cpu", storage="sq8").describe_scan() == "flat-sq8"
    with pytest.raises(ValueError, match="fp32"):
        FlatIndex(8, "L2", device="cpu", storage="sq8", selection="hybrid")
    # the hybrid route reranks off an fp32 slab, as in the JAX package
    with pytest.raises(ValueError, match="fp32"):
        FlatIndex(8, "L2", device="cpu", storage="bf16", selection="hybrid")
    with pytest.raises(ValueError):
        FlatIndex(8, "L2", device="cpu", storage="fp16")
