"""Port parity: Flat ``storage="sq8"`` and ``capacity`` against the JAX package.

The same writes go to the JAX FlatIndex and the port's and every search
must return the same hits. The SQ8 product runs on bf16-rounded operands
summed in fp32 on both sides (the JAX package's
``preferred_element_type=float32`` dot; the port's fp32 matmul of the
rounded values, exact products), in another summation order: scores
within the JAX package's SQ8 tolerance (rtol 1e-4, atol 1e-4), a hit may
differ only inside a run of near-equal scores.
"""

import numpy as np
import pytest
import torch
from _torch_parity import SQ8_RTOL, assert_same_results, port_options, stats_tuple

import pyrope_tpu as jpt
from pyrope_tpu.index import flat as jflat
from pyrope_tpu.types import SearchOptions
from pyrope_tpu.utils.datasets import ground_truth, recall_at_k
from pyrope_tpu.utils.datasets import synthetic as jsynthetic
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index import flat as tflat
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.types import Metric


def _mutate(ix, base):
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix.delete("4")
    ix.delete("9")
    ix.add("9", base[0] + 0.5)         # revive a tombstone in place
    ix.upsert("11", base[1])
    ix.add("extra", base[2] * 0.5)     # a new row after the bulk load


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_sq8_matches_jax_after_mutations(metric):
    rng = np.random.default_rng(0)
    base = rng.random((1500, 16), np.float32)
    q = rng.random((8, 16), np.float32)
    jix = jpt.FlatIndex(16, metric, storage="sq8")
    tix = FlatIndex(16, metric, device="cpu", storage="sq8")
    for ix in (jix, tix):
        _mutate(ix, base)
    assert stats_tuple(tix.get_stats()) == stats_tuple(jix.get_stats())
    assert tix.describe_scan(8) == jix.describe_scan(8) == "flat-sq8"
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10), rtol=SQ8_RTOL)
    opts = SearchOptions(max_scans=700)
    assert_same_results(tix.search_batch(q, 10, port_options(opts)),
                        jix.search_batch(q, 10, opts), rtol=SQ8_RTOL)


def test_sq8_incremental_sync_matches_jax():
    """After the first upload, writes scatter into the device slab in place
    (codes, mins, scales, sqnorm, alive), as the JAX package's _scatter5."""
    rng = np.random.default_rng(1)
    base = rng.random((600, 16), np.float32)
    q = rng.random((6, 16), np.float32)
    jix = jpt.FlatIndex(16, "L2", storage="sq8")
    tix = FlatIndex(16, "L2", device="cpu", storage="sq8")
    for ix in (jix, tix):
        ix.add_batch([str(i) for i in range(600)], base)
        ix.search_batch(q, 5)                        # full upload
    codes = tix._dev["codes"]
    for ix in (jix, tix):
        ix.upsert("3", base[7] * 0.9)
        ix.delete("5")
        ix.add("new", base[8] + 0.01)
    assert tix._dirty_rows == {3, 5, 600}
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10), rtol=SQ8_RTOL)
    assert tix._dev["codes"] is codes                # updated in place
    assert tix.search(base[7] * 0.9, 1)[0].id == "3"


def test_sq8_quantize_matches_jax():
    rng = np.random.default_rng(2)
    v = rng.normal(size=(300, 24)).astype(np.float32)
    v[7] = 0.25                                       # a constant row: scale 0
    for a, b in zip(tflat.sq8_quantize(v), jflat.sq8_quantize(v)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
@pytest.mark.parametrize("compute", [None, "float32"])
def test_sq8_scores_match_jax(metric, compute):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    v = rng.normal(size=(400, 32)).astype(np.float32)
    q = rng.normal(size=(5, 32)).astype(np.float32)
    codes, mins, scales, sq = tflat.sq8_host_state(v)
    got = tflat.sq8_scores(torch.from_numpy(codes), torch.from_numpy(mins),
                           torch.from_numpy(scales), torch.from_numpy(sq),
                           torch.from_numpy(q), Metric.parse(metric), compute)
    want = jflat.sq8_scores(jnp.asarray(codes), jnp.asarray(mins), jnp.asarray(scales),
                            jnp.asarray(sq), jnp.asarray(q), jpt.Metric.parse(metric),
                            jnp.bfloat16 if compute is None else jnp.dtype(compute))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SQ8_RTOL, atol=1e-4)


def test_sq8_recall_close_to_exact():
    """Twin of tests/test_flat_index.py's: the affine SQ8 stays near-exact,
    and both packages reach the same recall on the same rows."""
    base = jsynthetic(2000, 32)
    queries = jsynthetic(20, 32, seed=7)
    truth = ground_truth(base, queries, 10, "L2")
    got = []
    for ix in (jpt.FlatIndex(32, storage="sq8"), FlatIndex(32, device="cpu", storage="sq8")):
        ix.add_batch([str(i) for i in range(2000)], base)
        res = ix.search_batch(queries, 10)
        got.append(recall_at_k(np.array([[int(h.id) for h in hits] for hits in res]),
                               truth, 10))
    assert got[1] == got[0] >= 0.9


def test_sq8_snapshot_carries_across(tmp_path):
    """A JAX sq8 snapshot loads into the port (convert.flat_from_arrays and
    load), re-quantized to the same codes; the port's own snapshot loads
    back into the JAX package."""
    rng = np.random.default_rng(4)
    base = rng.random((700, 16), np.float32)
    q = rng.random((6, 16), np.float32)
    jix = jpt.FlatIndex(16, "IP", storage="sq8")
    _mutate(jix, base)
    jix.snapshot(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as z:
        tix = convert.flat_from_arrays(z, "cpu")
    assert tix.storage == "sq8" and tix.metric == Metric.INNER_PRODUCT
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10), rtol=SQ8_RTOL)
    loaded = FlatIndex(16, "L2", device="cpu")
    loaded.load(str(tmp_path / "j.npz"))
    assert_same_results(loaded.search_batch(q, 10), jix.search_batch(q, 10), rtol=SQ8_RTOL)
    tix.snapshot(str(tmp_path / "t.npz"))
    back = jpt.FlatIndex(16, "L2")
    back.load(str(tmp_path / "t.npz"))
    assert back.storage == "sq8"
    assert_same_results(tix.search_batch(q, 10), back.search_batch(q, 10), rtol=SQ8_RTOL)


@pytest.mark.parametrize("n,min_capacity", [(0, 1024), (1000, 1024), (5000, 1024),
                                            (3000, 64)])
def test_capacity_matches_jax(n, min_capacity):
    rng = np.random.default_rng(5)
    base = rng.random((n, 8), np.float32)
    caps = []
    for ix in (jpt.FlatIndex(8, storage="sq8", min_capacity=min_capacity),
               FlatIndex(8, device="cpu", storage="sq8", min_capacity=min_capacity)):
        if n:
            ix.add_batch([str(i) for i in range(n)], base)
        caps.append(ix.capacity)
    assert caps[0] == caps[1]


def test_sq8_validation():
    with pytest.raises(ValueError, match="hybrid"):
        FlatIndex(8, device="cpu", storage="sq8", selection="hybrid")
    with pytest.raises(ValueError, match="storage"):
        FlatIndex(8, device="cpu", storage="int4")
    ix = FlatIndex(8, device="cpu", storage="sq8", selection="pallas")
    assert ix.describe_scan(1024) == "flat-sq8"   # sq8 takes its route whatever the selection


def test_chip_smoke_sq8_recall_is_the_jax_packages():
    """chip_smoke's phase 20 holds the port's Flat sq8 recall to the JAX
    package's on the same rows (SQ8_RECALL_JAX): this is where those values
    come from. bench.py's ``sq8_100k`` rows: synthetic(100k, 128), the
    first 256 (b64) and 1024 (b1024) of synthetic_queries, L2, k 10, the
    truth exact in float64; the port's index on the CPU gives the same
    recall."""
    import chip_smoke
    import jax.numpy as jnp
    from pyrope_tpu.utils.datasets import id_lists_to_rows, synthetic_queries

    base = jsynthetic(100_000, 128)
    queries = synthetic_queries(1024, 128)
    truth = ground_truth(base, queries, 10, "L2")
    jix = jpt.FlatIndex(128, "L2", storage="sq8")
    tix = FlatIndex(128, "L2", device="cpu", storage="sq8")
    got = {}
    for name, ix, search in (
            ("jax", jix, lambda s: np.asarray(jix.device_search(jnp.asarray(queries[s:s + 256]),
                                                                10)[1])),
            ("port", tix, lambda s: tix.device_search(torch.from_numpy(queries[s:s + 256]),
                                                      10)[1].numpy())):
        ix.add_batch([str(i) for i in range(len(base))], base)
        rows = np.concatenate([search(s) for s in range(0, 1024, 256)])
        ids = id_lists_to_rows(ix.resolve_rows(rows), 10)
        got[name] = {b: recall_at_k(ids[:n], truth[:n], 10)
                     for b, n in ((64, 256), (1024, 1024))}
    assert got["jax"] == chip_smoke.SQ8_RECALL_JAX
    assert got["port"] == got["jax"]
