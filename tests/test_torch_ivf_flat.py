"""Port parity: index/ivf_flat.py and convert.py against the JAX package.

A JAX IvfFlatIndex is built, snapshotted, and carried into the port with
convert.ivf_flat_from_arrays, so both search the same partition (same
centroids, slab and lists). Every route must then return the JAX hit sets:
dense-pallas (JAX kernel K2 in interpret mode), dense-pallas-win (K3),
probe, and a max_scans budget (dense-xla). Scores are fp32 on both sides
with a different summation order: within rtol 1e-5 / atol 1e-4, order
equal except inside near-ties (see _torch_parity).
"""

import numpy as np
import pytest
import torch
from _torch_parity import assert_same_results, port_options

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex


def _built_pair(tmp_path_factory, n, d, nlist, nprobe, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    jix = jpt.IvfFlatIndex(d, "L2", nlist=nlist, nprobe=nprobe,
                           scan_mode="dense", train_init="sample")
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()
    path = str(tmp_path_factory.mktemp("ivf") / "jax.npz")
    jix.snapshot(path)
    with np.load(path) as z:
        tix = convert.ivf_flat_from_arrays(z, "cpu")
    return jix, tix, q


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    return _built_pair(tmp_path_factory, 3000, 24, 16, 4, 7)


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    # nlist 600 > 512 clusters: the JAX package's windowed kernel
    return _built_pair(tmp_path_factory, 20000, 16, 600, 32, 12)


def _set_scan_mode(pair, mode):
    pair[0].scan_mode = pair[1].scan_mode = mode


@pytest.mark.parametrize("fixture,route", [
    ("narrow", "dense-pallas"),
    ("wide", "dense-pallas-win"),
])
def test_dense_kernel_routes_match_jax(request, fixture, route):
    jix, tix, q = request.getfixturevalue(fixture)
    assert jix.describe_scan(8) == tix.describe_scan(8) == route
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10))


@pytest.mark.parametrize("fixture", ["narrow", "wide"])
def test_probe_route_matches_jax(request, fixture):
    pair = request.getfixturevalue(fixture)
    jix, tix, q = pair
    _set_scan_mode(pair, "probe")
    try:
        assert jix.describe_scan(8) == tix.describe_scan(8) == "probe"
        assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10))
    finally:
        _set_scan_mode(pair, "dense")


def test_max_scans_route_matches_jax(narrow):
    jix, tix, q = narrow
    opts = SearchOptions(max_scans=500)
    assert jix.describe_scan(8, max_scans=500) == "dense-xla"
    assert tix.describe_scan(8, max_scans=500) == "dense-xla"
    assert_same_results(tix.search_batch(q, 5, port_options(opts)),
                        jix.search_batch(q, 5, opts))


def test_describe_scan_strings_match_jax(narrow, wide):
    cases = [(8, None, None), (64, 2, None), (1024, None, None),
             (8, None, 100), (256, 16, 10**9)]
    for pair in (narrow, wide):
        jix, tix, _ = pair
        for mode in ("auto", "dense", "probe"):
            _set_scan_mode(pair, mode)
            for batch, nprobe, ms in cases:
                assert (tix.describe_scan(batch, nprobe, ms)
                        == jix.describe_scan(batch, nprobe, ms)), (mode, batch, nprobe, ms)
        _set_scan_mode(pair, "dense")


def test_device_search_matches_search_batch(narrow):
    _, tix, q = narrow
    vals, rows = tix.device_search(torch.from_numpy(q), 10)
    ids = tix.resolve_rows(rows.numpy())
    want = tix.search_batch(q, 10)
    assert ids == [[h.id for h in r] for r in want]
    assert vals.dtype == torch.float32 and rows.dtype == torch.int32


def test_port_snapshot_loads_into_jax(narrow, tmp_path):
    jix, _, q = narrow
    jix.snapshot(str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "jax.npz") as z:
        tix = convert.ivf_flat_from_arrays(z, "cpu")  # a copy to mutate
    tix.delete("3")
    tix.upsert("new", q[0])       # lands in the buffer
    path = str(tmp_path / "port.npz")
    tix.snapshot(path)
    back = jpt.IvfFlatIndex(24, "L2")
    back.load(path)
    assert back.get_stats().count == tix.get_stats().count
    assert_same_results(tix.search_batch(q, 10), back.search_batch(q, 10))
    again = IvfFlatIndex(24, "L2", device="cpu")
    again.load(path)
    assert_same_results(again.search_batch(q, 10), back.search_batch(q, 10))


def test_mutations_buffer_and_rebuild():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(2000, 8)).astype(np.float32)
    ix = IvfFlatIndex(8, "L2", device="cpu", nlist=8, nprobe=8)
    assert ix.describe_scan(8) == "buffer"
    ix.add_batch([str(i) for i in range(2000)], base)
    assert ix.search(base[5], 1)[0].id == "5"        # exact buffer scan
    ix.build()
    assert ix.get_stats().count == 2000
    assert ix.get_centroids().shape == (8, 8)
    assert ix.search(base[5], 1)[0].id == "5"
    assert ix.delete("5") and not ix.delete("5")
    assert all(h.id != "5" for h in ix.search(base[5], 3))
    ix.upsert("7", base[5])                          # main row -> buffer
    assert ix.search(base[5], 1)[0].id == "7"
    assert not ix.add("7", base[0])
    ix.build()
    assert ix.get_stats().count == 1999
    assert ix.search(base[5], 1)[0].id == "7"
    # explicit 'pallas' on a route without the kernel is a config error
    bad = IvfFlatIndex(8, "L2", device="cpu", nlist=4, selection="pallas",
                       scan_mode="probe")
    bad.add_batch([str(i) for i in range(100)], base[:100])
    bad.build()
    with pytest.raises(ValueError, match="pallas"):
        bad.search(base[0], 1)


def test_not_yet_ported_options_raise():
    # hybrid reranks in fp32, as in the JAX package
    with pytest.raises(ValueError, match="compute_dtype"):
        IvfFlatIndex(8, "L2", device="cpu", selection="hybrid", compute_dtype="bfloat16")
    with pytest.raises(ValueError):
        IvfFlatIndex(8, "L2", device="cpu", scan_mode="sparse")
