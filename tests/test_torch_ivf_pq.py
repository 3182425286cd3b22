"""Port parity: index/ivf_pq.py and convert.ivf_pq_from_arrays against the
JAX package.

A JAX IvfPqIndex is built and snapshotted; the snapshot is loaded back into
a JAX index and carried into the port with convert.ivf_pq_from_arrays, so
both search the same partition, codebooks and codes, and both encode the
residual-SQ8 slab on their load paths. Every route must then return the
JAX hit sets, with the same describe_scan string: the fused kernels
(dense-sq8-pallas[-win], JAX K4/K5 in interpret mode; dense-exact-pallas
[-win], K2/K3) and the plain routes (dense-sq8-xla, dense-exact-xla,
dense-adc, probe-adc, probe-adc+rerank, probe-adc+rerank-sq8). Scores are
fp32 on both sides with another summation order: within rtol 1e-5 / atol
1e-4, and the JAX SQ8 kernel tolerance rtol 1e-4 on the SQ8 routes.
"""

import numpy as np
import pytest
import torch
from _torch_parity import SQ8_RTOL, assert_same_results, port_options

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

# (refine, refine_storage, scan_mode, max_scans) -> route
ROUTES = {
    "dense-sq8-pallas": (64, "sq8res", "dense", None),
    "dense-exact-pallas": (64, "fp32", "dense", None),
    "dense-sq8-xla": (64, "sq8res", "dense", 700),
    "dense-exact-xla": (64, "fp32", "dense", 700),
    "dense-adc": (0, "fp32", "dense", None),
    "probe-adc": (0, "fp32", "probe", None),
    "probe-adc+rerank": (64, "fp32", "probe", None),
    "probe-adc+rerank-sq8": (64, "sq8res", "probe", None),
}


def _built_pair(tmp_path_factory, n, d, nlist, nprobe, seed, metric="L2"):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    built = jpt.IvfPqIndex(d, metric, nlist=nlist, pq_m=4, nprobe=nprobe,
                           scan_mode="dense", train_init="sample")
    built.add_batch([str(i) for i in range(n)], base)
    built.build()
    path = str(tmp_path_factory.mktemp("ivfpq") / "jax.npz")
    built.snapshot(path)
    jix = jpt.IvfPqIndex(d, metric)
    jix.load(path)          # the JAX load path: its host SQ8 encoder
    with np.load(path) as z:
        tix = convert.ivf_pq_from_arrays(z, "cpu")
    return jix, tix, q


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    return _built_pair(tmp_path_factory, 3000, 24, 16, 4, 7)


@pytest.fixture(scope="module")
def narrow_cos(tmp_path_factory):
    # cosine: normalized rows, searched as IP (the IP ADC tables and scans)
    return _built_pair(tmp_path_factory, 3000, 24, 16, 4, 8, metric="COSINE")


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    # nlist 600 > 512 clusters: the JAX package's windowed kernels
    return _built_pair(tmp_path_factory, 20000, 16, 600, 32, 12)


def _configure(pair, refine, storage, mode):
    for ix in pair[:2]:
        ix.refine, ix.refine_storage, ix.scan_mode = refine, storage, mode
        ix._dirty = True


def _tolerance(route):
    return SQ8_RTOL if "sq8" in route else 1e-5


@pytest.mark.parametrize("fixture", ["narrow", "narrow_cos"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_every_route_matches_jax(request, fixture, route):
    pair = request.getfixturevalue(fixture)
    jix, tix, q = pair
    refine, storage, mode, ms = ROUTES[route]
    _configure(pair, refine, storage, mode)
    assert jix.describe_scan(8, max_scans=ms) == route
    assert tix.describe_scan(8, max_scans=ms) == route
    opts = SearchOptions(max_scans=ms)
    assert_same_results(tix.search_batch(q, 10, port_options(opts)),
                        jix.search_batch(q, 10, opts),
                        rtol=_tolerance(route))


@pytest.mark.parametrize("route", ["dense-sq8-pallas-win", "dense-exact-pallas-win"])
def test_windowed_routes_match_jax(wide, route):
    jix, tix, q = wide
    _configure(wide, 64, "sq8res" if "sq8" in route else "fp32", "dense")
    assert jix.describe_scan(8) == tix.describe_scan(8) == route
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10),
                        rtol=_tolerance(route))


def test_describe_scan_strings_match_jax(narrow, wide):
    cases = [(8, None, None), (64, 2, None), (1024, None, None),
             (8, None, 100), (256, 16, 10**9)]
    for pair in (narrow, wide):
        jix, tix, _ = pair
        for refine in (0, 64):
            for storage in ("fp32", "sq8res"):
                for mode in ("auto", "dense", "probe"):
                    _configure(pair, refine, storage, mode)
                    for batch, nprobe, ms in cases:
                        want = jix.describe_scan(batch, nprobe, ms)
                        assert tix.describe_scan(batch, nprobe, ms) == want, (
                            refine, storage, mode, batch, nprobe, ms)
        assert tix.memory_bytes() == jix.memory_bytes()


def test_device_search_matches_search_batch(narrow):
    _configure(narrow, 64, "sq8res", "dense")
    _, tix, q = narrow
    vals, rows = tix.device_search(torch.from_numpy(q), 10)
    assert vals.dtype == torch.float32 and rows.dtype == torch.int32
    assert tix.resolve_rows(rows.numpy()) == [[h.id for h in r]
                                              for r in tix.search_batch(q, 10)]


@pytest.mark.parametrize("storage", ["sq8res", "fp32"])
def test_mutations_after_load_and_port_snapshot_into_jax(narrow, tmp_path, storage):
    jix, _, q = narrow
    _configure(narrow, 64, storage, "dense")
    jix.snapshot(str(tmp_path / "jax.npz"))
    pair = []
    for make in (lambda p: convert.ivf_pq_from_arrays(np.load(p), "cpu"),
                 lambda p: _jax_loaded(p)):
        ix = make(tmp_path / "jax.npz")
        assert ix.delete("3") and not ix.delete("3")
        ix.upsert("11", q[1])          # a main row superseded by the buffer
        ix.upsert("new", q[0])         # a new id, in the buffer
        assert not ix.add("12", q[2])  # live in main: refused
        pair.append(ix)
    tix, jnew = pair
    assert tix.get_stats().count == jnew.get_stats().count == 3000
    res = tix.search_batch(q, 10)
    assert res[0][0].id == "new" and res[1][0].id == "11"
    assert all(h.id != "3" for r in res for h in r)
    assert_same_results(res, jnew.search_batch(q, 10), rtol=SQ8_RTOL)
    path = str(tmp_path / "port.npz")
    tix.snapshot(path)
    back = _jax_loaded(path)
    assert back.refine_storage == storage
    assert_same_results(tix.search_batch(q, 10), back.search_batch(q, 10), rtol=SQ8_RTOL)
    again = IvfPqIndex(24, "L2", device="cpu")
    again.load(path)
    assert_same_results(again.search_batch(q, 10), back.search_batch(q, 10))
    tix.build()                        # buffer + live main rows, retrained
    assert tix.get_stats().count == 3000 and tix._buffer.get_stats().count == 0
    assert tix.search_batch(q[:1], 1)[0][0].id == "new"


def _jax_loaded(path):
    ix = jpt.IvfPqIndex(24, "L2")
    ix.load(str(path))
    return ix


@pytest.mark.parametrize("storage", ["sq8res", "fp32"])
def test_build_keeps_no_fp32_corpus_on_the_device(storage):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(2000, 16)).astype(np.float32)
    ix = IvfPqIndex(16, "L2", device="cpu", nlist=8, pq_m=4, refine_storage=storage)
    ix.add_batch([str(i) for i in range(2000)], base)
    assert ix.describe_scan(8) == "buffer"
    ix.build()
    dev = ix._dev
    npad = dev["codes"].shape[0]
    slabs = [key for key, t in dev.items() if isinstance(t, torch.Tensor)
             and t.dtype == torch.float32 and t.shape == (npad, 16)]
    assert slabs == ([] if storage == "sq8res" else ["xraw"])
    if storage == "sq8res":
        assert dev["codes8"].dtype == torch.uint8 and dev["codes8"].shape == (npad, 16)
        assert ix.memory_bytes()["refine_slab"] == 2000 * (16 + 12)
    assert ix.search(base[5], 1)[0].id == "5"
    assert ix.get_centroids().shape == (8, 16)


def test_tiny_corpus_takes_the_host_pq_path():
    """Fewer rows than ksub: codebooks from ProductQuantizer.train, and
    the device state is uploaded at the first search (the load path)."""
    rng = np.random.default_rng(6)
    base = rng.normal(size=(100, 8)).astype(np.float32)
    ix = IvfPqIndex(8, "L2", device="cpu", nlist=4, pq_m=2, refine_storage="sq8res")
    ix.add_batch([str(i) for i in range(100)], base)
    ix.build()
    assert ix._dev is None and ix.pq.codebooks.shape == (2, 256, 4)
    assert ix.search(base[7], 1)[0].id == "7"


def test_not_yet_ported_options_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        IvfPqIndex(8, "L2", device="cpu", refine_storage="bf16")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        IvfPqIndex(8, "L2", device="cpu", train_dtype="bfloat16")
    with pytest.raises(ValueError):
        IvfPqIndex(8, "L2", device="cpu", refine_storage="int4")
    with pytest.raises(ValueError):
        IvfPqIndex(8, "L2", device="cpu", scan_mode="sparse")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IvfPqIndex(8, "L2")
    jix = jpt.IvfPqIndex(8, "L2", refine_storage="bf16")
    jix.snapshot(str(tmp_path / "bf16.npz"))
    with np.load(tmp_path / "bf16.npz") as z, pytest.raises(NotImplementedError):
        convert.ivf_pq_from_arrays(z, "cpu")
