"""Port parity of the bf16 serving options of the indexes against the JAX
package, on the same writes and queries (Pallas in interpret mode):

  - FlatIndex ``storage="bf16"`` (pallas: the bf16 scan; exact: the
    widened slab), ``compute_dtype``, ``selection="hybrid[:R]"`` below and
    above HYBRID_MAX_BATCH and above the kernels' MAX_K;
  - IvfFlatIndex ``selection="hybrid"`` at nlist <= 512 and > 512,
    ``compute_dtype``, ``train_dtype``;
  - IvfPqIndex ``refine_storage="bf16"`` on its dense and probe routes;
  - bf16 slabs bit-equal to the JAX package's after ``convert``, and
    snapshots crossing both ways.

Scores: fp32 on both sides (the hybrid routes rerank in fp32) or exact
products of bf16 values summed in fp32, in another order: rtol 1e-5 / atol
1e-4. Hit sets equal, but for k-th place ties where scores are rounded to
bf16 (``assert_hits_but_kth_ties``). Hybrid cases at k > 32 (R > 128) are
held against the JAX package's exact selection, not its interpret-mode
wide-k kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_hits_but_kth_ties,
    assert_same_results,
    hits_to_arrays,
    port_options,
)

import pyrope_tpu as jpt
from pyrope_tpu.index import flat as jflat
from pyrope_tpu.types import SearchOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index.flat import HYBRID_MAX_BATCH, FlatIndex, hybrid_shortlist
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex as IvfPqIndexPort


def same_but_kth_ties(res_a, res_b):
    assert_hits_but_kth_ties(*hits_to_arrays(res_a), *hits_to_arrays(res_b))


def _mutate(ix, base):
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix.delete("4")
    ix.add("9", base[0] + 0.5)
    ix.upsert("11", base[1])
    ix.add("extra", base[2] * 0.5)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def _jax_bits(a) -> np.ndarray:
    """A JAX bf16 array's bits: to numpy through fp32 (exact), then bf16."""
    return _bits(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16())


@pytest.mark.parametrize("selection,metric", [
    ("pallas", "L2"), ("pallas", "IP"), ("exact", "L2"), ("exact", "COSINE"),
])
def test_flat_bf16_storage_matches_jax(selection, metric):
    rng = np.random.default_rng(0)
    base = rng.random((1500, 16), np.float32)
    q = rng.random((8, 16), np.float32)
    jix = jpt.FlatIndex(16, metric, storage="bf16", selection=selection)
    tix = FlatIndex(16, metric, device="cpu", storage="bf16", selection=selection)
    for ix in (jix, tix):
        _mutate(ix, base)
    same_but_kth_ties(tix.search_batch(q, 10), jix.search_batch(q, 10))
    opts = SearchOptions(max_scans=700)
    same_but_kth_ties(tix.search_batch(q, 10, port_options(opts)),
                      jix.search_batch(q, 10, opts))
    assert tix._dev["vecs"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(tix._dev["vecs"]), _jax_bits(jix._dev["vecs"]))
    assert tix.describe_scan(8) == ("flat-pallas" if selection == "pallas"
                                    and metric != "COSINE" else "flat-exact")


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_compute_dtype_matches_jax(metric):
    rng = np.random.default_rng(1)
    base = rng.normal(size=(800, 24)).astype(np.float32)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    jix = jpt.FlatIndex(24, metric, compute_dtype="bfloat16")
    tix = FlatIndex(24, metric, device="cpu", compute_dtype="bfloat16")
    for ix in (jix, tix):
        ix.add_batch([str(i) for i in range(800)], base)
    same_but_kth_ties(tix.search_batch(q, 10), jix.search_batch(q, 10))


@pytest.mark.parametrize("b", [8, HYBRID_MAX_BATCH, HYBRID_MAX_BATCH + 1])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_hybrid_matches_jax_below_and_above_the_batch_cap(metric, b):
    rng = np.random.default_rng(2)
    base = rng.normal(size=(1500, 16)).astype(np.float32)
    q = rng.normal(size=(b, 16)).astype(np.float32)
    jix = jpt.FlatIndex(16, metric, selection="hybrid")
    tix = FlatIndex(16, metric, device="cpu", selection="hybrid")
    for ix in (jix, tix):
        _mutate(ix, base)
    route = "flat-pallas-hybrid" if b <= HYBRID_MAX_BATCH else "flat-pallas"
    assert tix.describe_scan(b) == jix.describe_scan(b) == route
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10))
    assert tix._dev["vecs"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(tix._dev["vecs16"]), _jax_bits(jix._dev["vecs16"]))


def test_flat_hybrid_shortlist_and_routes_above_max_k():
    """R = max(64, next_pow2(4k)) clamped to the JAX package's row tile; at
    k > 32 (or 'hybrid:R' with R > 128) R is wider than the kernels hold and
    the route is the exact fp32 scan, whose hits equal the JAX package's
    exact selection; cosine takes the exact path."""
    assert [hybrid_shortlist(k, 0, 4096) for k in (1, 10, 16, 17, 32, 33, 50)] == [
        64, 64, 64, 128, 128, 256, 256]
    assert hybrid_shortlist(10, 96, 4096) == 128 and hybrid_shortlist(10, 0, 32) == 32
    rng = np.random.default_rng(3)
    base = rng.normal(size=(1500, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    ref = jpt.FlatIndex(16, "L2", selection="exact")
    ref.add_batch([str(i) for i in range(1500)], base)
    for sel, k in (("hybrid", 50), ("hybrid:256", 10), ("hybrid", 200)):
        tix = FlatIndex(16, "L2", device="cpu", selection=sel)
        tix.add_batch([str(i) for i in range(1500)], base)
        want = "flat-exact" if k > 128 else "flat-pallas"
        assert tix.describe_scan(8, top_k=k) == want
        assert_same_results(tix.search_batch(q, k), ref.search_batch(q, k))
    cos = FlatIndex(16, "COSINE", device="cpu", selection="hybrid")
    cos.add_batch(["a", "b"], base[:2])
    assert cos.describe_scan(8) == "flat-exact" and "vecs16" not in cos._sync()


def test_flat_pallas_above_max_k_raises_naming_the_limit():
    ix = FlatIndex(8, "L2", device="cpu", selection="pallas")
    ix.add_batch(["a", "b"], np.eye(2, 8, dtype=np.float32))
    with pytest.raises(ValueError, match=r"k must be in \[1, 128\].*queue 2 item B"):
        ix.search_batch(np.zeros((1, 8), np.float32), 200)
    assert ix.describe_scan(1, top_k=128) == "flat-pallas"


def test_flat_hybrid_incremental_sync_updates_both_slabs():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(600, 8)).astype(np.float32)
    ix = FlatIndex(8, "L2", device="cpu", selection="hybrid")
    ix.add_batch([str(i) for i in range(600)], base)
    ix.search(base[0], 1)                     # full upload
    slabs = ix._dev["vecs"], ix._dev["vecs16"]
    ix.upsert("5", base[7] * 2)
    ix.delete("3")
    assert [h.id for h in ix.search(base[7] * 2, 1)] == ["5"]
    assert ix._dev["vecs"] is slabs[0] and ix._dev["vecs16"] is slabs[1]
    np.testing.assert_array_equal(_bits(ix._dev["vecs16"][5]),
                                  _bits(torch.from_numpy(base[7] * 2).bfloat16()))
    assert all(h.id != "3" for h in ix.search(base[3], 5))


def test_flat_bf16_snapshots_cross_both_ways(tmp_path):
    rng = np.random.default_rng(5)
    base = rng.random((300, 8), np.float32)
    q = rng.random((4, 8), np.float32)
    jix = jpt.FlatIndex(8, "L2", storage="bf16", selection="pallas")
    jix.add_batch([str(i) for i in range(300)], base)
    jix.snapshot(str(tmp_path / "j.npz"))
    with np.load(tmp_path / "j.npz") as z:
        conv = convert.flat_from_arrays(z, "cpu")
    tix = FlatIndex(8, "L2", device="cpu", selection="pallas")
    tix.load(str(tmp_path / "j.npz"))
    assert conv.storage == tix.storage == "bf16"
    same_but_kth_ties(tix.search_batch(q, 5), jix.search_batch(q, 5))
    np.testing.assert_array_equal(_bits(conv._sync()["vecs"]), _jax_bits(jix._dev["vecs"]))
    tix.snapshot(str(tmp_path / "t.npz"))
    back = jpt.FlatIndex(8, "L2", selection="pallas")
    back.load(str(tmp_path / "t.npz"))
    assert back.storage == "bf16"
    same_but_kth_ties(tix.search_batch(q, 5), back.search_batch(q, 5))
    port = FlatIndex(8, "L2", device="cpu", selection="pallas")
    port.load(str(tmp_path / "t.npz"))
    assert port.storage == "bf16"
    same_but_kth_ties(port.search_batch(q, 5), jix.search_batch(q, 5))


# ---- IVF-Flat ---------------------------------------------------------------


def _ivf_pair(tmp_path, n, d, nlist, nprobe, seed, **kw):
    """A JAX IvfFlatIndex built and snapshotted, and a port index with the
    same options that loads the snapshot: both search the same partition."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    jix = jpt.IvfFlatIndex(d, "L2", nlist=nlist, nprobe=nprobe, scan_mode="dense",
                           train_init="sample", **kw)
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()
    jix.snapshot(str(tmp_path / "ivf.npz"))
    tix = IvfFlatIndex(d, "L2", device="cpu", nlist=nlist, nprobe=nprobe,
                       scan_mode="dense", **kw)
    tix.load(str(tmp_path / "ivf.npz"))
    return jix, tix, rng


@pytest.mark.parametrize("n,nlist,route", [
    (3000, 16, "dense-pallas-hybrid"), (20000, 600, "dense-pallas-win-hybrid"),
])
def test_ivf_flat_hybrid_matches_jax(tmp_path, n, nlist, route):
    jix, tix, rng = _ivf_pair(tmp_path, n, 16, nlist, 8 if nlist > 100 else 4, 6,
                              selection="hybrid")
    q = rng.normal(size=(16, 16)).astype(np.float32)
    assert tix.describe_scan(16) == jix.describe_scan(16) == route
    assert_same_results(tix.search_batch(q, 10), jix.search_batch(q, 10))
    np.testing.assert_array_equal(_bits(tix._sync()["xperm16"]),
                                  _jax_bits(jix._sync()["xperm16"]))
    # above HYBRID_MAX_BATCH the fp32 list scan, as in the JAX package
    assert tix.describe_scan(512) == jix.describe_scan(512) == route[:-len("-hybrid")]


def test_ivf_flat_hybrid_above_max_k_takes_the_fp32_scan(tmp_path):
    jix, tix, rng = _ivf_pair(tmp_path, 3000, 16, 16, 4, 7, selection="hybrid")
    q = rng.normal(size=(8, 16)).astype(np.float32)
    assert tix.describe_scan(8, top_k=50) == "dense-pallas"   # R 256 > MAX_K
    jix.selection = "exact"
    jix._dirty = True
    assert_same_results(tix.search_batch(q, 50), jix.search_batch(q, 50))


@pytest.mark.parametrize("mode,route", [("dense", "dense-xla"), ("probe", "probe")])
def test_ivf_flat_compute_dtype_matches_jax(tmp_path, mode, route):
    jix, tix, rng = _ivf_pair(tmp_path, 3000, 16, 16, 4, 8, compute_dtype="bfloat16")
    for ix in (jix, tix):
        ix.scan_mode = mode
    q = rng.normal(size=(8, 16)).astype(np.float32)
    assert tix.describe_scan(8) == jix.describe_scan(8) == route
    same_but_kth_ties(tix.search_batch(q, 10), jix.search_batch(q, 10))
    # the buffer searches with the same compute dtype
    for ix in (jix, tix):
        ix.add("new", q[0] * 1.01)
    same_but_kth_ties(tix.search_batch(q, 10), jix.search_batch(q, 10))


def test_ivf_flat_train_dtype_partition_matches_jax():
    """bf16 Lloyd iterations, fp32 final assignment, on both sides: the
    partitions are equal but for rows within rounding of a boundary."""
    rng = np.random.default_rng(9)
    centers = rng.random((8, 16)).astype(np.float32) * 6
    labels = rng.integers(0, 8, 4000)
    base = centers[labels] + rng.normal(0, 0.05, (4000, 16)).astype(np.float32)
    seed = next(s for s in range(10_000) if len(set(labels[
        np.random.default_rng(s).choice(4000, size=8, replace=False)])) == 8)
    ixs = [jpt.IvfFlatIndex(16, "L2", nlist=8, seed=seed, train_dtype="bfloat16",
                            train_init="sample"),
           IvfFlatIndex(16, "L2", device="cpu", nlist=8, seed=seed,
                        train_dtype="bfloat16", train_init="sample")]
    for ix in ixs:
        ix.add_batch([str(i) for i in range(4000)], base)
        ix.build()
    jix, tix = ixs
    np.testing.assert_allclose(tix.get_centroids(), jix.get_centroids(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tix._lens, jix._lens)
    assert tix._perm_ids == jix._perm_ids


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_train_dtype_reaches_the_coarse_kmeans(kind):
    """One Gaussian blob split 8 ways, so bf16 Lloyd moves the centroids:
    the port's bf16-trained partition equals the JAX package's and differs
    from the port's fp32-trained one (IVF-PQ: the codebooks differ too)."""
    base = np.random.default_rng(22).normal(size=(3000, 16)).astype(np.float32)
    kw = dict(nlist=8, seed=3, train_init="sample")
    if kind == "ivf_pq":
        kw.update(pq_m=4, ksub=16)
    jcls, tcls = ((jpt.IvfFlatIndex, IvfFlatIndex) if kind == "ivf_flat"
                  else (jpt.IvfPqIndex, IvfPqIndexPort))
    ixs = [jcls(16, "L2", train_dtype="bfloat16", **kw),
           tcls(16, "L2", device="cpu", train_dtype="bfloat16", **kw),
           tcls(16, "L2", device="cpu", **kw)]
    for ix in ixs:
        ix.add_batch([str(i) for i in range(3000)], base)
        ix.build()
    jix, tix, fix = ixs
    np.testing.assert_allclose(tix.get_centroids(), jix.get_centroids(), rtol=0, atol=1e-5)
    assert tix._perm_ids == jix._perm_ids
    assert np.abs(tix.get_centroids() - fix.get_centroids()).max() > 1e-2
    assert tix._perm_ids != fix._perm_ids
    if kind == "ivf_pq":
        assert not np.array_equal(tix.pq.codebooks, fix.pq.codebooks)


# ---- the route repairs: k above MAX_K, D above the list scan's shared memory --


@pytest.mark.parametrize("d,k", [(16, 200), (768, 10)])
def test_ivf_flat_auto_routes_shapes_the_kernel_refuses_to_dense_xla(tmp_path, d, k):
    jix, tix, rng = _ivf_pair(tmp_path, 2000, d, 8, 3, 10)
    q = rng.normal(size=(8, d)).astype(np.float32)
    assert tix.describe_scan(8, top_k=k) == "dense-xla"
    assert tix.describe_scan(8, top_k=5 if k > 128 else k) == (
        "dense-pallas" if k > 128 else "dense-xla")
    jix.selection = "exact"          # the JAX package's exact dense scan
    assert_same_results(tix.search_batch(q, k), jix.search_batch(q, k))
    tix.selection = "pallas"
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item " + ("B" if k > 128 else "C")):
        tix.search_batch(q, k)


def test_dense_xla_walks_the_queries_in_blocks(tmp_path, monkeypatch):
    from pyrope_tpu_torch.index import ivf_flat as tivf

    jix, tix, rng = _ivf_pair(tmp_path, 2000, 16, 8, 3, 11)
    q = rng.normal(size=(40, 16)).astype(np.float32)
    want = tix.search_batch(q, 200)
    seen = []
    real = tivf.masked_topk

    def spy(scores, mask, k, selection="exact"):
        seen.append(scores.numel())
        return real(scores, mask, k, selection)

    npad = tix._sync()["xperm"].shape[0]
    monkeypatch.setattr(tivf, "DENSE_MAX_ELEMS", 7 * npad)
    monkeypatch.setattr(tivf, "masked_topk", spy)
    assert tix.describe_scan(64, top_k=200) == "dense-xla"   # the mode stays dense
    assert_same_results(tix.search_batch(q, 200), want)
    assert len(seen) == 6 and max(seen) <= 7 * npad


@pytest.mark.parametrize("d,k", [(16, 200), (768, 10)])
def test_ivf_pq_auto_routes_shapes_the_kernel_refuses_to_dense_xla(tmp_path, d, k):
    rng = np.random.default_rng(12)
    base = rng.normal(size=(2000, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    built = jpt.IvfPqIndex(d, "L2", nlist=8, pq_m=4, ksub=64, nprobe=3,
                           train_init="sample")
    built.add_batch([str(i) for i in range(2000)], base)
    built.build()
    built.snapshot(str(tmp_path / "pq.npz"))
    jix = jpt.IvfPqIndex(d, "L2")
    jix.load(str(tmp_path / "pq.npz"))
    with np.load(tmp_path / "pq.npz") as z:
        tix = convert.ivf_pq_from_arrays(z, "cpu")
    assert tix.describe_scan(8, top_k=k) == "dense-exact-xla"
    # the JAX package's exact dense scan of the same slab: a max_scans
    # budget above the probed rows takes its XLA route, with equal hits
    opts = SearchOptions(max_scans=1999)
    assert jix.describe_scan(8, max_scans=1999) == "dense-exact-xla"
    assert_same_results(tix.search_batch(q, k), jix.search_batch(q, k, opts))


# ---- IVF-PQ: the bf16 rerank slab, bf16 training -------------------------------


@pytest.fixture(scope="module")
def pq_bf16(tmp_path_factory):
    """A JAX IvfPqIndex with a bf16 rerank slab, snapshotted, loaded back
    (its host upload path) and carried into the port."""
    rng = np.random.default_rng(13)
    base = rng.normal(size=(3000, 24)).astype(np.float32)
    built = jpt.IvfPqIndex(24, "L2", nlist=16, pq_m=4, nprobe=4, scan_mode="dense",
                           refine_storage="bf16", train_init="sample")
    built.add_batch([str(i) for i in range(3000)], base)
    built.build()
    path = str(tmp_path_factory.mktemp("pqbf16") / "jax.npz")
    built.snapshot(path)
    jix = jpt.IvfPqIndex(24, "L2")
    jix.load(path)
    with np.load(path) as z:
        tix = convert.ivf_pq_from_arrays(z, "cpu")
    return jix, tix, rng.normal(size=(8, 24)).astype(np.float32)


@pytest.mark.parametrize("mode,max_scans,route", [
    ("dense", None, "dense-exact-pallas"),      # the bf16 list scan with promote
    ("dense", 2999, "dense-exact-xla"),
    ("probe", None, "probe-adc+rerank"),        # the rerank off the bf16 slab
])
def test_ivf_pq_bf16_slab_routes_match_jax(pq_bf16, mode, max_scans, route):
    jix, tix, q = pq_bf16
    for ix in (jix, tix):
        ix.scan_mode = mode
    try:
        opts = SearchOptions(max_scans=max_scans)
        assert tix.describe_scan(8, max_scans=max_scans) == route
        assert jix.describe_scan(8, max_scans=max_scans) == route
        assert_same_results(tix.search_batch(q, 10, port_options(opts)),
                            jix.search_batch(q, 10, opts))
    finally:
        for ix in (jix, tix):
            ix.scan_mode = "dense"


def test_ivf_pq_bf16_slab_bytes_bits_and_snapshot(pq_bf16, tmp_path):
    jix, tix, q = pq_bf16
    assert tix.memory_bytes() == jix.memory_bytes()
    assert tix.memory_bytes()["refine_slab"] == 3000 * 24 * 2 + 3000 * 4
    dev = tix._sync()
    assert dev["xraw"].dtype == torch.bfloat16 and dev["xsqnorm"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(dev["xraw"]), _jax_bits(jix._sync()["xraw"]))
    tix.snapshot(str(tmp_path / "t.npz"))
    back = jpt.IvfPqIndex(24, "L2")
    back.load(str(tmp_path / "t.npz"))
    assert back.refine_storage == "bf16"
    assert_same_results(tix.search_batch(q, 10), back.search_batch(q, 10))


def test_ivf_pq_bf16_build_on_the_device_path():
    """The build path casts the permuted slab on the device: bf16 rows,
    sqnorms of the fp32 rows, the same hits as the host upload path."""
    rng = np.random.default_rng(14)
    base = rng.normal(size=(3000, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    ix = IvfPqIndexPort(16, "L2", device="cpu", nlist=8, pq_m=4, nprobe=3,
                        refine_storage="bf16", train_dtype="bfloat16")
    ix.add_batch([str(i) for i in range(3000)], base)
    ix.build()
    built = ix._dev
    assert built["xraw"].dtype == torch.bfloat16
    np.testing.assert_allclose(built["xsqnorm"][:3000].numpy(),
                               np.einsum("nd,nd->n", ix._xperm, ix._xperm), rtol=1e-5)
    got = ix.search_batch(q, 10)
    ix._dirty = True                # the host upload path (as after load)
    np.testing.assert_array_equal(_bits(ix._sync()["xraw"]), _bits(built["xraw"]))
    assert_same_results(ix.search_batch(q, 10), got)


def test_ivf_pq_train_dtype_matches_jax():
    """bf16 coarse k-means and PQ training on both sides, from the same
    initial rows: the same partition (centroids within 1e-4, the same
    lists). PQ then trains on residuals against centroids that differ in
    their last bits; rounding those to bf16 can flip a near-tie of Lloyd's
    argmax, and the iterations carry it on (fp32 training of this index
    differs by 2.4e-4 between the packages, bf16 training by 2.9e-3): the
    codebooks are held to 1e-2 and the codes to 99% agreement."""
    rng = np.random.default_rng(15)
    centers = rng.random((8, 16)).astype(np.float32) * 6
    labels = rng.integers(0, 8, 4000)
    base = centers[labels] + rng.normal(0, 0.05, (4000, 16)).astype(np.float32)
    seed = next(s for s in range(10_000) if len(set(labels[
        np.random.default_rng(s).choice(4000, size=8, replace=False)])) == 8)
    ixs = [jpt.IvfPqIndex(16, "L2", nlist=8, pq_m=4, ksub=64, seed=seed,
                          train_dtype="bfloat16", train_init="sample"),
           IvfPqIndexPort(16, "L2", device="cpu", nlist=8, pq_m=4, ksub=64, seed=seed,
                          train_dtype="bfloat16", train_init="sample")]
    for ix in ixs:
        ix.add_batch([str(i) for i in range(4000)], base)
        ix.build()
    jix, tix = ixs
    np.testing.assert_allclose(tix.get_centroids(), jix.get_centroids(), rtol=0, atol=1e-4)
    assert tix._perm_ids == jix._perm_ids
    np.testing.assert_allclose(tix.pq.codebooks, jix.pq.codebooks, rtol=0, atol=1e-2)
    assert (tix._codes == jix._codes).mean() >= 0.99
