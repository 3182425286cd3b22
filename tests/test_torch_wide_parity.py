"""Port parity at wide k (k > 128, and the hybrids' R > 128 at k > 32) and
at large D against the JAX package, on the same data (Pallas in interpret
mode, its wide-k merges included):

  - ``describe_scan`` of the port equals the JAX index's at k in {33, 100,
    129, 200, 512, 1000} and at D 768, for Flat (``pallas`` with fp32 and
    bf16 storage, ``hybrid``, ``hybrid:256``, ``hybrid:1024``) and IVF-Flat
    (``auto``, ``pallas``, ``hybrid``); IVF-PQ's in test_torch_wide_pq.py;
  - the hits equal the JAX package's on those routes: exact fp32 routes
    (the hybrids rerank in fp32) within rtol 1e-5 / atol 1e-4, bf16 scans
    but for k-th place ties (``assert_hits_but_kth_ties``).

The port's CPU path runs the kernels' plain versions; the kernels' wide
and large-D modes are held against those on the card
(test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
from _torch_parity import assert_hits_but_kth_ties, assert_same_results, hits_to_arrays

import pyrope_tpu as jpt
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex

KS = [33, 100, 129, 200, 512, 1000]
FLAT_SELECTIONS = [("pallas", "fp32"), ("pallas", "bf16"), ("hybrid", "fp32"),
                   ("hybrid:256", "fp32"), ("hybrid:1024", "fp32")]


@pytest.fixture(scope="module")
def flat_pairs():
    """(JAX, port) FlatIndex pairs over the same 1500 x 16 rows, one for each
    (selection, storage), and 8 queries."""
    rng = np.random.default_rng(21)
    base = rng.normal(size=(1500, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    pairs = {}
    for sel, storage in FLAT_SELECTIONS:
        jix = jpt.FlatIndex(16, "L2", selection=sel, storage=storage)
        tix = FlatIndex(16, "L2", device="cpu", selection=sel, storage=storage)
        for ix in (jix, tix):
            ix.add_batch([str(i) for i in range(len(base))], base)
        pairs[sel, storage] = (jix, tix)
    return pairs, q


@pytest.mark.parametrize("k", KS)
def test_flat_routes_match_jax_at_wide_k(flat_pairs, k):
    pairs, _ = flat_pairs
    for (sel, storage), (jix, tix) in pairs.items():
        for batch in (8, 256, 512):
            assert tix.describe_scan(batch, top_k=k) == jix.describe_scan(batch), (
                sel, storage, batch)


@pytest.mark.parametrize("sel,storage,k", [("pallas", "fp32", 200), ("pallas", "bf16", 129),
                                           ("hybrid", "fp32", 100), ("hybrid:1024", "fp32", 33),
                                           ("pallas", "fp32", 1000)])
def test_flat_wide_hits_match_jax(flat_pairs, sel, storage, k):
    pairs, q = flat_pairs
    jix, tix = pairs[sel, storage]
    want = "flat-pallas-hybrid" if sel.startswith("hybrid") else "flat-pallas"
    assert tix.describe_scan(8, top_k=k) == jix.describe_scan(8) == want
    if sel.startswith("hybrid"):
        assert tix._shortlist(k) == (1024 if sel == "hybrid:1024" else 512)
    got, ref = tix.search_batch(q, k), jix.search_batch(q, k)
    if storage == "bf16":
        assert_hits_but_kth_ties(*hits_to_arrays(got), *hits_to_arrays(ref))
    else:
        assert_same_results(got, ref)


def _ivf_pair(tmp_path_factory, n, d, nlist, nprobe, seed, **kw):
    """A JAX IvfFlatIndex built and snapshotted, and a port index with the
    same options that loads the snapshot: both search one partition."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    jix = jpt.IvfFlatIndex(d, "L2", nlist=nlist, nprobe=nprobe, train_init="sample", **kw)
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()
    path = str(tmp_path_factory.mktemp("ivf") / "ivf.npz")
    jix.snapshot(path)
    tix = IvfFlatIndex(d, "L2", device="cpu", nlist=nlist, nprobe=nprobe, **kw)
    tix.load(path)
    return jix, tix, rng.normal(size=(8, d)).astype(np.float32)


@pytest.fixture(scope="module")
def ivf_pairs(tmp_path_factory):
    """IVF-Flat pairs by selection at D 16 (3000 rows, nlist 16) and at D
    768 (4096 rows, nlist 8: a slab the JAX kernels tile, so its route is
    the kernel's too)."""
    pairs = {}
    for sel in ("auto", "pallas", "hybrid"):
        pairs[16, sel] = _ivf_pair(tmp_path_factory, 3000, 16, 16, 4, 22,
                                   scan_mode="dense", selection=sel)
        pairs[768, sel] = _ivf_pair(tmp_path_factory, 4096, 768, 8, 3, 23,
                                    scan_mode="dense", selection=sel)
    return pairs


@pytest.mark.parametrize("k", KS)
def test_ivf_flat_routes_match_jax_at_wide_k_and_large_d(ivf_pairs, k):
    for (d, sel), (jix, tix, _) in ivf_pairs.items():
        for batch in (8, 256, 512):
            want = jix.describe_scan(batch)
            assert want.startswith("dense-pallas"), (d, sel, batch, want)
            assert tix.describe_scan(batch, top_k=k) == want, (d, sel, batch)


@pytest.mark.parametrize("d,sel,k", [(16, "pallas", 200), (16, "hybrid", 100),
                                     (16, "auto", 256), (768, "auto", 10),
                                     (768, "pallas", 129)])
def test_ivf_flat_wide_and_large_d_hits_match_jax(ivf_pairs, d, sel, k):
    jix, tix, q = ivf_pairs[d, sel]
    route = "dense-pallas-hybrid" if sel == "hybrid" else "dense-pallas"
    assert tix.describe_scan(8, top_k=k) == jix.describe_scan(8) == route
    if sel == "hybrid":
        assert tix._shortlist(tix._sync(), k) == 512
    assert_same_results(tix.search_batch(q, k), jix.search_batch(q, k))
