"""IVF-PQ parity at wide k and large D against the JAX package: the dense
route over the fp32, sq8res and bf16 rerank slabs (the list scan in its IVF,
SQ8 and BF16-with-promote modes) keeps the JAX package's route name at k in
{33, 100, 129, 200, 512, 1000} and at D 768, and returns its hits: fp32
within rtol 1e-5 / atol 1e-4, SQ8 within the JAX SQ8 kernel tolerance
(rtol 1e-4), bf16 but for k-th place ties. Before this, the port took the
plain dense scans (``dense-*-xla``) there.
"""

import numpy as np
import pytest
from _torch_parity import (
    SQ8_RTOL,
    assert_hits_but_kth_ties,
    assert_same_results,
    hits_to_arrays,
)

import pyrope_tpu as jpt
from pyrope_tpu_torch import convert

KS = [33, 100, 129, 200, 512, 1000]
ROUTE = {"fp32": "dense-exact-pallas", "sq8res": "dense-sq8-pallas",
         "bf16": "dense-exact-pallas"}


def _pq_pair(tmp_path_factory, n, d, storage, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    built = jpt.IvfPqIndex(d, "L2", nlist=8, pq_m=4, ksub=64, nprobe=3, scan_mode="dense",
                           refine_storage=storage, train_init="sample")
    built.add_batch([str(i) for i in range(n)], base)
    built.build()
    path = str(tmp_path_factory.mktemp("pq") / "jax.npz")
    built.snapshot(path)
    jix = jpt.IvfPqIndex(d, "L2")
    jix.load(path)
    with np.load(path) as z:
        tix = convert.ivf_pq_from_arrays(z, "cpu")
    assert tix.refine_storage == jix.refine_storage == storage
    return jix, tix, rng.normal(size=(8, d)).astype(np.float32)


@pytest.fixture(scope="module")
def pq_pairs(tmp_path_factory):
    """(JAX, port, queries) at D 24 (3000 rows) and D 768 (4096 rows, a slab
    the JAX kernels tile) for each rerank slab."""
    return {(d, storage): _pq_pair(tmp_path_factory, n, d, storage, 30 + d)
            for d, n in ((24, 3000), (768, 4096)) for storage in ROUTE}


@pytest.mark.parametrize("k", KS)
def test_ivf_pq_dense_routes_match_jax_at_wide_k_and_large_d(pq_pairs, k):
    for (d, storage), (jix, tix, _) in pq_pairs.items():
        for batch in (8, 256, 1024):
            want = jix.describe_scan(batch)
            assert want == ROUTE[storage], (d, storage, batch, want)
            assert tix.describe_scan(batch, top_k=k) == want, (d, storage, batch)
        # a max_scans budget keeps the plain dense route, as in the JAX package
        assert tix.describe_scan(8, max_scans=100, top_k=k) == jix.describe_scan(
            8, max_scans=100)


@pytest.mark.parametrize("d,k", [(24, 200), (768, 10)])
@pytest.mark.parametrize("storage", list(ROUTE))
def test_ivf_pq_wide_and_large_d_hits_match_jax(pq_pairs, storage, d, k):
    jix, tix, q = pq_pairs[d, storage]
    got, ref = tix.search_batch(q, k), jix.search_batch(q, k)
    if storage == "bf16":
        assert_hits_but_kth_ties(*hits_to_arrays(got), *hits_to_arrays(ref))
    else:
        assert_same_results(got, ref, rtol=SQ8_RTOL if storage == "sq8res" else 1e-5)
