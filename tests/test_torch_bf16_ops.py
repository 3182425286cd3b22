"""Port parity of the bf16 modes below the indexes: ops/distance.py's
``compute_dtype``, the plain versions of the scans over bf16 slabs (with
and without ``promote_fp32``), the bf16 rerank, and bf16 training in
ops/kmeans.py and ops/pq.py, each against the JAX package on the same numpy
inputs (Pallas in interpret mode).

A product of two bf16 values is exact in fp32, so both packages compute
the same products and sum them in fp32 in another order: scores agree
within rtol 1e-5 / atol 1e-4, as the fp32 paths do. Scores rounded to bf16
tie more often, so a hit may differ only as a k-th place tie
(``assert_hits_but_kth_ties``). bf16 training is held to the same
centroid tolerance and assignment agreement as fp32 training
(test_torch_kmeans.py, test_torch_pq.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    ATOL,
    RTOL,
    as_tensor,
    assert_hits_but_kth_ties,
    csr,
    flat_case,
    ivf_case,
    port_metric,
)

from pyrope_tpu.ops import distance as jdist
from pyrope_tpu.ops import kmeans as jk
from pyrope_tpu.ops import pq as jpq
from pyrope_tpu.ops.pallas_scan import (
    pallas_flat_topk,
    pallas_ivf_topk,
    pallas_ivf_topk_windowed,
    tile_cluster_windows,
)
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import distance as tdist
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.ops import kmeans as tk
from pyrope_tpu_torch.ops import pq as tpq

METRICS = [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]


def _bf16(a: np.ndarray):
    """(JAX bf16 array, torch bf16 tensor) of one fp32 array: both round to
    nearest-even."""
    return jnp.asarray(a).astype(jnp.bfloat16), as_tensor(a).bfloat16()


@pytest.mark.parametrize("metric", METRICS)
def test_score_matrix_compute_dtype_vs_jax(metric):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(9, 40)).astype(np.float32)
    x = rng.normal(size=(300, 40)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    j = jdist.score_matrix(jnp.asarray(q), jnp.asarray(x), metric,
                           x_sqnorm=jnp.asarray(sq), compute_dtype=jnp.bfloat16)
    t = tdist.score_matrix(as_tensor(q), as_tensor(x), port_metric(metric),
                           x_sqnorm=as_tensor(sq), compute_dtype="bfloat16")
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)
    # the products are of bf16-rounded operands, the sums fp32: far from
    # the unrounded scores, and far from a bf16 matmul's rounded sums
    exact = tdist.score_matrix(as_tensor(q), as_tensor(x), port_metric(metric))
    assert not np.allclose(t.numpy(), exact.numpy(), rtol=RTOL, atol=ATOL)
    assert tdist.torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError, match="compute dtype"):
        tdist.score_matrix(as_tensor(q), as_tensor(x), "L2", compute_dtype="int8")


@pytest.mark.parametrize("metric", METRICS)
def test_score_matrix_widens_a_bf16_slab_vs_jax(metric):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    x = rng.normal(size=(200, 24)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)   # of the fp32 rows
    jx, tx = _bf16(x)
    j = jdist.score_matrix(jnp.asarray(q), jx, metric, x_sqnorm=jnp.asarray(sq))
    t = tdist.score_matrix(as_tensor(q), tx, port_metric(metric), x_sqnorm=as_tensor(sq))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_rerank_exact_off_a_bf16_slab_vs_jax(metric):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(500, 16)).astype(np.float32)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    cand = rng.integers(0, 500, (6, 40)).astype(np.int32)
    cand[:, -3:] = -1
    jx, tx = _bf16(x)
    jv, ji = jdist.rerank_exact(jx, jnp.asarray(sq), jnp.asarray(q), jnp.asarray(cand),
                                8, metric)
    tv, ti = tdist.rerank_exact(tx, as_tensor(sq), as_tensor(q), as_tensor(cand), 8,
                                port_metric(metric))
    assert_hits_but_kth_ties(tv, ti, jv, ji)


@pytest.mark.parametrize("metric,k,ms", [
    (Metric.L2, 10, 4000), (Metric.INNER_PRODUCT, 10, 4096), (Metric.L2, 16, 4096),
    (Metric.L2, 1, 3333),
])
def test_flat_bf16_plain_vs_pallas(metric, k, ms):
    n, b, d = 4096, 16, 32
    x, q, sq, alive = flat_case(3, n, b, d)
    jx, tx = _bf16(x)
    jv, ji = pallas_flat_topk(jnp.asarray(q), jx, jnp.asarray(sq), jnp.asarray(alive),
                              ms, k, metric)
    tv, ti = fs.fused_flat_topk(as_tensor(q), tx, as_tensor(sq), as_tensor(alive), ms, k,
                                port_metric(metric))
    assert_hits_but_kth_ties(tv, ti, jv, ji)
    pv, pi = fs.fused_flat_topk_plain(as_tensor(q), tx, as_tensor(sq), as_tensor(alive),
                                      ms, k, port_metric(metric), chunk_rows=1000)
    np.testing.assert_array_equal(pi.numpy(), ti.numpy())


def test_flat_bf16_rounds_q_but_not_its_norm():
    """The plain bf16 scores are bf16(q)·x with ‖q‖² of the fp32 q, as
    the TPU kernels' _tile_scores takes them."""
    x, q, sq, alive = flat_case(4, 512, 4, 16)
    tx = as_tensor(x).bfloat16()
    tq = as_tensor(q)
    v, i = fs.fused_flat_topk(tq, tx, as_tensor(sq), as_tensor(alive), 512, 5)
    qr = tq.bfloat16().double()
    want = -((tq.double() ** 2).sum(1, keepdim=True) - 2.0 * qr @ tx.double().T
             + as_tensor(sq).double()[None, :])
    np.testing.assert_allclose(v.numpy(), np.take_along_axis(want.numpy(), i.long().numpy(), 1),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("promote", [False, True])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_bf16_plain_vs_pallas(metric, promote):
    n, b, d, k, kc, kp = 4096, 16, 32, 10, 17, 128
    x, q, sq, alive, crow, probe = ivf_case(5, n, b, d, kc, 3)
    probed = np.zeros((b, kp), np.float32)
    probed[np.arange(b)[:, None], probe] = 1.0
    jx, tx = _bf16(x)
    jv, ji = pallas_ivf_topk(jnp.asarray(q), jx, jnp.asarray(sq), jnp.asarray(alive),
                             jnp.asarray(crow), jnp.asarray(probed), k, metric,
                             promote_fp32=promote)
    tv, ti = fs.fused_ivf_topk(as_tensor(q), tx, as_tensor(sq), as_tensor(alive),
                               as_tensor(crow), *csr(crow, kp), as_tensor(probe), kp, k,
                               port_metric(metric), max_len=n, promote_fp32=promote)
    assert_hits_but_kth_ties(tv, ti, jv, ji)


@pytest.mark.parametrize("promote", [False, True])
def test_ivf_bf16_plain_vs_pallas_windowed(promote):
    # kc 640 > 512: the JAX package's windowed kernel, which the port folds
    # into its one list scan
    n, b, d, k, kc = 16384, 16, 32, 16, 640
    x, q, sq, alive, crow, probe = ivf_case(13, n, b, d, kc, 5)
    probed_t = np.zeros((kc, b), np.float32)
    probed_t[probe.T, np.arange(b)[None, :]] = 1.0
    tile_clo, ok = tile_cluster_windows(crow, n, n, 4096, kpad=kc)
    assert ok
    jx, tx = _bf16(x)
    jv, ji = pallas_ivf_topk_windowed(
        jnp.asarray(q), jx, jnp.asarray(sq), jnp.asarray(alive), jnp.asarray(crow),
        jnp.asarray(probed_t, dtype=jnp.bfloat16), jnp.asarray(tile_clo), k, Metric.L2,
        promote_fp32=promote)
    tv, ti = fs.fused_ivf_topk(as_tensor(q), tx, as_tensor(sq), as_tensor(alive),
                               as_tensor(crow), *csr(crow, kc), as_tensor(probe), kc, k,
                               "L2", max_len=n, promote_fp32=promote)
    assert_hits_but_kth_ties(tv, ti, jv, ji)


def test_promote_is_the_identity_on_fp32_and_differs_on_bf16():
    n, b, d, k, kc = 2048, 8, 24, 10, 9
    x, q, sq, alive, crow, probe = ivf_case(6, n, b, d, kc, 3)
    args = (as_tensor(sq), as_tensor(alive), as_tensor(crow), *csr(crow, kc),
            as_tensor(probe), kc, k)
    q32 = as_tensor(q)
    for slab in (as_tensor(x),):
        a = fs.fused_ivf_topk(q32, slab, *args, max_len=n)
        p = fs.fused_ivf_topk(q32, slab, *args, max_len=n, promote_fp32=True)
        assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    x16 = as_tensor(x).bfloat16()
    a = fs.fused_ivf_topk(q32, x16, *args, max_len=n)
    p = fs.fused_ivf_topk(q32, x16, *args, max_len=n, promote_fp32=True)
    assert not torch.equal(a[0], p[0])
    # promote: fp32 q against the widened rows, the exact fp32 scan of them
    w = fs.fused_ivf_topk(q32, x16.float(), *args, max_len=n)
    assert_hits_but_kth_ties(p[0], p[1], w[0], w[1])


@pytest.fixture(scope="module")
def clustered():
    """Separated clusters and a seed whose sampled initial rows hit distinct
    clusters (see test_torch_kmeans.py): no row near a boundary."""
    rng = np.random.default_rng(7)
    centers = rng.random((6, 16)).astype(np.float32) * 4
    labels = rng.integers(0, 6, 6000)
    x = centers[labels] + rng.normal(0, 0.05, (6000, 16)).astype(np.float32)
    seed = next(s for s in range(10_000) if len(set(labels[
        np.random.default_rng(s).choice(6000, size=6, replace=False)])) == 6)
    return x, seed


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_kmeans_build_bf16_training_vs_jax(clustered, metric):
    x, seed = clustered
    jc, ja, _ = jk.kmeans_build(x, 6, metric, init="sample", seed=seed, block=2048,
                                compute_dtype="bfloat16")
    tc, ta, _ = tk.kmeans_build(x, 6, metric, device="cpu", init="sample", seed=seed,
                                block=2048, compute_dtype="bfloat16")
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    assert (ta == ja).mean() >= 0.999
    jt = jk.kmeans_train(x, 6, metric, init="sample", seed=seed, iters=4,
                         compute_dtype="bfloat16")
    tt = tk.kmeans_train(x, 6, metric, device="cpu", init="sample", seed=seed, iters=4,
                         compute_dtype="bfloat16")
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-4)
    assert (tk.kmeans_assign(x, tt, metric, device="cpu", compute_dtype="bfloat16")
            == jk.kmeans_assign(x, jt, metric, compute_dtype="bfloat16")).mean() >= 0.999


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_kmeans_bf16_training_near_boundaries_vs_jax(metric):
    """One Gaussian blob split 8 ways: most rows sit near a boundary, so
    rounding the operands to bf16 moves assignments and centroids (0.06-0.12
    on both packages). The port's bf16 training equals the JAX package's
    (the products of bf16 values are exact, only the order of the fp32 sums
    differs) and differs from its own fp32 training."""
    x = np.random.default_rng(21).normal(size=(3000, 16)).astype(np.float32)
    kw = dict(init="sample", seed=3, block=1024)
    jc, ja, _ = jk.kmeans_build(x, 8, metric, compute_dtype="bfloat16", **kw)
    tc, ta, _ = tk.kmeans_build(x, 8, metric, device="cpu", compute_dtype="bfloat16", **kw)
    fc, fa, _ = tk.kmeans_build(x, 8, metric, device="cpu", **kw)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ta, ja)
    assert np.abs(tc - fc).max() > 1e-2 and (ta == fa).mean() < 0.99
    jt = jk.kmeans_train(x, 8, metric, init="sample", seed=3, iters=4,
                         compute_dtype="bfloat16")
    tt = tk.kmeans_train(x, 8, metric, device="cpu", init="sample", seed=3, iters=4,
                         compute_dtype="bfloat16")
    ft = tk.kmeans_train(x, 8, metric, device="cpu", init="sample", seed=3, iters=4)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)
    assert np.abs(tt - ft).max() > 1e-2
    ta = tk.kmeans_assign(x, jt, metric, device="cpu", compute_dtype="bfloat16")
    np.testing.assert_array_equal(ta, jk.kmeans_assign(x, jt, metric,
                                                       compute_dtype="bfloat16"))
    assert not np.array_equal(ta, tk.kmeans_assign(x, jt, metric, device="cpu"))


def test_pq_train_encode_device_bf16_vs_jax():
    n, d, m, ksub = 3000, 32, 8, 64
    r = np.random.default_rng(8).normal(size=(n, d)).astype(np.float32)
    pad = np.pad(r, ((0, 64), (0, 0)))
    jcb, jcodes = jpq.pq_train_encode_device(
        jnp.asarray(pad), n, jpq.ProductQuantizer(m=m, ksub=ksub, dim=d),
        seed=42, compute="bfloat16", block=1024)
    tcb, tcodes = tpq.pq_train_encode_device(
        torch.from_numpy(pad), n, tpq.ProductQuantizer(m=m, ksub=ksub, dim=d),
        seed=42, compute="bfloat16", block=1024)
    # the fp32 training test's bounds (test_torch_pq.py); the stored codes
    # are fp32 argmins of each side's codebooks
    np.testing.assert_allclose(tcb, jcb, rtol=RTOL, atol=ATOL)
    assert (tcodes.numpy()[:n] == np.asarray(jcodes)[:n]).mean() >= 0.999
    fp32_cb, _ = tpq.pq_train_encode_device(
        torch.from_numpy(pad), n, tpq.ProductQuantizer(m=m, ksub=ksub, dim=d),
        seed=42, block=1024)
    assert not np.array_equal(fp32_cb, tcb)   # the training dtype took effect
