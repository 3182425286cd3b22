"""Port parity: ops/topk.py and ops/distance.py against the JAX package.

Tolerance (see _torch_parity): fp32 on both sides with a different
summation order, so scores agree within rtol 1e-5 / atol 1e-4; selections
over identical score arrays must agree exactly, tie order included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ATOL, RTOL, assert_same_hits, port_metric

from pyrope_tpu.ops import distance as jdist
from pyrope_tpu.ops import topk as jtopk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import distance as tdist
from pyrope_tpu_torch.ops import topk as ttopk


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_masked_topk_exact_ties_lower_row_first():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0],
                       [5.0, 5.0, 5.0, 5.0, 5.0]], np.float32)
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), None, 3)
    tv, ti = ttopk.masked_topk(_t(scores), None, 3)
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4], [0, 1, 2]])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("mask_kind", ["none", "row", "matrix"])
def test_masked_topk_vs_jax(mask_kind):
    rng = np.random.default_rng(0)
    # quantized scores force many exact ties across the k boundary
    scores = np.round(rng.normal(size=(16, 300)), 1).astype(np.float32)
    mask = {"none": None,
            "row": rng.random(300) > 0.3,
            "matrix": rng.random((16, 300)) > 0.3}[mask_kind]
    jm = None if mask is None else jnp.asarray(mask[None] if mask.ndim == 1 else mask)
    tm = None if mask is None else _t(mask[None] if mask.ndim == 1 else mask)
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), jm, 25)
    tv, ti = ttopk.masked_topk(_t(scores), tm, 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_masked_topk_k_over_n_pads_minus_inf_minus_one():
    scores = np.array([[0.5, -1.0, 2.0, 0.0]], np.float32)
    mask = np.array([[True, False, True, True]])
    jv, ji = jtopk.masked_topk(jnp.asarray(scores), jnp.asarray(mask), 7)
    tv, ti = ttopk.masked_topk(_t(scores), _t(mask), 7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy(), [[2, 0, 3, -1, -1, -1, -1]])
    assert np.isneginf(tv.numpy()[0, 3:]).all()


def test_approx_selection_runs_exact():
    rng = np.random.default_rng(1)
    scores = rng.normal(size=(4, 5000)).astype(np.float32)
    ev, ei = ttopk.masked_topk(_t(scores), None, 10, "exact")
    av, ai = ttopk.masked_topk(_t(scores), None, 10, "approx:0.9")
    np.testing.assert_array_equal(ai.numpy(), ei.numpy())
    assert ttopk.parse_selection("approx:0.9") == jtopk.parse_selection("approx:0.9")
    with pytest.raises(ValueError):
        ttopk.parse_selection("fastest")


def test_merge_topk_vs_jax_ties_keep_first_set():
    rng = np.random.default_rng(2)
    va = np.sort(np.round(rng.normal(size=(8, 10)), 1), axis=1)[:, ::-1].astype(np.float32)
    vb = np.sort(np.round(rng.normal(size=(8, 10)), 1), axis=1)[:, ::-1].astype(np.float32)
    va[:, -2:] = -np.inf
    ia = rng.integers(0, 1000, (8, 10)).astype(np.int32)
    ib = rng.integers(1000, 2000, (8, 10)).astype(np.int32)
    ia[:, -2:] = -1
    jv, ji = jtopk.merge_topk(*(jnp.asarray(a) for a in (va, ia, vb, ib)), 12)
    tv, ti = ttopk.merge_topk(*(_t(a) for a in (va, ia, vb, ib)), 12)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_chunked_exact_topk_vs_jax():
    rng = np.random.default_rng(3)
    x = rng.random((1000, 16), np.float32)
    q = rng.random((6, 16), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = rng.random(1000) > 0.1
    jv, ji = jtopk.chunked_exact_topk(jnp.asarray(x), jnp.asarray(sq),
                                      jnp.asarray(alive), jnp.asarray(q), 10,
                                      "L2", chunk_rows=256)
    tv, ti = ttopk.chunked_exact_topk(_t(x), _t(sq), _t(alive), _t(q), 10,
                                      "L2", chunk_rows=256)
    assert_same_hits(tv, ti, jv, ji)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE])
def test_score_matrix_vs_jax(metric):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(7, 24)).astype(np.float32)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    js = np.asarray(jdist.score_matrix(jnp.asarray(q), jnp.asarray(x), metric))
    ts = tdist.score_matrix(_t(q), _t(x), port_metric(metric)).numpy()
    np.testing.assert_allclose(ts, js, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE])
def test_rerank_exact_vs_jax(metric):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(200, 16)).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q = rng.normal(size=(5, 16)).astype(np.float32)
    cand = rng.integers(0, 200, (5, 12)).astype(np.int32)
    cand[:, -3:] = -1
    jv, ji = jdist.rerank_exact(jnp.asarray(x), jnp.asarray(sq), jnp.asarray(q),
                                jnp.asarray(cand), 15, metric)
    tv, ti = tdist.rerank_exact(_t(x), _t(sq), _t(q), _t(cand), 15, port_metric(metric))
    assert_same_hits(tv, ti, jv, ji)


def test_row_sqnorms_and_normalize_rows_vs_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(9, 33)).astype(np.float32)
    np.testing.assert_allclose(tdist.row_sqnorms(_t(x)).numpy(),
                               np.asarray(jdist.row_sqnorms(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tdist.normalize_rows(_t(x)).numpy(),
                               np.asarray(jdist.normalize_rows(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_tf32_refused_on_cuda_tensors_only():
    q = torch.zeros((2, 4))
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        tdist.score_matrix(q, q, "L2")  # CPU tensors never run in TF32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
