"""Port parity: ops/pq.py, the SQ8 parts of ops/slab.py and
ops/distance.rerank_exact_sq8res against the JAX package.

The same numpy inputs go through both. PQ training starts from the same
numpy draws (seed 42+m) and runs Lloyd's iterations in fp32 on both sides
with another summation order, so codebooks agree within rtol 1e-5 / atol
1e-4 and codes are equal except where a row is within rounding of two
codewords. The ADC tables sum in another order too (same tolerance); the
accumulates select exact fp32 entries and sum them in subspace order on
both sides. The residual-SQ8 encoders are elementwise fp32 and equal to
the JAX package's numpy encoder; XLA divides by 255 as a product with
its reciprocal, so against the JAX device encoder scales agree within
rounding and a code may sit one step over where its unrounded value is a
half-integer within rounding. ||x̂||² is a row sum (within tolerance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import ATOL, RTOL, as_tensor, assert_same_hits, port_metric

from pyrope_tpu.index import ivf_pq as jivfpq
from pyrope_tpu.ops import distance as jdist
from pyrope_tpu.ops import pq as jpq
from pyrope_tpu.ops import slab as jslab
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import distance as tdist
from pyrope_tpu_torch.ops import kmeans as tk
from pyrope_tpu_torch.ops import pq as tpq
from pyrope_tpu_torch.ops import slab as tslab


def _residuals(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def assert_codes_equal_but_ties(codes_a, codes_b, data, codebooks):
    """Codes equal, except a row whose two codewords lie within rounding
    of the same distance in that subspace."""
    m, _, sub = codebooks.shape
    for row, mi in zip(*np.nonzero(codes_a != codes_b)):
        x = data[row, mi * sub : (mi + 1) * sub].astype(np.float64)
        da, db = (np.sum((x - codebooks[mi, c]) ** 2)
                  for c in (codes_a[row, mi], codes_b[row, mi]))
        assert np.isclose(da, db, rtol=RTOL, atol=ATOL), (row, mi, da, db)


@pytest.mark.parametrize("n,d,m,ksub", [(3000, 32, 8, 64), (5000, 16, 4, 256)])
def test_pq_train_encode_device_vs_jax(n, d, m, ksub):
    r = _residuals(n, n, d)
    pad = np.pad(r, ((0, 96), (0, 0)))        # rows >= n are padding
    jcb, jcodes = jpq.pq_train_encode_device(
        jnp.asarray(pad), n, jpq.ProductQuantizer(m=m, ksub=ksub, dim=d),
        seed=42, compute=None, block=1024)
    tcb, tcodes = tpq.pq_train_encode_device(
        torch.from_numpy(pad), n, tpq.ProductQuantizer(m=m, ksub=ksub, dim=d),
        seed=42, block=1024)
    np.testing.assert_allclose(tcb, jcb, rtol=RTOL, atol=ATOL)
    assert tcodes.dtype == torch.int32 and tcodes.shape == (n + 96, m)
    assert_codes_equal_but_ties(tcodes.numpy()[:n], np.asarray(jcodes)[:n], r, jcb)


def test_pq_bf16_training_not_yet_ported():
    pq = tpq.ProductQuantizer(m=4, ksub=16, dim=16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tpq.pq_train_encode_device(torch.zeros(64, 16), 64, pq, compute="bfloat16")


@pytest.mark.parametrize("n", [300, 100])  # n < ksub: the last codeword fills the rest
def test_product_quantizer_host_path_vs_jax(n):
    d, m, ksub = 16, 4, 128
    x = _residuals(7, n, d)
    jp = jpq.ProductQuantizer(m=m, ksub=ksub, dim=d)
    tp = tpq.ProductQuantizer(m=m, ksub=ksub, dim=d)
    jp.train(x, seed=42, iters=5)
    tp.train(x, device="cpu", seed=42, iters=5)
    np.testing.assert_allclose(tp.codebooks, jp.codebooks, rtol=RTOL, atol=ATOL)
    tcodes = tp.encode(x, device="cpu")
    assert tcodes.dtype == np.uint8
    assert_codes_equal_but_ties(tcodes, jp.encode(x), x, jp.codebooks)
    np.testing.assert_array_equal(tp.decode(tcodes), jp.decode(tcodes))
    back = tpq.ProductQuantizer.from_state(tp.state())
    assert (back.m, back.ksub, back.sub) == (m, ksub, d // m)
    np.testing.assert_array_equal(back.codebooks, tp.codebooks)
    assert not tpq.ProductQuantizer.from_state({**tp.state(), "codebooks": None}).trained
    with pytest.raises(ValueError):
        tpq.ProductQuantizer(m=3, ksub=16, dim=16)
    with pytest.raises(ValueError):
        tpq.ProductQuantizer(m=4, ksub=512, dim=16)


@pytest.fixture(scope="module")
def adc_case():
    rng = np.random.default_rng(11)
    b, d, m, ksub, n = 6, 32, 8, 64, 500
    q = rng.normal(size=(b, d)).astype(np.float32)
    cb = rng.normal(size=(m, ksub, d // m)).astype(np.float32)
    codes = rng.integers(0, ksub, size=(n, m)).astype(np.uint8)
    blocks = rng.integers(0, ksub, size=(b, 40, m)).astype(np.uint8)
    return q, cb, codes, blocks


@pytest.mark.parametrize("table", ["l2", "ip"])
def test_adc_tables_and_accumulates_vs_jax(adc_case, table):
    q, cb, codes, blocks = adc_case
    jfn, tfn = ((jpq.adc_l2_table, tpq.adc_l2_table) if table == "l2"
                else (jpq.adc_ip_table, tpq.adc_ip_table))
    jt = np.asarray(jfn(jnp.asarray(q), jnp.asarray(cb)))
    tt = tfn(as_tensor(q), as_tensor(cb))
    np.testing.assert_allclose(tt.numpy(), jt, rtol=RTOL, atol=ATOL)
    # the accumulates on one table: equal sums, the same entries added in order
    t = as_tensor(jt)
    for impl in ("onehot", "gather"):
        want = np.asarray(jpq.adc_accumulate(jnp.asarray(jt), jnp.asarray(blocks), impl=impl))
        np.testing.assert_array_equal(tpq.adc_accumulate(t, as_tensor(blocks)).numpy(), want)
    want = np.asarray(jpq.adc_accumulate_shared(jnp.asarray(jt), jnp.asarray(codes)))
    np.testing.assert_array_equal(tpq.adc_accumulate_shared(t, as_tensor(codes)).numpy(), want)


def test_compute_cdot_vs_jax(adc_case):
    _, cb, codes, _ = adc_case
    rng = np.random.default_rng(3)
    cents = rng.normal(size=(5, 32)).astype(np.float32)
    crow = np.sort(rng.integers(0, 5, size=codes.shape[0])).astype(np.int32)
    from pyrope_tpu_torch.index.ivf_pq import compute_cdot

    np.testing.assert_array_equal(compute_cdot(codes, crow, cents, cb),
                                  jivfpq.compute_cdot(codes, crow, cents, cb))


def assert_sq8_codes_match(got, want, x, cents, crow, mins, scales):
    """SQ8 codes equal, except one step apart where the unrounded code
    lies within rounding of a half-integer (XLA may divide in another
    form than IEEE division: a product with the reciprocal)."""
    for row, col in zip(*np.nonzero(got != want)):
        assert abs(int(got[row, col]) - int(want[row, col])) == 1, (row, col)
        r = float(x[row, col]) - float(cents[crow[row], col])
        u = (r - float(mins[row])) / float(scales[row])
        assert abs(u - (min(got[row, col], want[row, col]) + 0.5)) < 1e-3, (row, col, u)


def _sq8_case(seed=5, n=900, d=24, kc=7, kpad=8, npad=1024):
    rng = np.random.default_rng(seed)
    cents = np.zeros((kpad, d), np.float32)
    cents[:kc] = rng.normal(size=(kc, d)) * 3
    x = rng.normal(size=(n, d)).astype(np.float32)
    order = rng.permutation(n)
    crow = np.full(npad, kpad - 1, np.int32)
    crow[:n] = np.sort(rng.integers(0, kc, size=n))
    return x, cents, order, crow


def test_take_slab_sq8res_vs_jax():
    """The build path: gather, then encode every slab row (pad rows -c)."""
    x, cents, order, crow = _sq8_case()
    npad = crow.shape[0]
    jout = jslab.take_slab_sq8res(jnp.asarray(x), jslab.pad_order(order, npad, len(x)),
                                  jnp.asarray(cents), jnp.asarray(crow))
    tout = tslab.take_slab_sq8res(as_tensor(x), tslab.pad_order(order, npad, len(x), "cpu"),
                                  as_tensor(cents), as_tensor(crow), chunk=300)
    jcodes, jmn, jsc, jsq = (np.asarray(a) for a in jout)
    assert tout[0].dtype == torch.uint8 and tout[0].shape == (npad, x.shape[1])
    xp = np.zeros((npad, x.shape[1]), np.float32)
    xp[: len(x)] = x[order]
    assert_sq8_codes_match(tout[0].numpy(), jcodes, xp, cents, crow, jmn, jsc)
    np.testing.assert_array_equal(tout[1].numpy(), jmn)
    np.testing.assert_allclose(tout[2].numpy(), jsc, rtol=RTOL, atol=0)
    same = (tout[0].numpy() == jcodes).all(axis=1)   # ||x̂||² of equal codes
    np.testing.assert_allclose(tout[3].numpy()[same], jsq[same], rtol=RTOL, atol=ATOL)


def test_sq8res_load_path_vs_both_jax_encoders():
    """The load path encodes host rows with the same function; it matches
    the JAX package's host encoder, and on real rows its device one."""
    x, cents, order, crow = _sq8_case(seed=6)
    n, npad = x.shape[0], crow.shape[0]
    xp = x[order]
    host = jivfpq.sq8res_encode_host(xp, cents, crow[:n], chunk=256)
    dev = [np.asarray(a) for a in jslab.take_slab_sq8res(
        jnp.asarray(x), jslab.pad_order(order, npad, n), jnp.asarray(cents),
        jnp.asarray(crow))]
    out = [t.numpy() for t in tslab.sq8res_encode_host(
        xp, as_tensor(cents), as_tensor(crow[:n]), npad, chunk=256)]
    for got, want_host, want_dev in zip(out, host, dev):
        assert got.shape[0] == npad and not got[n:].any()   # zero pad rows
    np.testing.assert_array_equal(out[0][:n], host[0])      # numpy: IEEE as torch
    assert_sq8_codes_match(out[0][:n], dev[0][:n], xp, cents, crow, host[1], host[2])
    np.testing.assert_array_equal(out[1][:n], host[1])
    np.testing.assert_array_equal(out[2][:n], host[2])
    same = (out[0][:n] == dev[0][:n]).all(axis=1)
    for got, want_host, want_dev in list(zip(out, host, dev))[1:]:
        np.testing.assert_allclose(got[:n], want_host, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[:n][same], want_dev[:n][same], rtol=RTOL, atol=ATOL)


def test_take_rows_and_cast_vs_jax():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 256, size=(40, 4)).astype(np.int32)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    order = rng.permutation(40)
    jidx, tidx = jslab.pad_order(order, 48, 40), tslab.pad_order(order, 48, 40, "cpu")
    np.testing.assert_array_equal(tslab.take_rows(as_tensor(codes), tidx).numpy(),
                                  np.asarray(jslab.take_rows(jnp.asarray(codes), jidx)))
    jx, jsq = jslab.take_slab_cast(jnp.asarray(x), jidx, dtype="float32")
    tx, tsq = tslab.take_slab_cast(as_tensor(x), tidx, dtype="float32")
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tslab.take_slab_cast(as_tensor(x), tidx, dtype="bfloat16")


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE])
def test_rerank_exact_sq8res_vs_jax(metric):
    x, cents, order, crow = _sq8_case(seed=8)
    npad = crow.shape[0]
    codes, mn, sc, sq = jslab.take_slab_sq8res(
        jnp.asarray(x), jslab.pad_order(order, npad, len(x)), jnp.asarray(cents),
        jnp.asarray(crow))
    rng = np.random.default_rng(9)
    q = rng.normal(size=(5, x.shape[1])).astype(np.float32)
    cand = rng.integers(0, len(x), size=(5, 60)).astype(np.int32)
    cand[:, ::7] = -1                     # missing candidates
    cand[0, 1:] = -1                      # fewer candidates than k
    slab = [np.asarray(a) for a in (codes, mn, sc)]
    jv, ji = jdist.rerank_exact_sq8res(*(jnp.asarray(a) for a in slab), jnp.asarray(crow),
                                       jnp.asarray(cents), sq, jnp.asarray(q),
                                       jnp.asarray(cand), 10, metric)
    tv, ti = tdist.rerank_exact_sq8res(*(as_tensor(a) for a in slab), as_tensor(crow),
                                       as_tensor(cents), as_tensor(np.asarray(sq)),
                                       as_tensor(q), as_tensor(cand), 10,
                                       port_metric(metric))
    assert ti.dtype == torch.int32
    assert (ti.numpy()[0, 1:] == -1).all()
    assert_same_hits(tv, ti, jv, ji)


def test_segment_sum_is_a_fixed_order_sum():
    """Lloyd's update: the one-hot product equals the float64 segment sum
    within rounding, and repeats bit for bit."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(5000, 12)).astype(np.float32)
    a = rng.integers(0, 9, size=5000)
    want = np.zeros((9, 12))
    np.add.at(want, a, x.astype(np.float64))
    got = tk.segment_sum(torch.from_numpy(a), torch.from_numpy(x), 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    again = tk.segment_sum(torch.from_numpy(a), torch.from_numpy(x), 9)
    assert torch.equal(got, again)
    batched = tk.segment_sum(torch.from_numpy(np.stack([a, a[::-1].copy()])),
                             torch.from_numpy(np.stack([x, x])), 9)
    assert batched.shape == (2, 9, 12)
    np.testing.assert_allclose(batched[0].numpy(), want, rtol=RTOL, atol=ATOL)
