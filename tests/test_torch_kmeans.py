"""Port parity: ops/kmeans.py and ops/slab.py against the JAX package.

``init="sample"`` draws the same initial rows on both sides (one numpy
call), so Lloyd's iterations start equal; so does ``init="kmeans++"``, whose
draws are ``jax.random``'s own (ops/jrandom.py, checked bit for bit below). Both update in fp32 but sum in a
different order (a one-hot matmul against index_add_), so centroids agree
within 1e-4 and the final assignments on clustered data agree on >= 99.9%
of rows. The data are well separated clusters and the seed is one whose
initial rows fall in distinct clusters: there no row lies within rounding
of a boundary, where one flip would move a centroid by more than the
tolerance and Lloyd's iterations would amplify it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyrope_tpu.ops import kmeans as jk
from pyrope_tpu.ops import slab as jslab
from pyrope_tpu.utils.datasets import synthetic_clustered
from pyrope_tpu_torch.ops import jrandom
from pyrope_tpu_torch.ops import kmeans as tk
from pyrope_tpu_torch.ops import slab as tslab


K = 6


@pytest.fixture(scope="module")
def data():
    """(rows, seed): K separated Gaussian clusters, and a k-means seed whose
    sampled initial rows hit K distinct clusters."""
    rng = np.random.default_rng(5)
    centers = rng.random((K, 16)).astype(np.float32) * 4
    labels = rng.integers(0, K, 6000)
    x = centers[labels] + rng.normal(0, 0.05, (6000, 16)).astype(np.float32)
    seed = next(s for s in range(10_000) if len(set(labels[
        np.random.default_rng(s).choice(6000, size=K, replace=False)])) == K)
    return x, seed


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_kmeans_build_sample_init_vs_jax(data, metric):
    x, seed = data
    jc, ja, _ = jk.kmeans_build(x, K, metric, init="sample", seed=seed, block=2048)
    tc, ta, x_dev = tk.kmeans_build(x, K, metric, device="cpu", init="sample",
                                    seed=seed, block=2048)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    assert ta.dtype == np.int32 and ta.shape == ja.shape
    assert (ta == ja).mean() >= 0.999
    assert x_dev.shape == x.shape


def test_kmeans_train_and_assign_vs_jax(data):
    x, seed = data
    jc = jk.kmeans_train(x, K, "L2", init="sample", seed=seed, iters=5)
    tc = tk.kmeans_train(x, K, "L2", device="cpu", init="sample", seed=seed, iters=5)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
    ja = jk.kmeans_assign(x, jc, "L2", block=1000)
    ta = tk.kmeans_assign(x, jc, "L2", device="cpu", block=1000)
    assert (ta == ja).mean() >= 0.999


def test_kmeans_pp_deterministic_and_valid():
    x = synthetic_clustered(3000, 16, n_clusters=24, seed=5)
    c1, a1, _ = tk.kmeans_build(x, 24, "L2", device="cpu", seed=7)
    c2, a2, _ = tk.kmeans_build(x, 24, "L2", device="cpu", seed=7)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
    assert c1.shape == (24, 16) and np.isfinite(c1).all()
    assert a1.min() >= 0 and a1.max() < 24
    # k clips to N; duplicates collapse D² to zero and fall back to uniform
    c, a, _ = tk.kmeans_build(np.ones((5, 4), np.float32), 9, "L2", device="cpu")
    assert c.shape == (5, 4) and (a >= 0).all()
    with pytest.raises(ValueError):
        tk.kmeans_build(np.zeros((0, 4), np.float32), 3, device="cpu")
    with pytest.raises(ValueError, match="init"):
        tk.kmeans_build(x, 3, device="cpu", init="random")


def test_take_slab_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    order = rng.permutation(50)
    jidx = jslab.pad_order(order, 64, 50)
    jx, jsq = jslab.take_slab(jnp.asarray(x), jidx)
    tidx = tslab.pad_order(order, 64, 50, "cpu")
    tx, tsq = tslab.take_slab(torch.from_numpy(x), tidx)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(tsq.numpy(), np.asarray(jsq), rtol=1e-5, atol=1e-4)
    assert (tx.numpy()[50:] == 0).all() and (tsq.numpy()[50:] == 0).all()


# ---- jax.random's draws (ops/jrandom.py) and the k-means++ seeding --------

SEEDS = [0, 1, 42, 2**31 - 1]


def test_threefry2x32_known_answers():
    """The Threefry-2x32 (20 rounds) known-answer vectors that jax.random's
    own tests use."""
    m = 0xFFFFFFFF
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((m, m), (m, m), (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        a, b = jrandom.threefry2x32(*(torch.tensor(v) for v in (*key, *ctr)))
        assert (int(a), int(b)) == want


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_jrandom_is_jax_random_bit_for_bit(seed, n):
    key, tkey = jax.random.PRNGKey(seed), jrandom.prng_key(seed)
    assert (np.asarray(jax.random.key_data(key)).astype(np.int64) == tkey.numpy()).all()
    np.testing.assert_array_equal(jrandom.split(tkey, n).numpy(),
                                  np.asarray(jax.random.split(key, n)).astype(np.int64))
    np.testing.assert_array_equal(jrandom.random_bits(tkey, n).numpy(),
                                  np.asarray(jax.random.bits(key, (n,))).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(key, (n,), minval=lo, maxval=hi))
        got = jrandom.uniform(tkey, n, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # -log(-log(u)): torch's log and XLA's round apart by an ulp at times
    np.testing.assert_allclose(jrandom.gumbel(tkey, n).numpy(),
                               np.asarray(jax.random.gumbel(key, (n,))), rtol=0, atol=2e-6)
    rng = np.random.default_rng(seed % 1000)
    for logits in (rng.standard_normal(n), np.log(rng.random(n) + 1e-3) * 3,
                   np.where(rng.random(n) < 0.5, -np.inf, 0.0)):
        logits = logits.astype(np.float32)
        if np.isinf(logits).all():
            logits[0] = 0.0
        assert (int(jrandom.categorical(tkey, torch.from_numpy(logits)))
                == int(jax.random.categorical(key, logits)))


def _kpp_pair(x, k, seed, block=512):
    """The JAX package's _kpp_init on its padded upload, and the port's."""
    x_dev, valid = jk._upload_padded(x, block)
    want = np.asarray(jk._kpp_init(x_dev, jnp.asarray(valid), seed, k=k))
    got = tk._kpp_init(torch.from_numpy(x), k, seed).numpy()
    return got, want


def _rows_of(cents, x):
    """The row of x each centroid is (its first copy)."""
    return [int(np.flatnonzero((x == c).all(axis=1))[0]) for c in cents]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_kpp_init_picks_the_jax_rows(kind, seed):
    x = (synthetic_clustered(3000, 16, n_clusters=24, seed=5) if kind == "clustered"
         else np.random.default_rng(9).random((2500, 12), dtype=np.float32))
    got, want = _kpp_pair(x, 24, seed)
    assert _rows_of(got, x) == _rows_of(want, x)
    np.testing.assert_array_equal(got, want)


def test_kpp_init_on_a_duplicate_corpus_is_jax_uniform_fallback():
    """All D² zero after the first pick: every later draw is the uniform
    fallback, as in the JAX package; the rows are picked by index."""
    x = np.repeat(np.random.default_rng(3).random((1, 8), dtype=np.float32), 700, 0)
    x[::7] += 1.0   # two distinct values, so both fallbacks run
    got, want = _kpp_pair(x, 9, 11)
    np.testing.assert_array_equal(got, want)
    keys = jax.random.split(jax.random.PRNGKey(11), 9)
    first = int(jax.random.categorical(keys[0], jnp.zeros(700)))
    np.testing.assert_array_equal(got[0], x[first])


def test_kmeans_build_kmeanspp_vs_jax(data):
    """With the same seeding, Lloyd's iterations start equal: the trained
    centroids agree as the sample-init builds do."""
    x, _ = data
    for seed in (0, 7):
        jc, ja, _ = jk.kmeans_build(x, K, "L2", seed=seed, block=2048)
        tc, ta, _ = tk.kmeans_build(x, K, "L2", device="cpu", seed=seed, block=2048)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-4)
        assert (ta == ja).mean() >= 0.999
