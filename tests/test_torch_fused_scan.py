"""Port parity: ops/fused_scan.py against the JAX package's Pallas kernels.

The JAX side runs pallas_flat_topk / pallas_ivf_topk /
pallas_ivf_topk_windowed / pallas_ivf_sq8_topk(_windowed) in interpret
mode on the CPU, as tests/test_pallas_scan.py does; the port side runs the
plain versions of its CUDA kernels (what the wrappers dispatch to for CPU
tensors). Both are fp32 with a different summation order: hit sets must
be equal, scores within rtol 1e-5 / atol 1e-4 (the SQ8 kernels: the JAX
package's own rtol 1e-4 / atol 1e-4), order equal except inside near-ties
(see _torch_parity). The kernels themselves are held against these plain
versions on the card in test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    SQ8_RTOL,
    as_tensor,
    assert_same_hits,
    csr,
    flat_case,
    ivf_case,
    port_metric,
    split_partials,
    sq8_case,
)

from pyrope_tpu.ops.pallas_scan import (
    MASK_SENT,
    pallas_flat_topk,
    pallas_ivf_sq8_topk,
    pallas_ivf_sq8_topk_windowed,
    pallas_ivf_topk,
    pallas_ivf_topk_windowed,
    padded_probe_width,
    tile_cluster_windows,
)
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import fused_scan as fs


@pytest.mark.parametrize("metric,k,n", [
    (Metric.L2, 10, 4096),
    (Metric.INNER_PRODUCT, 10, 4096),
    (Metric.L2, 64, 1024),  # k > 32: the Pallas kernel's bitonic merge
])
def test_flat_plain_vs_pallas(metric, k, n):
    b, d = 16, 32
    x, q, sq, alive = flat_case(0, n, b, d)
    ms = n - 96  # max_scans cuts the tail
    jv, ji = pallas_flat_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                              jnp.asarray(alive), ms, k, metric)
    tv, ti = fs.fused_flat_topk_plain(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), ms, k,
                                      port_metric(metric), chunk_rows=1000)
    assert_same_hits(tv, ti, jv, ji)
    # the wrapper takes the plain version for CPU tensors
    wv, wi = fs.fused_flat_topk(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), ms, k,
                                port_metric(metric))
    np.testing.assert_array_equal(wi.numpy(), ti.numpy())
    assert wi.dtype == torch.int32


def test_flat_fewer_live_than_k_reports_minus_one():
    n, b, d, k = 1024, 8, 16, 10
    x, q, sq, _ = flat_case(1, n, b, d)
    alive = np.zeros(n, bool)
    alive[:3] = True
    jv, ji = pallas_flat_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                              jnp.asarray(alive), n, k, Metric.L2)
    tv, ti = fs.fused_flat_topk(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), n, k)
    assert_same_hits(tv, ti, jv, ji)
    assert (ti.numpy()[:, 3:] == -1).all()
    assert np.isneginf(tv.numpy()[:, 3:]).all()


def test_flat_exact_ties_lower_row_first():
    n, b, d, k = 1024, 4, 8, 5
    x, q, sq, alive = flat_case(2, n, b, d)
    x[300] = x[900] = x[100]  # duplicate rows: exact score ties
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q[0] = x[100]
    jv, ji = pallas_flat_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                              jnp.asarray(alive), n, k, Metric.L2)
    tv, ti = fs.fused_flat_topk(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), n, k)
    assert list(ti.numpy()[0, :3]) == [100, 300, 900]
    np.testing.assert_array_equal(ti.numpy()[0], np.asarray(ji)[0])


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_plain_vs_pallas(metric):
    n, b, d, k, kc = 4096, 64, 32, 10, 17
    x, q, sq, alive, crow, probe = ivf_case(3, n, b, d, kc, 3)
    kp = 128
    probed = np.zeros((b, kp), np.float32)
    probed[np.arange(b)[:, None], probe] = 1.0
    jv, ji = pallas_ivf_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq),
                             jnp.asarray(alive), jnp.asarray(crow),
                             jnp.asarray(probed), k, metric)
    tv, ti = fs.fused_ivf_topk(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), as_tensor(crow),
                               *csr(crow, kp), as_tensor(probe), kp, k, port_metric(metric),
                               max_len=n)
    assert_same_hits(tv, ti, jv, ji)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_plain_vs_pallas_windowed(metric):
    # Kp = 640 > 512: the JAX package's windowed kernel (K3), which the
    # port folds into its one IVF kernel
    n, b, d, k, kc = 16384, 16, 32, 10, 640
    x, q, sq, alive, crow, probe = ivf_case(11, n, b, d, kc, 5)
    probed_t = np.zeros((kc, b), np.float32)
    probed_t[probe.T, np.arange(b)[None, :]] = 1.0
    tile_clo, ok = tile_cluster_windows(crow, n, n, 4096, kpad=kc)
    assert ok
    jv, ji = pallas_ivf_topk_windowed(
        jnp.asarray(q), jnp.asarray(x), jnp.asarray(sq), jnp.asarray(alive),
        jnp.asarray(crow), jnp.asarray(probed_t, dtype=jnp.bfloat16),
        jnp.asarray(tile_clo), k, metric,
    )
    tv, ti = fs.fused_ivf_topk(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), as_tensor(crow),
                               *csr(crow, kc), as_tensor(probe), kc, k, port_metric(metric),
                               max_len=n)
    assert_same_hits(tv, ti, jv, ji)


def _sq8_port(case, kp, k, metric):
    q, codes, mn, sc, sq, alive, crow, probe, _, qc = case
    return fs.fused_ivf_sq8_topk(*(as_tensor(a) for a in (
        q, codes, mn, sc, sq, alive, crow)), *csr(crow, kp), as_tensor(probe),
        as_tensor(qc), kp, k, port_metric(metric), max_len=len(crow))


@pytest.mark.parametrize("d", [32, 24])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_sq8_plain_vs_pallas(metric, d):
    # the shapes of test_pallas_scan.py's K4 test; d 24 is no multiple of 16
    n, b, k, kc, kp = 4096, 16, 10, 24, 128
    case = sq8_case(21, n, b, d, kc, 5, kp)
    q, codes, mn, sc, sq, alive, crow, probe, _, qc = case
    tq = np.full((b, kp), MASK_SENT, np.float32)
    tq[np.arange(b)[:, None], probe] = np.take_along_axis(qc, probe, axis=1)
    jv, ji = pallas_ivf_sq8_topk(*(jnp.asarray(a) for a in (
        q, codes, mn, sc, sq, alive, crow, tq)), k, metric)
    tv, ti = _sq8_port(case, kp, k, metric)
    assert ti.dtype == torch.int32
    assert_same_hits(tv, ti, jv, ji, rtol=SQ8_RTOL)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_ivf_sq8_plain_vs_pallas_windowed(metric):
    # kc 640 > 512: the JAX package's windowed SQ8 kernel (K5), which the
    # port folds into its one SQ8 mode
    n, b, k, kc = 16384, 16, 10, 640
    kp = padded_probe_width(kc)
    case = sq8_case(22, n, b, 32, kc, 5, kp)
    q, codes, mn, sc, sq, alive, crow, probe, _, qc = case
    tq_t = np.full((kp, b), MASK_SENT, np.float32)
    tq_t[probe.T, np.arange(b)[None, :]] = np.take_along_axis(qc, probe, axis=1).T
    tile_clo, ok = tile_cluster_windows(crow, n, n, 4096, kpad=kp)
    assert ok
    jv, ji = pallas_ivf_sq8_topk_windowed(*(jnp.asarray(a) for a in (
        q, codes, mn, sc, sq, alive, crow, tq_t, tile_clo)), k, metric)
    tv, ti = _sq8_port(case, kp, k, metric)
    assert_same_hits(tv, ti, jv, ji, rtol=SQ8_RTOL)


def test_ivf_sq8_dead_pad_rows_never_surface():
    """Pad rows encode -c and are alive=False: with every live row of the
    probed clusters gone, the slots stay empty."""
    n, b, kc, kp = 1024, 4, 6, 8
    q, codes, mn, sc, sq, alive, crow, probe, cents, qc = sq8_case(3, n, b, 16, kc, 2, kp)
    alive[:] = False
    alive[crow == probe[0, 0]] = True      # query 0's first list only
    tv, ti = _sq8_port((q, codes, mn, sc, sq, alive, crow, probe, cents, qc),
                       kp, 10, "L2")
    live = set(np.nonzero(alive)[0].tolist())
    for row in range(b):
        got = [r for r in ti[row].tolist() if r >= 0]
        assert set(got) <= live
        assert np.isneginf(tv[row].numpy()[len(got):]).all()


def test_merge_partials_equals_one_scan():
    x, q, sq, alive = flat_case(7, 3000, 9, 8)
    x[2500] = x[60]                     # a tie across splits
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q[0] = x[60]
    pv, pi = split_partials(q, x, sq, alive, 12, per=640)
    mv, mi = fs.merge_partials(pv, pi)
    wv, wi = fs.fused_flat_topk_plain(as_tensor(q), as_tensor(x), as_tensor(sq), as_tensor(alive), 3000, 12)
    np.testing.assert_array_equal(mi.numpy(), wi.numpy())
    np.testing.assert_array_equal(mv.numpy(), wv.numpy())
    assert list(mi.numpy()[0, :2]) == [60, 2500]


def test_wrapper_validation():
    q, x = torch.zeros((4, 8)), torch.zeros((64, 8))
    sq, alive = torch.zeros(64), torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="cosine"):
        fs.fused_flat_topk(q, x, sq, alive, 64, 5, "COSINE")
    with pytest.raises(ValueError, match="k must be"):
        fs.fused_flat_topk(q, x, sq, alive, 64, fs.MAX_K + 1)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        fs.fused_flat_topk(q, x.bfloat16(), sq, alive, 64, 5)
    codes, crow = torch.zeros((64, 8), dtype=torch.uint8), torch.zeros(64, dtype=torch.int32)
    probe, qc = torch.zeros((4, 2), dtype=torch.int64), torch.zeros((4, 8))
    offs, lens = fs.list_csr(crow, 8)
    with pytest.raises(ValueError, match="int32"):
        fs.fused_ivf_topk(q, x, sq, alive, torch.zeros(64, dtype=torch.int64),
                          offs, lens, probe, 8, 5, max_len=64)
    with pytest.raises(ValueError, match="lens must be int32"):
        fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens.long(), probe, 8, 5, max_len=64)
    with pytest.raises(ValueError, match="offsets must be int32"):
        fs.fused_ivf_topk(q, x, sq, alive, crow, offs[:4], lens, probe, 8, 5, max_len=64)
    with pytest.raises(ValueError, match="uint8"):
        fs.fused_ivf_sq8_topk(q, x, sq, sq, sq, alive, crow, offs, lens, probe, qc, 8, 5,
                              max_len=64)
    with pytest.raises(ValueError, match="qc"):
        fs.fused_ivf_sq8_topk(q, codes, sq, sq, sq, alive, crow, offs, lens, probe,
                              qc[:, :4], 8, 5, max_len=64)
    with pytest.raises(ValueError, match="mins"):
        fs.fused_ivf_sq8_topk(q, codes, sq[:9], sq, sq, alive, crow, offs, lens, probe,
                              qc, 8, 5, max_len=64)
