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
    flat_scan_emulated,
    ivf_case,
    merge_emulated,
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
    with pytest.raises(ValueError, match="slab dtype"):
        fs.fused_flat_topk(q, x.half(), sq, alive, 64, 5)
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


# ---- the flat scan's tile choice, grid and block work; the merge's floor -----


def _old_flat_smem(d, k):
    """Shared memory of the flat kernel's first form (64 resident queries,
    one 128 x 32 stage): what it took is what must still fit."""
    return 4 * (d * 68 + 32 * 129 + 2 * 128 + 64 + 2 * 64 * k)


@pytest.mark.parametrize("d", [1, 16, 100, 128, 384, 600, 2048])
@pytest.mark.parametrize("k", [1, 10, 44, 45, 100, 122, 123, 128])
@pytest.mark.parametrize("b", [1, 64, 65, 1024])
def test_flat_tile_fits_shared_memory(d, k, b):
    tile, smem = fs.flat_tile(d, k, b)
    assert tile in fs.FLAT_QUERY_TILES
    assert smem == fs.flat_scan_smem_bytes(k, tile) <= fs.SMEM_LIMIT
    # a batch one narrow tile holds takes it, whatever k is
    assert tile == 64 or b > 64
    # two blocks share an SM wherever a tile allows it, the wider tile first
    two = [t for t in (128, 64) if (b > 64 or t == 64)
           and fs.flat_scan_smem_bytes(k, t) <= fs.SMEM_TWO_BLOCKS]
    assert (smem <= fs.SMEM_TWO_BLOCKS) == bool(two)
    if two:
        assert tile == two[0]


def test_flat_tile_keeps_what_fit_and_raises_on_the_rest():
    for d in (8, 128, 384, 600, 800):
        for k in (1, 10, 128):
            if _old_flat_smem(d, k) <= fs.SMEM_LIMIT:
                assert fs.flat_tile(d, k, 1024)[1] <= fs.SMEM_LIMIT
    tile, smem = fs.flat_tile(128, 10, 1024)
    assert tile == 128 and 2 * (smem + 1024) <= 233_472   # two blocks an SM
    assert fs.flat_tile(128, 100, 1024) == (64, fs.flat_scan_smem_bytes(100, 64))
    assert fs.flat_tile(128, 100, 1024)[1] <= fs.SMEM_TWO_BLOCKS
    assert fs.flat_tile(128, 128, 1024)[0] == 128          # one block an SM either way
    with pytest.raises(ValueError, match="k in"):
        fs.flat_tile(128, fs.MAX_K + 1, 1024)
    with pytest.raises(ValueError, match="k in"):
        fs.flat_tile(128, 0, 1024)
    with pytest.raises(ValueError, match="D >= 1"):
        fs.flat_tile(0, 10, 1024)


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("b,n_rows", [(1, 1_000_000), (64, 1_000_000), (1024, 1_000_000),
                                      (1024, 600_000), (70, 20_000 - 999), (1024, 8192),
                                      (129, 100), (5, 0)])
def test_scan_splits_cover_the_rows_in_whole_tiles(b, n_rows, tile):
    per, n_splits = fs._splits(b, n_rows, 132, tile)
    assert n_splits >= 1 and per >= fs.ROW_TILE and per % fs.ROW_TILE == 0
    assert (n_splits - 1) * per < max(n_rows, 1) <= n_splits * per
    q_tiles = -(-b // tile)
    assert n_splits * q_tiles <= max(4 * 132 + q_tiles, q_tiles)  # about four blocks an SM


def _emulated_vs_plain(x, q, sq, alive, ms, k, tile, per, batch, seed=0, refresh_every=1):
    """The block emulation + the merge emulation against the plain version's
    selection on the same score matrix: bit for bit. A split's partial may
    lack rows that k rows of another split beat (the shared floor); the
    merged hits may not."""
    n = x.shape[0]
    tq, tx, tsq, tal = (as_tensor(a) for a in (q, x, sq, alive))
    scores = fs._l2_or_ip(tq, tq @ tx.T, tsq, False)
    rows = torch.arange(n)
    want = fs._plain_scan(tq, n, lambda s, e: scores[:, s:e],
                          lambda s, e: (tal[s:e] & (rows[s:e] < ms))[None, :], k, 200)
    n_splits = max(-(-min(ms, n) // per), 1)
    pv, pi = flat_scan_emulated(scores, tal, ms, k, query_tile=tile, per=per,
                                n_splits=n_splits, batch=batch, seed=seed,
                                refresh_every=refresh_every)
    assert not np.isnan(pv.numpy()).any() and (pi.numpy() >= -1).all()
    sbk = (pv.permute(1, 0, 2).contiguous(), pi.permute(1, 0, 2).contiguous())
    for got in (fs.merge_partials_plain(*sbk), merge_emulated(*sbk)):
        np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    return want


@pytest.mark.parametrize("k,tile,batch", [(1, 64, 16), (10, 128, 16), (128, 64, 16),
                                          (10, 64, 1), (128, 128, 1), (10, 128, 7)])
def test_flat_block_emulation_equals_plain(k, tile, batch):
    # B no multiple of the tile, max_scans inside a tile, tombstones
    n, b, d = 700, 70 if tile == 64 else 133, 8
    x, q, sq, alive = flat_case(31, n, b, d)
    alive[np.random.default_rng(5).random(n) < 0.3] = False
    _emulated_vs_plain(x, q, sq, alive, n - 59, k, tile, per=256, batch=batch)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flat_block_emulation_duplicate_rows_rank_by_row(seed):
    n, b, d, k = 640, 5, 8, 3               # more ties than k: the threshold ties too
    x, q, sq, alive = flat_case(32, n, b, d)
    x[130] = x[129] = x[500] = x[64]        # ties across tiles and across splits
    x[60:76] = x[300:311] = x[64]           # k or more in each of two splits: the
                                            # floor one publishes ties with the other's rows
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q[0] = x[64]
    want = _emulated_vs_plain(x, q, sq, alive, n, k, 64, per=256, batch=2, seed=seed)
    assert want[1][0].tolist() == [60, 61, 62]


def test_flat_block_emulation_all_rows_dead_or_cut():
    x, q, sq, alive = flat_case(33, 300, 3, 8)
    want = _emulated_vs_plain(x, q, sq, np.zeros(300, bool), 300, 4, 64, per=128, batch=16)
    assert (want[1] == -1).all()
    want = _emulated_vs_plain(x, q, sq, alive, 0, 4, 64, per=128, batch=16)
    assert (want[1] == -1).all()


def _merge_lists(seed, s, b, k, fill):
    """[S, B, k] sorted partials over distinct rows; list l of a query holds
    fill[l] entries, the rest (-inf, -1)."""
    rng = np.random.default_rng(seed)
    pv = np.full((s, b, k), -np.inf, np.float32)
    pi = np.full((s, b, k), -1, np.int32)
    for q in range(b):
        rows = rng.permutation(s * k)
        for l in range(s):
            m = fill[l]
            v = np.sort(rng.integers(0, 12, m).astype(np.float32))[::-1]  # many ties
            order = np.lexsort((rows[l * k:l * k + m], -v))
            pv[l, q, :m] = v[order]
            pi[l, q, :m] = rows[l * k:l * k + m][order]
    return torch.from_numpy(pv), torch.from_numpy(pi)


@pytest.mark.parametrize("name,s,k,fill", [
    ("fewer_than_k_lists", 3, 10, [10, 10, 10]),
    ("exactly_k_lists", 10, 10, [10] * 10),
    ("more_than_32_lists", 66, 10, [10] * 66),
    ("empty_lists_between", 12, 5, [5, 0, 3, 0, 0, 5, 1, 0, 5, 5, 0, 2]),
    ("all_lists_empty", 4, 5, [0] * 4),
    ("k1", 40, 1, [1] * 40),
    ("wide_k", 5, 128, [128, 7, 128, 0, 64]),
])
def test_merge_emulation_equals_plain(name, s, k, fill):
    pv, pi = _merge_lists(41, s, 6, k, fill)
    ev, ei = merge_emulated(pv, pi)
    mv, mi = fs.merge_partials_plain(pv, pi)
    np.testing.assert_array_equal(ei.numpy(), mi.numpy())
    np.testing.assert_array_equal(ev.numpy(), mv.numpy())


def test_merge_emulation_all_heads_equal():
    pv, pi = _merge_lists(42, 20, 4, 8, [8] * 20)
    pv[:, :, 0] = 50.0                       # every head ties: rows decide
    ev, ei = merge_emulated(pv, pi)
    mv, mi = fs.merge_partials_plain(pv, pi)
    np.testing.assert_array_equal(ei.numpy(), mi.numpy())
    np.testing.assert_array_equal(ev.numpy(), mv.numpy())
    assert (ev.numpy() == 50.0).all()
    for q in range(4):
        assert ei[q].tolist() == sorted(pi[:, q, 0].tolist())[:8]


@pytest.mark.parametrize("k,splits", [(1, 1), (1, 40), (10, 3), (10, 33), (10, 66), (100, 33),
                                      (128, 2), (128, 261)])
def test_flat_floor_counts_k_rows(k, splits):
    c, g = fs.flat_floor(k, splits)
    assert 1 <= c <= k and 1 <= g <= min(splits, fs.FLAT_FLOOR_WINDOW) and g * c >= k


def test_flat_block_emulation_floor_at_the_kernel_schedule():
    # many short splits, the floor taken up at tiles 0, 1, 3, 7 as the kernel does
    n, b, d, k = 128 * 40, 6, 8, 5
    x, q, sq, alive = flat_case(34, n, b, d)
    _emulated_vs_plain(x, q, sq, alive, n - 3, k, 64, per=128 * 8, batch=16,
                       refresh_every=None)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_block_emulation_one_hit_a_split(seed):
    """The k hits lie one in each of k splits, so the floor (the k-th best
    published head) is the k-th hit's own score: one rank higher and the
    last hit would be dropped."""
    tiles, splits, d = 6, 5, 8
    n = 128 * tiles * splits
    x, q, sq, alive = flat_case(35, n, 3, d)
    for s in range(splits):                  # nearer and nearer copies of query 0
        x[128 * tiles * s + 128 * s + 9] = q[0] + 0.01 * (s + 1)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive[:] = True
    want = _emulated_vs_plain(x, q, sq, alive, n, splits, 64, per=128 * tiles, batch=16,
                              seed=seed)
    assert want[1][0].tolist() == [128 * tiles * s + 128 * s + 9 for s in range(splits)]
