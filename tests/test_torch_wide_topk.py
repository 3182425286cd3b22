"""The wide mode of the scan kernels (k > 128, csrc/topk_wide.cuh) on the CPU.

A CUDA kernel has no CPU mode, so the wide list's logic is emulated step by
step in ``_torch_parity.WideListEmulated`` (buffer fill behind the threshold,
bitonic sort, the in-place merge by rank, the threshold a full list gives,
the pads) and held against the plain top-k; mutants of it must fail. The
shape formulas the wrappers size each launch by are checked here too.
"""

import numpy as np
import pytest
import torch
from _torch_parity import (
    WideListEmulated,
    as_tensor,
    assert_same_hits,
    csr,
    flat_scan_emulated,
    fused_ivf_topk_emulated,
    list_case,
    wide_stream_emulated,
)

from pyrope_tpu_torch.ops import fused_scan as fs


def _plain_top(vals, kw, floor=None):
    """Stable top-kw of (vals, row) in (score desc, row asc) order, rows
    that beat ``floor`` only, padded with (-inf, -1)."""
    fv, fi = floor or (float("-inf"), -1)
    ent = [(float(v), r) for r, v in enumerate(vals)
           if v > fv or (v == fv and r < fi)]
    ent = sorted(ent, key=lambda e: (-e[0], e[1]))[:kw]
    ent += [(float("-inf"), -1)] * (kw - len(ent))
    return np.array([v for v, _ in ent], np.float32), np.array([r for _, r in ent])


def _scores(seed, n, ties, dead=0.1):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(0, ties, n).astype(np.float32) if ties
            else rng.random(n, np.float32))
    vals[rng.random(n) < dead] = -np.inf
    return vals


@pytest.mark.parametrize("kw,cap,n", [(129, 128, 3000), (200, 256, 5000), (512, 128, 2600),
                                      (1000, 256, 900), (300, 32, 4000), (2048, 128, 2100)])
@pytest.mark.parametrize("ties", [0, 7, 300])
def test_wide_list_equals_the_plain_top_k(kw, cap, n, ties):
    """Buffer fill, flushes, threshold, ties (integer scores tie often) and
    the pads past the fill (n below kw, and dead rows)."""
    vals = _scores(kw + n + ties, n, ties)
    got_v, got_i, lst = wide_stream_emulated(vals, kw, cap=cap)
    want_v, want_i = _plain_top(vals, kw)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)
    assert lst.flushes >= 1 and not lst.buf


def test_wide_list_keeps_rows_over_a_floor_only():
    vals = _scores(5, 4000, 50)
    floor = (float(np.sort(vals)[-900]), 1234)
    got_v, got_i, _ = wide_stream_emulated(vals, 600, floor=floor)
    want_v, want_i = _plain_top(vals, 600, floor)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("mutant", ["row_desc", "drop_last", "forward"])
def test_wide_list_mutants_fail(mutant):
    """The emulation is only worth its pass if a broken step shows: ties
    broken by row desc, the last buffer dropped, or the list moved front to
    back (entries overwritten before they are read)."""
    vals = _scores(9, 3000, 20)
    want_v, want_i = _plain_top(vals, 700)
    got_v, got_i, _ = wide_stream_emulated(vals, 700, mutant=mutant)
    assert not (np.array_equal(got_v, want_v) and np.array_equal(got_i, want_i))


def test_wide_buffer_flushes_before_it_overflows():
    lst = WideListEmulated(300, cap=64)
    for r0 in range(0, 2000, 32):
        lst.offer_batch([(float(-r), r) for r in range(r0, r0 + 32)])
        assert len(lst.buf) <= 64
    assert lst.fill == 300 and lst.kth == (-299.0, 299)


@pytest.mark.parametrize("k", [129, 200, 500])
def test_flat_scan_wide_blocks_merge_to_the_plain_top_k(k):
    """The flat scan's blocks with wide lists (FLAT_WIDE_CAP-entry buffers,
    16 candidates an offer), the floor shared across splits, in a seeded
    random block order; the merged result is the plain top-k."""
    rng = np.random.default_rng(k)
    b, n = 5, 9000
    scores = torch.from_numpy(rng.integers(0, 60, (b, n)).astype(np.float32))
    ok = torch.from_numpy(rng.random(n) > 0.05)
    per, n_splits = 1024, 9
    pv, pi = flat_scan_emulated(scores, ok, n, k, query_tile=fs.FLAT_WIDE_TILE, per=per,
                                n_splits=n_splits, seed=k,
                                make_list=lambda kw: WideListEmulated(kw, fs.FLAT_WIDE_CAP))
    mv, mi = fs.merge_partials_plain(pv.permute(1, 0, 2), pi.permute(1, 0, 2))
    sc = torch.where(ok[None, :], scores, float("-inf"))
    wv, pos = torch.sort(sc, dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(mv.numpy(), wv[:, :k].numpy())
    np.testing.assert_array_equal(mi.numpy(), pos[:, :k].int().numpy())


def _flat_wide_run(scores, ok, k, per, n_splits, **kw):
    """The flat scan's wide blocks as the bf16 scan runs them (32
    candidates an offer, buffers of TC_FLUSH_MIN flushed at the floor's
    tiles), merged; and the plain top-k."""
    pv, pi = flat_scan_emulated(scores, ok, scores.shape[1], k, query_tile=fs.FLAT_WIDE_TILE,
                                per=per, n_splits=n_splits, batch=32,
                                make_list=lambda kw_: WideListEmulated(kw_, fs.FLAT_WIDE_CAP),
                                **kw)
    mv, mi = fs.merge_partials_plain(pv.permute(1, 0, 2), pi.permute(1, 0, 2))
    sc = torch.where(ok[None, :], scores, float("-inf"))
    wv, pos = torch.sort(sc, dim=1, descending=True, stable=True)
    return (mv.numpy(), mi.numpy()), (wv[:, :k].numpy(), pos[:, :k].int().numpy())


@pytest.mark.parametrize("k", [129, 200, 500])
def test_flat_tc_wide_flushes_at_the_floor_tiles(k):
    """Flushing the buffers at the floor's tiles so each split publishes a
    fresh c-th entry keeps the plain top-k, and offers fewer candidates."""
    rng = np.random.default_rng(k)
    scores = torch.from_numpy(rng.integers(0, 60, (4, 9000)).astype(np.float32))
    ok = torch.from_numpy(rng.random(9000) > 0.05)
    offered = []
    for flush_min in (fs.TC_FLUSH_MIN, None):
        stats = {}
        got, want = _flat_wide_run(scores, ok, k, 1024, 9, seed=k, flush_min=flush_min,
                                   stats=stats)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        offered.append(stats["offered"])
    assert offered[0] < offered[1]


def test_flat_tc_wide_floor_one_short_drops_a_hit():
    """The mutant that publishes each split's (c-1)-th entry: every split
    holds 16 of the 144 hits, its 16th late in the split, and a floor of
    9 splits' 15th entries drops it."""
    per, n_splits, k = 1024, 9, 144
    assert fs.flat_floor(k, n_splits, k) == (16, 9)
    rng = np.random.default_rng(3)
    sc = rng.random((2, per * n_splits)) * 100
    for s in range(n_splits):
        sc[:, s * per:s * per + 15] = 1001 + rng.random((2, 15)) * 10
        sc[:, s * per + 1000] = 1000.5 + 0.01 * s
    scores = torch.from_numpy(sc.astype(np.float32))
    ok = torch.ones(scores.shape[1], dtype=torch.bool)
    got, want = _flat_wide_run(scores, ok, k, per, n_splits, flush_min=fs.TC_FLUSH_MIN)
    np.testing.assert_array_equal(got[1], want[1])
    got, want = _flat_wide_run(scores, ok, k, per, n_splits, flush_min=fs.TC_FLUSH_MIN,
                               pub_short=1)
    assert not np.array_equal(got[1], want[1])


@pytest.mark.parametrize("k,seg", [(200, 256), (1000, 256), (300, 2048)])
def test_list_scan_wide_slots_merge_to_the_plain_scan(k, seg):
    """Slots of min(k, seg, max_len) entries, each filled by a wide list,
    merged into k: the plain scan's hits."""
    x, q, sq, alive, crow, probe = (as_tensor(a) for a in
                                    list_case(11, 3000, 20, 8, 12, 4, big=600, dead=0.1))
    offs, lens = csr(crow, 12)
    got = fused_ivf_topk_emulated(q, x, sq, alive, offs, lens, probe, 12, k, seg=seg,
                                  wide_cap=fs.LIST_WIDE_CAP)
    want = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, 12, k)
    assert_same_hits(*got, *want)


# ---- the shape formulas -------------------------------------------------------


def test_k_range_is_the_kernels_limit():
    """The kernels take any k >= 1 (they once stopped at 10,000)."""
    assert all(fs.k_refusal(k) is None for k in (*range(1, 10_002), 20_000, 10**6))
    for k in (0, -1):
        assert "k must be at least 1" in fs.k_refusal(k)


def test_flat_tile_fits_every_k():
    for k in (*range(1, 10_001), 20_000):
        for b in (1, 64, 65, 1024):
            for elem in (4, 2):
                tile, smem = fs.flat_tile(128, k, b, elem)
                assert smem == fs.flat_scan_smem_bytes(k, tile, elem, 128) <= fs.SMEM_LIMIT
                assert tile == fs.FLAT_WIDE_TILE if k > fs.NARROW_MAX_K else tile in (64, 128)
    assert fs.flat_tile(128, 129, 1024) == (64, 182_784)
    # the bf16 scan's wide block: a 4-stage ring of 16 KB tiles, q resident
    assert fs.flat_tile(128, 10_000, 1024, 2) == (64, 219_720)


@pytest.mark.parametrize("mode", [fs.LIST_IVF, fs.LIST_SQ8, fs.LIST_BF16])
def test_list_scan_smem_is_constant_in_d_and_fits(mode):
    """q is streamed by depth, so the formula takes no D; every k fits a
    block, and k 10 keeps two blocks an SM."""
    for k in (*range(1, 10_001, 37), 20_000):
        assert fs.list_scan_smem_bytes(k, mode) <= fs.SMEM_LIMIT
        assert fs.list_scan_refusal(k, mode) is None
    wide = {fs.list_scan_smem_bytes(k, mode) for k in (129, 512, 10_000, 20_000)}
    assert len(wide) == 1
    assert fs.list_scan_smem_bytes(10, mode) <= fs.SMEM_TWO_BLOCKS
    assert fs.list_scan_refusal(0, mode) is not None


@pytest.mark.parametrize("b,nprobe,kp,max_len,n", [(1024, 96, 100, 1100, 100_000),
                                                   (1024, 3, 1000, 50_000, 1_000_000),
                                                   (1, 5, 16, 300, 4000)])
@pytest.mark.parametrize("k", [10, 200, 1000, 10_000])
def test_list_partials_are_sized_by_the_segment(b, nprobe, kp, max_len, n, k):
    """A slot holds min(k, seg, max_len) entries above k 128 (k below); the
    partials stay within B x (nprobe + n // seg) slots of that width."""
    seg = fs.list_seg(b, nprobe, kp, max_len, 132)
    segs = fs.list_grid(b, nprobe, kp, max_len, seg)[1]
    width = fs.list_slot_width(k, seg, max_len)
    assert width == (k if k <= fs.NARROW_MAX_K else min(k, seg, max_len))
    slots = fs.list_slots(b, nprobe, segs, seg, n)
    assert slots * width <= b * (nprobe + n // seg) * min(k, seg, max(max_len, k))
    if segs == 1:
        assert slots * width <= b * nprobe * min(k, seg)


@pytest.mark.parametrize("k,width,s", [(300, 100, 2), (300, 300, 3), (50, 20, 1)])
def test_plain_merge_takes_lists_narrower_than_k(k, width, s):
    rng = np.random.default_rng(k + width)
    b = 6
    v = -np.sort(rng.integers(0, 30, (s, b, width)), axis=2).astype(np.float32)
    rows = rng.permutation(s * b * width).reshape(s, b, width).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)
    pv = torch.from_numpy(np.take_along_axis(v, order, 2))
    pi = torch.from_numpy(np.take_along_axis(rows, order, 2))
    mv, mi = fs.merge_partials(pv, pi, k=k)
    assert mv.shape == (b, k)
    allv = pv.permute(1, 0, 2).reshape(b, -1)
    alli = pi.permute(1, 0, 2).reshape(b, -1)
    for q in range(b):
        ent = sorted(zip(allv[q].tolist(), alli[q].tolist()), key=lambda e: (-e[0], e[1]))
        ent = (ent + [(float("-inf"), -1)] * k)[:k]
        assert mv[q].tolist() == [e[0] for e in ent] and mi[q].tolist() == [e[1] for e in ent]



@pytest.mark.parametrize("b", [1, 64, 256, 1024, 9000])
@pytest.mark.parametrize("n_rows", [300, 5_000, 1_000_000])
def test_wide_flat_grid_is_one_wave(b, n_rows):
    """The wide flat scan fits one block an SM: its grid holds at most one
    block an SM where the batch allows, in whole row tiles covering every
    row."""
    per, n_splits = fs._splits(b, n_rows, 132, fs.FLAT_WIDE_TILE, 1000)
    q_tiles = -(-b // fs.FLAT_WIDE_TILE)
    assert per % fs.ROW_TILE == 0 and per * n_splits >= n_rows > per * (n_splits - 1)
    assert q_tiles * n_splits <= max(132, q_tiles)
