"""The bf16 flat scan on the tensor cores (csrc/flat_scan_tc.cu): what of
its layout the CPU can check.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py).
Here: a mirror of the wgmma m64n128 accumulator fragment, which the
epilogue reads as (query, row) pairs, is a bijection onto a warpgroup's 64
queries x 128 rows and puts each query in one quad of one warp; the vote
on a lane's best score of each of its queries offers every row that
reaches a query's threshold (and a fragment map one bit off does not); the
shared-memory formula and the tile, ring and grid choices of the bf16
instantiations.

The wide mode's first pass (k > 128): the bf16 plan's shapes, worked by
hand, and where it returns None; the small-buffer wide block;
``flat_prefloor_plain`` on bf16 scores (each split's c-th best tile
maximum); both passes emulated in the bf16 wide layout (32 candidates an
offer, buffers of FLAT_WIDE_SMALL_CAP flushed at the floor's tiles,
_torch_parity.flat_scan_emulated) equal to the plain top-k; and a hybrid
FlatIndex at k 40 (R 256: the wide mode) against the JAX package's, Pallas
in interpret mode.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import (
    WideListEmulated,
    as_tensor,
    assert_hits_but_kth_ties,
    flat_case,
    flat_scan_emulated,
    hits_to_arrays,
)

import pyrope_tpu as jpt
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.types import Metric

WG_QUERIES, TILE_ROWS, WARPS, LANES, REGS = 64, 128, 4, 32, 64


def frag(w, lane, r):
    """(query, row) of register r of lane ``lane`` of warp w in the
    m64n128k16 f32 accumulator: register 4 j + 2 h + e holds query 16 w +
    lane / 4 + 8 h at row 8 j + 2 (lane % 4) + e (the kernel's epilogue)."""
    return (16 * w + lane // 4 + 8 * ((r >> 1) & 1), 8 * (r >> 2) + 2 * (lane % 4) + (r & 1))


def frag_swapped(w, lane, r):
    """A mutant: the query and row-pair bits of the register index swapped."""
    return (16 * w + lane // 4 + 8 * (r & 1), 8 * (r >> 2) + 2 * (lane % 4) + ((r >> 1) & 1))


def test_fragment_map_is_a_bijection_and_a_quad_owns_each_query():
    owner = {}
    for w in range(WARPS):
        for lane in range(LANES):
            for r in range(REGS):
                qr = frag(w, lane, r)
                assert qr not in owner
                owner[qr] = (w, lane // 4)
    assert len(owner) == WG_QUERIES * TILE_ROWS
    assert {q for q, _ in owner} == set(range(WG_QUERIES))
    assert {row for _, row in owner} == set(range(TILE_ROWS))
    quads = collections.defaultdict(set)
    for (q, _), wq in owner.items():
        quads[q].add(wq)
    assert all(len(s) == 1 for s in quads.values())     # one warp's quad a query
    for (q, _), (w, g) in owner.items():                 # the kernel's wq0 + g + 8 h
        assert q - 16 * w in (g, g + 8)
    # a lane holds 32 rows of each of its two queries, a quad all 128
    for w in range(WARPS):
        for lane in range(LANES):
            per_q = collections.Counter(frag(w, lane, r)[0] for r in range(REGS))
            assert sorted(per_q.values()) == [32, 32]


def offered(scores, thr, fmap):
    """The (query, row) pairs the epilogue offers to the lists: per lane and
    query half h, the best of its registers' scores of the query it takes
    them for; a quad whose lane reaches that query's threshold offers all
    128 rows of it."""
    out = set()
    for w in range(WARPS):
        for h in range(2):
            passed = set()
            for lane in range(LANES):
                q = 16 * w + lane // 4 + 8 * h
                regs = [r for r in range(REGS) if (r >> 1) & 1 == h]
                best = max(scores[fmap(w, lane, r)] for r in regs)
                if best >= thr[q]:
                    passed.add(q)
            out |= {(q, row) for q in passed for row in range(TILE_ROWS)}
    return out


@pytest.mark.parametrize("seed", range(4))
def test_the_vote_offers_every_row_at_or_above_its_threshold(seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((WG_QUERIES, TILE_ROWS)).astype(np.float32)
    # thresholds about at each query's 3rd best score: few rows reach them
    thr = np.sort(scores, axis=1)[:, -3] + rng.normal(0, 0.2, WG_QUERIES).astype(np.float32)
    thr[::5] = np.inf                                     # padding queries
    need = {(q, row) for q in range(WG_QUERIES) for row in range(TILE_ROWS)
            if scores[q, row] >= thr[q]}
    assert need and need <= offered(scores, thr, frag)
    assert not need <= offered(scores, thr, frag_swapped)   # the mutant misses hits


@pytest.mark.parametrize("d", [8, 24, 72, 128, 136, 256, 384, 768])
@pytest.mark.parametrize("k", [1, 10, 32, 64, 128, 129, 512, 10_000])
@pytest.mark.parametrize("b", [1, 63, 64, 65, 1000])
def test_bf16_tiles_stages_and_grid(d, k, b):
    tile, smem = fs.flat_tile(d, k, b, 2)
    stages = fs.tc_stages(k, tile, d)
    assert smem == fs.flat_scan_smem_bytes(k, tile, 2, d) <= fs.SMEM_LIMIT
    assert stages in fs.TC_STAGES and smem == fs._tc_smem_bytes(k, tile, d, stages)
    if k > fs.NARROW_MAX_K or b <= fs.QUERY_TILE:
        assert tile == fs.QUERY_TILE
    per_sm = fs.flat_blocks_per_sm(tile, smem, k, 2)
    assert per_sm == (2 if smem <= fs.SMEM_TWO_BLOCKS else 1) or tile == 128
    if tile == 128:
        assert per_sm == 1      # three warpgroups at 168 registers: one block an SM
    # the ring shrinks only where the block would not fit its target with more
    target = (fs.SMEM_TWO_BLOCKS if tile == fs.QUERY_TILE and k <= fs.NARROW_MAX_K
              else fs.SMEM_LIMIT)
    for more in (n for n in fs.TC_STAGES if n > stages):
        assert fs._tc_smem_bytes(k, tile, d, more) > target
    # one wave: every block of the grid runs at once
    per, n_splits = fs._splits(b, 1_000_000, 132, tile, k, per_sm)
    assert -(-b // tile) * n_splits <= max(per_sm * 132, -(-b // tile))
    assert per % fs.ROW_TILE == 0 and (n_splits - 1) * per < 1_000_000 <= n_splits * per


def test_bf16_main_shapes():
    """The shapes the main paths run: 1M x 128 at b1024 k10 (two consumer
    warpgroups, q resident, 4 stages), b64 k10 (two blocks an SM), b256
    k512 (the wide block) and D 768 (q streamed in the ring)."""
    assert fs.flat_tile(128, 10, 1024, 2) == (128, 117_832)
    assert fs.flat_tile(128, 10, 64, 2) == (64, 93_256)
    assert fs.flat_blocks_per_sm(64, 93_256, 10, 2) == 2
    assert fs.flat_tile(128, 512, 256, 2) == (64, 219_720)
    assert fs.tc_stages(512, 64, 128) == 4
    tile, smem = fs.flat_tile(768, 10, 1024, 2)
    assert (tile, fs.tc_stages(10, tile, 768)) == (128, 4)
    assert smem == 4 * (128 * 128 + 128 * 128 + 512) + 8 * 9 + 16 * 128 + 512 * 8 + 8 * 128 * 10 + 1024
    assert fs._splits(1024, 1_000_000, 132, 128, 10, 1) == (62_592, 16)
    with pytest.raises(ValueError, match="depends on D"):
        fs.flat_scan_smem_bytes(10, 128, 2)


# ---- the wide mode's first pass ---------------------------------------------------


@pytest.mark.parametrize("k,b,n,want", [
    # b256 k512 (the Flat hybrid's R 512 at k 100): two 128-query tiles, one
    # block an SM, one wave: 66 splits of 119 tiles; c = ceil(512 / 57) = 9,
    # g 57; f = min(1, sqrt(5120 * 512 / 1M)) = 1: the whole split
    (512, 256, 1_000_000, fs.FlatPrefloor(128, 15_232, 66, 15_232, 9, 57, 128)),
    # b1024 k512: eight tiles, 16 splits of 489 tiles; c = ceil(512 / 14) =
    # 37, g 14
    (512, 1024, 1_000_000, fs.FlatPrefloor(128, 62_592, 16, 62_592, 37, 14, 128)),
    # b64 k1000: one 64-query tile, two blocks an SM: 261 splits of 30
    # tiles; c = ceil(1000 / 228) = 5, g 200
    (1000, 64, 1_000_000, fs.FlatPrefloor(64, 3840, 261, 3840, 5, 200, 128)),
    # b256 k200 over 20M rows: 66 splits of 2,368 tiles; c = ceil(200 / 57)
    # = 4, g 50; f = sqrt(5120 * 200 / 20M) = 0.226: 536 tiles a split
    (200, 256, 20_000_000, fs.FlatPrefloor(128, 303_104, 66, 536 * 128, 4, 50, 128)),
    # k 129 at b1 over 20k rows: 157 one-tile splits, the whole tile
    (129, 1, 20_000, fs.FlatPrefloor(64, 128, 157, 128, 1, 129, 128)),
    # b1 k 700 over 30k rows: 235 one-tile splits, c = ceil(700 / 205) = 4:
    # a split of one tile has one tile maximum, fewer than c
    (700, 1, 30_000, None),
    (128, 1024, 1_000_000, None),      # narrow
    (20_000, 1024, 1_000_000, None),   # c = ceil(20000 / 14) > 128
    (300, 8, 256, None),               # two splits: c = 300
])
def test_bf16_prefloor_plan_hand_worked(k, b, n, want):
    got = fs.flat_prefloor_plan(k, b, 128, n, 132, elem=2)
    assert got == want
    if got is not None:
        assert got.g * got.c >= k and got.g <= got.splits and got.rows <= got.per
        assert got.tile == fs.flat_tile(128, got.c, b, 2)[0]
        assert got.rows % fs.ROW_TILE == 0 and got.per % fs.ROW_TILE == 0
        assert got.unit == fs.ROW_TILE and got.rows >= got.c * fs.ROW_TILE


@pytest.mark.parametrize("d", [8, 24, 72, 128, 136, 256, 384, 768])
def test_bf16_wide_small_buffers(d):
    """Behind a first pass's floor the wide block takes FLAT_WIDE_SMALL_CAP
    buffers (64 entries a query, not 256): 98,304 bytes less at 64 queries,
    the ring's four stages at every D, one block an SM as without the
    floor; above 64 queries the 128-query block, which now fits."""
    small = fs.FLAT_WIDE_SMALL_CAP
    smem = fs.flat_scan_smem_bytes(512, 64, 2, d, small)
    stages = fs.tc_stages(512, 64, d, small)
    assert smem == fs._tc_smem_bytes(512, 64, d, stages, small) <= fs.SMEM_LIMIT
    assert stages == 4 and fs.flat_blocks_per_sm(64, smem, 512, 2) == 1
    # above 64 queries the 128-query block, two consumer warpgroups
    assert fs.flat_wide_tile(65, 2, small) == 128 and fs.flat_wide_tile(64, 2, small) == 64
    assert fs.flat_wide_tile(256, 2) == fs.flat_wide_tile(256, 4, small) == 64
    wide128 = fs.flat_scan_smem_bytes(512, 128, 2, d, small)
    assert wide128 <= fs.SMEM_LIMIT and fs.flat_blocks_per_sm(128, wide128, 512, 2) == 1
    big = fs.flat_scan_smem_bytes(512, 64, 2, d)
    assert big - smem == 64 * 8 * (fs.FLAT_WIDE_CAP - small) or (
        fs.tc_stages(512, 64, d) < stages and big > smem)   # the big ring shrank
    if d == 128:   # 4 x (16 KB + 512) + 16 KB (32 KB) of q + the buffers
        assert (smem, wide128) == (121_416, 174_152)
        assert fs.tc_stages(512, 128, d, small) == 4


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_bf16_prefloor_plain_takes_bf16_scores(metric):
    """flat_prefloor_plain over a bf16 slab: the split floors of bf16(q)·x
    summed in fp32 (fs._tile_scores), the scores the kernel's tensor cores
    compute, each split's c-th best tile maximum; within the fp32 tolerance
    of the same floors in float64 off the rounded operands, at or under
    the floors of the c-th best rows (unit 1), and at least g·c >= k of a
    query's rows score at or above its floor."""
    n, b, d, k, ms = 60_000, 5, 24, 300, 58_000
    x, q, sq, alive = flat_case(31, n, b, d)
    t = [as_tensor(a) for a in (q, x, sq, alive)]
    x16 = t[1].bfloat16()
    plan = fs.flat_prefloor_plan(k, b, d, ms, 16, elem=2)
    assert plan is not None
    ip = metric == Metric.INNER_PRODUCT
    scores = fs._tile_scores(t[0], x16, t[2], ip)(0, ms)
    q64 = t[0].bfloat16().double()
    dots = q64 @ x16.double().T[:, :ms]
    exact = dots if ip else -torch.clamp((t[0].double() ** 2).sum(1, keepdim=True)
                                         - 2 * dots + t[2][None, :ms].double(), min=0)
    # the plan's sample (whole splits here) and c tiles of each split
    for p in (plan, dataclasses.replace(plan, rows=plan.c * fs.ROW_TILE)):
        got = fs.flat_prefloor_plain(t[0], x16, t[2], t[3], ms, p, metric.value)
        assert torch.equal(got, fs.split_floor_plain(scores, t[3][:ms], p))
        np.testing.assert_allclose(got.numpy(), fs.split_floor_plain(
            exact.float(), t[3][:ms], p).numpy(), rtol=1e-5, atol=1e-4)
        assert ((scores >= got[:, None]) & t[3][None, :ms]).sum(1).min() >= k
        by_row = fs.split_floor_plain(scores, t[3][:ms], dataclasses.replace(p, unit=1))
        assert (got <= by_row).all() and (got < by_row).any()


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("k,b,dup", [(129, 3, False), (512, 5, True), (300, 2, False)])
def test_bf16_two_pass_emulated_equals_plain(k, b, dup, metric):
    """Both passes in the bf16 wide layout on bf16 scores (98,304 rows, 5%
    dead, the tail cut by max_scans): the first pass's floors (the plain
    rule, each split's c-th best tile maximum, as the kernel's own launch
    takes them), then the wide blocks (one an SM) from there, 32 candidates
    an offer, buffers of FLAT_WIDE_SMALL_CAP flushed at the floor's tiles:
    merged, the plain top-k of the same scores bit for bit, and
    fused_flat_topk_plain's hits on the bf16 slab; fewer candidates offered
    than without the floor."""
    n, d, ms = 98_304, 16, 96_000
    x, q, sq, alive = flat_case(k, n, b, d)
    alive &= np.random.default_rng(k).random(n) > 0.05
    if dup:
        x[50_000:50_400] = x[:400]
        sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    t = [as_tensor(a) for a in (q, x, sq, alive)]
    x16 = t[1].bfloat16()
    scores = fs._tile_scores(t[0], x16, t[2], metric == Metric.INNER_PRODUCT)(0, n)
    ok = t[3] & (torch.arange(n) < ms)
    plan = fs.flat_prefloor_plan(k, b, d, ms, 16, elem=2)
    assert plan is not None
    per, n_splits = fs._splits(b, ms, 16, fs.FLAT_WIDE_TILE, k, 1)
    offered = []
    for floor0 in (fs.split_floor_plain(scores, ok, plan), torch.full((b,), float("-inf"))):
        stats = {}
        pv, pi = flat_scan_emulated(
            scores, ok, ms, k, query_tile=fs.FLAT_WIDE_TILE, per=per, n_splits=n_splits,
            batch=32, seed=k, flush_min=fs.TC_FLUSH_MIN, floor0=floor0, stats=stats,
            make_list=lambda kw: WideListEmulated(kw, fs.FLAT_WIDE_SMALL_CAP))
        mv, mi = fs.merge_partials_plain(pv.permute(1, 0, 2), pi.permute(1, 0, 2))
        wv, pos = torch.sort(torch.where(ok[None, :], scores, float("-inf")), dim=1,
                             descending=True, stable=True)
        np.testing.assert_array_equal(mv.numpy(), wv[:, :k].numpy())
        np.testing.assert_array_equal(
            mi.numpy(), torch.where(torch.isfinite(wv[:, :k]), pos[:, :k], -1).int().numpy())
        offered.append(stats["offered"])
    pv, pi = fs.fused_flat_topk_plain(t[0], x16, t[2], t[3], ms, k, metric.value)
    np.testing.assert_array_equal(np.sort(mi.numpy(), 1), np.sort(pi.numpy(), 1))
    assert offered[0] < offered[1]


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_flat_hybrid_k40_wide_matches_jax(metric):
    """A hybrid FlatIndex of 4,096 rows at k 40: R = 256 (not clamped to the
    rows), the bf16 scan's wide mode, then the fp32 rerank; the same writes
    and queries as the JAX package's hybrid FlatIndex (Pallas in interpret
    mode): the same route, hits equal but for k-th place fp32 ties."""
    rng = np.random.default_rng(40)
    base = rng.normal(size=(4096, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    jix = jpt.FlatIndex(16, metric, selection="hybrid")
    tix = FlatIndex(16, metric, device="cpu", selection="hybrid")
    for ix in (jix, tix):
        ix.add_batch([str(i) for i in range(len(base))], base)
    assert tix._shortlist(40) == 256 > fs.NARROW_MAX_K
    assert tix.describe_scan(8, top_k=40) == jix.describe_scan(8) == "flat-pallas-hybrid"
    assert_hits_but_kth_ties(*hits_to_arrays(tix.search_batch(q, 40)),
                             *hits_to_arrays(jix.search_batch(q, 40)))
