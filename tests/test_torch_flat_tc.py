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
"""

import collections

import numpy as np
import pytest

from pyrope_tpu_torch.ops import fused_scan as fs

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
