"""The bf16 list scan with promote and the first passes' own floors, on the
CPU.

``list_plan`` sends a bf16 slab with ``promote_fp32`` at k <= 128 and D <=
PROMOTE_MAX_D to the bulk-copy kernel (csrc/ivf_list_scan_promote.cu) and
nothing else; its shared memory and segment rule are worked by hand here,
and held to the source's by a ``cuda`` test. Its plain version is the one
``fused_ivf_topk_plain(promote_fp32=True)`` that tests/test_torch_bf16_ops.py
holds to the JAX package's kernels; here the call through the wrapper on
CPU tensors is held to the JAX package's K2 at shapes the plan sends to the
new kernel.

The first passes' floor select (csrc/floor_tail.cuh): one warp a query
takes its g-th largest published entry bit by bit from the highest bit
where the keys' max and min differ, stopping where exactly g keys lie at or
above the prefix. The flat first pass does it in its own launch: each split
block counts one arrival on its query tile, and the split that completes
the count selects the tile's floors. The list scans run it as a kernel of
their own (csrc/prefloor.cu) after their first pass. A CUDA kernel has no
CPU mode: both are emulated in numpy here (the flat one over shuffled
arrival orders) at chip_smoke's phase 3 shapes and at edge shapes, and held
bit-equal to ``floor_select_plain``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import as_tensor, assert_hits_but_kth_ties, csr, ivf_case, port_metric

from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops import fused_scan as fs

SMS = 132   # an H100's SMs
U64 = np.uint64


# ---- the host plan: which kernel takes a bf16 slab with promote ----------------


@pytest.mark.parametrize("k", [1, 10, 64, 128, 129, 1000])
@pytest.mark.parametrize("d", [8, 30, 96, 128, 129, 256, 257, 768])
@pytest.mark.parametrize("mode,promote", [(fs.LIST_BF16, True), (fs.LIST_BF16, False),
                                          (fs.LIST_IVF, True), (fs.LIST_SQ8, False)])
def test_only_bf16_promote_narrow_up_to_its_d_takes_the_new_kernel(mode, promote, d, k):
    plan = fs.list_plan(k, mode, promote, 64, 3, 1000, 1100, d, SMS)
    want = mode == fs.LIST_BF16 and promote and k <= fs.NARROW_MAX_K and d <= fs.PROMOTE_MAX_D
    assert plan.promote == want
    assert (plan.key == "ivf_scan_bf16_promote") == want
    if want:
        assert not plan.tc and plan.kw == k
        assert plan.seg == fs.promote_seg(64, 3, 1000, 1100, SMS)
        assert plan.smem == fs.list_promote_smem_bytes(k, d) <= fs.SMEM_LIMIT
        assert plan.blocks == (2 if plan.smem <= fs.SMEM_TWO_BLOCKS else 1) * SMS
    elif mode == fs.LIST_BF16 and promote:   # above the D limit, or wide: the CUDA cores
        assert plan.key == "ivf_scan_bf16" + ("_wide" if k > fs.NARROW_MAX_K else "")
        assert plan.smem == fs.list_scan_smem_bytes(k, mode)
    assert plan.key in fs.LAUNCHES


@pytest.mark.parametrize("k,d,stages,want", [
    # a stage: 8 warps x 4 steps x (32 / lanes) rows of D rounded up to 8
    # bf16 (64 rows up to D 128, 32 above), its row table (4 B a row) and
    # two mbarriers; 512 B of keys, 1,792 of per-query words; the 64
    # queries in fp32; the lists 512 k
    (10, 128, 4, 4 * (16_384 + 256 + 16) + 512 + 1_792 + 32_768 + 5_120),     # 106,816
    (1, 128, 4, 4 * (16_384 + 256 + 16) + 512 + 1_792 + 32_768 + 512),        # 102,208
    (128, 128, 6, 6 * (16_384 + 256 + 16) + 512 + 1_792 + 32_768 + 65_536),   # one an SM
    (10, 96, 6, 6 * (12_288 + 256 + 16) + 512 + 1_792 + 24_576 + 5_120),      # D 96
    (10, 30, 6, 6 * (4_096 + 256 + 16) + 512 + 1_792 + 8_192 + 5_120),        # XS 32
    (10, 256, 6, 6 * (16_384 + 128 + 16) + 512 + 1_792 + 65_536 + 5_120),     # 32 lanes
    # six stages would pass the limit by 96 bytes
    (128, 256, 5, 5 * (16_384 + 128 + 16) + 512 + 1_792 + 65_536 + 65_536),
])
def test_promote_shared_memory_formula_hand_worked(k, d, stages, want):
    assert fs.promote_stages(k, d) == stages
    assert fs.list_promote_smem_bytes(k, d) == want <= fs.SMEM_LIMIT
    # two blocks an SM where they fit, else the most stages one block holds
    two, one = ([n for n in fs.PROMOTE_STAGES if fs.list_promote_smem_bytes(k, d, n) <= lim]
                for lim in (fs.SMEM_TWO_BLOCKS, fs.SMEM_LIMIT))
    assert stages == (two or one)[0]


def test_promote_takes_no_d_above_its_limit():
    with pytest.raises(ValueError, match="takes D"):
        fs.list_promote_smem_bytes(10, fs.PROMOTE_MAX_D + 1)
    with pytest.raises(ValueError, match="takes D"):
        fs.list_promote_smem_bytes(129, 128)


@pytest.mark.parametrize("b,nprobe,kp,max_len,want", [
    # 2,048 rows halved while the grid bound, (ceil(B·P / 64) + min(kp,
    # B·P)) x ceil(max_len / seg), is under 2 x 132 = 264 items, down to 256
    (64, 3, 1000, 1100, 1024),     # (3 + 192) x 1 = 195 at 2,048; 390 at 1,024
    (1024, 3, 1000, 1100, 2048),   # (48 + 1000) x 1 = 1,048 at 2,048
    (1, 3, 1000, 1100, 256),       # (1 + 3) x 5 = 20 even at 256
    (8, 3, 1000, 1100, 256),       # (1 + 24) x 5 = 125 even at 256
    (32, 3, 1000, 1100, 512),      # (2 + 96) x 2 = 196 at 1,024; 294 at 512
    (4096, 3, 1000, 1100, 2048),   # (192 + 1000) x 1
])
def test_promote_segment_rule_hand_worked(b, nprobe, kp, max_len, want):
    assert fs.promote_seg(b, nprobe, kp, max_len, SMS) == want


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("d", [48, 96])
def test_promote_call_on_cpu_tensors_vs_pallas(metric, d):
    """The wrapper at shapes the plan sends to the promote kernel (k 10,
    nprobe 3) answers on CPU tensors with its plain version: the JAX
    package's K2 with promote_fp32 (Pallas in interpret mode on the CPU)
    returns the same hits but for k-th place ties."""
    n, b, k, kc, kp = 4096, 16, 10, 17, 128
    x, q, sq, alive, crow, probe = ivf_case(61 + d, n, b, d, kc, 3)
    assert fs.list_plan(k, fs.LIST_BF16, True, b, 3, kp, n, d, SMS).promote
    probed = np.zeros((b, kp), np.float32)
    probed[np.arange(b)[:, None], probe] = 1.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = as_tensor(np.asarray(jx.astype(jnp.float32))).bfloat16()
    jv, ji = pallas_ivf_topk(jnp.asarray(q), jx, jnp.asarray(sq), jnp.asarray(alive),
                             jnp.asarray(crow), jnp.asarray(probed), k, metric,
                             promote_fp32=True)
    tv, ti = fs.fused_ivf_topk(as_tensor(q), tx, as_tensor(sq), as_tensor(alive),
                               as_tensor(crow), *csr(crow, kp), as_tensor(probe), kp, k,
                               port_metric(metric), max_len=n, promote_fp32=True)
    assert_hits_but_kth_ties(tv, ti, jv, ji)


# ---- the first passes' floor tail, emulated ------------------------------------


def _warp_gth_key(keys: np.ndarray, g: int) -> int:
    """warp_gth_key of floor_tail.cuh on uint64 keys (0: none): the count,
    max and min of the real keys, then a bit a round from the highest bit
    where max and min differ, stopping where exactly g keys lie at or above
    the prefix (then their least). 0 where fewer than g are real."""
    real = keys[keys != 0]
    n = len(real)
    if n < g:
        return 0
    mx, mn = int(real.max()), int(real.min())
    if mx == mn:
        return mx
    top = (mx ^ mn).bit_length() - 1
    r = 0 if top == 63 else mx & ~((2 << top) - 1)
    at = n
    bit = top
    while bit >= 0 and at != g:
        cand = r | (1 << bit)
        c = int((real >= U64(cand)).sum())
        if c >= g:
            r, at = cand, c
        bit -= 1
    if at != g:
        return r
    return int(real[real >= U64(r)].min())


def _score_keys(v: np.ndarray) -> np.ndarray:
    """score_key: float scores as keys in their order (-0 as +0), 0 for -inf."""
    u = (v.astype(np.float32) + np.float32(0.0)).view(np.uint32).astype(U64)
    key = np.where(u & U64(0x80000000), ~u & U64(0xFFFFFFFF), u | U64(0x80000000))
    return np.where(v > -np.inf, key, U64(0))


def _key_score(key: int) -> np.float32:
    if not key:
        return np.float32(-np.inf)
    u = np.uint32(key)
    bits = u & np.uint32(0x7FFFFFFF) if u & np.uint32(0x80000000) else ~u
    return np.array([bits], np.uint32).view(np.float32)[0]


def _unsigned(keys: torch.Tensor) -> np.ndarray:
    return keys.numpy().view(U64)


def _list_case(seed, b, nprobe, kp, mean_len, none_share, tie_share):
    rng = np.random.default_rng(seed)
    lens = torch.from_numpy(rng.integers(0, 2 * mean_len, kp).astype(np.int32))
    lens[:2] = 0   # probed empty lists: no slots
    probe = torch.from_numpy(np.stack([rng.permutation(kp)[:nprobe]
                                       for _ in range(b)]).astype(np.int32))
    seg = 1024
    work = fs.invert_probes_plain(probe, lens, kp, int(lens.max()), seg, int(lens.sum()))
    nslots = int(work.slot_end[-1, -1])
    v = rng.integers(-500, 500, nslots).astype(np.float32) / 8   # equal scores
    v = np.where(rng.random(nslots) < tie_share, v, rng.normal(size=nslots)).astype(np.float32)
    keys = fs.key_of(torch.from_numpy(v),
                     torch.from_numpy(rng.permutation(nslots).astype(np.int32)))
    keys[torch.from_numpy(rng.random(nslots) < none_share)] = 0
    base = fs.key_of(torch.from_numpy(rng.normal(size=b).astype(np.float32) - 2.0),
                     torch.from_numpy(np.arange(nslots, nslots + b, dtype=np.int32)))
    base[torch.from_numpy(rng.random(b) < 0.7)] = 0
    return keys, base, work, lens, seg, nslots


@pytest.mark.parametrize("case,g", [
    ((1, 1024, 96, 100, 1000, 0.1, 0.5), 72),    # phase 3's list shape: 96 slots, g 72
    ((2, 256, 96, 100, 1000, 0.0, 0.0), 64),     # the hybrid's first pass, k 64 (c 1)
    ((3, 300, 24, 64, 400, 0.3, 0.9), 200),      # g above most queries' real keys
    ((4, 40, 24, 64, 3000, 0.5, 0.5), 1),        # segments: several a list
    ((5, 64, 40, 48, 2000, 0.0, 1.0), 7),        # every key on a coarse grid
    ((7, 30, 100, 128, 3000, 0.2, 0.5), 150),    # ~300 slots a query
])
def test_list_floor_select_emulated_bit_equal_to_the_plain_select(case, g):
    """The list floor select kernel, a warp a query over its slots' keys
    (cut at nslots and FLOOR_SELECT_CAP), raised to its base key."""
    keys, base, work, lens, seg, nslots = _list_case(*case)
    want = _unsigned(fs.floor_select_plain(keys, g, work.slot_end, base))
    ku, bu = _unsigned(keys), _unsigned(base)
    se = work.slot_end.numpy()[:, -1].astype(np.int64)
    got = []
    for b in range(len(se)):
        lo, hi = (min(se[b - 1], nslots) if b else 0), min(se[b], nslots)
        sel = _warp_gth_key(ku[lo:lo + min(max(hi - lo, 0), fs.FLOOR_SELECT_CAP)], g)
        got.append(max(sel, int(bu[b])))
    np.testing.assert_array_equal(np.array(got, U64), want)


def test_list_floor_select_reads_the_first_fs_cap_slots():
    """A query with more slots than FLOOR_SELECT_CAP (a 2,500-slot query):
    the kernel, as the plain select, reads its first FLOOR_SELECT_CAP."""
    rng = np.random.default_rng(6)
    cnt = np.array([2500, 3, 0, 40])
    slot_end = torch.from_numpy(np.cumsum(cnt).astype(np.int32)).view(4, 1)
    n = int(cnt.sum())
    keys = fs.key_of(torch.from_numpy(rng.normal(size=n).astype(np.float32)),
                     torch.from_numpy(rng.permutation(n).astype(np.int32)))
    base = torch.zeros(4, dtype=torch.int64)
    for g in (1, 100, 2048, 2049):
        want = _unsigned(fs.floor_select_plain(keys, g, slot_end, base))
        ku, se = _unsigned(keys), slot_end.numpy()[:, 0]
        got = [_warp_gth_key(ku[lo:lo + min(hi - lo, fs.FLOOR_SELECT_CAP)], g)
               for lo, hi in zip(np.concatenate([[0], se[:-1]]), se)]
        np.testing.assert_array_equal(np.array(got, U64), want)


def _flat_tail(pub: np.ndarray, g: int, tile: int, order) -> np.ndarray:
    """The flat first pass's tail: splits (a query tile's, in ``order``)
    publish their column of scores and count one arrival on their tile; the
    split that completes a tile selects each of its queries' floor."""
    b, s = pub.shape
    seen = np.full_like(pub, -np.inf)
    tiles = -(-b // tile)
    cnt = np.zeros(tiles, np.int64)
    out = np.full(b, np.nan, np.float32)
    for t, split in order:
        rows = slice(t * tile, min((t + 1) * tile, b))
        seen[rows, split] = pub[rows, split]
        cnt[t] += 1
        if cnt[t] == s:
            for q in range(rows.start, rows.stop):
                m = min(s, fs.FLOOR_SELECT_CAP)
                out[q] = _key_score(_warp_gth_key(_score_keys(seen[q, :m]), g))
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("b,s,g,tile,grid", [
    (1024, 66, 56, 128, False),   # phase 3's flat shape: [1024, 66], g 56
    (1024, 33, 28, 64, True),     # equal scores, counted with their multiplicity
    (64, 528, 455, 64, False),    # b64 k 10,000: one tile, 528 splits
    (70, 40, 41, 64, False),      # g above the splits: -inf
    (5, 7, 3, 64, True),
])
def test_flat_floor_tail_bit_equal_to_the_plain_select(b, s, g, tile, grid):
    rng = np.random.default_rng(b + s)
    pub = (rng.integers(-20, 20, (b, s)) / 4 if grid
           else rng.normal(size=(b, s))).astype(np.float32)
    pub[rng.random(pub.shape) < 0.15] = -np.inf   # splits that published nothing
    pub[0, :] = -0.0                              # -0 and +0: one score
    pub[0, ::2] = 0.0
    want = fs.floor_select_plain(torch.from_numpy(pub), g).numpy()
    orders = [(t, sp) for t in range(-(-b // tile)) for sp in range(s)]
    for _ in range(3):
        order = [orders[i] for i in rng.permutation(len(orders))]
        got = _flat_tail(pub, g, tile, order)
        np.testing.assert_array_equal(got.view(np.uint32) & 0x7FFFFFFF,
                                      want.view(np.uint32) & 0x7FFFFFFF)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g", [2, 5, 40])
def test_floor_tail_mutants_differ(g):
    """The emulation is sensitive: a tail taking g - 1 differs from the
    plain select on random keys; the answer has exactly g keys at or above
    it (the early stop's case for distinct keys)."""
    rng = np.random.default_rng(g)
    keys = fs.key_of(torch.from_numpy(rng.normal(size=(200,)).astype(np.float32)),
                     torch.from_numpy(rng.permutation(200).astype(np.int32)))
    qend = torch.tensor([[200]], dtype=torch.int32)
    want = int(_unsigned(fs.floor_select_plain(keys, g, qend))[0])
    ku = _unsigned(keys)
    assert _warp_gth_key(ku, g) == want
    assert _warp_gth_key(ku, g - 1) != want
    real = ku[ku != 0]
    above = np.sort(real)[::-1][:g]
    assert int(above.min()) == want and (real >= U64(want)).sum() == g
