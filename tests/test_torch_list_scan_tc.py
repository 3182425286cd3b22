"""The bf16 list scan on the tensor cores (csrc/ivf_list_scan_tc.cu), on the
CPU: its host plan, its formulas and rules from shapes, the wrapper's
caches, the design's floor rule in the CPU emulation, and the plain version
against the JAX package's K2 bf16 kernel.

A bf16 slab scanned without ``promote_fp32`` takes the tensor-core kernel
(``fs.list_plan``: ``ivf_scan_bf16_tc[_wide]``); with promote, and over fp32
or SQ8 slabs, the CUDA-core list scan. The kernel itself runs only on the
card (tests/test_torch_kernels_cuda.py, marked ``cuda``); here a stand-in
library records the C entry each call reaches and the arguments it gets.

The plain version is held against ``pallas_ivf_topk`` in interpret mode on
the same numpy inputs: both score bf16(q)·x (exact products) with ‖q‖² of
the fp32 q, each summing the products in fp32 in an order of its own, so
scores agree within rtol 1e-5 / atol 1e-4 and a hit may differ only as a
k-th place tie within that rounding (``assert_hits_but_kth_ties``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    as_tensor,
    assert_hits_but_kth_ties,
    csr,
    list_case,
    list_partials_emulated,
    port_metric,
)

from pyrope_tpu.ops.pallas_scan import pallas_ivf_topk
from pyrope_tpu.types import Metric
from pyrope_tpu_torch.kernels import build as kbuild
from pyrope_tpu_torch.ops import fused_scan as fs

KP = 128   # cluster-table width the JAX kernels take unwindowed
SMS = 132  # an H100's SMs


# ---- the host plan: which kernel, from shapes alone ----------------------------


@pytest.mark.parametrize("mode,promote,k,tc,key", [
    (fs.LIST_BF16, False, 64, True, "ivf_scan_bf16_tc"),
    (fs.LIST_BF16, False, 1, True, "ivf_scan_bf16_tc"),
    (fs.LIST_BF16, False, 128, True, "ivf_scan_bf16_tc"),
    (fs.LIST_BF16, False, 129, False, "ivf_scan_bf16_wide"),   # wide: the CUDA cores
    (fs.LIST_BF16, True, 64, False, "ivf_scan_bf16_promote"),   # the bulk-copy kernel
    (fs.LIST_BF16, True, 200, False, "ivf_scan_bf16_wide"),
    (fs.LIST_IVF, False, 10, False, "ivf_scan"),
    (fs.LIST_IVF, True, 10, False, "ivf_scan"),     # promote is the identity on fp32
    (fs.LIST_SQ8, False, 1000, False, "sq8_scan_wide"),
])
def test_list_plan_routes_bf16_without_promote_to_the_tensor_cores(mode, promote, k, tc,
                                                                   key):
    plan = fs.list_plan(k, mode, promote, 256, 96, 100, 1100, 128, SMS)
    assert (plan.tc, plan.key, plan.mode) == (tc, key, mode)
    assert plan.key in fs.LAUNCHES
    if tc:   # list_seg's segment, no shorter than LIST_TC_SEG_MIN; its own shared memory
        assert plan.seg == max(fs.list_seg(256, 96, 100, 1100, SMS), fs.LIST_TC_SEG_MIN)
        assert plan.smem == fs.list_tc_smem_bytes(k, 128)
    elif plan.promote:   # its own segment rule and shared memory
        assert plan.seg == fs.promote_seg(256, 96, 100, 1100, SMS)
        assert plan.smem == fs.list_promote_smem_bytes(k, 128)
    else:
        assert plan.seg == fs.list_seg(256, 96, 100, 1100, SMS)
        assert plan.smem == fs.list_scan_smem_bytes(k, mode)
    assert plan.kw == fs.list_slot_width(k, plan.seg, 1100)


def test_list_plan_refuses_k_below_one():
    for mode, promote in ((fs.LIST_BF16, False), (fs.LIST_BF16, True), (fs.LIST_IVF, False)):
        with pytest.raises(ValueError, match="at least 1"):
            fs.list_plan(0, mode, promote, 8, 3, 100, 50, 32, SMS)


# ---- shared memory and the segment rule, from shapes ------------------------------


@pytest.mark.parametrize("k,d,stages,want", [
    # ring: stages x (16,384 rows [+ 8,192 q streamed] + 512 row table + 16
    # mbarriers); resident A ceil(d / 64) x 8,192; 1,024 keys + 1,792
    # per-query words + 2,048 staged scores; lists 512 k;
    # 1,024 of alignment
    (10, 128, 4, 4 * 16_912 + 16_384 + 4_864 + 5_120 + 1_024),        # 95,040
    (64, 128, 3, 3 * 16_912 + 16_384 + 4_864 + 32_768 + 1_024),       # 105,776: two an SM
    (128, 128, 4, 4 * 16_912 + 16_384 + 4_864 + 65_536 + 1_024),      # one an SM
    (64, 30, 4, 4 * 16_912 + 8_192 + 4_864 + 32_768 + 1_024),         # one chunk
    (10, 768, 4, 4 * 25_104 + 4_864 + 5_120 + 1_024),                 # q streamed
    (128, 768, 4, 4 * 25_104 + 4_864 + 65_536 + 1_024),               # one an SM
])
def test_tc_shared_memory_formula_hand_worked(k, d, stages, want):
    assert fs.list_tc_stages(k, d) == stages
    assert fs.list_tc_smem_bytes(k, d) == want <= fs.SMEM_LIMIT


@pytest.mark.parametrize("b,nprobe,kp,max_len,k,d,want", [
    # list_seg's rule: 2,048 rows halved while the grid bound, (ceil(B·P /
    # 64) + min(kp, B·P)) x ceil(max_len / seg), is under 4 x 132 = 528
    # blocks; then no shorter than 512 rows. 256 x 96 pairs over 100 lists
    # of ~1,100 rows: (384 + 100) x 1 = 484 at 2,048, 968 at 1,024
    (256, 96, 100, 1100, 64, 128, 1024),    # the hybrid's 100k np96 b256 cell
    (256, 96, 100, 1100, 128, 200, 1024),   # k and D do not enter the rule
    (256, 256, 1000, 1200, 10, 128, 2048),  # 1M np256 b256: 1,024 + 1,000
    (1024, 96, 100, 1100, 64, 128, 2048),   # 1,536 + 100
    (4096, 96, 100, 1100, 10, 128, 2048),   # a large batch fills the card
    (64, 96, 100, 1100, 64, 128, 512),      # (96 + 100) x 3 = 588 at 512
    (8, 96, 100, 1100, 64, 128, 512),       # list_seg's 256 (560), raised to 512
    (1, 96, 100, 1100, 64, 128, 512),       # (2 + 96) x 5 = 490 even at 256
    (70, 9, 40, 3500, 10, 384, 512),        # (10 + 40) x 14 = 700 at 256
    (256, 3, 1000, 1200, 10, 128, 2048),    # nprobe 3: 12 + 768 lists
    (130, 100, 128, 400, 10, 32, 512),      # (204 + 128) x 2 = 664 at 256
    (1, 1, 1000, 1100, 10, 128, fs.LIST_TC_SEG_MIN),   # never under the least
])
def test_tc_segment_rule_hand_worked(b, nprobe, kp, max_len, k, d, want):
    plan = fs.list_plan(k, fs.LIST_BF16, False, b, nprobe, kp, max_len, d, SMS)
    assert plan.tc and plan.seg == want


def test_tc_first_pass_rule_from_shapes():
    """The tensor-core kernel (k <= 128) runs a first pass from
    LIST_PREFLOOR_MIN_PROBES probes, as the wide mode does; the CUDA-core
    rule is as it was (wide k only)."""
    narrow = fs.list_prefloor_plan(64, 96, 64, 1024, 1000.0, tc=True)
    # c = ceil(64 / (3/4 of 96)) = 1, g = 64; the sample: sqrt(80 x 64 /
    # 96,000) of ~1,000 rows, 231, in whole row tiles, 256
    assert narrow == fs.ListPrefloor(1, 64, 256)
    assert fs.list_prefloor_plan(64, 96, 64, 1024, 1000.0) is None
    assert fs.list_prefloor_plan(64, 8, 64, 1024, 1000.0, tc=True) is None
    # k 128: c = ceil(128 / 72) = 2, g = 64; sqrt(80 x 128 / 96,000) of
    # ~1,000 rows, 327, three tiles
    assert fs.list_prefloor_plan(128, 96, 128, 2048, 1000.0, tc=True) == fs.ListPrefloor(
        2, 64, 384)
    # the wide mode (the CUDA cores): c = 8, g = 64, sqrt(5 x 512 / 96,000)
    # of ~1,000 rows, 163, two tiles
    assert fs.list_prefloor_plan(512, 96, 512, 2048, 1000.0) == fs.ListPrefloor(8, 64, 256)


# ---- the wrapper on a stand-in library: its route and its caches ---------------


class _Lib:
    """A stand-in for the built library: the shared-memory entries answer
    with the host formulas (or ``skew`` bytes off), the scans record their
    name and arguments and return 0."""

    def __init__(self, skew=0):
        self.calls, self.smem, self.skew = [], [], skew

    def pyrope_list_tc_smem_bytes(self, k, d):
        self.smem.append(("tc", k, d))
        return fs.list_tc_smem_bytes(k, d) + self.skew

    def pyrope_list_scan_smem_bytes(self, k, mode):
        self.smem.append(("list", k, mode))
        return fs.list_scan_smem_bytes(k, mode) + self.skew

    def pyrope_list_promote_smem_bytes(self, k, d):
        self.smem.append(("promote", k, d))
        return fs.list_promote_smem_bytes(k, d) + self.skew

    def __getattr__(self, name):
        if not name.startswith("pyrope_ivf_list_scan"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kbuild, "load", lambda: lib)
    monkeypatch.setattr(fs, "_SMEM_CHECKED", set())
    monkeypatch.setitem(fs._SMS, ("cpu", None), SMS)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    return lib


def _inputs(b=40, d=24, nprobe=20, n=6000, kc=32, seed=3):
    x, q, sq, alive, crow, probe = list_case(seed, n, b, d, kc, nprobe, dead=0.1, empty=2)
    offs, lens = csr(crow, kc)
    t = [as_tensor(a) for a in (q, x, sq, alive)]
    return (t[0], t[1].bfloat16(), t[2], t[3], offs, lens, as_tensor(probe), kc,
            int(lens.max()))


@pytest.mark.parametrize("promote,k", [(False, 10), (False, 300), (True, 10), (True, 300)])
def test_list_partials_reaches_the_kernel_its_plan_names(stand_in, promote, k):
    """list_partials on a bf16 slab: without promote at k <= 128 the
    tensor-core entry, with q as it is (fp32) and the slab's rows N, under
    the tc LAUNCHES key; with promote at k <= 128 the bulk-copy entry (q as
    it is, then its walking grid's blocks); at k > 128 the CUDA-core entry's
    BF16 mode (q, x, then |q|^2 of the fp32 q without promote, or null). The
    first pass (nprobe 20) launches first at k = c."""
    q, x, sq, alive, offs, lens, probe, kc, ml = _inputs()
    before = dict(fs.LAUNCHES)
    part_v, part_i, slot_end = fs.list_partials(q, x, sq, alive, offs, lens, probe, kc, k,
                                                False, ml, promote=promote)
    plan = fs.list_plan(k, fs.LIST_BF16, promote, 40, 20, kc, ml, 24, SMS)
    assert plan.tc == (not promote and k <= fs.NARROW_MAX_K)
    assert plan.promote == (promote and k <= fs.NARROW_MAX_K)
    name = ("pyrope_ivf_list_scan_tc" if plan.tc else "pyrope_ivf_list_scan_promote"
            if plan.promote else "pyrope_ivf_list_scan_bf16")
    assert [c[0] for c in stand_in.calls] == [name] * len(stand_in.calls)
    first = fs.list_prefloor_plan(k, 20, plan.kw, plan.seg, 6000 / kc, plan.tc)
    assert len(stand_in.calls) == 1 + (first is not None)
    args = stand_in.calls[-1][1]
    assert args[1] == x.data_ptr()
    if plan.tc:
        assert args[0] == q.data_ptr() and args[4] == x.shape[0]   # N, for the tensor map
        tables = args[5:]
    elif plan.promote:
        assert args[0] == q.data_ptr() and args[4] == plan.blocks == 2 * SMS
        tables = args[5:]
    else:   # q rounded to bf16 (an fp32 tensor) and its |q|^2 without promote
        assert (args[0] == q.data_ptr()) == promote and (args[2] is None) == promote
        tables = args[5:]
    # k, kw, seg, sample of the main launch, and vec: the tensor maps take
    # D % 8 == 0 and a 16-byte aligned slab; the CUDA-core copies D % 4 == 0
    assert tables[13:15] == (k, plan.kw) and tables[16:18] == (plan.seg, plan.seg)
    aligned = x.data_ptr() % 16 == 0 and (plan.tc or plan.promote or args[0] % 16 == 0)
    assert tables[19] == int(aligned)
    assert part_v.shape == (tables[18], plan.kw) and slot_end.shape == (40, 20)
    assert fs.LAUNCHES[plan.key] == before[plan.key] + 1
    tc_first, cuda_first = (fs.LAUNCHES[key] - before[key]
                            for key in ("list_scan_prefloor_tc", "list_scan_prefloor"))
    assert (tc_first, cuda_first) == ((first is not None) * plan.tc,
                                      (first is not None) * (not plan.tc))


def test_list_job_caches_change_no_result(stand_in):
    """Two calls at one (k, mode) and D cross-check shared memory with the
    library once, and lay out the same work; another k checks again; the SM
    count is read once a device; a library that disagrees raises."""
    q, x, sq, alive, offs, lens, probe, kc, ml = _inputs()
    jobs = [fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 64, False, ml, None, False)
            for _ in range(2)]
    assert stand_in.smem == [("tc", 64, 24)]
    a, b = jobs
    assert a.plan == b.plan
    for name in ("pairs", "cstart", "ccnt", "item_end", "item_c", "slot_end"):
        assert torch.equal(getattr(a.work, name), getattr(b.work, name)), name
    assert (a.work.grid, a.work.slots) == (b.work.grid, b.work.slots)
    # the same layout as a fresh, uncached computation from shapes
    fresh = fs.invert_probes(probe, lens, kc, ml, max(fs.list_seg(40, 20, kc, ml, SMS),
                                                      fs.LIST_TC_SEG_MIN), x.shape[0])
    assert torch.equal(a.work.item_c, fresh.item_c) and a.work.grid == fresh.grid
    fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 128, False, ml, None, False)
    fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 64, False, ml, None, True)
    fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 300, False, ml, None, False)
    assert stand_in.smem == [("tc", 64, 24), ("tc", 128, 24), ("promote", 64, 24),
                             ("list", 300, fs.LIST_BF16)]
    assert fs.device_sms(torch.device("cpu")) == SMS
    stand_in.skew = 16
    with pytest.raises(RuntimeError, match="disagree"):
        fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 10, False, ml, None, False)


# ---- the design's floor rule, emulated -------------------------------------------


def _crafted(n_lists=96, per=40, k=64):
    """Lists whose best rows are the hits, one a list: list c's best row
    scores -c, every other row below -1000. A first pass at c = 1, g = k over
    whole lists (each shorter than a row tile) gives the floor -(k - 1): the
    k-th hit itself."""
    offsets = torch.arange(n_lists, dtype=torch.int32) * per
    lens = torch.full((n_lists,), per, dtype=torch.int32)
    crow = torch.arange(n_lists, dtype=torch.int32).repeat_interleave(per)
    n = n_lists * per
    local = torch.arange(n) % per
    best = torch.where(local == 0, -crow.float(), -1000.0 - torch.arange(n).float())
    scores = best[None, :].repeat(3, 1)
    probe = torch.stack([torch.randperm(n_lists, generator=torch.Generator().manual_seed(i))
                         for i in range(3)]).int()
    return scores, offsets, lens, crow, probe, n


@pytest.mark.parametrize("strict", [False, True])
def test_at_or_above_a_first_pass_floor_keeps_the_kth_hit(strict):
    """The tensor-core kernel's narrow mode keeps rows AT OR ABOVE a floor
    key: a first pass's floor can be the k-th hit itself, which lies in no
    list yet. The emulated scan (``tc``) returns the plain hits; a mutant
    that keeps only rows beating the floor loses the k-th hit."""
    k = 64
    scores, offsets, lens, crow, probe, n = _crafted(k=k)
    alive = torch.ones(n, dtype=torch.bool)
    plan = fs.list_prefloor_plan(k, 96, k, 1024, 40.0, tc=True)
    assert (plan.c, plan.g) == (1, k)
    part_v, part_i, work = list_partials_emulated(
        lambda bq, c, s, e: scores[bq, s:e], alive, offsets, lens, probe, 96, k, 40,
        1024, prefloor=plan, tc=True, floor_strict=strict)
    got_v, got_i = fs.merge_partials_plain(part_v, part_i, work.slot_end, k)
    want_v, want_i = torch.topk(scores, k, dim=1)
    if strict:
        assert not torch.equal(got_v, want_v)
        assert float(got_v[:, -1].max()) < -1000.0   # the k-th hit went
    else:
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i.int())


@pytest.mark.parametrize("k", [5, 64, 128])
@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_tc_emulation_with_its_first_pass_equals_plain(k, metric):
    """The tensor-core kernel's list form (empty lists, rows at or above the
    floor, publication after every tile) with its narrow first pass, on
    small-integer data where every score is exact and ties are many: the
    plain hits exactly, ties by row included."""
    x, q, _, alive, crow, probe = list_case(41, 8192, 12, 16, 40, 24, big=2500, dup=True,
                                            dead=0.1, empty=3)
    x, q = np.floor(x * 4).astype(np.float32), np.floor(q * 4).astype(np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    t = [as_tensor(a) for a in (q, x, sq, alive, crow, probe)]
    offsets, lens = csr(crow, KP)
    seg = 512
    plan = fs.list_prefloor_plan(k, 24, k, seg, 8192 / 40, tc=True)
    assert plan is not None
    dots = t[0] @ t[1].T
    scores = dots if metric == "IP" else -torch.clamp(
        (t[0] * t[0]).sum(1, keepdim=True) - 2 * dots + t[2][None, :], min=0.0)
    part_v, part_i, work = list_partials_emulated(
        lambda bq, c, s, e: scores[bq, s:e], t[3], offsets, lens, t[5], KP, k,
        int(lens.max()), seg, prefloor=plan, tc=True)
    got = fs.merge_partials_plain(part_v, part_i, work.slot_end, k)
    want = fs.fused_ivf_topk_plain(*t, KP, k, metric)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


# ---- the plain version against the JAX package's K2 bf16 --------------------------


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("k", [10, 64, 200])
@pytest.mark.parametrize("d", [96, 128, 200])
def test_plain_vs_pallas_bf16_without_promote(d, k, metric):
    """Ragged lists (a 1,500-row one), probed empty lists and 10% dead rows,
    bf16 rows and bf16(q) without promote; the wrapper on CPU tensors is the
    plain version."""
    n = 4096   # a whole number of the JAX kernel's row tiles
    x, q, sq, alive, crow, probe = list_case(50 + d, n, 9, d, 24, 7, big=1500, empty=2,
                                            dead=0.1)
    probed = np.zeros((len(q), KP), np.float32)
    probed[np.arange(len(q))[:, None], probe] = 1.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jv, ji = pallas_ivf_topk(jnp.asarray(q), jx, jnp.asarray(sq), jnp.asarray(alive),
                             jnp.asarray(crow), jnp.asarray(probed), k, metric)
    offsets, lens = csr(crow, KP)
    tv, ti = fs.fused_ivf_topk(as_tensor(q), as_tensor(x).bfloat16(), as_tensor(sq),
                               as_tensor(alive), as_tensor(crow), offsets, lens,
                               as_tensor(probe), KP, k, port_metric(metric),
                               max_len=int(lens.max()))
    assert tv.shape == (len(q), k)
    assert_hits_but_kth_ties(tv, ti, jv, ji)
