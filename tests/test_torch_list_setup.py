"""The list scan's set-up on the host and its inversion kernel's design, on
the CPU.

Every list-scan call (``ops/fused_scan.list_partials``) takes its host plan
from a process-wide cache (``fs.list_call``: the kernel, segment, slot
width, first pass, floor, grid, slots and the pieces of its one buffer, by
shapes), carves its partials, keys and work tables out of one allocation
(``fs.layout``), and on the card inverts the probes with one kernel
(csrc/invert_probes.cu, two launches). The kernel runs only on the card
(tests/test_torch_kernels_cuda.py); here its two passes are emulated in
numpy (``_torch_parity.invert_probes_emulated``) and held bit-equal to the
plain version at the main paths' shapes and the edges. The cache is held
to a fresh computation of every plan it keeps, the plan to the kernel
each mode, k and D takes, the carve to disjoint, aligned views of the
sizes the tables need, and the IVF routes' hits, with the probes' extents
computed only where a route reads them, to the JAX package's.
"""

import threading

import numpy as np
import pytest
import torch
from _torch_parity import (
    INVERT_CASES,
    as_tensor,
    assert_same_results,
    csr,
    invert_case,
    invert_probes_emulated,
    list_case,
    port_options,
)

import pyrope_tpu as jpt
from pyrope_tpu.types import SearchOptions
from pyrope_tpu_torch import convert
from pyrope_tpu_torch.index import ivf_flat as tivf
from pyrope_tpu_torch.kernels import build as kbuild
from pyrope_tpu_torch.ops import fused_scan as fs

SMS = 132   # an H100's SMs
TABLES = ("pairs", "cstart", "ccnt", "item_end", "item_c", "slot_end")


# ---- the inversion kernel's two passes, emulated ---------------------------------


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", sorted(INVERT_CASES))
def test_inversion_design_is_bit_equal_to_the_plain_version(name, dtype):
    """The kernel's tile masks and popcounts give every table of the plain
    version, bit for bit: query order within a cluster, the item table, the
    clusters of the grid's blocks and the slots."""
    probe, lens, kp, max_len, seg, n = invert_case(name, SMS)
    probe = probe.to(dtype)
    plain = fs.invert_probes_plain(probe, lens, kp, max_len, seg, n)
    got = invert_probes_emulated(probe.numpy(), lens.numpy(), kp, seg, fs.QUERY_TILE,
                                 plain.grid)
    for table in TABLES:
        assert np.array_equal(got[table], getattr(plain, table).numpy()), table
    # the CPU wrapper is the plain version
    again = fs.invert_probes(probe, lens, kp, max_len, seg, n)
    assert all(torch.equal(getattr(again, t), getattr(plain, t)) for t in TABLES)


@pytest.mark.parametrize("b,kp", [(1, 1), (64, 100), (65, 1000), (4096, 100),
                                  (1024, 16_384)])
def test_inversion_scratch_is_three_aligned_regions(b, kp):
    """Scratch = [tiles x kp] 64-bit masks, [tiles x kp] 32-bit bases and
    [tiles] 64-bit sums, each rounded up to 16 bytes (invert_probes.cu's
    it_scratch_bytes)."""
    tiles = -(-b // fs.INVERT_TILE)
    got = fs.invert_scratch_bytes(b, kp)
    want = sum(-(-n // 16) * 16 for n in (8 * tiles * kp, 4 * tiles * kp, 8 * tiles))
    assert got == want and got % 16 == 0


# ---- the plan cache ----------------------------------------------------------------

SHAPES = [  # b, nprobe, kp, max_len, d, n_rows
    (1, 3, 1000, 1100, 128, 1_000_000),
    (1024, 3, 1000, 1100, 128, 1_000_000),
    (256, 96, 100, 1100, 128, 100_000),
    (4096, 96, 100, 1100, 128, 100_000),
    (8, 3, 1000, 1100, 768, 1_000_000),
]
MODES = [(fs.LIST_IVF, False), (fs.LIST_SQ8, False), (fs.LIST_BF16, False),
         (fs.LIST_BF16, True)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "b{}_np{}_kp{}_d{}".format(
    s[0], s[1], s[2], s[4]))
@pytest.mark.parametrize("mode,promote", MODES, ids=["ivf", "sq8", "bf16", "bf16p"])
@pytest.mark.parametrize("k", [1, 10, 64, 128, 129, 512, 10_000])
def test_cached_plan_equals_a_fresh_one(shape, mode, promote, k):
    """The cached plan of a call is the one computed fresh from its shapes:
    list_plan, list_prefloor_plan, list_floor, list_grid, list_slots; a
    second call at the same shapes takes the same object."""
    b, nprobe, kp, max_len, d, n = shape
    call = fs.list_call(k, mode, promote, b, nprobe, kp, max_len, d, n, SMS)
    plan = fs.list_plan(k, mode, promote, b, nprobe, kp, max_len, d, SMS)
    grid, segs = fs.list_grid(b, nprobe, kp, max_len, plan.seg)
    assert call.plan == plan
    assert call.prefloor == fs.list_prefloor_plan(k, nprobe, plan.kw, plan.seg, n / kp,
                                                  plan.tc)
    assert (call.pub_c, call.pub_g) == fs.list_floor(k, nprobe, plan.kw)
    assert (call.grid, call.segs) == (grid, segs)
    assert call.slots == fs.list_slots(b, nprobe, segs, plan.seg, n)
    assert fs.list_call(k, mode, promote, b, nprobe, kp, max_len, d, n, SMS) is call
    # another SM count is another plan
    other = fs.list_call(k, mode, promote, b, nprobe, kp, max_len, d, n, 16)
    assert other.plan == fs.list_plan(k, mode, promote, b, nprobe, kp, max_len, d, 16)


@pytest.mark.parametrize("k", [1, 10, 64, 128, 129, 1000])
@pytest.mark.parametrize("d", [8, 24, 30, 96, 128, 129, 256, 257, 768])
@pytest.mark.parametrize("mode,promote", [(fs.LIST_IVF, False), (fs.LIST_IVF, True),
                                          (fs.LIST_SQ8, False), (fs.LIST_BF16, True),
                                          (fs.LIST_BF16, False)])
def test_main_path_keeps_fp32_and_sq8_on_the_cuda_core_kernel(mode, promote, d, k):
    """Which kernel ``list_plan`` gives a call: fp32 and SQ8 rows the
    CUDA-core one at every k and D (promote means nothing to them); a bf16
    slab at k <= NARROW_MAX_K the bulk-copy kernel with promote up to
    PROMOTE_MAX_D and the tensor-core one without; every other bf16 call the
    CUDA-core kernel's BF16 mode. Each key is a ``LAUNCHES`` key."""
    plan = fs.list_plan(k, mode, promote, 1024, 3, 1000, 1100, d, SMS)
    wide = "_wide" if k > fs.NARROW_MAX_K else ""
    assert plan.key in fs.LAUNCHES
    if mode != fs.LIST_BF16:
        assert plan.key == ("sq8_scan" if mode == fs.LIST_SQ8 else "ivf_scan") + wide
        assert not plan.tc and not plan.promote
        assert plan.seg == fs.list_seg(1024, 3, 1000, 1100, SMS)
        assert plan.smem == fs.list_scan_smem_bytes(k, mode)
    elif promote and k <= fs.NARROW_MAX_K and d <= fs.PROMOTE_MAX_D:
        assert plan.key == "ivf_scan_bf16_promote" and plan.promote and not plan.tc
        assert plan.smem == fs.list_promote_smem_bytes(k, d) and plan.blocks >= SMS
    elif not promote and k <= fs.NARROW_MAX_K:
        assert plan.key == "ivf_scan_bf16_tc" and plan.tc and not plan.promote
        assert plan.smem == fs.list_tc_smem_bytes(k, d)
    else:
        assert plan.key == "ivf_scan_bf16" + wide and not plan.tc and not plan.promote
        assert plan.smem == fs.list_scan_smem_bytes(k, mode)


@pytest.mark.parametrize("mode", [fs.LIST_IVF, fs.LIST_SQ8])
@pytest.mark.parametrize("k", [200, 1000])
def test_wide_first_pass_stays_on_the_cuda_core_kernel(mode, k):
    """A wide call at nprobe 96 runs a first pass: ``_ListJob.first_pass``
    launches the wide call's own plan narrow at k = c, the CUDA-core kernel
    (``<MODE, false>``), whose scores are the wide pass's bit for bit; a
    narrow call runs none."""
    call = fs.list_call(k, mode, False, 1024, 96, 100, 1100, 128, 100_000, SMS)
    assert call.prefloor is not None and not call.plan.tc and not call.plan.promote
    assert call.plan.key == ("sq8_scan" if mode == fs.LIST_SQ8 else "ivf_scan") + "_wide"
    assert fs.list_prefloor_plan(10, 96, 10, 2048, 1000.0) is None
    narrow = fs.list_call(10, mode, False, 1024, 96, 100, 1100, 128, 100_000, SMS)
    assert not narrow.plan.key.endswith("_wide") and narrow.prefloor is None


def test_plan_cache_is_safe_from_several_threads(monkeypatch):
    """Eight threads asking for plans at once (a server's workers), the
    cache starting over as it fills: each gets the plan of its own shapes."""
    monkeypatch.setattr(fs, "_CALLS", {})
    monkeypatch.setattr(fs, "_CALLS_MAX", 16)
    keys = [(k, fs.LIST_IVF, False, b, 3, 1000, 1100, 128, 1_000_000, SMS)
            for k in (10, 200) for b in range(1, 41)]
    want = {key: fs._list_call(*key) for key in keys}
    bad = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, len(keys), 300):
            if fs.list_call(*keys[i]) != want[keys[i]]:
                bad.append(keys[i])

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad and len(fs._CALLS) <= 16


# ---- the one allocation ------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES[:4], ids=lambda s: f"b{s[0]}_np{s[1]}")
@pytest.mark.parametrize("k", [10, 64, 512])
def test_one_buffer_lays_out_disjoint_aligned_pieces(shape, k):
    """A call's pieces lie in one buffer: each on a 16-byte boundary, of
    the size its table needs, none overlapping another."""
    b, nprobe, kp, max_len, d, n = shape
    call = fs.list_call(k, fs.LIST_BF16, False, b, nprobe, kp, max_len, d, n, SMS)
    assert [name for name, _ in call.pieces] == list(call.spans)
    spans = sorted(call.spans.values())
    assert all(o % 4 == 0 for o, _ in spans)            # int32 elements: 16 bytes
    assert all(o + n <= o2 for (o, n), (o2, _) in zip(spans, spans[1:]))
    assert spans[-1][0] + spans[-1][1] <= call.total
    sizes = dict(call.pieces)
    assert sizes["part_v"] == sizes["part_i"] == call.slots * call.plan.kw
    assert sizes["keys"] == 2 * (call.slots + b) * (1 if call.prefloor is None else 2)
    assert sizes["item_c"] == call.grid and sizes["slot_end"] == b * nprobe
    assert sizes["scratch"] * 4 == fs.invert_scratch_bytes(b, kp)


class _Lib:
    """A stand-in for the built library: shared memory by the host formulas,
    the scans recorded, no inversion entry (CPU tensors take the plain
    version)."""

    def __init__(self):
        self.calls = []

    def pyrope_list_tc_smem_bytes(self, k, d):
        return fs.list_tc_smem_bytes(k, d)

    def pyrope_list_scan_smem_bytes(self, k, mode):
        return fs.list_scan_smem_bytes(k, mode)

    def pyrope_list_promote_smem_bytes(self, k, d):
        return fs.list_promote_smem_bytes(k, d)

    def __getattr__(self, name):
        if not name.startswith("pyrope_ivf_list_scan"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(kbuild, "load", lambda: lib)
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


@pytest.mark.parametrize("k", [10, 300])
def test_list_job_tables_live_in_its_one_buffer(stand_in, k):
    """A job's partials, keys and work tables are views of one buffer; the
    tables are the plain inversion's, the keys zero, and the launches read
    the tables there."""
    q, x, sq, alive, offs, lens, probe, kc, ml = _inputs()
    job = fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, k, False, ml, None, False)
    w = job.work
    views = [job.part_v, job.part_i, job.pub, *(getattr(w, t) for t in TABLES)]
    if job.first is not None:
        views.append(job.first)
    assert len({t.untyped_storage().data_ptr() for t in views}) == 1
    plain = fs.invert_probes_plain(probe, lens, kc, ml, job.plan.seg, x.shape[0])
    for t in TABLES:
        assert torch.equal(getattr(w, t), getattr(plain, t)), t
    assert not job.pub.any() and (job.first is None or not job.first.any())
    assert job.pub.shape == (w.slots + 40,) and job.part_v.shape == (w.slots, job.plan.kw)
    call = job.call
    job.launch(k, call.plan.kw, job.part_v, job.part_i, job.pub, call.pub_c, call.pub_g,
               call.plan.seg)
    tables = stand_in.calls[-1][1][5:]
    assert (tables[0], tables[6], tables[18]) == (w.pairs.data_ptr(), w.slot_end.data_ptr(),
                                                  w.slots)
    assert (tables[20], tables[22]) == (job.part_v.data_ptr(), job.pub.data_ptr())


def test_host_split_records_each_step(stand_in):
    """host_split() records the wrapper's host steps, call by call, in
    order; outside it nothing is recorded."""
    q, x, sq, alive, offs, lens, probe, kc, ml = _inputs()
    with fs.host_split() as split:
        for _ in range(2):
            fs._mark("start")   # where fused_ivf_topk marks a call's entry
            fs.list_partials(q, x, sq, alive, offs, lens, probe, kc, 64, False, ml)
    steps = [s for s, _ in split]
    assert steps == ["plan", "alloc", "invert", "q_bf16", "first_pass", "scan"] * 2
    assert all(sec >= 0 for _, sec in split)
    assert getattr(fs._SPLIT, "marks", None) is None


# ---- probe extents only where a route reads them -----------------------------------


def _ivf_pair(tmp_path_factory, n, d, nlist, nprobe, seed):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(8, d)).astype(np.float32)
    jix = jpt.IvfFlatIndex(d, "L2", nlist=nlist, nprobe=nprobe, scan_mode="dense",
                           train_init="sample")
    jix.add_batch([str(i) for i in range(n)], base)
    jix.build()
    path = str(tmp_path_factory.mktemp("ivf") / "jax.npz")
    jix.snapshot(path)
    with np.load(path) as z:
        tix = convert.ivf_flat_from_arrays(z, "cpu")
    return jix, tix, q


@pytest.fixture(scope="module")
def ivf_pair(tmp_path_factory):
    return _ivf_pair(tmp_path_factory, 3000, 24, 16, 4, 7)


@pytest.mark.parametrize("route,scan_mode,max_scans,extents", [
    ("dense-pallas", "dense", None, False),
    ("probe", "probe", None, True),
    ("dense-xla", "dense", 500, True),
])
def test_routes_compute_probe_extents_only_where_read(ivf_pair, monkeypatch, route,
                                                      scan_mode, max_scans, extents):
    """rank_probes' extents (offsets and budgeted lengths of each probe)
    feed the probe and dense-xla routes only; the list scan's route skips
    them. Every route's hits stay the JAX package's."""
    jix, tix, q = ivf_pair
    calls = []
    real = tivf.probe_extents
    monkeypatch.setattr(tivf, "probe_extents", lambda *a: calls.append(1) or real(*a))
    jix.scan_mode = tix.scan_mode = scan_mode
    try:
        opts = SearchOptions(max_scans=max_scans)
        assert tix.describe_scan(8, max_scans=max_scans) == route
        got = tix.search_batch(q, 10, port_options(opts))
        assert_same_results(got, jix.search_batch(q, 10, opts))
    finally:
        jix.scan_mode = tix.scan_mode = "dense"
    assert bool(calls) == extents
