"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a GPU: a CUDA kernel
has no CPU mode (the CPU tests in test_torch_fused_scan.py hold the plain
versions against the JAX package's Pallas kernels). The file imports no
jax, so it also runs where only torch is installed:

    python3 -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Both sides compute in fp32 (TF32 off) with a different summation order:
hit sets must be equal, scores within rtol 1e-5 / atol 1e-4 (the SQ8 scan:
the JAX package's SQ8 tolerance, rtol 1e-4 / atol 1e-4; see _torch_parity).
The builds on the card are deterministic: two from one seed give bit-equal
centroids, codebooks and codes. The bf16 slab modes are held to the same
tolerance against their plain versions (exact products of bf16 values,
fp32 sums in another order; the flat scan's on the tensor cores, wgmma
with fp32 accumulation); scores rounded to bf16 tie more often, so a hit
may differ there only as a k-th place tie.
"""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from _torch_parity import (
    RTOL,
    SQ8_RTOL,
    as_tensor,
    assert_hits_but_kth_ties,
    assert_same_hits,
    assert_same_results,
    csr,
    INVERT_CASES,
    flat_case,
    fused_ivf_topk_emulated,
    invert_case,
    ivf_case,
    ivf_plain_exact,
    list_case,
    split_partials,
    sq8_case,
    sq8_of,
)

from pyrope_tpu_torch.kernels import build as kbuild
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.types import Metric, SearchOptions


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("k", [1, 10, 100, 128])
def test_flat_kernel_vs_plain(cuda_device, metric, k):
    n, b, d = 20_000, 70, 40  # ragged edges on every axis
    x, q, sq, alive = flat_case(5, n, b, d)
    args = [as_tensor(a).to(cuda_device) for a in (q, x, sq, alive)]
    before = fs.LAUNCHES["flat_scan"]
    kv, ki = fs.fused_flat_topk(*args, n - 999, k, metric)
    assert fs.LAUNCHES["flat_scan"] == before + 1
    pv, pi = fs.fused_flat_topk_plain(*args, n - 999, k, metric)
    torch.cuda.synchronize()
    assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [100, 1000])
def test_ivf_kernel_vs_plain(cuda_device, kc):
    n, b, d, k = 20_000, 130, 32, 10
    x, q, sq, alive, crow, probe = ivf_case(6, n, b, d, kc, 7)
    q, x, sq, alive, crow, probe = (as_tensor(a).to(cuda_device)
                                    for a in (q, x, sq, alive, crow, probe))
    offs, lens = (t.to(cuda_device) for t in csr(crow.cpu(), kc))
    before = fs.LAUNCHES["ivf_scan"]
    kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, kc, k,
                               max_len=n)
    assert fs.LAUNCHES["ivf_scan"] == before + 1
    pv, pi = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, kc, k)
    torch.cuda.synchronize()
    assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
def test_kernels_take_an_empty_batch(cuda_device):
    x, q, sq, alive, crow, probe = ivf_case(4, 4096, 8, 16, 50, 3)
    offs, lens = (t.to(cuda_device) for t in csr(crow, 50))
    q, x, sq, alive, crow, probe = (as_tensor(a).to(cuda_device)
                                    for a in (q[:0], x, sq, alive, crow, probe[:0]))
    for v, i in (fs.fused_flat_topk(q, x, sq, alive, 4096, 10),
                 fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 50, 10,
                                   max_len=4096)):
        assert v.shape == i.shape == (0, 10)
        assert (v.dtype, i.dtype) == (torch.float32, torch.int32)


@pytest.mark.cuda
def test_kernel_refuses_non_contiguous(cuda_device):
    x = torch.zeros((64, 16), device=cuda_device)
    q = torch.zeros((16, 8), device=cuda_device).T  # [8, 16], strided
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_flat_topk(q, x, torch.zeros(64, device=cuda_device),
                           torch.ones(64, dtype=torch.bool, device=cuda_device),
                           64, 5)


@pytest.mark.cuda
def test_merge_kernel_vs_plain(cuda_device):
    x, q, sq, alive = flat_case(8, 20_000, 70, 16)
    pv, pi = split_partials(q, x, sq, alive, 100, per=1280)
    before = fs.LAUNCHES["merge"]
    kv, ki = fs.merge_partials(pv.to(cuda_device), pi.to(cuda_device))
    assert fs.LAUNCHES["merge"] == before + 1
    mv, mi = fs.merge_partials_plain(pv, pi)
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


@pytest.mark.cuda
def test_ivf_index_kernel_route_matches_plain_route(cuda_device):
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex

    rng = np.random.default_rng(9)
    base = rng.normal(size=(30_000, 32)).astype(np.float32)
    q = rng.normal(size=(100, 32)).astype(np.float32)
    ids = [str(i) for i in range(len(base))]
    fused = IvfFlatIndex(32, "L2", device=cuda_device, nlist=600, nprobe=20,
                         scan_mode="dense")
    fused.add_batch(ids, base)
    fused.build()
    assert fused.describe_scan(128) == "dense-pallas-win"
    before = fs.LAUNCHES["ivf_scan"]
    got = fused.search_batch(q, 10)
    assert fs.LAUNCHES["ivf_scan"] == before + 1
    fused.selection = "exact"  # the plain dense route on the same partition
    assert fused.describe_scan(128) == "dense-xla"
    want = fused.search_batch(q, 10)
    assert_same_results(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("kc,d", [(100, 24), (1000, 40)])
def test_sq8_kernel_vs_plain(cuda_device, metric, kc, d):
    n, b, k = 20_000, 130, 10   # ragged edges; d not a multiple of 16
    case = sq8_case(13, n, b, d, kc, 7, kc)
    offs, lens = (t.to(cuda_device) for t in csr(case[6], kc))
    args = [as_tensor(a).to(cuda_device) for a in case]
    args.pop(8)                                  # cents: the kernel takes qc
    before = fs.LAUNCHES["sq8_scan"]
    kv, ki = fs.fused_ivf_sq8_topk(*args[:7], offs, lens, *args[7:], kc, k, metric,
                                   max_len=n)
    assert fs.LAUNCHES["sq8_scan"] == before + 1
    pv, pi = fs.fused_ivf_sq8_topk_plain(*args, kc, k, metric)
    torch.cuda.synchronize()
    assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), rtol=SQ8_RTOL)


@pytest.mark.cuda
def test_sq8_wrapper_raises_on_bad_cuda_inputs(cuda_device):
    raw = sq8_case(14, 4096, 16, 32, 50, 3, 50)
    case = [as_tensor(a).to(cuda_device) for a in raw]
    q, codes, mn, sc, sq, alive, crow, probe, _, qc = case
    ol = [t.to(cuda_device) for t in csr(raw[6], 50)]
    before = dict(fs.LAUNCHES)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq, alive, crow, *ol, probe,
                              qc.T.contiguous().T, 50, 10, max_len=4096)
    with pytest.raises(ValueError, match="uint8"):
        fs.fused_ivf_sq8_topk(q, codes.float(), mn, sc, sq, alive, crow, *ol, probe, qc,
                              50, 10, max_len=4096)
    with pytest.raises(ValueError, match="one device"):
        fs.fused_ivf_sq8_topk(q, codes, mn.cpu(), sc, sq, alive, crow, *ol, probe, qc,
                              50, 10, max_len=4096)
    with pytest.raises(ValueError, match="k must be"):
        fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq, alive, crow, *ol, probe, qc, 50,
                              0, max_len=4096)
    assert fs.LAUNCHES == before                 # nothing ran, nothing fell back
    v, i = fs.fused_ivf_sq8_topk(q[:0], codes, mn, sc, sq, alive, crow, *ol, probe[:0],
                                 qc[:0], 50, 10, max_len=4096)
    assert v.shape == i.shape == (0, 10)


@pytest.mark.cuda
def test_builds_on_the_card_are_deterministic(cuda_device):
    """Two builds from one seed: bit-equal k-means centroids and
    assignments, PQ codebooks and codes, and SQ8 slab codes."""
    from pyrope_tpu_torch.utils.datasets import synthetic_clustered
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
    from pyrope_tpu_torch.ops.kmeans import kmeans_build

    x = synthetic_clustered(200_000, 32, n_clusters=256, seed=3)
    runs = [kmeans_build(x, 256, "L2", device=cuda_device, seed=5) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    ixs = []
    for _ in range(2):
        ix = IvfPqIndex(32, "L2", device=cuda_device, nlist=64, pq_m=8,
                        refine_storage="sq8res")
        ix.add_batch([str(i) for i in range(len(x))], x)
        ix.build()
        ixs.append(ix)
    a, b = ixs
    np.testing.assert_array_equal(a.get_centroids(), b.get_centroids())
    np.testing.assert_array_equal(a.pq.codebooks, b.pq.codebooks)
    np.testing.assert_array_equal(a._codes, b._codes)
    for key in ("codes8", "mins", "scales", "sq8norm"):
        assert torch.equal(a._dev[key], b._dev[key]), key


@pytest.mark.cuda
def test_ivf_pq_sq8_route_matches_the_plain_route(cuda_device, tmp_path):
    """The SQ8 kernel route on the card against the same index carried to
    the CPU, where the route runs the plain version."""
    from pyrope_tpu_torch import convert
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(10)
    base = rng.normal(size=(30_000, 32)).astype(np.float32)
    q = rng.normal(size=(100, 32)).astype(np.float32)
    ix = IvfPqIndex(32, "L2", device=cuda_device, nlist=600, nprobe=20, pq_m=8,
                    refine_storage="sq8res", scan_mode="dense")
    ix.add_batch([str(i) for i in range(len(base))], base)
    ix.build()
    assert ix.describe_scan(128) == "dense-sq8-pallas-win"
    before = fs.LAUNCHES["sq8_scan"]
    got = ix.search_batch(q, 10)
    assert fs.LAUNCHES["sq8_scan"] == before + 1
    ix.snapshot(str(tmp_path / "ix.npz"))
    with np.load(tmp_path / "ix.npz") as z:
        cpu = convert.ivf_pq_from_arrays(z, "cpu")
    assert cpu.describe_scan(128) == "dense-sq8-pallas-win"
    assert_same_results(got, cpu.search_batch(q, 10), rtol=SQ8_RTOL)


# the list scan's layouts on the card: name -> (list_case kwargs, nprobe, k)
LIST_CASES = {
    "skewed": (dict(big=6000), 3, 10),            # one long list: 2048-row segments
    "all_lists": (dict(empty=7), 120, 10),        # nprobe >= non-empty clusters
    "empty_probed": (dict(empty=20), 5, 10),
    "k128": (dict(big=2000), 3, 128),
    "dup_ties": (dict(dup=True), 3, 10),
    "tombstones": (dict(dead=0.4), 7, 10),
    "wide_chunks": (dict(), 100, 10),             # 130 queries a list: layout A
}


def _list_inputs(name, dev, d, kc=128, n=20_000, b=130):
    kw, nprobe, k = LIST_CASES[name]
    case = list_case(17, n, b, d, kc, nprobe, **kw)
    offs, lens = (t.to(dev) for t in csr(case[4], kc))
    return case, [as_tensor(a).to(dev) for a in case], offs, lens, k


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 30])          # 30: the plain-load staging
@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_list_scan_vs_plain(cuda_device, name, d):
    _, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, d)
    for metric in (Metric.L2, Metric.INNER_PRODUCT):
        before = fs.LAUNCHES["ivf_scan"]
        kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k,
                                   metric, max_len=int(lens.max()))
        assert fs.LAUNCHES["ivf_scan"] == before + 1
        pv, pi = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, 128, k, metric)
        torch.cuda.synchronize()
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 24, 30])
@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_sq8_list_scan_vs_plain(cuda_device, name, d):
    case, (_, q, _, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, d)
    codes, mn, sc, sq, _, qc = (as_tensor(a).to(cuda_device) for a in sq8_of(case, 128))
    for metric in (Metric.L2, Metric.INNER_PRODUCT):
        before = fs.LAUNCHES["sq8_scan"]
        kv, ki = fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq, alive, crow, offs, lens,
                                       probe, qc, 128, k, metric, max_len=int(lens.max()))
        assert fs.LAUNCHES["sq8_scan"] == before + 1
        pv, pi = fs.fused_ivf_sq8_topk_plain(q, codes, mn, sc, sq, alive, crow, probe,
                                             qc, 128, k, metric)
        torch.cuda.synchronize()
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), rtol=SQ8_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["skewed", "wide_chunks", "dup_ties"])
def test_list_scan_launches_are_bit_equal(cuda_device, name):
    """Each partial slot has one writer and each block a fixed order; the
    per-query floors depend on the order blocks ran in, but only drop rows
    that k others beat. So two launches on the same inputs return
    bit-equal results, whatever order the blocks ran in."""
    case, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, 32)
    ml = int(lens.max())
    runs = [fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k, max_len=ml)
            for _ in range(2)]
    codes, mn, sc, sq8, _, qc = (as_tensor(a).to(cuda_device) for a in sq8_of(case, 128))
    runs8 = [fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq8, alive, crow, offs, lens, probe,
                                   qc, 128, k, max_len=ml) for _ in range(2)]
    for a, b in (runs, runs8):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_list_scan_matches_its_cpu_emulation(cuda_device):
    """The kernel against the CPU emulation of its own work layout, at the
    segment length the wrapper picks."""
    case, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs("skewed", cuda_device, 32)
    ml = int(lens.max())
    kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k, max_len=ml)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    seg = fs.list_seg(q.shape[0], probe.shape[1], 128, ml, sms)
    ev, ei = fused_ivf_topk_emulated(*(t.cpu() for t in (q, x, sq, alive, offs, lens,
                                                         probe)), 128, k, seg=seg)
    torch.cuda.synchronize()
    assert_same_hits(kv.cpu(), ki.cpu(), ev, ei)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["skewed", "all_lists", "k128"])
def test_list_scan_takes_max_len_at_and_above_the_longest_list(cuda_device, name):
    """max_len exactly the longest list, or an l_pad-style bound above it
    (more segments allowed, another segment length): bit-equal results,
    equal to the plain version. A max_len below the longest list breaks
    the precondition: the launch then stays inside its buffers (no CUDA
    error), and the next call is right."""
    _, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, 32)
    ml = int(lens.max())
    runs = [fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k, max_len=m)
            for m in (ml, -(-ml // 128) * 128, ml + 5000)]
    for v, i in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(i, runs[0][1])
    pv, pi = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, 128, k)
    assert_same_hits(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())
    fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k, max_len=ml // 8)
    torch.cuda.synchronize()
    again = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 128, k, max_len=ml)
    assert torch.equal(again[0], runs[0][0]) and torch.equal(again[1], runs[0][1])


@pytest.mark.cuda
def test_merge_kernel_takes_per_query_slots(cuda_device):
    """The list scan's merge form ([slots, k] rows, query b's from
    qend[b-1, -1] to qend[b, -1], some queries with none) against the plain
    version."""
    x, q, sq, alive = flat_case(8, 20_000, 70, 16)
    pv, pi = split_partials(q, x, sq, alive, 100, per=1280)    # [16, 70, 100]
    cnt = torch.from_numpy(np.random.default_rng(2).integers(0, 17, 70))
    cnt[::9] = 0
    qend = torch.stack([cnt // 2, cnt - cnt // 2], 1).reshape(-1).cumsum(0).int().view(70, 2)
    rows = torch.cat([torch.arange(c) for c in cnt.tolist()])          # list s of query b
    owner = torch.repeat_interleave(torch.arange(70), cnt)
    sv, si = pv[rows, owner].contiguous(), pi[rows, owner].contiguous()
    kv, ki = fs.merge_partials(sv.to(cuda_device), si.to(cuda_device), qend.to(cuda_device))
    mv, mi = fs.merge_partials_plain(sv, si, qend)
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())
    assert (mi[cnt == 0] == -1).all()


def _zipf_layout(dev, n=60_000, d=32, nc=100, b=1024, nprobe=3):
    """A list layout as an IVF index over a Zipf corpus makes it: rows of
    ``synthetic_zipf`` sorted by their nearest generating center (the
    largest of 100 lists ~19% of the rows), ``synthetic_zipf_queries`` probing their nearest
    ``nprobe`` centers. Returns (q, x, sq, alive, crow, offs, lens, probe,
    max_len) on ``dev``, max_len the longest list rounded up to 128."""
    from pyrope_tpu_torch.utils.datasets import synthetic_zipf, synthetic_zipf_queries

    x = synthetic_zipf(n, d, n_clusters=nc)
    q = synthetic_zipf_queries(b, d, n_clusters=nc)
    cents = np.random.default_rng(42).random((nc, d)).astype(np.float32)

    def nearest(v, m):
        d2 = (v * v).sum(1)[:, None] - 2.0 * v @ cents.T + (cents * cents).sum(1)[None]
        return np.argsort(d2, axis=1, kind="stable")[:, :m]

    assign = nearest(x, 1)[:, 0]
    order = np.argsort(assign, kind="stable")
    x = np.ascontiguousarray(x[order])
    crow = assign[order].astype(np.int32)
    probe = nearest(q, nprobe).astype(np.int32)
    offs, lens = csr(crow, nc)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    t = [as_tensor(a).to(dev) for a in (q, x, sq, alive, crow)]
    return (*t, offs.to(dev), lens.to(dev), as_tensor(probe).to(dev),
            -(-int(lens.max()) // 128) * 128)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nprobe,k", [(1024, 3, 10), (64, 3, 10), (256, 8, 128),
                                        (256, 3, 200)])
def test_list_scan_on_a_zipf_layout_vs_plain(cuda_device, b, nprobe, k):
    """The list scan (narrow and wide) where one list holds a sixth of the
    rows or more, as on the skewed corpora: the hits of its plain
    version."""
    q, x, sq, alive, crow, offs, lens, probe, ml = _zipf_layout(cuda_device, b=b,
                                                                nprobe=nprobe)
    assert int(lens.max()) > 0.13 * x.shape[0]
    key = "ivf_scan_wide" if k > fs.NARROW_MAX_K else "ivf_scan"
    before = fs.LAUNCHES[key]
    kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 100, k,
                               max_len=ml)
    assert fs.LAUNCHES[key] == before + 1
    pv, pi = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, 100, k)
    torch.cuda.synchronize()
    assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1024, 64])
def test_merge_on_a_zipf_layout_vs_plain(cuda_device, b):
    """The merge kernel on the list scan's own partials over a Zipf layout
    (queries of the long list fill more slots than the others: 8 against
    3 at 2,048-row segments): bit-equal to its plain version on the same
    partials."""
    q, x, sq, alive, crow, offs, lens, probe, ml = _zipf_layout(cuda_device, b=b)
    part_v, part_i, slot_end = fs.list_partials(q, x, sq, alive, offs, lens, probe, 100, 10,
                                                False, ml)
    per_q = slot_end[:, -1].diff(prepend=slot_end.new_zeros(1))
    assert int(per_q.max()) >= 2 * int(per_q.min())
    before = fs.LAUNCHES["merge"]
    kv, ki = fs.merge_partials(part_v, part_i, slot_end)
    assert fs.LAUNCHES["merge"] == before + 1
    mv, mi = fs.merge_partials_plain(part_v, part_i, slot_end)
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.cpu().numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.cpu().numpy())


# ---- the flat scan's two tile instantiations and the merge's layouts ---------


def _flat_inputs(dev, seed, n, b, d, dead=0.0):
    x, q, sq, alive = flat_case(seed, n, b, d)
    if dead:
        alive &= np.random.default_rng(seed).random(n) >= dead
    return [as_tensor(a).to(dev) for a in (q, x, sq, alive)]


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("d", [16, 100, 128, 384])
@pytest.mark.parametrize("b", [1, 70, 129, 1024])
def test_flat_tiles_vs_plain(cuda_device, metric, d, b):
    """Both tiles (B <= 64: the 64-query tile; k 128: one block an SM), both
    metrics' instantiations, N no multiple of the row tile, max_scans inside
    a tile, 20% tombstones."""
    n = 5_000 if b == 1024 else 20_001
    args = _flat_inputs(cuda_device, 50 + d, n, b, d, dead=0.2)
    for k in (1, 10, 128):
        assert fs.flat_tile(d, k, b)[0] == (64 if b <= 64 else 128)
        before = fs.LAUNCHES["flat_scan"]
        kv, ki = fs.fused_flat_topk(*args, n - 77, k, metric)
        assert fs.LAUNCHES["flat_scan"] == before + 1
        pv, pi = fs.fused_flat_topk_plain(*args, n - 77, k, metric)
        torch.cuda.synchronize()
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [30, 128])          # 30: the plain-load staging
def test_flat_unaligned_and_odd_depth(cuda_device, d):
    q, x, sq, alive = _flat_inputs(cuda_device, 60, 9_000, 130, d)
    xo = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x).copy_(x)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    for slab in (x, xo):
        kv, ki = fs.fused_flat_topk(q, slab, sq, alive, 9_000, 10)
        pv, pi = fs.fused_flat_topk_plain(q, slab, sq, alive, 9_000, 10)
        torch.cuda.synchronize()
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(3, 10), (200, 10), (200, 30), (200, 100)])
def test_flat_duplicates_dead_rows_and_bit_equal_launches(cuda_device, b, k):
    n, d = 30_000, 64
    x, q, sq, alive = flat_case(61, n, b, d)
    x[129] = x[130] = x[25_000] = x[64]       # exact ties in a tile, across splits
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q[0] = x[64]
    tq, tx, tsq, tal = (as_tensor(a).to(cuda_device) for a in (q, x, sq, alive))
    runs = [fs.fused_flat_topk(tq, tx, tsq, tal, n, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][1][0, :4].tolist() == [64, 129, 130, 25_000]
    pv, pi = fs.fused_flat_topk_plain(tq, tx, tsq, tal, n, k)
    assert_same_hits(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())
    for dead, ms in ((torch.zeros_like(tal), n), (tal, 0)):   # nothing survives
        v, i = fs.fused_flat_topk(tq, tx, tsq, dead, ms, k)
        assert (i == -1).all() and torch.isinf(v).all()
    few = torch.zeros_like(tal)
    few[[5, 20_000]] = True                                   # fewer live than k
    v, i = fs.fused_flat_topk(tq, tx, tsq, few, n, k)
    if k > 1:
        assert (i[:, 2:] == -1).all() and (i[:, :2].sort(1).values.cpu()
                                           == torch.tensor([5, 20_000])).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 128])
@pytest.mark.parametrize("s", [1, 3, 33, 200])
def test_merge_kernel_layouts_vs_plain(cuda_device, s, k):
    """S lists a query as [S, B, k], and the same lists as per-query slots
    ([slots, k] + qend): bit-equal to the plain version, ties included."""
    b = 70
    rng = np.random.default_rng(70 + s)
    v = np.sort(rng.integers(0, 40, (s, b, k)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * k) for _ in range(b)], 1).reshape(s, k, b)
    rows = np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)                    # ties: lower row first
    pv = torch.from_numpy(np.take_along_axis(np.ascontiguousarray(v), order, 2))
    pi = torch.from_numpy(np.take_along_axis(rows, order, 2))
    pv[s // 2, ::3] = float("-inf")                           # an empty list
    pi[s // 2, ::3] = -1
    mv, mi = fs.merge_partials_plain(pv, pi)
    kv, ki = fs.merge_partials(pv.to(cuda_device), pi.to(cuda_device))
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())
    sv = pv.permute(1, 0, 2).reshape(b * s, k).contiguous()   # query b: slots b·s..
    si = pi.permute(1, 0, 2).reshape(b * s, k).contiguous()
    qend = (torch.arange(1, b + 1, dtype=torch.int32) * s).view(b, 1)
    kv, ki = fs.merge_partials(sv.to(cuda_device), si.to(cuda_device), qend.to(cuda_device))
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


# ---- the bf16 slab modes (flat scan, list scan with and without promote) ----


def _bf16_flat_inputs(dev, seed, n, b, d, dead=0.0):
    q, x, sq, alive = _flat_inputs(dev, seed, n, b, d, dead)
    return q, x.bfloat16(), sq, alive   # sqnorm of the fp32 rows


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 37, 100, 128, 384])   # 37, 100: plain-load staging
@pytest.mark.parametrize("b", [1, 70, 257])
def test_flat_bf16_vs_plain(cuda_device, d, b):
    n = 20_001
    args = _bf16_flat_inputs(cuda_device, 80 + d, n, b, d, dead=0.2)
    for k in (1, 10, 64, 128):
        assert fs.flat_tile(d, k, b, 2)[0] in fs.FLAT_QUERY_TILES
        for metric in (Metric.L2, Metric.INNER_PRODUCT):
            before = dict(fs.LAUNCHES)
            kv, ki = fs.fused_flat_topk(*args, n - 77, k, metric)
            assert fs.LAUNCHES["flat_scan_bf16"] == before["flat_scan_bf16"] + 1
            assert fs.LAUNCHES["flat_scan"] == before["flat_scan"]
            pv, pi = fs.fused_flat_topk_plain(*args, n - 77, k, metric)
            torch.cuda.synchronize()
            assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 64])
def test_flat_bf16_duplicates_and_bit_equal_launches(cuda_device, k):
    n, d, b = 30_000, 64, 200
    x, q, sq, alive = flat_case(62, n, b, d)
    x[129] = x[130] = x[25_000] = x[64]       # exact ties in a tile, across splits
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    q[0] = x[64]
    tq, tsq, tal = (as_tensor(a).to(cuda_device) for a in (q, sq, alive))
    tx = as_tensor(x).to(cuda_device).bfloat16()
    runs = [fs.fused_flat_topk(tq, tx, tsq, tal, n, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    assert runs[0][1][0, :4].tolist() == [64, 129, 130, 25_000]
    pv, pi = fs.fused_flat_topk_plain(tq, tx, tsq, tal, n, k)
    assert_hits_but_kth_ties(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("promote", [False, True])
@pytest.mark.parametrize("d", [16, 30, 100, 128, 384])   # 30: the plain-load staging
@pytest.mark.parametrize("name", sorted(LIST_CASES))
def test_bf16_list_scan_vs_plain(cuda_device, name, d, promote):
    """Without promote (the tensor cores) against the exactly summed plain
    version (``ivf_plain_exact``): at D 384 cuBLAS's fp32 order put the
    dup_ties case's near-duplicate 1.6e-4 off the kernel's
    (tests/bf16_sum_witness.py); with promote against the plain version."""
    _, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, d)
    x16 = x.bfloat16()
    for metric in (Metric.L2, Metric.INNER_PRODUCT):
        before = dict(fs.LAUNCHES)
        kv, ki = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, 128, k,
                                   metric, max_len=int(lens.max()), promote_fp32=promote)
        # promote: the bulk-copy kernel up to PROMOTE_MAX_D, above it the
        # CUDA-core kernel's BF16 mode; else the tensor cores
        key = (("ivf_scan_bf16_promote" if d <= fs.PROMOTE_MAX_D else "ivf_scan_bf16")
               if promote else "ivf_scan_bf16_tc")
        for other in ("ivf_scan_bf16", "ivf_scan_bf16_promote", "ivf_scan_bf16_tc"):
            assert fs.LAUNCHES[other] == before[other] + (other == key), other
        assert fs.LAUNCHES["ivf_scan"] == before["ivf_scan"]
        pv, pi = (fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, 128, k, metric,
                                          promote_fp32=True) if promote
                  else ivf_plain_exact(q, x16, sq, alive, crow, probe, 128, k, metric))
        torch.cuda.synchronize()
        assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 70, 257])
@pytest.mark.parametrize("k", [1, 10, 64, 128])
def test_bf16_list_scan_batches_k_and_bit_equal_launches(cuda_device, b, k):
    case = list_case(23, 20_000, b, 128, 128, 5, dead=0.1, dup=True)
    x, q, sq, alive, crow, probe = (as_tensor(a).to(cuda_device) for a in case)
    offs, lens = (t.to(cuda_device) for t in csr(case[4], 128))
    x16 = x.bfloat16()
    for promote in (False, True):
        runs = [fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, 128, k,
                                  max_len=int(lens.max()), promote_fp32=promote)
                for _ in range(2)]
        pv, pi = (fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, 128, k,
                                          promote_fp32=True) if promote
                  else ivf_plain_exact(q, x16, sq, alive, crow, probe, 128, k))
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        assert_hits_but_kth_ties(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
def test_smem_formulas_match_the_library(cuda_device):
    """The wrappers size each launch from the Python formulas; they must
    equal the sources' own, and the list scan's no longer grows with D."""
    from pyrope_tpu_torch.kernels.build import load

    lib = load()
    for k in (1, 10, 64, 128, 129, 512, 1000, 10_000, 20_000):
        for mode in (fs.LIST_IVF, fs.LIST_SQ8, fs.LIST_BF16):
            assert (lib.pyrope_list_scan_smem_bytes(k, mode)
                    == fs.list_scan_smem_bytes(k, mode) <= fs.SMEM_LIMIT), (k, mode)
    for k in (1, 10, 64, 100, 128, 129, 512, 10_000, 20_000):
        for tile in (fs.FLAT_QUERY_TILES if k <= fs.NARROW_MAX_K else (fs.FLAT_WIDE_TILE,)):
            assert (lib.pyrope_scan_smem_bytes(k, tile)
                    == fs.flat_scan_smem_bytes(k, tile)), (k, tile)
            for d in (8, 24, 72, 128, 136, 256, 384, 768):   # the bf16 scan's: by D
                assert (lib.pyrope_flat_tc_smem_bytes(k, tile, d)
                        == fs.flat_scan_smem_bytes(k, tile, 2, d)), (k, tile, d)
    for k in (1, 10, 32, 33, 64, 100, 128):   # the tensor-core list scan's: by D
        for d in (8, 30, 64, 128, 200, 256, 384, 768):
            assert (lib.pyrope_list_tc_smem_bytes(k, d)
                    == fs.list_tc_smem_bytes(k, d) <= fs.SMEM_LIMIT), (k, d)
    for k in (1, 10, 32, 64, 100, 128):   # the promote list scan's: by D, up to its limit
        for d in (1, 8, 30, 96, 128, 129, 200, 256):
            assert (lib.pyrope_list_promote_smem_bytes(k, d)
                    == fs.list_promote_smem_bytes(k, d) <= fs.SMEM_LIMIT), (k, d)
        assert lib.pyrope_list_promote_smem_bytes(k, fs.PROMOTE_MAX_D + 1) == 0
    assert fs.list_scan_smem_bytes(10, fs.LIST_IVF) == 114_944   # two blocks an SM
    assert fs.list_scan_refusal(20_000, fs.LIST_IVF) is None
    assert fs.list_scan_refusal(0, fs.LIST_IVF) is not None


@pytest.mark.cuda
def test_k200_and_d768_routes_answer_on_the_card(cuda_device):
    """Shapes the kernels used to refuse (k above 128, D above ~565 in the
    list scan) run the kernel routes, as in the JAX package: describe_scan
    names them, the wide and large-D modes launch, and the hits equal the
    index's exact route's; explicit 'pallas' answers too."""
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(31)
    for d, k in ((768, 10), (32, 200)):
        scan = "ivf_scan_wide" if k > 128 else "ivf_scan"
        base = rng.normal(size=(4_000, d)).astype(np.float32)
        q = rng.normal(size=(16, d)).astype(np.float32)
        ids = [str(i) for i in range(len(base))]
        ix = IvfFlatIndex(d, "L2", device=cuda_device, nlist=16, nprobe=4)
        ix.add_batch(ids, base)
        ix.build()
        assert ix.describe_scan(16, top_k=k) == "dense-pallas"
        before = fs.LAUNCHES[scan]
        got = ix.search_batch(q, k)
        assert fs.LAUNCHES[scan] == before + 1
        ix.selection = "exact"
        assert_same_results(got, ix.search_batch(q, k))
        ix.selection = "pallas"
        assert_same_results(got, ix.search_batch(q, k))
        pq = IvfPqIndex(d, "L2", device=cuda_device, nlist=16, pq_m=4, nprobe=4)
        pq.add_batch(ids, base)
        pq.build()
        assert pq.describe_scan(16, top_k=k) == "dense-exact-pallas"
        got = pq.search_batch(q, k)
        assert len(got[0]) == k
        assert_same_results(got, pq.search_batch(q, k, SearchOptions(max_scans=3_999)))
    flat = FlatIndex(32, "L2", device=cuda_device, selection="pallas")
    flat.add_batch(ids, base)
    before = fs.LAUNCHES["flat_scan_wide"]
    got = flat.search_batch(q, 200)
    assert fs.LAUNCHES["flat_scan_wide"] == before + 1
    flat.selection = "exact"
    assert_same_results(got, flat.search_batch(q, 200))
    flat.selection = "pallas"
    got = flat.search_batch(q, 20_000)   # above the rows there are: every row
    assert fs.LAUNCHES["flat_scan_wide"] == before + 2
    flat.selection = "exact"
    assert_same_results(got, flat.search_batch(q, 20_000))


@pytest.mark.cuda
def test_bf16_index_routes_launch_their_kernels(cuda_device):
    """Flat bf16 and hybrid, IVF-Flat hybrid and IVF-PQ's bf16 slab on the
    card: each route launches its bf16 kernel and returns the hits of the
    index's fp32 or plain route on the same data, but for k-th place ties."""
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(32)
    base = rng.normal(size=(20_000, 32)).astype(np.float32)
    q = rng.normal(size=(64, 32)).astype(np.float32)
    ids = [str(i) for i in range(len(base))]

    def run(ix, key, batch_q=q):
        before = fs.LAUNCHES[key]
        out = ix.search_batch(batch_q, 10)
        assert fs.LAUNCHES[key] > before, key
        return out

    hyb = FlatIndex(32, "L2", device=cuda_device, selection="hybrid")
    hyb.add_batch(ids, base)
    assert hyb.describe_scan(64) == "flat-pallas-hybrid"
    got = run(hyb, "flat_scan_bf16")
    hyb.selection = "exact"
    assert_same_results(got, hyb.search_batch(q, 10))
    bf, cpu = (FlatIndex(32, "L2", device=dev, storage="bf16", selection="pallas")
               for dev in (cuda_device, "cpu"))
    for ix in (bf, cpu):
        ix.add_batch(ids, base)
    got = run(bf, "flat_scan_bf16")   # against the plain version on the CPU
    assert_hits_but_kth_ties(*_arrays(got), *_arrays(cpu.search_batch(q, 10)))

    ivf = IvfFlatIndex(32, "L2", device=cuda_device, nlist=600, nprobe=20,
                       scan_mode="dense", selection="hybrid")
    ivf.add_batch(ids, base)
    ivf.build()
    assert ivf.describe_scan(64) == "dense-pallas-win-hybrid"
    got = run(ivf, "ivf_scan_bf16_tc")
    wide = np.concatenate([q, rng.normal(size=(1024 - 64, 32)).astype(np.float32)])
    assert ivf.describe_scan(1024) == "dense-pallas-win"
    assert_same_results(got, run(ivf, "ivf_scan", wide)[:64])

    pq = IvfPqIndex(32, "L2", device=cuda_device, nlist=16, pq_m=4, nprobe=4,
                    refine_storage="bf16", train_dtype="bfloat16")
    pq.add_batch(ids, base)
    pq.build()
    assert pq._dev["xraw"].dtype == torch.bfloat16
    assert pq.describe_scan(64) == "dense-exact-pallas"
    got = run(pq, "ivf_scan_bf16_promote")
    plain = pq.search_batch(q, 10, SearchOptions(max_scans=len(base) - 1))
    assert pq.describe_scan(64, max_scans=len(base) - 1) == "dense-exact-xla"
    assert_hits_but_kth_ties(*_arrays(got), *_arrays(plain))


def _arrays(results):
    from _torch_parity import hits_to_arrays

    return hits_to_arrays(results)


# ---- the wide modes (k > 128) and the list scan at large D ------------------

WIDE_KS = [129, 256, 512, 1000, 4096, 10_000]


def _compare(kv, ki, pv, pi, kth_ties, rtol=RTOL):
    """Equal hits; with ``kth_ties`` a hit may differ as a k-th place tie
    (the parity rule: bf16 scores tie often, and the SQ8 scores' scale
    terms round in another order, so at k in the hundreds over a b1024
    batch two rows within rounding of the k-th score do occur)."""
    if kth_ties:
        assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), rtol=rtol)
    else:
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("b", [1, 70, 1024])
@pytest.mark.parametrize("k", WIDE_KS)
def test_flat_wide_vs_plain(cuda_device, k, b, elem):
    n, d = 20_000, 40
    q, x, sq, alive = _flat_inputs(cuda_device, 81, n, b, d, dead=0.05)
    if elem == 2:
        x = x.bfloat16()
    key = "flat_scan_bf16_wide" if elem == 2 else "flat_scan_wide"
    before, merges = fs.LAUNCHES[key], fs.LAUNCHES["merge_wide"]
    kv, ki = fs.fused_flat_topk(q, x, sq, alive, n - 999, k)
    assert fs.LAUNCHES[key] == before + 1 and fs.LAUNCHES["merge_wide"] == merges + 1
    pv, pi = fs.fused_flat_topk_plain(q, x, sq, alive, n - 999, k)
    torch.cuda.synchronize()
    _compare(kv, ki, pv, pi, elem == 2)


def _wide_list_run(dev, mode, case, k, kc=128, metric=Metric.L2):
    """One list-scan launch in ``mode`` (ivf, bf16, bf16p, sq8) and its
    plain version on ``case`` (a list_case)."""
    x, q, sq, alive, crow, probe = (as_tensor(a).to(dev) for a in case)
    offs, lens = (t.to(dev) for t in csr(case[4], kc))
    ml = int(lens.max())
    if mode == "sq8":
        codes, mn, sc, sq8, _, qc = (as_tensor(a).to(dev) for a in sq8_of(case, kc))
        return (fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq8, alive, crow, offs, lens,
                                      probe, qc, kc, k, metric, max_len=ml),
                fs.fused_ivf_sq8_topk_plain(q, codes, mn, sc, sq8, alive, crow, probe,
                                            qc, kc, k, metric))
    xs = x.bfloat16() if mode.startswith("bf16") else x
    promote = mode == "bf16p"
    return (fs.fused_ivf_topk(q, xs, sq, alive, crow, offs, lens, probe, kc, k, metric,
                              max_len=ml, promote_fp32=promote),
            fs.fused_ivf_topk_plain(q, xs, sq, alive, crow, probe, kc, k, metric,
                                    promote_fp32=promote))


_LIST_KEYS = {"ivf": "ivf_scan", "bf16": "ivf_scan_bf16", "bf16p": "ivf_scan_bf16",
              "sq8": "sq8_scan"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "bf16p", "sq8"])
@pytest.mark.parametrize("b", [1, 70, 1024])   # 1, 70: layout B; 1024: layout A
@pytest.mark.parametrize("k", WIDE_KS)
def test_list_scan_wide_vs_plain(cuda_device, k, b, mode):
    case = list_case(83, 20_000, b, 32, 128, 12, big=3000, dead=0.1, dup=True)
    key = _LIST_KEYS[mode] + "_wide"
    before = fs.LAUNCHES[key]
    (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k)
    assert fs.LAUNCHES[key] == before + 1
    torch.cuda.synchronize()
    _compare(kv, ki, pv, pi, mode in ("bf16", "sq8"), SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "bf16p", "sq8"])
@pytest.mark.parametrize("d", [566, 768, 770, 1024, 4096])
def test_list_scan_large_d_vs_plain(cuda_device, d, mode):
    """D above what the list scan once held whole (~565 at k 10), not a
    multiple of 4 or of the depth chunk (770), at k 10 and wide k, both
    layouts (b 3 and b 300 over 16 clusters). Rows and queries lie on a
    grid of 1/8 (exact in bf16), so every product and sum of the IVF and
    BF16 modes is exact in fp32 whatever its order, even over 4096 depths,
    and the hits must be equal, ties by row included; the SQ8 scores add
    rounded scale terms (k-th place ties allowed)."""
    n = 3000 if d == 4096 else 6000
    for b, k in ((3, 10), (300, 10), (300, 200)):
        x, q, _, alive, crow, probe = list_case(85, n, b, d, 16, 4, dead=0.1)
        x, q = np.floor(x * 8) / 8, np.floor(q * 8) / 8
        sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
        case = (x.astype(np.float32), q.astype(np.float32), sq, alive, crow, probe)
        (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k, kc=16)
        torch.cuda.synchronize()
        _compare(kv, ki, pv, pi, mode == "sq8", SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [200, 1000])
def test_wide_launches_are_bit_equal(cuda_device, k):
    q, x, sq, alive = _flat_inputs(cuda_device, 87, 30_000, 70, 64)
    x[129] = x[130] = x[25_000] = x[64]        # exact ties in a tile, across splits
    sq = (x * x).sum(1)
    runs = [fs.fused_flat_topk(q, x, sq, alive, 30_000, k) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    for mode in ("ivf", "sq8", "bf16"):
        case = list_case(89, 20_000, 300, 32, 128, 20, big=3000, dup=True)
        runs = [_wide_list_run(cuda_device, mode, case, k)[0] for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_wide_list_scan_partials_are_sized_by_segment(cuda_device):
    """k 10,000 at 100k rows, nlist 100, nprobe 96, b1024: the partial slots
    hold min(k, seg, max_len) entries, not k; the peak memory of the call
    stays within those partials, the work tables and the [B, k] outputs."""
    n, d, b, kc, nprobe, k = 100_000, 32, 1024, 100, 96, 10_000
    case = list_case(91, n, b, d, kc, nprobe)
    x, q, sq, alive, crow, probe = (as_tensor(a).to(cuda_device) for a in case)
    offs, lens = (t.to(cuda_device) for t in csr(case[4], kc))
    ml = int(lens.max())
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    seg = fs.list_seg(b, nprobe, kc, ml, sms)
    segs = fs.list_grid(b, nprobe, kc, ml, seg)[1]
    width = fs.list_slot_width(k, seg, ml)
    assert width == min(k, seg, ml) < k
    partials = fs.list_slots(b, nprobe, segs, seg, n) * width * 8
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, kc, k, max_len=ml)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    extra = b * k * 8 + 64 * b * nprobe * 8 + (1 << 20)   # outputs, tables, slack
    assert peak <= partials + extra, (peak, partials, extra)
    assert peak < b * nprobe * k * 8 / 4   # a quarter of slots x k
    pv, pi = fs.fused_ivf_topk_plain(q[:64], x, sq, alive, crow, probe[:64], kc, k)
    assert_same_hits(kv[:64].cpu(), ki[:64].cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k,width", [(129, 129), (1000, 1000), (1000, 300), (10_000, 2048),
                                     (64, 20)])
@pytest.mark.parametrize("s", [1, 33, 96])
def test_merge_wide_layouts_vs_plain(cuda_device, s, k, width):
    """The wide merge over [S, B, w] and per-query slots, lists narrower
    than k included: bit-equal to the plain version, ties included."""
    b = 70
    rng = np.random.default_rng(90 + s)
    v = np.sort(rng.integers(0, 400, (s, b, width)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * width) for _ in range(b)], 1).reshape(s, width, b)
    rows = np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)
    pv = torch.from_numpy(np.take_along_axis(np.ascontiguousarray(v), order, 2))
    pi = torch.from_numpy(np.take_along_axis(rows, order, 2))
    pv[s // 2, ::3, width // 2:] = float("-inf")               # lists half filled
    pi[s // 2, ::3, width // 2:] = -1
    mv, mi = fs.merge_partials_plain(pv, pi, k=k)
    before = fs.LAUNCHES["merge_wide"]
    kv, ki = fs.merge_partials(pv.to(cuda_device), pi.to(cuda_device), k=k)
    assert fs.LAUNCHES["merge_wide"] == before + 1
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())
    sv = pv.permute(1, 0, 2).reshape(b * s, width).contiguous()
    si = pi.permute(1, 0, 2).reshape(b * s, width).contiguous()
    qend = (torch.arange(1, b + 1, dtype=torch.int32) * s).view(b, 1)
    kv, ki = fs.merge_partials(sv.to(cuda_device), si.to(cuda_device), qend.to(cuda_device),
                               k=k)
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


# ---- the published floor and the wide merge's gather ------------------------

_FLOOR_MODES = ["ivf", "bf16", "bf16p", "sq8"]


def _grid_case(seed, n, b, d, kc, nprobe, **kw):
    """A list_case on a grid of 1/8 (exact in bf16 and in every fp32 sum), so
    the IVF and BF16 modes must return the plain version's hits exactly,
    ties by row included."""
    x, q, _, alive, crow, probe = list_case(seed, n, b, d, kc, nprobe, **kw)
    x, q = (np.floor(a * 8) / 8 for a in (x, q))
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32), sq, alive, crow, probe


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _FLOOR_MODES)
@pytest.mark.parametrize("b", [3, 300])          # layout B, layout A
@pytest.mark.parametrize("k", [1, 10, 64, 128, 1000, 20_000])
def test_list_scan_floor_every_mode_and_layout_vs_plain(cuda_device, k, b, mode):
    """The list scan with the floor published across a query's slots, in
    every mode and both layouts, narrow and wide (k 20,000: above the rows a
    query probes, padded with -inf/-1), on skewed lists with a row copied
    into two lists (exact ties): the plain version's hits."""
    case = _grid_case(93, 12_000, b, 32, 64, 24, big=2500, dup=True, dead=0.05)
    # bf16 at k <= 128: without promote the tensor-core list scan, with it
    # the bulk-copy one
    key = ("ivf_scan_bf16_tc" if mode == "bf16" and k <= fs.NARROW_MAX_K
           else "ivf_scan_bf16_promote" if mode == "bf16p" and k <= fs.NARROW_MAX_K
           else _LIST_KEYS[mode] + ("_wide" if k > fs.NARROW_MAX_K else ""))
    before = fs.LAUNCHES[key]
    (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k, kc=64)
    assert fs.LAUNCHES[key] == before + 1
    torch.cuda.synchronize()
    assert kv.shape == (b, k)
    _compare(kv, ki, pv, pi, mode == "sq8", SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _FLOOR_MODES)
def test_list_scan_query_with_only_empty_probes(cuda_device, mode):
    """Queries whose probes name only empty lists have no slot at all:
    their rows are all missing hits, and the other queries' are right."""
    x, q, sq, alive, crow, probe = _grid_case(95, 8_000, 200, 32, 64, 4, empty=8)
    probe[::5] = np.arange(4, dtype=np.int32)          # clusters 0..3: empty
    case = (x, q, sq, alive, crow, probe)
    for k in (10, 300):
        (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k, kc=64)
        torch.cuda.synchronize()
        assert (ki[::5] == -1).all() and torch.isinf(kv[::5]).all()
        _compare(kv, ki, pv, pi, mode == "sq8", SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", _FLOOR_MODES)
def test_list_scan_at_nlist_16384(cuda_device, mode):
    """A cluster table of 16,384 lists (once sent to the plain dense route
    on the card): the list scan takes it, in both layouts."""
    kc = 16_384
    for b, nprobe, k in ((64, 8, 10), (1024, 64, 10), (256, 32, 500)):
        case = _grid_case(97, 60_000, b, 16, kc, nprobe)
        (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k, kc=kc)
        torch.cuda.synchronize()
        _compare(kv, ki, pv, pi, mode == "sq8", SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
def test_k20000_and_nlist16384_routes_run_the_kernels(cuda_device):
    """k 20,000 and nlist 16,384 take the kernel routes of Flat, IVF-Flat and
    IVF-PQ on the card (no plain route on a CUDA tensor), and answer as the
    exact routes do; selection='pallas' no longer raises for either."""
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(99)
    base = rng.normal(size=(40_000, 16)).astype(np.float32)
    q = rng.normal(size=(8, 16)).astype(np.float32)
    ids = [str(i) for i in range(len(base))]
    k = 20_000
    flat = FlatIndex(16, "L2", device=cuda_device, selection="pallas")
    flat.add_batch(ids, base)
    assert flat.describe_scan(8, top_k=k) == "flat-pallas"
    before = fs.LAUNCHES["flat_scan_wide"]
    got = flat.search_batch(q, k)
    assert fs.LAUNCHES["flat_scan_wide"] == before + 1 and len(got[0]) == k
    flat.selection = "exact"
    assert_same_results(got, flat.search_batch(q, k))
    for nlist, route in ((16, "dense-pallas"), (16_384, "dense-pallas-win")):
        ix = IvfFlatIndex(16, "L2", device=cuda_device, nlist=nlist, nprobe=nlist // 2,
                          scan_mode="dense", selection="pallas")
        ix.add_batch(ids, base)
        ix.build()
        assert ix.describe_scan(8, top_k=k) == route
        before = fs.LAUNCHES["ivf_scan_wide"]
        got = ix.search_batch(q, k)
        assert fs.LAUNCHES["ivf_scan_wide"] == before + 1
        ix.selection = "exact"
        assert ix.describe_scan(8, top_k=k) == "dense-xla"
        assert_same_results(got, ix.search_batch(q, k))
    pq = IvfPqIndex(16, "L2", device=cuda_device, nlist=16_384, pq_m=4, nprobe=8_192)
    pq.add_batch(ids, base)
    pq.build()
    assert pq.describe_scan(8, top_k=k) == "dense-exact-pallas-win"
    before = fs.LAUNCHES["ivf_scan_wide"]
    got = pq.search_batch(q, k)
    assert fs.LAUNCHES["ivf_scan_wide"] == before + 1
    assert_same_results(got, pq.search_batch(q, k, SearchOptions(max_scans=len(base) - 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("k,width,s", [(20_000, 8_000, 3), (12_000, 600, 33),
                                       (300, 300, 400), (5, 3, 40)])
def test_merge_wide_gather_and_in_place_paths_vs_plain(cuda_device, k, width, s):
    """The wide merge's two paths: the gathered prefixes sorted once, and,
    where they outgrow the run buffer (k 20,000 over three 8,000-entry
    lists), the in-place rank merge behind the floor; more lists than the
    floor reads (400); lists shorter than c; all-padding lists; ties
    across lists; k above the entries present. Bit-equal to the plain
    version."""
    b = 6
    rng = np.random.default_rng(s + width)
    v = np.sort(rng.integers(0, 50, (s, b, width)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * width) for _ in range(b)], 1).reshape(s, width, b)
    rows = np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)
    pv = torch.from_numpy(np.take_along_axis(np.ascontiguousarray(v), order, 2))
    pi = torch.from_numpy(np.take_along_axis(rows, order, 2))
    pv[::2, 1, width // 3:] = float("-inf")               # short lists
    pi[::2, 1, width // 3:] = -1
    pv[:, 2], pi[:, 2] = float("-inf"), -1                # a query with no entry
    pv[1, 3], pi[1, 3] = float("-inf"), -1                # an all-padding list
    mv, mi = fs.merge_partials_plain(pv, pi, k=k)
    before = fs.LAUNCHES["merge_wide"]
    kv, ki = fs.merge_partials(pv.to(cuda_device), pi.to(cuda_device), k=k)
    assert fs.LAUNCHES["merge_wide"] == before + 1
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


# ---- the bf16 flat scan on the tensor cores (csrc/flat_scan_tc.cu) ----------

TC_DS = [8, 24, 72, 128, 136, 768]   # TMA (D % 8 == 0) with a depth tail; q streamed at 768
TC_BS = [1, 63, 64, 65, 1000]        # the 64-query block, the 128-query one, padding queries
TC_KS = [1, 10, 32, 128, 129, 512]   # register lists (<= 32), shared-memory lists, wide


@pytest.mark.cuda
@pytest.mark.parametrize("d", TC_DS)
@pytest.mark.parametrize("b", TC_BS)
def test_flat_tc_shapes_vs_plain(cuda_device, d, b):
    """Every k of TC_KS in both metrics, 10% dead rows, max_scans cut
    inside a row tile: the plain version's hits but for k-th place ties."""
    n = 6_001
    q, x, sq, alive = _bf16_flat_inputs(cuda_device, 300 + d, n, b, d, dead=0.1)
    ms = n - 77
    for k in TC_KS:
        key = "flat_scan_bf16_wide" if k > fs.NARROW_MAX_K else "flat_scan_bf16"
        for metric in (Metric.L2, Metric.INNER_PRODUCT):
            before = fs.LAUNCHES[key]
            kv, ki = fs.fused_flat_topk(q, x, sq, alive, ms, k, metric)
            assert fs.LAUNCHES[key] == before + 1
            pv, pi = fs.fused_flat_topk_plain(q, x, sq, alive, ms, k, metric)
            torch.cuda.synchronize()
            assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
            assert (ki[:, :min(k, ms)] < ms).all()


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 136, 768])
@pytest.mark.parametrize("k", [10, 512])
def test_flat_tc_unaligned_base_and_bit_equal_launches(cuda_device, d, k):
    """A slab whose base is not 16-byte aligned is staged by plain loads
    into the layout TMA writes: the same products in the same order, so the
    same hits bit for bit; and repeated launches of either are bit-equal."""
    n, b = 9_000, 130
    q, x, sq, alive = _bf16_flat_inputs(cuda_device, 61, n, b, d, dead=0.05)
    xo = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    xo = xo.view_as(x).copy_(x)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    runs = [fs.fused_flat_topk(q, slab, sq, alive, n, k) for slab in (x, x, xo, xo)]
    torch.cuda.synchronize()
    for v, i in runs[1:]:
        assert torch.equal(v, runs[0][0]) and torch.equal(i, runs[0][1])
    pv, pi = fs.fused_flat_topk_plain(q, x, sq, alive, n, k)
    assert_hits_but_kth_ties(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
def test_bf16_flat_scan_runs_on_wgmma(cuda_device):
    """The built library's SASS: every instantiation of the bf16 flat scan
    issues HGMMA, and the fp32 scan's fused_scan_kernel has no bf16 (or any
    type-parameterised) instantiation left."""
    from pyrope_tpu_torch.kernels.build import library_path, load

    load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path())], capture_output=True,
                          text=True, check=True).stdout
    funcs = {part.split()[0]: part for part in re.split(r"Function : ", sass)[1:]}
    tc = [body for name, body in funcs.items() if "flat_scan_tc_kernel" in name]
    assert len(tc) == 6 and all("HGMMA.64x128x16.F32.BF16" in body for body in tc)
    fused = [name for name in funcs if "fused_scan_kernel" in name]
    # <64|128, IP>, the wide <64, IP> and the wide behind a first pass's
    # floor <64, IP, true, 64>, fp32 only
    assert len(fused) == 8
    assert all(re.search(r"fused_scan_kernelI(?:L[a-z]+\d+E)+E", name) for name in fused)


# ---- the wide modes' first pass: a floor before any row is kept -------------


def _grid_flat(dev, seed, n, b, d, dead=0.05):
    """Flat inputs on a grid of 1/8 (every fp32 sum exact in any order), so
    the kernels must return the plain version's hits, ties by row included."""
    q, x, _, alive = _flat_inputs(dev, seed, n, b, d, dead=dead)
    q, x = torch.floor(q * 8) / 8, torch.floor(x * 8) / 8
    return q, x, (x * x).sum(1), alive


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("shape", ["spread", "one_split", "dups"])
@pytest.mark.parametrize("b,k", [(1, 300), (70, 1000), (1024, 200), (64, 4096)])
def test_flat_prefloor_two_pass_vs_plain(cuda_device, b, k, shape, metric):
    """The wide fp32 flat scan with its first pass (the host rule runs it at
    these shapes) against the plain version: hits spread over the splits,
    every hit in one split (rows near the queries copied into split 0's
    first rows), duplicate rows across splits; 5% dead rows."""
    n, d = 24_000, 24
    q, x, sq, alive = _grid_flat(cuda_device, 97, n, b, d)
    if shape == "one_split":
        near = q[torch.arange(min(k, 3000), device=cuda_device) % b]
        x[:near.shape[0]] = near + 0.125
    elif shape == "dups":
        x[n // 2:n // 2 + 2000] = x[:2000]
    sq = (x * x).sum(1)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fs.flat_prefloor_plan(k, b, d, n, sms)
    assert plan is not None and plan.g * plan.c >= k
    before = dict(fs.LAUNCHES)
    kv, ki = fs.fused_flat_topk(q, x, sq, alive, n, k, metric)
    assert fs.LAUNCHES["flat_scan_prefloor"] == before["flat_scan_prefloor"] + 1
    assert fs.LAUNCHES["floor_select"] == before["floor_select"]   # in the pass's launch
    assert fs.LAUNCHES["flat_scan_wide"] == before["flat_scan_wide"] + 1
    pv, pi = fs.fused_flat_topk_plain(q, x, sq, alive, n, k, metric)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), pv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_flat_prefloor_floors_bit_equal_second_pass_scores(cuda_device, metric):
    """The first pass's floors against the second pass's own scores: a wide
    launch at k = n returns every row's second-pass score; the split floors
    computed from those (the plain rule) equal the first pass's floors bit
    for bit, so no row of the g * c that make a floor scores under it."""
    n, b, d = 3000, 40, 37   # D % 4 != 0: the plain-load staging too
    q, x, sq, alive = _flat_inputs(cuda_device, 98, n, b, d, dead=0.05)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fs.flat_prefloor_plan(600, b, d, n, sms)
    assert plan is not None
    plan = fs.FlatPrefloor(plan.tile, plan.per, plan.splits, plan.per, plan.c, plan.g)
    got = fs.flat_prefloor(q, x, sq, alive, n, plan, metric)
    kv, ki = fs.fused_flat_topk(q, x, sq, alive, n, n, metric)   # every alive row
    scores = torch.full((b, n), float("-inf"), device=cuda_device)
    ok = ki >= 0
    scores[torch.nonzero(ok)[:, 0], ki[ok].long()] = kv[ok]
    want = fs.split_floor_plain(scores, alive, plan)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    pv = fs.flat_prefloor_plain(q, x, sq, alive, n, plan, metric)
    np.testing.assert_allclose(got.cpu().numpy(), pv.cpu().numpy(), rtol=RTOL, atol=1e-4)


def _list_work(dev, case, kc, k, mode):
    """The list scan's inputs on the card and the layout list_partials makes."""
    x, q, sq, alive, crow, probe = (as_tensor(a).to(dev) for a in case)
    offs, lens = (t.to(dev) for t in csr(case[4], kc))
    ml = int(lens.max())
    sq8 = None
    if mode == "sq8":
        codes, mn, sc, sq8v, _, qc = (as_tensor(a).to(dev) for a in sq8_of(case, kc))
        x, sq, sq8 = codes, sq8v, (mn, sc, qc)
    elif mode.startswith("bf16"):
        x = x.bfloat16()
    return q, x, sq, alive, offs, lens, probe, ml, sq8


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "bf16p", "sq8"])
@pytest.mark.parametrize("b", [3, 300])   # layout B, layout A
@pytest.mark.parametrize("k", [200, 1000])
def test_list_prefloor_two_pass_vs_plain(cuda_device, k, b, mode):
    """The wide list scan with its first pass, every mode, both layouts, on
    a skewed list holding the hits of half the queries (a 4000-row list
    probed by every second query), a row copied into two lists, 5% dead
    rows and probed empty lists: the plain version's hits (ties by row
    included on the grid of 1/8; SQ8 to its tolerance)."""
    case = _grid_case(99, 16_000, b, 32, 64, 24, big=4000, dup=True, dead=0.05, empty=2)
    q, x, sq, alive, offs, lens, probe, ml, sq8 = _list_work(cuda_device, case, 64, k, mode)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    seg = fs.list_seg(b, 24, 64, ml, sms)
    kw = fs.list_slot_width(k, seg, ml)
    plan = fs.list_prefloor_plan(k, 24, kw, seg, x.shape[0] / 64)
    assert plan is not None
    key = _LIST_KEYS[mode] + "_wide"
    before = dict(fs.LAUNCHES)
    (kv, ki), (pv, pi) = _wide_list_run(cuda_device, mode, case, k, kc=64)
    assert fs.LAUNCHES["list_scan_prefloor"] == before["list_scan_prefloor"] + 1
    assert fs.LAUNCHES["floor_select"] == before["floor_select"] + 1
    assert fs.LAUNCHES[key] == before[key] + 1
    torch.cuda.synchronize()
    _compare(kv, ki, pv, pi, mode == "sq8", SQ8_RTOL if mode == "sq8" else RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "bf16p", "sq8"])
@pytest.mark.parametrize("b", [3, 300])
def test_list_prefloor_keys_bit_equal_second_pass_scores(cuda_device, b, mode):
    """Every slot key the first pass publishes is bit-equal to the second
    pass's score of the same (query, row): a wide launch at k above every
    probed row returns each row's second-pass score."""
    kc, nprobe = 64, 24
    case = list_case(100, 6_000, b, 20, kc, nprobe, dead=0.05)
    q, x, sq, alive, offs, lens, probe, ml, sq8 = _list_work(cuda_device, case, kc, 200, mode)
    promote = mode == "bf16p"
    # the layout of a wide call (k 200, as the second pass's k 6,000: one
    # segment rule), its narrow launch at k = c over whole segments
    job = fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 200, False, ml, sq8, promote)
    assert not job.plan.tc
    w, c = job.work, 8
    first = torch.zeros(w.slots + b, dtype=torch.int64, device=cuda_device)
    job.launch(c, c, None, None, first, c, 64, job.plan.seg)
    k = 6_000   # every probed row
    if mode == "sq8":
        kv, ki = fs.fused_ivf_sq8_topk(q, x, *sq8[:2], sq, alive, as_tensor(case[4]).to(
            cuda_device), offs, lens, probe, sq8[2], kc, k, max_len=ml)
    else:
        kv, ki = fs.fused_ivf_topk(q, x, sq, alive, as_tensor(case[4]).to(cuda_device), offs,
                                   lens, probe, kc, k, max_len=ml, promote_fp32=promote)
    keys = first[:w.slots]
    qoff = torch.nn.functional.pad(w.slot_end[:, -1].long(), (1, 0))
    owner = torch.searchsorted(qoff, torch.arange(w.slots, device=cuda_device), right=True) - 1
    v, r = fs.entry_of(keys)
    has = keys != 0
    assert int(has.sum()) > b   # most slots published
    # the second pass's score of (owner, r): find r in the owner's returned rows
    hit = ki[owner[has]] == r[has][:, None]
    assert bool(hit.any(1).all())
    second = kv[owner[has]][hit]
    torch.cuda.synchronize()
    assert torch.equal(second.view(torch.int32), v[has].view(torch.int32))


@pytest.mark.cuda
def test_prefloor_host_rule_matches_launches(cuda_device):
    """The host rule's choice, from shapes alone, is what runs: the first
    pass launches exactly where flat_prefloor_plan / list_prefloor_plan give
    a plan (narrow k, nprobe 3 and a small corpus do not run it)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, b, k in ((24_000, 70, 1000), (24_000, 70, 100), (300, 5, 200), (24_000, 1, 129)):
        q, x, sq, alive = _flat_inputs(cuda_device, 101, n, b, 16)
        before = fs.LAUNCHES["flat_scan_prefloor"]
        fs.fused_flat_topk(q, x, sq, alive, n, k)
        ran = fs.LAUNCHES["flat_scan_prefloor"] - before
        assert ran == (fs.flat_prefloor_plan(k, b, 16, n, sms) is not None), (n, b, k)
    for nprobe, k in ((24, 300), (3, 300), (24, 64)):
        case = list_case(102, 8_000, 40, 16, 64, nprobe)
        q, x, sq, alive, offs, lens, probe, ml, _ = _list_work(cuda_device, case, 64, k, "ivf")
        seg = fs.list_seg(40, nprobe, 64, ml, sms)
        plan = fs.list_prefloor_plan(k, nprobe, fs.list_slot_width(k, seg, ml), seg,
                                     x.shape[0] / 64)
        before = fs.LAUNCHES["list_scan_prefloor"]
        _wide_list_run(cuda_device, "ivf", case, k, kc=64)
        ran = fs.LAUNCHES["list_scan_prefloor"] - before
        assert ran == (plan is not None), (nprobe, k)
        assert (plan is not None) == (k > fs.NARROW_MAX_K and nprobe >= 16)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("b,k,grid", [(70, 1000, True), (1, 300, False), (1024, 200, True),
                                      (64, 4096, False)])
def test_flat_first_pass_floors_equal_the_plain_select(cuda_device, b, k, grid, metric):
    """The flat first pass takes its floors in its own launch (the split that
    completes a query tile selects): bit-equal to floor_select_plain over the
    scores its splits published, whatever order the splits ended in; rows on
    a grid of 1/8 (equal scores across splits, counted with their
    multiplicity) or random; splits that publish nothing (-inf)."""
    n, d = 24_000, 24
    q, x, sq, alive = (_grid_flat(cuda_device, 105, n, b, d) if grid
                       else _flat_inputs(cuda_device, 105, n, b, d, dead=0.05))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = fs.flat_prefloor_plan(k, b, d, n, sms)
    assert plan is not None
    for g in (plan.g, 1, plan.splits, plan.splits + 1):   # the last: fewer than g
        plan_g = fs.FlatPrefloor(plan.tile, plan.per, plan.splits, plan.rows, plan.c, g)
        for _ in range(3):   # block orders differ from launch to launch
            floors, pub = fs.flat_prefloor(q, x, sq, alive, n, plan_g, metric, published=True)
            torch.cuda.synchronize()
            assert torch.equal(floors, fs.floor_select_plain(pub, g)), g


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "bf16_tc", "sq8"])
@pytest.mark.parametrize("b", [3, 300])
def test_list_first_pass_floors_equal_the_plain_select(cuda_device, b, mode):
    """Every list first pass (the CUDA-core kernel's in each mode, the
    tensor-core kernel's) and the floor select kernel after it: bit-equal
    to floor_select_plain over the keys the slots published and the pass's
    own floor keys (base), at the plan's g and at g above the slots some
    queries have (none), on a skewed list, probed empty lists and dead
    rows; a base above the selection wins."""
    kc, nprobe = 64, 24
    case = _grid_case(106, 16_000, b, 32, kc, nprobe, big=3000, dup=True, dead=0.05,
                      empty=2)
    q, x, sq, alive, offs, lens, probe, ml, sq8 = _list_work(
        cuda_device, case, kc, 400, "bf16" if mode == "bf16_tc" else mode)
    k = 64 if mode == "bf16_tc" else 400
    before = dict(fs.LAUNCHES)
    for _ in range(2):
        floors, plan, (keys, slot_end) = fs.list_prefloor(
            q, x, sq, alive, offs, lens, probe, kc, k, False, ml, sq8=sq8, published=True)
        torch.cuda.synchronize()
        slots = keys.shape[0] - b
        want = fs.floor_select_plain(keys[:slots], plan.g, slot_end, keys[slots:])
        assert torch.equal(floors, want)
    key = "list_scan_prefloor_tc" if mode == "bf16_tc" else "list_scan_prefloor"
    assert fs.LAUNCHES[key] == before[key] + 2
    assert fs.LAUNCHES["floor_select"] == before["floor_select"] + 2
    # other g, and a base above some selections: written into the pass's own
    # floor keys before it runs (its rows must beat them, and the select
    # raises to them)
    base = fs.key_of(torch.full((b,), -1.0, device=cuda_device),
                     torch.arange(b, dtype=torch.int32, device=cuda_device))
    base[::2] = 0
    for g in (plan.g, 200):
        job = fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, k, False, ml, sq8, False)
        w = job.work
        job.first[w.slots:].copy_(base)
        got = job.first_pass(fs.ListPrefloor(plan.c, g, plan.sample))
        torch.cuda.synchronize()
        keys = job.first
        assert torch.equal(got, fs.floor_select_plain(keys[:w.slots], g, w.slot_end,
                                                      keys[w.slots:])), g


@pytest.mark.cuda
def test_floor_select_kernel_vs_plain(cuda_device):
    """The list floor select kernel (csrc/prefloor.cu) bit-equal to its
    plain version: key slots of uneven counts (none at all for some
    queries, 300 and 2,500 for others: keys read from L2 past 256 a
    query, and the first 2,048 only), equal scores told apart by row, base
    keys, g above the keys there are."""
    rng = np.random.default_rng(103)
    cnt = rng.integers(0, 120, 70)
    cnt[::9] = 0
    cnt[5], cnt[6] = 300, 2500
    qend = torch.from_numpy(np.cumsum(cnt).astype(np.int32)).view(70, 1)
    v = torch.from_numpy(rng.integers(-40, 40, int(cnt.sum())).astype(np.float32))
    r = torch.from_numpy(rng.permutation(int(cnt.sum())).astype(np.int32))
    keys = fs.key_of(v, r)
    keys[::5] = 0
    base = fs.key_of(torch.from_numpy(rng.integers(-40, 40, 70).astype(np.float32)),
                     torch.arange(70, dtype=torch.int32))
    base[::2] = 0
    before = fs.LAUNCHES["floor_select"]
    for g in (1, 5, 60, 119, 290, 2048, 2049):
        for bv in (base, None):
            got = fs.floor_select_list(keys.to(cuda_device), g, qend.to(cuda_device),
                                       None if bv is None else bv.to(cuda_device))
            assert torch.equal(got.cpu(), fs.floor_select_plain(keys, g, qend, bv)), g
    assert fs.LAUNCHES["floor_select"] == before + 14


# ---- the bf16 list scan with promote (csrc/ivf_list_scan_promote.cu) --------


def _promote_run(dev, case, k, kc, metric=Metric.L2, slab=None):
    """One bf16 list scan with promote (the bulk-copy kernel, counted once)
    and its plain version on ``case``."""
    x, q, sq, alive, crow, probe = (as_tensor(a).to(dev) for a in case)
    offs, lens = (t.to(dev) for t in csr(case[4], kc))
    x16 = x.bfloat16() if slab is None else slab
    before = dict(fs.LAUNCHES)
    got = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, kc, k, metric,
                            max_len=int(lens.max()), promote_fp32=True)
    key = ("ivf_scan_bf16_promote" if q.shape[1] <= fs.PROMOTE_MAX_D else "ivf_scan_bf16")
    for other in ("ivf_scan_bf16", "ivf_scan_bf16_promote", "ivf_scan_bf16_tc"):
        assert fs.LAUNCHES[other] == before[other] + (other == key), other
    plain = fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, kc, k, metric,
                                    promote_fp32=True)
    torch.cuda.synchronize()
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("d", [96, 128, 768])   # 768: above the limit, the CUDA-core kernel
@pytest.mark.parametrize("b", [1, 64, 1000])
def test_list_promote_vs_plain(cuda_device, b, d, metric):
    """k 1, 10 and 128; a 50,000-row list probed by every second query,
    probed empty lists, 30% dead rows, a row copied into two lists: the
    plain version's hits but for k-th place ties, scores to RTOL."""
    n = 80_000 if d <= 128 else 60_000
    case = list_case(120 + d, n, b, d, 100, 3, big=50_000, empty=3, dead=0.3, dup=True)
    for k in (1, 10, 128):
        (kv, ki), (pv, pi) = _promote_run(cuda_device, case, k, 100, metric)
        assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("b,nprobe", [(70, 9), (300, 40)])   # chunks of 1-64 queries
@pytest.mark.parametrize("k", [10, 33, 128])                 # g = 1, and a window's floor
def test_list_promote_chunks_and_floors_on_the_grid(cuda_device, b, nprobe, k):
    """On a grid of 1/8 (every sum exact in any order) the kernel returns the
    plain version's hits exactly, ties by row included: chunks from 1 to 64
    queries a list (teams of warps and their merge, two groups a warp above
    32 queries), the floor from a window of slots (k >= 32, nprobe >= 8)."""
    case = _grid_case(121, 16_000, b, 32, 40, nprobe, big=3000, dup=True, dead=0.05)
    (kv, ki), (pv, pi) = _promote_run(cuda_device, case, k, 40)
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), pv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 128, 256])   # 100: D % 8 != 0, plain loads
@pytest.mark.parametrize("seg", [256, 2048])
def test_list_promote_unaligned_segments_and_bit_equal_launches(cuda_device, monkeypatch,
                                                                 d, seg):
    """A slab whose base is not 16-byte aligned is copied by plain loads
    into the layout the bulk copies write: the same products in the same
    order, so the same hits bit for bit; repeated launches are bit-equal;
    short and long segments (the blocks walk many items, or few)."""
    for name in ("PROMOTE_SEG_MAX", "PROMOTE_SEG_MIN"):
        monkeypatch.setattr(fs, name, seg)
    case = list_case(122, 9_000, 130, d, 32, 5, dead=0.05, dup=True, big=2000)
    x16 = as_tensor(case[0]).to(cuda_device).bfloat16()
    xo = torch.empty(x16.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    xo = xo.view_as(x16).copy_(x16)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    runs = [_promote_run(cuda_device, case, 10, 32, slab=slab) for slab in (x16, x16, xo, xo)]
    for (v, i), _ in runs[1:]:
        assert torch.equal(v, runs[0][0][0]) and torch.equal(i, runs[0][0][1])
    (kv, ki), (pv, pi) = runs[0]
    assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ivf", "bf16", "sq8"])
def test_list_prefloor_vs_plain(cuda_device, mode):
    """The list scan's first pass alone (``fs.list_prefloor``: the narrow
    launch and the floor select) names each query's floor of the plain
    version (``list_prefloor_plain`` on dense scores), on the grid of 1/8
    where every score is exact."""
    kc, nprobe, b = 64, 24, 300
    case = _grid_case(104, 16_000, b, 32, kc, nprobe, big=3000, dead=0.05)
    q, x, sq, alive, offs, lens, probe, ml, sq8 = _list_work(cuda_device, case, kc, 400, mode)
    keys, plan = fs.list_prefloor(q, x, sq, alive, offs, lens, probe, kc, 400, False, ml,
                                  sq8=sq8)
    assert plan is not None
    crow = as_tensor(case[4]).to(cuda_device)
    if mode == "sq8":
        scores = fs.sq8_scores(q, sq8[2], x, sq8[0], sq8[1], sq, crow, False)
    else:
        qd = q.bfloat16().float() if mode == "bf16" else q
        scores = fs._l2_or_ip(q, qd @ x.float().T, sq, False)
    # the segments of the kernel the call took (the tensor-core list scan
    # has a segment rule of its own)
    seg = fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, 400, False, ml, sq8,
                      False).plan.seg
    want = fs.list_prefloor_plain(scores, alive, crow, offs, lens, probe, seg, plan)
    torch.cuda.synchronize()
    gv, gr = fs.entry_of(keys)
    wv, wr = fs.entry_of(want)
    if mode == "sq8":   # scale terms round in another order
        np.testing.assert_allclose(gv.cpu().numpy(), wv.cpu().numpy(), rtol=SQ8_RTOL,
                                   atol=1e-4)
    else:
        assert torch.equal(keys, want)


# ---- the bf16 list scan on the tensor cores (csrc/ivf_list_scan_tc.cu) -------

LT_KS = [1, 10, 32, 33, 64, 128]   # register lists (<= 32), shared-memory lists


def _tc_run(dev, case, k, kc, metric=Metric.L2, slab=None):
    """One bf16 list scan without promote at k <= 128 (the tensor-core
    kernel, counted once) and its plain version on ``case``, summed exactly
    (``ivf_plain_exact``)."""
    x, q, sq, alive, crow, probe = (as_tensor(a).to(dev) for a in case)
    offs, lens = (t.to(dev) for t in csr(case[4], kc))
    x16 = x.bfloat16() if slab is None else slab
    key = "ivf_scan_bf16_tc"
    before = dict(fs.LAUNCHES)
    got = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, kc, k, metric,
                            max_len=int(lens.max()))
    assert fs.LAUNCHES[key] == before[key] + 1
    assert fs.LAUNCHES["ivf_scan_bf16"] == before["ivf_scan_bf16"]
    plain = ivf_plain_exact(q, x16, sq, alive, crow, probe, kc, k, metric)
    torch.cuda.synchronize()
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("d", [8, 30, 100, 128, 256, 384])   # 30, 100: plain-load staging;
@pytest.mark.parametrize("b", [1, 5, 70, 300])               # 384: q streamed
def test_list_tc_vs_plain(cuda_device, b, d, metric):
    """Every k of LT_KS, chunks of 1 to 64 queries (b 1 to 300 over 40
    lists at nprobe 9), a 3000-row list (segment ends inside
    a TMA box), a row copied into two lists, 10% dead rows, empty lists
    probed: the plain version's hits but for k-th place ties."""
    case = list_case(110 + d, 12_000, b, d, 40, 9, big=3000, empty=2, dead=0.1, dup=True)
    for k in LT_KS:
        (kv, ki), (pv, pi) = _tc_run(cuda_device, case, k, 40, metric)
        assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 64, 128])
def test_list_tc_on_the_grid_is_exact(cuda_device, k):
    """Rows and queries on a grid of 1/8 (exact in bf16 and in every fp32
    sum): the kernel returns the plain version's hits exactly, ties by row
    included, at nprobe 24 (the first pass runs) and at nprobe 4 (none)."""
    for nprobe, b in ((24, 300), (4, 70)):
        case = _grid_case(111, 16_000, b, 32, 64, nprobe, big=3000, dup=True, dead=0.05)
        (kv, ki), (pv, pi) = _tc_run(cuda_device, case, k, 64)
        np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())
        np.testing.assert_array_equal(kv.cpu().numpy(), pv.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [512, 2048])
def test_list_tc_segments_end_inside_a_box(cuda_device, monkeypatch, seg):
    """Segments cut at LIST_TC_SEG_MIN (512 rows: four boxes) and at 2048,
    lists of 700-3000 rows whose ends fall inside a 128-row TMA box (the
    next list's rows there are masked): the plain version's hits."""
    for name in ("LIST_SEG", "LIST_SEG_MIN", "LIST_TC_SEG_MIN"):
        monkeypatch.setattr(fs, name, seg)
    case = _grid_case(112, 20_000, 200, 64, 16, 6, big=3000, dead=0.05)
    for k in (10, 128):
        (kv, ki), (pv, pi) = _tc_run(cuda_device, case, k, 16)
        np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 136, 768])
@pytest.mark.parametrize("k", [10, 100])
def test_list_tc_unaligned_base_and_bit_equal_launches(cuda_device, d, k):
    """A slab whose base is not 16-byte aligned is staged by plain loads
    into the layout TMA writes: the same products in the same order, so the
    same hits bit for bit; and repeated launches of either are bit-equal."""
    case = list_case(113, 9_000, 130, d, 32, 12, dead=0.05, dup=True)
    x16 = as_tensor(case[0]).to(cuda_device).bfloat16()
    xo = torch.empty(x16.numel() + 1, dtype=torch.bfloat16, device=cuda_device)[1:]
    xo = xo.view_as(x16).copy_(x16)
    assert xo.data_ptr() % 16 != 0 and xo.is_contiguous()
    runs = [_tc_run(cuda_device, case, k, 32, slab=slab) for slab in (x16, x16, xo, xo)]
    for (v, i), _ in runs[1:]:
        assert torch.equal(v, runs[0][0][0]) and torch.equal(i, runs[0][0][1])
    (kv, ki), (pv, pi) = runs[0]
    assert_hits_but_kth_ties(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("nprobe,k", [(24, 64), (24, 128), (4, 10), (4, 64)])
def test_list_tc_first_pass_runs_where_the_host_rule_says(cuda_device, nprobe, k):
    """The tensor-core list scan's first pass (a launch of it at k = c and
    the floor select) runs where list_prefloor_plan(tc=True) gives a plan:
    from nprobe 16, and never at nprobe 4; the promote mode keeps the
    CUDA-core kernel's rule (wide k only)."""
    case = list_case(114, 8_000, 40, 16, 64, nprobe)
    q, x, sq, alive, offs, lens, probe, ml, _ = _list_work(cuda_device, case, 64, k, "bf16")
    job = fs._ListJob(q, x, sq, alive, offs, lens, probe, 64, k, False, ml, None, False)
    plan = job.prefloor()
    assert (plan is not None) == (nprobe >= 16)
    before = dict(fs.LAUNCHES)
    _tc_run(cuda_device, case, k, 64)
    assert fs.LAUNCHES["list_scan_prefloor_tc"] - before["list_scan_prefloor_tc"] == (
        plan is not None)
    assert fs.LAUNCHES["list_scan_prefloor"] == before["list_scan_prefloor"]
    assert fs.LAUNCHES["floor_select"] - before["floor_select"] == (plan is not None)
    promoted = fs._ListJob(q, x, sq, alive, offs, lens, probe, 64, k, False, ml, None, True)
    assert not promoted.plan.tc
    assert (promoted.prefloor() is not None) == (nprobe >= 16 and k > fs.NARROW_MAX_K)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
@pytest.mark.parametrize("b", [3, 300])
def test_list_tc_first_pass_keys_bit_equal_second_pass_scores(cuda_device, b, metric):
    """Every slot key the tensor-core first pass publishes (its launch at
    k = c over whole segments) is bit-equal to the main pass's score of the
    same (query, row): lists of ~16 rows at nprobe 4, so a k 128 scan
    returns every probed alive row of a query; D 40 (plain loads) and 64
    (TMA)."""
    kc, nprobe, k = 64, 4, 128
    for d in (40, 64):
        case = list_case(115, 1_000, b, d, kc, nprobe, dead=0.05)
        q, x, sq, alive, offs, lens, probe, ml, _ = _list_work(cuda_device, case, kc, k, "bf16")
        job = fs._ListJob(q, x, sq, alive, offs, lens, probe, kc, k, metric == Metric.INNER_PRODUCT,
                          ml, None, False)
        assert job.plan.tc
        w, c = job.work, 8
        first = torch.zeros(w.slots + b, dtype=torch.int64, device=cuda_device)
        job.launch(c, c, None, None, first, c, 64, job.plan.seg)
        kv, ki = fs.fused_ivf_topk(q, x, sq, alive, as_tensor(case[4]).to(cuda_device), offs,
                                   lens, probe, kc, k, metric, max_len=ml)
        assert int((ki >= 0).sum(1).max()) < k   # every probed alive row returned
        keys = first[:w.slots]
        qoff = torch.nn.functional.pad(w.slot_end[:, -1].long(), (1, 0))
        owner = torch.searchsorted(qoff, torch.arange(w.slots, device=cuda_device),
                                   right=True) - 1
        v, r = fs.entry_of(keys)
        has = keys != 0
        assert int(has.sum()) > b
        hit = ki[owner[has]] == r[has][:, None]
        assert bool(hit.any(1).all())
        second = kv[owner[has]][hit]
        torch.cuda.synchronize()
        assert torch.equal(second.view(torch.int32), v[has].view(torch.int32))


@pytest.mark.cuda
def test_list_tc_runs_on_wgmma(cuda_device):
    """The built library's SASS: every instantiation of the tensor-core list
    scan (<IP, SPLIT>) issues HGMMA."""
    from pyrope_tpu_torch.kernels.build import library_path, load

    load()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(library_path())], capture_output=True,
                          text=True, check=True).stdout
    funcs = {part.split()[0]: part for part in re.split(r"Function : ", sass)[1:]}
    tc = [body for name, body in funcs.items() if "ivf_list_scan_tc_kernel" in name]
    # <IP, SPLIT>: SPLIT sums each 64-depth chunk apart (D > 128)
    assert len(tc) == 4 and all("HGMMA.64x128x16.F32.BF16" in body for body in tc)


@pytest.mark.cuda
@pytest.mark.parametrize("k,width,s", [(1000, 100, 264), (10_000, 120, 264), (300, 40, 33)])
def test_merge_wide_bisected_floor_vs_plain(cuda_device, k, width, s):
    """More entries at or above the wide merge's level floor than its run
    buffer takes, with k inside it (the wide flat scan's partials behind a
    first pass's floor): the merge bisects for a higher floor and gathers;
    bit-equal to the plain version, ties across lists included."""
    b = 5
    rng = np.random.default_rng(105 + s)
    v = np.sort(rng.integers(0, 2000, (s, b, width)).astype(np.float32), axis=2)[:, :, ::-1]
    rows = np.stack([rng.permutation(s * width) for _ in range(b)], 1).reshape(s, width, b)
    rows = np.ascontiguousarray(rows.transpose(0, 2, 1)).astype(np.int32)
    order = np.lexsort((rows, -v), axis=2)
    pv = torch.from_numpy(np.take_along_axis(np.ascontiguousarray(v), order, 2))
    pi = torch.from_numpy(np.take_along_axis(rows, order, 2))
    pv[::3, 0, width // 2:], pi[::3, 0, width // 2:] = float("-inf"), -1   # short lists
    mv, mi = fs.merge_partials_plain(pv, pi, k=k)
    kv, ki = fs.merge_partials(pv.to(cuda_device), pi.to(cuda_device), k=k)
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


@pytest.mark.cuda
def test_wide_small_buffer_smem_formula_matches_the_library(cuda_device):
    """The wide fp32 flat scan's shared memory with its FLAT_WIDE_CAP buffers
    and, behind a first pass's floor, with FLAT_WIDE_SMALL_CAP ones is the
    source's, and only the small buffers let two blocks share an SM."""
    lib = kbuild.load()
    for k in (129, 1000, 10_000):
        for cap in (fs.FLAT_WIDE_CAP, fs.FLAT_WIDE_SMALL_CAP):
            smem = fs.flat_scan_smem_bytes(k, fs.FLAT_WIDE_TILE, cap=cap)
            assert lib.pyrope_scan_wide_smem_bytes(k, cap) == smem
            assert (cap == fs.FLAT_WIDE_CAP) == (smem > fs.SMEM_TWO_BLOCKS)


@pytest.mark.cuda
@pytest.mark.parametrize("k,width,s", [(1000, 1000, 40), (3840, 3840, 12), (300, 300, 9),
                                       (2000, 600, 264)])
def test_merge_wide_reads_fill_counts_vs_plain(cuda_device, k, width, s):
    """The wide merge over [B, S, w] lists that carry a fill count each (the
    fp32 wide flat scan writes counts in place of its pads): entries past a
    list's fill are never read (NaN here), some lists are empty, some full;
    bit-equal to the plain version on the real entries, ties included."""
    b = 6
    rng = np.random.default_rng(107 + s)
    fills = rng.integers(0, width + 1, (b, s)).astype(np.int32)
    fills[:, ::7] = 0
    fills[:, 1::9] = width
    v = np.sort(rng.integers(0, 3000, (b, s, width)).astype(np.float32), axis=2)[:, :, ::-1]
    r = rng.permutation(b * s * width).reshape(b, s, width).astype(np.int32)
    order = np.lexsort((r, -v), axis=2)
    v, r = np.take_along_axis(np.ascontiguousarray(v), order, 2), np.take_along_axis(r, order, 2)
    past = np.arange(width)[None, None, :] >= fills[:, :, None]
    pv = torch.from_numpy(np.where(past, -np.inf, v).astype(np.float32))
    pi = torch.from_numpy(np.where(past, -1, r).astype(np.int32))
    mv, mi = fs.merge_partials_plain(pv.permute(1, 0, 2), pi.permute(1, 0, 2), k=k)
    gv = torch.from_numpy(np.where(past, np.nan, v).astype(np.float32)).to(cuda_device)
    gi = torch.from_numpy(np.where(past, 12345, r).astype(np.int32)).to(cuda_device)
    kv, ki = fs._merge_launch(gv, gi, s, b, k, None, 0, s * width, width, width,
                              torch.from_numpy(fills).to(cuda_device))
    np.testing.assert_array_equal(ki.cpu().numpy(), mi.numpy())
    np.testing.assert_array_equal(kv.cpu().numpy(), mv.numpy())


# ---- the sharded families and DeviceFlatIndex on the card ----------------------


def _one_card_mesh(cuda_device, n=4, two_d=False):
    """n shards on one card: the mesh the one-card machine can hold."""
    from pyrope_tpu_torch.parallel import make_mesh, make_mesh_2d

    devs = [cuda_device] * n
    return make_mesh_2d(2, n // 2, devices=devs) if two_d else make_mesh(devices=devs)


@pytest.mark.cuda
@pytest.mark.parametrize("shard_by", ["rows", "cluster"])
def test_per_shard_list_scan_at_shard_local_csr(cuda_device, shard_by):
    """Each shard's list scan over its own slab and local CSR (offsets, lens,
    l_pad of the layout) against the plain list scan on the same tensors;
    the sharded search's hits equal the single index's, and the path
    launched the list scan once a shard and the merge."""
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex, rank_probes
    from pyrope_tpu_torch.parallel import ShardedIvfFlatIndex

    rng = np.random.default_rng(31)
    base = rng.random((40_000, 32), np.float32)
    q = rng.random((200, 32), np.float32)
    ids = [str(i) for i in range(len(base))]
    sh = ShardedIvfFlatIndex(32, "L2", mesh=_one_card_mesh(cuda_device), nlist=600,
                             nprobe=9, shard_by=shard_by, scan_mode="dense")
    ref = IvfFlatIndex(32, "L2", device=cuda_device, nlist=600, nprobe=9, scan_mode="dense")
    for ix in (sh, ref):
        ix.add_batch(ids, base)
        ix.build()
    assert sh.describe_scan(256) == "dense-pallas-win"
    dev = sh._sync()
    qt = torch.from_numpy(q).to(cuda_device)
    for s, st in enumerate(dev["shards"][0]):
        probe = rank_probes(qt, st["cents"], st["cvalid"], st["offsets"], st["lens"], 9,
                            dev["stride"], Metric.L2)[0]
        args = (qt, st["xperm"], st["sqnorm"], st["alive"], st["crow"])
        kv, ki = fs.fused_ivf_topk(*args, st["offsets"], st["lens"], probe, dev["kpad"], 10,
                                   max_len=dev["l_pad"])
        pv, pi = fs.fused_ivf_topk_plain(*args, probe, dev["kpad"], 10)
        assert_same_hits(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())
    fs.reset_launches()
    got = sh.search_batch(q, 10)
    assert fs.LAUNCHES["ivf_scan"] == 4 and fs.LAUNCHES["merge"] >= 5
    assert_same_results(got, ref.search_batch(q, 10))


@pytest.mark.cuda
def test_shard_merge_on_the_card(cuda_device):
    """The shard merge (stacked [nd, B, k] lists, ties across shards) on the
    card: the merge kernel, bit-equal to its plain version on the CPU."""
    from pyrope_tpu_torch.parallel.mesh import allgather_merge_topk

    rng = np.random.default_rng(5)
    nd, b, k, stride = 8, 300, 10, 5000
    vals = -np.sort(-(np.round(rng.random((nd, b, k)) * 8) / 8).astype(np.float32), axis=2)
    local = np.stack([[rng.choice(stride, k, replace=False) for _ in range(b)]
                      for _ in range(nd)])        # a row once a list, as a scan gives it
    rows = (local + np.arange(nd)[:, None, None] * stride).astype(np.int32)
    for s in range(nd):
        for i in range(b):
            o = np.lexsort((rows[s, i], -vals[s, i]))
            vals[s, i], rows[s, i] = vals[s, i, o], rows[s, i, o]
    parts = [(torch.from_numpy(vals[s]), torch.from_numpy(rows[s])) for s in range(nd)]
    pv, pi = allgather_merge_topk(parts, k, torch.device("cpu"))
    before = fs.LAUNCHES["merge"]
    kv, ki = allgather_merge_topk([(v.to(cuda_device), r.to(cuda_device)) for v, r in parts],
                                  k, cuda_device)
    assert fs.LAUNCHES["merge"] == before + 1
    np.testing.assert_array_equal(kv.cpu().numpy(), pv.numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("two_d", [False, True])
def test_sharded_flat_kernel_rebases_the_budget(cuda_device, two_d):
    """ShardedFlatIndex(selection='pallas') on a 4-shard mesh of the card:
    the flat scan once a shard, hits equal FlatIndex's, with and without a
    max_scans budget that ends inside a shard."""
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.parallel import ShardedFlatIndex

    rng = np.random.default_rng(9)
    base = rng.random((30_000, 64), np.float32)
    q = rng.random((96, 64), np.float32)
    ids = [str(i) for i in range(len(base))]
    sh = ShardedFlatIndex(64, "L2", mesh=_one_card_mesh(cuda_device, two_d=two_d),
                          selection="pallas")
    ref = FlatIndex(64, "L2", device=cuda_device, selection="pallas")
    for ix in (sh, ref):
        ix.add_batch(ids, base)
    for opts in (SearchOptions(), SearchOptions(max_scans=20_001)):
        fs.reset_launches()
        got = sh.search_batch(q, 10, opts)
        assert fs.LAUNCHES["flat_scan"] == 4   # 4 shards, or 2 shards x 2 batch groups
        assert_same_results(got, ref.search_batch(q, 10, opts))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_device_flat_index_runs_the_flat_scan(cuda_device, dtype):
    """DeviceFlatIndex adopts a slab generated on the card: device-pallas
    launches K1 (fp32) or its bf16 kernel, hits equal the plain version on
    the same slab (bf16: but for k-th place ties)."""
    from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex

    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.rand((50_000, 128), generator=g, device=cuda_device).to(dtype)
    q = torch.rand((64, 128), generator=g, device=cuda_device)
    ix = DeviceFlatIndex(x, "L2", n_valid=49_000)
    assert ix._dev["vecs"] is x
    key = "flat_scan_bf16" if dtype == torch.bfloat16 else "flat_scan"
    before = fs.LAUNCHES[key]
    kv, ki = ix.device_search(q, 10)
    assert fs.LAUNCHES[key] == before + 1
    d = ix._dev
    pv, pi = fs.fused_flat_topk_plain(q, d["vecs"], d["sqnorm"], d["alive"], 49_000, 10)
    check = assert_hits_but_kth_ties if dtype == torch.bfloat16 else assert_same_hits
    check(kv.cpu(), ki.cpu(), pv.cpu(), pi.cpu())


# ---- the probe inversion (csrc/invert_probes.cu) ------------------------------

_INVERT_TABLES = ("pairs", "cstart", "ccnt", "item_end", "item_c", "slot_end")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("name", sorted(INVERT_CASES))
def test_invert_probes_kernel_is_bit_equal_to_plain(cuda_device, name, dtype):
    """Every table the inversion kernel writes is bit-equal to the plain
    version's, at the main paths' shapes (b1 np3 and b1024 np3 at kp 1000,
    at the 2,048-row and the tensor-core segment; b256 and b4096 np96 at kp
    100) and the edges (probed empty lists, kp far above B·P, several
    segments a list, P = 1); one count a call, the same tables twice."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    probe, lens, kp, max_len, seg, n = invert_case(name, sms)
    probe, lens = probe.to(cuda_device, dtype), lens.to(cuda_device)
    plain = fs.invert_probes_plain(probe, lens, kp, max_len, seg, n)
    before = fs.LAUNCHES["invert_probes"]
    runs = [fs.invert_probes(probe, lens, kp, max_len, seg, n) for _ in range(2)]
    assert fs.LAUNCHES["invert_probes"] == before + 2
    torch.cuda.synchronize()
    for got in runs:
        assert (got.grid, got.segs, got.slots) == (plain.grid, plain.segs, plain.slots)
        for table in _INVERT_TABLES:
            assert torch.equal(getattr(got, table), getattr(plain, table)), table


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys", [1, 7, 100_003])
def test_invert_probes_kernel_zeroes_the_keys(cuda_device, n_keys):
    """The inversion's first launch zeroes the call's keys (every 64-bit
    word of them, none past them) beside the tables."""
    probe, lens, kp, max_len, seg, n = invert_case("b256_np96_kp100")
    probe, lens = probe.to(cuda_device), lens.to(cuda_device)
    grid, segs = fs.list_grid(256, 96, kp, max_len, seg)
    spans, total = fs.layout((("keys", 2 * n_keys + 4), *fs._table_sizes(256, 96, kp, grid)))
    buf = torch.full((total,), -1, dtype=torch.int32, device=cuda_device)
    work = fs._CarvedWork(buf, spans, 256, 96, segs, grid, 0)
    keys = buf.narrow(0, *spans["keys"])
    fs._invert_launch(kbuild.load(), probe, lens, kp, seg, fs.QUERY_TILE, grid, work.ptr,
                      work.ptr("keys"), n_keys, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert not keys[:2 * n_keys].any()
    assert bool((keys[2 * n_keys:] == -1).all())
    plain = fs.invert_probes_plain(probe, lens, kp, max_len, seg, n)
    assert torch.equal(work.pairs, plain.pairs)


@pytest.mark.cuda
def test_invert_probes_scratch_formula_matches_the_library(cuda_device):
    lib = kbuild.load()
    for b, kp in ((1, 1), (64, 100), (65, 1000), (4096, 100), (1024, 16_384)):
        assert lib.pyrope_invert_scratch_bytes(b, kp) == fs.invert_scratch_bytes(b, kp)


@pytest.mark.cuda
def test_invert_probes_raises_on_a_refused_launch(cuda_device):
    """A launch the C entry refuses (kp 0) raises; nothing falls back to
    the plain version."""
    probe, lens, kp, max_len, seg, n = invert_case("p1")
    probe, lens = probe.to(cuda_device), lens.to(cuda_device)
    grid, segs = fs.list_grid(130, 1, kp, max_len, seg)
    spans, total = fs.layout(fs._table_sizes(130, 1, kp, grid))
    work = fs._CarvedWork(torch.empty(total, dtype=torch.int32, device=cuda_device), spans,
                          130, 1, segs, grid, 0)
    with pytest.raises(RuntimeError, match="probe inversion"):
        fs._invert_launch(kbuild.load(), probe, lens, 0, seg, fs.QUERY_TILE, grid, work.ptr,
                          None, 0, torch.cuda.current_stream().cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,k", [("ivf", 10), ("ivf", 300), ("sq8", 10), ("bf16", 64),
                                    ("bf16", 300), ("bf16p", 10)])
def test_every_list_scan_call_launches_the_inversion(cuda_device, mode, k):
    """Each list-scan call inverts its probes with the kernel, once, and the
    plain version runs on no call on the card: the hits are the plain
    route's."""
    case = list_case(120, 8_000, 70, 32, 64, 24, dead=0.05)
    q, x, sq, alive, offs, lens, probe, ml, sq8 = _list_work(cuda_device, case, 64, k, mode)
    crow = as_tensor(case[4]).to(cuda_device)
    real = fs.invert_probes_plain
    fs.invert_probes_plain = None   # any call of it on the card would raise
    try:
        before = dict(fs.LAUNCHES)
        if mode == "sq8":
            kv, ki = fs.fused_ivf_sq8_topk(q, x, *sq8[:2], sq, alive, crow, offs, lens,
                                           probe, sq8[2], 64, k, max_len=ml)
        else:
            kv, ki = fs.fused_ivf_topk(q, x, sq, alive, crow, offs, lens, probe, 64, k,
                                       max_len=ml, promote_fp32=mode == "bf16p")
        assert fs.LAUNCHES["invert_probes"] == before["invert_probes"] + 1
        scans = sum(fs.LAUNCHES[key] - before[key] for key in
                    ("ivf_scan", "ivf_scan_bf16", "ivf_scan_bf16_promote",
                     "ivf_scan_bf16_tc", "sq8_scan",
                     "ivf_scan_wide", "ivf_scan_bf16_wide", "sq8_scan_wide"))
        assert scans == 1
    finally:
        fs.invert_probes_plain = real
    torch.cuda.synchronize()
    if mode == "sq8":
        pv, pi = fs.fused_ivf_sq8_topk_plain(q, x, *sq8[:2], sq, alive, crow, probe, sq8[2],
                                             64, k)
        _compare(kv, ki, pv, pi, True, SQ8_RTOL)
    else:
        pv, pi = fs.fused_ivf_topk_plain(q, x, sq, alive, crow, probe, 64, k,
                                         promote_fp32=mode == "bf16p")
        _compare(kv, ki, pv, pi, mode != "ivf", RTOL)
