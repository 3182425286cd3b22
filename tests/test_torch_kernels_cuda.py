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
fp32 sums in another order); scores rounded to bf16 tie more often, so a
hit may differ there only as a k-th place tie.
"""

import numpy as np
import pytest
import torch
from _torch_parity import (
    SQ8_RTOL,
    as_tensor,
    assert_hits_but_kth_ties,
    assert_same_hits,
    assert_same_results,
    csr,
    flat_case,
    fused_ivf_topk_emulated,
    ivf_case,
    list_case,
    split_partials,
    sq8_case,
    sq8_of,
)

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
        fs.fused_ivf_sq8_topk(q, codes, mn, sc, sq, alive, crow, *ol, probe, qc, 50, 129,
                              max_len=4096)
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
    _, (x, q, sq, alive, crow, probe), offs, lens, k = _list_inputs(name, cuda_device, d)
    x16 = x.bfloat16()
    for metric in (Metric.L2, Metric.INNER_PRODUCT):
        before = dict(fs.LAUNCHES)
        kv, ki = fs.fused_ivf_topk(q, x16, sq, alive, crow, offs, lens, probe, 128, k,
                                   metric, max_len=int(lens.max()), promote_fp32=promote)
        assert fs.LAUNCHES["ivf_scan_bf16"] == before["ivf_scan_bf16"] + 1
        assert fs.LAUNCHES["ivf_scan"] == before["ivf_scan"]
        pv, pi = fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, 128, k, metric,
                                         promote_fp32=promote)
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
        pv, pi = fs.fused_ivf_topk_plain(q, x16, sq, alive, crow, probe, 128, k,
                                         promote_fp32=promote)
        torch.cuda.synchronize()
        assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
        assert_hits_but_kth_ties(runs[0][0].cpu(), runs[0][1].cpu(), pv.cpu(), pi.cpu())


@pytest.mark.cuda
def test_smem_formulas_match_the_library(cuda_device):
    """The routes decide from the Python formulas which shapes the kernels
    take; they must equal the sources' own."""
    from pyrope_tpu_torch.kernels.build import load

    lib = load()
    for d in (1, 16, 30, 128, 384, 565, 566, 600, 768, 1024):
        for k in (1, 10, 64, 128):
            for mode in (fs.LIST_IVF, fs.LIST_SQ8, fs.LIST_BF16):
                assert (lib.pyrope_list_scan_smem_bytes(d, k, mode)
                        == fs.list_scan_smem_bytes(d, k, mode)), (d, k, mode)
    for k in (1, 10, 64, 100, 128):
        for tile in fs.FLAT_QUERY_TILES:
            for elem in (4, 2):
                assert (lib.pyrope_scan_smem_bytes(k, tile, elem)
                        == fs.flat_scan_smem_bytes(k, tile, elem)), (k, tile, elem)
    assert fs.list_scan_smem_bytes(768, 10, fs.LIST_IVF) == 287_488
    assert fs.list_scan_refusal(768, 10, fs.LIST_IVF) is not None


@pytest.mark.cuda
def test_k200_and_d768_routes_answer_on_the_card(cuda_device):
    """Shapes the list scan does not take route to the plain dense scan
    (decided on the host, shown by describe_scan), and answer as the
    index's exact route does; explicit 'pallas' raises naming the limit."""
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex

    rng = np.random.default_rng(31)
    for d, k in ((768, 10), (32, 200)):
        base = rng.normal(size=(4_000, d)).astype(np.float32)
        q = rng.normal(size=(16, d)).astype(np.float32)
        ids = [str(i) for i in range(len(base))]
        ix = IvfFlatIndex(d, "L2", device=cuda_device, nlist=16, nprobe=4)
        ix.add_batch(ids, base)
        ix.build()
        assert ix.describe_scan(16, top_k=k) == "dense-xla"
        got = ix.search_batch(q, k)
        ix.selection = "exact"
        assert_same_results(got, ix.search_batch(q, k))
        ix.selection = "pallas"
        with pytest.raises(ValueError, match="ROADMAP.md queue 2 item"):
            ix.search_batch(q, k)
        pq = IvfPqIndex(d, "L2", device=cuda_device, nlist=16, pq_m=4, nprobe=4)
        pq.add_batch(ids, base)
        pq.build()
        assert pq.describe_scan(16, top_k=k) == "dense-exact-xla"
        assert len(pq.search_batch(q, k)[0]) == k
    flat = FlatIndex(32, "L2", device=cuda_device, selection="pallas")
    flat.add_batch(ids, base)
    with pytest.raises(ValueError, match="ROADMAP.md queue 2 item B"):
        flat.search_batch(q, 200)


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
    got = run(ivf, "ivf_scan_bf16")
    wide = np.concatenate([q, rng.normal(size=(1024 - 64, 32)).astype(np.float32)])
    assert ivf.describe_scan(1024) == "dense-pallas-win"
    assert_same_results(got, run(ivf, "ivf_scan", wide)[:64])

    pq = IvfPqIndex(32, "L2", device=cuda_device, nlist=16, pq_m=4, nprobe=4,
                    refine_storage="bf16", train_dtype="bfloat16")
    pq.add_batch(ids, base)
    pq.build()
    assert pq._dev["xraw"].dtype == torch.bfloat16
    assert pq.describe_scan(64) == "dense-exact-pallas"
    got = run(pq, "ivf_scan_bf16")
    plain = pq.search_batch(q, 10, SearchOptions(max_scans=len(base) - 1))
    assert pq.describe_scan(64, max_scans=len(base) - 1) == "dense-exact-xla"
    assert_hits_but_kth_ties(*_arrays(got), *_arrays(plain))


def _arrays(results):
    from _torch_parity import hits_to_arrays

    return hits_to_arrays(results)
