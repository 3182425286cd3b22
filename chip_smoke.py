#!/usr/bin/env python3
"""End-to-end check of the PyTorch + CUDA port (pyrope_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the repo root, on a host with a GPU

Builds the CUDA kernels from pyrope_tpu_torch/csrc at first use, then runs
twelve phases, one line each (phase 8 two); any failed check exits non-zero:

  1. device    torch/CUDA versions, the card's name and power limit
  2. build     nvcc build time, registers and spills per kernel
  3. kernels   each kernel against its plain PyTorch version on the card at
               the main paths' shapes: equal hit sets, scores within
               |a-b| <= 1e-4 + 1e-5|b| (fp32 both sides, other summation
               order; the SQ8 scan 1e-4 + 1e-4|b|, the JAX package's SQ8
               tolerance), kernel and plain times (CUDA events, median),
               the nearest PyTorch composition's time (topk of the masked
               fp32 scores) beside each main case and the narrow rows, each
               case's bound (what its inputs need, bytes or operations); the
               flat scan at b1024 (k 10, k 100, max_scans 600k), b64, b1 and
               over an 8k-row slab, with q @ x.T alone (torch.matmul, fp32)
               timed beside the main case; the merge on the slice's
               per-query slots and on the flat path's [B, splits, k]; and
               the list scan's edge cases, IVF and SQ8 mode: a 50k-row list
               (at nprobe 3, and at nprobe 96 with k 128), nprobe >= the
               non-empty lists, probed empty lists, B 1000, k 128, a row
               copied into two lists, 30% tombstones; the bf16 slab modes:
               the flat scan at 1M x 128 (b1024 and b64 at k 10, b64 at the
               hybrid's k 64), the list scan without promote (100k, nlist
               100, nprobe 96, b256, k 64) and with it (1M, nlist 1000,
               nprobe 3, b64, k 10), each beside the composition, the bare
               bf16 q16 @ x16.T, and its bound (bf16 rows over the memory
               rate against the bf16 tensor-core peak, or the fp32 peak with
               promote)
  4. slice     create_index(IVF_FLAT, nlist 1000, nprobe 3, dense) on 1M x
               128 clustered rows through the registry's Delta(Flat,
               IVF_FLAT): add_batch, build (compaction -> k-means -> slab),
               search_batch / device_search on b1024; route
               dense-pallas-win, recall@10 >= 0.995 against numpy ground
               truth; build_s, QPS, p50/p99 batch latency, per-layer
               times, and a torch.profiler trace of 40 pipelined b1024
               device_search batches (device idle share, kernel shares)
  5. narrow    IvfFlatIndex nlist 100, nprobe 96 on 100k uniform rows,
               b4096: route dense-pallas, recall@10 within 0.005 of 0.9972
  6. flat      FlatIndex(selection="pallas") on 1M uniform rows, b1024:
               exact, recall@10 1.0
  7. pq        create_index(IVF_PQ, nlist 1000, pq_m 16, ksub 256,
               refine_storage sq8res) on the same 1M clustered rows through
               Delta(Flat, IVF_PQ): add_batch, build; route
               dense-sq8-pallas-win at b256 (the SQ8 kernel), recall@10 >=
               0.9736 from search_batch and device_search on 1024 queries;
               build_s, QPS and p50/p99 at b256 and b1024, device bytes
  8. pq narrow IvfPqIndex nlist 100, pq_m 16, sq8res on 100k clustered rows,
               b1024: route dense-sq8-pallas, recall@10 >= 0.9783; the same
               index in probe mode (probe-adc+rerank-sq8, the ADC path);
               the registry default fp32 rerank slab (dense-exact-pallas,
               the IVF kernel); and a second build from the same seed with
               bit-equal centroids, codebooks, PQ codes and SQ8 codes
  9. flat bf16 FlatIndex(storage="bf16", selection="pallas") on phase 6's
               1M uniform rows (flat1m_pallas): route flat-pallas, the bf16
               flat scan; recall@10 of b1024 within 0.005 of 0.9817, b64's
               beside 0.9855; QPS, p50/p99 at b1024 and b64
 10. flat hybrid FlatIndex(selection="hybrid") on the same rows
               (flat1m_hybrid, flat1m_hybrid_b256): flat-pallas-hybrid at
               b64 and b256, flat-pallas at b1024; no miss beyond fp32 ties
 11. ivf hybrid IvfFlatIndex(selection="hybrid"): 100k uniform, nlist 100,
               nprobe 96 (ivf100k_np96_hybrid_b256, dense-pallas-hybrid) and
               the 1M uniform rows, nlist 1000, nprobe 256, bf16 training
               (ivf1m_np256_hybrid_b256, dense-pallas-win-hybrid), b256:
               hits equal the fp32 list scan's on the same queries (sent
               inside a b1024 batch, above HYBRID_MAX_BATCH), but for k-th
               place ties
 12. pq bf16   create_index(IVF_PQ, nlist 1000, pq_m 16, ksub 256,
               refine_storage bf16), bf16 training, on phase 4's clustered
               rows (ivfpq1m_bf16slab): route dense-exact-pallas-win at b64
               (the bf16 list scan with promote), a 256,000,000-byte slab,
               recall@10 of 1024 queries within 0.03 of 0.725

The kernels' launch counters are zeroed before each serving path (phases
4-6, the IVF-Flat path; phases 7-8, the IVF-PQ path; phases 9, 10, 11 and
12, one path each) and read after it: every kernel of a path must have run
on it. The last three lines are the
kernels' JSON record, the card as nvidia-smi names it, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from pyrope_tpu_torch.types import IndexConfig, IndexParams, Metric
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic,
    synthetic_clustered,
    synthetic_clustered_queries,
    synthetic_queries,
)
from pyrope_tpu_torch.utils.stats import LatencySummary
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex, rank_probes
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
from pyrope_tpu_torch.kernels import build as kbuild
from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.ops.slab import sq8res_encode
from pyrope_tpu_torch.registry import create_index

RTOL, ATOL = 1e-5, 1e-4
SQ8_RTOL = 1e-4   # the JAX package's SQ8 kernel tolerance
K = 10
SOURCE = "pyrope_tpu_torch/csrc/fused_scan.cu"
LIST_SOURCE = "pyrope_tpu_torch/csrc/ivf_list_scan.cu"
PALLAS = "pyrope_tpu/ops/pallas_scan.py"


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median time of ``fn`` on the card (CUDA events), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(kernel_out, plain_out, what: str, rtol: float = RTOL) -> tuple[float, int]:
    """Hit sets equal, scores within tolerance. A hit may differ only as a
    tie at the k-th place: both scores within tolerance of the k-th score.
    Returns (max |score difference| at equal rank, tie swaps)."""
    kv, ki = (t.cpu().numpy() for t in kernel_out)
    pv, pi = (t.cpu().numpy() for t in plain_out)
    require(kv.shape == pv.shape, f"{what}: shapes {kv.shape} vs {pv.shape}")
    fin = np.isfinite(pv)
    require((np.isfinite(kv) == fin).all(), f"{what}: missing-hit slots differ")
    require(np.allclose(kv[fin], pv[fin], rtol=rtol, atol=ATOL),
            f"{what}: scores differ beyond tolerance")
    swaps = 0
    for b in np.nonzero((np.sort(ki, 1) != np.sort(pi, 1)).any(1))[0]:
        kth = pv[b][fin[b]][-1]
        only = set(ki[b]) ^ set(pi[b])
        score = {**dict(zip(pi[b], pv[b])), **dict(zip(ki[b], kv[b]))}
        require(all(np.isclose(score[r], kth, rtol=rtol, atol=ATOL) for r in only),
                f"{what}: query {b} hit sets differ outside a k-th place tie")
        swaps += len(only) // 2
    err = float(np.abs(kv[fin] - pv[fin]).max()) if fin.any() else 0.0
    return err, swaps


def recall(results, truth, top_k=K) -> float:
    """recall@k of search_batch results against ground-truth rows."""
    rows = id_lists_to_rows([[h.id for h in r] for r in results], top_k)
    return recall_at_k(rows, truth, top_k)


def serve(ix, q_dev: list[torch.Tensor], iters: int) -> dict:
    """Pipelined device_search throughput (one synchronize at the end) and
    blocking per-batch latency including the rows' fetch to the host."""
    b = q_dev[0].shape[0]
    ix.device_search(q_dev[0], K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ix.device_search(q_dev[i % len(q_dev)], K) for i in range(iters)]
    torch.cuda.synchronize()
    qps = iters * b / (time.perf_counter() - t0)
    del outs
    lat = []
    for i in range(30):
        t0 = time.perf_counter()
        ix.device_search(q_dev[i % len(q_dev)], K)[1].cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    s = LatencySummary.from_samples(lat)
    return {"qps": round(qps, 1), "p50_ms": round(s.p50_ms, 3),
            "p99_ms": round(s.p99_ms, 3)}


def exact_misses_are_ties(ix, base, queries, truth, batch=None) -> tuple[float, int]:
    """Recall against float64 ground truth, and the number of misses that
    are not fp32 ties at the k-th place (float64 distance of the returned
    row within 1e-4 of the true k-th distance). ``batch``: search_batch in
    batches of that many queries (None: all at once)."""
    step = batch or len(queries)
    results = [r for s in range(0, len(queries), step)
               for r in ix.search_batch(queries[s:s + step], K)]
    rows = id_lists_to_rows([[h.id for h in r] for r in results], K)
    rec = recall_at_k(rows, truth, K)
    bad = 0
    for b in range(len(queries)):
        extra = set(rows[b]) - set(truth[b])
        if not extra:
            continue
        d = lambda r: float(np.sum((base[r].astype(np.float64) - queries[b]) ** 2))
        kth = d(truth[b][K - 1])
        bad += sum(abs(d(r) - kth) > ATOL for r in extra)
    return rec, bad


def device_shares(fn, iters: int) -> dict:
    """A torch.profiler trace of ``iters`` pipelined calls: the device span
    (first kernel start to last kernel end), the kernels' busy time, the
    idle share of the span and the largest kernels' shares of busy time.
    Where the profiler records no device time, the fields say so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_time": "not measured"}
    span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"span_ms": round(span / 1e3, 3), "busy_ms": round(busy / 1e3, 3),
            "idle_share": round(1.0 - busy / span, 4),
            "shares": {name: round(us / busy, 4) for name, us in top}}


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say("1 device", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], card=repr(smi),
        count=torch.cuda.device_count())
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kbuild.build(verbose=True)
    kbuild.load()
    secs = time.perf_counter() - t0
    regs = [ln.replace("ptxas info", "").strip(" :")
            for ln in kbuild.build_log().splitlines()
            if "registers" in ln or "spill" in ln]
    say("2 build", seconds=round(secs, 2), lib=kbuild.library_path().name,
        ptxas=repr("; ".join(regs)))


HBM_BYTES_S = 3.35e12   # H100 SXM device memory rate (data sheet)
FP32_FLOP_S = 67e12     # H100 SXM fp32 rate outside the tensor cores
BF16_FLOP_S = 989e12    # H100 SXM bf16 tensor-core rate, dense


def bound(nbytes: float, flops: float, rate: float = FP32_FLOP_S) -> tuple[float, str]:
    """Least time on the card, ms, and what sets it: each input byte read
    once and each output written once over the memory rate, against the
    operations over the rate of their type (fp32, or bf16 products with
    fp32 sums: the tensor cores')."""
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def l2_or_ip(q, dots, sq, ip):
    return dots if ip else -torch.clamp((q * q).sum(1, keepdim=True) - 2.0 * dots
                                        + sq[None, :], min=0.0)


def composition_topk(scores, mask, k):
    """The nearest PyTorch composition of a masked scan + top-k: topk of the
    fp32 scores under torch.where (no single call computes the function)."""
    v, i = torch.topk(torch.where(mask, scores, float("-inf")), k, dim=1)
    return v, torch.where(torch.isfinite(v), i, -1).int()


def layout(n, kp, g, dev, *, big=0, empty=0):
    """A cluster-major crow of n rows over kp clusters: clusters 0..empty-1
    hold no rows, cluster ``empty`` gets ``big`` extra rows. Returns
    (crow, offsets, lens, max_len)."""
    ids = torch.randint(empty, kp, (n - big,), generator=g, device=dev)
    crow = torch.sort(torch.cat([ids, torch.full((big,), empty, device=dev)])).values.int()
    offs, lens = fs.list_csr(crow, kp)
    return crow, offs, lens, int(lens.max())


def probes(b, kp, nprobe, g, dev, *, lo=0, forced=None, every=1):
    """[b, nprobe] distinct probes among clusters lo..kp-1; with ``forced``
    (a cluster id, or a tensor of ids per row) in column 0 of every
    ``every``-th row."""
    p = torch.rand((b, kp - lo), generator=g, device=dev).argsort(1)[:, :nprobe] + lo
    if forced is not None:
        f = forced if torch.is_tensor(forced) else torch.full((b,), forced, device=dev)
        rows = torch.arange(0, b, every, device=dev)
        p[rows, 0] = f[rows]
    return p


def list_bound(x_bytes_per_row, q, probe, lens, alive, crow, kp, k, extra=0,
               rate=FP32_FLOP_S):
    """Bound of an IVF/SQ8 list scan on these inputs: each probed cluster's
    rows read once, the (query, alive row) pairs' FMAs."""
    b, d = q.shape
    used = torch.zeros(kp, dtype=torch.bool, device=q.device)
    used[probe.reshape(-1).long()] = True
    rows = int(lens[used].sum())
    alive_c = torch.zeros(kp, device=q.device).index_add_(0, crow.long(), alive.float())
    pairs = float(alive_c[probe.long()].sum())
    return bound(rows * x_bytes_per_row + b * d * 4 + probe.numel() * 8 + b * k * 8 + extra,
                 2.0 * d * pairs, rate)


def phase_kernels(dev) -> dict:
    """Kernel vs plain at the main path's shapes, and the list scan's edge
    cases. Returns the JSON record's measured fields per kernel."""
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    n, d, b = 1_000_000, 128, 1024
    x = torch.rand((n, d), generator=g, device=dev)
    sq = (x * x).sum(1)
    alive = torch.rand(n, generator=g, device=dev) > 0.01
    q = torch.rand((b, d), generator=g, device=dev)
    rec = {kind: {"err": 0.0}
           for kind in ("flat", "ivf", "sq8", "merge", "flat_bf16", "ivf_bf16", "ivf_bf16p")}
    cells = []

    def case(kind, name, kern, plain, reps=10, plain_reps=3, main=False, comp=None,
             bnd=None, lib=None):
        err, swaps = compare(kern(), plain(), name, SQ8_RTOL if kind == "sq8" else RTOL)
        rec[kind]["err"] = max(rec[kind]["err"], err)
        ms, pms = cuda_ms(kern, reps), cuda_ms(plain, plain_reps)
        cms = cuda_ms(comp, plain_reps) if comp is not None else None
        lms = cuda_ms(lib, reps) if lib is not None else None
        if main:
            rec[kind].update(ms=ms, plain_ms=pms, composition_ms=cms, library_ms=lms)
        cell = f"{name}:{ms:.3f}ms/plain {pms:.3f}ms/err {err:.2e}/ties {swaps}"
        if cms is not None:
            cell += f"/composition {cms:.3f}ms"
        if lms is not None:
            cell += f"/library {lms:.3f}ms"
        if bnd is not None:
            cell += f"/bound {bnd[0]:.4f}ms {bnd[1]}"
        cells.append(cell)

    rows = torch.arange(n, device=dev)
    for k, ms_cut in ((10, n), (100, n), (10, 600_000)):
        main = k == 10 and ms_cut == n
        case("flat", f"flat_1M_b1024_k{k}_ms{ms_cut}",
             lambda: fs.fused_flat_topk(q, x, sq, alive, ms_cut, k),
             lambda: fs.fused_flat_topk_plain(q, x, sq, alive, ms_cut, k,
                                              chunk_rows=65536),
             main=main, comp=(lambda: composition_topk(
                 l2_or_ip(q, q @ x.T, sq, False), (alive & (rows < ms_cut))[None, :], k))
             if main else None,
             # q @ x.T alone: the product, not the function (no metric, mask,
             # top-k); what fp32 on the CUDA cores reaches through the library
             lib=(lambda: q @ x.T) if main else None,
             bnd=bound(ms_cut * (d * 4 + 5) + b * d * 4 + b * k * 8,
                       2.0 * b * int(alive[:ms_cut].sum()) * d))
    live = int(alive.sum())
    rec["flat"]["bound"] = bound(n * (d * 4 + 5) + b * d * 4 + b * K * 8, 2.0 * b * live * d)
    # small batches (the 64-query tile) and a Delta-head-sized slab
    for name, qv, rows_n in (("flat_1M_b64_k10", q[:64].contiguous(), n),
                             ("flat_1M_b1_k10", q[:1].contiguous(), n),
                             ("flat_8k_b1024_k10", q, 8192)):
        xv, sqv, alv = (t[:rows_n].contiguous() for t in (x, sq, alive))
        bv = qv.shape[0]
        case("flat", name,
             lambda: fs.fused_flat_topk(qv, xv, sqv, alv, rows_n, K),
             lambda: fs.fused_flat_topk_plain(qv, xv, sqv, alv, rows_n, K, chunk_rows=65536),
             bnd=bound(rows_n * (d * 4 + 5) + bv * d * 4 + bv * K * 8,
                       2.0 * bv * int(alv.sum()) * d))
        del xv, sqv, alv

    def ivf_case(name, qv, xv, sqv, alv, lay, kp, probe, k=K, main=False, reps=10,
                 comp=False):
        crow, offs, lens, ml = lay
        bnd = list_bound(d * 4 + 5, qv, probe, lens, alv, crow, kp, k)
        case("ivf", name,
             lambda: fs.fused_ivf_topk(qv, xv, sqv, alv, crow, offs, lens, probe, kp, k,
                                       max_len=ml),
             lambda: fs.fused_ivf_topk_plain(qv, xv, sqv, alv, crow, probe, kp, k,
                                             chunk_rows=65536),
             reps=reps, main=main, comp=(lambda: composition_topk(
                 l2_or_ip(qv, qv @ xv.T, sqv, False),
                 fs.probe_table(probe, kp)[:, crow.long()] & alv[None, :], k))
             if main or comp else None, bnd=bnd)
        if main:
            rec["ivf"]["bound"] = bnd

    def sq8_case(name, qv, xv, alv, lay, kp, probe, metric="L2", k=K, main=False,
                 reps=10, comp=False):
        crow, offs, lens, ml = lay
        cents = xv[torch.randint(0, xv.shape[0], (kp,), generator=g, device=dev)]
        codes, mins, scales, sq8 = sq8res_encode(xv, cents, crow)
        qc = qv @ cents.T
        ip = metric == "IP"
        bnd = list_bound(d + 13, qv, probe, lens, alv, crow, kp, k, extra=probe.numel() * 4)
        case("sq8", f"{name}_{metric}",
             lambda: fs.fused_ivf_sq8_topk(qv, codes, mins, scales, sq8, alv, crow, offs,
                                           lens, probe, qc, kp, k, metric, max_len=ml),
             lambda: fs.fused_ivf_sq8_topk_plain(qv, codes, mins, scales, sq8, alv, crow,
                                                 probe, qc, kp, k, metric,
                                                 chunk_rows=65536),
             reps=reps, main=main, comp=(lambda: composition_topk(
                 fs.sq8_scores(qv, qc, codes, mins, scales, sq8, crow, ip),
                 fs.probe_table(probe, kp)[:, crow.long()] & alv[None, :], k))
             if main or comp else None, bnd=bnd)
        if main:
            rec["sq8"]["bound"] = bnd

    kp = 1000
    lay = layout(n, kp, g, dev)
    for nprobe in (3, 32):
        ivf_case(f"ivf_1M_nlist1000_np{nprobe}_b1024", q, x, sq, alive, lay, kp,
                 probes(b, kp, nprobe, g, dev), main=(nprobe == 3))
    n2, b2, kp2 = 100_000, 4096, 100
    x2, sq2, alive2 = x[:n2].contiguous(), sq[:n2].contiguous(), alive[:n2].contiguous()
    q2 = torch.rand((b2, d), generator=g, device=dev)
    ivf_case("ivf_100k_nlist100_np96_b4096", q2, x2, sq2, alive2, layout(n2, kp2, g, dev),
             kp2, probes(b2, kp2, 96, g, dev), reps=5, comp=True)
    # the SQ8 scan: x stored as residual SQ8 against one centroid per cluster
    for n_s, kp_s in ((n, 1000), (100_000, 100)):
        lay_s = lay if n_s == n else layout(n_s, kp_s, g, dev)
        probe_s = probes(b, kp_s, 3, g, dev)
        for metric in ("L2", "IP"):
            sq8_case(f"sq8_{n_s // 1000}k_nlist{kp_s}_np3_b1024", q, x[:n_s],
                     alive[:n_s].contiguous(), lay_s, kp_s, probe_s, metric,
                     main=(n_s == n and metric == "L2"), comp=(metric == "L2"))

    # edge cases of the list scan's work layout, both modes, held to the same
    # tolerances
    skew = layout(n, kp, g, dev, big=50_000)        # one 50k-row list
    p_skew = probes(b, kp, 3, g, dev, lo=1, forced=0, every=2)
    p_skew96 = probes(b, kp, 96, g, dev, lo=1, forced=0, every=2)
    few = layout(100_000, 100, g, dev, empty=10)     # 90 non-empty lists
    holes = layout(n, kp, g, dev, empty=100)         # 100 empty lists, probed
    p_holes = probes(b, kp, 3, g, dev, lo=100, every=3,
                     forced=torch.randint(0, 100, (b,), generator=g, device=dev))
    p_main = probes(b, kp, 3, g, dev)
    dead = alive & (torch.rand(n, generator=g, device=dev) > 0.3)
    crow_m, offs_m = lay[0], lay[1]
    c1, c2 = int(p_main[0, 0]), int(p_main[0, 1])  # a row copied across two lists
    r1, r2 = int(offs_m[c1]), int(offs_m[c2])
    xd, qd = x.clone(), q.clone()
    xd[r2] = xd[r1]
    qd[0] = xd[r1]
    sqd = (xd * xd).sum(1)
    for name, args in (
        ("skewed_50k_np3_b1024", (q, x, sq, alive, skew, kp, p_skew)),
        ("skewed_50k_np96_k128_b1024", (q, x, sq, alive, skew, kp, p_skew96)),
        ("nprobe100_ge_90_lists_b256", (q[:256], x2, sq2, alive2, few, 100,
                                        probes(256, 100, 100, g, dev))),
        ("empty_lists_probed_np3_b1024", (q, x, sq, alive, holes, kp, p_holes)),
        ("ragged_b1000_np3", (q[:1000], x, sq, alive, lay, kp, p_main[:1000])),
        ("k128_np3_b1024", (q, x, sq, alive, lay, kp, p_main)),
        ("dup_rows_two_lists_np3_b1024", (qd, xd, sqd, alive, lay, kp, p_main)),
        ("tombstones_30pct_np3_b1024", (q, x, sq, dead, lay, kp, p_main)),
    ):
        qv, xv, sqv, alv, lay_e, kp_e, probe = args
        k = 128 if "k128" in name else K
        ivf_case(f"ivf_{name}", qv, xv, sqv, alv, lay_e, kp_e, probe, k=k, reps=3)
        sq8_case(f"sq8_{name}", qv, xv, alv, lay_e, kp_e, probe, k=k, reps=3)
    del xd

    # the bf16 slab modes at the shapes of phases 9-12: rows rounded to bf16,
    # sqnorm of the fp32 rows; the composition scores bf16(q)·x (or q·x with
    # promote) in fp32 and takes torch.topk; the library call is the bare
    # bf16 product q16 @ x16.T (bf16 sums: not the function, a yardstick)
    x16 = x.bfloat16()
    q16 = q.bfloat16()
    for name, bv, k, main in (("flat_bf16_1M_b1024_k10", b, K, True),
                              ("flat_bf16_1M_b64_k10", 64, K, False),
                              ("flat_bf16_1M_b64_k64", 64, 64, False)):
        qv, qv16 = q[:bv].contiguous(), q16[:bv].contiguous()
        bnd = bound(n * (d * 2 + 5) + bv * d * 4 + bv * k * 8, 2.0 * bv * live * d,
                    BF16_FLOP_S)
        if main:
            rec["flat_bf16"]["bound"] = bnd
        case("flat_bf16", name,
             lambda: fs.fused_flat_topk(qv, x16, sq, alive, n, k),
             lambda: fs.fused_flat_topk_plain(qv, x16, sq, alive, n, k, chunk_rows=65536),
             main=main,
             comp=lambda: composition_topk(l2_or_ip(qv, qv16.float() @ x16.float().T, sq, False),
                                           alive[None, :], k),
             lib=lambda: qv16 @ x16.T, bnd=bnd)
    # without promote: the IVF-Flat hybrid's shortlist scan (100k, nprobe 96, k 64)
    x2_16 = x2.bfloat16()
    lay2 = layout(n2, kp2, g, dev)
    q3 = q2[:256].contiguous()
    q3_16 = q3.bfloat16()
    p3 = probes(256, kp2, 96, g, dev)
    bnd = list_bound(d * 2 + 5, q3, p3, lay2[2], alive2, lay2[0], kp2, 64, rate=BF16_FLOP_S)
    rec["ivf_bf16"]["bound"] = bnd
    case("ivf_bf16", "ivf_bf16_100k_nlist100_np96_b256_k64",
         lambda: fs.fused_ivf_topk(q3, x2_16, sq2, alive2, lay2[0], lay2[1], lay2[2], p3,
                                   kp2, 64, max_len=lay2[3]),
         lambda: fs.fused_ivf_topk_plain(q3, x2_16, sq2, alive2, lay2[0], p3, kp2, 64,
                                         chunk_rows=65536),
         main=True, bnd=bnd, lib=lambda: q3_16 @ x2_16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q3, q3_16.float() @ x2_16.float().T, sq2, False),
             fs.probe_table(p3, kp2)[:, lay2[0].long()] & alive2[None, :], 64))
    # with promote: IVF-PQ's bf16 rerank slab scanned exactly (1M, nprobe 3, k 10)
    q4 = q[:64].contiguous()
    q4_16 = q4.bfloat16()
    p4 = probes(64, kp, 3, g, dev)
    bnd = list_bound(d * 2 + 5, q4, p4, lay[2], alive, lay[0], kp, K)
    rec["ivf_bf16p"]["bound"] = bnd
    case("ivf_bf16p", "ivf_bf16_promote_1M_nlist1000_np3_b64_k10",
         lambda: fs.fused_ivf_topk(q4, x16, sq, alive, lay[0], lay[1], lay[2], p4, kp, K,
                                   max_len=lay[3], promote_fp32=True),
         lambda: fs.fused_ivf_topk_plain(q4, x16, sq, alive, lay[0], p4, kp, K,
                                         promote_fp32=True, chunk_rows=65536),
         main=True, bnd=bnd, lib=lambda: q4_16 @ x16.T,
         comp=lambda: composition_topk(
             l2_or_ip(q4, q4 @ x16.float().T, sq, False),
             fs.probe_table(p4, kp)[:, lay[0].long()] & alive[None, :], K))
    del x16, x2_16

    # the merge alone, on partials of the slice's shape: each query's slots
    # (its lists' segments) from the list scan's inversion of the main probes
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seg = fs.list_seg(b, 3, kp, lay[3], sms)
    qend = fs.invert_probes(p_main, lay[2], kp, lay[3], seg, n).slot_end
    lists = int(qend[-1, -1])
    pv = torch.rand((lists, K), generator=g, device=dev).sort(1, descending=True).values
    pi = torch.randint(0, n, (lists, K), generator=g, device=dev).int()
    case("merge", f"merge_{lists}lists_b1024_k10",
         lambda: fs.merge_partials(pv, pi, qend), lambda: fs.merge_partials_plain(pv, pi, qend),
         reps=20, plain_reps=10, main=True, comp=lambda: torch.topk(
             pv[:lists // b * b].reshape(b, -1), K, dim=1))
    rec["merge"]["bound"] = bound(lists * K * 8 + (b + 1) * 4 + b * K * 8, 0.0)
    cells[-1] += f"/bound {rec['merge']['bound'][0]:.4f}ms bytes"
    # the merge on the flat path's partials at b1024: [B, splits, k], the
    # layout and split count fused_flat_topk hands it
    splits = fs.scan_splits(b, n, dev, fs.flat_tile(d, K, b)[0])[1]
    fv = torch.rand((b, splits, K), generator=g, device=dev).sort(2, descending=True).values
    fi = torch.randint(0, n, (b, splits, K), generator=g, device=dev).int()
    sbk = (fv.permute(1, 0, 2).contiguous(), fi.permute(1, 0, 2).contiguous())
    case("merge", f"merge_flat_{splits}splits_b1024_k10",
         lambda: fs._merge_launch(fv, fi, splits, b, K, None, 0, splits * K, K),
         lambda: fs.merge_partials_plain(*sbk), reps=20, plain_reps=10,
         comp=lambda: torch.topk(fv.view(b, -1), K, dim=1),
         bnd=bound(b * splits * K * 8 + b * K * 8, 0.0))
    say("3 kernels", cells=repr(" | ".join(cells)))
    return rec


def clustered_1m() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 1M x 128 clustered corpus of phases 4 and 7 (1000 centers), 8192
    queries, and the ground truth of the first 1024."""
    base = synthetic_clustered(1_000_000, 128, n_clusters=1000)
    queries = synthetic_clustered_queries(8 * 1024, 128, n_clusters=1000)
    return base, queries, ground_truth(base, queries[:1024], K, block=16384)


def phase_slice(dev, counts_before, data) -> dict:
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_FLAT",
                                  params=IndexParams(nlist=1000, nprobe=3,
                                                     scan_mode="dense")),
                      device=dev)
    t0 = time.perf_counter()
    ix.add_batch([str(i) for i in range(n)], base)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = ix.tail.describe_scan(1024)
    require(route == "dense-pallas-win", f"1M nlist 1000 route is {route}")
    launches = fs.LAUNCHES["ivf_scan"]
    t0 = time.perf_counter()
    results = ix.search_batch(queries[:1024], K)
    search_batch_ms = (time.perf_counter() - t0) * 1e3
    r_search = recall(results, truth)
    q_dev = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev)
             for i in range(8)]
    _, rows = ix.device_search(q_dev[0], K)
    r_device = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)
    srv = serve(ix, q_dev, iters=200)
    require(fs.LAUNCHES["ivf_scan"] > launches, "IVF kernel never launched")
    require(r_search >= 0.995 and r_device >= 0.995,
            f"recall@10 {r_search}/{r_device} < 0.995")
    # per-layer times on one b1024 batch (CUDA events, median)
    tdev = ix.tail._sync()
    probe = rank_probes(q_dev[0], tdev["cents"], tdev["cvalid"], tdev["offsets"],
                        tdev["lens"], 3, n, Metric.L2)[0]
    rank_ms = cuda_ms(lambda: rank_probes(
        q_dev[0], tdev["cents"], tdev["cvalid"], tdev["offsets"], tdev["lens"],
        3, n, Metric.L2), 10)
    kp = tdev["cents"].shape[0]
    scan_ms = cuda_ms(lambda: fs.fused_ivf_topk(
        q_dev[0], tdev["xperm"], tdev["sqnorm"], tdev["alive"], tdev["crow"],
        tdev["offsets"], tdev["lens"], probe, kp, K, max_len=tdev["l_pad"]), 10)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seg = fs.list_seg(1024, 3, kp, tdev["l_pad"], sms)
    invert_ms = cuda_ms(lambda: fs.invert_probes(probe, tdev["lens"], kp, tdev["l_pad"],
                                                 seg, tdev["xperm"].shape[0]), 10)
    trace = device_shares(lambda: ix.device_search(q_dev[0], K), 40)
    t0 = time.perf_counter()
    ix.resolve_rows(rows.cpu().numpy())
    resolve_ms = (time.perf_counter() - t0) * 1e3
    say("4 slice", route=route, n=n, load_s=round(load_s, 2),
        build_s=round(build_s, 2), recall_search_batch=r_search,
        recall_device_search=r_device, **srv,
        search_batch_b1024_ms=round(search_batch_ms, 1),
        rank_probes_ms=round(rank_ms, 3), scan_plus_merge_ms=round(scan_ms, 3),
        inversion_ms=round(invert_ms, 3), trace_40_b1024=repr(trace),
        resolve_rows_ms=round(resolve_ms, 2),
        ivf_launches=fs.LAUNCHES["ivf_scan"] - counts_before["ivf_scan"])
    return srv


def phase_narrow(dev) -> None:
    n, d, b = 100_000, 128, 4096
    base = synthetic(n, d)
    queries = synthetic_queries(b, d)
    truth = ground_truth(base, queries, K, block=16384)
    ix = IvfFlatIndex(d, "L2", device=dev, nlist=100, nprobe=96)
    ix.add_batch([str(i) for i in range(n)], base)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    route = ix.describe_scan(b)
    require(route == "dense-pallas", f"100k nlist 100 route is {route}")
    q_dev = [torch.from_numpy(queries).to(dev)]
    _, rows = ix.device_search(q_dev[0], K)
    r = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K), truth, K)
    require(abs(r - 0.9972) <= 0.005, f"recall@10 {r} not within 0.005 of 0.9972")
    srv = serve(ix, q_dev, iters=50)
    say("5 narrow", route=route, n=n, batch=b, build_s=round(build_s, 2),
        recall=r, **srv)


def uniform_1m() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The 1M x 128 uniform corpus of phases 6 and 9-11 (the reference's
    flat1m and ivf1m rows), 4096 queries, and the ground truth of the first
    1024."""
    base = synthetic(1_000_000, 128)
    queries = synthetic_queries(4 * 1024, 128)
    return base, queries, ground_truth(base, queries[:1024], K, block=16384)


def phase_flat(dev, data) -> None:
    base, queries, truth = data
    n, d, b = base.shape[0], base.shape[1], 1024
    ix = FlatIndex(d, "L2", device=dev, selection="pallas")
    ix.add_batch([str(i) for i in range(n)], base)
    require(ix.describe_scan(b) == "flat-pallas", "flat route")
    rec, not_ties = exact_misses_are_ties(ix, base, queries[:b], truth)
    require(not_ties == 0, f"exact flat recall {rec}: {not_ties} misses beyond fp32 ties")
    q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev) for i in range(4)]
    srv = serve(ix, q_dev, iters=50)
    say("6 flat", route="flat-pallas", n=n, batch=b, recall=rec,
        misses_beyond_fp32_ties=not_ties, **srv)


def phase_pq(dev, data) -> None:
    """The IVF-PQ path at SIFT1M scale: Delta(Flat, IVF_PQ sq8res)."""
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                  params=IndexParams(nlist=1000, pq_m=16, k=256,
                                                     refine_storage="sq8res")),
                      device=dev)
    ix.add_batch([str(i) for i in range(n)], base)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    tail = ix.tail
    require(all(key not in tail._dev for key in ("xraw", "xsqnorm")),
            "an sq8res index holds an fp32 rerank slab")
    route = tail.describe_scan(256)
    require(route == "dense-sq8-pallas-win", f"1M nlist 1000 sq8res route is {route}")
    launches = fs.LAUNCHES["sq8_scan"]
    r_search = recall(ix.search_batch(queries[:1024], K), truth)
    q1024 = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev) for i in range(8)]
    _, rows = ix.device_search(q1024[0], K)
    r_device = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)
    require(fs.LAUNCHES["sq8_scan"] > launches, "SQ8 kernel never launched")
    require(r_search >= 0.9736 and r_device >= 0.9736,
            f"recall@10 {r_search}/{r_device} < 0.9736")
    q256 = [torch.from_numpy(queries[i * 256:(i + 1) * 256]).to(dev) for i in range(32)]
    s256, s1024 = serve(ix, q256, iters=400), serve(ix, q1024, iters=100)
    # per-layer times of one batch (CUDA events, median)
    tdev = tail._sync()
    layers = {}
    for qb in (q256[0], q1024[0]):
        def rank():
            return rank_probes(qb, tdev["cents"], tdev["cvalid"], tdev["offsets"],
                               tdev["lens"], 3, n, Metric.L2)[0]
        probe, qc = rank(), qb @ tdev["cents"].T
        layers[f"b{len(qb)}_rank_probes_ms"] = round(cuda_ms(rank, 10), 3)
        layers[f"b{len(qb)}_qc_ms"] = round(cuda_ms(lambda: qb @ tdev["cents"].T, 10), 3)
        layers[f"b{len(qb)}_sq8_scan_plus_merge_ms"] = round(cuda_ms(
            lambda: fs.fused_ivf_sq8_topk(
                qb, tdev["codes8"], tdev["mins"], tdev["scales"], tdev["sq8norm"],
                tdev["alive"], tdev["crow"], tdev["offsets"], tdev["lens"], probe, qc,
                tdev["cents"].shape[0], K, max_len=tdev["l_pad"]), 10), 3)
    layers["trace_40_b1024"] = repr(device_shares(lambda: ix.device_search(q1024[0], K), 40))
    say("7 pq", route=route, n=n, build_s=round(build_s, 2),
        recall_search_batch=r_search, recall_device_search=r_device,
        **{f"b256_{k}": v for k, v in s256.items()},
        **{f"b1024_{k}": v for k, v in s1024.items()}, **layers,
        memory_bytes=repr(tail.memory_bytes()),
        cuda_memory_allocated=torch.cuda.memory_allocated(dev),
        build_peak_cuda_memory=build_peak)


def _pq_narrow_index(dev, base, **kw) -> tuple[IvfPqIndex, float]:
    ix = IvfPqIndex(base.shape[1], "L2", device=dev, nlist=100, pq_m=16, ksub=256, **kw)
    ix.add_batch([str(i) for i in range(len(base))], base)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    return ix, time.perf_counter() - t0


def phase_pq_narrow(dev) -> None:
    n, d, b = 100_000, 128, 1024
    base = synthetic_clustered(n, d, n_clusters=100)
    queries = synthetic_clustered_queries(b, d, n_clusters=100)
    truth = ground_truth(base, queries, K, block=16384)
    q_dev = [torch.from_numpy(queries).to(dev)]

    def device_recall(ix) -> float:
        _, rows = ix.device_search(q_dev[0], K)
        return recall_at_k(id_lists_to_rows(ix.resolve_rows(rows.cpu().numpy()), K),
                           truth, K)

    ix, build_s = _pq_narrow_index(dev, base, refine_storage="sq8res")
    route = ix.describe_scan(b)
    require(route == "dense-sq8-pallas", f"100k nlist 100 sq8res route is {route}")
    launches = fs.LAUNCHES["sq8_scan"]
    r = device_recall(ix)
    require(fs.LAUNCHES["sq8_scan"] > launches, "SQ8 kernel never launched")
    require(r >= 0.9783, f"recall@10 {r} < 0.9783")
    srv = serve(ix, q_dev, iters=50)
    ix.scan_mode = "probe"        # the ADC shortlist, reranked off the SQ8 slab
    probe_route = ix.describe_scan(b)
    require(probe_route == "probe-adc+rerank-sq8", f"probe route is {probe_route}")
    r_probe = device_recall(ix)
    s_probe = serve(ix, q_dev, iters=10)
    say("8 pq narrow", route=route, n=n, batch=b, build_s=round(build_s, 2),
        recall=r, **srv, probe_route=probe_route, probe_recall=r_probe,
        probe_qps=s_probe["qps"], probe_p50_ms=s_probe["p50_ms"])

    twin, _ = _pq_narrow_index(dev, base, refine_storage="sq8res")
    same = {
        "centroids": np.array_equal(ix.get_centroids(), twin.get_centroids()),
        "codebooks": np.array_equal(ix.pq.codebooks, twin.pq.codebooks),
        "pq_codes": np.array_equal(ix._codes, twin._codes),
        "sq8_codes": all(torch.equal(ix._dev[key], twin._dev[key])
                         for key in ("codes8", "mins", "scales", "sq8norm")),
    }
    require(all(same.values()), f"two builds from one seed differ: {same}")
    del ix, twin

    reg = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                   params=IndexParams(nlist=100, pq_m=16, k=256)),
                       device=dev)                 # refine_storage: fp32
    reg.add_batch([str(i) for i in range(len(base))], base)
    reg.build()
    fp32_route = reg.tail.describe_scan(b)
    require(fp32_route == "dense-exact-pallas", f"fp32 rerank slab route is {fp32_route}")
    launches = fs.LAUNCHES["ivf_scan"]
    r_fp32 = device_recall(reg)
    require(fs.LAUNCHES["ivf_scan"] > launches, "IVF kernel never launched")
    say("8 pq narrow", deterministic_rebuild=repr(same), fp32_route=fp32_route,
        fp32_recall=r_fp32, fp32_qps=serve(reg, q_dev, iters=20)["qps"])


def phase_flat_bf16(dev, data) -> None:
    """flat1m_pallas: the bf16 slab through the bf16 flat scan."""
    base, queries, truth = data
    n, d = base.shape
    ix = FlatIndex(d, "L2", device=dev, storage="bf16", selection="pallas")
    ix.add_batch([str(i) for i in range(n)], base)
    routes = {b: ix.describe_scan(b) for b in (1024, 64)}
    require(set(routes.values()) == {"flat-pallas"}, f"flat bf16 routes {routes}")
    require(ix._sync()["vecs"].dtype == torch.bfloat16, "the flat slab is not bf16")
    r1024 = recall(ix.search_batch(queries[:1024], K), truth)
    require(abs(r1024 - 0.9817) <= 0.005,
            f"flat bf16 b1024 recall@10 {r1024} not within 0.005 of 0.9817")
    r64 = recall([r for s in range(0, 256, 64) for r in ix.search_batch(queries[s:s + 64], K)],
                 truth[:256])
    q1024 = [torch.from_numpy(queries[i * 1024:(i + 1) * 1024]).to(dev) for i in range(4)]
    q64 = [torch.from_numpy(queries[i * 64:(i + 1) * 64]).to(dev) for i in range(16)]
    s1024, s64 = serve(ix, q1024, iters=50), serve(ix, q64, iters=200)
    say("9 flat bf16", route="flat-pallas", n=n, recall_b1024=r1024,
        recall_b64_first256=r64, reference="0.9817 (b1024), 0.9855 (b64)",
        **{f"b1024_{k}": v for k, v in s1024.items()},
        **{f"b64_{k}": v for k, v in s64.items()})


def phase_flat_hybrid(dev, data) -> None:
    """flat1m_hybrid (b64), flat1m_hybrid_b256: the bf16 twin scanned for a
    top-R shortlist, reranked off the fp32 slab; b1024 scans the fp32 slab."""
    base, queries, truth = data
    n, d = base.shape
    ix = FlatIndex(d, "L2", device=dev, selection="hybrid")
    ix.add_batch([str(i) for i in range(n)], base)
    routes = {b: ix.describe_scan(b) for b in (64, 256, 1024)}
    require(routes == {64: "flat-pallas-hybrid", 256: "flat-pallas-hybrid",
                       1024: "flat-pallas"}, f"flat hybrid routes {routes}")
    fields = {}
    for b in (64, 256, 1024):
        rec_b, not_ties = exact_misses_are_ties(ix, base, queries[:1024], truth, batch=b)
        require(not_ties == 0, f"flat hybrid b{b} recall {rec_b}: {not_ties} misses "
                "beyond fp32 ties")
        q_dev = [torch.from_numpy(queries[i * b:(i + 1) * b]).to(dev)
                 for i in range(len(queries) // b)]
        srv = serve(ix, q_dev, iters=max(50, 12_800 // b))
        fields.update({f"b{b}_route": routes[b], f"b{b}_recall": rec_b,
                       **{f"b{b}_{k}": v for k, v in srv.items()}})
    say("10 flat hybrid", n=n, R=ix._shortlist(K), misses_beyond_fp32_ties=0,
        reference="recall 1.0 (flat1m_hybrid, flat1m_hybrid_b256)", **fields)


def _hybrid_against_fp32(dev, ix, queries, truth, name, route):
    """The b256 hybrid route's hits against the fp32 list scan's on the same
    queries (sent as the first 256 of a b1024 batch); recall and QPS."""
    require(ix.describe_scan(256) == route, f"{name} b256 route {ix.describe_scan(256)}")
    require(ix.describe_scan(1024) == route[:-len("-hybrid")],
            f"{name} b1024 route {ix.describe_scan(1024)}")
    q1024 = torch.from_numpy(queries[:1024]).to(dev)
    q256 = q1024[:256].contiguous()
    hybrid = ix.device_search(q256, K)
    fp32 = ix.device_search(q1024, K)
    err, swaps = compare(hybrid, tuple(t[:256] for t in fp32), f"{name} hybrid vs fp32")
    rows = id_lists_to_rows(ix.resolve_rows(hybrid[1].cpu().numpy()), K)
    srv = serve(ix, [q1024[i * 256:(i + 1) * 256].contiguous() for i in range(4)], iters=200)
    return {f"{name}_route": route, f"{name}_max_abs_err_vs_fp32": err,
            f"{name}_kth_ties": swaps, f"{name}_recall_b256": recall_at_k(rows, truth[:256], K),
            **{f"{name}_b256_{k}": v for k, v in srv.items()}}


def phase_ivf_hybrid(dev, data) -> None:
    """ivf100k_np96_hybrid_b256 and ivf1m_np256_hybrid_b256."""
    base, queries, truth = data
    n, d = base.shape
    small, small_q = synthetic(100_000, d), synthetic_queries(1024, d)
    narrow = IvfFlatIndex(d, "L2", device=dev, nlist=100, nprobe=96, selection="hybrid")
    narrow.add_batch([str(i) for i in range(len(small))], small)
    narrow.build()
    fields = _hybrid_against_fp32(dev, narrow, small_q,
                                  ground_truth(small, small_q[:256], K, block=16384),
                                  "ivf100k_np96", "dense-pallas-hybrid")
    del narrow
    wide = IvfFlatIndex(d, "L2", device=dev, nlist=1000, nprobe=256,
                        train_dtype="bfloat16", selection="hybrid")
    wide.add_batch([str(i) for i in range(n)], base)
    t0 = time.perf_counter()
    wide.build()
    torch.cuda.synchronize()
    fields["ivf1m_np256_build_s"] = round(time.perf_counter() - t0, 2)
    fields.update(_hybrid_against_fp32(dev, wide, queries, truth, "ivf1m_np256",
                                       "dense-pallas-win-hybrid"))
    say("11 ivf hybrid", R=wide._shortlist(wide._sync(), K), **fields)


def phase_pq_bf16(dev, data) -> None:
    """ivfpq1m_bf16slab: Delta(Flat, IVF_PQ) with a bf16 rerank slab, scanned
    by the bf16 list scan with promote."""
    base, queries, truth = data
    n, d = base.shape
    ix = create_index(IndexConfig(dim=d, metric=Metric.L2, algorithm="IVF_PQ",
                                  params=IndexParams(nlist=1000, pq_m=16, k=256,
                                                     refine_storage="bf16")),
                      device=dev)
    ix.tail.train_dtype = "bfloat16"   # the reference row's training dtype
    ix.add_batch([str(i) for i in range(n)], base)
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    ix.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_alloc = torch.cuda.memory_allocated(dev) - alloc0
    tail = ix.tail
    route = tail.describe_scan(64)
    require(route == "dense-exact-pallas-win", f"1M bf16-slab route is {route}")
    # the slab as it lies on the card: npad = slab_pad(n, l_pad) rows, padding
    # included; its storage must be half an fp32 slab of the same rows
    slab = tail._dev["xraw"]
    npad = slab.shape[0]
    slab_bytes = slab.untyped_storage().nbytes()
    require(slab.dtype == torch.bfloat16 and slab.shape[1] == d and npad >= n
            and 2 * slab_bytes == npad * d * 4 and n * d * 2 == 256_000_000,
            f"bf16 slab {slab.dtype} {tuple(slab.shape)}: {slab_bytes} B of storage, "
            f"an fp32 slab of the same rows {npad * d * 4} B")
    require(build_alloc >= slab_bytes,
            f"the build allocated {build_alloc} B, less than its {slab_bytes} B slab")
    q64 = [torch.from_numpy(queries[i * 64:(i + 1) * 64]).to(dev) for i in range(16)]
    rows = np.concatenate([ix.device_search(qb, K)[1].cpu().numpy() for qb in q64])
    r = recall_at_k(id_lists_to_rows(ix.resolve_rows(rows), K), truth, K)
    require(abs(r - 0.725) <= 0.03, f"bf16-slab recall@10 {r} not within 0.03 of 0.725")
    srv = serve(ix, q64, iters=400)
    say("12 pq bf16", route=route, n=n, build_s=round(build_s, 2), recall_1024_b64=r,
        reference=0.725, slab_rows=npad, slab_bytes=slab_bytes,
        slab_bytes_unpadded=n * d * 2, build_allocated_bytes=build_alloc,
        memory_bytes_as_counted=repr(tail.memory_bytes()),
        **{f"b64_{k}": v for k, v in srv.items()})


def run_path(name: str, fn, kernels: tuple[str, ...]) -> dict:
    """One serving path: the launch counts zeroed before it and read after;
    each of ``kernels`` must have run on it."""
    fs.reset_launches()
    fn()
    torch.cuda.synchronize()
    got = dict(fs.LAUNCHES)
    for kernel in kernels:
        require(got[kernel] > 0, f"kernel {kernel} was not launched on the {name} path")
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device()
    phase_build()
    rec = phase_kernels(dev)

    data, uniform = clustered_1m(), uniform_1m()

    def ivf_flat():  # phases 4-6
        phase_slice(dev, dict(fs.LAUNCHES), data)
        phase_narrow(dev)
        phase_flat(dev, uniform)

    def ivf_pq():    # phases 7-8
        phase_pq(dev, data)
        phase_pq_narrow(dev)

    paths = {name: run_path(name, fn, kernels) for name, fn, kernels in (
        ("IVF-Flat", ivf_flat, ("flat_scan", "ivf_scan", "merge")),
        ("IVF-PQ", ivf_pq, ("sq8_scan", "ivf_scan", "merge")),
        ("flat bf16", lambda: phase_flat_bf16(dev, uniform), ("flat_scan_bf16", "merge")),
        ("flat hybrid", lambda: phase_flat_hybrid(dev, uniform),
         ("flat_scan_bf16", "flat_scan", "merge")),
        ("IVF-Flat hybrid", lambda: phase_ivf_hybrid(dev, uniform),
         ("ivf_scan_bf16", "ivf_scan", "merge")),
        ("IVF-PQ bf16", lambda: phase_pq_bf16(dev, data), ("ivf_scan_bf16", "merge")),
    )}
    say("launches", **{name.replace(" ", "_"): repr(got) for name, got in paths.items()})
    launches = {name: sum(got[name] for got in paths.values()) for name in fs.LAUNCHES}
    # the list scan's bf16 mode runs without promote on the hybrid path only,
    # with promote on the bf16-slab path only
    bf16_plain = paths["IVF-Flat hybrid"]["ivf_scan_bf16"]
    bf16_promote = paths["IVF-PQ bf16"]["ivf_scan_bf16"]

    def entry(name, kind, source, replaces, launched):
        r = rec[kind]
        bound_ms, bound_by = r["bound"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launched, "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": r["library_ms"], "composition_ms": r["composition_ms"]}

    kernels = [
        entry("fused_scan_kernel", "flat", SOURCE, f"{PALLAS}:672", launches["flat_scan"]),
        entry("fused_scan_kernel<bf16>", "flat_bf16", SOURCE, f"{PALLAS}:672, {PALLAS}:232",
              launches["flat_scan_bf16"]),
        entry("ivf_list_scan_kernel<IVF>", "ivf", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992", launches["ivf_scan"]),
        entry("ivf_list_scan_kernel<BF16>", "ivf_bf16", LIST_SOURCE,
              f"{PALLAS}:1035, {PALLAS}:992, {PALLAS}:232", bf16_plain),
        entry("ivf_list_scan_kernel<BF16> promote_fp32", "ivf_bf16p", LIST_SOURCE,
              f"{PALLAS}:992, {PALLAS}:1035, {PALLAS}:232", bf16_promote),
        entry("ivf_list_scan_kernel<SQ8>", "sq8", LIST_SOURCE,
              f"{PALLAS}:1204, {PALLAS}:1341", launches["sq8_scan"]),
        entry("merge_partials_kernel", "merge", SOURCE, f"{PALLAS}:401", launches["merge"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
