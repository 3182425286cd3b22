"""Exact scans + running top-k: wrappers of the CUDA kernels in
``pyrope_tpu_torch/csrc/`` and their plain PyTorch twins.

Replaces ``pyrope_tpu/ops/pallas_scan.py``:
  - ``fused_flat_topk``  <- ``pallas_flat_topk`` (K1, :672): the flat scan
    kernel (csrc/fused_scan.cu; over a bf16 slab the tensor-core kernel of
    csrc/flat_scan_tc.cu), corpus splits into [B, splits, k] partials;
    ``flat_tile`` picks its query tile, ``scan_splits`` its grid.
  - ``fused_ivf_topk``   <- ``pallas_ivf_topk`` (K2, :1035) and
    ``pallas_ivf_topk_windowed`` (K3, :992) (over a bf16 slab at k <=
    NARROW_MAX_K: without ``promote_fp32`` the tensor-core list scan of
    csrc/ivf_list_scan_tc.cu, with it at D <= PROMOTE_MAX_D the bulk-copy
    list scan of csrc/ivf_list_scan_promote.cu), and
  - ``fused_ivf_sq8_topk`` <- ``pallas_ivf_sq8_topk`` (K4, :1204) and
    ``pallas_ivf_sq8_topk_windowed`` (K5, :1341): the cluster-major list
    scan (csrc/ivf_list_scan.cu). The TPU kernels scan the whole slab and
    mask the rows of unprobed clusters (K3/K5 add a per-tile cluster window,
    K4/K5 a masked [B, Kp] centroid-dot table); here the probe lists are
    inverted on the device (``invert_probes``) and each probed cluster's
    rows (``offsets``/``lens``, the CSR the indexes keep) are scanned once
    for the queries that probe it. The SQ8 scan reads qc = q·centsᵀ once
    per (query, cluster).
All end in the merge kernel that reduces the per-split or per-list sorted
partials, the work of the Pallas bodies' ``_merge_tile`` (:401) and
``_finish_topk`` (:642).

bf16 slabs (the branch ``x.dtype == bfloat16`` of the TPU kernels'
``_tile_scores``, :232-264): ``fused_flat_topk`` and ``fused_ivf_topk`` take
a bf16 ``x``. The flat scan and the list scan without ``promote_fp32``
score bf16(q) against the bf16 rows (the MXU's single bf16 pass: exact
products, fp32 sums), the flat scan and the narrow list scan on the tensor
cores; ``fused_ivf_topk(promote_fp32=True)`` scores the fp32 q against the
widened rows on the CUDA cores (at k <= NARROW_MAX_K and D <= PROMOTE_MAX_D
its own kernel, ``list_plan``), as the wide list scan does without promote.
In both, ‖q‖² is that of the fp32 q and ``sqnorm`` that of the fp32 rows
before the cast.

k is any k >= 1 and D is any: k <= NARROW_MAX_K (128) runs the
warp-register lists; above it each kernel's wide mode (the TPU kernels'
wide merges, ``_wide_params`` :372, ``_bitonic_merge_wide`` :192,
``_merge_tile_wide`` :200, ``_extract_top`` :496; csrc/topk_wide.cuh) keeps
each list in global memory (the partials) behind a candidate buffer in
shared memory. A list holds no more than its part of the rows can give:
the list scan's wide slots ``list_slot_width`` = min(k, seg, max_len)
entries, the flat scan's wide splits min(k, rows a split). Above the rows
present, the answer is padded with -inf/-1, as ``_finish_topk`` pads.
``LAUNCHES`` counts the wide modes under their own ``_wide`` keys.

The wide flat scans (fp32 and bf16) and the wide list scan (every mode) may
run a first pass that forms each query's floor before the wide pass keeps
any row (``flat_prefloor_plan``, ``list_prefloor_plan``: decided on the host
from shapes alone): a narrow launch of the same kernel at k = c <=
NARROW_MAX_K over a sample of each split or segment publishes each split's
or slot's c-th entry, and each query's g-th largest, g = ceil(k / c), is its
floor (``floor_select_plain`` is the plain version): the flat first passes
take it in their own launch (the split that completes a query tile, csrc/
floor_tail.cuh), the list scans' with the floor select kernel (csrc/
prefloor.cu); the wide pass keeps rows at or above it. ``LAUNCHES`` counts
them under ``flat_scan_prefloor`` (``_bf16``: the tensor-core pass),
``list_scan_prefloor`` (``_tc``) and ``floor_select``.

What bounds each kernel on an H100, and what its design does about it, is
in the header of its CUDA source.

Semantics, shared with the JAX kernels: L2 scores -max(‖q‖²−2q·x+‖x‖², 0),
IP scores q·x (x the reconstruction x̂ in SQ8 mode); cosine raises
(callers pre-normalize and use IP). Hits are ordered by (score desc, row
asc); missing hits are -inf/-1.

Dispatch is by where the tensors lie: on the CPU the wrapper runs the plain
version; on a CUDA device it launches the kernel or raises. There is no
path from a CUDA tensor to the plain version. Each kernel launch adds one
to ``LAUNCHES``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import numbers
import threading
import time

import torch

from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.ops.distance import check_fp32_exact

# MAXK, BT and RT of the CUDA sources
NARROW_MAX_K = 128       # MAXK: warp-register lists (4 slots a lane) up to here
QUERY_TILE = 64          # queries per list chunk; the flat scan's narrow tile
FLAT_QUERY_TILES = (128, 64)  # the flat scan's instantiations, widest first
ROW_TILE = 128           # corpus rows per tile
FLAT_STAGES = 2          # NST of fused_scan.cu: stages in the copy ring
FLAT_DEPTH_CHUNK = 32    # DC of fused_scan.cu: fp32 depths a stage holds (128 bytes)
TC_DEPTH_CHUNK = 64      # TC_DC of flat_scan_tc.cu: bf16 depths a stage holds (128 bytes)
TC_STAGES = (4, 3, 2)    # its ring's stages, the most that fit first (tc_stages)
TC_QRES_MAX_D = 256      # q resident in its shared memory up to this D, streamed above
TC_FLUSH_MIN = 32        # its wide mode: buffers of this many flush at the floor's tiles
FLAT_FLOOR_WINDOW = 32   # WIN: splits whose published scores a warp reads
FLAT_WIDE_TILE = 64      # WIDE_BT: the flat scan's query tile at k > NARROW_MAX_K
FLAT_WIDE_CAP = 256      # FLAT_CAP: its candidate buffer, a query
FLAT_WIDE_SMALL_CAP = 64  # FLAT_SMALL_CAP: the same behind a first pass's floor
LIST_WIDE_CAP = 128      # LCAP: the list scan's candidate buffer, a list
LIST_FLOOR_WINDOW = 128  # FWIN: slots whose published keys a list-scan warp reads
LIST_FLOOR_SLOTS = 8     # the most slots list_floor waits for before a floor forms
LIST_FLOOR_MIN_K = 32    # below it list_floor takes g = 1: a list's own k-th entry
LIST_SEG = 2048          # rows of one cluster a list-scan block walks at most
LIST_SEG_MIN = 256       # shortest segment list_seg cuts for parallelism
# the tensor-core list scan (csrc/ivf_list_scan_tc.cu, k <= NARROW_MAX_K):
# its shortest segment (list_plan), and its first pass's sample ratio
# (list_prefloor_plan)
LIST_TC_SEG_MIN = 512
LIST_TC_SPLIT_D = 128    # LT_SPLIT_D: above it each 64-depth chunk is summed apart
LIST_TC_PREFLOOR_RATIO = 80.0
# the bf16 list scan with promote (csrc/ivf_list_scan_promote.cu, k <=
# NARROW_MAX_K): the widest D it takes (32 lanes x 8 depths a row, the
# queries whole in shared memory), its ring's stages (promote_stages), and
# its segment rule (promote_seg): from PROMOTE_SEG_MAX halved, down to
# PROMOTE_SEG_MIN, while the grid bound holds fewer than
# PROMOTE_ITEMS_PER_SM items an SM; its blocks walk the items (swept on an
# H100 by bench/scan_ab.py --sweep, PERF.md: 2 items an SM against 4,
# 6 and 12 at 1M np3 b64 and b1024)
PROMOTE_MAX_D = 256
PROMOTE_STAGES = (6, 5, 4, 3)
PROMOTE_WARPS = 8        # PM_WARPS: consumer warps, a tile of rows each a stage
PROMOTE_SEG_MAX = 2048
PROMOTE_SEG_MIN = 256
PROMOTE_ITEMS_PER_SM = 2
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use on sm_90
SMEM_TWO_BLOCKS = 115_712  # the most a block may use for two to share an SM
                           # (233,472 B an SM, 1,024 B a block reserved)
# the list scan's modes (ivf_list_scan.cu Mode) and their slab element bytes
LIST_IVF, LIST_SQ8, LIST_BF16 = 1, 2, 3
_LIST_ELEM = {LIST_IVF: 4, LIST_SQ8: 1, LIST_BF16: 2}
LIST_DEPTH_CHUNK = 64    # DCH of ivf_list_scan.cu: depth elements a stage
LIST_LD_PAD = 4          # QLD - DCH and XLD - DCH: the padding of its stage rows
_BLOCKS_PER_SM = 4       # list-scan grid target: blocks in flight per SM
_FLAT_BLOCKS_PER_SM = 2  # flat grid target: one wave of two blocks an SM
# the wide modes' first pass (flat_prefloor_plan, list_prefloor_plan): the
# share of a query's splits (slots) whose c-th entries the floor needs, the
# fewest probes at which the list scan runs it, and the sample rule: a
# share f = min(1, sqrt(ratio * k / rows a query)) of each split's
# (segment's) rows, which balances the first pass's FMAs (~f) against the
# rows the floor lets through (~k / f); the ratios and the flat first pass's
# two waves were chosen on an H100 by bench/scan_ab.py --sweep (PERF.md, PR
# 10): the list scan's first pass is dear a row, the flat scan's second
# pass a kept row
FLAT_PREFLOOR_SHARE = 7 / 8
FLAT_PREFLOOR_WAVES = 2      # the flat first pass's grid: waves of two blocks an SM
LIST_PREFLOOR_SHARE = 3 / 4
LIST_PREFLOOR_MIN_PROBES = 16
FLAT_PREFLOOR_RATIO = 20.0
LIST_PREFLOOR_RATIO = 5.0
# the bf16 flat scan's first pass (flat_prefloor_plan(..., elem=2)) runs
# one wave of the narrow tensor-core grid (flat_blocks_per_sm), with its own
# sample ratio: on the tensor cores a sampled row costs a vote and no
# insertion, and every row the floor lets through costs an offer, so the
# sample is whole splits at the main shapes (on an H100 at 1M x 128,
# bench/scan_ab.py --sweep: b256 k512 device 2.088 / 1.435 / 1.266 / 1.233
# ms at ratios 80 / 320 / 1280 / 5120)
FLAT_TC_PREFLOOR_RATIO = 5120.0

# launches of each kernel since the last reset_launches(); the ``_wide``
# keys count the wide mode (k > NARROW_MAX_K) of the same kernel. Servers
# launch from several threads at once: counts change only under the lock
# (count_launch), so none is lost
# (``ivf_scan_bf16[_wide]``: the CUDA-core list scan's bf16 mode, with
# promote_fp32 above PROMOTE_MAX_D, and at k > NARROW_MAX_K with or without
# it; ``ivf_scan_bf16_promote``: the bulk-copy list scan, with promote at k
# <= NARROW_MAX_K and D <= PROMOTE_MAX_D; ``ivf_scan_bf16_tc``: the
# tensor-core list scan, without promote at k <= NARROW_MAX_K, and
# ``list_scan_prefloor_tc`` its first pass; ``floor_select``: the list
# scans' first-pass floor select, the flat first passes taking their own;
# ``flat_scan_bf16_prefloor``: the bf16 flat scan's first pass)
LAUNCHES = {"flat_scan": 0, "flat_scan_bf16": 0, "ivf_scan": 0, "ivf_scan_bf16": 0,
            "ivf_scan_bf16_promote": 0, "ivf_scan_bf16_tc": 0, "sq8_scan": 0, "merge": 0,
            "flat_scan_wide": 0, "flat_scan_bf16_wide": 0, "ivf_scan_wide": 0,
            "ivf_scan_bf16_wide": 0, "sq8_scan_wide": 0, "merge_wide": 0,
            "flat_scan_prefloor": 0, "flat_scan_bf16_prefloor": 0, "list_scan_prefloor": 0,
            "list_scan_prefloor_tc": 0, "floor_select": 0, "invert_probes": 0}


_LAUNCH_LOCK = threading.Lock()


def count_launch(key: str) -> None:
    """One launch of kernel ``key``, counted where its wrapper launched it."""
    with _LAUNCH_LOCK:
        LAUNCHES[key] += 1


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


# the list-scan wrapper's host steps, recorded while host_split() runs in
# this thread: (step, perf_counter) marks, each at the end of its step
_SPLIT = threading.local()


def _mark(step: str) -> None:
    marks = getattr(_SPLIT, "marks", None)
    if marks is not None:
        marks.append((step, time.perf_counter()))


@contextlib.contextmanager
def host_split():
    """Record the host time of each step of the list-scan calls this thread
    makes inside: yields a list that takes (step, seconds) pairs, call by
    call (``checks``, ``plan``, ``alloc``, ``invert``, ``first_pass``,
    ``scan``, ``merge``), each the host time from the step before, the
    first from the wrapper's entry. No device sync: what each step costs to
    enqueue."""
    marks, out = [], []
    _SPLIT.marks = marks
    try:
        yield out
    finally:
        _SPLIT.marks = None
        for (_, t0), (step, t1) in zip(marks, marks[1:]):
            if step != "start":
                out.append((step, t1 - t0))


# ---- plain PyTorch versions -------------------------------------------------


def _l2_or_ip(q, dots, sq, metric_ip: bool):
    if metric_ip:
        return dots
    qq = (q * q).sum(dim=-1, keepdim=True)
    return -torch.clamp(qq - 2.0 * dots + sq[None, :], min=0.0)


def _plain_scan(q, n, tile_scores, row_mask, k, chunk_rows):
    """Running top-k over row chunks. ``tile_scores(s, e)`` -> [B, e-s]
    scores, ``row_mask(s, e)`` -> [B|1, e-s] bool. Candidates are
    concatenated in row order after the running best (whose rows are all
    lower), so a stable sort on the float values keeps (score desc, row
    asc) with the kernels' float comparison (-0 == +0)."""
    check_fp32_exact(q)
    b = q.shape[0]
    best_v = torch.full((b, k), float("-inf"), device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=q.device)
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        sc = torch.where(row_mask(s, e), tile_scores(s, e), float("-inf"))
        rows = torch.arange(s, e, device=q.device).expand(b, -1)
        cand_v = torch.cat([best_v, sc], dim=1)
        cand_i = torch.cat([best_i, rows], dim=1)
        best_v, pos = torch.sort(cand_v, dim=1, descending=True, stable=True)
        best_v, pos = best_v[:, :k], pos[:, :k]
        best_i = torch.gather(cand_i, 1, pos)
    best_i = torch.where(torch.isfinite(best_v), best_i, -1)
    return best_v, best_i.int()


def _tile_scores(q, x, sqnorm, metric_ip: bool, promote: bool = False):
    """``tile_scores`` of the plain scans, as the TPU kernels' ``_tile_scores``
    takes them: fp32 dots off an fp32 slab; off a bf16 slab, dots of bf16(q)
    (the fp32 q with ``promote``) and the widened rows, summed in fp32. ‖q‖²
    is always that of the unrounded fp32 q."""
    qd = q.bfloat16().float() if x.dtype == torch.bfloat16 and not promote else q
    return lambda s, e: _l2_or_ip(q, qd @ x[s:e].float().T, sqnorm[s:e], metric_ip)


def fused_flat_topk_plain(q, x, sqnorm, alive, max_scans: int, k: int,
                          metric=Metric.L2, *, chunk_rows: int = 8192):
    """Plain version of ``fused_flat_topk``: same inputs, same outputs."""
    metric_ip = _metric_ip(metric)
    ms = int(max_scans)

    def row_mask(s, e):
        rows = torch.arange(s, e, device=q.device)
        return (alive[s:e] & (rows < ms))[None, :]

    return _plain_scan(q, x.shape[0], _tile_scores(q, x, sqnorm, metric_ip),
                       row_mask, k, chunk_rows)


def probe_table(probe: torch.Tensor, kp: int) -> torch.Tensor:
    """[B, nprobe] probe ids -> [B, kp] bool membership table."""
    t = torch.zeros((probe.shape[0], kp), dtype=torch.bool, device=probe.device)
    return t.scatter_(1, probe.long(), True)  # in place on a fresh table


def fused_ivf_topk_plain(q, x, sqnorm, alive, crow, probe, kp: int, k: int,
                         metric=Metric.L2, *, promote_fp32: bool = False,
                         chunk_rows: int = 8192):
    """Plain version of ``fused_ivf_topk``: same inputs, same outputs."""
    metric_ip = _metric_ip(metric)
    return _plain_scan(q, x.shape[0], _tile_scores(q, x, sqnorm, metric_ip, promote_fp32),
                       _probed_rows(probe, kp, crow, alive), k, chunk_rows)


def _probed_rows(probe, kp, crow, alive):
    """row_mask of the IVF scans: alive and in a probed cluster."""
    table = probe_table(probe, kp)
    crow_l = crow.long()
    return lambda s, e: table[:, crow_l[s:e]] & alive[None, s:e]


def sq8_scores(q, qc, codes, mins, scales, sqnorm, crow, metric_ip: bool):
    """[B, n] scores off residual-SQ8 rows, as the JAX package's
    ``_tile_scores_sq8`` and its XLA twin compute them: q·x̂ = qc[b, crow]
    + (q·code)·scale + (Σq)·min, with qc = q·centsᵀ."""
    dots8 = q @ codes.float().T
    qx = (qc[:, crow.long()] + dots8 * scales[None, :]
          + q.sum(dim=1, keepdim=True) * mins[None, :])
    return _l2_or_ip(q, qx, sqnorm, metric_ip)


def fused_ivf_sq8_topk_plain(q, codes, mins, scales, sqnorm, alive, crow, probe,
                             qc, kp: int, k: int, metric=Metric.L2, *,
                             chunk_rows: int = 8192):
    """Plain version of ``fused_ivf_sq8_topk``: same inputs, same outputs."""
    metric_ip = _metric_ip(metric)

    def tile_scores(s, e):
        return sq8_scores(q, qc, codes[s:e], mins[s:e], scales[s:e], sqnorm[s:e],
                          crow[s:e], metric_ip)

    return _plain_scan(q, codes.shape[0], tile_scores,
                       _probed_rows(probe, kp, crow, alive), k, chunk_rows)


# ---- kernel wrappers ---------------------------------------------------------


def _metric_ip(metric) -> bool:
    metric = Metric.parse(metric)
    if metric == Metric.COSINE:
        raise ValueError("pre-normalize rows and use IP for cosine")
    return metric == Metric.INNER_PRODUCT


_FP_SLABS = (torch.float32, torch.bfloat16)


def k_refusal(k: int) -> str | None:
    """Why the kernels do not take ``k`` hits a query, or None: they take
    any k >= 1, as the JAX package's kernels do."""
    return None if k >= 1 else f"k must be at least 1, got {k}"


def list_scan_smem_bytes(k: int, mode: int) -> int:
    """Shared memory of a list-scan block, as ``list_scan_smem_bytes`` of
    ivf_list_scan.cu computes it: two stages of RT rows x (DCH + 4) slab
    elements and of the chunk's BT queries x (DCH + 4) floats, the row
    tables of two tiles, the per-query tables, and the lists (k <=
    NARROW_MAX_K) or a candidate buffer, its state and a threshold a list
    (the wide mode). It does not depend on D: q is streamed by depth."""
    ld = LIST_DEPTH_CHUNK + LIST_LD_PAD
    lists = (QUERY_TILE * (8 * LIST_WIDE_CAP + 16) if k > NARROW_MAX_K
             else 8 * QUERY_TILE * k)
    return (4 * 2 * QUERY_TILE * ld + 2 * ROW_TILE * ld * _LIST_ELEM[mode]
            + 2 * ROW_TILE * 4 * (4 if mode == LIST_SQ8 else 2)
            + 13 * QUERY_TILE * 4 + lists)


def list_tc_smem_bytes(k: int, d: int, stages: int | None = None) -> int:
    """Shared memory of a tensor-core list-scan block, as ``lt_layout(k, d,
    stages).total`` of ivf_list_scan_tc.cu computes it (``stages`` default:
    ``list_tc_stages``): the ring (a 128-row x 128-byte tile of the slab a
    stage, and the 64 queries' bf16 chunk where q streams above
    TC_QRES_MAX_D), resident A (ceil(d / 64) chunks of 64 x 128 bytes), the
    row table and two mbarriers a stage, two 64-bit keys and seven words a
    query, four warps' staged scores, the lists (64 x k entries), and 1024
    bytes to align the base for the swizzle."""
    if d < 1 or not 1 <= k <= NARROW_MAX_K:
        raise ValueError(f"the tensor-core list scan takes D >= 1 and k in 1..{NARROW_MAX_K},"
                         f" got {d}, {k}")
    if stages is None:
        stages = list_tc_stages(k, d)
    stream = d > TC_QRES_MAX_D
    stage = ROW_TILE * 128 + (QUERY_TILE * 128 if stream else 0)
    resident = 0 if stream else -(-d // TC_DEPTH_CHUNK) * QUERY_TILE * 128
    return (stages * (stage + 4 * ROW_TILE + 16) + resident + 16 * QUERY_TILE
            + 28 * QUERY_TILE + 16 * ROW_TILE + 8 * QUERY_TILE * k + 1024)


def list_tc_stages(k: int, d: int) -> int:
    """Stages of the tensor-core list scan's ring, as ``lt_stages`` of
    ivf_list_scan_tc.cu picks them: the most (4, 3, 2) with which its block
    fits two to an SM at D <= LIST_TC_SPLIT_D (one above it, where the
    chunks' sums take 64 more registers a thread); failing that, the most
    that fit one block an SM."""
    target = SMEM_TWO_BLOCKS if d <= LIST_TC_SPLIT_D else SMEM_LIMIT
    for limit in (target, SMEM_LIMIT):
        for n in TC_STAGES:
            if list_tc_smem_bytes(k, d, n) <= limit:
                return n
    return TC_STAGES[-1]


def promote_lanes(d: int) -> int:
    """Lanes a row of the promote list scan (``pm_lpr``): 16 up to D 128, 32
    above, each an 8-depth piece."""
    return 16 if d <= 128 else 32


def list_promote_smem_bytes(k: int, d: int, stages: int | None = None) -> int:
    """Shared memory of a promote list-scan block, as ``pm_layout(k, d,
    stages).total`` of ivf_list_scan_promote.cu computes it (``stages``
    default: ``promote_stages``): the ring (a stage holds PROMOTE_WARPS
    tiles of 4 x 32 / lanes rows of D rounded up to 8 bf16), its row tables,
    two mbarriers a stage, two 64-bit keys (the window's floor, the
    query's threshold) and five words a query, the 64 queries in fp32, and
    the lists (64 x k entries)."""
    if not 1 <= d <= PROMOTE_MAX_D or not 1 <= k <= NARROW_MAX_K:
        raise ValueError(f"the promote list scan takes D in 1..{PROMOTE_MAX_D} and k in "
                         f"1..{NARROW_MAX_K}, got {d}, {k}")
    if stages is None:
        stages = promote_stages(k, d)
    xs = -(-d // 8) * 8
    rows = PROMOTE_WARPS * 4 * (32 // promote_lanes(d))
    return (stages * (rows * xs * 2 + 4 * rows + 16) + 8 * QUERY_TILE + 28 * QUERY_TILE
            + 4 * QUERY_TILE * xs + 8 * QUERY_TILE * k)


def promote_stages(k: int, d: int) -> int:
    """Stages of the promote list scan's ring, as ``pm_stages``: the most
    of PROMOTE_STAGES with which two blocks share an SM, else the most that
    fit one (D <= PROMOTE_MAX_D always fits three)."""
    for limit in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        for n in PROMOTE_STAGES:
            if list_promote_smem_bytes(k, d, n) <= limit:
                return n
    raise ValueError(f"no ring of the promote list scan fits at k {k}, D {d}")


def list_scan_refusal(k: int, mode: int) -> str | None:
    """Why the list scan does not take ``k`` hits in ``mode``, or None when
    it does: k < 1, or shared memory over what a block may use (which no k
    reaches). Decided on the host from shapes alone."""
    why = k_refusal(k)
    if why is None and list_scan_smem_bytes(k, mode) > SMEM_LIMIT:
        why = (f"k {k} needs {list_scan_smem_bytes(k, mode)} B of shared memory "
               f"in the list scan, over the {SMEM_LIMIT} B a block may use")
    return why


def _check_inputs(q, x, sqnorm, alive, k, extra=(), slab_dtypes=_FP_SLABS):
    """Shapes, dtypes and devices the kernel takes; raises on the rest.
    Returns True when the tensors lie on a CUDA device."""
    why = k_refusal(k)
    if why is not None:
        raise ValueError(why)
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q [B, D] and x [N, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    if x.dtype not in slab_dtypes:
        raise ValueError(f"slab dtype {x.dtype}: this scan takes {slab_dtypes} slabs")
    if q.dtype != torch.float32 or sqnorm.dtype != torch.float32:
        raise ValueError("q and sqnorm must be float32")
    if alive.dtype != torch.bool:
        raise ValueError("alive must be bool")
    n = x.shape[0]
    if sqnorm.shape != (n,) or alive.shape != (n,):
        raise ValueError("sqnorm and alive must be [N]")
    tensors = (q, x, sqnorm, alive, *extra)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must lie on one device")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    return True


def _check_probe(q, x, crow, probe):
    if crow.dtype != torch.int32 or crow.shape != (x.shape[0],):
        raise ValueError("crow must be int32 [N]")
    if probe.dim() != 2 or probe.shape[0] != q.shape[0] or probe.device != q.device:
        raise ValueError("probe must be [B, nprobe] on the queries' device")


def flat_scan_smem_bytes(k: int, query_tile: int, elem: int = 4, d: int = 0,
                         cap: int = FLAT_WIDE_CAP) -> int:
    """Shared memory of a flat-scan block. fp32 rows (``elem`` 4), as
    ``scan_smem_bytes`` of fused_scan.cu computes it: the ring of stages
    (each a depth chunk of the tile's rows, 128 bytes of each, the same
    depths of its queries, and the rows' table), four words a query, and
    the lists (k <= NARROW_MAX_K) or a candidate buffer and its state a
    query (the wide mode: the lists lie in the partials); it does not
    depend on D, q is streamed. bf16 rows (``elem`` 2), as
    ``pyrope_flat_tc_smem_bytes`` of flat_scan_tc.cu computes it at depth
    ``d``, with ``tc_stages`` stages. ``cap``: the wide mode's buffer
    (fp32: ``pyrope_scan_wide_smem_bytes``)."""
    if elem == 2:
        return _tc_smem_bytes(k, query_tile, d, tc_stages(k, query_tile, d, cap), cap)
    stage = ROW_TILE * FLAT_DEPTH_CHUNK + query_tile * FLAT_DEPTH_CHUNK
    lists = (query_tile * (2 * cap + 2) if k > NARROW_MAX_K
             else 2 * query_tile * k)
    return 4 * (FLAT_STAGES * (stage + ROW_TILE) + 4 * query_tile + lists)


def _tc_smem_bytes(k: int, bt: int, d: int, stages: int, cap: int = FLAT_WIDE_CAP) -> int:
    """``tc_layout(k, bt, d, stages, cap).total`` of flat_scan_tc.cu: the
    ring (a 128-row x 128-byte tile of the slab a stage, and the queries'
    chunk where q streams), resident q (ceil(d / 64) chunks of bt x 128
    bytes up to TC_QRES_MAX_D), the row table a stage, the mbarriers, four
    words a query, a warp's staged scores, the lists or the wide buffers
    (``cap`` entries a query) and their states, and 1024 bytes to align the
    base for the swizzle."""
    if d < 1:
        raise ValueError(f"the bf16 flat scan's shared memory depends on D, got {d}")
    stream = d > TC_QRES_MAX_D
    stage = ROW_TILE * 128 + (bt * 128 if stream else 0)
    resident = 0 if stream else -(-d // TC_DEPTH_CHUNK) * bt * 128
    lists = (bt * (8 * cap + 8) if k > NARROW_MAX_K else 8 * bt * k)
    return (stages * (stage + 4 * ROW_TILE) + resident + 8 * (2 * stages + 1)
            + 16 * bt + 4 * ROW_TILE * (bt // 16) + lists + 1024)


def tc_stages(k: int, bt: int, d: int, cap: int = FLAT_WIDE_CAP) -> int:
    """Stages of the bf16 flat scan's ring, as ``tc_stages`` of
    flat_scan_tc.cu picks them (wide buffers of ``cap`` entries): the most
    (4, 3, 2) with which the block fits its target, two blocks an SM for
    the narrow 64-query tile and one otherwise; failing that, the most that
    fit one block an SM."""
    target = SMEM_TWO_BLOCKS if bt == QUERY_TILE and k <= NARROW_MAX_K else SMEM_LIMIT
    for limit in (target, SMEM_LIMIT):
        for n in TC_STAGES:
            if _tc_smem_bytes(k, bt, d, n, cap) <= limit:
                return n
    return TC_STAGES[-1]


def flat_blocks_per_sm(tile: int, smem: int, k: int, elem: int = 4) -> int | None:
    """Blocks of the flat scan an SM holds, for its grid (``_splits``):
    the bf16 scan's 128-query block (three warpgroups at 168 registers) and
    its wide block hold one (two wide blocks an SM, at 128 registers a
    thread, spilled 320-576 bytes), its narrow 64-query block two where
    shared memory allows. None for the fp32 scan, whose grid keeps its own
    target."""
    if elem != 2:
        return None
    return 2 if tile == QUERY_TILE and k <= NARROW_MAX_K and smem <= SMEM_TWO_BLOCKS else 1


def flat_tile(d: int, k: int, b: int, elem: int = 4) -> tuple[int, int]:
    """(query tile, shared-memory bytes) of the flat scan's instantiation
    for depth ``d``, ``k`` hits, ``b`` queries and rows of ``elem`` bytes an
    element (4 fp32, 2 bf16): the 128-query tile, or
    the 64-query one where a batch fits it (at B <= 64 a wider tile is
    padding). fp32: the first of which two blocks fit an SM wins (two
    blocks hide each other's list insertions: k <= 45 at 128 queries, k <=
    125 at 64), else the first that fits at all. bf16: the first that fits
    (its 128-query block, two consumer warpgroups on one stage, is one an
    SM whatever its shared memory). The wide mode (k > NARROW_MAX_K) has
    one tile, FLAT_WIDE_TILE. Raises where none fits."""
    if d < 1 or k < 1:
        raise ValueError(f"flat scan takes D >= 1 and k >= 1, got D={d}, k={k}")
    tiles = (FLAT_WIDE_TILE,) if k > NARROW_MAX_K else FLAT_QUERY_TILES
    fits = [(tile, flat_scan_smem_bytes(k, tile, elem, d)) for tile in tiles
            if b > QUERY_TILE or tile == QUERY_TILE]
    for limit in ((SMEM_LIMIT,) if elem == 2 else (SMEM_TWO_BLOCKS, SMEM_LIMIT)):
        for tile, smem in fits:
            if smem <= limit:
                return tile, smem
    raise ValueError(
        f"flat scan needs {min(smem for _, smem in fits)} B of shared memory "
        f"(D={d}, k={k}), over the {SMEM_LIMIT} B a block may use")


def flat_wide_tile(b: int, elem: int = 4, cap: int = FLAT_WIDE_CAP) -> int:
    """The query tile of the wide flat scan (k > NARROW_MAX_K): FLAT_WIDE_TILE,
    but for the bf16 scan behind a first pass's floor (``cap``
    FLAT_WIDE_SMALL_CAP) at B > 64, whose 128-query block (two consumer
    warpgroups that overlap each other's epilogue) holds its small buffers:
    at b256 k512 the 64-query block left the tensor cores idle through its
    one warpgroup's offers."""
    if elem == 2 and cap == FLAT_WIDE_SMALL_CAP and b > QUERY_TILE:
        return FLAT_QUERY_TILES[0]
    return FLAT_WIDE_TILE


def flat_floor(k: int, n_splits: int, width: int | None = None) -> tuple[int, int]:
    """(c, g) of the flat scan's shared floor: each of a query's splits
    publishes the c-th score of its list, and a warp drops rows under the
    g-th largest of up to FLAT_FLOOR_WINDOW published scores; g·c >= k
    rows lie at or above it, so no dropped row is a hit. A list holds
    ``width`` entries (default k), so c is at most that; a g above the
    window is never reached, and then nothing is dropped."""
    c = min(-(-k // min(n_splits, FLAT_FLOOR_WINDOW)), k if width is None else width)
    return c, -(-k // c)


def list_floor(k: int, nprobe: int, width: int) -> tuple[int, int]:
    """(c, g) of the list scan's floor, from k, nprobe and the slots'
    ``width``. Each slot of a query (one a probed list's segment)
    publishes its list's c-th entry once the list holds c of the item's
    own rows; an item that ends takes the g-th largest key published in a
    window of up to LIST_FLOOR_WINDOW of the query's slots as the query's
    floor, and later rows that it beats are dropped. Slots hold disjoint
    rows and a list's c-th entry only rises, so g·c >= k distinct rows lie
    at or above that key, and no dropped row is a hit.

    g is the number of slots that must have published before a floor
    forms: nprobe / 4 (a quarter of a query's slots where nprobe lists
    fill the window), at most LIST_FLOOR_SLOTS, at least 1; and 1 below k
    LIST_FLOOR_MIN_K,
    where a list's insertions are cheap and reading the window does not
    pay (measured on an H100 at nprobe 96: g 5 at k 10, b4096 ran 7%
    slower than g 1; g 8 at k 64, b256 17% faster). g = 1 means c = k: a
    finished list's k-th entry, raised into the query's floor as it is
    published. c = ceil(k / g), at most the width (a list of fewer
    entries never publishes; a g then above the window is never reached,
    and nothing is dropped)."""
    want = 1 if k < LIST_FLOOR_MIN_K else min(LIST_FLOOR_SLOTS, max(1, nprobe // 4))
    c = min(-(-k // want), width)
    return c, -(-k // c)


_SMS: dict = {}


def device_sms(dev: torch.device) -> int:
    """The device's SM count, read once a device (a property query costs
    host time on every call)."""
    key = (dev.type, dev.index)
    sms = _SMS.get(key)
    if sms is None:
        sms = _SMS[key] = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms


def scan_splits(b: int, n_rows: int, dev: torch.device,
                query_tile: int = QUERY_TILE, k: int = 1,
                per_sm: int | None = None) -> tuple[int, int]:
    """(rows_per_split, n_splits) of the scan grid: enough corpus splits
    that it holds about _FLAT_BLOCKS_PER_SM blocks per SM, each split a
    whole number of row tiles. The wide mode (k > NARROW_MAX_K) fits one
    block an SM, so its grid is one wave of at most one block an SM:
    measured on an H100 at 700 W against the two-block target (bench/
    scan_ab.py, one call, ABBA), 31.4 against 62.5 ms at b1024 k1000, 7.3
    against 12.8 ms at b256 k512 (bf16), 45.8 against 67.4 ms at b64 k10000.
    ``per_sm`` (the bf16 scan, ``flat_blocks_per_sm``): one wave of that
    many blocks an SM."""
    return _splits(b, n_rows, device_sms(dev), query_tile, k, per_sm)


def _splits(b: int, n_rows: int, sms: int, query_tile: int,
            k: int = 1, per_sm: int | None = None) -> tuple[int, int]:
    q_tiles = -(-b // query_tile)
    tiles = max(-(-n_rows // ROW_TILE), 1)
    if per_sm is not None:
        want = max(per_sm * sms // q_tiles, 1)
    elif k > NARROW_MAX_K:   # one block an SM: one wave, no block past it
        want = max(sms // q_tiles, 1)
    else:
        want = max(-(-_FLAT_BLOCKS_PER_SM * sms // q_tiles), 1)
    want = min(want, tiles)
    per = -(-tiles // want) * ROW_TILE
    return per, max(-(-n_rows // per), 1)


# ---- the wide modes' first pass: a floor before any row is kept ---------------


@dataclasses.dataclass(frozen=True)
class FlatPrefloor:
    """The wide flat scan's first pass: a narrow launch (query tile
    ``tile``) over ``splits`` splits of ``per`` rows, each scanning its first
    ``rows``; each split publishes the c-th best of its units' best scores
    (``unit`` rows a unit: 1, the fp32 pass's rows; ROW_TILE, the bf16
    pass's tiles, whose maxima its vote already takes), and a query's floor
    is the g-th largest of those. Each unit's best is a distinct row, so g·c
    rows score at or above the floor."""

    tile: int
    per: int
    splits: int
    rows: int
    c: int
    g: int
    unit: int = 1


@dataclasses.dataclass(frozen=True)
class ListPrefloor:
    """The wide list scan's first pass: the same items at k = c, each
    scanning the first ``sample`` rows of its segment; each slot publishes its
    c-th key, and a query's floor key is the g-th largest of its slots'."""

    c: int
    g: int
    sample: int


def _sample_share(ratio: float, k: int, rows: float) -> float:
    """f = min(1, sqrt(ratio * k / rows)): the first pass's FMAs grow as f,
    the rows its floor lets through as about k / f."""
    return min(1.0, math.sqrt(ratio * k / max(rows, 1.0)))


def _prefloor_grid(b: int, n_rows: int, d: int, sms: int, tile: int, c: int,
                   elem: int) -> tuple[int, int]:
    """(per, splits) of a flat first pass at k = c: fp32, FLAT_PREFLOOR_WAVES
    waves of the narrow grid's two blocks an SM; bf16, one wave of the
    tensor-core blocks an SM holds (``flat_blocks_per_sm``)."""
    if elem == 2:
        per_sm = flat_blocks_per_sm(tile, flat_scan_smem_bytes(c, tile, 2, d), c, 2)
        return _splits(b, n_rows, sms, tile, c, per_sm)
    return _splits(b, n_rows, sms * FLAT_PREFLOOR_WAVES, tile)


def flat_prefloor_plan(k: int, b: int, d: int, n_rows: int, sms: int,
                       elem: int = 4) -> FlatPrefloor | None:
    """Whether the wide flat scan (k > NARROW_MAX_K) over rows of ``elem``
    bytes an element (4 fp32, 2 bf16) runs its first pass, from shapes
    alone, and its shape: the narrow grid (``_prefloor_grid``) at k = c, c =
    ceil(k / (FLAT_PREFLOOR_SHARE of the splits)), so the floor needs the
    c-th scores of that share of a query's splits; a sample of each split
    (``_sample_share`` of its tiles at FLAT_PREFLOOR_RATIO, bf16
    FLAT_TC_PREFLOOR_RATIO; at least 2c rows). None where k is narrow or no
    c <= NARROW_MAX_K gives a g within the splits. The bf16 pass takes each
    split's c-th best tile maximum (``unit`` ROW_TILE): its sample holds at
    least c tiles, and it inserts one score a tile and query, where the
    fp32 pass offers every row that beats its list."""
    if k <= NARROW_MAX_K or b < 1 or n_rows < 1:
        return None
    tile, c = flat_tile(d, 1, b, elem)[0], 1
    for _ in range(3):   # the tile depends on c, and the splits on the tile
        per, splits = _prefloor_grid(b, n_rows, d, sms, tile, c, elem)
        c = -(-k // max(1, int(splits * FLAT_PREFLOOR_SHARE)))
        if c > NARROW_MAX_K:
            return None
        fit = flat_tile(d, c, b, elem)[0]
        if (fit, _prefloor_grid(b, n_rows, d, sms, fit, c, elem)) == (tile, (per, splits)):
            break
        tile = fit
    else:
        return None
    g = -(-k // c)
    tiles = per // ROW_TILE
    if elem == 2:
        f = _sample_share(FLAT_TC_PREFLOOR_RATIO, k, n_rows)
        t = min(tiles, max(math.ceil(f * tiles), c))
        if t < c:   # a split of fewer than c tiles publishes nothing
            return None
        return FlatPrefloor(tile, per, splits, t * ROW_TILE, c, g, ROW_TILE)
    f = _sample_share(FLAT_PREFLOOR_RATIO, k, n_rows)
    t = min(tiles, max(math.ceil(f * tiles), -(-2 * c // ROW_TILE)))
    return FlatPrefloor(tile, per, splits, t * ROW_TILE, c, g)


def list_prefloor_plan(k: int, nprobe: int, width: int, seg: int,
                       rows_per_list: float, tc: bool = False) -> ListPrefloor | None:
    """Whether the wide list scan (k > NARROW_MAX_K, any mode) runs its
    first pass, from shapes alone: at nprobe >= LIST_PREFLOOR_MIN_PROBES (at
    nprobe 3 a query has three slots, and the wide pass's own floor, g 1,
    forms as its first item ends), with c = ceil(k / (LIST_PREFLOOR_SHARE of
    nprobe)) at most NARROW_MAX_K and the slot ``width``; a sample of each
    segment (``_sample_share`` of a list's mean ``rows_per_list`` rows, in
    row tiles, at least 2c rows). The tensor-core list scan (``tc``, k <=
    NARROW_MAX_K) runs it too, at the same nprobe: it
    keeps rows at or above any floor key, so a first pass's floor is exact
    there. Its sample follows LIST_TC_PREFLOOR_RATIO: on the tensor cores a
    sampled row is cheap and every row the floor lets through costs an
    insertion (on an H100, bench/scan_ab.py --sweep, 100k np96 b256 k 64:
    256 sampled rows a segment left 391 entries a query against 653 at 128,
    both passes 0.533 against 0.601 ms). None where it does not run."""
    if (k <= NARROW_MAX_K and not tc) or nprobe < LIST_PREFLOOR_MIN_PROBES:
        return None
    c = -(-k // max(1, int(nprobe * LIST_PREFLOOR_SHARE)))
    if c > min(NARROW_MAX_K, width):
        return None
    seg_rows = min(seg, max(rows_per_list, 1.0))
    ratio = LIST_TC_PREFLOOR_RATIO if tc else LIST_PREFLOOR_RATIO
    f = _sample_share(ratio, k, nprobe * rows_per_list)
    tiles = max(math.ceil(f * seg_rows / ROW_TILE), -(-2 * c // ROW_TILE))
    return ListPrefloor(c, -(-k // c), min(seg, tiles * ROW_TILE))


def _unsigned_order(keys: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding 64-bit floor keys, in a signed order equal to
    the keys' unsigned one (the sign bit flipped): 0 (no key) is the least."""
    return keys ^ torch.iinfo(torch.int64).min


def key_of(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The kernels' ``floor_key`` of entries (score, row) as int64 tensors:
    unsigned order is the lists' (score desc, row asc); 0 for (-inf, -1)."""
    u = (v + 0.0).view(torch.int32).long() & 0xFFFFFFFF   # -0 -> +0
    hi = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    key = (hi << 32) | (0xFFFFFFFF - (r.long() & 0xFFFFFFFF))
    return torch.where((r >= 0) & (v > float("-inf")), key, torch.zeros_like(key))


def entry_of(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The (score, row) of int64 floor keys; (-inf, -1) for 0."""
    hi = (key >> 32) & 0xFFFFFFFF
    u = torch.where(hi >= 0x80000000, hi & 0x7FFFFFFF, hi ^ 0xFFFFFFFF)
    v = u.int().view(torch.float32)
    r = (0xFFFFFFFF - (key & 0xFFFFFFFF)).int()
    none = key == 0
    return (torch.where(none, float("-inf"), v), torch.where(none, -1, r))


def _gth_largest(vals: torch.Tensor, ok: torch.Tensor, g: int, none):
    """[B, m] values, ``ok`` where real -> [B] the g-th largest real value
    of each row (``none`` where fewer than g)."""
    if vals.shape[1] < g:
        return torch.full(vals.shape[:1], none, dtype=vals.dtype, device=vals.device)
    top = torch.where(ok, vals, torch.full_like(vals, none)).topk(g, dim=1).values[:, -1]
    return torch.where(ok.sum(1) >= g, top, torch.full_like(top, none))


def floor_select_plain(pub, g: int, qend=None, base=None):
    """The first passes' floor select (the flat first pass takes it in its
    own launch, csrc/floor_tail.cuh; the list scans' is ``floor_select_list``;
    this is their plain version): each query's g-th largest published entry,
    equal entries counted with their multiplicity. ``pub`` [B, S] float
    scores (-inf: none) -> [B] float (-inf: fewer than g); or with ``qend``
    ([B, P] int32, the list scan's running slot counts) ``pub`` [nslots]
    int64 floor keys (0: none), query b's the slots qend[b-1, -1] ..
    qend[b, -1] -> [B] int64 keys, the larger of that and ``base`` [B] (in
    the keys' unsigned order). The first FLOOR_SELECT_CAP entries a query
    are read."""
    if qend is None:
        return _gth_largest(pub, pub > float("-inf"), g, float("-inf"))
    qoff = torch.nn.functional.pad(qend[:, -1].long().clamp(max=pub.shape[0]), (1, 0))
    cnt = qoff.diff().clamp(min=0)
    m = min(int(cnt.max()) if cnt.numel() else 0, FLOOR_SELECT_CAP)
    j = torch.arange(m, device=pub.device)
    ok = j[None, :] < cnt[:, None]
    keys = _unsigned_order(pub[torch.where(ok, qoff[:-1, None] + j, 0)])
    least = torch.iinfo(torch.int64).min
    got = _gth_largest(keys, ok & (keys != least), g, least)
    if base is not None:
        got = torch.maximum(got, _unsigned_order(base))
    return _unsigned_order(got)


FLOOR_SELECT_CAP = 2048   # FS_CAP of floor_tail.cuh: a query's entries read at most


def floor_select_list(keys, g: int, qend, base=None, out=None):
    """The list scans' first-pass floor select: ``keys`` [nslots] int64
    floor keys (0: none), query b's the slots qend[b-1, -1] .. qend[b, -1]
    of ``qend`` [B, P] int32 -> [B] int64, each query's g-th largest key
    raised to ``base`` [B]: the kernel (csrc/prefloor.cu) on CUDA tensors,
    ``floor_select_plain`` on CPU ones; ``out`` (contiguous, [B]) takes the
    result where given."""
    if keys.device.type == "cpu":
        got = floor_select_plain(keys, g, qend, base)
        return got if out is None else out.copy_(got)
    from pyrope_tpu_torch.kernels.build import load

    b, p = qend.shape
    if (g < 1 or keys.dtype != torch.int64 or qend.dtype != torch.int32
            or not all(t.is_contiguous() for t in (keys, qend))
            or (base is not None and (base.shape != (b,) or not base.is_contiguous()))):
        raise ValueError("g >= 1; keys int64, qend int32 [B, P], base int64 [B], contiguous")
    if out is None:
        out = torch.empty(b, dtype=torch.int64, device=keys.device)
    _floor_select_list_launch(load(), keys.data_ptr(), keys.shape[0], qend.data_ptr(), b, p,
                              g, None if base is None else base.data_ptr(), out.data_ptr(),
                              torch.cuda.current_stream(keys.device).cuda_stream)
    return out


def _floor_select_list_launch(lib, keys, nslots, qend, b, p, g, base, out, stream) -> None:
    """The floor select kernel on addresses (``keys`` [nslots], ``qend``
    [B, P], ``base`` [B] or None, ``out`` [B]), counted."""
    from pyrope_tpu_torch.kernels.build import check

    check(lib.pyrope_floor_select_list(keys, nslots, qend, b, p, g, base, out, stream),
          "floor select")
    count_launch("floor_select")


def split_floor_plain(scores, ok, plan: FlatPrefloor):
    """The first pass's floor from [B, n] scores and [n] bool ``ok`` (alive
    and under max_scans): split s's rows s·per .. s·per + rows in units of
    ``plan.unit`` rows (the last one cut by n), each unit's best score, the
    split's c-th best of those (-inf under c units), then each query's g-th
    largest."""
    b, n = scores.shape
    pub = torch.full((b, plan.splits), float("-inf"), device=scores.device)
    for s in range(plan.splits):
        lo, hi = s * plan.per, min(s * plan.per + plan.rows, n)
        if hi <= lo:
            continue
        sc = torch.where(ok[None, lo:hi], scores[:, lo:hi], float("-inf"))
        if plan.unit > 1:
            pad = -(hi - lo) % plan.unit
            sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
            sc = sc.view(b, -1, plan.unit).amax(dim=2)
        if sc.shape[1] >= plan.c:
            pub[:, s] = sc.topk(plan.c, dim=1).values[:, -1]
    return floor_select_plain(pub, plan.g)


def flat_prefloor_plain(q, x, sqnorm, alive, max_scans: int, plan: FlatPrefloor,
                        metric=Metric.L2):
    """Plain version of ``flat_prefloor``: the same floors (to the scores'
    rounding), from the plain scores (over a bf16 ``x``, bf16(q)·x summed
    in fp32, as ``_tile_scores``)."""
    ms = max(min(int(max_scans), x.shape[0]), 0)
    sc = _tile_scores(q, x, sqnorm, _metric_ip(metric))(0, ms)
    return split_floor_plain(sc, alive[:ms], plan)


def flat_prefloor(q, x, sqnorm, alive, max_scans: int, plan: FlatPrefloor,
                  metric=Metric.L2, *, published: bool = False):
    """The wide flat scan's first pass alone (fp32 or bf16 ``x``): [B]
    floors (-inf: none), the scores each query's hits reach. On CUDA tensors
    the narrow scan kernel (the plan's sample, no partials; over a bf16 slab
    the tensor-core kernel), which takes the floors in its own launch; on
    CPU ones the plain version. ``published`` (CUDA): also the [B, splits]
    scores the splits published, the floors' inputs."""
    if q.device.type == "cpu":
        return flat_prefloor_plain(q, x, sqnorm, alive, max_scans, plan, metric)
    ms = max(min(int(max_scans), x.shape[0]), 0)
    floors, pub = _flat_first_pass(q, x, sqnorm, alive, _metric_ip(metric), ms, plan)
    return (floors, pub) if published else floors


def _flat_first_pass(q, x, sqnorm, alive, metric_ip, max_scans, plan: FlatPrefloor,
                     q16=None, qsq=None):
    """One launch: (floors [B], the published scores [B, splits]). The
    splits publish into ``pub``; after it in the same -inf fill, one count a
    query tile (its bits start as -inf's), which the split that completes it
    reads as its cue to take the tile's floors. Over a bf16 ``x`` the
    tensor-core kernel, on bf16(q) and ‖q‖² of the fp32 q (``q16``, ``qsq``:
    the caller's, where it has them)."""
    from pyrope_tpu_torch.kernels.build import check, load

    b, d = q.shape
    tiles = -(-b // plan.tile)
    fill = torch.full((b * plan.splits + tiles,), float("-inf"), device=q.device)
    pub = fill[:b * plan.splits].view(b, plan.splits)
    floors = torch.empty(b, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    shape = (b, x.shape[0], d, plan.c, plan.c, int(metric_ip), max_scans, plan.per,
             plan.rows, plan.splits, plan.tile)
    floor_args = (None, None, pub.data_ptr(), plan.c, plan.g, None, FLAT_WIDE_CAP, None,
                  fill.data_ptr() + 4 * b * plan.splits, floors.data_ptr(), plan.g, stream)
    if x.dtype == torch.bfloat16:
        if q16 is None:
            q16, qsq = q.bfloat16(), (q * q).sum(dim=1)
        vec = int(d % 8 == 0 and q16.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        check(load().pyrope_flat_scan_tc(
            q16.data_ptr(), x.data_ptr(), qsq.data_ptr(), sqnorm.data_ptr(),
            alive.data_ptr(), *shape, vec, *floor_args), "bf16 flat scan kernel (first pass)")
        count_launch("flat_scan_bf16_prefloor")
    else:
        vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        check(load().pyrope_fused_scan(
            q.data_ptr(), x.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(), *shape, vec,
            *floor_args), "fused scan kernel (first pass)")
        count_launch("flat_scan_prefloor")
    return floors, pub


def merge_partials_plain(part_v, part_i, qend=None, k=None):
    """Plain version of ``merge_partials``: (score desc, row asc) over every
    list of a query, whatever order the lists come in (two stable sorts:
    rows, then scores); ``k`` hits (default: the lists' width), -inf/-1
    past the entries there are."""
    k = part_v.shape[-1] if k is None else k
    if qend is not None:  # per-query lists, padded to [most lists, B, width]
        qoff = torch.nn.functional.pad(qend[:, -1], (1, 0))
        cnt = qoff.diff()
        m = int(cnt.max()) if cnt.numel() else 0
        if m == 0:
            return _empty_hits(cnt.numel(), k, part_v.device)
        j = torch.arange(m, device=part_v.device)
        ok = (j[None, :] < cnt[:, None])[..., None]
        rows = torch.where(ok[..., 0], qoff[:-1, None] + j, 0).long()
        part_v = torch.where(ok, part_v[rows], float("-inf")).permute(1, 0, 2)
        part_i = torch.where(ok, part_i[rows], -1).permute(1, 0, 2)
    s, b, w = part_v.shape
    v = part_v.permute(1, 0, 2).reshape(b, s * w)
    i = part_i.permute(1, 0, 2).reshape(b, s * w)
    by_row = torch.sort(i, dim=1, stable=True).indices
    v, i = torch.gather(v, 1, by_row), torch.gather(i, 1, by_row)
    vals, pos = torch.sort(v, dim=1, descending=True, stable=True)
    vals, rows = vals[:, :k], torch.gather(i, 1, pos[:, :k])
    if vals.shape[1] < k:  # fewer entries than k in all
        pad_v, pad_i = _empty_hits(b, k - vals.shape[1], part_v.device)
        vals, rows = torch.cat([vals, pad_v], 1), torch.cat([rows, pad_i], 1)
    return vals, rows


def merge_partials(part_v, part_i, qend=None, k=None):
    """Sorted lists (f32 scores, int32 rows, -inf/-1 empty) -> the [B, k]
    top-k of each query across its lists, (score desc, row asc): the merge
    kernel on CUDA tensors, the plain version on CPU ones. Lists are
    [S, B, w] (S lists for every query), or with ``qend`` [B, P] int32
    [slots, w] rows, query b's from qend[b-1, -1] (0 for b = 0) to
    qend[b, -1] (the list scan's running slot counts, ``ListWork``). ``k``
    defaults to the lists' width w; a wider k (the list scan's wide slots
    hold min(k, seg, max_len)) takes the wide merge."""
    if part_v.device.type == "cpu":
        return merge_partials_plain(part_v, part_i, qend, k)
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise ValueError("partials must be float32 scores and int32 rows")
    tensors = (part_v, part_i) if qend is None else (part_v, part_i, qend)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if qend is None:
        s, b, w = part_v.shape
        nprobe = 0
    else:
        if qend.dtype != torch.int32 or qend.device != part_v.device:
            raise ValueError("qend must be int32 on the partials' device")
        (s, w), (b, nprobe) = part_v.shape, qend.shape
    k = w if k is None else k
    if qend is None:  # [S, B, w]: list s of query b at (s·B + b)·w
        return _merge_launch(part_v, part_i, s, b, k, None, 0, w, b * w, w)
    return _merge_launch(part_v, part_i, s, b, k, qend, nprobe, 0, w, w)


def _merge_launch(part_v, part_i, s, b, k, qend, nprobe, qstride, lstride, width=None,
                  fills=None):
    """The merge kernel over partials whose list ``l`` of query ``q`` starts
    at entry q·qstride + l·lstride (``qend`` None), or over [s, width] rows
    cut by ``qend``; lists ``width`` entries wide (default k), k hits out.
    k <= NARROW_MAX_K with lists of k: the warp-register merge; else the
    wide merge, which takes ``fills`` ([B, s] int32, the lists' real
    entries, without ``qend``) where the lists are not padded. The one place
    the merge is launched and counted."""
    from pyrope_tpu_torch.kernels.build import check, load

    width = k if width is None else width
    if not 1 <= width <= k:
        raise ValueError(f"merge takes lists of 1..k entries and k >= 1, "
                         f"got {width} and {k}")
    out_v = torch.empty((b, k), dtype=torch.float32, device=part_v.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=part_v.device)
    if b == 0:
        return out_v, out_i  # an empty grid is not a valid launch
    stream = torch.cuda.current_stream(part_v.device).cuda_stream
    qptr = None if qend is None else qend.data_ptr()
    if k <= NARROW_MAX_K and width == k:
        check(load().pyrope_merge_partials(
            part_v.data_ptr(), part_i.data_ptr(), s, b, k, qptr, nprobe, qstride,
            lstride, out_v.data_ptr(), out_i.data_ptr(), stream), "merge kernel")
        count_launch("merge")
    else:
        check(load().pyrope_merge_partials_wide(
            part_v.data_ptr(), part_i.data_ptr(), s, b, k, width, qptr, nprobe,
            qstride, lstride, None if fills is None else fills.data_ptr(),
            out_v.data_ptr(), out_i.data_ptr(), stream), "wide merge kernel")
        count_launch("merge_wide")
    return out_v, out_i


def _empty_hits(b, k, dev):
    return (torch.full((b, k), float("-inf"), device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))


def _bf16_query(q):
    """(bf16(q) as fp32, ‖q‖² of the unrounded q): what the CUDA-core list
    scan's BF16 mode without promote reads for q."""
    return q.bfloat16().float(), (q * q).sum(dim=1)


def _launch(q, x, sqnorm, alive, k, metric_ip, max_scans):
    """The flat scan kernel into [B, splits, k] partials, then the merge;
    over a bf16 ``x`` the tensor-core kernel, on bf16(q) and ‖q‖² of the
    fp32 q. The wide scan (fp32 or bf16) starts from its first pass's floors
    where ``flat_prefloor_plan`` runs one."""
    from pyrope_tpu_torch.kernels.build import check, load

    lib = load()
    b, d = q.shape
    elem = x.element_size()
    tile, smem = flat_tile(d, k, b, elem)
    lib_smem = (lib.pyrope_flat_tc_smem_bytes(k, tile, d, FLAT_WIDE_CAP) if elem == 2
                else lib.pyrope_scan_smem_bytes(k, tile))
    if lib_smem != smem:
        raise RuntimeError("flat_tile and the flat scan's source disagree on shared memory")
    if b == 0:  # an empty grid is not a valid launch
        return _empty_hits(0, k, q.device)
    q16 = qsq = None
    if elem == 2:
        q16, qsq = q.bfloat16(), (q * q).sum(dim=1)   # bf16(q) is exact in bf16
    per_sm = flat_blocks_per_sm(tile, smem, k, elem)
    floor0, cap = None, FLAT_WIDE_CAP
    if k > NARROW_MAX_K:
        plan = flat_prefloor_plan(k, b, d, max_scans, device_sms(q.device), elem)
        if plan is not None:
            floor0 = _flat_first_pass(q, x, sqnorm, alive, metric_ip, max_scans, plan,
                                      q16, qsq)[0]
            # behind the floor a split keeps few rows: small buffers; the
            # fp32 scan's blocks then fit two an SM, a grid of two waves'
            # splits; the bf16 scan's take the 128-query tile above 64
            # queries (two consumer warpgroups, one block an SM)
            cap = FLAT_WIDE_SMALL_CAP
            tile = flat_wide_tile(b, elem, cap)
            small = flat_scan_smem_bytes(k, tile, elem, d, cap)
            lib_small = (lib.pyrope_flat_tc_smem_bytes(k, tile, d, cap) if elem == 2
                         else lib.pyrope_scan_wide_smem_bytes(k, cap))
            if lib_small != small:
                raise RuntimeError("flat_scan_smem_bytes and the flat scan's source disagree")
            per_sm = 1 if elem == 2 else 2
    per, n_splits = scan_splits(b, max_scans, q.device, tile, k, per_sm)
    kw = k if k <= NARROW_MAX_K else min(k, per)   # a split gives at most per rows
    part_v = torch.empty((b, n_splits, kw), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_splits, kw), dtype=torch.int32, device=q.device)
    pub_c, pub_g = flat_floor(k, n_splits, kw)
    pub = torch.full((b, n_splits), float("-inf"), device=q.device)
    # the wide lists' real entries, written in place of their pads
    fills = (torch.empty((b, n_splits), dtype=torch.int32, device=q.device)
             if k > NARROW_MAX_K else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tail = (b, x.shape[0], d, k, kw, int(metric_ip), max_scans, per, per, n_splits, tile)
    outs = (part_v.data_ptr(), part_i.data_ptr(), pub.data_ptr(), pub_c, pub_g,
            None if floor0 is None else floor0.data_ptr(), cap,
            None if fills is None else fills.data_ptr(), None, None, 0, stream)
    if elem == 2:
        vec = int(d % 8 == 0 and q16.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        check(lib.pyrope_flat_scan_tc(
            q16.data_ptr(), x.data_ptr(), qsq.data_ptr(), sqnorm.data_ptr(),
            alive.data_ptr(), *tail, vec, *outs), "bf16 flat scan kernel")
    else:
        vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
        check(lib.pyrope_fused_scan(
            q.data_ptr(), x.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(), *tail, vec,
            *outs), "fused scan kernel")
    count_launch(("flat_scan_bf16" if elem == 2 else "flat_scan")
                 + ("_wide" if k > NARROW_MAX_K else ""))
    return _merge_launch(part_v, part_i, n_splits, b, k, None, 0, n_splits * kw, kw, kw,
                         fills)


def fused_flat_topk(q, x, sqnorm, alive, max_scans: int, k: int,
                    metric=Metric.L2) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked exact scan + top-k over a flat slab (K1).

    q [B, D] f32, x [N, D] f32 or bf16 slab (bf16: scored as bf16(q)·x,
    fp32 sums), sqnorm [N] f32 (of the fp32 rows), alive [N] bool; rows >=
    ``max_scans`` never hit. Returns (values [B, k] f32, rows [B, k]
    int32), (score desc, row asc), -inf/-1 for missing hits. Any B and N:
    the kernel masks the ragged edges itself. It has no promote mode: no
    route of the JAX package promotes a flat scan."""
    metric_ip = _metric_ip(metric)
    if not _check_inputs(q, x, sqnorm, alive, k):
        return fused_flat_topk_plain(q, x, sqnorm, alive, max_scans, k, metric)
    check_fp32_exact(q)
    ms = max(min(int(max_scans), x.shape[0]), 0)
    return _launch(q, x, sqnorm, alive, k, metric_ip, ms)


# ---- the cluster-major list scan (IVF and SQ8 modes) --------------------------


def list_csr(crow: torch.Tensor, kp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(offsets, lens) int32 [kp] of a cluster-major row -> cluster map."""
    lens = torch.bincount(crow.long(), minlength=kp)[:kp]
    return (torch.cumsum(lens, 0) - lens).int(), lens.int()


@dataclasses.dataclass
class ListWork:
    """What the list scan reads besides the data: the probe lists inverted
    (pairs grouped by cluster), the item table and the pairs' partial
    slots. Built on the device with no host sync; ``grid``, ``segs`` and
    ``slots`` come from shapes alone."""

    pairs: torch.Tensor     # [B·P] int32 pair ids j = b·P + p, by (cluster, b)
    cstart: torch.Tensor    # [kp] int32 first pair of each cluster
    ccnt: torch.Tensor      # [kp] int32 pairs (probing queries) per cluster
    item_end: torch.Tensor  # [kp] int32 inclusive prefix sum of items
    item_c: torch.Tensor    # [grid] int32 cluster of each block (kp: none)
    slot_end: torch.Tensor  # [B, P] int32 slots of pairs 0..j (row-major), inclusive
    segs: int               # S: row segments per cluster, at most
    grid: int               # blocks launched, >= the items there are
    slots: int              # partial slots allocated, >= slot_end[-1, -1]


def list_grid(b: int, nprobe: int, kp: int, max_len: int, seg: int,
              chunk: int = QUERY_TILE) -> tuple[int, int]:
    """(grid, segs) of the list scan from shapes alone. A cluster probed by
    n queries has ceil(n/chunk) <= n/chunk + 1 chunks, so all clusters have
    at most ceil(B·P/chunk) + min(kp, B·P) chunks, each of at most
    ceil(max_len/seg) segments."""
    segs = max(1, -(-int(max_len) // seg))
    pairs = b * nprobe
    return (-(-pairs // chunk) + min(kp, pairs)) * segs, segs


def list_slots(b: int, nprobe: int, segs: int, seg: int, n_rows: int) -> int:
    """Partial slots of the list scan from shapes alone: a query's distinct
    probes have at most P·S segments, and at most P + n_rows // seg, since
    their lists are disjoint and ceil(l/seg) <= l // seg + 1."""
    return b * min(nprobe * segs, nprobe + n_rows // seg)


def list_slot_width(k: int, seg: int, max_len: int) -> int:
    """Entries a list-scan partial slot holds: k, or in the wide mode (k >
    NARROW_MAX_K) at most what one segment of a list can give, min(k, seg,
    max_len). So the partials are slots x min(k, seg, max_len), not x k."""
    return k if k <= NARROW_MAX_K else max(1, min(k, seg, max_len))


def list_seg(b: int, nprobe: int, kp: int, max_len: int, sms: int) -> int:
    """Segment length of a list-scan launch, from shapes alone: LIST_SEG,
    halved (down to LIST_SEG_MIN) while the grid bound holds fewer than
    _BLOCKS_PER_SM blocks per SM, so a batch that probes few lists still
    fills the card (100k rows, nlist 100, b1024, nprobe 3: 100 lists)."""
    seg = LIST_SEG
    while (seg > LIST_SEG_MIN
           and list_grid(b, nprobe, kp, max_len, seg)[0] < _BLOCKS_PER_SM * sms):
        seg //= 2
    return seg


def promote_seg(b: int, nprobe: int, kp: int, max_len: int, sms: int) -> int:
    """Segment length of a promote list-scan launch, from shapes alone:
    PROMOTE_SEG_MAX, halved (down to PROMOTE_SEG_MIN) while the grid bound
    holds fewer than PROMOTE_ITEMS_PER_SM items an SM. Its blocks walk the
    items and stream across their ends: the rule wants items enough to
    balance the blocks' walks, each item paying its set-up and its lists'
    merge once."""
    seg = PROMOTE_SEG_MAX
    while (seg > PROMOTE_SEG_MIN
           and list_grid(b, nprobe, kp, max_len, seg)[0] < PROMOTE_ITEMS_PER_SM * sms):
        seg //= 2
    return seg


@dataclasses.dataclass(frozen=True)
class ListPlan:
    """Which list-scan kernel a call takes and how, from shapes alone:
    ``tc`` the tensor-core kernel (a bf16 slab without promote_fp32, k <=
    NARROW_MAX_K), ``promote`` the bulk-copy kernel (a bf16 slab with
    promote_fp32, k <= NARROW_MAX_K, D <= PROMOTE_MAX_D), else the CUDA-core
    one in ``mode``; its segment, the slots' width, the block's shared
    memory, the ``LAUNCHES`` key of its launch, and (``promote``) its
    walking grid's blocks."""

    tc: bool
    mode: int
    seg: int
    kw: int
    smem: int
    key: str
    promote: bool = False
    blocks: int = 0


def list_plan(k: int, mode: int, promote: bool, b: int, nprobe: int, kp: int,
              max_len: int, d: int, sms: int) -> ListPlan:
    """The host plan of a list-scan call: a bf16 slab at k <= NARROW_MAX_K
    takes the tensor-core kernel without promote and the bulk-copy kernel
    with it up to D PROMOTE_MAX_D; every other call the CUDA-core one (its
    wide mode beat the tensor cores', PERF.md). Raises where the kernel
    refuses k (``list_scan_refusal``)."""
    tc = mode == LIST_BF16 and not promote and k <= NARROW_MAX_K
    if mode == LIST_BF16 and promote and 1 <= k <= NARROW_MAX_K and d <= PROMOTE_MAX_D:
        seg = promote_seg(b, nprobe, kp, max_len, sms)
        smem = list_promote_smem_bytes(k, d)
        per_sm = 2 if smem <= SMEM_TWO_BLOCKS else 1
        return ListPlan(False, mode, seg, k, smem, "ivf_scan_bf16_promote", True,
                        per_sm * sms)
    if tc:
        why = k_refusal(k)
        if why is not None:
            raise ValueError(why)
        # list_seg's rule, never under LIST_TC_SEG_MIN rows (four TMA boxes):
        # every item gathers its queries first, so a tensor-core block wants
        # fewer, longer items than a CUDA-core one. At 100k np96 b256 k 64
        # it cuts 1,024 rows; 2,048 (one wave) and 512 scanned in the same
        # time there (H100, bench/scan_ab.py --sweep, PERF.md)
        seg = max(list_seg(b, nprobe, kp, max_len, sms), LIST_TC_SEG_MIN)
        smem, key = list_tc_smem_bytes(k, d), "ivf_scan_bf16_tc"
    else:
        why = list_scan_refusal(k, mode)
        if why is not None:
            raise ValueError(why)
        seg = list_seg(b, nprobe, kp, max_len, sms)
        smem = list_scan_smem_bytes(k, mode)
        key = {LIST_IVF: "ivf_scan", LIST_SQ8: "sq8_scan", LIST_BF16: "ivf_scan_bf16"}[mode]
    return ListPlan(tc, mode, seg, list_slot_width(k, seg, max_len), smem,
                    key + ("_wide" if k > NARROW_MAX_K else ""))


def invert_probes_plain(probe: torch.Tensor, lens: torch.Tensor, kp: int, max_len: int,
                        seg: int, n_rows: int, chunk: int = QUERY_TILE) -> ListWork:
    """Plain version of ``invert_probes``: the same tables, in some twenty
    small torch launches (a sort, two searchsorted, cumsums, a take). The
    CPU path and the CPU emulation of the list scan use it; on the card it
    is only the kernel's yardstick."""
    b, nprobe = probe.shape
    dev = probe.device
    grid, segs = list_grid(b, nprobe, kp, max_len, seg, chunk)
    bb = max(b, 1)
    kt = torch.int32 if (kp + 1) * bb < 2**31 else torch.int64
    rows = torch.arange(b, device=dev, dtype=kt)[:, None]
    key, order = torch.sort((probe.to(kt) * bb + rows).reshape(-1))  # distinct keys
    bounds = torch.searchsorted(key, torch.arange(kp + 1, device=dev, dtype=kt) * bb,
                                out_int32=True)
    ccnt = bounds.diff()
    nseg = (lens + (seg - 1)) // seg
    item_end = torch.cumsum((ccnt + (chunk - 1)) // chunk * nseg, 0, dtype=torch.int32)
    item_c = torch.searchsorted(item_end, torch.arange(grid, device=dev, dtype=torch.int32),
                                right=True, out_int32=True)
    slot_end = torch.take(nseg, probe.long()).view(-1).cumsum(0, dtype=torch.int32)
    return ListWork(order.int(), bounds[:-1], ccnt, item_end, item_c,
                    slot_end.view(b, nprobe), segs, grid,
                    list_slots(b, nprobe, segs, seg, n_rows))


INVERT_TILE = 64   # IT_TILE of invert_probes.cu: queries a block, one mask bit each
_TABLES = ("pairs", "cstart", "ccnt", "item_end", "item_c", "slot_end")


def invert_scratch_bytes(b: int, kp: int) -> int:
    """Scratch of the inversion kernel, as ``pyrope_invert_scratch_bytes``
    of invert_probes.cu computes it: a 64-bit mask word, a 32-bit base a
    (query tile, cluster) and a 64-bit segment sum a tile, each region
    rounded up to 16 bytes."""
    t = -(-b // INVERT_TILE)
    return _round16(8 * t * kp) + _round16(4 * t * kp) + _round16(8 * t)


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _table_sizes(b: int, nprobe: int, kp: int, grid: int) -> tuple[tuple[str, int], ...]:
    """The inversion's pieces of a buffer: its tables and scratch, in int32
    elements."""
    pairs = b * nprobe
    return (("pairs", pairs), ("cstart", kp), ("ccnt", kp), ("item_end", kp),
            ("item_c", grid), ("slot_end", pairs),
            ("scratch", invert_scratch_bytes(b, kp) // 4))


def layout(pieces) -> tuple[dict, int]:
    """``pieces`` ((name, int32 elements), in order) laid end to end in one
    buffer, each starting on a 16-byte boundary: (name -> (first element,
    elements)), and the elements in all."""
    at, out = 0, {}
    for name, n in pieces:
        out[name] = (at, n)
        at += n + -n % 4
    return out, at


class _CarvedWork:
    """``ListWork`` over a call's one buffer (``buf``, int32, cut by
    ``layout``'s ``spans``): one allocation from the stream-ordered caching
    allocator a call, never kept across calls (two micro-batches may be in
    flight). The pieces' addresses (``ptr``) come without a tensor each, and
    a table's view is made when it is first read (the merge reads slot_end;
    tests and the CPU path the rest)."""

    def __init__(self, buf: torch.Tensor, spans: dict, b: int, nprobe: int, segs: int,
                 grid: int, slots: int):
        self._buf, self._spans, self._base = buf, spans, buf.data_ptr()
        self._shape = (b, nprobe)
        self.segs, self.grid, self.slots = segs, grid, slots

    def ptr(self, name: str) -> int:
        return self._base + 4 * self._spans[name][0]

    def __getattr__(self, name: str) -> torch.Tensor:
        if name not in _TABLES:
            raise AttributeError(name)
        t = self._buf.narrow(0, *self._spans[name])
        if name == "slot_end":
            t = t.view(self._shape)
        self.__dict__[name] = t
        return t


def _invert_launch(lib, probe, lens, kp, seg, chunk, grid, ptr, keys, n_keys,
                   stream) -> None:
    """One call of the inversion kernel (its two launches) into the tables
    at ``ptr(name)`` (pairs .. slot_end, scratch), zeroing ``n_keys`` 64-bit
    keys at address ``keys`` (None: none)."""
    from pyrope_tpu_torch.kernels.build import check

    b, nprobe = probe.shape
    if not probe.is_contiguous():
        probe = probe.contiguous()
    if probe.dtype not in (torch.int64, torch.int32):
        probe = probe.long()
    if b * nprobe >= 2**31:
        raise ValueError(f"the inversion takes B·P < 2^31 pairs, got {b * nprobe}")
    check(lib.pyrope_invert_probes(
        probe.data_ptr(), int(probe.dtype == torch.int64), lens.data_ptr(), b, nprobe, kp,
        seg, chunk, grid, ptr("pairs"), ptr("cstart"), ptr("ccnt"), ptr("item_end"),
        ptr("item_c"), ptr("slot_end"), ptr("scratch"), keys, n_keys, stream),
        "probe inversion kernel")
    count_launch("invert_probes")


def invert_probes(probe: torch.Tensor, lens: torch.Tensor, kp: int, max_len: int,
                  seg: int, n_rows: int, chunk: int = QUERY_TILE) -> ListWork:
    """Group the (query, probe position) pairs of ``probe`` [B, P] by
    cluster and lay out the list scan's items: item = (cluster, chunk of <=
    ``chunk`` of its queries, segment of <= ``seg`` of its ``lens`` rows).
    Pair j = b·P + p gets one partial slot per segment of its list, the
    slot_end[j] - segments(j) .. slot_end[j] before it; a query's slots are
    contiguous, so the merge reads only the lists its probes have.
    ``max_len`` >= every list length; the lists cover at most ``n_rows``
    rows. On CUDA tensors the inversion kernel (csrc/invert_probes.cu, two
    launches, no host sync) into one allocation; on CPU ones the plain
    version."""
    if probe.device.type == "cpu":
        return invert_probes_plain(probe, lens, kp, max_len, seg, n_rows, chunk)
    from pyrope_tpu_torch.kernels.build import load

    b, nprobe = probe.shape
    grid, segs = list_grid(b, nprobe, kp, max_len, seg, chunk)
    if lens.dtype != torch.int32 or lens.shape != (kp,) or lens.device != probe.device:
        raise ValueError(f"lens must be int32 [kp] = [{kp}] on the probes' device")
    spans, total = layout(_table_sizes(b, nprobe, kp, grid))
    buf = torch.empty(total, dtype=torch.int32, device=probe.device)
    work = _CarvedWork(buf, spans, b, nprobe, segs, grid,
                       list_slots(b, nprobe, segs, seg, n_rows))
    _invert_launch(load(), probe, lens, kp, seg, chunk, grid, work.ptr, None, 0,
                   torch.cuda.current_stream(probe.device).cuda_stream)
    return work


def _check_lists(q, probe, offsets, lens, kp, max_len):
    if probe.dim() != 2 or probe.shape[0] != q.shape[0] or probe.device != q.device:
        raise ValueError("probe must be [B, nprobe] on the queries' device")
    for name, t in (("offsets", offsets), ("lens", lens)):
        if t.dtype != torch.int32 or t.shape != (kp,):
            raise ValueError(f"{name} must be int32 [kp] = [{kp}]")
    if not isinstance(max_len, numbers.Integral):
        raise TypeError(f"max_len must be a host int, got {type(max_len).__name__}")


def _check_list_preconditions(probe, lens, max_len):
    """What the list scan relies on: a probe row names distinct clusters,
    and ``max_len`` >= every lens[c]. Checked on the CPU path only: on the
    card a check would sync the host, and there a violation gives wrong
    hits (the kernels never write out of bounds)."""
    if lens.numel() and int(lens.max()) > max_len:
        raise ValueError(f"max_len {max_len} is below the longest list, {int(lens.max())}")
    ranked = probe.sort(dim=1).values
    if bool((ranked[:, 1:] == ranked[:, :-1]).any()):
        raise ValueError("a probe row names a cluster twice")


def _launch_list(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                 max_len, sq8=None, promote=False):
    """The list scan kernel into per-query partial slots, then the merge."""
    b = q.shape[0]
    if b == 0 or probe.shape[1] == 0:
        return _empty_hits(b, k, q.device)
    part_v, part_i, slot_end = list_partials(q, slab, sqnorm, alive, offsets, lens, probe,
                                             kp, k, metric_ip, max_len, sq8, promote)
    slots, width = part_v.shape   # the call's own partials: merge_partials' checks hold
    out = _merge_launch(part_v, part_i, slots, b, k, slot_end, probe.shape[1], 0, width, width)
    _mark("merge")
    return out


def list_partials(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                  max_len, sq8=None, promote=False):
    """The list scan kernel alone (CUDA tensors, B and nprobe >= 1):
    (part_v, part_i, slot_end), the [slots, width] partials and the running
    slot counts the merge reads; slots past slot_end[-1, -1] are unused.
    IVF mode over an fp32 slab; over a bf16 one at k <= NARROW_MAX_K the
    tensor-core kernel (bf16(q), ``LAUNCHES`` ``ivf_scan_bf16_tc``), with
    ``promote`` up to D PROMOTE_MAX_D the bulk-copy kernel (q as it is,
    ``ivf_scan_bf16_promote``), else the CUDA-core kernel's BF16 mode
    (``ivf_scan_bf16``, q rounded unless ``promote``); SQ8 mode when ``sq8``
    = (mins, scales, qc). The first pass runs where ``list_prefloor_plan``
    says (the wide modes, and the tensor-core kernel)."""
    job = _ListJob(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                   max_len, sq8, promote)
    call, w = job.call, job.work
    # every slot below slot_end[-1, -1] is written by the one item covering
    # it; the slots' published keys, then the queries' floor keys, are 0
    # (none yet) from the inversion, and so are the first pass's own
    if call.prefloor is not None:   # its floors are the main pass's queries' keys
        job.first_pass(call.prefloor, into_pub=True)
    _mark("first_pass")
    job.launch(k, call.plan.kw, job.part_v, job.part_i, job.keys_ptr, call.pub_c,
               call.pub_g, call.plan.seg)
    count_launch(call.plan.key)
    _mark("scan")
    return job.part_v, job.part_i, w.slot_end


def list_prefloor(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                  max_len, sq8=None, promote=False, *, published: bool = False):
    """The wide list scan's first pass alone (CUDA tensors; inputs as
    ``list_partials``): (floor keys [B] int64, its ``ListPrefloor``), or
    (None, None) where ``list_prefloor_plan`` does not run one (the narrow
    launch, then the floor select kernel). ``published``: also the floors'
    inputs, (the first pass's keys [slots + B]: its slots', then its own
    floor keys; the running slot counts [B, P]), as ``floor_select_plain``
    takes them."""
    job = _ListJob(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                   max_len, sq8, promote)
    plan = job.prefloor()
    if plan is None:
        return (None, None, None) if published else (None, None)
    floors = job.first_pass(plan)
    if published:
        return floors, plan, (job.first, job.work.slot_end)
    return floors, plan


def list_prefloor_plain(scores, alive, crow, offsets, lens, probe, seg, plan: ListPrefloor):
    """Plain version of ``list_prefloor`` on [B, N] scores: each probed
    list's segments of ``seg`` rows, the first ``plan.sample`` rows of each,
    the c-th best alive row a query (its key; none under c rows), and each
    query's g-th largest key over its segments. [B] int64 keys."""
    b = scores.shape[0]
    table = probe_table(probe, offsets.shape[0])
    keys = []
    for c in torch.unique(probe).tolist():
        off, n = int(offsets[c]), int(lens[c])
        for s0 in range(0, n, seg):
            lo, hi = off + s0, off + min(n, s0 + plan.sample)
            if hi - lo < plan.c:
                continue
            sc = torch.where(alive[None, lo:hi], scores[:, lo:hi], float("-inf"))
            v, r = torch.sort(sc, dim=1, descending=True, stable=True)   # ties: row asc
            key = key_of(v[:, plan.c - 1], (r[:, plan.c - 1] + lo).int())
            keys.append(torch.where(table[:, c], key, torch.zeros_like(key)))
    if not keys:
        return torch.zeros(b, dtype=torch.int64, device=scores.device)
    keys = _unsigned_order(torch.stack(keys, 1))
    least = torch.iinfo(torch.int64).min
    return _unsigned_order(_gth_largest(keys, keys != least, plan.g, least))


_SMEM_CHECKED: set = set()


def _check_smem(lib, plan: ListPlan, k: int, d: int) -> None:
    """The host formula against the library's, once per kernel, k and mode
    (and D, on which the tensor-core kernel's depends) in a process."""
    key = (plan.tc, plan.promote, k, plan.mode, d if plan.tc or plan.promote else 0)
    if key in _SMEM_CHECKED:
        return
    got = (lib.pyrope_list_tc_smem_bytes(k, d) if plan.tc
           else lib.pyrope_list_promote_smem_bytes(k, d) if plan.promote
           else lib.pyrope_list_scan_smem_bytes(k, plan.mode))
    if got != plan.smem:
        raise RuntimeError("the list scan's host shared-memory formula and its source "
                           f"disagree: {plan.smem} against {got} B (k {k}, mode "
                           f"{plan.mode}, tensor cores {plan.tc})")
    _SMEM_CHECKED.add(key)


@dataclasses.dataclass(frozen=True)
class ListCall:
    """A list-scan call's host plan, from shapes alone: the kernel and its
    segment (``list_plan``), the first pass (``list_prefloor_plan``, or
    None), the floor's (c, g) (``list_floor``), the grid, segments and
    slots (``list_grid``, ``list_slots``), and the pieces of the call's one
    buffer ((name, int32 elements): partials, keys, the inversion's tables
    and scratch)."""

    plan: ListPlan
    prefloor: ListPrefloor | None
    pub_c: int
    pub_g: int
    grid: int
    segs: int
    slots: int
    pieces: tuple
    spans: dict    # ``layout(pieces)``: name -> (first int32 element, elements)
    total: int     # int32 elements of the buffer


def _list_call(k, mode, promote, b, nprobe, kp, max_len, d, n_rows, sms) -> ListCall:
    plan = list_plan(k, mode, promote, b, nprobe, kp, max_len, d, sms)
    grid, segs = list_grid(b, nprobe, kp, max_len, plan.seg)
    slots = list_slots(b, nprobe, segs, plan.seg, n_rows)
    prefloor = list_prefloor_plan(k, nprobe, plan.kw, plan.seg, n_rows / max(kp, 1),
                                  plan.tc)
    # the keys, in int32 elements: a 64-bit key a slot, then a query; twice
    # with a first pass (its own, after the main pass's)
    keys = 2 * (slots + b) * (1 if prefloor is None else 2)
    pieces = (("part_v", slots * plan.kw), ("part_i", slots * plan.kw), ("keys", keys),
              *_table_sizes(b, nprobe, kp, grid))
    return ListCall(plan, prefloor, *list_floor(k, nprobe, plan.kw), grid, segs, slots,
                    pieces, *layout(pieces))


_CALLS: dict = {}
_CALLS_LOCK = threading.Lock()
_CALLS_MAX = 4096   # distinct shapes kept; the cache starts over past it


def list_call(k: int, mode: int, promote: bool, b: int, nprobe: int, kp: int,
              max_len: int, d: int, n_rows: int, sms: int) -> ListCall:
    """``ListCall`` of these shapes, computed once for each in a process.
    Servers search from several threads: a reader takes the dict's entry
    as it is (entries are frozen and never change), and writers insert
    under a lock; two threads that miss together compute the same plan."""
    key = (k, mode, bool(promote), b, nprobe, kp, max_len, d, n_rows, sms)
    call = _CALLS.get(key)
    if call is None:
        call = _list_call(*key)
        with _CALLS_LOCK:
            if len(_CALLS) >= _CALLS_MAX:
                _CALLS.clear()
            _CALLS[key] = call
    return call


class _ListJob:
    """A list-scan call: its plan (``list_call``, cached by shapes: the
    kernel, segment, slot width, first pass, floor, grid and the buffer's
    layout), its one buffer (partials, published keys, the inversion's
    tables and scratch, addressed by offset; a view is made only where a
    tensor is read), the inverted probes and its launches. What depends
    only on the process or the device is cached too: the library
    (``load``), the SM count (``device_sms``) and the shared-memory
    cross-check (``_check_smem``). On CUDA tensors the inversion kernel
    fills the tables and zeroes the keys; on CPU ones (the wrapper's tests)
    the plain version is copied in. The CUDA-core kernel's BF16 mode without
    promote (the wide mode) reads q rounded to bf16 and ‖q‖² of the fp32 q
    (``qsq``); the tensor-core kernel rounds and sums them itself."""

    def __init__(self, q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                 max_len, sq8, promote):
        from pyrope_tpu_torch.kernels.build import load

        self.lib = load()
        mode = (LIST_SQ8 if sq8 is not None
                else LIST_BF16 if slab.dtype == torch.bfloat16 else LIST_IVF)
        self.b, d = q.shape
        dev = q.device
        self.nprobe = probe.shape[1]
        self.call = call = list_call(k, mode, promote, self.b, self.nprobe, kp, max_len, d,
                                     slab.shape[0], device_sms(dev))
        self.plan = call.plan
        _check_smem(self.lib, self.plan, k, d)
        self.stream = torch.cuda.current_stream(dev).cuda_stream
        _mark("plan")
        buf = torch.empty(call.total, dtype=torch.int32, device=dev)
        spans, kw = call.spans, call.plan.kw
        self.part_v = buf.narrow(0, *spans["part_v"]).view(torch.float32).view(call.slots, kw)
        self.part_i = buf.narrow(0, *spans["part_i"]).view(call.slots, kw)
        self._keys = buf.narrow(0, *spans["keys"])
        self.work = _CarvedWork(buf, spans, self.b, self.nprobe, call.segs, call.grid,
                                call.slots)
        self.keys_ptr = self.work.ptr("keys")
        _mark("alloc")
        if dev.type == "cpu":
            plain = invert_probes_plain(probe, lens, kp, max_len, call.plan.seg,
                                        slab.shape[0])
            for name in _TABLES:
                getattr(self.work, name).copy_(getattr(plain, name))
            self._keys.zero_()
        else:
            _invert_launch(self.lib, probe, lens, kp, call.plan.seg, QUERY_TILE, call.grid,
                           self.work.ptr, self.keys_ptr, spans["keys"][1] // 2, self.stream)
        _mark("invert")
        self.qsq = None
        if mode == LIST_BF16 and not promote and not self.plan.tc:
            q, self.qsq = _bf16_query(q)
        self.args = (q, slab, sqnorm, alive, offsets, lens, kp, metric_ip, sq8)
        _mark("q_bf16")

    @property
    def pub(self) -> torch.Tensor:
        """The main pass's keys: [slots] published, then [B] floors."""
        return self._keys.view(torch.int64).narrow(0, 0, self.call.slots + self.b)

    @property
    def first(self) -> torch.Tensor | None:
        """The first pass's own keys, as ``pub`` (None: no first pass)."""
        n = self.call.slots + self.b
        return (None if self.call.prefloor is None
                else self._keys.view(torch.int64).narrow(0, n, n))

    def prefloor(self) -> ListPrefloor | None:
        return self.call.prefloor

    def first_pass(self, plan: ListPrefloor, into_pub: bool = False) -> torch.Tensor | None:
        """The same items at k = c over each segment's sample, its slots'
        c-th keys into the job's first-pass keys (zeros); then each query's
        g-th largest, raised to the pass's own floor key (the floor select
        kernel): [B] floor keys, a new tensor, or with ``into_pub`` the main
        pass's query floors (None returned)."""
        w, n = self.work, self.call.slots + self.b
        first = self.keys_ptr + 8 * n
        # a g above the window: the first pass only publishes, it raises no
        # floor of its own (selecting g of 128 keys at each item's end cost
        # more than the rows it dropped)
        self.launch(plan.c, plan.c, None, None, first, plan.c, LIST_FLOOR_WINDOW + 1,
                    plan.sample)
        count_launch("list_scan_prefloor_tc" if self.plan.tc else "list_scan_prefloor")
        if self.part_v.device.type == "cpu":   # the wrapper's tests: the plain select
            keys = self.first
            got = floor_select_plain(keys[:w.slots], plan.g, w.slot_end, keys[w.slots:])
            if not into_pub:
                return got
            self.pub[w.slots:].copy_(got)
            return None
        floors = None
        if into_pub:
            out = self.keys_ptr + 8 * w.slots
        else:
            floors = torch.empty(self.b, dtype=torch.int64, device=self.part_v.device)
            out = floors.data_ptr()
        _floor_select_list_launch(self.lib, first, w.slots, w.ptr("slot_end"), self.b,
                                  self.nprobe, plan.g, first + 8 * w.slots, out, self.stream)
        return floors

    def launch(self, k, kw, part_v, part_i, pub, pub_c, pub_g, sample) -> None:
        """One launch of the plan's kernel; the partials and ``pub`` tensors
        or addresses (partials None: the first pass, pub alone written)."""
        q, slab, sqnorm, alive, offsets, lens, kp, metric_ip, sq8 = self.args
        _list_scan_launch(self.lib, self.plan, q, slab, self.qsq, sqnorm, alive, offsets,
                          lens, kp, self.work, self.nprobe, k, kw, metric_ip, part_v, part_i,
                          pub, pub_c, pub_g, sample, sq8, self.stream)


def _addr(t) -> int | None:
    """A tensor's address, an address as it is, or None."""
    return t if t is None or isinstance(t, int) else t.data_ptr()


def _list_scan_launch(lib, plan: ListPlan, q, slab, qsq, sqnorm, alive, offsets, lens, kp,
                      w, nprobe, k, kw, metric_ip, part_v, part_i, pub, pub_c, pub_g,
                      sample, sq8, stream) -> None:
    """One launch of the list scan kernel ``plan`` names (partials None: the
    first pass, pub alone written). It launches or raises."""
    from pyrope_tpu_torch.kernels.build import check

    b, d = q.shape
    if plan.tc or plan.promote:   # TMA reads 16-byte rows off a 16-byte aligned base
        vec = int(d % 8 == 0 and slab.data_ptr() % 16 == 0)
    else:
        vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0
                  and slab.data_ptr() % (4 * _LIST_ELEM[plan.mode]) == 0)
    tables = (w.ptr("pairs"), nprobe, w.ptr("cstart"), w.ptr("ccnt"), w.ptr("item_end"),
              w.ptr("item_c"), w.ptr("slot_end"), offsets.data_ptr(), lens.data_ptr(), kp,
              w.grid, b, d, k, kw, int(metric_ip), plan.seg, sample, w.slots, vec,
              _addr(part_v), _addr(part_i), _addr(pub), pub_c, pub_g, stream)
    if plan.promote:
        check(lib.pyrope_ivf_list_scan_promote(
            q.data_ptr(), slab.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(), plan.blocks,
            *tables), "IVF list scan kernel (BF16, promote_fp32)")
    elif plan.tc:
        check(lib.pyrope_ivf_list_scan_tc(
            q.data_ptr(), slab.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(),
            slab.shape[0], *tables), "IVF list scan kernel (BF16, tensor cores)")
    elif sq8 is not None:
        mins, scales, qc = sq8
        check(lib.pyrope_ivf_list_scan_sq8(
            q.data_ptr(), slab.data_ptr(), mins.data_ptr(), scales.data_ptr(),
            sqnorm.data_ptr(), alive.data_ptr(), qc.data_ptr(), qc.shape[1],
            *tables), "IVF list scan kernel (SQ8)")
    elif plan.mode == LIST_BF16:
        check(lib.pyrope_ivf_list_scan_bf16(
            q.data_ptr(), slab.data_ptr(), _addr(qsq), sqnorm.data_ptr(), alive.data_ptr(),
            *tables), "IVF list scan kernel (BF16)")
    else:
        check(lib.pyrope_ivf_list_scan(
            q.data_ptr(), slab.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(),
            *tables), "IVF list scan kernel")


def fused_ivf_topk(q, x, sqnorm, alive, crow, offsets, lens, probe, kp: int,
                   k: int, metric=Metric.L2, *, max_len: int,
                   promote_fp32: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF scan + top-k over the probed lists (K2, with K3 folded in).

    x [N, D] cluster-major f32 or bf16 slab (bf16: scored as bf16(q)·x, or
    with ``promote_fp32`` as q·x in fp32; the identity on an fp32 slab);
    sqnorm [N] f32 of the fp32 rows; crow [N] int32 cluster of each row
    (< kp); offsets, lens [kp] int32 the lists' CSR (cluster c's rows are
    offsets[c] .. offsets[c]+lens[c], matching crow); probe [B, nprobe]
    probed cluster ids (< kp, distinct in a row, as ``rank_probes`` gives
    them; see ``_check_list_preconditions``). A row hits iff it is alive and its cluster
    is in the query's probe set; there is no max_scans budget here (routes
    with a budget take the plain dense or probe scans). ``max_len`` >=
    every list length, a host int (the indexes' ``l_pad``). Returns as
    ``fused_flat_topk``."""
    _mark("start")
    metric_ip = _metric_ip(metric)
    _check_probe(q, x, crow, probe)
    _check_lists(q, probe, offsets, lens, kp, max_len)
    if not _check_inputs(q, x, sqnorm, alive, k, extra=(crow, offsets, lens)):
        _check_list_preconditions(probe, lens, max_len)
        return fused_ivf_topk_plain(q, x, sqnorm, alive, crow, probe, kp, k,
                                    metric, promote_fp32=promote_fp32)
    check_fp32_exact(q)
    _mark("checks")
    return _launch_list(q, x, sqnorm, alive, offsets, lens, probe, kp, k,
                        metric_ip, max_len, promote=promote_fp32)


def fused_ivf_sq8_topk(q, codes, mins, scales, sqnorm, alive, crow, offsets, lens,
                       probe, qc, kp: int, k: int, metric=Metric.L2, *,
                       max_len: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF scan + top-k over a residual-SQ8 slab (K4, with K5 folded in).

    codes [N, D] uint8 cluster-major residual codes; mins, scales [N] f32
    and sqnorm [N] f32 = ||x̂||² of the reconstruction x̂ = c[crow] + min +
    scale·code; qc [B, kp] f32 = q·centsᵀ (the kernel reads qc[b, c] once
    per probed list); crow, offsets, lens, probe, max_len and the return as
    ``fused_ivf_topk``."""
    _mark("start")
    metric_ip = _metric_ip(metric)
    _check_probe(q, codes, crow, probe)
    _check_lists(q, probe, offsets, lens, kp, max_len)
    n = codes.shape[0]
    if mins.shape != (n,) or scales.shape != (n,):
        raise ValueError("mins and scales must be [N]")
    if qc.shape != (q.shape[0], kp):
        raise ValueError(f"qc must be [B, kp] = {(q.shape[0], kp)}, got {tuple(qc.shape)}")
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {codes.dtype}")
    if not all(t.dtype == torch.float32 for t in (mins, scales, qc)):
        raise ValueError("mins, scales and qc must be float32")
    if not _check_inputs(q, codes, sqnorm, alive, k,
                         extra=(crow, offsets, lens, mins, scales, qc),
                         slab_dtypes=(torch.uint8,)):
        _check_list_preconditions(probe, lens, max_len)
        return fused_ivf_sq8_topk_plain(q, codes, mins, scales, sqnorm, alive,
                                        crow, probe, qc, kp, k, metric)
    check_fp32_exact(q)
    _mark("checks")
    return _launch_list(q, codes, sqnorm, alive, offsets, lens, probe, kp, k,
                        metric_ip, max_len, sq8=(mins, scales, qc))
