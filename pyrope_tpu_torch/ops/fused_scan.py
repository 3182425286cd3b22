"""Exact scans + running top-k: wrappers of the CUDA kernels in
``pyrope_tpu_torch/csrc/`` and their plain PyTorch twins.

Replaces ``pyrope_tpu/ops/pallas_scan.py``:
  - ``fused_flat_topk``  <- ``pallas_flat_topk`` (K1, :672): the flat scan
    kernel (csrc/fused_scan.cu), corpus splits into [B, splits, k] partials;
    ``flat_tile`` picks its query tile, ``scan_splits`` its grid.
  - ``fused_ivf_topk``   <- ``pallas_ivf_topk`` (K2, :1035) and
    ``pallas_ivf_topk_windowed`` (K3, :992), and
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
products, fp32 sums); ``fused_ivf_topk(promote_fp32=True)`` scores the fp32
q against the widened rows. In both, ‖q‖² is that of the fp32 q and
``sqnorm`` that of the fp32 rows before the cast.

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

import dataclasses
import numbers

import torch

from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.ops.distance import check_fp32_exact

# MAXK, BT and RT of the CUDA sources; the kernels refuse any other k range
MAX_K = 128              # list slots per query (4 per lane)
QUERY_TILE = 64          # queries per list chunk; the flat scan's narrow tile
FLAT_QUERY_TILES = (128, 64)  # the flat scan's instantiations, widest first
ROW_TILE = 128           # corpus rows per tile
FLAT_STAGES = 2          # NST of fused_scan.cu: stages in the copy ring
FLAT_ROW_BYTES = 128     # bytes of a row a stage holds: 32 fp32 or 64 bf16 depths
FLAT_FLOOR_WINDOW = 32   # WIN: splits whose published scores a warp reads
LIST_SEG = 2048          # rows of one cluster a list-scan block walks at most
LIST_SEG_MIN = 256       # shortest segment list_seg cuts for parallelism
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use on sm_90
SMEM_TWO_BLOCKS = 115_712  # the most a block may use for two to share an SM
                           # (233,472 B an SM, 1,024 B a block reserved)
IVF_MAX_KPAD = 8192      # widest cluster table a route sends the list scan
# the list scan's modes (ivf_list_scan.cu Mode) and their slab element bytes
LIST_IVF, LIST_SQ8, LIST_BF16 = 1, 2, 3
_LIST_ELEM = {LIST_IVF: 4, LIST_SQ8: 1, LIST_BF16: 2}
LIST_DEPTH_CHUNK = 64    # DCH of ivf_list_scan.cu: depth elements a stage
LIST_LD_PAD = 4          # QS_LD - BT and XLD - DCH: the padding of its rows
_BLOCKS_PER_SM = 4       # list-scan grid target: blocks in flight per SM
_FLAT_BLOCKS_PER_SM = 2  # flat grid target: one wave of two blocks an SM

# launches of each kernel since the last reset_launches()
LAUNCHES = {"flat_scan": 0, "flat_scan_bf16": 0, "ivf_scan": 0, "ivf_scan_bf16": 0,
            "sq8_scan": 0, "merge": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


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
    """Why the kernels do not take ``k`` hits a query, or None."""
    if 1 <= k <= MAX_K:
        return None
    why = f"k must be in [1, {MAX_K}], got {k}"
    if k > MAX_K:
        why += (f": the CUDA kernels hold {MAX_K} list slots a query "
                "(wide k: ROADMAP.md queue 2 item B)")
    return why


def list_scan_smem_bytes(d: int, k: int, mode: int) -> int:
    """Shared memory of a list-scan block, as ``list_scan_smem_bytes`` of
    ivf_list_scan.cu computes it: a chunk's queries whole ([D][BT + 4]
    floats), two stages of RT rows x (DCH + 4) slab elements, the row tables
    of two tiles, the per-query tables and the lists."""
    d4 = -(-d // 4) * 4
    return (4 * d4 * (QUERY_TILE + LIST_LD_PAD)
            + 2 * ROW_TILE * (LIST_DEPTH_CHUNK + LIST_LD_PAD) * _LIST_ELEM[mode]
            + 2 * ROW_TILE * 4 * (4 if mode == LIST_SQ8 else 2)
            + 7 * QUERY_TILE * 4 + 8 * QUERY_TILE * k)


def list_scan_refusal(d: int, k: int, mode: int) -> str | None:
    """Why the list scan does not take depth ``d`` and ``k`` hits in
    ``mode``, or None when it does. Decided on the host from shapes alone:
    the routes of the IVF indexes call it before any launch."""
    why = k_refusal(k)
    if why is None and list_scan_smem_bytes(d, k, mode) > SMEM_LIMIT:
        why = (f"D {d} needs {list_scan_smem_bytes(d, k, mode)} B of shared memory "
               f"in the list scan, over the {SMEM_LIMIT} B a block may use "
               "(large D: ROADMAP.md queue 2 item C)")
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


def flat_scan_smem_bytes(k: int, query_tile: int, elem: int = 4) -> int:
    """Shared memory of a flat-scan block, as ``scan_smem_bytes`` of
    fused_scan.cu computes it: the ring of stages (each a depth chunk of
    the tile's rows, 128 bytes of each, and the same depths of its fp32
    queries, and the rows' table), four words a query, and the lists. It
    does not depend on D: q is streamed."""
    stage = ROW_TILE * FLAT_ROW_BYTES // 4 + query_tile * (FLAT_ROW_BYTES // elem)
    return 4 * (FLAT_STAGES * (stage + ROW_TILE) + 4 * query_tile
                + 2 * query_tile * k)


def flat_tile(d: int, k: int, b: int, elem: int = 4) -> tuple[int, int]:
    """(query tile, shared-memory bytes) of the flat scan's instantiation
    for depth ``d``, ``k`` hits, ``b`` queries and rows of ``elem`` bytes an
    element (4 fp32, 2 bf16): the 128-query tile, or
    the 64-query one where a batch fits it (at B <= 64 a wider tile is
    padding). The first of which two blocks fit an SM wins (two blocks hide
    each other's list insertions: k <= 45 at 128 queries, k <= 125 at 64),
    else the first that fits at all. Raises where none fits."""
    if d < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"flat scan takes D >= 1 and k in [1, {MAX_K}], got D={d}, k={k}")
    fits = [(tile, flat_scan_smem_bytes(k, tile, elem)) for tile in FLAT_QUERY_TILES
            if b > QUERY_TILE or tile == QUERY_TILE]
    for limit in (SMEM_TWO_BLOCKS, SMEM_LIMIT):
        for tile, smem in fits:
            if smem <= limit:
                return tile, smem
    raise ValueError(
        f"flat scan needs {min(smem for _, smem in fits)} B of shared memory "
        f"(D={d}, k={k}), over the {SMEM_LIMIT} B a block may use")


def flat_floor(k: int, n_splits: int) -> tuple[int, int]:
    """(c, g) of the flat scan's shared floor: each of a query's splits
    publishes the c-th score of its list, and a warp drops rows under the
    g-th largest of up to FLAT_FLOOR_WINDOW published scores; g·c >= k
    rows lie at or above it, so no dropped row is a hit."""
    c = -(-k // min(n_splits, FLAT_FLOOR_WINDOW))
    return c, -(-k // c)


def scan_splits(b: int, n_rows: int, dev: torch.device,
                query_tile: int = QUERY_TILE) -> tuple[int, int]:
    """(rows_per_split, n_splits) of the scan grid: enough corpus splits
    that it holds about _FLAT_BLOCKS_PER_SM blocks per SM, each split a
    whole number of row tiles."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return _splits(b, n_rows, sms, query_tile)


def _splits(b: int, n_rows: int, sms: int, query_tile: int) -> tuple[int, int]:
    q_tiles = -(-b // query_tile)
    tiles = max(-(-n_rows // ROW_TILE), 1)
    want = min(max(-(-_FLAT_BLOCKS_PER_SM * sms // q_tiles), 1), tiles)
    per = -(-tiles // want) * ROW_TILE
    return per, max(-(-n_rows // per), 1)


def merge_partials_plain(part_v, part_i, qend=None):
    """Plain version of ``merge_partials``: (score desc, row asc) over every
    list of a query, whatever order the lists come in (two stable sorts:
    rows, then scores)."""
    if qend is not None:  # per-query lists, padded to [most lists, B, k]
        qoff = torch.nn.functional.pad(qend[:, -1], (1, 0))
        k, cnt = part_v.shape[1], qoff.diff()
        m = int(cnt.max()) if cnt.numel() else 0
        if m == 0:
            return _empty_hits(cnt.numel(), k, part_v.device)
        j = torch.arange(m, device=part_v.device)
        ok = (j[None, :] < cnt[:, None])[..., None]
        rows = torch.where(ok[..., 0], qoff[:-1, None] + j, 0).long()
        part_v = torch.where(ok, part_v[rows], float("-inf")).permute(1, 0, 2)
        part_i = torch.where(ok, part_i[rows], -1).permute(1, 0, 2)
    s, b, k = part_v.shape
    v = part_v.permute(1, 0, 2).reshape(b, s * k)
    i = part_i.permute(1, 0, 2).reshape(b, s * k)
    by_row = torch.sort(i, dim=1, stable=True).indices
    v, i = torch.gather(v, 1, by_row), torch.gather(i, 1, by_row)
    vals, pos = torch.sort(v, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(i, 1, pos[:, :k])


def merge_partials(part_v, part_i, qend=None):
    """Sorted lists (f32 scores, int32 rows, -inf/-1 empty) -> the [B, k]
    top-k of each query across its lists, (score desc, row asc): the merge
    kernel on CUDA tensors, the plain version on CPU ones. Lists are
    [S, B, k] (S lists for every query), or with ``qend`` [B, P] int32
    [slots, k] rows, query b's from qend[b-1, -1] (0 for b = 0) to
    qend[b, -1] (the list scan's running slot counts, ``ListWork``)."""
    if part_v.device.type == "cpu":
        return merge_partials_plain(part_v, part_i, qend)
    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise ValueError("partials must be float32 scores and int32 rows")
    tensors = (part_v, part_i) if qend is None else (part_v, part_i, qend)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous tensors")
    if qend is None:
        s, b, k = part_v.shape
        nprobe = 0
    else:
        if qend.dtype != torch.int32 or qend.device != part_v.device:
            raise ValueError("qend must be int32 on the partials' device")
        (s, k), (b, nprobe) = part_v.shape, qend.shape
    if qend is None:  # [S, B, k]: list s of query b at (s·B + b)·k
        return _merge_launch(part_v, part_i, s, b, k, None, 0, k, b * k)
    return _merge_launch(part_v, part_i, s, b, k, qend, nprobe, 0, k)


def _merge_launch(part_v, part_i, s, b, k, qend, nprobe, qstride, lstride):
    """The merge kernel over partials whose list ``l`` of query ``q`` starts
    at entry q·qstride + l·lstride (``qend`` None), or over [s, k] rows cut
    by ``qend``. The one place the merge is launched and counted."""
    from pyrope_tpu_torch.kernels.build import check, load

    out_v = torch.empty((b, k), dtype=torch.float32, device=part_v.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=part_v.device)
    if b == 0:
        return out_v, out_i  # an empty grid is not a valid launch
    check(load().pyrope_merge_partials(
        part_v.data_ptr(), part_i.data_ptr(), s, b, k,
        None if qend is None else qend.data_ptr(), nprobe, qstride, lstride,
        out_v.data_ptr(), out_i.data_ptr(),
        torch.cuda.current_stream(part_v.device).cuda_stream,
    ), "merge kernel")
    LAUNCHES["merge"] += 1
    return out_v, out_i


def _empty_hits(b, k, dev):
    return (torch.full((b, k), float("-inf"), device=dev),
            torch.full((b, k), -1, dtype=torch.int32, device=dev))


def _bf16_query(q):
    """(bf16(q) as fp32, ‖q‖² of the unrounded q): what the bf16 modes
    without promote read for q."""
    return q.bfloat16().float(), (q * q).sum(dim=1)


def _launch(q, x, sqnorm, alive, k, metric_ip, max_scans):
    """The flat scan kernel into [B, splits, k] partials, then the merge;
    bf16 mode over a bf16 ``x``."""
    from pyrope_tpu_torch.kernels.build import check, load

    lib = load()
    b, d = q.shape
    elem = x.element_size()
    tile, smem = flat_tile(d, k, b, elem)
    if lib.pyrope_scan_smem_bytes(k, tile, elem) != smem:
        raise RuntimeError("flat_tile and fused_scan.cu disagree on shared memory")
    if b == 0:  # an empty grid is not a valid launch
        return _empty_hits(0, k, q.device)
    per, n_splits = scan_splits(b, max_scans, q.device, tile)
    part_v = torch.empty((b, n_splits, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_splits, k), dtype=torch.int32, device=q.device)
    pub_c, pub_g = flat_floor(k, n_splits)
    pub = torch.full((b, n_splits), float("-inf"), device=q.device)
    qsq = None
    if elem == 2:
        q, qsq = _bf16_query(q)
    vec = int(d % (16 // elem) == 0 and q.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 0)
    check(lib.pyrope_fused_scan(
        q.data_ptr(), x.data_ptr(), None if qsq is None else qsq.data_ptr(),
        sqnorm.data_ptr(), alive.data_ptr(), b, x.shape[0], d, k, int(metric_ip),
        max_scans, per, n_splits, tile, elem, vec, part_v.data_ptr(),
        part_i.data_ptr(), pub.data_ptr(), pub_c, pub_g,
        torch.cuda.current_stream(q.device).cuda_stream,
    ), "fused scan kernel")
    LAUNCHES["flat_scan_bf16" if elem == 2 else "flat_scan"] += 1
    return _merge_launch(part_v, part_i, n_splits, b, k, None, 0, n_splits * k, k)


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


def invert_probes(probe: torch.Tensor, lens: torch.Tensor, kp: int, max_len: int,
                  seg: int, n_rows: int, chunk: int = QUERY_TILE) -> ListWork:
    """Group the (query, probe position) pairs of ``probe`` [B, P] by
    cluster and lay out the list scan's items: item = (cluster, chunk of <=
    ``chunk`` of its queries, segment of <= ``seg`` of its ``lens`` rows).
    Pair j = b·P + p gets one partial slot per segment of its list, the
    slot_end[j] - segments(j) .. slot_end[j] before it; a query's slots are
    contiguous, so the merge reads only the lists its probes have.
    ``max_len`` >= every list length; the lists cover at most ``n_rows``
    rows. Device-side torch throughout, in few launches: on the card each
    costs more host time than device time."""
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
    hits (the kernel never writes out of bounds)."""
    if lens.numel() and int(lens.max()) > max_len:
        raise ValueError(f"max_len {max_len} is below the longest list, {int(lens.max())}")
    ranked = probe.sort(dim=1).values
    if bool((ranked[:, 1:] == ranked[:, :-1]).any()):
        raise ValueError("a probe row names a cluster twice")


def _launch_list(q, slab, sqnorm, alive, offsets, lens, probe, kp, k, metric_ip,
                 max_len, sq8=None, promote=False):
    """The list scan kernel into per-query partial slots, then the merge.
    IVF mode over an fp32 slab, BF16 mode over a bf16 one (q rounded unless
    ``promote``); SQ8 mode when ``sq8`` = (mins, scales, qc)."""
    from pyrope_tpu_torch.kernels.build import check, load

    lib = load()
    b, d = q.shape
    mode = (LIST_SQ8 if sq8 is not None
            else LIST_BF16 if slab.dtype == torch.bfloat16 else LIST_IVF)
    if lib.pyrope_list_scan_smem_bytes(d, k, mode) != list_scan_smem_bytes(d, k, mode):
        raise RuntimeError("list_scan_smem_bytes and ivf_list_scan.cu disagree")
    why = list_scan_refusal(d, k, mode)
    if why is not None:
        raise ValueError(why)
    nprobe = probe.shape[1]
    if b == 0 or nprobe == 0:
        return _empty_hits(b, k, q.device)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    seg = list_seg(b, nprobe, kp, max_len, sms)
    w = invert_probes(probe, lens, kp, max_len, seg, slab.shape[0])
    # every slot below slot_end[-1, -1] is written by the one item covering it
    part_v = torch.empty((w.slots, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((w.slots, k), dtype=torch.int32, device=q.device)
    qfloor = torch.zeros(b, dtype=torch.int64, device=q.device)  # 0: no floor yet
    qsq = None
    if mode == LIST_BF16 and not promote:
        q, qsq = _bf16_query(q)
    vec = int(d % 4 == 0 and q.data_ptr() % 16 == 0
              and slab.data_ptr() % (4 * _LIST_ELEM[mode]) == 0)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tables = (w.pairs.data_ptr(), nprobe, w.cstart.data_ptr(), w.ccnt.data_ptr(),
              w.item_end.data_ptr(), w.item_c.data_ptr(), w.slot_end.data_ptr(),
              offsets.data_ptr(), lens.data_ptr(), kp, w.grid, b, d, k,
              int(metric_ip), seg, w.slots, vec, part_v.data_ptr(), part_i.data_ptr(),
              qfloor.data_ptr(), stream)
    if sq8 is not None:
        mins, scales, qc = sq8
        check(lib.pyrope_ivf_list_scan_sq8(
            q.data_ptr(), slab.data_ptr(), mins.data_ptr(), scales.data_ptr(),
            sqnorm.data_ptr(), alive.data_ptr(), qc.data_ptr(), qc.shape[1],
            *tables), "IVF list scan kernel (SQ8)")
        LAUNCHES["sq8_scan"] += 1
    elif mode == LIST_BF16:
        check(lib.pyrope_ivf_list_scan_bf16(
            q.data_ptr(), slab.data_ptr(), None if qsq is None else qsq.data_ptr(),
            sqnorm.data_ptr(), alive.data_ptr(), *tables), "IVF list scan kernel (BF16)")
        LAUNCHES["ivf_scan_bf16"] += 1
    else:
        check(lib.pyrope_ivf_list_scan(
            q.data_ptr(), slab.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(),
            *tables), "IVF list scan kernel")
        LAUNCHES["ivf_scan"] += 1
    return merge_partials(part_v, part_i, w.slot_end)


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
    metric_ip = _metric_ip(metric)
    _check_probe(q, x, crow, probe)
    _check_lists(q, probe, offsets, lens, kp, max_len)
    if not _check_inputs(q, x, sqnorm, alive, k, extra=(crow, offsets, lens)):
        _check_list_preconditions(probe, lens, max_len)
        return fused_ivf_topk_plain(q, x, sqnorm, alive, crow, probe, kp, k,
                                    metric, promote_fp32=promote_fp32)
    check_fp32_exact(q)
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
    return _launch_list(q, codes, sqnorm, alive, offsets, lens, probe, kp, k,
                        metric_ip, max_len, sq8=(mins, scales, qc))
