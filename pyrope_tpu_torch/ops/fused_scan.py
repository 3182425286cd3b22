"""Fused exact scan + running top-k: wrappers of the CUDA kernels in
``pyrope_tpu_torch/csrc/fused_scan.cu`` and their plain PyTorch twins.

Replaces ``pyrope_tpu/ops/pallas_scan.py``:
  - ``fused_flat_topk``  <- ``pallas_flat_topk`` (K1, :672)
  - ``fused_ivf_topk``   <- ``pallas_ivf_topk`` (K2, :1035) and
    ``pallas_ivf_topk_windowed`` (K3, :992): the CUDA kernel resolves probe
    membership with a bitmap lookup in shared memory, which takes any
    cluster-table width, so K3's per-tile cluster window has no counterpart.
  - ``fused_ivf_sq8_topk`` <- ``pallas_ivf_sq8_topk`` (K4, :1204) and
    ``pallas_ivf_sq8_topk_windowed`` (K5, :1341), folded the same way: the
    IVF scan over a residual-SQ8 slab (uint8 codes + per-row min/scale).
    The TPU kernels' masked [B, Kp] centroid-dot table (``MASK_SENT``
    where a cluster is not probed) becomes the probe bitmap plus the plain
    qc = q·centsᵀ the kernel reads for live rows only.
All run the same scan kernel (FLAT, IVF or SQ8 mode) and then the merge
kernel that reduces the per-split partial lists, the work of the Pallas
bodies' ``_merge_tile`` (:401) and ``_finish_topk`` (:642).

What bounds the kernel on an H100, and what the design does about it, is
in the header of the CUDA source: at B = 1024 the slab is re-read once per
64-query tile (the query tiles of one corpus split run side by side, so
the re-reads can share L2), the fp32 product runs on the CUDA cores (exact
fp32 has no tensor-core path), and the threshold-gated top-k update is the
per-row cost.

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

import torch

from pyrope_tpu.types import Metric
from pyrope_tpu_torch.ops.distance import check_fp32_exact

# MAXK, BT and RT of the CUDA source; the kernel refuses any other k range
MAX_K = 128              # list slots per query (4 per lane)
QUERY_TILE = 64          # queries per block
ROW_TILE = 128           # corpus rows per tile
SMEM_LIMIT = 232_448     # bytes of shared memory a block may use on sm_90
IVF_MAX_KPAD = 8192      # widest probe bitmap a route sends the kernel
_BLOCKS_PER_SM = 4       # grid target: blocks in flight per SM

# launches of each kernel since the last reset_launches()
LAUNCHES = {"flat_scan": 0, "ivf_scan": 0, "sq8_scan": 0, "merge": 0}


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


def _fp32_scores(q, x, sqnorm, metric_ip):
    return lambda s, e: _l2_or_ip(q, q @ x[s:e].T, sqnorm[s:e], metric_ip)


def fused_flat_topk_plain(q, x, sqnorm, alive, max_scans: int, k: int,
                          metric=Metric.L2, *, chunk_rows: int = 8192):
    """Plain version of ``fused_flat_topk``: same inputs, same outputs."""
    metric_ip = _metric_ip(metric)
    ms = int(max_scans)

    def row_mask(s, e):
        rows = torch.arange(s, e, device=q.device)
        return (alive[s:e] & (rows < ms))[None, :]

    return _plain_scan(q, x.shape[0], _fp32_scores(q, x, sqnorm, metric_ip),
                       row_mask, k, chunk_rows)


def probe_table(probe: torch.Tensor, kp: int) -> torch.Tensor:
    """[B, nprobe] probe ids -> [B, kp] bool membership table."""
    t = torch.zeros((probe.shape[0], kp), dtype=torch.bool, device=probe.device)
    return t.scatter_(1, probe.long(), True)  # in place on a fresh table


def fused_ivf_topk_plain(q, x, sqnorm, alive, crow, probe, kp: int, k: int,
                         metric=Metric.L2, *, chunk_rows: int = 8192):
    """Plain version of ``fused_ivf_topk``: same inputs, same outputs."""
    metric_ip = _metric_ip(metric)
    return _plain_scan(q, x.shape[0], _fp32_scores(q, x, sqnorm, metric_ip),
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


def _check_inputs(q, x, sqnorm, alive, k, extra=(), slab_dtype=torch.float32):
    """Shapes, dtypes and devices the kernel takes; raises on the rest.
    Returns True when the tensors lie on a CUDA device."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"q [B, D] and x [N, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(x.shape)}")
    if x.dtype != slab_dtype:
        raise NotImplementedError(
            f"slab dtype {x.dtype} not yet ported: this scan takes {slab_dtype} slabs")
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


def scan_splits(b: int, n_rows: int, dev: torch.device) -> tuple[int, int]:
    """(rows_per_split, n_splits) of the scan grid: enough corpus splits
    that it holds about _BLOCKS_PER_SM blocks per SM, each split a whole
    number of row tiles."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    q_tiles = -(-b // QUERY_TILE)
    tiles = max(-(-n_rows // ROW_TILE), 1)
    want = min(max(-(-_BLOCKS_PER_SM * sms // q_tiles), 1), tiles)
    per = -(-tiles // want) * ROW_TILE
    return per, max(-(-n_rows // per), 1)


def merge_partials_plain(part_v, part_i):
    """Plain version of ``merge_partials``. Split-major concatenation puts
    lower rows first among equal scores, so a stable sort keeps (score
    desc, row asc)."""
    s, b, k = part_v.shape
    v = part_v.permute(1, 0, 2).reshape(b, s * k)
    i = part_i.permute(1, 0, 2).reshape(b, s * k)
    vals, pos = torch.sort(v, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(i, 1, pos[:, :k])


def merge_partials(part_v, part_i):
    """[S, B, k] per-split sorted lists (f32 scores, int32 rows, -inf/-1
    empty) -> the [B, k] top-k of each query across splits, (score desc,
    row asc): the merge kernel on CUDA tensors, the plain version on CPU
    ones."""
    if part_v.device.type == "cpu":
        return merge_partials_plain(part_v, part_i)
    from pyrope_tpu_torch.kernels.build import check, load

    if part_v.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise ValueError("partials must be float32 scores and int32 rows")
    if not (part_v.is_contiguous() and part_i.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors")
    s, b, k = part_v.shape
    out_v = torch.empty((b, k), dtype=torch.float32, device=part_v.device)
    out_i = torch.empty((b, k), dtype=torch.int32, device=part_v.device)
    if b == 0:
        return out_v, out_i  # an empty grid is not a valid launch
    check(load().pyrope_merge_partials(
        part_v.data_ptr(), part_i.data_ptr(), s, b, k, out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(part_v.device).cuda_stream,
    ), "merge kernel")
    LAUNCHES["merge"] += 1
    return out_v, out_i


def _launch(q, x, sqnorm, alive, k, metric_ip, n_rows, *, max_scans=0,
            crow=None, bitmap=None, sq8=None):
    """The scan kernel into [splits, B, k] partials, then the merge. FLAT
    mode without ``crow``; IVF mode with ``crow`` and ``bitmap``; SQ8 mode
    when ``sq8`` = (mins, scales, qc) comes too."""
    from pyrope_tpu_torch.kernels.build import check, load

    lib = load()
    b, d = q.shape
    words = 0 if bitmap is None else bitmap.shape[1]
    smem = lib.pyrope_scan_smem_bytes(d, k, words, int(sq8 is not None))
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"scan needs {smem} B of shared memory (D={d}, k={k}, "
            f"bitmap words={words}), over the {SMEM_LIMIT} B a block may use")
    if b == 0:  # an empty grid is not a valid launch
        empty = torch.empty((0, k), dtype=torch.float32, device=q.device)
        return empty, empty.int()
    per, n_splits = scan_splits(b, n_rows, q.device)
    part_v = torch.empty((n_splits, b, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((n_splits, b, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if sq8 is not None:
        mins, scales, qc = sq8
        check(lib.pyrope_fused_scan_sq8(
            q.data_ptr(), x.data_ptr(), mins.data_ptr(), scales.data_ptr(),
            sqnorm.data_ptr(), alive.data_ptr(), crow.data_ptr(),
            bitmap.data_ptr(), words, qc.data_ptr(), qc.shape[1], b,
            x.shape[0], d, k, int(metric_ip), per, n_splits,
            part_v.data_ptr(), part_i.data_ptr(), stream,
        ), "fused SQ8 scan kernel")
        LAUNCHES["sq8_scan"] += 1
        return merge_partials(part_v, part_i)
    ivf = crow is not None
    check(lib.pyrope_fused_scan(
        q.data_ptr(), x.data_ptr(), sqnorm.data_ptr(), alive.data_ptr(),
        crow.data_ptr() if ivf else None, bitmap.data_ptr() if ivf else None,
        words, b, x.shape[0], d, k, int(metric_ip), max_scans, per, n_splits,
        part_v.data_ptr(), part_i.data_ptr(), stream,
    ), "fused scan kernel")
    LAUNCHES["ivf_scan" if ivf else "flat_scan"] += 1
    return merge_partials(part_v, part_i)


def fused_flat_topk(q, x, sqnorm, alive, max_scans: int, k: int,
                    metric=Metric.L2) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused masked exact scan + top-k over a flat slab (K1).

    q [B, D] f32, x [N, D] f32 slab, sqnorm [N] f32, alive [N] bool; rows
    >= ``max_scans`` never hit. Returns (values [B, k] f32, rows [B, k]
    int32), (score desc, row asc), -inf/-1 for missing hits. Any B and N:
    the kernel masks the ragged edges itself."""
    metric_ip = _metric_ip(metric)
    if not _check_inputs(q, x, sqnorm, alive, k):
        return fused_flat_topk_plain(q, x, sqnorm, alive, max_scans, k, metric)
    check_fp32_exact(q)
    ms = max(min(int(max_scans), x.shape[0]), 0)
    return _launch(q, x, sqnorm, alive, k, metric_ip, ms, max_scans=ms)


def probe_bitmap(probe: torch.Tensor, kp: int) -> torch.Tensor:
    """[B, nprobe] probe ids -> [B, ceil(kp/32)] int32 words, bit c%32 of
    word c//32 set iff cluster c is probed (the kernel reads them as
    uint32)."""
    words = -(-kp // 32)
    t = probe_table(probe, words * 32).view(probe.shape[0], words, 32)
    shifts = torch.arange(32, device=probe.device, dtype=torch.int64)
    w = (t.long() << shifts).sum(dim=-1)                 # < 2**32
    return torch.where(w >= 2**31, w - 2**32, w).int()   # same bits, int32


def fused_ivf_topk(q, x, sqnorm, alive, crow, probe, kp: int, k: int,
                   metric=Metric.L2) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused dense-mask IVF scan + top-k (K2, with K3 folded in).

    x [N, D] cluster-major f32 slab; crow [N] int32 cluster of each row
    (< kp); probe [B, nprobe] probed cluster ids (< kp). A row hits iff it
    is alive and its cluster is in the query's probe set; there is no
    max_scans budget here (routes with a budget take the plain dense or
    probe scans). Returns as ``fused_flat_topk``."""
    metric_ip = _metric_ip(metric)
    _check_probe(q, x, crow, probe)
    if not _check_inputs(q, x, sqnorm, alive, k, extra=(crow,)):
        return fused_ivf_topk_plain(q, x, sqnorm, alive, crow, probe, kp, k,
                                    metric)
    check_fp32_exact(q)
    bitmap = probe_bitmap(probe, kp)
    return _launch(q, x, sqnorm, alive, k, metric_ip, x.shape[0], crow=crow,
                   bitmap=bitmap)


def fused_ivf_sq8_topk(q, codes, mins, scales, sqnorm, alive, crow, probe, qc,
                       kp: int, k: int, metric=Metric.L2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused dense-mask IVF scan + top-k over a residual-SQ8 slab (K4, with
    K5 folded in).

    codes [N, D] uint8 cluster-major residual codes; mins, scales [N] f32
    and sqnorm [N] f32 = ||x̂||² of the reconstruction x̂ = c[crow] + min +
    scale·code; qc [B, kp] f32 = q·centsᵀ (the kernel reads it for live
    rows only); crow, probe, alive and the return as ``fused_ivf_topk``."""
    metric_ip = _metric_ip(metric)
    _check_probe(q, codes, crow, probe)
    n = codes.shape[0]
    if mins.shape != (n,) or scales.shape != (n,):
        raise ValueError("mins and scales must be [N]")
    if qc.shape != (q.shape[0], kp):
        raise ValueError(f"qc must be [B, kp] = {(q.shape[0], kp)}, got {tuple(qc.shape)}")
    if codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8, got {codes.dtype}")
    if not all(t.dtype == torch.float32 for t in (mins, scales, qc)):
        raise ValueError("mins, scales and qc must be float32")
    if not _check_inputs(q, codes, sqnorm, alive, k, extra=(crow, mins, scales, qc),
                         slab_dtype=torch.uint8):
        return fused_ivf_sq8_topk_plain(q, codes, mins, scales, sqnorm, alive,
                                        crow, probe, qc, kp, k, metric)
    check_fp32_exact(q)
    return _launch(q, codes, sqnorm, alive, k, metric_ip, n, crow=crow,
                   bitmap=probe_bitmap(probe, kp), sq8=(mins, scales, qc))
