"""Batched score functions (port of ``pyrope_tpu/ops/distance.py``).

Score convention (higher is better), as in the JAX package:
    L2     -> -squared_distance     (‖q‖² + ‖x‖² − 2·q·x, clamped at 0)
    IP     -> dot(q, x)
    COSINE -> dot(q, x) / (‖q‖·‖x‖)

Exact fp32 means IEEE fp32 products: no TF32 anywhere. The JAX package pins
``Precision.HIGHEST`` for the same reason (its ops/distance.py:60-67). A
float32 matmul on a CUDA tensor runs in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set, so the functions here
refuse to run in that state instead of returning rounded scores. Callers
that also run cuDNN set ``torch.backends.cudnn.allow_tf32 = False`` too.
"""

from __future__ import annotations

import torch

from pyrope_tpu_torch.types import Metric


def check_fp32_exact(t: torch.Tensor) -> None:
    """Raise where a float32 matmul on ``t``'s device would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: exact fp32 "
            "scores need it False (TF32 keeps ~3 decimal digits)"
        )


def torch_dtype(dtype) -> torch.dtype:
    """A compute dtype as the JAX package names it ("bfloat16", ...) or a
    torch dtype -> the torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
    if not isinstance(found, torch.dtype) or not found.is_floating_point:
        raise ValueError(f"unknown compute dtype {dtype!r}")
    return found


def rounded(x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """fp32 ``x`` with its values rounded to ``compute_dtype`` (None: x as
    fp32). The operands of a product in ``compute_dtype`` with fp32 sums,
    as JAX's ``preferred_element_type=float32`` takes them: products of two
    bf16 values are exact in fp32, so an fp32 matmul of the rounded values
    sums what the JAX package's bf16 dot sums. A matmul on bf16 tensors
    would round the sum to bf16 as well."""
    if compute_dtype is None:
        return x.float()
    return x.to(torch_dtype(compute_dtype)).float()


def row_sqnorms(x: torch.Tensor) -> torch.Tensor:
    """Per-row squared norms ‖x‖² (fp32)."""
    xf = x.float()
    return (xf * xf).sum(dim=-1)


def score_matrix(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric,
    *,
    x_sqnorm: torch.Tensor | None = None,
    compute_dtype=None,
) -> torch.Tensor:
    """Scores[b, n] for every query row against every corpus row.

    q: [B, D], x: [N, D] (fp32, or a bf16 slab, widened) on one device.
    Returns [B, N] float32, higher = better. ``x_sqnorm``: optional
    precomputed ‖x‖² [N] (fp32). ``compute_dtype`` (e.g. "bfloat16"): the
    dtype both matmul operands are rounded to; the sum is fp32 and the
    norms come from the unrounded operands, as in the JAX package."""
    metric = Metric.parse(metric)
    check_fp32_exact(q)
    qf, xf = q.float(), x.float()
    if compute_dtype is None:
        dots = qf @ xf.T
    else:
        dots = rounded(qf, compute_dtype) @ rounded(xf, compute_dtype).T
    if metric == Metric.INNER_PRODUCT:
        return dots
    qq = row_sqnorms(qf)
    xx = x_sqnorm if x_sqnorm is not None else row_sqnorms(xf)
    if metric == Metric.L2:
        # clamp tiny negative values from cancellation so score <= 0
        return -torch.clamp(qq[:, None] - 2.0 * dots + xx[None, :], min=0.0)
    return dots / torch.clamp(torch.sqrt(qq)[:, None] * torch.sqrt(xx)[None, :],
                              min=1e-12)  # COSINE


def rerank_exact(
    x: torch.Tensor,
    sqnorm: torch.Tensor,
    q: torch.Tensor,
    cand_rows: torch.Tensor,
    k: int,
    metric: Metric,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather shortlisted rows and re-score them exactly; final top-k.

    x: [N_pad, D] rows, sqnorm: [N_pad] fp32 ‖x‖², q: [B, D] fp32
    (pre-normalized for cosine), cand_rows: [B, R] slab rows, -1 = missing.
    Returns ([B, k] scores, [B, k] int32 rows), -inf/-1 for missing; ties
    order by candidate position, as ``lax.top_k`` does."""
    safe = torch.clamp(cand_rows.long(), min=0)
    return _rerank(x[safe].float(), sqnorm, q, cand_rows, k, metric)


def _rerank(vecs, sqnorm, q, cand_rows, k, metric):
    """Score the gathered candidates vecs [B, R, D] fp32 exactly; top-k."""
    from pyrope_tpu_torch.ops.topk import masked_topk

    metric = Metric.parse(metric)
    check_fp32_exact(q)
    cand = cand_rows.long()
    safe = torch.clamp(cand, min=0)
    qf = q.float()
    dots = torch.einsum("brd,bd->br", vecs, qf)
    qq = (qf * qf).sum(dim=-1)
    if metric == Metric.L2:
        scores = -torch.clamp(qq[:, None] - 2.0 * dots + sqnorm[safe], min=0.0)
    elif metric == Metric.INNER_PRODUCT:
        scores = dots
    else:  # COSINE
        xn = torch.sqrt(torch.clamp(sqnorm[safe], min=1e-24))
        scores = dots / torch.clamp(torch.sqrt(qq)[:, None] * xn, min=1e-12)
    vals, sel = masked_topk(scores, cand >= 0, k)
    rows = torch.gather(cand, 1, sel.long().clamp(min=0))
    return vals, torch.where(sel >= 0, rows, -1).int()


def rerank_exact_sq8res(
    codes: torch.Tensor,
    mins: torch.Tensor,
    scales: torch.Tensor,
    crow: torch.Tensor,
    cents: torch.Tensor,
    sqnorm: torch.Tensor,
    q: torch.Tensor,
    cand_rows: torch.Tensor,
    k: int,
    metric: Metric,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``rerank_exact`` off a residual-SQ8 slab: each candidate is
    reconstructed as x̂ = c[crow] + min + scale·code and scored in fp32;
    ``sqnorm`` is ||x̂||² of the same reconstruction.

    codes [N_pad, D] uint8, mins/scales/sqnorm [N_pad] fp32, crow [N_pad]
    int32 cluster of each row, cents [Kp, D] fp32; the rest as
    ``rerank_exact``."""
    safe = torch.clamp(cand_rows.long(), min=0)
    c8 = codes[safe].float()                                 # [B, R, D]
    cc = cents[crow[safe].long()]                            # [B, R, D]
    vecs = cc + mins[safe][..., None] + scales[safe][..., None] * c8
    return _rerank(vecs, sqnorm, q, cand_rows, k, metric)


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize rows (cosine pre-normalization)."""
    n = torch.sqrt((x.float() ** 2).sum(dim=-1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)
