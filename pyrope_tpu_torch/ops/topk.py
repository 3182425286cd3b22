"""Top-k selection and merge (port of ``pyrope_tpu/ops/topk.py``).

Order is part of the contract: the JAX package orders hits by (score desc,
lower index first), because ``lax.top_k`` breaks ties by position and its
Pallas kernels use the same rule. ``torch.topk`` promises no tie order
(``torch.topk(torch.tensor([[1., 3., 3., 2., 3.]]), 3).indices`` may come
back as [2, 4, 1] where JAX gives [1, 2, 4]), so every selection here goes
through ``stable_topk``: a stable descending sort on an integer key in the
IEEE total order, which ``lax.top_k`` also uses (+0 ranks above -0), so
ties keep position order.

``selection="approx[:recall]"`` maps to exact top-k: ``lax.approx_max_k`` is
a TPU PartialReduce primitive with no torch counterpart, and exact is a
valid answer at any recall target.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float("-inf")


def parse_selection(selection: str) -> tuple[str, float]:
    """'exact' | 'pallas' | 'approx[:<recall>]' | 'hybrid[:<R>]'
    -> (mode, param), as in the JAX package. 'pallas' names the fused
    scan kernel (here the CUDA kernel of ops/fused_scan.py)."""
    if selection in ("exact", "pallas"):
        return selection, 1.0
    if selection.startswith("approx"):
        _, _, rt = selection.partition(":")
        return "approx", float(rt) if rt else 0.95
    if selection.startswith("hybrid"):
        _, _, r = selection.partition(":")
        return "hybrid", float(r) if r else 0.0
    raise ValueError(
        f"selection must be exact|pallas|approx[:recall]|hybrid[:R], got {selection!r}"
    )


def stable_topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of float32 ``scores`` along the last dim, in ``lax.top_k``'s
    order: the IEEE total order (+0 above -0, NaN above +inf), ties by
    lower index. Returns (values, int64 indices), sorted descending; ``k``
    must not exceed the last dim."""
    bits = scores.float().contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)  # int order == IEEE total order
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(scores, -1, idx), idx


def masked_topk(
    scores: torch.Tensor,
    mask: torch.Tensor | None,
    k: int,
    selection: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of scores[b, n] over valid columns.

    mask: [N] or [B, N] bool, True = live; masked entries score -inf.
    Returns (values [B, k], int32 indices [B, k]) sorted descending, with
    -inf/-1 for missing hits (k > live columns)."""
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    parse_selection(selection)  # validate; every mode selects exactly here
    vals, idx = stable_topk(scores, min(k, scores.shape[-1]))
    if vals.shape[-1] < k:  # fewer columns than k: pad with missing hits
        pad = k - vals.shape[-1]
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
    idx = torch.where(torch.isfinite(vals), idx, -1)
    return vals, idx.int()


def merge_topk(
    vals_a: torch.Tensor,
    idx_a: torch.Tensor,
    vals_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k candidate sets (ids in a shared id space);
    ties keep set a's entries first, as the JAX merge does."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a.long(), idx_b.long()], dim=-1)
    mvals, pos = stable_topk(vals, min(k, vals.shape[-1]))
    midx = torch.gather(idx, -1, pos)
    midx = torch.where(torch.isfinite(mvals), midx, -1)
    return mvals, midx.int()


def chunked_exact_topk(
    x: torch.Tensor,
    sqnorm: torch.Tensor,
    alive: torch.Tensor,
    q: torch.Tensor,
    k: int,
    metric,
    chunk_rows: int = 1 << 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k over a device slab, chunked over corpus rows so no
    [B, N] score matrix is held. Returns HOST (values [B, k], int64 slab
    rows [B, k]) sorted descending; -inf/-1 mark missing hits. Independent
    of the fused kernel (plain matmul + stable selection), so it can serve
    as its cross-check."""
    from pyrope_tpu_torch.types import Metric
    from pyrope_tpu_torch.ops.distance import score_matrix

    metric = Metric.parse(metric)
    n = x.shape[0]
    b = q.shape[0]
    best_v = np.full((b, k), -np.inf, np.float32)
    best_i = np.full((b, k), -1, np.int64)
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        scores = score_matrix(q, x[s:e], metric, x_sqnorm=sqnorm[s:e])
        vals, idx = masked_topk(scores, alive[None, s:e], min(k, e - s))
        vals = vals.cpu().numpy()
        idx = idx.cpu().numpy().astype(np.int64)
        idx = np.where(idx >= 0, idx + s, -1)
        cand_v = np.concatenate([best_v, vals], axis=1)
        cand_i = np.concatenate([best_i, idx], axis=1)
        order = np.argsort(-cand_v, axis=1, kind="stable")[:, :k]
        best_v = np.take_along_axis(cand_v, order, axis=1)
        best_i = np.take_along_axis(cand_i, order, axis=1)
    return best_v, best_i
