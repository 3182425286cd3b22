"""IVF-SQ8 (residual SQ8)'s rows as the configuration scores them: each row
coded against the centroid of the list that holds it and decoded again.

The code, worked out here from the corpus and the centroid: r = x - c in
fp32; per row, min = min(r), scale = max(max(r) - min, 1e-12) / 255, code =
round((r - min) / scale) clamped to [0, 255]; the row scored is
x̂ = c + min + scale·code (in float64 here). The steps are the elementwise
fp32 operations that the configuration's encoding states, so they give the
program's codes bit for bit wherever the row sits in the same list.
"""

from __future__ import annotations

import torch

from core.ivf_judge import Judge


def rows_under(x32: torch.Tensor, c32: torch.Tensor, rows: torch.Tensor,
               lists: torch.Tensor) -> torch.Tensor:
    c = c32[lists]
    r = x32[rows] - c
    mn = r.amin(dim=-1)
    scale = torch.clamp(r.amax(dim=-1) - mn, min=1e-12) / 255.0
    code = torch.clamp(torch.round((r - mn[..., None]) / scale[..., None]), 0.0, 255.0)
    return c.double() + mn.double()[..., None] + scale.double()[..., None] * code.double()


def make_judge(x32: torch.Tensor, state: dict, pool: torch.Tensor, traffic: dict) -> Judge:
    """The reference for this index's state (its centroids) and query pool."""
    return Judge(x32, state["centroids"], pool, traffic["nprobe"], traffic["k"], rows_under)
