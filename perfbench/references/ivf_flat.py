"""IVF-Flat's rows as the configuration scores them: the fp32 rows
themselves, whichever list holds them (L2 in float64 by ``core.ivf_judge``)."""

from __future__ import annotations

import torch

from core.ivf_judge import Judge


def rows_under(x32: torch.Tensor, c32: torch.Tensor, rows: torch.Tensor,
               lists: torch.Tensor) -> torch.Tensor:
    return x32[rows].double()


def make_judge(x32: torch.Tensor, state: dict, pool: torch.Tensor, traffic: dict) -> Judge:
    """The reference for this index's state (its centroids) and query pool."""
    return Judge(x32, state["centroids"], pool, traffic["nprobe"], traffic["k"], rows_under)
