"""Tensor ops of the port: scores, top-k, k-means, slab gathers, and the
fused scan kernels' wrappers."""

from pyrope_tpu_torch.ops.distance import score_convention

__all__ = ["score_convention"]
