"""Tensor ops of the port: scores, top-k, k-means, slab gathers, and the
fused scan kernels' wrappers."""

from pyrope_tpu_torch.ops.distance import normalize_rows, score_convention, score_matrix
from pyrope_tpu_torch.ops.topk import masked_topk, merge_topk, parse_selection

__all__ = [
    "score_matrix",
    "score_convention",
    "normalize_rows",
    "masked_topk",
    "merge_topk",
    "parse_selection",
]


def __getattr__(name):
    # the heavier op modules load on first use, as the JAX package's do
    lazy = {
        "kmeans_train": "pyrope_tpu_torch.ops.kmeans",
        "kmeans_assign": "pyrope_tpu_torch.ops.kmeans",
        "ProductQuantizer": "pyrope_tpu_torch.ops.pq",
        "adc_l2_table": "pyrope_tpu_torch.ops.pq",
        "adc_ip_table": "pyrope_tpu_torch.ops.pq",
        "adc_accumulate": "pyrope_tpu_torch.ops.pq",
        "fused_flat_topk": "pyrope_tpu_torch.ops.fused_scan",
    }
    if name in lazy:
        import importlib

        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
