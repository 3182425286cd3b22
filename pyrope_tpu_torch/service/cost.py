"""Proxy cost metric.

Rebuild of the reference's ``CostCalculator``
(ref: Vector/CostCalculator.cs:15-32): search cost ≈
``(count / 10_000) * (dim / 128)`` — used for billing, monthly-budget
degradation, and the dynamic L2-cache distance threshold
(ref: VectorCommandSet.cs:913-944).
"""

from __future__ import annotations

import math

from pyrope_tpu_torch.types import IndexStats, Metric


def estimate_search_cost(stats: IndexStats) -> float:
    return (stats.count / 10_000.0) * (stats.dim / 128.0)


def is_cluster_close_enough(score: float, metric: Metric, proxy_cost: float) -> bool:
    """Cost-relaxed L2-cache admission (ref: VectorCommandSet.cs:913-944):
    base thresholds L2 distance² 0.05 / cosine similarity 0.95, relaxed by
    ×(1 + log10(cost + 1)) — expensive indexes accept farther clusters since
    a recompute costs more than a slightly-stale cache hit."""
    relax = 1.0 + math.log10(proxy_cost + 1.0)
    m = Metric.parse(metric)
    if m == Metric.COSINE:
        # score is cosine similarity; higher = closer
        return score >= 1.0 - (1.0 - 0.95) * relax
    # L2 score is -d²; IP treated like L2 on distance-to-centroid
    return -score <= 0.05 * relax
