"""Nearest-rank percentiles (the port's ``utils/stats.LatencySummary``)."""

from __future__ import annotations

import math


def nearest_rank(samples: list[float], p: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[max(1, math.ceil(p / 100.0 * len(s))) - 1]
