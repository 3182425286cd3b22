"""Latency summary, nearest-rank quantiles (the port's copy of
``pyrope_tpu/utils/stats.py``).

Mirrors the reference harness's summary statistics
(ref: src/Pyrope.Benchmarks/Stats/LatencySummary.cs:16-56 — min/p50/p95/p99/
max/mean via nearest-rank on sorted samples).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class LatencySummary:
    count: int
    min_ms: float
    p50_ms: float
    p95_ms: float
    p99_ms: float
    max_ms: float
    mean_ms: float

    @classmethod
    def from_samples(cls, samples_ms: list[float]) -> "LatencySummary":
        if not samples_ms:
            return cls(0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        s = sorted(samples_ms)
        n = len(s)

        def nearest_rank(p: float) -> float:
            rank = max(1, math.ceil(p / 100.0 * n))
            return s[rank - 1]

        return cls(
            count=n,
            min_ms=s[0],
            p50_ms=nearest_rank(50),
            p95_ms=nearest_rank(95),
            p99_ms=nearest_rank(99),
            max_ms=s[-1],
            mean_ms=sum(s) / n,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
