"""Warm-path metric deltas for the AI sidecar.

Rebuilds of ``SidecarMetricsCalculator`` (ref:
Services/SidecarMetricsCalculator.cs:15-70 — pure delta math: QPS, miss
rate, bucket-boundary P99, CPU utilisation from process time) and
``SystemUsageProvider`` (ref: Services/SystemUsageProvider.cs:6-26).
The async reporter loop that ships these to the sidecar lives in
``server/app.py`` (``SidecarMetricsReporter``, ref:
Services/SidecarMetricsReporter.cs).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

from pyrope_tpu_torch.service.metrics import MetricsSnapshot, estimate_p99_ms


@dataclasses.dataclass(frozen=True)
class UsageSnapshot:
    timestamp: float
    process_cpu_seconds: float


class SystemUsageProvider:
    def get_snapshot(self) -> UsageSnapshot:
        return UsageSnapshot(
            timestamp=time.time(),
            process_cpu_seconds=sum(os.times()[:2]),
        )


@dataclasses.dataclass(frozen=True)
class SystemMetrics:
    """What gets reported per tenant (ref: policy_service.proto:66-75)."""

    qps: float
    cache_miss_rate: float
    p99_latency_ms: float
    cpu_utilization: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SidecarMetricsCalculator:
    """Holds the previous snapshots and computes interval deltas."""

    def __init__(self):
        self._prev_metrics: Optional[MetricsSnapshot] = None
        self._prev_usage: Optional[UsageSnapshot] = None

    def calculate(
        self, metrics: MetricsSnapshot, usage: UsageSnapshot
    ) -> Optional[SystemMetrics]:
        prev_m, prev_u = self._prev_metrics, self._prev_usage
        self._prev_metrics, self._prev_usage = metrics, usage
        if prev_m is None or prev_u is None:
            return None
        dt = usage.timestamp - prev_u.timestamp
        if dt <= 0:
            return None
        d_search = metrics.searches - prev_m.searches
        d_hits = metrics.hits - prev_m.hits
        d_miss = metrics.misses - prev_m.misses
        lookups = d_hits + d_miss
        hist_delta = [a - b for a, b in zip(metrics.histogram, prev_m.histogram)]
        cpu = (usage.process_cpu_seconds - prev_u.process_cpu_seconds) / dt
        return SystemMetrics(
            qps=d_search / dt,
            cache_miss_rate=(d_miss / lookups) if lookups > 0 else 0.0,
            p99_latency_ms=estimate_p99_ms(hist_delta),
            cpu_utilization=min(1.0, max(0.0, cpu)),
        )
