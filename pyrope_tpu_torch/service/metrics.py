"""Metrics: counters + latency histogram + Prometheus exposition.

Rebuild of the reference's ``MetricsCollector``
(ref: Services/MetricsCollector.cs): cache hit/miss/eviction(reason)/
ai_fallback counters and a 6-bucket latency histogram with bounds
1/5/10/50/100/200 ms (:39-52), Prometheus text exposition (:54-100) and a
snapshot for the sidecar reporter (:102-116).
"""

from __future__ import annotations

import dataclasses
import threading

BUCKET_BOUNDS_MS = (1.0, 5.0, 10.0, 50.0, 100.0, 200.0)


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    hits: int
    misses: int
    evictions: int
    ai_fallbacks: int
    searches: int
    histogram: tuple[int, ...]  # len(BUCKET_BOUNDS_MS)+1, last = +Inf bucket
    latency_sum_ms: float


class MetricsCollector:
    def __init__(self):
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions: dict[str, int] = {}
        self._ai_fallbacks = 0
        self._searches = 0
        self._hist = [0] * (len(BUCKET_BOUNDS_MS) + 1)
        self._latency_sum_ms = 0.0

    def record_hit(self) -> None:
        with self._lock:
            self._hits += 1

    def record_miss(self) -> None:
        with self._lock:
            self._misses += 1

    def record_eviction(self, reason: str = "ttl") -> None:
        with self._lock:
            self._evictions[reason] = self._evictions.get(reason, 0) + 1

    def record_ai_fallback(self) -> None:
        with self._lock:
            self._ai_fallbacks += 1

    def record_search_latency(self, latency_ms: float) -> None:
        with self._lock:
            self._searches += 1
            self._latency_sum_ms += latency_ms
            for i, bound in enumerate(BUCKET_BOUNDS_MS):
                if latency_ms <= bound:
                    self._hist[i] += 1
                    return
            self._hist[-1] += 1

    def get_snapshot(self) -> MetricsSnapshot:
        with self._lock:
            return MetricsSnapshot(
                hits=self._hits,
                misses=self._misses,
                evictions=sum(self._evictions.values()),
                ai_fallbacks=self._ai_fallbacks,
                searches=self._searches,
                histogram=tuple(self._hist),
                latency_sum_ms=self._latency_sum_ms,
            )

    def to_prometheus(self) -> str:
        """Prometheus text exposition (ref: MetricsCollector.cs:54-100)."""
        s = self.get_snapshot()
        with self._lock:
            evictions = dict(self._evictions)
        lines = [
            "# TYPE pyrope_cache_hits_total counter",
            f"pyrope_cache_hits_total {s.hits}",
            "# TYPE pyrope_cache_misses_total counter",
            f"pyrope_cache_misses_total {s.misses}",
            "# TYPE pyrope_ai_fallback_total counter",
            f"pyrope_ai_fallback_total {s.ai_fallbacks}",
            "# TYPE pyrope_cache_evictions_total counter",
        ]
        if evictions:
            for reason, n in sorted(evictions.items()):
                lines.append(f'pyrope_cache_evictions_total{{reason="{reason}"}} {n}')
        else:
            lines.append("pyrope_cache_evictions_total 0")
        lines.append("# TYPE pyrope_search_latency_ms histogram")
        cum = 0
        for bound, n in zip(BUCKET_BOUNDS_MS, s.histogram):
            cum += n
            lines.append(f'pyrope_search_latency_ms_bucket{{le="{bound:g}"}} {cum}')
        cum += s.histogram[-1]
        lines.append(f'pyrope_search_latency_ms_bucket{{le="+Inf"}} {cum}')
        lines.append(f"pyrope_search_latency_ms_sum {s.latency_sum_ms:.6f}")
        lines.append(f"pyrope_search_latency_ms_count {s.searches}")
        return "\n".join(lines) + "\n"


def estimate_p99_ms(
    hist_delta: "tuple[int, ...] | list[int]",
    bounds_ms: tuple[float, ...] = BUCKET_BOUNDS_MS,
) -> float:
    """P99 estimate from histogram bucket deltas — the monitor's estimator
    (ref: Services/SloGuardrailsMonitor.cs:77-111): walk buckets until 99%
    of samples are covered; report that bucket's upper bound (2× last bound
    for the overflow bucket)."""
    total = sum(hist_delta)
    if total <= 0:
        return 0.0
    target = 0.99 * total
    cum = 0
    for i, n in enumerate(hist_delta):
        cum += n
        if cum >= target:
            return bounds_ms[i] if i < len(bounds_ms) else bounds_ms[-1] * 2
    return bounds_ms[-1] * 2
