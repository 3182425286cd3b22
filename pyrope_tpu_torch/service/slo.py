"""SLO guardrails: degradation with hysteresis + noisy-neighbor shedding.

Rebuild of the reference's ``SloGuardrails`` + ``SloGuardrailsMonitor``
(ref: Services/SloGuardrails.cs:25-87, SloGuardrailsOptions.cs:3-31,
SloGuardrailsMonitor.cs:31-111):

- degraded flag with hysteresis: enter when P99 > target (default 50 ms),
  exit when P99 ≤ target × exit_ratio (0.8);
- while degraded, priority ≥ 1 tenants get ``max_scans = degraded_max_scans``
  (5000) and priority ≥ 2 tenants are shed to cache-only;
- the monitor periodically estimates P99 from metrics-histogram bucket
  deltas with a minimum-sample gate.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from pyrope_tpu_torch.service.metrics import MetricsCollector, estimate_p99_ms
from pyrope_tpu_torch.types import SearchOptions


@dataclasses.dataclass
class SloGuardrailsOptions:
    enabled: bool = True
    target_p99_ms: float = 50.0
    exit_ratio: float = 0.8
    degraded_max_scans: int = 5000
    min_samples: int = 20
    check_interval_s: float = 5.0


class SloGuardrails:
    def __init__(self, options: Optional[SloGuardrailsOptions] = None):
        self.options = options or SloGuardrailsOptions()
        self._lock = threading.Lock()
        self._degraded = False
        self._last_p99_ms = 0.0

    @property
    def is_degraded(self) -> bool:
        return self._degraded

    @property
    def last_p99_ms(self) -> float:
        return self._last_p99_ms

    def observe_p99(self, p99_ms: float) -> bool:
        """Feed a P99 sample; returns the (possibly updated) degraded flag."""
        opt = self.options
        with self._lock:
            self._last_p99_ms = p99_ms
            if not opt.enabled:
                self._degraded = False
            elif not self._degraded and p99_ms > opt.target_p99_ms:
                self._degraded = True
            elif self._degraded and p99_ms <= opt.target_p99_ms * opt.exit_ratio:
                self._degraded = False
            return self._degraded

    def get_search_options(
        self, base: SearchOptions, tenant_priority: int
    ) -> SearchOptions:
        """While degraded, cap max_scans for normal/low-priority tenants
        (ref: SloGuardrails.cs:58-74). High-priority (0) is untouched."""
        if not self._degraded or tenant_priority < 1:
            return base
        cap = self.options.degraded_max_scans
        ms = cap if base.max_scans is None else min(base.max_scans, cap)
        return dataclasses.replace(base, max_scans=ms)

    def should_force_cache_only(self, tenant_priority: int) -> bool:
        """Low-priority (≥2) tenants are shed to cache-only while degraded
        (ref: SloGuardrails.cs:76-87)."""
        return self._degraded and tenant_priority >= 2


class SloMonitor:
    """Histogram-delta P99 estimator feeding the guardrails.

    The reference runs this as a BackgroundService every 5 s; here ``tick()``
    is called by the server's periodic task (or manually in tests).
    """

    def __init__(self, metrics: MetricsCollector, guardrails: SloGuardrails):
        self._metrics = metrics
        self._guardrails = guardrails
        self._prev_hist: Optional[tuple[int, ...]] = None

    def tick(self) -> Optional[float]:
        """Returns the estimated P99 (ms) or None if below the sample gate."""
        snap = self._metrics.get_snapshot()
        prev = self._prev_hist or tuple([0] * len(snap.histogram))
        delta = [a - b for a, b in zip(snap.histogram, prev)]
        self._prev_hist = snap.histogram
        if sum(delta) < self._guardrails.options.min_samples:
            return None
        p99 = estimate_p99_ms(delta)
        self._guardrails.observe_p99(p99)
        return p99
