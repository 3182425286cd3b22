"""Heuristic warm-path policy.

Rebuild of the reference's ``HeuristicPolicyEngine``
(ref: src/Pyrope.AISidecar/policy_engine.py:12-25): when the cache miss
rate exceeds 0.5, go aggressive — lower the admission threshold to 0.05,
stretch TTL to 300 s, raise eviction priority; otherwise the defaults
(0.1 / 60 s / 0).
"""

from __future__ import annotations

AGGRESSIVE = {"admission_threshold": 0.05, "ttl_seconds": 300, "eviction_priority": 1}
DEFAULT = {"admission_threshold": 0.1, "ttl_seconds": 60, "eviction_priority": 0}


class HeuristicPolicyEngine:
    MISS_RATE_THRESHOLD = 0.5

    def compute_policy(self, metrics: dict) -> dict:
        if float(metrics.get("cache_miss_rate", 0.0)) > self.MISS_RATE_THRESHOLD:
            return dict(AGGRESSIVE)
        return dict(DEFAULT)
