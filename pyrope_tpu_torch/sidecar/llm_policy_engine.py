"""Non-blocking LLM policy engine with heuristic fallback.

Rebuild of the reference's ``LLMPolicyEngine``
(ref: src/Pyrope.AISidecar/llm_policy_engine.py:35-240): builds a
goal-oriented prompt, parses + clamps the JSON reply (ttl 30–3600,
admission 0–1, eviction 0–2), caches decisions bucketed by quantized
metrics, dedups in-flight prompts, and — critically — **never blocks the
warm path**: ``compute_policy`` returns the heuristic (or a cached LLM
decision) immediately and installs the LLM result via callback for the
next call.
"""

from __future__ import annotations

import threading
from typing import Optional

from pyrope_tpu_torch.sidecar.llm_worker import LLMWorker
from pyrope_tpu_torch.sidecar.policy_engine import HeuristicPolicyEngine
from pyrope_tpu_torch.sidecar.prompts import POLICY_PROMPT

TTL_MIN, TTL_MAX = 30, 3600


def clamp_policy(raw: dict) -> dict:
    return {
        "admission_threshold": min(1.0, max(0.0, float(raw.get("admission_threshold", 0.1)))),
        "ttl_seconds": min(TTL_MAX, max(TTL_MIN, int(raw.get("ttl_seconds", 60)))),
        "eviction_priority": min(2, max(0, int(raw.get("eviction_priority", 0)))),
    }


def parse_llm_reply(text: str) -> Optional[dict]:
    """Extract + clamp the JSON object from an LLM reply."""
    from pyrope_tpu_torch.sidecar.llm_worker import extract_json

    obj = extract_json(text)
    if obj is None:
        return None
    try:
        return clamp_policy(obj)
    except (TypeError, ValueError):
        return None


def _bucket(metrics: dict) -> tuple:
    """Quantize metrics so near-identical states share a cached decision
    (ref: decision cache bucketing)."""
    return (
        round(float(metrics.get("qps", 0.0)) / 50.0),
        round(float(metrics.get("cache_miss_rate", 0.0)) * 10),
        round(float(metrics.get("p99_latency_ms", 0.0)) / 25.0),
        round(float(metrics.get("cpu_utilization", 0.0)) * 10),
    )


class LLMPolicyEngine:
    CACHE_TTL_S = 300.0
    CACHE_MAX = 512

    def __init__(self, worker: Optional[LLMWorker] = None, target_p99_ms: float = 50.0):
        self.worker = worker or LLMWorker()
        self.worker.start()  # no-op when disabled; consumer thread otherwise
        self.heuristic = HeuristicPolicyEngine()
        self.target_p99_ms = target_p99_ms
        self._lock = threading.Lock()
        self._cache: dict[tuple, tuple[dict, float]] = {}  # bucket -> (policy, ts)
        self._inflight: set[tuple] = set()
        self.stats = {"cache_hits": 0, "heuristic_fallbacks": 0, "llm_decisions": 0}

    def compute_policy(self, tenant: str, metrics: dict) -> dict:
        import time as _time

        bucket = _bucket(metrics)
        now = _time.monotonic()
        with self._lock:
            cached = self._cache.get(bucket)
            if cached is not None:
                policy, ts = cached
                if now - ts < self.CACHE_TTL_S:
                    self.stats["cache_hits"] += 1
                    return dict(policy)
                del self._cache[bucket]  # stale decision: re-consult
            launch = self.worker.enabled and bucket not in self._inflight
            if launch:
                self._inflight.add(bucket)
        if launch:
            prompt = POLICY_PROMPT.format(
                target_p99_ms=self.target_p99_ms,
                tenant=tenant,
                qps=float(metrics.get("qps", 0.0)),
                miss_rate=float(metrics.get("cache_miss_rate", 0.0)),
                p99_ms=float(metrics.get("p99_latency_ms", 0.0)),
                cpu=float(metrics.get("cpu_utilization", 0.0)),
            )

            def on_reply(text: Optional[str], _bucket=bucket):
                policy = parse_llm_reply(text) if text else None
                with self._lock:
                    self._inflight.discard(_bucket)
                    if policy is not None:
                        if len(self._cache) >= self.CACHE_MAX:
                            self._cache.clear()
                        self._cache[_bucket] = (policy, _time.monotonic())
                        self.stats["llm_decisions"] += 1

            if not self.worker.submit(prompt, on_reply):
                with self._lock:
                    self._inflight.discard(bucket)
        # non-blocking: heuristic NOW, LLM result next time
        self.stats["heuristic_fallbacks"] += 1
        return self.heuristic.compute_policy(metrics)
