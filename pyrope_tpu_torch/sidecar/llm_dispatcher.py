"""LLM-driven prefetch dispatch + TTL advice.

Rebuilds of the reference's ``LLMPrefetchDispatcher`` (LLM JSON → prefetch
callback when confidence > 0.5, ref: src/Pyrope.AISidecar/llm_dispatcher.py:
15-51) and ``LLMTTLAdvisor`` (shorten/evict overrides per cluster,
ref: llm_dispatcher.py:54-117).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from pyrope_tpu_torch.sidecar.llm_worker import LLMWorker, extract_json as _extract_json
from pyrope_tpu_torch.sidecar.prompts import PREFETCH_PREDICTION_PROMPT, TTL_ADVICE_PROMPT

MIN_CONFIDENCE = 0.5


class LLMPrefetchDispatcher:
    def __init__(
        self,
        worker: LLMWorker,
        on_prefetch: Callable[[str, str, int], None],
    ):
        self.worker = worker
        self.on_prefetch = on_prefetch

    def request_prediction(self, tenant: str, index: str, sequence: list[int]) -> bool:
        prompt = PREFETCH_PREDICTION_PROMPT.format(
            tenant=tenant, index=index, sequence=sequence
        )

        def on_reply(text: Optional[str]):
            obj = _extract_json(text)
            if not obj:
                return
            try:
                conf = float(obj.get("confidence", 0.0))
                nxt = int(obj["next_cluster"])
            except (KeyError, TypeError, ValueError):
                return
            if conf > MIN_CONFIDENCE:
                self.on_prefetch(tenant, index, nxt)

        return self.worker.submit(prompt, on_reply)


class LLMTTLAdvisor:
    def __init__(self, worker: LLMWorker):
        self.worker = worker
        self._lock = threading.Lock()
        # (index, cluster) -> override dict {"action", "ttl_seconds"}
        self._overrides: dict[tuple[str, int], dict] = {}

    def request_advice(
        self, index: str, cluster_id: int, writes_per_min: float, ttl_seconds: float
    ) -> bool:
        prompt = TTL_ADVICE_PROMPT.format(
            cluster_id=cluster_id, index=index,
            writes_per_min=writes_per_min, ttl_seconds=ttl_seconds,
        )

        def on_reply(text: Optional[str]):
            obj = _extract_json(text)
            if not obj or obj.get("action") not in ("keep", "shorten", "evict"):
                return
            with self._lock:
                self._overrides[(index, cluster_id)] = {
                    "action": obj["action"],
                    "ttl_seconds": int(obj.get("ttl_seconds", ttl_seconds)),
                }

        return self.worker.submit(prompt, on_reply)

    def get_override(self, index: str, cluster_id: int) -> Optional[dict]:
        with self._lock:
            return self._overrides.get((index, cluster_id))
