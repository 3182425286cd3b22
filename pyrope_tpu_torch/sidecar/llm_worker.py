"""Async LLM request worker with rate/budget guardrails.

Rebuild of the reference's ``llm_worker.py``
(ref: src/Pyrope.AISidecar/llm_worker.py:15-267): a bounded queue
(maxsize 10, fail-fast), rate limits of 60 requests/min and 100k
tokens/min, a 10M-token monthly budget, ≤3 retries, and a stats dict.
Disabled without ``GEMINI_API_KEY`` — always the case in this zero-egress
environment, so the transport is injectable and the guardrail logic is
what's exercised (the reference tests do the same with mocks).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Optional

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

MAX_QUEUE = 10
REQS_PER_MIN = 60
TOKENS_PER_MIN = 100_000
MONTHLY_TOKEN_BUDGET = 10_000_000
MAX_RETRIES = 3


def extract_json(text: "str | None") -> "dict | None":
    """Extract the first {...} JSON object from an LLM reply (shared by the
    policy engine and dispatchers)."""
    import json

    if not text:
        return None
    start, end = text.find("{"), text.rfind("}")
    if start < 0 or end <= start:
        return None
    try:
        obj = json.loads(text[start : end + 1])
    except json.JSONDecodeError:
        return None
    return obj if isinstance(obj, dict) else None


class LLMDisabledError(RuntimeError):
    pass


class LLMBudgetError(RuntimeError):
    pass


class LLMWorker:
    def __init__(
        self,
        transport: Optional[Callable[[str], str]] = None,
        clock: Clock = SYSTEM_CLOCK,
        api_key_env: str = "GEMINI_API_KEY",
    ):
        self._clock = clock
        self._transport = transport
        self.enabled = transport is not None or bool(os.environ.get(api_key_env))
        self._queue: queue.Queue = queue.Queue(maxsize=MAX_QUEUE)
        self._lock = threading.Lock()
        self._minute_key = -1
        self._minute_reqs = 0
        self._minute_tokens = 0
        self._month_key = -1
        self._month_tokens = 0
        self.stats = {
            "submitted": 0, "completed": 0, "failed": 0,
            "rejected_queue": 0, "rejected_rate": 0, "rejected_budget": 0,
            "retries": 0,
        }
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def estimate_tokens(prompt: str) -> int:
        return max(1, len(prompt) // 4)

    def _check_limits(self, tokens: int) -> None:
        now = self._clock.now()
        minute, month = int(now // 60), int(now // (30 * 86400))
        with self._lock:
            if self._minute_key != minute:
                self._minute_key, self._minute_reqs, self._minute_tokens = minute, 0, 0
            if self._month_key != month:
                self._month_key, self._month_tokens = month, 0
            if self._minute_reqs >= REQS_PER_MIN or self._minute_tokens + tokens > TOKENS_PER_MIN:
                self.stats["rejected_rate"] += 1
                raise LLMBudgetError("per-minute rate limit")
            if self._month_tokens + tokens > MONTHLY_TOKEN_BUDGET:
                self.stats["rejected_budget"] += 1
                raise LLMBudgetError("monthly token budget exhausted")
            self._minute_reqs += 1
            self._minute_tokens += tokens
            self._month_tokens += tokens

    def submit(self, prompt: str, callback: Callable[[Optional[str]], None]) -> bool:
        """Fail-fast enqueue; returns False when disabled/over-limit/full."""
        if not self.enabled:
            return False
        try:
            self._check_limits(self.estimate_tokens(prompt))
        except LLMBudgetError:
            return False
        try:
            self._queue.put_nowait((prompt, callback))
        except queue.Full:
            self.stats["rejected_queue"] += 1
            return False
        self.stats["submitted"] += 1
        return True

    def process_one(self) -> bool:
        """Process one queued request (worker-loop body; callable directly
        in tests). Returns False when the queue is empty."""
        try:
            prompt, callback = self._queue.get_nowait()
        except queue.Empty:
            return False
        result: Optional[str] = None
        for attempt in range(MAX_RETRIES):
            try:
                result = self._transport(prompt) if self._transport else None
                break
            except Exception:
                self.stats["retries"] += 1
        if result is None:
            self.stats["failed"] += 1
        else:
            self.stats["completed"] += 1
        try:
            callback(result)
        except Exception:
            pass
        return True

    def start(self) -> None:
        if not self.enabled or self._worker is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if not self.process_one():
                    self._stop.wait(0.05)

        self._worker = threading.Thread(target=loop, daemon=True, name="pyrope-llm")
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2)
            self._worker = None
