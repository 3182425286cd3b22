"""Predictive prefetch: Markov-rule cache warming.

Rebuilds of:
- ``PredictivePrefetcher`` (ref: Services/PredictivePrefetcher.cs): records
  (tenant, index, cluster, ts) interactions into a bounded queue (:60-75),
  answers ``get_prediction`` O(1) from a rules cache (:77-91); a background
  loop flushes ≤100 interactions per tick to the sidecar's
  ``ReportClusterAccess`` and refreshes ``GetPrefetchRules`` every 60 s
  (:93-142).
- ``PrefetchBackgroundQueue`` (ref: Services/PrefetchBackgroundQueue.cs:
  15-77): a bounded(1024) drop-on-full work queue whose worker runs
  prefetch searches (search the predicted cluster's centroid, stuff the
  result cache) off the hot path.

The sidecar client is injected as a small protocol so tests use fakes
(mirroring the reference's fake-gRPC-client tests,
ref: Services/PredictivePrefetcherTests.cs).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional, Protocol

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


class PolicyClient(Protocol):
    """Subset of the sidecar surface the prefetcher needs
    (ref: policy_service.proto ReportClusterAccess / GetPrefetchRules)."""

    def report_cluster_access(self, events: list[dict]) -> None: ...

    def get_prefetch_rules(self) -> list[dict]: ...


class PredictivePrefetcher:
    MAX_FLUSH_PER_TICK = 100
    RULES_REFRESH_S = 60.0

    def __init__(
        self,
        client: Optional[PolicyClient] = None,
        clock: Clock = SYSTEM_CLOCK,
        max_pending: int = 4096,
    ):
        self._client = client
        self._clock = clock
        self._pending: queue.Queue[dict] = queue.Queue(maxsize=max_pending)
        # (tenant, index, from_cluster) -> to_cluster
        self._rules: dict[tuple[str, str, int], int] = {}
        self._rules_refreshed_at = 0.0
        self._lock = threading.Lock()

    def record_interaction(self, tenant: str, index: str, cluster_id: int) -> None:
        try:
            self._pending.put_nowait(
                {
                    "tenant_id": tenant,
                    "index_name": index,
                    "cluster_id": int(cluster_id),
                    "timestamp": self._clock.now(),
                }
            )
        except queue.Full:
            pass  # drop-on-full, matching the reference's DropWrite channel

    def get_prediction(self, tenant: str, index: str, cluster_id: int) -> Optional[int]:
        with self._lock:
            return self._rules.get((tenant, index, int(cluster_id)))

    def tick(self) -> int:
        """One background-loop iteration: flush pending interactions and
        (rate-limited) refresh the rules cache. Returns events flushed."""
        if self._client is None:
            return 0
        events: list[dict] = []
        while len(events) < self.MAX_FLUSH_PER_TICK:
            try:
                events.append(self._pending.get_nowait())
            except queue.Empty:
                break
        if events:
            try:
                self._client.report_cluster_access(events)
            except Exception:
                pass  # sidecar unreachable: drop, never block the data plane
        now = self._clock.now()
        if now - self._rules_refreshed_at >= self.RULES_REFRESH_S:
            self._rules_refreshed_at = now
            try:
                rules = self._client.get_prefetch_rules()
            except Exception:
                rules = None
            if rules is not None:
                new = {}
                for r in rules:
                    new[
                        (r["tenant_id"], r["index_name"], int(r["from_cluster"]))
                    ] = int(r["to_cluster"])
                with self._lock:
                    self._rules = new
        return len(events)

    def set_rules_for_test(self, rules: dict[tuple[str, str, int], int]) -> None:
        with self._lock:
            self._rules = dict(rules)


class PrefetchBackgroundQueue:
    """Bounded async work queue; drops when full (never blocks the hot path)."""

    def __init__(self, capacity: int = 1024):
        self._q: queue.Queue[Callable[[], None]] = queue.Queue(maxsize=capacity)
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.dropped = 0
        self.executed = 0

    def try_enqueue(self, work: Callable[[], None]) -> bool:
        try:
            self._q.put_nowait(work)
            return True
        except queue.Full:
            self.dropped += 1
            return False

    def run_pending(self, max_items: int = 64) -> int:
        """Drain synchronously (used by tests and by the server's executor)."""
        n = 0
        while n < max_items:
            try:
                work = self._q.get_nowait()
            except queue.Empty:
                break
            try:
                work()
            except Exception:
                pass  # prefetch work is best-effort
            self.executed += 1
            n += 1
        return n

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    work = self._q.get(timeout=0.1)
                except queue.Empty:
                    continue
                try:
                    work()
                except Exception:
                    pass
                self.executed += 1

        self._worker = threading.Thread(target=loop, daemon=True, name="pyrope-prefetch")
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=2.0)
            self._worker = None
