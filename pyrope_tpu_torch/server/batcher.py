"""Micro-batching query scheduler.

The port's copy of ``pyrope_tpu/server/batcher.py``. A runtime component
with no reference analog: the reference serves each RESP query with its
own CPU scan (concurrency = thread pool, ref: Extensions/VectorCommandSet.cs
one command per connection). On the card a one-query scan launches the
same kernels as a batch and reads the same slab once: every launch pays
the host's per-call work (the list scan's setup, the launches themselves)
and one device→host read of the hits.

The batcher turns concurrent single-query requests into one [B, N] device
batch: the first arrival for a (index, top_k, options) key becomes the
**leader**, waits up to ``max_wait_ms`` for followers (or until
``max_batch`` fills, which notifies the leader immediately), then executes
one ``index.search_batch`` for the group and distributes the per-query
results. Callers with an already-batched [B, D] workload should call
``index.search_batch`` directly — ``search`` takes exactly one query.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from pyrope_tpu_torch.types import DEFAULT_SEARCH_OPTIONS, SearchOptions, SearchResult


@dataclasses.dataclass
class BatcherStats:
    batches: int = 0
    queries: int = 0
    max_batch_seen: int = 0

    @property
    def avg_batch(self) -> float:
        return self.queries / self.batches if self.batches else 0.0


class BatchError(RuntimeError):
    """Wraps a batch-execution failure for each rider (re-raising one shared
    exception instance from many threads races on its __traceback__)."""


class _Group:
    __slots__ = ("queries", "results", "error", "done", "closed", "full")

    def __init__(self):
        self.queries: list[np.ndarray] = []
        self.results: Optional[list[list[SearchResult]]] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.closed = False
        self.full = threading.Event()  # set when max_batch fills


class MicroBatcher:
    def __init__(self, max_batch: int = 64, max_wait_ms: float = 0.5,
                 max_inflight: int = 2, linger_ms: float = 0.0):
        """``max_inflight`` bounds concurrent device batches (0 = no gate).
        The gate is what makes coalescing track device pressure: a leader
        acquires a slot BEFORE closing its group, so while the device is
        busy with earlier batches, the open group keeps absorbing arrivals
        instead of spawning contending single-query dispatches. With a
        ~30 ms-per-round-trip link (or any saturated chip) this is the
        difference between avg_batch ~1 and avg_batch ~max_batch at high
        concurrency; 2 keeps the dispatch pipeline non-empty while the
        previous batch executes.

        ``linger_ms`` is a post-acquire hold: after winning a device slot
        the leader waits up to this long (early-exit when ``max_batch``
        fills) before closing. Closed-loop serving ping-pongs otherwise —
        the cohort whose batch just completed re-sends while the next group
        dispatches without it, so avg_batch locks at ~half the offered
        concurrency (measured: 32 of 64). The linger gives the finishing
        cohort one response-turnaround to merge in. Use on high-RTT links
        (~30 ms); keep 0 when co-located — it taxes every batch.
        The hold only runs when a slot was actually acquired: after the
        gate-timeout escape hatch (wedged device) or with no gate at all
        there is no device-pressure signal, and lingering would only delay
        the emergency dispatch / tax every batch."""
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.linger_s = linger_ms / 1000.0
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Group] = {}
        self._gate = (
            threading.BoundedSemaphore(max_inflight) if max_inflight else None
        )
        # a wedged device batch must not stall the whole serving plane: a
        # leader that cannot get a slot within this window dispatches
        # ungated (pre-gate behavior — only the wedged batch's riders hang)
        self.gate_timeout_s = 5.0
        self.stats = BatcherStats()

    @staticmethod
    def _key(index, top_k: int, options: SearchOptions) -> tuple:
        return (id(index), top_k, options)

    def search(
        self,
        index,
        query: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[SearchResult]:
        """One logical query; may ride a shared device batch."""
        q = np.asarray(query, np.float32)
        if q.ndim != 1:
            raise ValueError(
                f"search() takes one query vector, got shape {q.shape}; "
                "use index.search_batch for pre-batched workloads"
            )
        key = self._key(index, top_k, options)
        with self._lock:
            group = self._groups.get(key)
            if group is None or group.closed:
                group = _Group()
                self._groups[key] = group
                leader = True
            else:
                leader = False
            slot = len(group.queries)
            group.queries.append(q)
            if slot + 1 >= self.max_batch:
                group.closed = True
                self._groups.pop(key, None)
                group.full.set()  # wake the leader immediately

        if leader:
            if not group.closed:
                # wait for followers; a full group wakes us without polling
                group.full.wait(self.max_wait_s)
            # acquire a device slot BEFORE closing: while earlier batches
            # hold the gate, this group stays open and keeps absorbing
            # arrivals (it may fill and close via the max_batch path, which
            # is fine — the queries list only ever grows until closed).
            # Bounded wait: on timeout (slots wedged) dispatch ungated.
            holds_slot = (
                self._gate.acquire(timeout=self.gate_timeout_s)
                if self._gate is not None else False
            )
            if self.linger_s and holds_slot and not group.closed:
                # POST-ACQUIRE hold: let the cohort that just got its
                # responses re-send and join (early-exit when full).
                # Gated on holds_slot: after the gate-timeout escape hatch
                # (wedged device) or in ungated configs there was no
                # acquire, and lingering would only delay the emergency
                # dispatch / tax every batch
                group.full.wait(self.linger_s)
            try:
                with self._lock:
                    if not group.closed:
                        group.closed = True
                        if self._groups.get(key) is group:
                            self._groups.pop(key)
                batch = np.stack(group.queries)
                group.results = index.search_batch(batch, top_k, options)
                with self._lock:
                    self.stats.batches += 1
                    self.stats.queries += len(batch)
                    self.stats.max_batch_seen = max(
                        self.stats.max_batch_seen, len(batch)
                    )
            except BaseException as e:  # propagate to every rider
                group.error = e
            finally:
                if holds_slot:
                    self._gate.release()
                group.done.set()
        else:
            group.done.wait()

        if group.error is not None:
            raise BatchError(str(group.error)) from group.error
        return group.results[slot]

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "batches": self.stats.batches,
                "queries": self.stats.queries,
                "avg_batch": round(self.stats.avg_batch, 2),
                "max_batch_seen": self.stats.max_batch_seen,
            }


class _WriteGroup:
    __slots__ = ("reqs", "upserts", "spans", "closed")

    def __init__(self):
        self.reqs: list = []
        self.upserts: list[bool] = []
        # (start, count, future) per submitter: a pipelined burst is ONE
        # span/future for its whole row slice, not a future per row
        self.spans: list = []
        self.closed = False


class AsyncWriteCoalescer:
    """Event-loop write coalescing: concurrent per-row VEC.ADD/VEC.UPSERT
    requests for the same (tenant, index, api_key) share ONE
    engine.write_batch pass (one quota lease / auth / epoch bump / batched
    write-heat probe; per-row results).

    Absorption has two mechanisms, both with NO fixed wait window:

    1. MicroBatcher-style gate contention: while an earlier batch holds the
       execution gate (running in the executor), the open group keeps
       absorbing arrivals from other connections' dispatch coroutines.
    2. Leader drain rounds: a leader that acquires the gate UNCONTENDED
       yields to the event loop twice (``asyncio.sleep(0)``) before closing
       its group. Without this no coalescing ever happens in the inline
       regime: executing on the loop blocks every other connection's read
       callback, so followers could never interleave between batches
       (measured max_batch_seen == 1 under 4 concurrent writers). The
       drain rounds let the selector deliver already-queued socket data,
       whose handlers join the still-open group — steady-state batch size
       ≈ writer concurrency, while a solo write pays only two no-op yields.

    A pipelined connection's burst arrives as ONE ``submit_many`` call (the
    RESP handler parses every buffered write before submitting): one span +
    one future for the whole slice — per-row futures/tasks measurably
    dominated per-op cost at pipeline depth 64+.

    Engine execution stays inline on the event loop below
    ``inline_max`` rows (~19 us/row of host work beats a thread hop);
    larger groups go to the default executor so a bulk burst cannot stall
    concurrent searches for milliseconds.
    """

    def __init__(self, engine, max_batch: int = 256, inline_max: int = 16):
        import asyncio

        self.engine = engine
        self.max_batch = max_batch
        self.inline_max = inline_max
        self._groups: dict[tuple, _WriteGroup] = {}
        self._gate = asyncio.Lock()
        self.stats = BatcherStats()

    async def submit(self, req, upsert: bool):
        """One logical write; may ride a shared engine pass. ``req`` is a
        parsed WriteRequest (server/parser.py)."""
        return (await self.submit_many([req], [upsert]))[0]

    async def submit_many(self, reqs, upserts):
        """A burst of writes sharing one (tenant, index, api_key) —
        returns their WriteResponses in order. The burst joins the open
        group as a single span (one future)."""
        import asyncio

        from pyrope_tpu_torch.security import SessionAuthContext
        from pyrope_tpu_torch.service import VectorRecord

        r0 = reqs[0]
        # Session identity MUST be part of the group key: write_batch runs
        # ONE _authenticate in the leader's task context, and _authenticate
        # trusts SessionAuthContext (a per-connection contextvar). Without
        # it, an unauthenticated connection's api_key=None write coalesced
        # under a session-AUTH'd leader would be accepted on the leader's
        # credentials (and a session-auth'd follower under an unauth'd
        # leader spuriously rejected).
        key = (r0.tenant, r0.index, r0.api_key, SessionAuthContext.get_tenant())
        group = self._groups.get(key)
        leader = group is None or group.closed
        if leader:
            group = _WriteGroup()
            self._groups[key] = group
        start = len(group.reqs)
        group.reqs.extend(reqs)
        group.upserts.extend(upserts)
        fut = asyncio.get_running_loop().create_future()
        group.spans.append((start, len(reqs), fut))
        if len(group.reqs) >= self.max_batch:
            group.closed = True
            self._groups.pop(key, None)

        if leader:
            # The whole leader section is fail-safe: ANY exit — gate-wait
            # cancellation, record-build failure, engine error — must
            # resolve every undone span future, or the follower
            # connections' writes hang forever. Cancellation is re-raised
            # (never swallowed into a BatchError) so task cancellation
            # still propagates to the leader's own coroutine.
            try:
                async with self._gate:  # absorption window = prior batch
                    # drain rounds (docstring #2): let the loop deliver
                    # queued socket reads so concurrent writers join this
                    # group before it closes; no-op when the gate wait
                    # already absorbed them
                    for _ in range(2):
                        if group.closed:
                            break
                        await asyncio.sleep(0)
                    if not group.closed:
                        group.closed = True
                        if self._groups.get(key) is group:
                            self._groups.pop(key)
                    records = [
                        VectorRecord(id=r.id, vector=r.vector, meta=r.meta,
                                     tags=tuple(r.tags),
                                     numeric_fields=r.numeric_fields)
                        for r in group.reqs
                    ]
                    if len(records) <= self.inline_max:
                        results = self.engine.write_batch(
                            r0.tenant, r0.index, records, group.upserts,
                            api_key=r0.api_key,
                        )
                    else:
                        results = await asyncio.to_thread(
                            self.engine.write_batch,
                            r0.tenant, r0.index, records, group.upserts,
                            api_key=r0.api_key,
                        )
                    self.stats.batches += 1
                    self.stats.queries += len(records)
                    self.stats.max_batch_seen = max(
                        self.stats.max_batch_seen, len(records)
                    )
                    for s, c, f in group.spans:
                        if not f.done():
                            f.set_result(results[s : s + c])
            except BaseException as e:
                group.closed = True
                if self._groups.get(key) is group:
                    self._groups.pop(key)
                for _, _, f in group.spans:
                    if not f.done():
                        f.set_exception(BatchError(str(e)))
                if isinstance(e, asyncio.CancelledError):
                    # mark the leader's own failed future retrieved before
                    # re-raising, or the loop logs "exception never
                    # retrieved" for a future nobody will await
                    if fut.done():
                        fut.exception()
                    raise
        return await fut

    def to_dict(self) -> dict:
        return {
            "batches": self.stats.batches,
            "writes": self.stats.queries,
            "avg_batch": round(self.stats.avg_batch, 2),
            "max_batch_seen": self.stats.max_batch_seen,
        }
