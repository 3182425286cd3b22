"""The closed loop: one harness thread keeps ``in_flight`` batches out.

A batch's queries go to the index's search as a device tensor; its hits are
copied without blocking into pinned host memory and an event is recorded.
When the loop is full the harness waits on the oldest event, which closes
that batch's latency (from just before its search call to its hits in host
memory), and submits the next. Batch i takes the pool's batch i mod P.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

clock = time.perf_counter_ns


class _Slot:
    """Pinned host buffers for one batch in flight, and its event."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.host: tuple[torch.Tensor, torch.Tensor] | None = None
        self.event = torch.cuda.Event() if cuda else None

    def fill(self, vals: torch.Tensor, rows: torch.Tensor) -> None:
        if self.host is None or self.host[0].shape != vals.shape or self.host[1].dtype != rows.dtype:
            self.host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda)
                              for t in (vals, rows))
        self.host[0].copy_(vals, non_blocking=self.cuda)
        self.host[1].copy_(rows, non_blocking=self.cuda)
        if self.cuda:
            self.event.record()

    def wait(self) -> None:
        if self.cuda:
            self.event.synchronize()

    def take(self) -> tuple[np.ndarray, np.ndarray]:
        return self.host[0].numpy().copy(), self.host[1].numpy().copy()


@dataclass
class Window:
    """One run of the loop. Times are ``perf_counter_ns``; ``end`` is the
    window's close (None: the loop ran a count of batches)."""
    start: int
    end: int | None
    batch: int
    submitted: int = 0
    index: list = field(default_factory=list)    # batch number, in completion order
    t_submit: list = field(default_factory=list)
    t_done: list = field(default_factory=list)
    vals: list = field(default_factory=list)     # [B, k] host copies
    rows: list = field(default_factory=list)
    spans: list = field(default_factory=list)    # (name, start, end): the harness's host steps

    def in_window(self) -> list[int]:
        """Positions of the batches completed inside the window."""
        return [j for j, t in enumerate(self.t_done) if self.end is None or t <= self.end]

    def latencies_ms(self) -> list[float]:
        return [(self.t_done[j] - self.t_submit[j]) / 1e6 for j in self.in_window()]


def run(search, pool: list[torch.Tensor], in_flight: int, *, seconds: float | None = None,
        batches: int | None = None, first: int = 0) -> Window:
    """Run the closed loop for ``seconds`` (or ``batches`` batches), then
    wait for the batches still out. ``first``: the number of the first
    batch (its pool slot is first mod P)."""
    cuda = pool[0].is_cuda
    slots = [_Slot(cuda) for _ in range(in_flight)]
    pending: deque = deque()
    start = clock()
    w = Window(start, None if seconds is None else start + int(seconds * 1e9),
               pool[0].shape[0])

    def finish() -> None:
        i, t_sub, slot = pending.popleft()
        t0 = clock()
        slot.wait()
        t1 = clock()
        v, r = slot.take()
        t2 = clock()
        w.index.append(i)
        w.t_submit.append(t_sub)
        w.t_done.append(t1)
        w.vals.append(v)
        w.rows.append(r)
        w.spans += [("wait", t0, t1), ("collect", t1, t2)]

    i = first
    while (w.end is None or clock() < w.end) and (batches is None or i < first + batches):
        if len(pending) == in_flight:
            finish()
            continue
        q = pool[i % len(pool)]
        t0 = clock()
        vals, rows = search(q)
        t1 = clock()
        slot = slots[i % in_flight]
        slot.fill(vals, rows)
        t2 = clock()
        w.spans += [("search", t0, t1), ("copy", t1, t2)]
        pending.append((i, t0, slot))
        i += 1
    w.submitted = i - first
    while pending:
        finish()
    return w
