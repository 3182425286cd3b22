"""Audit trail for management operations.

Rebuild of the reference's ``AuditLogger``
(ref: Services/AuditLogger.cs:14-70): an in-memory ring (default 10k
entries) plus optional JSONL persistence with a 10 MB cap, queried by
tenant / time window / action. Every control-plane mutation (index create,
build, snapshot, tenant update, model deploy…) is logged
(e.g. ref: Controllers/IndexController.cs:61-70).
"""

from __future__ import annotations

import dataclasses
import json
import threading
from pathlib import Path
from typing import Optional

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


@dataclasses.dataclass(frozen=True)
class AuditEvent:
    timestamp: float
    tenant_id: str
    actor: str
    action: str
    resource: str
    detail: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AuditLogger:
    def __init__(
        self,
        max_entries: int = 10_000,
        path: Optional[str] = None,
        max_file_bytes: int = 10 * 1024 * 1024,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self._max_entries = max_entries
        self._path = Path(path) if path else None
        self._max_file_bytes = max_file_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self._events: list[AuditEvent] = []

    def log(
        self,
        tenant_id: str,
        actor: str,
        action: str,
        resource: str,
        detail: Optional[dict] = None,
    ) -> AuditEvent:
        ev = AuditEvent(self._clock.now(), tenant_id, actor, action, resource, detail)
        with self._lock:
            self._events.append(ev)
            if len(self._events) > self._max_entries:
                self._events = self._events[-self._max_entries:]
        if self._path is not None:
            try:
                if (
                    not self._path.exists()
                    or self._path.stat().st_size < self._max_file_bytes
                ):
                    with self._path.open("a") as f:
                        f.write(json.dumps(ev.to_dict()) + "\n")
            except OSError:
                pass
        return ev

    def query(
        self,
        tenant_id: Optional[str] = None,
        action: Optional[str] = None,
        since: Optional[float] = None,
        until: Optional[float] = None,
        limit: int = 100,
    ) -> list[AuditEvent]:
        with self._lock:
            out = []
            for ev in reversed(self._events):
                if tenant_id is not None and ev.tenant_id != tenant_id:
                    continue
                if action is not None and ev.action != action:
                    continue
                if since is not None and ev.timestamp < since:
                    continue
                if until is not None and ev.timestamp > until:
                    continue
                out.append(ev)
                if len(out) >= limit:
                    break
            return out

    def stats(self) -> dict:
        with self._lock:
            by_action: dict[str, int] = {}
            for ev in self._events:
                by_action[ev.action] = by_action.get(ev.action, 0) + 1
            return {"total": len(self._events), "by_action": by_action}
