"""Billing: per-tenant usage meters + tamper-evident hash-chained log.

Rebuilds of:
- ``BillingMeter`` (ref: Services/BillingMeter.cs:11-282): per-tenant
  request counts (hit/miss split), compute cost-units, stored vector bytes,
  snapshot bytes; interval-gated appends to the log store.
- ``BillingLogStore`` (ref: Services/BillingLogStore.cs:16-70):
  SHA-256-chained entries — hash = H(prev_hash + payload), rooted at
  "GENESIS" — kept in an in-memory ring and an optional JSONL file with a
  size cap, so any tampering with past billing records breaks the chain.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from pathlib import Path
from typing import Optional

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock

GENESIS = "GENESIS"


@dataclasses.dataclass
class BillingLogEntry:
    timestamp: float
    tenant_id: str
    payload: dict
    prev_hash: str
    hash: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _entry_hash(prev_hash: str, timestamp: float, tenant_id: str, payload: dict) -> str:
    body = json.dumps(
        {"ts": timestamp, "tenant": tenant_id, "payload": payload},
        sort_keys=True,
        separators=(",", ":"),
    )
    return hashlib.sha256((prev_hash + body).encode()).hexdigest()


class BillingLogStore:
    def __init__(
        self,
        path: Optional[str] = None,
        max_entries: int = 10_000,
        max_file_bytes: int = 10 * 1024 * 1024,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self._path = Path(path) if path else None
        self._max_entries = max_entries
        self._max_file_bytes = max_file_bytes
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: list[BillingLogEntry] = []
        self._last_hash = GENESIS

    def append(self, tenant_id: str, payload: dict) -> BillingLogEntry:
        with self._lock:
            ts = self._clock.now()
            h = _entry_hash(self._last_hash, ts, tenant_id, payload)
            entry = BillingLogEntry(ts, tenant_id, payload, self._last_hash, h)
            self._last_hash = h
            self._entries.append(entry)
            if len(self._entries) > self._max_entries:
                self._entries = self._entries[-self._max_entries:]
            if self._path is not None:
                try:
                    if (
                        not self._path.exists()
                        or self._path.stat().st_size < self._max_file_bytes
                    ):
                        with self._path.open("a") as f:
                            f.write(json.dumps(entry.to_dict()) + "\n")
                except OSError:
                    pass  # billing log persistence is best-effort
            return entry

    def entries(self, tenant_id: Optional[str] = None) -> list[BillingLogEntry]:
        with self._lock:
            if tenant_id is None:
                return list(self._entries)
            return [e for e in self._entries if e.tenant_id == tenant_id]

    def verify_chain(self) -> bool:
        """Recompute every hash; False if any entry was tampered with."""
        with self._lock:
            prev = self._entries[0].prev_hash if self._entries else GENESIS
            for e in self._entries:
                if e.prev_hash != prev:
                    return False
                if _entry_hash(e.prev_hash, e.timestamp, e.tenant_id, e.payload) != e.hash:
                    return False
                prev = e.hash
            return True


@dataclasses.dataclass
class TenantBillingUsage:
    """ref: Model/TenantBillingUsage.cs."""

    requests_total: int = 0
    requests_cache_hit: int = 0
    requests_cache_miss: int = 0
    compute_cost_units: float = 0.0
    vector_bytes: int = 0
    snapshot_bytes: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class BillingMeter:
    def __init__(
        self,
        log_store: Optional[BillingLogStore] = None,
        log_interval_s: float = 60.0,
        cost_unit_seconds: float = 1.0,
        clock: Clock = SYSTEM_CLOCK,
    ):
        self._log = log_store
        self._log_interval_s = log_interval_s
        self._cost_unit_seconds = cost_unit_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self._usage: dict[str, TenantBillingUsage] = {}
        self._last_logged: dict[str, float] = {}

    def _u(self, tenant: str) -> TenantBillingUsage:
        u = self._usage.get(tenant)
        if u is None:
            u = self._usage[tenant] = TenantBillingUsage()
        return u

    def record_request(self, tenant: str, cache_hit: bool) -> None:
        with self._lock:
            u = self._u(tenant)
            u.requests_total += 1
            if cache_hit:
                u.requests_cache_hit += 1
            else:
                u.requests_cache_miss += 1
        self._maybe_log(tenant)

    def record_compute(self, tenant: str, cost_units: float) -> None:
        with self._lock:
            self._u(tenant).compute_cost_units += cost_units * self._cost_unit_seconds
        self._maybe_log(tenant)

    def record_vector_bytes(self, tenant: str, delta_bytes: int) -> None:
        with self._lock:
            u = self._u(tenant)
            u.vector_bytes = max(0, u.vector_bytes + delta_bytes)

    def record_snapshot(self, tenant: str, nbytes: int) -> None:
        with self._lock:
            self._u(tenant).snapshot_bytes += nbytes
        self._maybe_log(tenant)

    def _maybe_log(self, tenant: str) -> None:
        """Interval-gated append (ref: BillingMeter.cs interval gate)."""
        if self._log is None:
            return
        now = self._clock.now()
        with self._lock:
            last = self._last_logged.get(tenant, 0.0)
            if now - last < self._log_interval_s:
                return
            self._last_logged[tenant] = now
            payload = self._u(tenant).to_dict()
        self._log.append(tenant, payload)

    def get_usage(self, tenant: str) -> TenantBillingUsage:
        with self._lock:
            u = self._usage.get(tenant)
            return dataclasses.replace(u) if u else TenantBillingUsage()

    def all_usage(self) -> dict[str, TenantBillingUsage]:
        with self._lock:
            return {t: dataclasses.replace(u) for t, u in self._usage.items()}
