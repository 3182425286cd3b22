"""TTL cache storage with per-tenant byte accounting.

Rebuild of the reference's ``MemoryCacheStorage``
(ref: Model/MemoryCacheStorage.cs): TTL dict with per-tenant byte
accounting and cache-memory quota enforcement — a ``set`` that would push a
tenant over its ``cache_memory_mb`` quota is silently dropped (:37-86);
``clear`` / ``remove_by_prefix`` admin ops (:88-125). Implements the
storage, admin, and usage-provider roles the reference splits across
``ICacheStorage`` / ``ICacheAdmin`` / ``ICacheUsageProvider``.
"""

from __future__ import annotations

import abc
import threading
from typing import Callable, Optional

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


class CacheStorage(abc.ABC):
    """Storage contract (ref: Model/ICacheStorage.cs:5-10)."""

    @abc.abstractmethod
    def get(self, key: str) -> Optional[str]: ...

    @abc.abstractmethod
    def set(self, key: str, value: str, ttl_seconds: float, tenant: str = "") -> bool: ...

    @abc.abstractmethod
    def delete(self, key: str) -> bool: ...


class _Entry:
    __slots__ = ("value", "expires_at", "tenant", "nbytes")

    def __init__(self, value: str, expires_at: float, tenant: str, nbytes: int):
        self.value = value
        self.expires_at = expires_at
        self.tenant = tenant
        self.nbytes = nbytes


class MemoryCacheStorage(CacheStorage):
    """In-memory TTL store with tenant memory quotas."""

    def __init__(
        self,
        clock: Clock = SYSTEM_CLOCK,
        tenant_quota_mb: Optional[Callable[[str], Optional[float]]] = None,
        on_eviction: Optional[Callable[[str], None]] = None,
    ):
        self._clock = clock
        self._lock = threading.Lock()
        self._data: dict[str, _Entry] = {}
        self._tenant_bytes: dict[str, int] = {}
        # tenant -> CacheMemoryMb quota (None = unlimited), injected so the
        # storage doesn't depend on the tenant registry directly.
        self._tenant_quota_mb = tenant_quota_mb or (lambda _t: None)
        # eviction callback (reason) for metrics (ref records eviction reasons)
        self._on_eviction = on_eviction or (lambda _reason: None)

    @staticmethod
    def _size(key: str, value: str) -> int:
        return len(key.encode()) + len(value.encode())

    def _expire_locked(self, key: str, entry: _Entry) -> None:
        self._data.pop(key, None)
        self._tenant_bytes[entry.tenant] = max(
            0, self._tenant_bytes.get(entry.tenant, 0) - entry.nbytes
        )
        self._on_eviction("ttl")

    def get(self, key: str) -> Optional[str]:
        now = self._clock.now()
        with self._lock:
            e = self._data.get(key)
            if e is None:
                return None
            if e.expires_at <= now:
                self._expire_locked(key, e)
                return None
            return e.value

    def set(self, key: str, value: str, ttl_seconds: float, tenant: str = "") -> bool:
        """Returns False (drops silently, like ref :62-76) when the write
        would push the tenant over its cache-memory quota."""
        now = self._clock.now()
        nbytes = self._size(key, value)
        with self._lock:
            old = self._data.get(key)
            old_bytes = old.nbytes if (old is not None and old.tenant == tenant) else 0
            quota_mb = self._tenant_quota_mb(tenant)
            if quota_mb is not None:
                projected = self._tenant_bytes.get(tenant, 0) - old_bytes + nbytes
                if projected > quota_mb * 1024 * 1024:
                    self._on_eviction("quota")
                    return False
            if old is not None:
                self._tenant_bytes[old.tenant] = max(
                    0, self._tenant_bytes.get(old.tenant, 0) - old.nbytes
                )
            self._data[key] = _Entry(value, now + float(ttl_seconds), tenant, nbytes)
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + nbytes
            return True

    def delete(self, key: str) -> bool:
        with self._lock:
            e = self._data.pop(key, None)
            if e is None:
                return False
            self._tenant_bytes[e.tenant] = max(
                0, self._tenant_bytes.get(e.tenant, 0) - e.nbytes
            )
            return True

    def sweep_expired(self, max_scan: int = 50_000) -> int:
        """Reclaim expired entries (and their tenant-byte accounting) even
        when they are never read again; run periodically by the server's
        background tick. Returns entries removed."""
        now = self._clock.now()
        with self._lock:
            dead = []
            for i, (k, e) in enumerate(self._data.items()):
                if i >= max_scan:
                    break
                if e.expires_at <= now:
                    dead.append((k, e))
            for k, e in dead:
                self._expire_locked(k, e)
            return len(dead)

    # ---- admin (ref: Model/MemoryCacheStorage.cs:88-125) -----------------

    def clear(self) -> int:
        with self._lock:
            n = len(self._data)
            self._data.clear()
            self._tenant_bytes.clear()
            return n

    def remove_by_prefix(self, prefix: str) -> int:
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
            for k in keys:
                e = self._data.pop(k)
                self._tenant_bytes[e.tenant] = max(
                    0, self._tenant_bytes.get(e.tenant, 0) - e.nbytes
                )
            return len(keys)

    # ---- usage (ref: ICacheUsageProvider) ---------------------------------

    def tenant_bytes(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_bytes.get(tenant, 0)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._tenant_bytes.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)
