"""L0.5 canonical-alias cache key map.

Rebuild of the reference's ``CanonicalKeyMap``
(ref: DataModel/CanonicalKeyMap.cs:11-93): alias-hash → canonical-hash with
a confidence score and TTL. In the reference the aliases are produced by
LLM query normalization ("what's the weather" ≈ "weather today"); here any
producer (the sidecar's canonical-key prompt, or offline batch jobs) can
register aliases.
"""

from __future__ import annotations

import threading
from typing import Optional

from pyrope_tpu_torch.utils.clock import SYSTEM_CLOCK, Clock


class _Alias:
    __slots__ = ("canonical", "confidence", "expires_at")

    def __init__(self, canonical: str, confidence: float, expires_at: float):
        self.canonical = canonical
        self.confidence = confidence
        self.expires_at = expires_at


class CanonicalKeyMap:
    """Entries are namespaced by tenant: a tenant-scoped role registering an
    alias can only redirect lookups made on behalf of that same tenant, never
    another tenant's L0.5 cache path. ``tenant=""`` is the global
    namespace used by single-tenant/offline producers."""

    def __init__(self, clock: Clock = SYSTEM_CLOCK, min_confidence: float = 0.5):
        self._clock = clock
        self._min_confidence = min_confidence
        self._lock = threading.Lock()
        self._aliases: dict[tuple[str, str], _Alias] = {}

    def set_alias(
        self,
        alias_hash: str,
        canonical_hash: str,
        confidence: float = 1.0,
        ttl_seconds: float = 3600.0,
        tenant: str = "",
    ) -> None:
        with self._lock:
            self._aliases[(tenant, alias_hash)] = _Alias(
                canonical_hash, float(confidence), self._clock.now() + ttl_seconds
            )

    def try_get_canonical(self, alias_hash: str, tenant: str = "") -> Optional[str]:
        now = self._clock.now()
        with self._lock:
            a = self._aliases.get((tenant, alias_hash))
            if a is None:
                return None
            if a.expires_at <= now:
                del self._aliases[(tenant, alias_hash)]
                return None
            if a.confidence < self._min_confidence:
                return None
            return a.canonical

    def cleanup_expired(self) -> int:
        now = self._clock.now()
        with self._lock:
            dead = [k for k, a in self._aliases.items() if a.expires_at <= now]
            for k in dead:
                del self._aliases[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._aliases)
