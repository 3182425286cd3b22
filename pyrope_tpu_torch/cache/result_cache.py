"""L0/L0.5 result cache with epoch-based invalidation.

Rebuild of the reference's ``ResultCache`` (ref: Model/ResultCache.cs):
stores JSON-serialized hits keyed ``cache:{tenant}:{index}:{hash}``
(:125-128); ``try_get`` verifies stored-key equality (hash-collision check)
plus index **epoch** match (:27-71); ``try_get_aliased`` (the L0.5/L1/L2
path) skips key-equality but still checks epoch (:73-107); ``set`` stamps
the current epoch (:109-123). Epochs come from the index registry — any
write to an index bumps its epoch, instantly invalidating every cached
result for it.
"""

from __future__ import annotations

import json
from typing import Callable, Optional

from pyrope_tpu_torch.cache.query_key import QueryKey
from pyrope_tpu_torch.cache.storage import CacheStorage
from pyrope_tpu_torch.types import SearchResult


def _hits_to_jsonable(hits: list[SearchResult]) -> list[dict]:
    return [{"id": h.id, "score": float(h.score)} for h in hits]


def _hits_from_jsonable(rows: list[dict]) -> list[SearchResult]:
    return [SearchResult(id=r["id"], score=float(r["score"])) for r in rows]


class ResultCache:
    def __init__(
        self,
        storage: CacheStorage,
        epoch_provider: Callable[[str, str], int],
    ):
        self._storage = storage
        # (tenant, index) -> current epoch; ref wires VectorIndexRegistry in.
        self._epoch = epoch_provider

    def try_get(self, key: QueryKey) -> Optional[list[SearchResult]]:
        """Exact L0 lookup: stored-key identity must match (collision check)
        and the stored epoch must equal the index's current epoch."""
        raw = self._storage.get(key.storage_key())
        if raw is None:
            return None
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            return None
        stored_key = QueryKey.from_dict(payload["key"])
        if stored_key != key:
            return None
        if payload["epoch"] != self._epoch(key.tenant, key.index):
            return None
        return _hits_from_jsonable(payload["hits"])

    def try_get_aliased(
        self, tenant: str, index: str, canonical_hash: str
    ) -> Optional[list[SearchResult]]:
        """Aliased lookup by canonical hash (L0.5/L1/L2): skips key-equality
        but still enforces the epoch check (ref: ResultCache.cs:73-107)."""
        raw = self._storage.get(f"cache:{tenant}:{index}:{canonical_hash}")
        if raw is None:
            return None
        try:
            payload = json.loads(raw)
        except json.JSONDecodeError:
            return None
        if payload["epoch"] != self._epoch(tenant, index):
            return None
        return _hits_from_jsonable(payload["hits"])

    def set(
        self, key: QueryKey, hits: list[SearchResult], ttl_seconds: float
    ) -> bool:
        payload = json.dumps(
            {
                "key": key.to_dict(),
                "epoch": self._epoch(key.tenant, key.index),
                "hits": _hits_to_jsonable(hits),
            }
        )
        return self._storage.set(
            key.storage_key(), payload, ttl_seconds, tenant=key.tenant
        )

    def invalidate_index(self, tenant: str, index: str) -> int:
        """Prefix purge (used by the cache admin API)."""
        rm = getattr(self._storage, "remove_by_prefix", None)
        if rm is None:
            return 0
        return rm(f"cache:{tenant}:{index}:")
