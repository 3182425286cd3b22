"""Cache key for search results.

Rebuild of the reference's ``QueryKey`` (ref: Model/QueryKey.cs):
key = tenant + index + vector + topK + metric + tag-set, with optional
``simhash`` (L1 fuzzy key) and ``cluster_id`` (L2 semantic key). Equality
and hashing follow the same precedence the reference uses —
cluster_id > simhash > exact vector (ref: Model/QueryKey.cs:62-141) — and
topK is bucketed via ``round_k`` → {5,10,20,50,100}
(ref: Model/QueryKey.cs:52-60).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Sequence

import numpy as np

_K_BUCKETS = (5, 10, 20, 50, 100)


def round_k(top_k: int) -> int:
    """Bucket topK so near-identical queries share a cache line
    (ref: Model/QueryKey.cs:52-60). Values above the last bucket are
    returned unchanged — the reference does the same, and clamping them
    would let a top_k=300 query hit a line cached with fewer results."""
    for b in _K_BUCKETS:
        if top_k <= b:
            return b
    return top_k


@dataclasses.dataclass(frozen=True)
class QueryKey:
    tenant: str
    index: str
    vector_digest: str            # hex digest of the raw float32 query bytes
    top_k: int                    # already round_k-bucketed
    metric: str
    tags: tuple[str, ...] = ()
    simhash: Optional[int] = None       # L1: 64-bit SimHash
    cluster_id: Optional[int] = None    # L2: nearest semantic cluster

    @classmethod
    def create(
        cls,
        tenant: str,
        index: str,
        vector: np.ndarray,
        top_k: int,
        metric: str,
        tags: Sequence[str] = (),
        simhash: Optional[int] = None,
        cluster_id: Optional[int] = None,
    ) -> "QueryKey":
        v = np.ascontiguousarray(np.asarray(vector, dtype=np.float32))
        digest = hashlib.sha256(v.tobytes()).hexdigest()[:32]
        return cls(
            tenant=tenant,
            index=index,
            vector_digest=digest,
            top_k=round_k(int(top_k)),
            metric=str(metric),
            tags=tuple(sorted(tags)),
            simhash=simhash,
            cluster_id=cluster_id,
        )

    # Precedence cluster_id > simhash > exact vector, mirroring
    # ref Model/QueryKey.cs:62-141: two keys in the same cluster (or with the
    # same simhash) are "equal" for cache purposes even if vectors differ.
    def _identity(self) -> tuple:
        base = (self.tenant, self.index, self.top_k, self.metric, self.tags)
        if self.cluster_id is not None:
            return base + ("cluster", self.cluster_id)
        if self.simhash is not None:
            return base + ("simhash", self.simhash)
        return base + ("exact", self.vector_digest)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, QueryKey) and self._identity() == other._identity()

    def __hash__(self) -> int:
        return hash(self._identity())

    def cache_hash(self) -> str:
        """Stable string hash used inside storage keys."""
        ident = "|".join(str(x) for x in self._identity())
        return hashlib.sha256(ident.encode()).hexdigest()[:24]

    def storage_key(self) -> str:
        """``cache:{tenant}:{index}:{hash}`` (ref: Model/ResultCache.cs:125-128)."""
        return f"cache:{self.tenant}:{self.index}:{self.cache_hash()}"

    def with_simhash(self, simhash: int) -> "QueryKey":
        return dataclasses.replace(self, simhash=simhash, cluster_id=None)

    def with_cluster(self, cluster_id: int) -> "QueryKey":
        return dataclasses.replace(self, cluster_id=cluster_id)

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "index": self.index,
            "vector_digest": self.vector_digest,
            "top_k": self.top_k,
            "metric": self.metric,
            "tags": list(self.tags),
            "simhash": self.simhash,
            "cluster_id": self.cluster_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "QueryKey":
        return cls(
            tenant=d["tenant"],
            index=d["index"],
            vector_digest=d["vector_digest"],
            top_k=int(d["top_k"]),
            metric=d["metric"],
            tags=tuple(d.get("tags") or ()),
            simhash=d.get("simhash"),
            cluster_id=d.get("cluster_id"),
        )
