"""Record-of-truth vector store.

Rebuild of the reference's ``VectorStore``
(ref: Services/VectorStore.cs:9-73): a concurrent map keyed
``tenant:index:id`` holding the full ``VectorRecord`` (vector + metadata +
tags + numeric fields), with logical delete. Indexes hold only (id, vector);
metadata joins happen against this store at result time
(ref: VectorCommandSet.cs:461-481).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class VectorRecord:
    """ref: Model/VectorRecord.cs."""

    id: str
    vector: np.ndarray
    meta: Optional[dict[str, Any]] = None
    tags: tuple[str, ...] = ()
    numeric_fields: Optional[dict[str, float]] = None
    deleted: bool = False

    def nbytes(self) -> int:
        """Approximate stored bytes (billing estimator,
        ref: BillingMeter.cs:169-196)."""
        n = self.vector.nbytes + len(self.id.encode())
        if self.meta:
            n += sum(len(str(k)) + len(str(v)) for k, v in self.meta.items())
        n += sum(len(t) for t in self.tags)
        if self.numeric_fields:
            n += 12 * len(self.numeric_fields)
        return n


class VectorStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._records: dict[str, VectorRecord] = {}

    @staticmethod
    def _key(tenant: str, index: str, id: str) -> str:
        return f"{tenant}:{index}:{id}"

    def try_add(self, tenant: str, index: str, record: VectorRecord) -> bool:
        key = self._key(tenant, index, record.id)
        with self._lock:
            existing = self._records.get(key)
            if existing is not None and not existing.deleted:
                return False
            self._records[key] = record
            return True

    def upsert(self, tenant: str, index: str, record: VectorRecord) -> int:
        """Returns the byte delta (new − old) for billing."""
        key = self._key(tenant, index, record.id)
        with self._lock:
            old = self._records.get(key)
            old_bytes = old.nbytes() if (old is not None and not old.deleted) else 0
            self._records[key] = record
            return record.nbytes() - old_bytes

    def try_get(self, tenant: str, index: str, id: str) -> Optional[VectorRecord]:
        with self._lock:
            r = self._records.get(self._key(tenant, index, id))
            return None if (r is None or r.deleted) else r

    def try_mark_deleted(self, tenant: str, index: str, id: str) -> bool:
        with self._lock:
            r = self._records.get(self._key(tenant, index, id))
            if r is None or r.deleted:
                return False
            r.deleted = True
            return True

    def purge_index(self, tenant: str, index: str) -> int:
        """Remove every record of an index (called on index drop so ghost
        ids/metadata never leak into a recreated index)."""
        prefix = f"{tenant}:{index}:"
        with self._lock:
            keys = [k for k in self._records if k.startswith(prefix)]
            for k in keys:
                del self._records[k]
            return len(keys)

    def export_records(self, tenant: str, index: str) -> list[VectorRecord]:
        """Live records of one index (snapshot persistence; the reference's
        record-of-truth lives in Garnet's persisted KV — ours must ride the
        index snapshot)."""
        prefix = f"{tenant}:{index}:"
        with self._lock:
            return [
                dataclasses.replace(r)
                for k, r in self._records.items()
                if k.startswith(prefix) and not r.deleted
            ]

    def import_records(self, tenant: str, index: str, records: list[VectorRecord]) -> int:
        """Replace an index's records wholesale (snapshot restore)."""
        prefix = f"{tenant}:{index}:"
        with self._lock:
            for k in [k for k in self._records if k.startswith(prefix)]:
                del self._records[k]
            for r in records:
                self._records[prefix + r.id] = r
            return len(records)

    def count(self, tenant: str, index: str) -> int:
        prefix = f"{tenant}:{index}:"
        with self._lock:
            return sum(
                1
                for k, r in self._records.items()
                if k.startswith(prefix) and not r.deleted
            )
