"""Delta (LSM Head+Tail) composite index (the port's copy of
``pyrope_tpu/index/delta.py``, numpy only: it composes any two indexes).

Rebuild of the reference's ``DeltaVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/DeltaVectorIndex.cs):

- writes go to the mutable Head (:29-56)
- delete propagates to both halves (:58-74)
- search = Head.search + Tail.search, merged by id with Head winning,
  sorted descending, top-k (:76-122)
- ``build()`` = compaction: scan Head → Tail.add each → Head.delete each →
  build both (:124-158)
- snapshot = ``.head`` + ``.tail`` files + JSON manifest written
  tmp-then-atomic-rename (:160-191)
- forwards ``get_centroids`` from the Tail (:231-242)
"""

from __future__ import annotations

import json
import os
from typing import Iterator, Optional

import numpy as np

from pyrope_tpu_torch.index.base import CentroidsProvider, VectorIndex
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    SearchOptions,
    SearchResult,
)


class DeltaIndex(VectorIndex, CentroidsProvider):
    def __init__(self, head: VectorIndex, tail: VectorIndex):
        if head.dim != tail.dim or head.metric != tail.metric:
            raise ValueError("head/tail dim+metric must match")
        self.head = head
        self.tail = tail
        self.dim = head.dim
        self.metric = head.metric
        # ids live in BOTH halves (head shadows tail); kept incrementally so
        # get_stats stays O(1)
        self._overlap = 0

    # ---- mutation (writes land in Head, ref :29-56) ----------------------


    @property
    def host_write_cheap(self) -> bool:  # type: ignore[override]
        # writes land in the head (ref: DeltaVectorIndex.cs:48-63)
        return self.head.host_write_cheap

    def add(self, id: str, vector: np.ndarray) -> bool:
        # duplicate iff the id is live anywhere (head or tail); never mutate
        # state while answering that question
        if self._in_head(id) or self._in_tail(id):
            return False
        return self.head.add(id, vector)

    def upsert(self, id: str, vector: np.ndarray) -> None:
        gained_head = not self._in_head(id)
        self.head.upsert(id, vector)
        if gained_head and self._in_tail(id):
            self._overlap += 1

    def delete(self, id: str) -> bool:
        was_overlap = self._in_head(id) and self._in_tail(id)
        h = self.head.delete(id)
        t = self.tail.delete(id)
        if was_overlap:
            self._overlap -= 1
        return h or t

    def add_batch(self, ids, vectors) -> int:
        if self.tail.get_stats().count == 0:
            return self.head.add_batch(ids, vectors)
        return super().add_batch(ids, vectors)

    @staticmethod
    def _is_live(index: VectorIndex, id: str) -> bool:
        """Non-destructive liveness probe across the index families
        (Flat/HNSW: _id_to_row; IVF-*: _main_pos + buffer)."""
        pos = getattr(index, "_main_pos", None)
        if pos is not None:
            r = pos.get(id)
            if r is not None and index._alive[r]:
                return True
            buf = getattr(index, "_buffer", None)
            if buf is not None:
                rr = buf._id_to_row.get(id)
                return rr is not None and buf._alive[rr]
            return False
        idm = getattr(index, "_id_to_row", None)
        if idm is not None:
            r = idm.get(id)
            return r is not None and bool(index._alive[r])
        return any(i == id for i, _ in index.scan())  # generic fallback

    def _in_head(self, id: str) -> bool:
        return self._is_live(self.head, id)

    def _in_tail(self, id: str) -> bool:
        return self._is_live(self.tail, id)

    # ---- query (merge, Head wins — ref :76-122) ---------------------------

    def search_batch(
        self,
        queries: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[list[SearchResult]]:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        head_hits = (
            self.head.search_batch(q, top_k, options)
            if self.head.get_stats().count
            else [[] for _ in range(q.shape[0])]
        )
        tail_hits = (
            self.tail.search_batch(q, top_k, options)
            if self.tail.get_stats().count
            else [[] for _ in range(q.shape[0])]
        )
        out: list[list[SearchResult]] = []
        for hh, th in zip(head_hits, tail_hits):
            seen = {h.id for h in hh}
            merged = list(hh) + [t for t in th if t.id not in seen]
            merged.sort(key=lambda h: -h.score)
            out.append(merged[:top_k])
        return out

    def device_search(self, q, top_k, options=DEFAULT_SEARCH_OPTIONS):
        """Device-resident query; valid when the Head is fully compacted
        (post-build) so the Tail alone is authoritative."""
        if self.head.get_stats().count:
            raise RuntimeError("device_search requires a compacted (empty) head")
        return self.tail.device_search(q, top_k, options)

    def resolve_rows(self, rows):
        return self.tail.resolve_rows(rows)

    # ---- compaction (ref :124-158) ----------------------------------------

    def build(self) -> None:
        entries = list(self.head.scan())
        if entries and self.tail.get_stats().count == 0:
            # first compaction into an empty tail: one bulk build (the HNSW
            # tail routes this through the native C++ graph builder)
            ids = [i for i, _ in entries]
            vecs = np.stack([v for _, v in entries])
            self.tail.add_batch(ids, vecs)
        else:
            for id, vec in entries:
                self.tail.upsert(id, vec)
        for id, _ in entries:
            self.head.delete(id)
        self.head.build()
        self.tail.build()
        self._overlap = 0  # head fully compacted into tail

    def get_centroids(self) -> Optional[np.ndarray]:
        if isinstance(self.tail, CentroidsProvider):
            return self.tail.get_centroids()
        return None

    # ---- lifecycle ---------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        seen = set()
        for id, v in self.head.scan():
            seen.add(id)
            yield id, v
        for id, v in self.tail.scan():
            if id not in seen:
                yield id, v

    def get_stats(self) -> IndexStats:
        return IndexStats(
            count=self.head.get_stats().count
            + self.tail.get_stats().count
            - self._overlap,
            dim=self.dim,
            metric=self.metric,
        )

    def snapshot(self, path: str) -> None:
        """Manifest + .head/.tail, tmp-then-atomic-rename (ref :160-191)."""
        head_p, tail_p = path + ".head", path + ".tail"
        for target, part in ((head_p, self.head), (tail_p, self.tail)):
            tmp = target + ".tmp"
            part.snapshot(tmp)
            actual = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(actual, target)
        manifest = {
            "format": "pyrope_tpu.delta.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "head": os.path.basename(head_p),
            "tail": os.path.basename(tail_p),
            "head_type": type(self.head).__name__,
            "tail_type": type(self.tail).__name__,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            manifest = json.load(f)
        if manifest.get("format") != "pyrope_tpu.delta.v1":
            raise ValueError(f"bad snapshot format: {manifest.get('format')}")
        base = os.path.dirname(path)
        self.head.load(os.path.join(base, manifest["head"]))
        self.tail.load(os.path.join(base, manifest["tail"]))
        self.dim = self.head.dim
        self.metric = self.head.metric
        # recompute the overlap once at restore time
        self._overlap = sum(1 for i, _ in self.head.scan() if self._in_tail(i))
