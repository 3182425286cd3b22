"""Exact brute-force (Flat) index (port of ``pyrope_tpu/index/flat.py``).

Host numpy arrays are the record of truth: a capacity-bucketed slab, a
tombstone (alive) mask and the id table. A device copy (vectors, fp32 row
sqnorms, alive) is synced lazily before queries: in full after growth or
bulk loads, by scattering the few mutated rows otherwise.

Selection:
  - ``exact``: plain torch, one [B, cap] score matrix + stable top-k (the
    JAX package's XLA path).
  - ``pallas``: the fused scan kernel K1 (ops/fused_scan.fused_flat_topk),
    exact, no [B, cap] score matrix. Cosine runs the exact path, as in the
    JAX package (the kernel takes pre-normalized IP only).
  - ``approx[:recall]``: runs exact (see ops/topk.py).
Not yet ported: ``storage`` bf16 / sq8 and ``selection`` hybrid; asking
for them raises NotImplementedError.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.base import VectorIndex
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import capacity_bucket
from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.ops.distance import row_sqnorms, score_matrix
from pyrope_tpu_torch.ops.fused_scan import fused_flat_topk
from pyrope_tpu_torch.ops.topk import masked_topk, parse_selection


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A device copy of a host array (never a view of it, also on the CPU:
    the host slab is mutated in place while the copy serves queries)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


class FlatIndex(VectorIndex):
    """Exact scan index with tombstone deletes (fp32 storage)."""

    @property
    def host_write_cheap(self) -> bool:  # see VectorIndex
        # a single add is cheap only while it fits the capacity bucket:
        # crossing one reallocates and copies the whole host slab
        return self._count < self._cap

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        device="cuda",
        storage: str = "fp32",
        selection: str = "exact",  # exact | pallas | approx[:recall]
        min_capacity: int = 1024,
    ):
        if storage not in ("fp32", "bf16", "sq8"):
            raise ValueError(f"storage must be fp32|bf16|sq8, got {storage}")
        mode, _ = parse_selection(selection)  # validate eagerly
        if storage != "fp32":
            raise NotImplementedError(f"storage={storage!r} not yet ported")
        if mode == "hybrid":
            raise NotImplementedError("selection='hybrid' not yet ported")
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.device = resolve_device(device)
        self.storage = storage
        self.selection = selection
        self._min_cap = min_capacity
        self._clear()

    def _clear(self) -> None:
        """Reset to empty host state (also used by load())."""
        self._cap = capacity_bucket(0, self._min_cap)
        self._vecs = np.zeros((self._cap, self.dim), np.float32)
        self._alive = np.zeros(self._cap, bool)
        self._row_ids: list[Optional[str]] = [None] * self._cap
        self._id_to_row: dict[str, int] = {}
        self._count = 0        # rows ever used (scan frontier)
        self._live = 0         # live rows
        self._dirty = True
        self._dirty_rows: Optional[set[int]] = set()
        self._dev: Optional[dict] = None

    # ---- mutation -------------------------------------------------------

    def _ensure_capacity(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = capacity_bucket(need, self._min_cap)
        vecs = np.zeros((new_cap, self.dim), np.float32)
        vecs[: self._cap] = self._vecs
        alive = np.zeros(new_cap, bool)
        alive[: self._cap] = self._alive
        self._vecs, self._alive = vecs, alive
        self._row_ids.extend([None] * (new_cap - self._cap))
        self._cap = new_cap
        self._dev = None  # shape changed; drop the device slab
        self._mark_all_dirty()

    def _check_vec(self, vector: np.ndarray) -> np.ndarray:
        v = np.asarray(vector, dtype=np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: expected {self.dim}, got {v.shape[0]}")
        return v

    def _mark_dirty(self, row: int) -> None:
        self._dirty = True
        if self._dirty_rows is not None:
            self._dirty_rows.add(row)
            if len(self._dirty_rows) > 4096:  # too many: a full upload wins
                self._dirty_rows = None

    def _mark_all_dirty(self) -> None:
        self._dirty = True
        self._dirty_rows = None

    def add(self, id: str, vector: np.ndarray) -> bool:
        v = self._check_vec(vector)
        with self.lock:
            row = self._id_to_row.get(id)
            if row is not None and self._alive[row]:
                return False
            if row is not None:  # revive a tombstoned id in place
                self._vecs[row] = v
                self._alive[row] = True
                self._live += 1
            else:
                self._ensure_capacity(self._count + 1)
                row = self._count
                self._vecs[row] = v
                self._alive[row] = True
                self._row_ids[row] = id
                self._id_to_row[id] = row
                self._count += 1
                self._live += 1
            self._mark_dirty(row)
            return True

    def upsert(self, id: str, vector: np.ndarray) -> None:
        v = self._check_vec(vector)
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None:
                self.add(id, v)
                return
            if not self._alive[row]:
                self._live += 1
            self._vecs[row] = v
            self._alive[row] = True
            self._mark_dirty(row)

    def delete(self, id: str) -> bool:
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None or not self._alive[row]:
                return False
            self._alive[row] = False
            self._vecs[row] = 0.0
            self._live -= 1
            self._mark_dirty(row)
            return True

    def add_batch(self, ids, vectors) -> int:
        vecs = np.asarray(vectors, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected [N, {self.dim}] batch")
        with self.lock:
            # fast path: all-new ids appended contiguously
            new_mask = [i not in self._id_to_row for i in ids]
            if all(new_mask) and len(set(ids)) == len(ids):
                n = len(ids)
                self._ensure_capacity(self._count + n)
                s = self._count
                self._vecs[s : s + n] = vecs
                self._alive[s : s + n] = True
                for off, i in enumerate(ids):
                    self._row_ids[s + off] = i
                    self._id_to_row[i] = s + off
                self._count += n
                self._live += n
                self._mark_all_dirty()
                return n
            return super().add_batch(ids, vecs)

    # ---- device sync ----------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev  # another thread synced while we waited
        if self._dev is not None and self._dirty_rows:
            return self._sync_incremental()
        vecs = to_device(self._vecs, self.device)
        self._dev = {
            "vecs": vecs,
            "sqnorm": row_sqnorms(vecs),
            "alive": to_device(self._alive, self.device),
        }
        self._dirty = False
        self._dirty_rows = set()
        return self._dev

    def _sync_incremental(self) -> dict:
        """Scatter the mutated rows into the device slab. In place: a fresh
        slab per mutation would copy the whole capacity. The rows are
        marked dead first and revived last, so a search that runs between
        the writes sees them absent, never half written."""
        rows = np.fromiter(self._dirty_rows, np.int64, len(self._dirty_rows))
        idx = torch.from_numpy(rows).to(self.device)
        v = to_device(self._vecs[rows], self.device)
        dev = self._dev
        dev["alive"][idx] = False
        dev["vecs"][idx] = v
        dev["sqnorm"][idx] = row_sqnorms(v)
        dev["alive"][idx] = to_device(self._alive[rows], self.device)
        self._dirty = False
        self._dirty_rows = set()
        return dev

    # ---- query ----------------------------------------------------------

    def _query_tensor(self, q) -> torch.Tensor:
        if not isinstance(q, torch.Tensor):
            q = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32))
            return q.to(self.device)
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        return q

    def _search_device(self, q: torch.Tensor, top_k: int,
                       max_scans: Optional[int]) -> tuple[torch.Tensor, torch.Tensor]:
        """q [B, D] on the index device -> (scores [B, k], rows [B, k]);
        rows are slab positions, -1 marks missing hits."""
        dev = self._sync()
        ms = self._count if max_scans is None else min(max_scans, self._count)
        if self.selection == "pallas" and self.metric != Metric.COSINE:
            return fused_flat_topk(q, dev["vecs"], dev["sqnorm"], dev["alive"],
                                   ms, top_k, self.metric)
        scores = score_matrix(q, dev["vecs"], self.metric, x_sqnorm=dev["sqnorm"])
        row = torch.arange(self._cap, device=self.device)
        mask = dev["alive"] & (row < ms)
        return masked_topk(scores, mask[None, :], top_k, self.selection)

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident query: q [B, D] tensor on the index device ->
        (scores [B, k], slab rows [B, k]) on the device; no host sync."""
        return self._search_device(self._query_tensor(q), top_k, options.max_scans)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        """Map slab rows (from device_search) to external ids; '' = no hit."""
        return [
            [self._row_ids[int(r)] or "" if r >= 0 else "" for r in row]
            for row in rows
        ]

    def search_batch(
        self,
        queries: np.ndarray,
        top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> list[list[SearchResult]]:
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise ValueError(f"dim mismatch: expected {self.dim}, got {q.shape[1]}")
        vals, rows = self._search_device(self._query_tensor(q), top_k,
                                         options.max_scans)
        return self._to_results(vals.cpu().numpy(), rows.cpu().numpy())

    def _to_results(self, vals: np.ndarray, rows: np.ndarray) -> list[list[SearchResult]]:
        out: list[list[SearchResult]] = []
        for vrow, rrow in zip(vals, rows):
            hits = []
            for v, r in zip(vrow, rrow):
                if r < 0 or not np.isfinite(v):
                    continue
                rid = self._row_ids[int(r)]
                if rid is not None:
                    hits.append(SearchResult(rid, float(v)))
            out.append(hits)
        return out

    # ---- lifecycle ------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        for row in range(self._count):
            if self._alive[row] and self._row_ids[row] is not None:
                yield self._row_ids[row], self._vecs[row].copy()

    def get_stats(self) -> IndexStats:
        return IndexStats(count=self._live, dim=self.dim, metric=self.metric)

    def snapshot(self, path: str) -> None:
        """``pyrope_tpu.flat.v1`` npz, the JAX package's format."""
        with self.lock:  # a concurrent in-place upsert would tear a row
            live_rows = [r for r in range(self._count) if self._alive[r]]
            ids = np.array([self._row_ids[r] for r in live_rows], dtype=np.str_)
            vecs = (self._vecs[live_rows] if live_rows
                    else np.zeros((0, self.dim), np.float32))
            meta = json.dumps({
                "format": "pyrope_tpu.flat.v1",
                "dim": self.dim,
                "metric": self.metric.value,
                "storage": self.storage,
            })
            np.savez_compressed(path, meta=np.str_(meta), ids=ids, vecs=vecs)

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._restore(z)

    def _restore(self, arrays) -> None:
        """Adopt ``pyrope_tpu.flat.v1`` state: a snapshot's arrays, or the
        JAX package's index state carried across (see convert.py)."""
        meta = read_meta(arrays, "pyrope_tpu.flat.v1")
        if int(meta["dim"]) != self.dim:
            raise ValueError("snapshot dim mismatch")
        if meta.get("storage", "fp32") != "fp32":
            raise NotImplementedError(f"storage={meta['storage']!r} not yet ported")
        ids = [str(s) for s in arrays["ids"]]
        vecs = np.asarray(arrays["vecs"], np.float32)
        self.metric = Metric.parse(meta["metric"])
        self._clear()
        if ids:
            self.add_batch(ids, vecs)

    def describe_scan(self, batch: int | None = None,
                      nprobe: int | None = None) -> str:
        """Which kernel a query runs."""
        if self.selection == "pallas" and self.metric != Metric.COSINE:
            return "flat-pallas"
        return "flat-exact"  # exact, approx and cosine-pallas run the exact scan

    # ---- internals exposed for composite indexes ------------------------

    def live_vectors(self) -> tuple[list[str], np.ndarray]:
        """(ids, vectors) of live rows, in insertion order. When every row
        is live the vectors are a VIEW of the host slab: callers must not
        mutate it."""
        n = self._count
        if n == 0:
            return [], np.zeros((0, self.dim), np.float32)
        alive = self._alive[:n]
        if alive.all():
            return list(self._row_ids[:n]), self._vecs[:n]
        rows = np.flatnonzero(alive)
        return [self._row_ids[int(r)] for r in rows], self._vecs[rows]


def read_meta(arrays, fmt: str) -> dict:
    """The ``meta`` entry of a snapshot's arrays (json text or a dict),
    checked against the expected format."""
    meta = arrays["meta"]
    meta = dict(meta) if isinstance(meta, dict) else json.loads(str(meta))
    if meta.get("format") != fmt:
        raise ValueError(f"bad snapshot format: {meta.get('format')}")
    return meta
