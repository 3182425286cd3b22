"""Frozen device-resident Flat index (port of ``pyrope_tpu/index/device_flat.py``).

``FlatIndex`` keeps a host numpy slab as the record of truth and uploads it
lazily: right for a mutable serving index, but it caps the corpus at what
the host can hold and move (10M x 128 fp32 is 5.12 GB). ``DeviceFlatIndex``
adopts an [N, D] fp32 or bf16 tensor that already lives on the card (a
collocated loader, another model's embedding head, an on-device generator)
in place, with no host copy, and serves FlatIndex's query surface: the same
score conventions and the same ``max_scans`` budget.

Routes (``describe_scan``), by the JAX package's names:
  - ``device-pallas`` (``selection="pallas"``, the default): the flat scan
    kernel K1 (``ops/fused_scan.fused_flat_topk``): csrc/fused_scan.cu on
    an fp32 slab, the tensor-core kernel of csrc/flat_scan_tc.cu on a bf16
    slab (bf16(q)·x, fp32 sums, as the JAX kernel's bf16 branch).
  - ``device-exact``: plain torch, one [B, N] score matrix + stable top-k.
Cosine rows are normalized at ingest and scored as IP. The JAX package
pads the slab to a 4096-row multiple (``SLAB_ALIGN``), a Pallas row-tile
rule; the port's kernels mask ragged edges themselves, so the slab is
adopted as it is, with no padded copy.

Frozen: ``add``/``upsert``/``delete`` raise (a mutable head composes over
it through ``DeltaIndex``). ``snapshot`` fetches the slab once and writes
``pyrope_tpu.flat.v1``, so a frozen corpus loads into a mutable FlatIndex.
Row ids default to the implicit ``str(row)``; ``ids=`` attaches explicit
ones.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.index.base import VectorIndex
from pyrope_tpu_torch.index.flat import read_meta
from pyrope_tpu_torch.ops.distance import normalize_rows, score_matrix
from pyrope_tpu_torch.ops.fused_scan import fused_flat_topk, k_refusal
from pyrope_tpu_torch.ops.topk import masked_topk, parse_selection
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import batch_bucket

_FROZEN_MSG = (
    "DeviceFlatIndex is frozen (device-resident slab, no host record of "
    "truth). Use FlatIndex for mutable corpora, or compose a mutable head "
    "over this index with DeltaIndex."
)

# rows a step of the sqnorm pass widens at once: no [N, D] fp32 transient
_SQNORM_CHUNK = 1 << 20


def slab_sqnorms(x: torch.Tensor) -> torch.Tensor:
    """fp32 ‖x‖² of each row of an fp32 or bf16 slab, in row chunks."""
    out = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _SQNORM_CHUNK):
        xf = x[s:s + _SQNORM_CHUNK].float()
        out[s:s + _SQNORM_CHUNK] = (xf * xf).sum(dim=-1)
    return out


class DeviceFlatIndex(VectorIndex):
    """Read-only exact scan over a device-resident slab."""

    host_write_cheap = False

    def __init__(
        self,
        x: torch.Tensor | np.ndarray,
        metric: Metric | str = Metric.L2,
        *,
        n_valid: Optional[int] = None,
        selection: str = "pallas",  # pallas | exact | approx[:recall]
        ids: Optional[Sequence[str]] = None,
        device="cuda",
    ):
        """``x``: [N, D] fp32/bf16 corpus. A tensor is adopted in place on
        its own device (``device`` is not read); numpy input is uploaded to
        ``device`` (the card unless the caller asks for the CPU).
        ``n_valid``: live rows when the tail of ``x`` is padding (default:
        all N). COSINE rows are L2-normalized at ingest (a normalized copy)
        and scored as IP."""
        parse_selection(selection)
        if x.ndim != 2:
            raise ValueError(f"expected [N, D] corpus, got shape {tuple(x.shape)}")
        n, dim = int(x.shape[0]), int(x.shape[1])
        n_valid = n if n_valid is None else int(n_valid)
        if not 0 < n_valid <= n:
            raise ValueError(f"n_valid must be in (0, {n}], got {n_valid}")
        self.dim = dim
        self.metric = Metric.parse(metric)
        self.selection = selection
        if isinstance(x, np.ndarray):
            self.device = resolve_device(device)
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(self.device)
        else:
            self.device = resolve_device(x.device)
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"slab dtype must be fp32|bf16, got {x.dtype}")
        if self.metric == Metric.COSINE:
            x = normalize_rows(x)
        self._dev = {
            "vecs": x,
            "sqnorm": slab_sqnorms(x),
            "alive": torch.arange(n, device=self.device) < n_valid,
        }
        self._count = n_valid
        if ids is not None:
            ids = list(ids)
            if len(ids) != n_valid:
                raise ValueError(f"ids must have n_valid={n_valid} entries")
            self._row_ids: Optional[list[str]] = ids
            self._id_to_row = {i: r for r, i in enumerate(ids)}
            if len(self._id_to_row) != n_valid:
                raise ValueError("duplicate ids")
        else:
            self._row_ids = None  # implicit str(row) ids
            self._id_to_row = None

    # ---- mutation: frozen -------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        raise RuntimeError(_FROZEN_MSG)

    def upsert(self, id: str, vector: np.ndarray) -> None:
        raise RuntimeError(_FROZEN_MSG)

    def delete(self, id: str) -> bool:
        raise RuntimeError(_FROZEN_MSG)

    # ---- query -------------------------------------------------------------

    def _search_device(self, q: torch.Tensor, top_k: int, max_scans: Optional[int]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        dev = self._dev
        ms = self._count if max_scans is None else min(max_scans, self._count)
        metric = Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        if self.selection == "pallas":
            why = k_refusal(top_k)
            if why is not None:
                raise ValueError(f"device-pallas needs the flat scan kernel: {why}")
            return fused_flat_topk(q, dev["vecs"], dev["sqnorm"], dev["alive"], ms,
                                   top_k, metric)
        scores = score_matrix(q, dev["vecs"], metric, x_sqnorm=dev["sqnorm"])
        row = torch.arange(dev["vecs"].shape[0], device=self.device)
        return masked_topk(scores, (dev["alive"] & (row < ms))[None, :], top_k,
                           self.selection)

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """q [B, D] fp32 on the index device -> (scores [B, k], rows [B, k]).
        COSINE: rows were normalized at ingest, so pass unit queries (as
        search_batch makes them)."""
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        return self._search_device(q, top_k, options.max_scans)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        if self._row_ids is None:
            return [[str(int(r)) if r >= 0 else "" for r in row] for row in rows]
        return [[self._row_ids[int(r)] if r >= 0 else "" for r in row] for row in rows]

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
        if self.metric == Metric.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        b = q.shape[0]
        bb = batch_bucket(b)
        if bb != b:
            q = np.pad(q, ((0, bb - b), (0, 0)))
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        vals, rows = self._search_device(qt, top_k, options.max_scans)
        vals = vals[:b].cpu().numpy()
        ids = self.resolve_rows(rows[:b].cpu().numpy())
        return [[SearchResult(i, float(v)) for v, i in zip(vrow, irow)
                 if i and np.isfinite(v)] for vrow, irow in zip(vals, ids)]

    # ---- lifecycle ----------------------------------------------------------

    def _host_rows(self) -> np.ndarray:
        """The live rows as host fp32, one bulk device-to-host copy."""
        return self._dev["vecs"][: self._count].float().cpu().numpy()

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        """One bulk device-to-host fetch, then host iteration."""
        vecs = self._host_rows()
        for row in range(self._count):
            rid = str(row) if self._row_ids is None else self._row_ids[row]
            yield rid, vecs[row]

    def get_stats(self) -> IndexStats:
        return IndexStats(count=self._count, dim=self.dim, metric=self.metric)

    def memory_bytes(self) -> int:
        d = self._dev
        return int(d["vecs"].numel() * d["vecs"].element_size()
                   + d["sqnorm"].numel() * 4 + d["alive"].numel())

    def describe_scan(self, batch: int | None = None,
                      nprobe: int | None = None) -> str:
        return {"pallas": "device-pallas", "exact": "device-exact"}.get(
            self.selection, f"device-{self.selection}")

    def snapshot(self, path: str) -> None:
        """Fetch the slab once and write FlatIndex's ``pyrope_tpu.flat.v1``
        format (``implicit_ids`` lets load skip the id list)."""
        ids = np.array([str(r) for r in range(self._count)]
                       if self._row_ids is None else self._row_ids, dtype=np.str_)
        meta = json.dumps({
            "format": "pyrope_tpu.flat.v1",
            "dim": self.dim,
            "metric": self.metric.value,
            "storage": "bf16" if self._dev["vecs"].dtype == torch.bfloat16 else "fp32",
            "implicit_ids": self._row_ids is None,
        })
        np.savez_compressed(path, meta=np.str_(meta), ids=ids, vecs=self._host_rows())

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._restore(z)

    def _restore(self, arrays) -> None:
        """Re-adopt ``pyrope_tpu.flat.v1`` state (a snapshot's arrays, or the
        JAX package's carried across, see convert.py) on this index's
        device."""
        meta = read_meta(arrays, "pyrope_tpu.flat.v1")
        if int(meta["dim"]) != self.dim:
            raise ValueError("snapshot dim mismatch")
        vecs = np.asarray(arrays["vecs"], np.float32)
        ids = None if meta.get("implicit_ids") else [str(s) for s in arrays["ids"]]
        dtype = torch.bfloat16 if meta.get("storage") == "bf16" else torch.float32
        self.__init__(torch.from_numpy(vecs).to(self.device, dtype),
                      Metric.parse(meta["metric"]), selection=self.selection, ids=ids)
