"""Corpus-sharded exact scan + sharded k-means step (port of
``pyrope_tpu/parallel/sharded_flat.py``).

Corpus rows are block-sharded over the mesh's row axes (shard s owns rows
[s·L, (s+1)·L) of the capacity, padded to a multiple of the shard count);
each shard scores its own rows and keeps a local top-k; the [B, k] lists
merge to the final top-k (mesh.py). On a 2-D batch x data mesh the query
batch splits over ``batch`` too; on a multi-slice mesh rows shard over
slice x data. The k-means step shards the
assignment product and sums the per-shard partials.

Per-shard scans, by the JAX package's search makers:
  - ``make_sharded_search``: plain torch score matrix + masked top-k
    (``flat-exact``), the shard's rows past the global ``max_scans``
    budget masked;
  - ``make_sharded_pallas_search``: the flat scan kernel K1
    (``ops/fused_scan.fused_flat_topk``, fp32 or bf16 slab) on each
    shard's slab, the budget rebased per shard: clip(ms − s·L, 0, L);
  - ``make_sharded_sq8_search``: the SQ8 scores of index/flat.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.flat import (
    FlatIndex,
    sq8_device_state,
    sq8_scores,
    to_device,
)
from pyrope_tpu_torch.ops.distance import check_fp32_exact, row_sqnorms, score_matrix
from pyrope_tpu_torch.ops.fused_scan import fused_flat_topk, k_refusal
from pyrope_tpu_torch.ops.topk import masked_topk
from pyrope_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    encode_rows,
    on_device,
    replicate_shards,
    row_axes,
    row_shard_count,
    shard_grid,
    sharded_call,
)
from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.utils.shapes import round_up


def _budget_mask(st: dict, ms: int) -> torch.Tensor:
    """[1, L] alive rows of a shard inside the global max_scans budget."""
    n = st["alive"].shape[0]
    grow = st["base"] + torch.arange(n, device=st["alive"].device)
    return (st["alive"] & (grow < ms))[None, :]


def _sharded(mesh: Mesh, k: int, local):
    """fn(shards, q, max_scans) -> (scores [B, k], global rows [B, k]):
    ``local(st, q, ms)`` gives each shard's (scores, local rows), encoded
    by the shard's base row and merged."""

    def fn(shards, q, ms):
        def shard(s, st, qs):
            vals, idx = local(st, qs, int(ms))
            return vals, encode_rows(idx, st["base"])
        return sharded_call(mesh, row_axes(mesh), shards, q, shard, k)

    return fn


def make_sharded_search(mesh: Mesh, metric: Metric, k: int, compute: str | None):
    """Sharded plain scan: each shard's [B, L] score matrix + masked top-k,
    merged."""
    return _sharded(mesh, k, lambda st, q, ms: masked_topk(
        score_matrix(q, st["vecs"], metric, x_sqnorm=st["sqnorm"], compute_dtype=compute),
        _budget_mask(st, ms), k))


def make_sharded_pallas_search(mesh: Mesh, metric: Metric, k: int):
    """Sharded fused exact scan: each shard runs the flat scan kernel over
    its own row block (no [B, L] score matrix), then the merge. The global
    budget is rebased per shard: shard s owns global rows [s·L, (s+1)·L),
    so its local budget is clip(ms − s·L, 0, L)."""
    return _sharded(mesh, k, lambda st, q, ms: fused_flat_topk(
        q, st["vecs"], st["sqnorm"], st["alive"],
        min(max(ms - st["base"], 0), st["alive"].shape[0]), k, metric))


def make_sharded_sq8_search(mesh: Mesh, metric: Metric, k: int, compute: str | None):
    """Sharded SQ8 scan: uint8 codes + per-vector (min, scale) rows
    block-sharded; the same merge as the dense scan."""
    return _sharded(mesh, k, lambda st, q, ms: masked_topk(
        sq8_scores(st["codes"], st["mins"], st["scales"], st["sqnorm"], q, metric,
                   compute),
        _budget_mask(st, ms), k))


def sharded_kmeans_step(x, valid, cents, *, metric: Metric, mesh: Mesh) -> torch.Tensor:
    """One Lloyd iteration with rows sharded over the mesh's row axes.

    x [N, D] and valid [N] (tensors or numpy) are split into equal row
    blocks, one a shard on its device; cents [K, D] is replicated. Each
    shard's (sums, counts) come from a one-hot product over its rows; the
    partials are summed on the first shard's device. Returns the new centroids there; an empty cluster
    keeps its centroid."""
    metric = Metric.parse(metric)
    grid = shard_grid(mesh, row_axes(mesh))[0]
    x = torch.as_tensor(x)
    valid = torch.as_tensor(valid)
    cents = torch.as_tensor(cents)
    first = grid[0]
    parts = []
    for dev, xl, vl in zip(grid, torch.tensor_split(x, len(grid)),
                           torch.tensor_split(valid, len(grid))):
        with on_device(dev):
            xl, vl, c = xl.to(dev).float(), vl.to(dev), cents.to(dev).float()
            check_fp32_exact(xl)
            assign = torch.argmax(score_matrix(xl, c, metric), dim=1)
            onehot = ((assign[:, None] == torch.arange(c.shape[0], device=dev)[None, :])
                      & vl[:, None]).float()
            parts.append((onehot.T @ xl, onehot.sum(dim=0)))
    sums = sum(p[0].to(first) for p in parts)
    counts = sum(p[1].to(first) for p in parts)
    c = cents.to(first).float()
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, c)


class ShardedFlatIndex(FlatIndex):
    """FlatIndex whose device slab is row-sharded over the mesh (1-D
    ``data``, 2-D ``batch x data`` with queries split over ``batch``, or
    multi-slice ``slice x data``). Same host API and semantics as FlatIndex;
    the slab capacity is padded to a multiple of the row-shard count so
    shards stay equal. ``device`` names the default mesh's devices when no
    ``mesh`` is given."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        storage: str = "fp32",
        compute_dtype: Optional[str] = None,
        min_capacity: int = 1024,
        selection: str = "exact",
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._ndev = row_shard_count(self.mesh)  # data x slice (batch splits queries)
        self._grid = shard_grid(self.mesh, row_axes(self.mesh))
        super().__init__(
            dim, metric, device=self._grid[0, 0], storage=storage,
            compute_dtype=compute_dtype, min_capacity=max(min_capacity, 8 * self._ndev),
            selection=selection,
        )

    def _sync_locked(self) -> dict:
        """Upload the whole capacity, block-sharded (the JAX package's
        sharded sync has no incremental path either)."""
        if self._dev is not None and not self._dirty:
            return self._dev
        cap = round_up(self._cap, self._ndev)
        rows = cap // self._ndev
        vf = self._vecs
        if cap != self._cap:
            vf = np.pad(vf, ((0, cap - self._cap), (0, 0)))
        alive = np.zeros(cap, bool)
        alive[: self._cap] = self._alive
        shards = []
        for s, dev in enumerate(self._grid[0]):
            blk = slice(s * rows, (s + 1) * rows)
            if self.storage == "sq8":
                st = sq8_device_state(vf[blk], dev)
            else:
                vecs = to_device(vf[blk], dev)
                st = {"vecs": vecs.bfloat16() if self.storage == "bf16" else vecs,
                      "sqnorm": row_sqnorms(vecs)}
            st.update(alive=to_device(alive[blk], dev), base=s * rows)
            shards.append(st)
        self._dev = {"shards": replicate_shards(self._grid, shards), "rows_local": rows}
        self._dirty = False
        self._dirty_rows = set()
        return self._dev

    def _pallas_eligible(self, batch: int) -> bool:
        """Per-shard fused-kernel eligibility, as the single FlatIndex's
        opt-in: selection='pallas', not cosine, not SQ8. The JAX package's
        tile-divisibility terms have no counterpart: the kernel masks
        ragged edges. ``batch`` is kept for the JAX signature."""
        return (self.selection == "pallas" and self.metric != Metric.COSINE
                and self.storage != "sq8")

    def _route(self, batch: int, top_k: int) -> str:
        """'flat-sq8', 'flat-pallas' (K1 on every shard) or 'flat-exact'
        (the plain scan on every shard: exact, approx, hybrid and cosine)."""
        if self.storage == "sq8":
            return "flat-sq8"
        if not self._pallas_eligible(batch):
            return "flat-exact"
        why = k_refusal(top_k)
        if why is not None:
            raise ValueError(f"flat-pallas needs the flat scan kernel: {why}")
        return "flat-pallas"

    def _search_device(self, q, top_k, max_scans, batch=None):
        route = self._route(q.shape[0] if batch is None else batch, top_k)
        dev = self._sync()
        ms = self._count if max_scans is None else min(max_scans, self._count)
        if route == "flat-sq8":
            fn = make_sharded_sq8_search(self.mesh, self.metric, top_k, self.compute_dtype)
        elif route == "flat-pallas":
            fn = make_sharded_pallas_search(self.mesh, self.metric, top_k)
        else:
            fn = make_sharded_search(self.mesh, self.metric, top_k, self.compute_dtype)
        return fn(dev["shards"], q, ms)
