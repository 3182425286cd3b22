"""Sharded HNSW (port of ``pyrope_tpu/parallel/sharded_hnsw.py``).

Two layouts, as in the JAX package:

- ``ShardedHnswIndex``: the graph replicated, the query batch split over
  the mesh. Each device runs the batched beam (``index/hnsw.
  beam_search_body``, plain torch as in the JAX package) on its slice of
  the batch; no merge. A device that repeats in the mesh holds one copy
  of the graph.
- ``ShardedHnswCorpusIndex``: the corpus partitioned into k-means cells
  (capacity-balanced to ceil(n/nd)), one sub-graph a shard (an HnswIndex on
  the shard's device: the native builder below 200k rows, the device
  bootstrap above, as HnswIndex chooses). A query beams every shard's
  sub-graph; the [B, k] lists, encoded ``shard * stride + local row``,
  merge into one (mesh.py: the merge kernel on the card). Graph memory a
  device scales with 1/nd.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.hnsw import HnswIndex, beam_schedule, beam_search_body
from pyrope_tpu_torch.ops.kmeans import kmeans_build
from pyrope_tpu_torch.parallel.mesh import (
    Mesh,
    allgather_merge_topk,
    default_mesh,
    encode_rows,
    on_device,
)
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import round_up

SNAPSHOT_FORMAT = "pyrope_tpu.sharded_hnsw.v1"


def _hits(vals: np.ndarray, ids: list[list[Optional[str]]]) -> list[list[SearchResult]]:
    return [[SearchResult(i, float(v)) for v, i in zip(vrow, irow)
             if i is not None and np.isfinite(v)] for vrow, irow in zip(vals, ids)]


class ShardedHnswIndex(HnswIndex):
    """HnswIndex whose query batches fan out over the mesh's devices. Host
    API and graph construction as HnswIndex; ``device_search`` takes a
    batch that is a multiple of the mesh size (``search_batch`` pads).
    ``device`` names the default mesh's devices when no ``mesh`` is
    given."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        search_dtype: str = "float32",
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._ndev = self.mesh.size
        super().__init__(dim, metric, device=self.mesh.devices.flat[0], m=m,
                         ef_construction=ef_construction, ef_search=ef_search, seed=seed,
                         neighbor_heuristic=neighbor_heuristic, search_dtype=search_dtype)
        self._replicas: dict = {}

    def _replicated(self, dev: dict) -> list[dict]:
        """The graph on every mesh device (one copy a distinct device; the
        fp32 beam slab is the rerank slab, copied once)."""
        if self._replicas.get("src") is not dev:
            copies = {}
            for d in self.mesh.devices.flat:
                if d not in copies:
                    c = {k: v.to(d) if isinstance(v, torch.Tensor) else v
                         for k, v in dev.items() if k != "x_exact"}
                    c["x_exact"] = c["x"] if dev["x_exact"] is dev["x"] else dev["x_exact"].to(d)
                    copies[d] = c
            self._replicas = {"src": dev,
                              "per_device": [copies[d] for d in self.mesh.devices.flat]}
        return self._replicas["per_device"]

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Beam search of q [B, D] (B a multiple of the mesh size, on the
        mesh's first device): each device beams its slice of the batch.
        Returns (scores [B, k], node rows [B, k]) there."""
        if self._count == 0 or self._entry < 0:
            raise RuntimeError("device_search on empty index")
        b = q.shape[0]
        if b % self._ndev:
            raise ValueError(f"query batch {b} must be a multiple of the mesh size "
                             f"{self._ndev} (search_batch pads automatically)")
        pool, steps = beam_schedule(options.ef_search or self.ef_search, top_k)
        replicas = self._replicated(self._sync())
        first = self.mesh.devices.flat[0]
        vals, rows = [], []
        for d, g, qs in zip(self.mesh.devices.flat, replicas, torch.chunk(q, self._ndev)):
            with on_device(d):
                v, r = beam_search_body(
                    g["x"], g["x_exact"], g["sqnorm"], g["adj0"], g["adj_up"], g["alive"],
                    self._entry, qs.to(d), metric=self._search_metric(), k=top_k,
                    pool=pool, steps=steps, n_upper=g["n_upper"],
                    visited_mode=self.visited_mode, rerank=self.search_dtype == "bfloat16")
            vals.append(v.to(first))
            rows.append(r.to(first))
        return torch.cat(vals), torch.cat(rows)

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
        if self._count == 0 or self._entry < 0:
            return [[] for _ in range(q.shape[0])]
        if self.metric == Metric.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        b = q.shape[0]
        bb = round_up(b, self._ndev)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q
        vals, rows = self.device_search(torch.from_numpy(np.ascontiguousarray(qp))
                                        .to(self.device), top_k, options)
        vals, rows = vals[:b].cpu().numpy(), rows[:b].cpu().numpy()
        return _hits(vals, [[self._row_ids[int(r)] if r >= 0 else None for r in row]
                            for row in rows])


class ShardedHnswCorpusIndex:
    """HNSW partitioned over the mesh: a k-means cell and a sub-graph a
    shard. Writes before build() buffer on the host; build() partitions
    (capacity-balanced k-means cells) and builds the sub-graphs; later adds
    go to the least-loaded shard's incremental insert, deletes to the
    owning shard's tombstone."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        m: int = 16,
        ef_construction: int = 200,
        ef_search: int = 10,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        build_mode: str = "auto",
        device="cuda",
    ):
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._ndev = int(self.mesh.size)
        self._devices = list(self.mesh.devices.flat)
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.m = int(m)
        self.ef_search = int(ef_search)
        self._sub_kwargs = dict(m=m, ef_construction=ef_construction, ef_search=ef_search,
                                seed=seed, neighbor_heuristic=neighbor_heuristic,
                                build_mode=build_mode)
        self.seed = seed
        self._subs: list[HnswIndex] = []
        self._buf_ids: list[Optional[str]] = []
        self._buf_vecs: list[np.ndarray] = []
        self._buf_pos: dict[str, int] = {}
        self._owner: dict[str, int] = {}      # id -> shard (after build)
        self._stride: Optional[int] = None    # encoded-row stride of the last sync

    def _new_sub(self, s: int) -> HnswIndex:
        return HnswIndex(self.dim, self.metric, device=self._devices[s], **self._sub_kwargs)

    # ---- mutation --------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        if self._subs:
            if id in self._owner:
                return False
            s = min(range(self._ndev), key=lambda i: self._subs[i].get_stats().count)
            if self._subs[s].add(id, vector):
                self._owner[id] = s
                return True
            return False
        if id in self._buf_pos:
            return False
        self._buf_pos[id] = len(self._buf_ids)
        self._buf_ids.append(id)
        self._buf_vecs.append(np.asarray(vector, np.float32).reshape(-1))
        return True

    def add_batch(self, ids, vectors) -> int:
        vectors = np.asarray(vectors, np.float32)
        return sum(self.add(i, v) for i, v in zip(ids, vectors))

    def delete(self, id: str) -> bool:
        s = self._owner.get(id)
        if s is not None:
            return self._subs[s].delete(id)
        pos = self._buf_pos.pop(id, None)
        if pos is None:
            return False
        self._buf_ids[pos] = None
        return True

    # ---- build: partition + per-shard sub-graphs --------------------------

    def build(self) -> None:
        pairs = [(i, v) for i, v in zip(self._buf_ids, self._buf_vecs) if i is not None]
        if not pairs or self._subs:
            return
        ids = [p[0] for p in pairs]
        x = np.stack([p[1] for p in pairs])
        cells = self._partition(x, self._ndev)
        self._subs = [self._new_sub(s) for s in range(self._ndev)]
        for s in range(self._ndev):
            rows = np.flatnonzero(cells == s)
            if rows.size:
                self._subs[s].add_batch([ids[r] for r in rows], x[rows])
                self._subs[s].build()
            for r in rows:
                self._owner[ids[r]] = s
        self._buf_ids, self._buf_vecs, self._buf_pos = [], [], {}

    def _partition(self, x: np.ndarray, nd: int) -> np.ndarray:
        """k-means cells capacity-balanced to ceil(n/nd): coherent shards
        (a query's true neighbors concentrate on few) with bounded skew."""
        n = x.shape[0]
        if nd == 1:
            return np.zeros(n, np.int32)
        metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        _, assign, _ = kmeans_build(x, nd, metric, device=self._devices[0], seed=self.seed)
        assign = np.asarray(assign, np.int32).copy()
        cap = -(-n // nd)
        counts = np.bincount(assign, minlength=nd)
        spill = []
        for c in range(nd):
            if counts[c] > cap:
                rows = np.flatnonzero(assign == c)
                spill.extend(rows[cap:])   # deterministic overflow tail
                counts[c] = cap
        for r in spill:
            tgt = int(np.argmin(counts))
            assign[r] = tgt
            counts[tgt] += 1
        return assign

    # ---- query -----------------------------------------------------------

    def _graphs(self) -> list[Optional[dict]]:
        """Each shard's sub-graph tensors on its device (None: an empty
        shard), and the encoded-row stride (the largest sub-graph's rows)."""
        if not self._subs:
            raise RuntimeError("call build() first")
        graphs = [sub._sync() if sub._count and sub._entry >= 0 else None
                  for sub in self._subs]
        self._stride = max((g["x"].shape[0] for g in graphs if g is not None), default=1)
        return graphs

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """q [B, D] (pre-normalized for COSINE) -> (scores [B, k], encoded
        rows [B, k]) on the mesh's first device: every shard beams its own
        sub-graph on its device, then one merge."""
        graphs = self._graphs()
        pool, steps = beam_schedule(options.ef_search or self.ef_search, top_k)
        metric = Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric
        parts = []
        for s, (g, sub) in enumerate(zip(graphs, self._subs)):
            if g is None:
                continue
            d = self._devices[s]
            with on_device(d):
                v, r = beam_search_body(
                    g["x"], g["x_exact"], g["sqnorm"], g["adj0"], g["adj_up"], g["alive"],
                    sub._entry, q.to(d), metric=metric, k=top_k, pool=pool, steps=steps,
                    n_upper=g["n_upper"])
            parts.append((v, encode_rows(r, s * self._stride)))
        if not parts:
            b = q.shape[0]
            return (torch.full((b, top_k), float("-inf"), device=q.device),
                    torch.full((b, top_k), -1, dtype=torch.int32, device=q.device))
        return allgather_merge_topk(parts, top_k, self._devices[0])

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        out = []
        for row in np.asarray(rows):
            ids = []
            for r in row:
                if r < 0:
                    ids.append("")
                    continue
                s, local = divmod(int(r), self._stride)
                ids.append(self._subs[s]._row_ids[local] or "")
            out.append(ids)
        return out

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
        if not self._subs:
            return [[] for _ in range(q.shape[0])]
        if self.metric == Metric.COSINE:
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self._devices[0])
        vals, rows = self.device_search(qt, top_k, options)
        ids = [[i or None for i in row] for row in self.resolve_rows(rows.cpu().numpy())]
        return _hits(vals.cpu().numpy(), ids)

    def search(self, query, top_k, options=DEFAULT_SEARCH_OPTIONS):
        return self.search_batch(query, top_k, options)[0]

    # ---- lifecycle --------------------------------------------------------

    def get_stats(self) -> IndexStats:
        count = (sum(s.get_stats().count for s in self._subs)
                 + sum(1 for i in self._buf_ids if i is not None))
        return IndexStats(count=count, dim=self.dim, metric=self.metric)

    def memory_bytes(self) -> dict:
        """Graph bytes on the devices (slab, norms, adjacency, alive): the
        total, each shard's, and the largest shard's (the per-device
        bound of the scaling contract)."""
        per = []
        for sub in self._subs:
            g = sub._dev if sub._dev is not None and not sub._dirty else None
            per.append(0 if g is None else sum(
                g[k].numel() * g[k].element_size()
                for k in ("x", "sqnorm", "adj0", "adj_up", "alive")))
        if not any(per):
            return {}
        return {"graph_total": sum(per), "graph_per_device": max(per),
                "graph_per_shard": per}

    def snapshot(self, path: str) -> None:
        """A manifest (``pyrope_tpu.sharded_hnsw.v1``) + one sub-graph
        snapshot a shard (``<path>.shard<s>.npz``), the JAX package's
        files."""
        for s, sub in enumerate(self._subs):
            sub.snapshot(f"{path}.shard{s}.npz")
        meta = {"format": SNAPSHOT_FORMAT, "ndev": self._ndev, "dim": self.dim,
                "metric": self.metric.value, "owner": self._owner}
        with open(path, "w") as f:
            json.dump(meta, f)

    def load(self, path: str) -> None:
        with open(path) as f:
            meta = json.load(f)
        shards = []
        for s in range(int(meta.get("ndev", 0))):
            with np.load(f"{path}.shard{s}.npz", allow_pickle=False) as z:
                shards.append({k: z[k] for k in z.files})
        self._restore(meta, shards)

    def _restore(self, meta: dict, shards: list) -> None:
        """Adopt ``pyrope_tpu.sharded_hnsw.v1`` state: the manifest and each
        shard's ``pyrope_tpu.hnsw.v1`` arrays (a snapshot's, or the JAX
        package's carried across, see convert.py)."""
        if meta.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(f"bad snapshot format: {meta.get('format')}")
        if int(meta["ndev"]) != self._ndev:
            raise ValueError(f"snapshot mesh size {meta['ndev']} != mesh {self._ndev}")
        self.metric = Metric.parse(meta["metric"])
        self._subs = []
        for s, arrays in enumerate(shards):
            sub = self._new_sub(s)
            sub._restore(arrays)
            self._subs.append(sub)
        self._owner = {k: int(v) for k, v in meta["owner"].items()}
        self._buf_ids, self._buf_vecs, self._buf_pos = [], [], {}
