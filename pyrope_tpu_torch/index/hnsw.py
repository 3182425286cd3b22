"""HNSW graph index: host-built hierarchy, batched beam search on the device
(port of ``pyrope_tpu/index/hnsw.py``).

Rebuild of the reference's ``HnswVectorIndex``
(ref: src/Pyrope.GarnetServer/Vector/HnswVectorIndex.cs):

- params m (16), ef_construction (200), ef_search (10, mutable) (:30-40)
- geometric level generation λ = 1/ln(m) (:351-357)
- insert: greedy descent through upper layers (:106-134), then
  SearchLayer(ef_construction) + link + prune to M (2M at layer 0) (:141-162)
- ``SelectNeighbors`` = closest-M, or the diversity heuristic (default)
- cosine vectors normalized at insert (:69-85) and queries at search (:212-219)
- delete = tombstone only; the node keeps routing (:187-204)
- Snapshot/Load in the JAX package's ``pyrope_tpu.hnsw.v1`` format

The host insert path is numpy, as in the JAX package; bulk builds go
through the native C++ builder (``native/``) or the device bootstrap
(``ops/hnsw_bootstrap.py``). Queries run a **batched beam search** in plain
torch on the device (``beam_search_body``): each step expands the top-E
unexpanded pool entries, gathers their adjacency rows, masks
visited/duplicate/invalid candidates, scores E·2M candidates a query in one
gathered product, and merges into the pool with a top-k.

Every top-k here is ``ops/topk.stable_topk`` (ties to the lower index, as
``lax.top_k``): the pool-mode dedup's exactness rests on that order.
"""

from __future__ import annotations

import heapq
import json
import math
from typing import Iterator, Optional

import numpy as np
import torch

from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.index.base import VectorIndex
from pyrope_tpu_torch.index.flat import read_meta
from pyrope_tpu_torch.native import hnsw_build_native
from pyrope_tpu_torch.ops.distance import check_fp32_exact
from pyrope_tpu_torch.ops.hnsw_bootstrap import bootstrap_build
from pyrope_tpu_torch.ops.kmeans import kmeans_build
from pyrope_tpu_torch.ops.topk import NEG_INF, stable_topk
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import batch_bucket, round_up

FORMAT = "pyrope_tpu.hnsw.v1"
DEFAULT_M = 16            # ref :30-40
DEFAULT_EF_CONSTRUCTION = 200
DEFAULT_EF_SEARCH = 10
UPPER_GREEDY_STEPS = 16   # step cap per upper level
EXPAND_PER_STEP = 8       # E: pool entries expanded per beam step
DESCENT_BEAM = 8          # T: frontier width of the upper-layer descent


def beam_schedule(ef: int, top_k: int) -> tuple[int, int]:
    """(pool, steps) for the batched beam at a given ef/k, as in the JAX
    package: steps = ceil(pool/E) + 8 lets the frontier drain plus slack."""
    pool = int(round_up(max(ef, top_k, EXPAND_PER_STEP), 8))
    steps = max(4, -(-pool // EXPAND_PER_STEP) + 8)
    return pool, steps


def beam_search_body(
    x, x_exact, sqnorm, adj0, adj_up, alive, entry: int, q,
    *, metric: Metric, k: int, pool: int, steps: int, n_upper: int,
    visited_mode: str = "pool", rerank: bool = False, counts: Optional[dict] = None,
):
    """Batched beam search (greedy upper descent + layer-0 beam) on tensors
    of one device. Returns (scores [B, k] fp32, node rows [B, k] int32);
    -inf / -1 mark missing hits.

    ``x`` is the beam slab (fp32 or bf16; a bf16 product's operands are
    exact in fp32, so its scores are fp32 sums of bf16 values), ``x_exact``
    the fp32 slab that re-scores the final pool when ``rerank``. Exact fp32
    products throughout: no TF32 (``check_fp32_exact``).

    Loops. The JAX package runs both loops as ``lax.while_loop``s that stop
    at a fixed point: the upper descent when a step leaves every query's
    frontier unchanged, the layer-0 beam when no query holds a live
    unexpanded pool entry; ``UPPER_GREEDY_STEPS`` and ``steps`` are the
    caps. A step at the fixed point returns its input, so the result is
    the fixed-count loops'. Torch has no device-side loop: each step's exit
    test is read on the host (one sync a step). Running every step to the
    caps with no sync gives the same ids and was slower on the card at b1
    and b256 on the 1M graph (PERF.md).

    ``visited_mode``: 'pool' drops a candidate already in the CURRENT pool
    (exactly the bitmap's result: an evicted node scored <= the monotone
    k-th bound, and ties keep the incumbent because pool entries precede
    candidates in the top-k); 'bitmap' keeps a [B, N] visited map (one
    extra sink column takes the writes of invalid candidates).

    ``counts``: when given, the steps this batch ran are added to its
    ``"upper"`` and ``"layer0"`` entries (each step gathers every query's
    frontier or expansions, whether or not that query has converged)."""
    b, d = q.shape
    dev = q.device
    qf = q.float()
    check_fp32_exact(qf)
    qq = (qf * qf).sum(-1)
    qb = qf.to(x.dtype).float()  # beam-dtype query, fp32 sums

    def node_scores(ids):
        """ids [B, C] -> scores [B, C]; -inf for id < 0."""
        safe = ids.clamp(min=0)
        vecs = x.index_select(0, safe.reshape(-1)).view(b, -1, d).float()
        dots = torch.bmm(vecs, qb[:, :, None])[..., 0]
        if metric == Metric.L2:
            sq = sqnorm.index_select(0, safe.reshape(-1)).view(safe.shape)
            s = -torch.clamp(qq[:, None] - 2.0 * dots + sq, min=0.0)
        else:  # IP; cosine rows are pre-normalized so dots == cosine
            s = dots
        return torch.where(ids >= 0, s, NEG_INF)

    def dedup_sorted(ids, s):
        """ids sorted ascending (stable), duplicates and -1 scored -inf."""
        order = torch.argsort(ids, dim=1, stable=True)
        sid, ss = ids.gather(1, order), s.gather(1, order)
        dup = torch.zeros_like(sid, dtype=torch.bool)
        dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
        return sid, torch.where(dup | (sid < 0), NEG_INF, ss)

    # ---- upper-layer descent (ref :229-247), a width-T frontier ----------
    t_beam = DESCENT_BEAM
    fr = torch.full((b, t_beam), entry, dtype=torch.int32, device=dev)
    fr_s = node_scores(fr)
    fr_s[:, 1:] = NEG_INF  # one live copy of the entry
    for lev in range(n_upper - 1, -1, -1):
        adj = adj_up[lev]
        for _ in range(UPPER_GREEDY_STEPS):
            nbrs = adj.index_select(0, fr.clamp(min=0).reshape(-1)).view(b, t_beam, -1)
            nbrs = torch.where(torch.isfinite(fr_s)[:, :, None], nbrs, -1).reshape(b, -1)
            sid, ss = dedup_sorted(torch.cat([fr, nbrs], 1),
                                   torch.cat([fr_s, node_scores(nbrs)], 1))
            nfr_s, pos = stable_topk(ss, t_beam)
            nfr = torch.where(torch.isfinite(nfr_s), sid.gather(1, pos), -1)
            moved = (nfr != fr).any()
            fr, fr_s = nfr, nfr_s
            if counts is not None:
                counts["upper"] = counts.get("upper", 0) + 1
            if not bool(moved):
                break

    # ---- layer-0 batched beam (replaces sequential SearchLayer) ----------
    deg = adj0.shape[1]
    c = EXPAND_PER_STEP * deg
    n_nodes = x.shape[0]
    pool_ids = torch.full((b, pool), -1, dtype=torch.int32, device=dev)
    pool_s = torch.full((b, pool), NEG_INF, dtype=torch.float32, device=dev)
    expanded = torch.zeros((b, pool), dtype=torch.bool, device=dev)
    pool_ids[:, :t_beam] = torch.where(torch.isfinite(fr_s), fr, -1)
    pool_s[:, :t_beam] = fr_s
    use_bitmap = visited_mode == "bitmap"
    if use_bitmap:
        visited = torch.zeros((b, n_nodes + 1), dtype=torch.bool, device=dev)
        visited.scatter_(1, torch.where(torch.isfinite(fr_s), fr, n_nodes).long(), True)
    iota_pool = torch.arange(pool, device=dev)[None, None, :]
    tri = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)[None]
    no_exp = torch.zeros((b, c), dtype=torch.bool, device=dev)

    for _ in range(steps):
        if not bool(((~expanded) & (pool_ids >= 0)).any()):
            break  # fixed point: every further step expands nothing
        if counts is not None:
            counts["layer0"] = counts.get("layer0", 0) + 1
        unexp = torch.where((~expanded) & (pool_ids >= 0), pool_s, NEG_INF)
        top_vals, pos = stable_topk(unexp, EXPAND_PER_STEP)
        valid_e = torch.isfinite(top_vals)
        hit = (pos[:, :, None] == iota_pool) & valid_e[:, :, None]
        expanded = expanded | hit.any(1)

        eids = pool_ids.gather(1, pos)
        nbrs = adj0.index_select(0, eids.clamp(min=0).reshape(-1)).view(b, -1, deg)
        nbrs = torch.where(valid_e[:, :, None], nbrs, -1).reshape(b, c)

        # within-step duplicates: keep the first occurrence only
        dup = ((nbrs[:, :, None] == nbrs[:, None, :]) & tri).any(2)
        invalid = nbrs < 0
        if use_bitmap:
            safe = nbrs.clamp(min=0).long()
            pre_seen = visited.gather(1, safe)
            visited.scatter_(1, torch.where(invalid, n_nodes, safe), True)
        else:
            pre_seen = (nbrs[:, :, None] == pool_ids[:, None, :]).any(2)
        s = torch.where(pre_seen | dup | invalid, NEG_INF, node_scores(nbrs))

        pool_s, sel = stable_topk(torch.cat([pool_s, s], 1), pool)
        pool_ids = torch.cat([pool_ids, nbrs], 1).gather(1, sel)
        expanded = torch.cat([expanded, no_exp], 1).gather(1, sel)
        pool_ids = torch.where(torch.isfinite(pool_s), pool_ids, -1)

    if rerank:
        # exact fp32 re-score of the surviving pool: beam membership may
        # carry beam-dtype rounding, the returned order and scores not
        safe = pool_ids.clamp(min=0)
        vecs = x_exact.index_select(0, safe.reshape(-1)).view(b, pool, d)
        dots = torch.bmm(vecs, qf[:, :, None])[..., 0]
        if metric == Metric.L2:
            sq = sqnorm.index_select(0, safe.reshape(-1)).view(safe.shape)
            exact = -torch.clamp(qq[:, None] - 2.0 * dots + sq, min=0.0)
        else:
            exact = dots
        pool_s = torch.where((pool_ids >= 0) & torch.isfinite(pool_s), exact, NEG_INF)

    # final: drop tombstones, take top-k (ref tombstone filter :187-204)
    ok = (pool_ids >= 0) & alive.index_select(0, pool_ids.clamp(min=0).reshape(-1)).view(b, pool)
    vals, sel = stable_topk(torch.where(ok, pool_s, NEG_INF), k)
    ids = torch.where(torch.isfinite(vals), pool_ids.gather(1, sel), -1)
    return vals, ids


class HnswIndex(VectorIndex):
    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        device="cuda",
        m: int = DEFAULT_M,
        ef_construction: int = DEFAULT_EF_CONSTRUCTION,
        ef_search: int = DEFAULT_EF_SEARCH,
        seed: int = 42,
        neighbor_heuristic: bool = True,
        build_mode: str = "auto",
        visited_mode: str = "pool",
        search_dtype: str = "float32",
    ):
        """As the JAX package's HnswIndex, on ``device`` (the card unless the
        caller asks for the CPU).

        ``neighbor_heuristic``: diversity-heuristic neighbor selection (HNSW
        paper Alg. 4) instead of the reference's closest-M.
        ``build_mode``: the bulk path of ``add_batch`` into an empty index:
        'incremental' = the native C++ builder (the reference's insert
        algorithm), 'bootstrap' = ops/hnsw_bootstrap.py on the device,
        'auto' = bootstrap at n >= 200k. Bootstrap requires
        ``neighbor_heuristic`` (it is the selection rule).
        ``search_dtype``: 'float32', or 'bfloat16' (a bf16 beam slab, the
        final pool re-scored from the fp32 slab)."""
        if build_mode not in ("auto", "incremental", "bootstrap"):
            raise ValueError(
                f"build_mode must be auto|incremental|bootstrap, got {build_mode!r}"
            )
        if visited_mode not in ("pool", "bitmap"):
            raise ValueError(
                f"visited_mode must be pool|bitmap, got {visited_mode!r}"
            )
        if search_dtype not in ("bfloat16", "float32"):
            raise ValueError(
                f"search_dtype must be bfloat16|float32, got {search_dtype!r}"
            )
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.device = resolve_device(device)
        self.m = int(m)
        self.ef_construction = int(ef_construction)
        self.ef_search = int(ef_search)  # mutable, ref :30-40
        self.neighbor_heuristic = bool(neighbor_heuristic)
        self.build_mode = build_mode
        self.visited_mode = visited_mode
        self.search_dtype = search_dtype
        self._ml = 1.0 / math.log(self.m)  # λ = 1/ln(m), ref :351-357
        self._rng = np.random.default_rng(seed)

        cap = 1024
        self._vecs = np.zeros((cap, self.dim), np.float32)
        self._alive = np.zeros(cap, bool)
        self._levels = np.full(cap, -1, np.int32)
        self._adj0 = np.full((cap, 2 * self.m), -1, np.int32)
        self._adj_up: list[np.ndarray] = []   # per level >= 1: [cap, M]
        self._row_ids: list[Optional[str]] = [None] * cap
        self._id_to_row: dict[str, int] = {}
        self._count = 0
        self._live = 0
        self._entry = -1
        self._top_level = -1
        self._dirty = True
        self._dev: Optional[dict] = None

    # ---- host-side scoring (higher = better) ----------------------------

    def _prep(self, v: np.ndarray) -> np.ndarray:
        v = np.asarray(v, np.float32).reshape(-1)
        if v.shape[0] != self.dim:
            raise ValueError(f"dim mismatch: expected {self.dim}, got {v.shape[0]}")
        if self.metric == Metric.COSINE:  # normalize at insert (ref :69-85)
            n = np.linalg.norm(v)
            if n > 1e-12:
                v = v / n
        return v

    def _scores(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        vecs = self._vecs[rows]
        dots = vecs @ q
        if self.metric == Metric.L2:
            return -np.maximum(((q * q).sum() - 2 * dots + (vecs * vecs).sum(1)), 0.0)
        return dots  # IP / normalized cosine

    # ---- capacity -------------------------------------------------------

    def _grow(self, need: int) -> None:
        cap = self._vecs.shape[0]
        if need <= cap:
            return
        new_cap = max(need, cap * 2)

        def pad2(a, fill):
            out = np.full((new_cap,) + a.shape[1:], fill, a.dtype)
            out[:cap] = a
            return out

        self._vecs = pad2(self._vecs, 0)
        self._alive = pad2(self._alive, False)
        self._levels = pad2(self._levels, -1)
        self._adj0 = pad2(self._adj0, -1)
        self._adj_up = [pad2(a, -1) for a in self._adj_up]
        self._row_ids.extend([None] * (new_cap - cap))
        self._dev = None

    def _adj_at(self, level: int) -> np.ndarray:
        if level == 0:
            return self._adj0
        while len(self._adj_up) < level:
            self._adj_up.append(
                np.full((self._vecs.shape[0], self.m), -1, np.int32)
            )
        return self._adj_up[level - 1]

    # ---- host search-layer (build only; ref SearchLayer :281-325) --------

    def _search_layer_host(
        self, q: np.ndarray, entries: list[int], ef: int, level: int
    ) -> list[tuple[float, int]]:
        adj = self._adj_at(level)
        visited = set(entries)
        escore = {e: float(self._scores(q, np.array([e]))[0]) for e in entries}
        cand = [(-escore[e], e) for e in entries]   # max-heap by score
        heapq.heapify(cand)
        w = [(escore[e], e) for e in entries]        # min-heap: worst first
        heapq.heapify(w)
        while len(w) > ef:
            heapq.heappop(w)
        while cand:
            negs, c = heapq.heappop(cand)
            if len(w) >= ef and -negs < w[0][0]:
                break
            nbrs = [n for n in adj[c] if n >= 0 and n not in visited]
            if not nbrs:
                continue
            visited.update(nbrs)
            ss = self._scores(q, np.array(nbrs))
            for n, sn in zip(nbrs, ss):
                sn = float(sn)
                if len(w) < ef or sn > w[0][0]:
                    heapq.heappush(w, (sn, int(n)))
                    heapq.heappush(cand, (-sn, int(n)))
                    if len(w) > ef:
                        heapq.heappop(w)
        return sorted(w, reverse=True)  # [(score, node)] best first

    def _greedy_descent_host(self, q: np.ndarray, start: int, level: int) -> int:
        cur = start
        cur_s = float(self._scores(q, np.array([cur]))[0])
        adj = self._adj_at(level)
        while True:
            nbrs = adj[cur]
            nbrs = nbrs[nbrs >= 0]
            if nbrs.size == 0:
                return cur
            ss = self._scores(q, nbrs)
            bi = int(np.argmax(ss))
            if ss[bi] <= cur_s:
                return cur
            cur, cur_s = int(nbrs[bi]), float(ss[bi])

    def _select_neighbors(self, cands: np.ndarray,
                          scores: np.ndarray, m_out: int) -> np.ndarray:
        """Neighbor selection from best-first (cands, scores): diversity
        heuristic (default) or the reference's closest-M. Mirrors the
        native builder's select_heuristic exactly."""
        order = np.argsort(-scores)
        cands, scores = cands[order], scores[order]
        if not self.neighbor_heuristic:
            return cands[:m_out]
        kept: list[int] = []
        rejected: list[int] = []
        for e, s in zip(cands, scores):
            if len(kept) >= m_out:
                break
            ek = self._scores(self._vecs[int(e)], np.asarray(kept, np.int64)) if kept else None
            if ek is None or not (ek > s).any():
                kept.append(int(e))
            else:
                rejected.append(int(e))
        for e in rejected:  # keepPrunedConnections backfill
            if len(kept) >= m_out:
                break
            kept.append(e)
        return np.asarray(kept, dtype=cands.dtype)

    def _link(self, a: int, b: int, level: int) -> None:
        """Add b to a's neighbor list, pruning to max-degree when full
        (ref link+prune :141-162) with ``_select_neighbors``."""
        adj = self._adj_at(level)
        row = adj[a]
        slot = np.where(row < 0)[0]
        if slot.size:
            row[slot[0]] = b
            return
        cands = np.append(row, b)
        ss = self._scores(self._vecs[a], cands)
        keep = self._select_neighbors(cands, ss, row.shape[0])
        adj[a][:] = -1
        adj[a][: keep.shape[0]] = keep

    # ---- mutation --------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        with self.lock:
            return self._add_locked(id, vector)

    def _add_locked(self, id: str, vector: np.ndarray) -> bool:
        row = self._id_to_row.get(id)
        if row is not None and self._alive[row]:
            return False
        v = self._prep(vector)
        if row is not None:  # revive tombstone in place, keep links
            self._vecs[row] = v
            self._alive[row] = True
            self._live += 1
            self._dirty = True
            return True
        self._grow(self._count + 1)
        row = self._count
        self._count += 1
        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._vecs[row] = v
        self._alive[row] = True
        self._levels[row] = level
        self._row_ids[row] = id
        self._id_to_row[id] = row
        self._live += 1
        self._dirty = True

        if self._entry < 0:
            self._entry = row
            self._top_level = level
            self._adj_at(level)  # materialize layers
            return True

        cur = self._entry
        for lev in range(self._top_level, level, -1):
            cur = self._greedy_descent_host(v, cur, lev)
        for lev in range(min(level, self._top_level), -1, -1):
            w = self._search_layer_host(v, [cur], self.ef_construction, lev)
            wc = np.asarray([n for _, n in w], np.int64)
            wsc = np.asarray([s for s, _ in w], np.float32)
            neighbors = (
                [int(x) for x in self._select_neighbors(wc, wsc, self.m)]
                if wc.size else []
            )
            adj = self._adj_at(lev)
            for n in neighbors:
                if n == row:
                    continue
                slot = np.where(adj[row] < 0)[0]
                if slot.size:
                    adj[row][slot[0]] = n
                self._link(n, row, lev)
            cur = w[0][1] if w else cur
        if level > self._top_level:
            self._entry = row
            self._top_level = level
            self._adj_at(level)
        return True

    def add_batch(self, ids, vectors) -> int:
        """Bulk build into an empty index with new, distinct ids: the whole
        graph from the native C++ builder or the device bootstrap
        (``build_mode``). Otherwise per-row adds."""
        with self.lock:
            return self._add_batch_locked(ids, vectors)

    def _add_batch_locked(self, ids, vectors) -> int:
        vecs = np.asarray(vectors, np.float32)
        if (
            self._count > 0
            or vecs.ndim != 2
            or vecs.shape[1] != self.dim
            or len(set(ids)) != len(ids)
        ):
            return super().add_batch(ids, vecs)

        n = vecs.shape[0]
        if self.metric == Metric.COSINE:
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(norms > 1e-12, vecs / np.maximum(norms, 1e-12), vecs)
        # same geometric level draw as add() (ref :351-357)
        u = np.maximum(self._rng.random(n), 1e-12)
        levels = (-np.log(u) * self._ml).astype(np.int32)

        use_bootstrap = self.neighbor_heuristic and (
            self.build_mode == "bootstrap"
            or (self.build_mode == "auto" and n >= 200_000)
        )
        if use_bootstrap:
            adj0, adj_up, entry, top_level, levels = bootstrap_build(
                vecs, levels, self.m, self.metric, device=self.device,
            )
        else:
            adj0, adj_up, entry, top_level = hnsw_build_native(
                vecs, levels, self.m, self.ef_construction,
                metric_is_l2=(self.metric == Metric.L2),
                heuristic=self.neighbor_heuristic,
            )
        self._grow(n)
        self._vecs[:n] = vecs
        self._alive[:n] = True
        self._levels[:n] = levels
        self._adj0[:n] = adj0
        cap = self._vecs.shape[0]
        self._adj_up = []
        for lev in range(adj_up.shape[0]):
            a = np.full((cap, self.m), -1, np.int32)
            a[:n] = adj_up[lev]
            self._adj_up.append(a)
        for row, i in enumerate(ids):
            self._row_ids[row] = i
            self._id_to_row[i] = row
        self._count = n
        self._live = n
        self._entry = entry
        self._top_level = top_level
        self._dirty = True
        return n

    def relabel(self, order: str = "cluster", seed: int = 0) -> None:
        """Permute node rows for gather locality. Results are invariant
        (ids, scores and tie order: the graph is isomorphic and the ids move
        with the rows). Orders: 'cluster' (k-means cell-major, 128 cells,
        seed 42), 'bfs' (breadth-first from the entry over layer 0),
        'random' (a control arm)."""
        with self.lock:
            n = self._count
            if n <= 1:
                return
            if order == "cluster":
                metric = (Metric.L2 if self.metric == Metric.COSINE
                          else self.metric)
                kc = max(2, min(128, n // 64))
                _, assign, _ = kmeans_build(
                    self._vecs[:n], kc, metric, device=self.device, seed=42)
                new_of_old = np.argsort(np.argsort(assign, kind="stable"))
            elif order == "bfs":
                from collections import deque

                adj = self._adj0[:n]
                seen = np.zeros(n, bool)
                out = []
                for start in ([max(self._entry, 0)] + list(range(n))):
                    if seen[start]:
                        continue
                    dq = deque([start])
                    seen[start] = True
                    while dq:
                        c = dq.popleft()
                        out.append(c)
                        for nb in adj[c]:
                            if nb >= 0 and nb < n and not seen[nb]:
                                seen[nb] = True
                                dq.append(nb)
                new_of_old = np.empty(n, np.int64)
                new_of_old[np.array(out)] = np.arange(n)
            elif order == "random":
                new_of_old = np.random.default_rng(seed).permutation(n)
            else:
                raise ValueError(f"order must be cluster|bfs|random, got {order!r}")
            old_of_new = np.argsort(new_of_old)

            def remap_vals(a):
                out = np.where(a >= 0, new_of_old[np.maximum(a, 0)], -1)
                return out.astype(np.int32)

            cap = self._vecs.shape[0]
            for name in ("_vecs", "_alive", "_levels"):
                arr = getattr(self, name)
                arr[:n] = arr[:n][old_of_new]
            self._adj0[:n] = remap_vals(self._adj0[:n][old_of_new])
            for a in self._adj_up:
                a[:n] = remap_vals(a[:n][old_of_new])
            ids = [self._row_ids[int(r)] for r in old_of_new]
            for new, rid in enumerate(ids):
                self._row_ids[new] = rid
                if rid is not None:
                    self._id_to_row[rid] = new
            for r in range(n, cap):
                self._row_ids[r] = None
            if self._entry >= 0:
                self._entry = int(new_of_old[self._entry])
            self._dirty = True

    def upsert(self, id: str, vector: np.ndarray) -> None:
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None:
                self._add_locked(id, vector)
                return
            if not self._alive[row]:
                self._live += 1
            self._vecs[row] = self._prep(vector)  # in-place update, links kept
            self._alive[row] = True
            self._dirty = True

    def delete(self, id: str) -> bool:
        with self.lock:
            row = self._id_to_row.get(id)
            if row is None or not self._alive[row]:
                return False
            self._alive[row] = False  # tombstone only (ref :187-204)
            self._live -= 1
            self._dirty = True
            return True

    # ---- device sync + query ---------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        n = max(self._count, 1)
        npad = round_up(n, 8)
        x = np.zeros((npad, self.dim), np.float32)
        x[: self._count] = self._vecs[: self._count]
        sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
        adj0 = np.full((npad, 2 * self.m), -1, np.int32)
        adj0[: self._count] = self._adj0[: self._count]
        alive = np.zeros(npad, bool)
        alive[: self._count] = self._alive[: self._count]
        n_upper = len(self._adj_up)
        up = np.full((max(n_upper, 1), npad, self.m), -1, np.int32)  # [1]: unused
        for i, a in enumerate(self._adj_up):
            up[i, : self._count] = a[: self._count]
        to_dev = lambda a: torch.from_numpy(a).to(self.device)
        x_exact = to_dev(x)
        self._dev = {
            # beam slab: bf16 halves the gather bytes of the walk; the fp32
            # slab stays resident for the final-pool rerank
            "x": x_exact.bfloat16() if self.search_dtype == "bfloat16" else x_exact,
            "x_exact": x_exact,
            "sqnorm": to_dev(sq),
            "adj0": to_dev(adj0),
            "adj_up": to_dev(up),
            "alive": to_dev(alive),
            "n_upper": n_upper,
        }
        self._dirty = False
        return self._dev

    def _search_metric(self) -> Metric:
        return Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric

    def _beam(self, q: torch.Tensor, top_k: int, options: SearchOptions):
        pool, steps = beam_schedule(options.ef_search or self.ef_search, top_k)
        dev = self._sync()
        return beam_search_body(
            dev["x"], dev["x_exact"], dev["sqnorm"], dev["adj0"], dev["adj_up"],
            dev["alive"], self._entry, q, metric=self._search_metric(), k=top_k,
            pool=pool, steps=steps, n_upper=dev["n_upper"],
            visited_mode=self.visited_mode,
            rerank=self.search_dtype == "bfloat16",
        )

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Beam search of q [B, D] on the index's device (pre-normalized for
        COSINE). Returns device (scores [B, k], node rows [B, k])."""
        if self._count == 0 or self._entry < 0:
            raise RuntimeError("device_search on empty index")
        return self._beam(q, top_k, options)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
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
        if self._count == 0 or self._entry < 0:
            return [[] for _ in range(q.shape[0])]
        if self.metric == Metric.COSINE:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = q / np.maximum(norms, 1e-12)
        b = q.shape[0]
        bb = batch_bucket(b)
        qp = np.pad(q, ((0, bb - b), (0, 0))) if bb != b else q
        vals, rows = self._beam(torch.from_numpy(np.ascontiguousarray(qp)).to(self.device),
                                top_k, options)
        vals = vals[:b].cpu().numpy()
        rows = rows[:b].cpu().numpy()
        out: list[list[SearchResult]] = []
        for bi in range(b):
            hits = []
            for v, r in zip(vals[bi], rows[bi]):
                if r < 0 or not np.isfinite(v):
                    continue
                rid = self._row_ids[int(r)]
                if rid is not None:
                    hits.append(SearchResult(rid, float(v)))
            out.append(hits)
        return out

    # ---- lifecycle --------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        for row in range(self._count):
            if self._alive[row] and self._row_ids[row] is not None:
                yield self._row_ids[row], self._vecs[row].copy()

    def get_stats(self) -> IndexStats:
        return IndexStats(count=self._live, dim=self.dim, metric=self.metric)

    def _arrays(self) -> dict:
        """The ``pyrope_tpu.hnsw.v1`` state as arrays (what ``snapshot``
        writes and ``_restore`` reads)."""
        n = self._count
        meta = json.dumps({
            "format": FORMAT,
            "dim": self.dim,
            "metric": self.metric.value,
            "m": self.m,
            "ef_construction": self.ef_construction,
            "ef_search": self.ef_search,
            "neighbor_heuristic": self.neighbor_heuristic,
            "entry": self._entry,
            "top_level": self._top_level,
            "count": n,
        })
        return dict(
            meta=np.str_(meta),
            vecs=self._vecs[:n],
            alive=self._alive[:n],
            levels=self._levels[:n],
            adj0=self._adj0[:n],
            adj_up=(np.stack([a[:n] for a in self._adj_up]) if self._adj_up
                    else np.zeros((0, n, self.m), np.int32)),
            ids=np.array([self._row_ids[r] or "" for r in range(n)], dtype=np.str_),
        )

    def snapshot(self, path: str) -> None:
        """Graph snapshot in the JAX package's ``pyrope_tpu.hnsw.v1`` format."""
        np.savez_compressed(path, **self._arrays())

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._restore(z)

    def _restore(self, arrays) -> None:
        """Adopt ``pyrope_tpu.hnsw.v1`` state: a snapshot's arrays, or the
        JAX package's index state carried across (see convert.py)."""
        with self.lock:
            meta = read_meta(arrays, FORMAT)
            if int(meta["dim"]) != self.dim:
                raise ValueError("snapshot dim mismatch")
            self.metric = Metric.parse(meta["metric"])
            self.m = int(meta["m"])
            self.ef_construction = int(meta["ef_construction"])
            self.ef_search = int(meta["ef_search"])
            self.neighbor_heuristic = bool(meta.get("neighbor_heuristic", True))
            self._ml = 1.0 / math.log(self.m)
            n = int(meta["count"])
            cap = max(1024, round_up(n, 1024))
            self._vecs = np.zeros((cap, self.dim), np.float32)
            self._alive = np.zeros(cap, bool)
            self._levels = np.full(cap, -1, np.int32)
            self._adj0 = np.full((cap, 2 * self.m), -1, np.int32)
            self._vecs[:n] = arrays["vecs"]
            self._alive[:n] = arrays["alive"]
            self._levels[:n] = arrays["levels"]
            self._adj0[:n] = arrays["adj0"]
            up = np.asarray(arrays["adj_up"])
            self._adj_up = []
            for i in range(up.shape[0]):
                a = np.full((cap, self.m), -1, np.int32)
                a[:n] = up[i]
                self._adj_up.append(a)
            ids = [str(s) for s in arrays["ids"]]
            self._row_ids = [i if i else None for i in ids] + [None] * (cap - n)
            self._id_to_row = {i: r for r, i in enumerate(ids) if i}
            self._count = n
            self._live = int(self._alive[:n].sum())
            self._entry = int(meta["entry"])
            self._top_level = int(meta["top_level"])
            self._dirty = True
            self._dev = None
