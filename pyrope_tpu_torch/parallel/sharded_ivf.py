"""Corpus-sharded IVF-Flat (port of ``pyrope_tpu/parallel/sharded_ivf.py``).

Layout: every inverted list's rows are dealt round-robin across the mesh's
``data`` axis (``roundrobin_layout``), so each shard owns ~1/nd of every
list in its own cluster-major slab with a local CSR (offsets, lens); or,
with ``shard_by="cluster"``, whole lists go to shards by greedy LPT
(``cluster_layout``) and a probed list is scanned by its one owner. The
centroids are replicated: every shard ranks probes identically, scans its
local part of the probed lists, and the [B, k] lists merge (mesh.py).
Candidates are encoded ``shard * stride + local slab row`` and decoded on
the host through the per-shard row map.

Routes, by the JAX package's names, on shard-local volumes:
  - ``dense-pallas`` / ``dense-pallas-win``: the list scan kernel
    (``ops/fused_scan.fused_ivf_topk``, csrc/ivf_list_scan.cu) on each
    shard over its own local CSR. The JAX package runs its kernels K2 / K3
    per shard; the port folded both into the one cluster-major list scan,
    so ``-win`` only names a cluster table wider than 512. Full scans only:
    a ``max_scans`` budget takes ``dense-xla``.
  - ``dense-xla``: plain torch, the shard's score matrix masked by probe
    membership and the shard-local budget.
  - ``probe``: plain torch gathers of each probed list's local slice (the
    cluster layout: of the probes the shard owns, compacted into
    ``probe_cap`` slots).
``shard_tile_windows`` (the windowed kernel's per-tile cluster bands) has no
counterpart: the list scan reads the local CSR directly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.flat import to_device
from pyrope_tpu_torch.index.ivf_flat import (
    WINDOWED_ROUTE_KPAD,
    IvfFlatIndex,
    blocked_dense_topk,
    dense_probe_mask,
    pallas_dense_ok,
    pick_scan_mode,
    probe_extents,
    scan_probed_lists,
    top_probes,
)
from pyrope_tpu_torch.ops.distance import row_sqnorms, score_matrix
from pyrope_tpu_torch.ops.fused_scan import fused_ivf_topk, k_refusal
from pyrope_tpu_torch.ops.topk import stable_topk
from pyrope_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    default_mesh,
    encode_rows,
    replicate_shards,
    shard_grid,
    sharded_call,
)
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import batch_bucket, round_up


def roundrobin_layout(lens: np.ndarray, offsets: np.ndarray, nd: int, kpad: int):
    """Deal every list's rows round-robin across nd shards.

    Returns (local_lens [nd, kpad], local_offsets [nd, kpad], l_pad,
    cap_local, placements) where placements is a list of (shard,
    dst_start, global_rows) copy instructions for filling the per-shard
    slabs. cap_local includes an l_pad tail so probe slices never run past
    the slab."""
    k = lens.shape[0]
    local_lens = np.zeros((nd, kpad), np.int32)
    for li in range(k):
        ln = int(lens[li])
        for s in range(nd):
            local_lens[s, li] = (ln - s + nd - 1) // nd if ln > s else 0
    l_pad = int(round_up(max(int(local_lens.max()) if k else 1, 1), 128))
    local_offsets = np.zeros((nd, kpad), np.int32)
    caps = local_lens.sum(axis=1)
    cap_local = int(round_up(int(caps.max()) if k else 1, 8) + l_pad)
    cap_local = int(round_up(cap_local, 4096) if cap_local > 4096
                    else round_up(cap_local, 128))
    placements = []
    cursor = np.zeros(nd, np.int64)
    for li in range(k):
        off = int(offsets[li])
        ln = int(lens[li])
        for s in range(nd):
            rows = np.arange(off + s, off + ln, nd)
            c = int(cursor[s])
            local_offsets[s, li] = c
            if len(rows):
                placements.append((s, c, rows))
            cursor[s] = c + len(rows)
    return local_lens, local_offsets, l_pad, cap_local, placements


def cluster_layout(lens: np.ndarray, offsets: np.ndarray, nd: int, kpad: int):
    """Deal whole CLUSTERS to shards, size-balanced (greedy LPT: largest
    list to the least-loaded shard). Each shard owns ~K/nd complete lists,
    so a probed list is scanned by exactly one shard; probe load then
    depends on the query distribution.

    Returns (local_lens [nd, kpad], local_offsets [nd, kpad], l_pad,
    cap_local, placements, owner [kpad]): roundrobin_layout's contract plus
    the ownership table."""
    k = lens.shape[0]
    owner = np.zeros(kpad, np.int32)
    load = np.zeros(nd, np.int64)
    for li in np.argsort(-lens[:k], kind="stable"):
        s = int(np.argmin(load))
        owner[li] = s
        load[s] += int(lens[li])
    if kpad > k:  # pad clusters (never probed): spread round-robin
        owner[k:] = np.arange(kpad - k) % nd
    local_lens = np.zeros((nd, kpad), np.int32)
    for li in range(k):
        local_lens[owner[li], li] = int(lens[li])
    l_pad = int(round_up(max(int(lens[:k].max()) if k else 1, 1), 128))
    local_offsets = np.zeros((nd, kpad), np.int32)
    caps = local_lens.sum(axis=1)
    cap_local = int(round_up(int(caps.max()) if k else 1, 8) + l_pad)
    cap_local = int(round_up(cap_local, 4096) if cap_local > 4096
                    else round_up(cap_local, 128))
    placements = []
    cursor = np.zeros(nd, np.int64)
    for li in range(k):
        s = int(owner[li])
        off, ln = int(offsets[li]), int(lens[li])
        c = int(cursor[s])
        local_offsets[s, li] = c
        if ln:
            placements.append((s, c, np.arange(off, off + ln)))
        cursor[s] = c + ln
    return local_lens, local_offsets, l_pad, cap_local, placements, owner


def layout_tables(local_lens: np.ndarray, local_offsets: np.ndarray, cap_local: int,
                  placements, kpad: int) -> dict:
    """Host tables of a sharded layout: ``src`` [nd, cap_local] the global
    (permuted) row each local row holds (-1: padding; its ravel is the
    encoded-row map), and the per-shard cluster-of-row ``crow`` and
    within-list ``pos`` (each local slab is cluster-major by
    construction)."""
    nd = local_lens.shape[0]
    src = np.full((nd, cap_local), -1, np.int64)
    for s, c, rows in placements:
        src[s, c : c + len(rows)] = rows
    crow = np.full((nd, cap_local), kpad - 1, np.int32)
    pos = np.zeros((nd, cap_local), np.int32)
    for s in range(nd):
        tot = int(local_lens[s].sum())
        if tot:
            crow[s, :tot] = np.repeat(np.arange(kpad, dtype=np.int32), local_lens[s])
            pos[s, :tot] = np.arange(tot, dtype=np.int32) - local_offsets[s][crow[s, :tot]]
    return {"src": src, "crow": crow, "pos": pos}


def gather_rows(x_all: torch.Tensor, src: np.ndarray, dev: torch.device) -> torch.Tensor:
    """x_all[src] on ``dev``, zero rows where src is -1 (x_all on any
    device: the gather runs there, one copy moves)."""
    idx = torch.from_numpy(np.maximum(src, 0)).to(x_all.device)
    ok = torch.from_numpy(src >= 0).to(x_all.device)
    rows = torch.where(ok[:, None], x_all[idx], torch.zeros((), dtype=x_all.dtype,
                                                            device=x_all.device))
    return rows.to(dev)


def shard_ivf_state(dev: torch.device, s: int, stride: int, t: dict, local_lens,
                    local_offsets, cents, cvalid, alive_rows: np.ndarray) -> dict:
    """One shard's list tables on ``dev``: CSR, crow/pos, alive, the
    replicated centroids, and its encoded-row base."""
    return {
        "offsets": to_device(local_offsets[s], dev),
        "lens": to_device(local_lens[s], dev),
        "crow": to_device(t["crow"][s], dev),
        "pos": to_device(t["pos"][s], dev),
        "alive": to_device(alive_rows, dev),
        "cents": to_device(cents, dev),
        "cvalid": to_device(cvalid, dev),
        "base": s * stride,
    }


def _ivf_sharded(mesh: Mesh, k: int, nprobe: int, probe_metric: Metric,
                 compute: str | None, local):
    """fn(shards, q, ms_local) over the ``data`` axis: every shard holds the
    same centroids, so each batch group ranks its probes once (``prep``)
    and each shard gets them; ``local(s, st, q, probe, ms)`` gives the
    shard's (scores, local rows), encoded by the shard's base and merged."""

    def fn(shards, q, ms):
        def rank(g, qg):
            st = shards[g][0]
            return top_probes(qg, st["cents"], st["cvalid"], nprobe, probe_metric, compute)

        def shard(s, st, qs, probe):
            vals, rows = local(s, st, qs, probe, int(ms))
            return vals, encode_rows(rows, st["base"])
        return sharded_call(mesh, (DATA_AXIS,), shards, q, shard, k, prep=rank)

    return fn


def make_sharded_ivf_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                            l_pad: int, compute: str | None):
    """Probed scan over the round-robin layout: the probes ranked once,
    each shard gathers its slice of every probed list."""

    def local(s, st, q, probe, ms):
        offs_p, eff = probe_extents(probe, st["offsets"], st["lens"], ms)
        return scan_probed_lists(st["xperm"], st["sqnorm"], st["alive"], q, offs_p, eff,
                                 k=k, l_pad=l_pad, metric=metric, cdtype=compute)

    return _ivf_sharded(mesh, k, nprobe, metric, compute, local)


def make_sharded_ivf_cluster_probe_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                                          p_cap: int, l_pad: int, compute: str | None):
    """Probed scan for the CLUSTER layout: the probes ranked once, every
    shard keeps the probes it OWNS, compacts them into ``p_cap`` slots in
    probe-rank order, and scans those full lists from its local slab.
    Owned probes beyond p_cap are dropped (p_cap = nprobe drops none). The
    max_scans budget counts the shard's own scan order."""

    def local(s, st, q, probe, ms):
        owned = st["owner"][probe.long()] == s                      # [B, nprobe]
        rank = torch.arange(nprobe, device=q.device)[None, :]
        sel_score, sel = stable_topk(torch.where(owned, nprobe - rank, -1).float(), p_cap)
        probe_own = torch.gather(probe.long(), 1, sel)
        valid = sel_score > 0
        lens_own = torch.where(valid, st["lens"][probe_own], 0)
        offs_own = torch.where(valid, st["offsets"][probe_own], 0)
        before = torch.cumsum(lens_own, dim=1) - lens_own
        eff = torch.minimum(lens_own, torch.clamp(ms - before, min=0))
        return scan_probed_lists(st["xperm"], st["sqnorm"], st["alive"], q, offs_own, eff,
                                 k=k, l_pad=l_pad, metric=metric, cdtype=compute)

    return _ivf_sharded(mesh, k, nprobe, metric, compute, local)


def make_sharded_ivf_dense_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                                  compute: str | None):
    """Dense plain scan: each shard's score matrix over its own
    cluster-major slab masked by probe membership and the shard-local
    budget (per-shard CSR, crow, pos), walked in query blocks."""

    def local(s, st, q, probe, ms):
        _, eff = probe_extents(probe, st["offsets"], st["lens"], ms)
        kpad = st["cents"].shape[0]
        return blocked_dense_topk(
            q.shape[0], st["xperm"].shape[0],
            lambda a, b: score_matrix(q[a:b], st["xperm"], metric, x_sqnorm=st["sqnorm"],
                                      compute_dtype=compute),
            lambda a, b: dense_probe_mask(probe[a:b], eff[a:b], st["crow"], st["pos"],
                                          st["alive"], kpad),
            k)

    return _ivf_sharded(mesh, k, nprobe, metric, compute, local)


def make_sharded_ivf_dense_pallas_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                                         l_pad: int):
    """Fused dense scan: each shard runs the list scan kernel over its own
    cluster-major slab and local CSR (no [B, cap_local] score matrix), then
    the merge. Full-scan semantics only."""

    def local(s, st, q, probe, ms):
        return fused_ivf_topk(q, st["xperm"], st["sqnorm"], st["alive"], st["crow"],
                              st["offsets"], st["lens"], probe, st["cents"].shape[0], k,
                              metric, max_len=l_pad)

    return _ivf_sharded(mesh, k, nprobe, metric, None, local)


def decode_hits(vals: np.ndarray, enc: np.ndarray, enc_to_perm: np.ndarray,
                perm_ids: list, buf_hits: list, top_k: int) -> list[list[SearchResult]]:
    """Encoded candidates -> SearchResults through the row map, merged with
    the buffer's exact hits."""
    rows = np.where(enc >= 0, enc_to_perm[np.maximum(enc, 0)], -1)
    out: list[list[SearchResult]] = []
    for bi in range(vals.shape[0]):
        hits = list(buf_hits[bi])
        for v, r in zip(vals[bi], rows[bi]):
            if r < 0 or not np.isfinite(v):
                continue
            hits.append(SearchResult(perm_ids[int(r)], float(v)))
        hits.sort(key=lambda h: -h.score)
        out.append(hits[:top_k])
    return out


class ShardedIvfFlatIndex(IvfFlatIndex):
    """IvfFlatIndex whose built slab is list-sliced over the mesh's ``data``
    axis (a 2-D batch x data mesh splits queries over ``batch``). Host API
    and semantics as IvfFlatIndex (buffer, build, options); only the
    built slab's layout and the per-shard scans differ. ``device`` names
    the default mesh's devices when no ``mesh`` is given."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        nlist: int = 100,
        nprobe: int = 3,
        compute_dtype: Optional[str] = None,
        seed: int = 42,
        scan_mode: str = "auto",
        shard_by: str = "rows",       # rows | cluster (see module docstring)
        probe_cap: int | str = "auto",
        device="cuda",
    ):
        """``probe_cap`` bounds the cluster layout's owned-probe slots a
        shard: 'auto' provisions 4x the balanced expectation
        (min(nprobe, max(8, 4*ceil(nprobe/nd)))); owned probes beyond it
        are dropped (recall, not correctness, degrades); nprobe drops
        none."""
        if shard_by not in ("rows", "cluster"):
            raise ValueError(f"shard_by must be rows|cluster, got {shard_by!r}")
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._ndev = int(self.mesh.shape[DATA_AXIS])  # rows deal over DATA only
        self._grid = shard_grid(self.mesh, (DATA_AXIS,))
        self.shard_by = shard_by
        self.probe_cap = probe_cap
        super().__init__(dim, metric, device=self._grid[0, 0], nlist=nlist, nprobe=nprobe,
                         compute_dtype=compute_dtype, seed=seed, scan_mode=scan_mode)

    def _install_device_slab(self, x_dev, order) -> None:
        """The single index's device install does not apply: the sharded
        layout is built by _sync."""
        self._dirty = True
        self._dev = None

    def _layout(self, kpad: int):
        if self.shard_by == "cluster":
            return cluster_layout(self._lens, self._offsets, self._ndev, kpad)
        return (*roundrobin_layout(self._lens, self._offsets, self._ndev, kpad), None)

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        local_lens, local_offsets, l_pad, cap_local, placements, owner = self._layout(kpad)
        t = layout_tables(local_lens, local_offsets, cap_local, placements, kpad)
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True
        x_all = to_device(self._xperm, self.device)  # one upload, gathered per shard
        shards = []
        for s, dev in enumerate(self._grid[0]):
            src = t["src"][s]
            alive = np.where(src >= 0, self._alive[np.maximum(src, 0)], False)
            st = shard_ivf_state(dev, s, cap_local, t, local_lens, local_offsets, cents,
                                 cvalid, alive)
            st["xperm"] = gather_rows(x_all, src, dev)
            st["sqnorm"] = row_sqnorms(st["xperm"])
            if owner is not None:
                st["owner"] = to_device(owner, dev)
            shards.append(st)
        del x_all
        self._dev = {
            "shards": replicate_shards(self._grid, shards),
            "kpad": kpad, "l_pad": l_pad, "stride": cap_local, "k_actual": k,
            "local_lens": local_lens, "owner": owner,
            # decode tables consistent with these shards (a rebuild swaps them)
            "enc_to_perm": t["src"].reshape(-1),
            "perm_ids": self._perm_ids,
        }
        self._dirty = False
        return self._dev

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """q [B, D] on the mesh's first device -> (scores [B, k], encoded
        rows [B, k]) there (``resolve_rows`` decodes them)."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        return self._device_scan(q, top_k, options, q.shape[0])

    def _ms_local(self, dev: dict, max_scans: Optional[int]) -> int:
        """The per-shard budget: uncapped, the local slab; the cluster
        layout applies the full budget per shard in probe order (whole lists
        live on one shard); the row layout divides it (a shard scans 1/nd of
        every list). Both approximate the single index's insertion-order
        semantics, as in the JAX package."""
        if max_scans is None:
            return dev["stride"]
        if self.shard_by == "cluster":
            return max_scans
        return (max_scans + self._ndev - 1) // self._ndev

    def _device_scan(self, q: torch.Tensor, top_k: int, options: SearchOptions,
                     batch: int):
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        path = self._resolve_sharded_scan(dev, batch, nprobe,
                                          options.max_scans is None, top_k)
        if path in ("dense-pallas", "dense-pallas-win"):
            fn = make_sharded_ivf_dense_pallas_search(self.mesh, self.metric, top_k,
                                                      nprobe, dev["l_pad"])
        elif path == "dense-xla":
            fn = make_sharded_ivf_dense_search(self.mesh, self.metric, top_k, nprobe,
                                               self.compute_dtype)
        elif self.shard_by == "cluster":
            fn = make_sharded_ivf_cluster_probe_search(
                self.mesh, self.metric, top_k, nprobe, self._resolve_probe_cap(nprobe),
                dev["l_pad"], self.compute_dtype)
        else:
            fn = make_sharded_ivf_search(self.mesh, self.metric, top_k, nprobe,
                                         dev["l_pad"], self.compute_dtype)
        return fn(dev["shards"], q, self._ms_local(dev, options.max_scans))

    def _resolve_probe_cap(self, nprobe: int) -> int:
        """Owned-probe slots a shard (cluster layout, probe route): an int is
        clamped to [1, nprobe]; 'auto' is 4x the balanced expectation,
        floor 8."""
        if isinstance(self.probe_cap, int):
            return max(1, min(self.probe_cap, nprobe))
        return min(nprobe, max(8, 4 * -(-nprobe // self._ndev)))

    def _resolve_sharded_scan(self, dev: dict, batch: int, nprobe: int, uncapped: bool,
                              top_k: int = 10) -> str:
        """The single index's routing rule on per-shard local volumes (a
        shard scans its own slab; stride ~ its rows): 'probe', 'dense-xla',
        'dense-pallas' or 'dense-pallas-win'. The kernel has full-scan
        semantics, so a max_scans budget takes 'dense-xla', where the
        shard-local budget applies."""
        p_ok = uncapped and pallas_dense_ok(self.selection, self.metric,
                                            self.compute_dtype, dev["stride"], dev["stride"])
        mode = pick_scan_mode(self.scan_mode, dev["stride"], nprobe, dev["l_pad"],
                              batch=batch, pallas_ok=p_ok)
        if mode != "dense":
            return "probe"
        if not p_ok:
            return "dense-xla"
        why = k_refusal(top_k)
        if why is not None:
            raise ValueError(f"the dense kernel route needs the list scan: {why}")
        return "dense-pallas-win" if dev["kpad"] > WINDOWED_ROUTE_KPAD else "dense-pallas"

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None, *, top_k: int = 10) -> str:
        """The sharded route of a (batch, nprobe, max_scans) query; 'buffer'
        before build."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        return self._resolve_sharded_scan(dev, batch, np_eff, max_scans is None, top_k)

    def _decode(self, rows: np.ndarray) -> np.ndarray:
        """Encoded candidates -> global perm rows (-1 stays -1)."""
        enc = self._sync()["enc_to_perm"]
        return np.where(rows >= 0, enc[np.maximum(rows, 0)], -1)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        dec = self._decode(np.asarray(rows))
        return [[self._perm_ids[int(r)] if r >= 0 else "" for r in row] for row in dec]

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
        b = q.shape[0]
        buf_hits = (self._buffer.search_batch(q, top_k, options)
                    if self._buffer.get_stats().count else [[] for _ in range(b)])
        if not self._built or self._main_live == 0:
            return buf_hits
        dev = self._sync()
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        vals, rows = self._device_scan(qt, top_k, options, batch_bucket(b))
        return decode_hits(vals.cpu().numpy(), rows.cpu().numpy(), dev["enc_to_perm"],
                           dev["perm_ids"], buf_hits, top_k)
