"""IVF-Flat index (port of ``pyrope_tpu/index/ivf_flat.py``).

Coarse k-means + exact scans of the probed inverted lists. Pre-build writes
land in a mutable FlatIndex buffer, searched exactly; ``build()`` merges
main + buffer, runs k-means (k = min(nlist, N), seed 42) and permutes the
rows cluster-major into one slab (CSR: offsets + lengths). A query ranks
the centroids, probes the top ``nprobe`` lists and honors the
``max_scans``/``nprobe`` options.

Scan routes, by the same names as the JAX package, so a recorded
``scan_path`` names the code that ran:
  - ``dense-pallas`` / ``dense-pallas-win``: the CUDA list scan
    (ops/fused_scan.fused_ivf_topk): the probe lists inverted on the
    device, each probed cluster's rows scanned once for the queries that
    probe it. The JAX package splits these into its kernels K2 and K3 at
    512 clusters; here both names run the one kernel, and the name still
    follows the cluster-table width.
  - ``dense-pallas-hybrid`` / ``dense-pallas-win-hybrid``
    (``selection="hybrid[:R]"``, at a bucketed batch <= HYBRID_MAX_BATCH):
    the list scan's bf16 mode over a bf16 twin of the slab (``xperm16``)
    keeps each query's top R, and ``rerank_exact`` rescores them off the
    fp32 slab. Larger batches, and R above what the kernel holds, take the
    fp32 list scan: both sides are exact.
  - ``dense-xla``: plain torch, a [B, N] score matrix masked by probe
    membership and the max_scans budget (the JAX package's XLA kernel),
    walked in query blocks of at most DENSE_MAX_ELEMS scores. It also takes
    the dense scans the list scan does not take (k above its MAX_K, or a D
    whose queries overflow its shared memory: ``list_scan_refusal``), where
    the JAX package's kernels answer; the mode (dense or probe) stays the
    JAX package's.
  - ``probe``: plain torch, a gather of each probed list + a running merge.
``compute_dtype`` (e.g. "bfloat16") rounds the search products' operands,
as the JAX package does, and makes the kernel routes ineligible;
``train_dtype`` is the k-means training dtype.

Invariant: an id lives either in the built main slab or in the buffer,
never both (upsert tombstones the main row first), so merges need no dedup.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.base import CentroidsProvider, VectorIndex
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import batch_bucket, round_up
from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.index.flat import (
    HYBRID_MAX_BATCH,
    FlatIndex,
    hybrid_shortlist,
    pick_row_tile,
    read_meta,
    to_device,
)
from pyrope_tpu_torch.ops.distance import rerank_exact, rounded, row_sqnorms, score_matrix
from pyrope_tpu_torch.ops.fused_scan import (
    IVF_MAX_KPAD,
    LIST_BF16,
    LIST_IVF,
    fused_ivf_topk,
    list_scan_refusal,
)
from pyrope_tpu_torch.ops.kmeans import kmeans_build
from pyrope_tpu_torch.ops.topk import masked_topk, merge_topk, parse_selection, stable_topk

DEFAULT_NPROBE = 3

# auto scan-mode thresholds (see pick_scan_mode), as in the JAX package
DENSE_MAX_ROWS = 262_144
DENSE_TILE_B = 256
DENSE_MARGIN = 2
# cap on the plain dense route's [B, npad] transients (scores + mask)
DENSE_MAX_ELEMS = 1 << 28
# cluster-table width above which the route is named 'dense-pallas-win'
# (the JAX package's windowed kernel K3 takes over there)
WINDOWED_ROUTE_KPAD = 512


def pick_scan_mode(
    scan_mode: str, npad: int, nprobe: int, l_pad: int, batch: int = 64,
    pallas_ok: bool = False,
) -> str:
    """Resolve 'auto' to 'dense' or 'probe' by the JAX package's slab
    traffic model: the probe scan reads batch·nprobe·l_pad rows, the dense
    scan npad rows per ~DENSE_TILE_B queries; dense wins unless probe
    traffic is DENSE_MARGIN times smaller. ``pallas_ok``: the fused kernel
    will run, which holds no [B, npad] transient, so the DENSE_MAX_ELEMS
    guard does not apply."""
    if scan_mode != "auto":
        return scan_mode
    if not pallas_ok and batch * npad > DENSE_MAX_ELEMS:
        return "probe"
    if npad <= DENSE_MAX_ROWS:
        return "dense"
    dense_traffic = npad * -(-batch // DENSE_TILE_B)
    if batch * nprobe * l_pad >= DENSE_MARGIN * dense_traffic:
        return "dense"
    return "probe"


def slab_pad(n: int, l_pad: int) -> int:
    """Padded slab length, as in the JAX package: a tail pad so every
    probe slice stays in range, rounded up (extra rows are alive=False)."""
    npad = round_up(n, 8) + l_pad
    return int(round_up(npad, 4096) if npad > 4096 else round_up(npad, 128))


def rank_probes(q, cents, cvalid, offsets, lens, nprobe, max_scans, metric,
                cdtype=None):
    """Rank centroids, pick the top-nprobe lists (ties to the lower id, as
    ``lax.top_k``), and compute each probe's scan length under the
    max_scans budget. ``cdtype``: the ranking product's compute dtype.
    Returns (probe [B, nprobe], offs_p, eff)."""
    cscores = score_matrix(q, cents, metric, compute_dtype=cdtype)
    cscores = torch.where(cvalid[None, :], cscores, float("-inf"))
    _, probe = stable_topk(cscores, nprobe)
    lens_p = lens[probe]
    offs_p = offsets[probe]
    before = torch.cumsum(lens_p, dim=1) - lens_p           # rows scanned earlier
    budget = torch.clamp(max_scans - before, min=0)
    eff = torch.minimum(lens_p, budget)
    return probe, offs_p, eff


def scan_probed_lists(xperm, sqnorm, alive, q, offs_p, eff, *, k: int,
                      l_pad: int, metric: Metric, cdtype=None):
    """Scan every probed list slice with a running top-k merge: each probe
    gathers [B, l_pad] rows from the cluster-major slab and scores them
    against its query (operands rounded to ``cdtype`` when given)."""
    b = q.shape[0]
    qf = q.float()
    qd = rounded(qf, cdtype)
    qq = (qf * qf).sum(dim=-1)
    qn = torch.sqrt(torch.clamp(qq, min=1e-24))
    j = torch.arange(l_pad, device=q.device)
    vals = torch.full((b, k), float("-inf"), device=q.device)
    gidx = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for p in range(offs_p.shape[1]):
        rows = offs_p[:, p : p + 1].long() + j                 # [B, L]
        dots = torch.einsum("bld,bd->bl", rounded(xperm[rows], cdtype), qd)
        sq = sqnorm[rows]
        if metric == Metric.L2:
            scores = -torch.clamp(qq[:, None] - 2.0 * dots + sq, min=0.0)
        elif metric == Metric.INNER_PRODUCT:
            scores = dots
        else:  # COSINE
            xn = torch.sqrt(torch.clamp(sq, min=1e-24))
            scores = dots / torch.clamp(qn[:, None] * xn, min=1e-12)
        mask = (j[None, :] < eff[:, p : p + 1]) & alive[rows]
        svals = torch.where(mask, scores, float("-inf"))
        vals, gidx = merge_topk(vals, gidx, svals, rows, k)
    return vals, gidx


def dense_probe_mask(probe, eff, crow, pos, alive, kpad):
    """[B, N] mask of rows inside a probed list AND inside its max_scans
    budget: scatter eff at the probed list ids, read it back per row
    through the cluster-of-row map, compare with the within-list position."""
    allowed = torch.zeros((probe.shape[0], kpad), dtype=torch.int32,
                          device=probe.device)
    allowed.scatter_(1, probe.long(), eff.int())  # in place on a fresh table
    return (pos[None, :] < allowed[:, crow.long()]) & alive[None, :]


def pallas_dense_ok(selection: str, metric: Metric, compute, ms: int, n: int,
                    kpad: int) -> bool:
    """Eligibility of a dense scan for the kernel, by the JAX package's
    semantic terms: full scan only (no max_scans budget), L2/IP, fp32
    compute, and at most IVF_MAX_KPAD clusters (a routing cap kept from the
    dense-mask kernel; the list scan takes any width). The JAX package's
    tile-divisibility and window terms have no counterpart: the kernel masks
    ragged edges and takes any cluster layout. It also keeps the dense mode
    free of the DENSE_MAX_ELEMS guard (``pick_scan_mode``), as in the JAX
    package. Whether the kernel takes the shape (k, D) is
    ``list_scan_refusal``'s, decided after the mode."""
    if selection == "exact":
        return False
    return (metric != Metric.COSINE and compute is None and ms >= n
            and kpad <= IVF_MAX_KPAD)


def blocked_dense_topk(b: int, n_rows: int, scores_of, mask_of, k: int):
    """masked_topk of ``scores_of(s, e)`` [e-s, N] under ``mask_of(s, e)``,
    over blocks of queries s..e small enough that no [block, N] transient
    holds more than DENSE_MAX_ELEMS elements, whatever the batch."""
    step = max(1, DENSE_MAX_ELEMS // max(n_rows, 1))
    parts = [masked_topk(scores_of(s, min(s + step, b)), mask_of(s, min(s + step, b)), k)
             for s in (range(0, b, step) if b else [0])]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([v for v, _ in parts]), torch.cat([i for _, i in parts])


class IvfFlatIndex(VectorIndex, CentroidsProvider):
    @property
    def host_write_cheap(self) -> bool:  # see VectorIndex
        return self._buffer.host_write_cheap

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        device="cuda",
        nlist: int = 100,
        nprobe: int = DEFAULT_NPROBE,
        compute_dtype: Optional[str] = None,
        seed: int = 42,
        train_dtype: Optional[str] = None,
        scan_mode: str = "auto",
        train_init: str = "kmeans++",  # | "sample"
        selection: str = "auto",       # auto | pallas | exact | hybrid[:R]
    ):
        """As the JAX package's IvfFlatIndex, on ``device`` (the card unless
        the caller asks for the CPU).
        ``selection``: 'auto' routes eligible dense scans through the fused
        kernel, 'pallas' requires it, 'exact' forces the plain dense scan,
        'hybrid[:R]' scans a bf16 twin slab for a top-R shortlist and
        reranks it off the fp32 slab. ``compute_dtype``: the search
        products' dtype (None: exact fp32). ``train_dtype``: k-means
        training's."""
        if scan_mode not in ("auto", "dense", "probe"):
            raise ValueError(f"scan_mode must be auto|dense|probe, got {scan_mode!r}")
        sel = selection.partition(":")[0]
        if sel not in ("auto", "pallas", "exact", "hybrid"):
            raise ValueError(
                f"selection must be auto|pallas|exact|hybrid[:R], got {selection!r}"
            )
        if sel == "hybrid" and compute_dtype is not None:
            raise ValueError("selection='hybrid' reranks in fp32; "
                             "compute_dtype must stay None (fp32)")
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.device = resolve_device(device)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.compute_dtype = compute_dtype
        self.seed = seed
        self.train_dtype = train_dtype
        self.scan_mode = scan_mode
        self.train_init = train_init
        self.selection = selection

        self._buffer = self._new_buffer()
        # built main slab (host truth). The permuted host slab and the
        # id->row dict are materialized lazily from (_xbase, _order):
        # serving needs neither, only snapshot/scan/rebuild/mutation do.
        self._built = False
        self._centroids: Optional[np.ndarray] = None   # [K, D]
        self._xperm_cache: Optional[np.ndarray] = np.zeros((0, self.dim), np.float32)
        self._xbase: Optional[np.ndarray] = None       # unpermuted merged corpus
        self._order: Optional[np.ndarray] = None       # argsort(assign)
        self._main_n = 0
        self._perm_ids: list[str] = []
        self._main_pos_cache: Optional[dict[str, int]] = {}
        self._alive = np.zeros(0, bool)
        self._offsets = np.zeros(0, np.int32)
        self._lens = np.zeros(0, np.int32)
        self._main_live = 0
        self._dirty = True
        self._dev: Optional[dict] = None

    @property
    def _xperm(self) -> np.ndarray:
        """Permuted host slab (cluster-major). Materialized on first use."""
        cache = self._xperm_cache
        if cache is None:
            with self.lock:
                if self._xperm_cache is None:
                    self._xperm_cache = self._xbase[self._order]
                    self._xbase = None
                    self._order = None
                cache = self._xperm_cache
        return cache

    @_xperm.setter
    def _xperm(self, value: np.ndarray) -> None:
        self._xperm_cache = value
        self._xbase = None
        self._order = None
        self._main_n = value.shape[0]

    @property
    def _main_pos(self) -> dict[str, int]:
        """id -> permuted-row dict. Materialized on first mutation/lookup."""
        cache = self._main_pos_cache
        if cache is None:
            with self.lock:
                if self._main_pos_cache is None:
                    self._main_pos_cache = {
                        pid: r for r, pid in enumerate(self._perm_ids)
                    }
                cache = self._main_pos_cache
        return cache

    @_main_pos.setter
    def _main_pos(self, value: dict[str, int]) -> None:
        self._main_pos_cache = value

    def _new_buffer(self) -> FlatIndex:
        return FlatIndex(self.dim, self.metric, device=self.device,
                         compute_dtype=self.compute_dtype)

    # ---- mutation -------------------------------------------------------

    def add(self, id: str, vector: np.ndarray) -> bool:
        with self.lock:
            row = self._main_pos.get(id)
            if row is not None and self._alive[row]:
                return False
            return self._buffer.add(id, vector)

    def upsert(self, id: str, vector: np.ndarray) -> None:
        with self.lock:
            row = self._main_pos.get(id)
            if row is not None and self._alive[row]:
                self._alive[row] = False  # main copy superseded by the buffer's
                self._main_live -= 1
                self._dirty = True
            self._buffer.upsert(id, vector)

    def delete(self, id: str) -> bool:
        with self.lock:
            if self._buffer.delete(id):
                return True
            row = self._main_pos.get(id)
            if row is None or not self._alive[row]:
                return False
            self._alive[row] = False
            self._main_live -= 1
            self._dirty = True
            return True

    def add_batch(self, ids, vectors) -> int:
        if not self._built and not self._main_pos:
            return self._buffer.add_batch(ids, vectors)
        return super().add_batch(ids, vectors)

    # ---- build ----------------------------------------------------------

    def build(self) -> None:
        """Merge main + buffer, retrain k-means, re-bucket."""
        with self.lock:
            self._build_locked()

    def _build_locked(self) -> None:
        ids: list[str] = []
        rows: list[np.ndarray] = []
        main_live_rows = [r for r in range(len(self._perm_ids)) if self._alive[r]]
        if main_live_rows:
            ids.extend(self._perm_ids[r] for r in main_live_rows)
            rows.append(self._xperm[main_live_rows])
        bids, bvecs = self._buffer.live_vectors()
        if bids:
            ids.extend(bids)
            rows.append(bvecs)
        if not ids:
            return
        x = np.concatenate(rows) if len(rows) > 1 else rows[0]
        n = x.shape[0]
        k = min(self.nlist, n)

        # one corpus upload: train + assign reuse one device buffer, and
        # the search slab below is a device-side gather of the same buffer
        cents, assign, x_dev = kmeans_build(
            x, k, self.metric, device=self.device, seed=self.seed,
            compute_dtype=self.train_dtype, init=self.train_init,
        )

        order = np.argsort(assign, kind="stable")
        # defer the host permute + id->row dict: serving needs neither
        self._xperm_cache = None
        self._xbase = x
        self._order = order
        self._main_n = n
        self._perm_ids = [ids[i] for i in order]
        self._main_pos_cache = None
        self._alive = np.ones(n, bool)
        self._lens = np.bincount(assign, minlength=k).astype(np.int32)
        self._offsets = np.concatenate([[0], np.cumsum(self._lens)[:-1]]).astype(np.int32)
        self._centroids = cents[:k]
        self._main_live = n
        self._built = True
        self._buffer = self._new_buffer()
        self._install_device_slab(x_dev, order)

    def get_centroids(self) -> Optional[np.ndarray]:
        return None if self._centroids is None else self._centroids.copy()

    # ---- device state ---------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _host_tables(self) -> dict:
        """Padded centroid/list/alive tables shared by the host-upload sync
        and the device-side build install."""
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        l_pad = int(round_up(max(int(self._lens.max()) if k else 1, 1), 128))
        n = self._main_n
        npad = slab_pad(n, l_pad)
        alive = np.zeros(npad, bool)
        alive[:n] = self._alive
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True
        offs = np.zeros(kpad, np.int32)
        lens = np.zeros(kpad, np.int32)
        offs[:k] = self._offsets
        lens[:k] = self._lens
        # row -> cluster id and row -> within-list position (pad rows point
        # at the last slot; they are alive=False anyway)
        crow = np.full(npad, kpad - 1, np.int32)
        pos = np.zeros(npad, np.int32)
        if n:
            crow[:n] = np.repeat(np.arange(k, dtype=np.int32), self._lens)
            pos[:n] = np.arange(n, dtype=np.int32) - self._offsets[crow[:n]]
        return {
            "k": k, "kpad": kpad, "l_pad": l_pad, "n": n, "npad": npad,
            "alive": alive, "cents": cents, "cvalid": cvalid,
            "offs": offs, "lens": lens, "crow": crow, "pos": pos,
        }

    def _dev_common(self, t: dict) -> dict:
        d = self.device
        return {
            "cents": to_device(t["cents"], d),
            "cvalid": to_device(t["cvalid"], d),
            "alive": to_device(t["alive"], d),
            "offsets": to_device(t["offs"], d),
            "lens": to_device(t["lens"], d),
            "crow": to_device(t["crow"], d),
            "pos": to_device(t["pos"], d),
            "l_pad": t["l_pad"],
            "k_actual": t["k"],
            # the row->id table that matches this slab: build()/load()
            # replace _perm_ids, and a search holding an older dict must
            # still resolve against its own table
            "perm_ids": self._perm_ids,
        }

    def _install_device_slab(self, x_dev: torch.Tensor, order: np.ndarray) -> None:
        """Build the device search slab from the corpus buffer k-means
        already holds, by a device-side permuted gather."""
        from pyrope_tpu_torch.ops.slab import pad_order, take_slab

        t = self._host_tables()
        idx = pad_order(order, t["npad"], x_dev.shape[0], self.device)
        xperm, sqnorm = take_slab(x_dev, idx)
        self._dev = {"xperm": xperm, "sqnorm": sqnorm, **self._dev_common(t)}
        self._add_twin()
        self._dirty = False

    def _add_twin(self) -> None:
        """The hybrid routes' bf16 twin of the slab, cast on the device."""
        if self.selection.partition(":")[0] == "hybrid":
            self._dev["xperm16"] = self._dev["xperm"].bfloat16()

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        t = self._host_tables()
        xperm = torch.zeros((t["npad"], self.dim), dtype=torch.float32,
                            device=self.device)
        xperm[: t["n"]] = to_device(self._xperm, self.device)
        self._dev = {"xperm": xperm, "sqnorm": row_sqnorms(xperm),
                     **self._dev_common(t)}
        self._add_twin()
        self._dirty = False
        return self._dev

    # ---- query ----------------------------------------------------------

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident query over the built main slab only (the buffer
        must be empty: build first). q [B, D] on the index device ->
        (scores [B, k], permuted rows [B, k]) on the device; no host sync."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._main_n
        return self._run_scan(dev, q, top_k, nprobe, ms, q.shape[0])

    def _shortlist(self, dev: dict, top_k: int) -> int:
        """The hybrid routes' R, clamped as the JAX package clamps it."""
        return hybrid_shortlist(top_k, parse_selection(self.selection)[1],
                                pick_row_tile(dev["xperm"].shape[0], self.dim, 4))

    def _resolve_scan(self, dev: dict, batch: int, nprobe: int, ms: int,
                      top_k: int) -> str:
        """(batch, nprobe, max_scans, top_k) -> the route that will run:
        'probe', 'dense-xla', 'dense-pallas[-win]' or
        'dense-pallas[-win]-hybrid'. The single source of routing truth for
        _run_scan and describe_scan. The mode (dense or probe) is the JAX
        package's; which kernel takes a dense scan is decided from shapes."""
        kpad = dev["cents"].shape[0]
        p_ok = pallas_dense_ok(self.selection, self.metric, self.compute_dtype, ms,
                               self._main_n, kpad)
        mode = pick_scan_mode(
            self.scan_mode, dev["xperm"].shape[0], nprobe, dev["l_pad"],
            batch=batch, pallas_ok=p_ok,
        )
        if mode != "dense":
            return "probe"
        if not p_ok:
            return "dense-xla"
        path = "dense-pallas-win" if kpad > WINDOWED_ROUTE_KPAD else "dense-pallas"
        if (self.selection.partition(":")[0] == "hybrid" and batch <= HYBRID_MAX_BATCH
                and list_scan_refusal(self.dim, self._shortlist(dev, top_k),
                                      LIST_BF16) is None):
            return path + "-hybrid"
        if list_scan_refusal(self.dim, top_k, LIST_IVF) is not None:
            return "dense-xla"
        return path

    def _run_scan(self, dev: dict, q: torch.Tensor, top_k: int, nprobe: int,
                  ms: int, batch: int):
        """``batch`` is what routing sees: the bucketed batch for
        search_batch, as in the JAX package, so routes agree with it."""
        path = self._resolve_scan(dev, batch, nprobe, ms, top_k)
        if (self.selection == "pallas" and ms >= self._main_n
                and path in ("probe", "dense-xla")):
            # a max_scans budget (ms < n) takes the plain kernels; anything
            # else under explicit 'pallas' is a config error, never a swap
            why = list_scan_refusal(self.dim, top_k, LIST_IVF)
            raise ValueError(
                "selection='pallas' requires the fused dense kernel but the "
                f"scan resolved to {path!r} (needs dense mode, L2/IP, fp32 "
                f"compute, at most {IVF_MAX_KPAD} clusters"
                + (f"; {why})" if why else ")"))
        probe, offs_p, eff = rank_probes(
            q, dev["cents"], dev["cvalid"], dev["offsets"], dev["lens"],
            nprobe, ms, self.metric, self.compute_dtype,
        )
        kpad = dev["cents"].shape[0]
        if path.endswith("-hybrid"):
            _, rows = fused_ivf_topk(
                q, dev["xperm16"], dev["sqnorm"], dev["alive"], dev["crow"],
                dev["offsets"], dev["lens"], probe, kpad, self._shortlist(dev, top_k),
                self.metric, max_len=dev["l_pad"],
            )
            return rerank_exact(dev["xperm"], dev["sqnorm"], q, rows, top_k, self.metric)
        if path in ("dense-pallas", "dense-pallas-win"):
            return fused_ivf_topk(
                q, dev["xperm"], dev["sqnorm"], dev["alive"], dev["crow"],
                dev["offsets"], dev["lens"], probe, kpad,
                top_k, self.metric, max_len=dev["l_pad"],
            )
        if path == "dense-xla":
            return blocked_dense_topk(
                q.shape[0], dev["xperm"].shape[0],
                lambda s, e: score_matrix(q[s:e], dev["xperm"], self.metric,
                                          x_sqnorm=dev["sqnorm"],
                                          compute_dtype=self.compute_dtype),
                lambda s, e: dense_probe_mask(probe[s:e], eff[s:e], dev["crow"],
                                              dev["pos"], dev["alive"], kpad),
                top_k)
        return scan_probed_lists(
            dev["xperm"], dev["sqnorm"], dev["alive"], q, offs_p, eff,
            k=top_k, l_pad=dev["l_pad"], metric=self.metric,
            cdtype=self.compute_dtype,
        )

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None, *, top_k: int = 10) -> str:
        """Which route a (batch, nprobe, max_scans) query of ``top_k`` hits
        would run (max_scans None = full scan); 'buffer' before build."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        ms = max_scans if max_scans is not None else self._main_n
        return self._resolve_scan(dev, batch, np_eff, ms, top_k)

    def resolve_rows(self, rows: np.ndarray) -> list[list[str]]:
        return [
            [self._perm_ids[int(r)] if r >= 0 else "" for r in row]
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
        b = q.shape[0]

        buf_hits = (
            self._buffer.search_batch(q, top_k, options)
            if self._buffer.get_stats().count
            else [[] for _ in range(b)]
        )
        if not self._built or self._main_live == 0:
            return buf_hits

        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._main_n
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(self.device)
        vals, rows = self._run_scan(dev, qt, top_k, nprobe, ms, batch_bucket(b))
        vals = vals.cpu().numpy()
        rows = rows.cpu().numpy()

        perm_ids = dev["perm_ids"]
        out: list[list[SearchResult]] = []
        for bi in range(b):
            hits = list(buf_hits[bi])
            for v, r in zip(vals[bi], rows[bi]):
                if r < 0 or not np.isfinite(v):
                    continue
                hits.append(SearchResult(perm_ids[int(r)], float(v)))
            hits.sort(key=lambda h: -h.score)
            out.append(hits[:top_k])
        return out

    # ---- lifecycle ------------------------------------------------------

    def scan(self) -> Iterator[tuple[str, np.ndarray]]:
        for r, pid in enumerate(self._perm_ids):
            if self._alive[r]:
                yield pid, self._xperm[r].copy()
        yield from self._buffer.scan()

    def get_stats(self) -> IndexStats:
        return IndexStats(
            count=self._main_live + self._buffer.get_stats().count,
            dim=self.dim,
            metric=self.metric,
        )

    def snapshot(self, path: str) -> None:
        """``pyrope_tpu.ivf_flat.v1`` npz, the JAX package's format:
        centroids + permuted slab + lists + buffer."""
        with self.lock:  # live_vectors may return a view of the buffer slab
            bids, bvecs = self._buffer.live_vectors()
            meta = json.dumps({
                "format": "pyrope_tpu.ivf_flat.v1",
                "dim": self.dim,
                "metric": self.metric.value,
                "nlist": self.nlist,
                "nprobe": self.nprobe,
                "built": self._built,
                "seed": self.seed,
                "scan_mode": self.scan_mode,
            })
            cents = (self._centroids if self._centroids is not None
                     else np.zeros((0, self.dim), np.float32))
            np.savez_compressed(
                path,
                meta=np.str_(meta),
                centroids=cents,
                xperm=self._xperm,
                perm_ids=np.array(self._perm_ids, dtype=np.str_),
                alive=self._alive,
                offsets=self._offsets,
                lens=self._lens,
                buf_ids=np.array(bids, dtype=np.str_),
                buf_vecs=bvecs,
            )

    def load(self, path: str) -> None:
        with np.load(path, allow_pickle=False) as z:
            self._restore(z)

    def _restore(self, arrays) -> None:
        """Adopt ``pyrope_tpu.ivf_flat.v1`` state: a snapshot's arrays, or
        the JAX package's index state carried across (see convert.py).
        The slab is uploaded at the next search."""
        meta = read_meta(arrays, "pyrope_tpu.ivf_flat.v1")
        if int(meta["dim"]) != self.dim:
            raise ValueError("snapshot dim mismatch")
        self.metric = Metric.parse(meta["metric"])
        self.nlist = int(meta["nlist"])
        self.nprobe = int(meta["nprobe"])
        self.seed = int(meta.get("seed", 42))
        self.scan_mode = str(meta.get("scan_mode", self.scan_mode))
        self._built = bool(meta["built"])
        cents = np.asarray(arrays["centroids"], np.float32)
        self._centroids = cents if cents.size else None
        self._xperm = np.asarray(arrays["xperm"], np.float32)
        self._perm_ids = [str(s) for s in arrays["perm_ids"]]
        self._alive = np.asarray(arrays["alive"], bool)
        self._offsets = np.asarray(arrays["offsets"], np.int32)
        self._lens = np.asarray(arrays["lens"], np.int32)
        self._main_pos = {pid: r for r, pid in enumerate(self._perm_ids)}
        self._main_live = int(self._alive.sum())
        self._buffer = self._new_buffer()
        bids = [str(s) for s in arrays["buf_ids"]]
        if bids:
            self._buffer.add_batch(bids, np.asarray(arrays["buf_vecs"], np.float32))
        self._dirty = True
        self._dev = None
