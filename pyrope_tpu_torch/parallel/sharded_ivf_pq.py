"""Corpus-sharded IVF-PQ (port of ``pyrope_tpu/parallel/sharded_ivf_pq.py``).

ShardedIvfFlatIndex's round-robin layout (parallel/sharded_ivf.py) over the
PQ codes: every list's codes are dealt across the ``data`` axis, each shard
holds ~1/nd of every list in its own cluster-major code slab, and, with
``refine`` > 0, the same rows of the rerank slab (fp32, or bf16 with
``refine_storage="bf16"``). Codebooks and centroids are replicated.
Candidates are encoded ``shard * stride + local row``.

Routes (``describe_scan``), by the JAX package's names, on shard-local
volumes:
  - ``dense-exact-pallas`` / ``dense-exact-pallas-win`` (refine > 0, full
    scan): the list scan kernel (``ops/fused_scan.fused_ivf_topk``) on each
    shard over its rerank slab and local CSR, with ``promote_fp32`` as the
    JAX package runs its K2 / K3 there: IVF mode on an fp32 slab, BF16
    mode (fp32 q times the widened rows) on a bf16 one.
  - ``dense-exact-xla``: plain torch, the shard's exact scores masked by
    probe membership and the shard-local budget.
  - ``dense-adc`` (refine 0): the shared-slab ADC accumulate per shard.
  - ``probe-adc`` / ``probe-adc+rerank``: ADC over each probed list's local
    slice; with refine each shard reranks its own top-R exactly before the
    merge, so the merged lists stay [B, k] (the union of per-shard top-R
    covers the global top-R).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyrope_tpu_torch.index.flat import to_device
from pyrope_tpu_torch.index.ivf_flat import (
    DENSE_MAX_ELEMS,
    DENSE_MAX_ROWS,
    WINDOWED_ROUTE_KPAD,
    blocked_dense_topk,
    dense_probe_mask,
    pallas_dense_ok,
    pick_scan_mode,
    probe_extents,
)
from pyrope_tpu_torch.index.ivf_pq import (
    IvfPqIndex,
    adc_scan_dense,
    adc_scan_probed_lists,
    compute_cdot,
)
from pyrope_tpu_torch.ops.distance import rerank_exact, row_sqnorms, score_matrix
from pyrope_tpu_torch.ops.fused_scan import fused_ivf_topk, k_refusal
from pyrope_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    default_mesh,
    replicate_shards,
    shard_grid,
)
from pyrope_tpu_torch.parallel.sharded_ivf import (
    _ivf_sharded,
    decode_hits,
    gather_rows,
    layout_tables,
    roundrobin_layout,
    shard_ivf_state,
)
from pyrope_tpu_torch.types import (
    DEFAULT_SEARCH_OPTIONS,
    Metric,
    SearchOptions,
    SearchResult,
)
from pyrope_tpu_torch.utils.shapes import batch_bucket, round_up


def make_sharded_ivfpq_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                              l_pad: int, probe_metric: Metric, refine_r: int = 0):
    """Probed ADC scan on every shard. With ``refine_r`` > 0 each shard
    reranks its own ADC top-R exactly off its rerank slab before the merge."""

    def local(s, st, q, probe, ms):
        offs_p, eff = probe_extents(probe, st["offsets"], st["lens"], ms)
        vals, cand = adc_scan_probed_lists(
            st["codes"], st["alive"], q, st["cents"], st["codebooks"], probe, offs_p, eff,
            k=refine_r or k, l_pad=l_pad, metric=metric)
        if not refine_r:
            return vals, cand
        return rerank_exact(st["xraw"], st["xsqnorm"], q, cand, k, metric)

    return _ivf_sharded(mesh, k, nprobe, probe_metric, None, local)


def make_sharded_ivfpq_dense_search(mesh: Mesh, metric: Metric, k: int, nprobe: int,
                                    probe_metric: Metric, refine_r: int = 0,
                                    pallas_path: str = "", l_pad: int = 0):
    """Dense scan on every shard. ``refine_r`` 0: the shared-slab ADC
    accumulate masked by the shard's CSR. ``refine_r`` > 0: each shard
    exact-scores all its probed rows off the rerank slab: through the list
    scan kernel (``pallas_path``, full scans) or the plain masked score
    matrix."""

    def local(s, st, q, probe, ms):
        _, eff = probe_extents(probe, st["offsets"], st["lens"], ms)
        kpad = st["cents"].shape[0]
        if refine_r and pallas_path:
            return fused_ivf_topk(q, st["xraw"], st["xsqnorm"], st["alive"], st["crow"],
                                  st["offsets"], st["lens"], probe, kpad, k, metric,
                                  max_len=l_pad, promote_fp32=True)
        if refine_r:
            xf = st["xraw"].float()  # a bf16 slab widened once: exact products
            return blocked_dense_topk(
                q.shape[0], xf.shape[0],
                lambda a, b: score_matrix(q[a:b], xf, metric, x_sqnorm=st["xsqnorm"]),
                lambda a, b: dense_probe_mask(probe[a:b], eff[a:b], st["crow"], st["pos"],
                                              st["alive"], kpad),
                k)
        return adc_scan_dense(st["codes"], st["alive"], q, st["cents"], st["codebooks"],
                              st["cdot"], st["crow"], st["pos"], probe, eff, k=k,
                              metric=metric)

    return _ivf_sharded(mesh, k, nprobe, probe_metric, None, local)


class ShardedIvfPqIndex(IvfPqIndex):
    """IvfPqIndex whose code slab (and rerank slab) is list-sliced over the
    mesh's ``data`` axis. ``refine_storage``: 'fp32' or 'bf16' (the
    residual-SQ8 slab has no sharded form, as in the JAX package).
    ``device`` names the default mesh's devices when no ``mesh`` is
    given."""

    def __init__(
        self,
        dim: int,
        metric: Metric | str = Metric.L2,
        *,
        mesh: Optional[Mesh] = None,
        nlist: int = 100,
        pq_m: int = 4,
        ksub: int = 256,
        nprobe: int = 3,
        seed: int = 123,
        refine: int = 64,
        refine_storage: str = "fp32",
        scan_mode: str = "auto",
        device="cuda",
    ):
        if refine_storage not in ("fp32", "bf16"):
            raise ValueError(f"refine_storage must be fp32|bf16, got {refine_storage!r}")
        self.mesh = mesh if mesh is not None else default_mesh(device)
        self._ndev = int(self.mesh.shape[DATA_AXIS])  # rows deal over DATA only
        self._grid = shard_grid(self.mesh, (DATA_AXIS,))
        super().__init__(dim, metric, device=self._grid[0, 0], nlist=nlist, pq_m=pq_m,
                         ksub=ksub, nprobe=nprobe, seed=seed, refine=refine,
                         refine_storage=refine_storage, scan_mode=scan_mode)

    def _install_device_slab(self, x_dev, codes_dev, order) -> None:
        """The single index's device install does not apply to the sharded
        layout; _sync builds it."""
        self._dirty = True
        self._dev = None

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        nd = self._ndev
        k = self._lens.shape[0]
        kpad = round_up(max(k, 1), 8)
        local_lens, local_offsets, l_pad, cap_local, placements = roundrobin_layout(
            self._lens, self._offsets, nd, kpad)
        t = layout_tables(local_lens, local_offsets, cap_local, placements, kpad)
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:k] = self._centroids
            cvalid[:k] = True
        cbs = (self.pq.codebooks if self.pq.codebooks is not None
               else np.zeros((self.pq.m, self.pq.ksub, self.pq.sub), np.float32))
        # cdot feeds only the refine 0 dense ADC (see IvfPqIndex._host_tables)
        cdot = None
        if (self.refine == 0 and self._codes.shape[0] and self.pq.trained
                and self._centroids is not None):
            cdot = compute_cdot(self._codes, np.repeat(np.arange(k, dtype=np.int32),
                                                       self._lens),
                                self._centroids, self.pq.codebooks)
        first = self.device
        codes_all = to_device(self._codes, first)
        x_all = to_device(self._xperm, first) if self.refine > 0 else None
        slab_dtype = torch.bfloat16 if self.refine_storage == "bf16" else torch.float32
        shards = []
        for s, dev in enumerate(self._grid[0]):
            src = t["src"][s]
            ok = src >= 0
            alive = np.where(ok, self._alive[np.maximum(src, 0)], False)
            st = shard_ivf_state(dev, s, cap_local, t, local_lens, local_offsets, cents,
                                 cvalid, alive)
            st["codes"] = gather_rows(codes_all, src, dev)
            st["codebooks"] = to_device(cbs, dev)
            if cdot is not None:
                st["cdot"] = to_device(np.where(ok, cdot[np.maximum(src, 0)], 0.0)
                                       .astype(np.float32), dev)
            if x_all is not None:
                xs = gather_rows(x_all, src, dev)
                st["xsqnorm"] = row_sqnorms(xs)   # of the fp32 rows, whatever the slab
                st["xraw"] = xs.to(slab_dtype)
            shards.append(st)
        del codes_all, x_all
        self._dev = {
            "shards": replicate_shards(self._grid, shards),
            "kpad": kpad, "l_pad": l_pad, "stride": cap_local, "k_actual": k,
            "enc_to_perm": t["src"].reshape(-1),
            "perm_ids": self._perm_ids,
        }
        self._dirty = False
        return self._dev

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """q [B, D] on the mesh's first device (pre-normalized for COSINE)
        -> (scores [B, k], encoded rows [B, k]) there."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        return self._device_scan(q, top_k, options, q.shape[0])

    def _refine_r(self, dev: dict, top_k: int) -> int:
        return max(top_k, min(self.refine * top_k, dev["stride"])) if self.refine > 0 else 0

    def _device_scan(self, q: torch.Tensor, top_k: int, options: SearchOptions,
                     batch: int):
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms_local = (dev["stride"] if options.max_scans is None
                    else (options.max_scans + self._ndev - 1) // self._ndev)
        metric = self._search_metric()
        probe_metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        refine_r = self._refine_r(dev, top_k)
        mode, ppath = self._resolve_sharded_scan(dev, batch, nprobe, metric, refine_r,
                                                 options.max_scans is None, top_k)
        if mode == "dense":
            fn = make_sharded_ivfpq_dense_search(self.mesh, metric, top_k, nprobe,
                                                 probe_metric, refine_r, ppath, dev["l_pad"])
        else:
            fn = make_sharded_ivfpq_search(self.mesh, metric, top_k, nprobe, dev["l_pad"],
                                           probe_metric, refine_r)
        return fn(dev["shards"], q, ms_local)

    def _resolve_sharded_scan(self, dev: dict, batch: int, nprobe: int,
                              search_metric: Metric, refine_r: int, uncapped: bool,
                              top_k: int = 10) -> tuple[str, str]:
        """(mode, kernel path) on per-shard local volumes; the path is ''
        (plain torch), 'dense-exact-pallas' or 'dense-exact-pallas-win'. The
        kernel has full-scan semantics, so a max_scans budget keeps the
        plain dense scan. With refine > 0, 'auto' resolves by local size
        only, never by batch (dense and probe return different hit sets),
        but the memory guard may demote."""
        p_ok = refine_r > 0 and uncapped and pallas_dense_ok(
            "auto", search_metric, None, dev["stride"], dev["stride"])
        if self.scan_mode == "auto" and self.refine > 0:
            mode = "dense" if dev["stride"] <= DENSE_MAX_ROWS else "probe"
            if not p_ok and batch * dev["stride"] > DENSE_MAX_ELEMS:
                mode = "probe"  # the memory guard outranks batch-invariance
        else:
            mode = pick_scan_mode(self.scan_mode, dev["stride"], nprobe, dev["l_pad"],
                                  batch=batch, pallas_ok=p_ok)
        if mode != "dense" or not p_ok:
            return mode, ""
        why = k_refusal(top_k)
        if why is not None:
            raise ValueError(f"the dense kernel route needs the list scan: {why}")
        return mode, ("dense-exact-pallas-win" if dev["kpad"] > WINDOWED_ROUTE_KPAD
                      else "dense-exact-pallas")

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None, *, top_k: int = 10) -> str:
        """The sharded route of a (batch, nprobe, max_scans) query; 'buffer'
        before build."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        refine_r = max(1, min(self.refine, dev["stride"])) if self.refine > 0 else 0
        mode, ppath = self._resolve_sharded_scan(dev, batch, np_eff, self._search_metric(),
                                                 refine_r, max_scans is None, top_k)
        if mode != "dense":
            return "probe-adc+rerank" if self.refine > 0 else "probe-adc"
        if self.refine == 0:
            return "dense-adc"
        return ppath or "dense-exact-xla"

    def _decode(self, rows: np.ndarray) -> np.ndarray:
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
        qt = torch.from_numpy(np.ascontiguousarray(self._normalize(q))).to(self.device)
        vals, rows = self._device_scan(qt, top_k, options, batch_bucket(b))
        return decode_hits(vals.cpu().numpy(), rows.cpu().numpy(), dev["enc_to_perm"],
                           dev["perm_ids"], buf_hits, top_k)
