"""IVF-PQ index (port of ``pyrope_tpu/index/ivf_pq.py``).

Coarse k-means (seed 123) + product-quantized residuals scored by ADC,
with an exact rerank stage over a rerank slab. Pre-build writes land in a
FlatIndex buffer, searched exactly; ``build()`` merges main + buffer, runs
the coarse k-means, trains PQ on the residuals r = x − c (codebooks seeded
42+m), and permutes codes and rerank slab cluster-major on the device.

The rerank slab (``refine`` > 0) is fp32 rows, bf16 rows
(``refine_storage="bf16"``: half the bytes; sqnorms of the fp32 rows), or
with ``refine_storage="sq8res"`` per-row residual-SQ8 codes (uint8 codes +
min/scale against the row's own centroid, N·(D+12) bytes): the
memory-lean configuration. The fp32 corpus buffer k-means uploaded is not
kept: raw rows stay on the host only. ``train_dtype`` ("bfloat16") is the
coarse k-means' and PQ training's matmul dtype; assignments and codes are
always fp32.

Scan routes, by the same names as the JAX package, so a recorded route
names the code that ran:
  - ``dense-sq8-pallas`` / ``dense-sq8-pallas-win``: the CUDA list scan
    in SQ8 mode (ops/fused_scan.fused_ivf_sq8_topk) over the SQ8 slab; the
    JAX package's kernels K4 and K5.
  - ``dense-exact-pallas`` / ``dense-exact-pallas-win``: the list scan
    (``fused_ivf_topk``) over the rerank slab with the JAX package's
    ``promote_fp32=True``: IVF mode on an fp32 slab (where promote is the
    identity), BF16 mode on a bf16 one (fp32 q times the widened rows).
  - plain torch, as they are XLA in the JAX package: ``dense-sq8-xla``,
    ``dense-exact-xla``, ``dense-adc`` (refine 0), ``probe-adc``,
    ``probe-adc+rerank`` and ``probe-adc+rerank-sq8``. These carry the
    ``max_scans`` budgets (the ``dense-*-xla`` routes walked in query
    blocks), as in the JAX package. The list scan takes any D and any k.
The ``-win`` names follow the cluster-table width (> 512), as in the JAX
package, though here one kernel serves both: the list scan takes any
nlist. So the eligibility test keeps only the JAX
package's semantic terms (L2/IP, full scan, fp32) and drops its tile and
window terms (``pick_row_tile``, ``tile_cluster_windows``/``win_ok``):
where a JAX index's slab does not fit the windowed kernel (``win_ok``
False) it routes ``dense-*-xla`` and the port ``dense-*-pallas-win``.
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
from pyrope_tpu_torch.index.flat import FlatIndex, read_meta, to_device
from pyrope_tpu_torch.index.ivf_flat import (
    DENSE_MAX_ELEMS,
    DENSE_MAX_ROWS,
    WINDOWED_ROUTE_KPAD,
    blocked_dense_topk,
    dense_probe_mask,
    pallas_dense_ok,
    pick_scan_mode,
    probe_extents,
    slab_pad,
    top_probes,
)
from pyrope_tpu_torch.ops.distance import (
    check_fp32_exact,
    rerank_exact,
    rerank_exact_sq8res,
    row_sqnorms,
    score_matrix,
)
from pyrope_tpu_torch.ops.fused_scan import (
    fused_ivf_sq8_topk,
    fused_ivf_topk,
    k_refusal,
    sq8_scores,
)
from pyrope_tpu_torch.ops.kmeans import kmeans_build
from pyrope_tpu_torch.ops.pq import (
    ProductQuantizer,
    adc_accumulate,
    adc_accumulate_shared,
    adc_ip_table,
    adc_l2_table,
    pq_train_encode_device,
)
from pyrope_tpu_torch.ops.topk import masked_topk, merge_topk

COARSE_SEED = 123
DEFAULT_NPROBE = 3
FORMAT = "pyrope_tpu.ivf_pq.v1"


def compute_cdot(codes: np.ndarray, crow_n: np.ndarray, centroids: np.ndarray,
                 codebooks: np.ndarray) -> np.ndarray:
    """cdot[n] = c·r̂, the query-independent term of the dense ADC
    decomposition (see ``adc_scan_dense``). Host numpy, chunked to bound
    the decode buffer; codes [N, M] uint8, crow_n [N] cluster per row."""
    n = codes.shape[0]
    out = np.zeros(n, np.float32)
    m, _, sub = codebooks.shape
    mi = np.arange(m)
    for s in range(0, n, 262_144):
        e = min(s + 262_144, n)
        dec = codebooks[mi[None, :], codes[s:e].astype(np.int64)]  # [c, M, sub]
        csub = centroids[crow_n[s:e]].reshape(e - s, m, sub)
        out[s:e] = np.einsum("nms,nms->n", dec, csub)
    return out


def adc_scan_probed_lists(codes_perm, alive, q, cents, codebooks, probe, offs_p,
                          eff, *, k: int, l_pad: int, metric: Metric, row_base=0):
    """ADC scan of every probed list's code slice with a running top-k
    merge. L2 scores −Σ_m table(q − c)[m][code]; IP scores q·c + Σ_m
    table(q)[m][code]. ``row_base`` offsets the emitted rows."""
    b = q.shape[0]
    j = torch.arange(l_pad, device=q.device)
    vals = torch.full((b, k), float("-inf"), device=q.device)
    gidx = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    if metric != Metric.L2:
        ip_table = adc_ip_table(q, codebooks)               # residual-free
        qdotc = q @ cents.T
    for p in range(probe.shape[1]):
        c_ids = probe[:, p].long()
        rows = offs_p[:, p : p + 1].long() + j                # [B, L]
        blocks = codes_perm[rows]                             # [B, L, M]
        if metric == Metric.L2:
            table = adc_l2_table(q - cents[c_ids], codebooks)
            scores = -adc_accumulate(table, blocks)
        else:
            base = torch.gather(qdotc, 1, c_ids[:, None])     # q·c
            scores = base + adc_accumulate(ip_table, blocks)
        mask = (j[None, :] < eff[:, p : p + 1]) & alive[rows]
        svals = torch.where(mask, scores, float("-inf"))
        vals, gidx = merge_topk(vals, gidx, svals, row_base + rows, k)
    return vals, gidx


def adc_scan_dense(codes_all, alive, q, cents, codebooks, cdot, crow, pos, probe,
                   eff, *, k: int, metric: Metric):
    """Dense ADC scan: one shared-slab accumulate over every code row,
    masked by probe membership. The per-probe residual table decomposes
    so nothing depends on the (query, probe) pair:
      L2: ||(q−c) − r̂||² = T0sum[b,n] + 2·cdot[n] + ||c||² − 2·q·c
      IP: q·c + q·r̂ = QC[b, crow[n]] + IPsum[b,n]."""
    qdotc = q @ cents.T                                       # [B, K]
    if metric == Metric.L2:
        t0sum = adc_accumulate_shared(adc_l2_table(q, codebooks), codes_all)
        cc = (cents * cents).sum(dim=-1)
        d2 = cc[None, :] - 2.0 * qdotc
        scores = -(t0sum + 2.0 * cdot[None, :] + d2[:, crow.long()])
    else:
        scores = qdotc[:, crow.long()] + adc_accumulate_shared(
            adc_ip_table(q, codebooks), codes_all)
    mask = dense_probe_mask(probe, eff, crow, pos, alive, cents.shape[0])
    return masked_topk(scores, mask, k)


class IvfPqIndex(VectorIndex, CentroidsProvider):
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
        pq_m: int = 4,
        ksub: int = 256,
        nprobe: int = DEFAULT_NPROBE,
        seed: int = COARSE_SEED,
        refine: int = 64,
        refine_storage: str = "fp32",  # fp32 | bf16 | sq8res
        train_dtype: Optional[str] = None,
        scan_mode: str = "auto",
        train_init: str = "kmeans++",  # | "sample"
    ):
        """As the JAX package's IvfPqIndex, on ``device`` (the card unless
        the caller asks for the CPU).
        ``refine``: the ADC shortlist is ``refine * top_k`` rows, re-scored
        exactly from the rerank slab (0: pure ADC). ``scan_mode``: 'auto' |
        'dense' | 'probe'. ``train_dtype``: the training matmuls' dtype
        (None: fp32)."""
        if scan_mode not in ("auto", "dense", "probe"):
            raise ValueError(f"scan_mode must be auto|dense|probe, got {scan_mode!r}")
        _check_storage(refine_storage)
        self.dim = int(dim)
        self.metric = Metric.parse(metric)
        self.device = resolve_device(device)
        self.nlist = int(nlist)
        self.nprobe = int(nprobe)
        self.seed = seed
        self.refine = int(refine)
        self.refine_storage = refine_storage
        self.train_dtype = train_dtype
        self.scan_mode = scan_mode
        self.train_init = train_init
        self.pq = ProductQuantizer(m=int(pq_m), ksub=int(ksub), dim=self.dim)

        self._buffer = FlatIndex(dim, self.metric, device=self.device)
        self._built = False
        self._centroids: Optional[np.ndarray] = None
        # host-only raw rows; the permuted slab and the id->row dict are
        # materialized lazily from (_xbase, _order), as in IvfFlatIndex
        self._xperm_cache: Optional[np.ndarray] = np.zeros((0, self.dim), np.float32)
        self._xbase: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._codes = np.zeros((0, self.pq.m), np.uint8)
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

    @property
    def _main_pos(self) -> dict[str, int]:
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

    # ---- mutation (buffer first, as IvfFlatIndex) ------------------------

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

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        if self.metric != Metric.COSINE:
            return x
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return (x / np.maximum(n, 1e-12)).astype(np.float32)

    def build(self) -> None:
        with self.lock:
            self._build_locked()

    def _build_locked(self) -> None:
        ids: list[str] = []
        rows: list[np.ndarray] = []
        main_live = [r for r in range(len(self._perm_ids)) if self._alive[r]]
        if main_live:
            ids.extend(self._perm_ids[r] for r in main_live)
            rows.append(self._xperm[main_live])
        bids, bvecs = self._buffer.live_vectors()
        if bids:
            ids.extend(bids)
            rows.append(self._normalize(bvecs))
        if not ids:
            return
        x = np.concatenate(rows) if len(rows) > 1 else rows[0]
        n = x.shape[0]
        kc = min(self.nlist, n)

        metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        # one corpus upload serves the coarse k-means, the residuals, PQ
        # training and encoding, and the permuted slabs; nothing keeps it
        cents, assign, x_dev = kmeans_build(
            x, kc, metric, device=self.device, seed=self.seed,
            compute_dtype=self.train_dtype, init=self.train_init,
        )
        codes_dev = None
        if n >= self.pq.ksub:
            assign_dev = torch.from_numpy(assign).to(self.device).long()
            r_dev = x_dev - torch.from_numpy(cents).to(self.device)[assign_dev]
            codebooks, codes_dev = pq_train_encode_device(r_dev, n, self.pq, seed=42,
                                                          compute=self.train_dtype)
            del r_dev
            self.pq.codebooks = codebooks
            codes = codes_dev.cpu().numpy().astype(np.uint8)
        else:  # tiny corpus: the host path duplicates codewords for k < ksub
            residuals = x - cents[assign]
            self.pq.train(residuals, device=self.device, seed=42)
            codes = self.pq.encode(residuals, device=self.device)

        order = np.argsort(assign, kind="stable")
        self._xperm_cache = None
        self._xbase = x
        self._order = order
        self._codes = np.ascontiguousarray(codes[order])
        self._perm_ids = [ids[i] for i in order]
        self._main_pos_cache = None
        self._alive = np.ones(n, bool)
        self._lens = np.bincount(assign, minlength=kc).astype(np.int32)
        self._offsets = np.concatenate([[0], np.cumsum(self._lens)[:-1]]).astype(np.int32)
        self._centroids = cents[:kc]
        self._main_live = n
        self._built = True
        self._buffer = FlatIndex(self.dim, self.metric, device=self.device)
        if codes_dev is not None:
            self._install_device_slab(x_dev, codes_dev, order)
        else:
            self._dirty = True
            self._dev = None

    def get_centroids(self) -> Optional[np.ndarray]:
        return None if self._centroids is None else self._centroids.copy()

    # ---- device state ---------------------------------------------------

    def _sync(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        with self.lock:
            return self._sync_locked()

    def _host_tables(self) -> dict:
        kc = self._lens.shape[0]
        kpad = round_up(max(kc, 1), 8)
        l_pad = int(round_up(max(int(self._lens.max()) if kc else 1, 1), 128))
        n = self._codes.shape[0]
        npad = slab_pad(n, l_pad)
        alive = np.zeros(npad, bool)
        alive[:n] = self._alive
        cents = np.zeros((kpad, self.dim), np.float32)
        cvalid = np.zeros(kpad, bool)
        if self._centroids is not None:
            cents[:kc] = self._centroids
            cvalid[:kc] = True
        offs = np.zeros(kpad, np.int32)
        lens = np.zeros(kpad, np.int32)
        offs[:kc] = self._offsets
        lens[:kc] = self._lens
        # row -> cluster, row -> within-list position, and the dense ADC's
        # query-independent constant cdot[n] = c·r̂ (refine 0 only)
        crow = np.full(npad, kpad - 1, np.int32)
        pos = np.zeros(npad, np.int32)
        cdot = np.zeros(npad, np.float32)
        if n:
            crow[:n] = np.repeat(np.arange(kc, dtype=np.int32), self._lens)
            pos[:n] = np.arange(n, dtype=np.int32) - self._offsets[crow[:n]]
            if self.refine == 0 and self.pq.trained and self._centroids is not None:
                cdot[:n] = compute_cdot(self._codes, crow[:n], self._centroids,
                                        self.pq.codebooks)
        return {
            "k": kc, "kpad": kpad, "l_pad": l_pad, "n": n, "npad": npad,
            "alive": alive, "cents": cents, "cvalid": cvalid,
            "offs": offs, "lens": lens, "crow": crow, "pos": pos, "cdot": cdot,
        }

    def _dev_common(self, t: dict) -> dict:
        d = self.device
        return {
            "cents": to_device(t["cents"], d),
            "cvalid": to_device(t["cvalid"], d),
            "alive": to_device(t["alive"], d),
            "offsets": to_device(t["offs"], d),
            "lens": to_device(t["lens"], d),
            "codebooks": to_device(self.pq.codebooks, d),
            "crow": to_device(t["crow"], d),
            "pos": to_device(t["pos"], d),
            "cdot": to_device(t["cdot"], d),
            "l_pad": t["l_pad"],
            "k_actual": t["k"],
            # the row->id table that matches this slab (see IvfFlatIndex)
            "perm_ids": self._perm_ids,
        }

    def _install_device_slab(self, x_dev: torch.Tensor, codes_dev: torch.Tensor,
                             order: np.ndarray) -> None:
        """Permute the codes and build the rerank slab on the device from
        the build's buffers: no second upload."""
        from pyrope_tpu_torch.ops.slab import (
            pad_order,
            take_rows,
            take_slab_cast,
            take_slab_sq8res,
        )

        t = self._host_tables()
        idx = pad_order(order, t["npad"], x_dev.shape[0], self.device)
        dev = self._dev_common(t)
        dev["codes"] = take_rows(codes_dev, idx).to(torch.uint8)
        if self.refine > 0:
            if self.refine_storage == "sq8res":
                (dev["codes8"], dev["mins"], dev["scales"],
                 dev["sq8norm"]) = take_slab_sq8res(x_dev, idx, dev["cents"],
                                                    dev["crow"])
            else:
                dev["xraw"], dev["xsqnorm"] = take_slab_cast(x_dev, idx,
                                                             dtype=self._slab_dtype())
        self._dev = dev
        self._dirty = False

    def _sync_locked(self) -> dict:
        if self._dev is not None and not self._dirty:
            return self._dev
        from pyrope_tpu_torch.ops.slab import sq8res_encode_host

        t = self._host_tables()
        n, npad = t["n"], t["npad"]
        codes = np.zeros((npad, self.pq.m), np.uint8)
        codes[:n] = self._codes
        dev = {"codes": to_device(codes, self.device), **self._dev_common(t)}
        if self.refine > 0:
            if self.refine_storage == "sq8res":
                (dev["codes8"], dev["mins"], dev["scales"],
                 dev["sq8norm"]) = sq8res_encode_host(
                    self._xperm, dev["cents"], dev["crow"][:n], npad)
            else:
                xraw = torch.zeros((npad, self.dim), dtype=torch.float32,
                                   device=self.device)
                xraw[:n] = to_device(self._xperm, self.device)
                # sqnorms of the fp32 rows, whatever the slab stores
                dev["xsqnorm"] = row_sqnorms(xraw)
                dev["xraw"] = xraw.to(getattr(torch, self._slab_dtype()))
        self._dev = dev
        self._dirty = False
        return dev

    # ---- query ----------------------------------------------------------

    def _slab_dtype(self) -> str:
        return "bfloat16" if self.refine_storage == "bf16" else "float32"

    def _search_metric(self) -> Metric:
        return Metric.INNER_PRODUCT if self.metric == Metric.COSINE else self.metric

    def _resolve_scan(self, dev: dict, batch: int, nprobe: int, ms: int,
                      top_k: int) -> str:
        """(batch, nprobe, max_scans, top_k) -> the route that will run, by
        the JAX package's rules: 'probe-adc', 'probe-adc+rerank[-sq8]',
        'dense-adc', 'dense-exact-{xla,pallas,pallas-win}' or
        'dense-sq8-{xla,pallas,pallas-win}'. The single source of routing
        truth for _run_scan and describe_scan, by the JAX package's rules;
        ``top_k`` only names the limit where a kernel route cannot take it.

        With ``refine`` > 0 dense and probe return different hit sets
        (dense exact-scans the rerank slab, probe reranks an ADC
        shortlist), so 'auto' resolves by index size only, never by batch;
        with ``refine`` 0 both score the same ADC sums and auto may pick by
        traffic."""
        npad = dev["codes"].shape[0]
        kpad = dev["cents"].shape[0]
        n = self._codes.shape[0]
        p_ok = self.refine > 0 and pallas_dense_ok(
            "auto", self._search_metric(), None, ms, n)
        if self.scan_mode == "auto" and self.refine > 0:
            # the fused kernel holds no [B, npad] transient: eligible slabs
            # stay dense at any size
            mode = "dense" if (npad <= DENSE_MAX_ROWS or p_ok) else "probe"
            if not p_ok and batch * npad > DENSE_MAX_ELEMS:
                mode = "probe"  # the memory guard outranks batch-invariance
        else:
            mode = pick_scan_mode(self.scan_mode, npad, nprobe, dev["l_pad"],
                                  batch=batch, pallas_ok=p_ok)
        sq8 = self.refine_storage == "sq8res"
        if mode != "dense":
            if self.refine > 0:
                return "probe-adc+rerank-sq8" if sq8 else "probe-adc+rerank"
            return "probe-adc"
        if self.refine == 0:
            return "dense-adc"
        if not p_ok:
            return "dense-sq8-xla" if sq8 else "dense-exact-xla"
        why = k_refusal(top_k)
        if why is not None:
            raise ValueError(f"the dense kernel route needs the list scan: {why}")
        win = "-win" if kpad > WINDOWED_ROUTE_KPAD else ""
        return ("dense-sq8-pallas" if sq8 else "dense-exact-pallas") + win

    def _run_scan(self, dev: dict, q: torch.Tensor, top_k: int, nprobe: int,
                  ms: int, batch: int):
        """Run the route ``batch`` resolves to (the bucketed batch for
        search_batch, as in the JAX package) on q [B, D] fp32."""
        metric = self._search_metric()
        probe_metric = Metric.L2 if self.metric == Metric.COSINE else self.metric
        path = self._resolve_scan(dev, batch, nprobe, ms, top_k)
        check_fp32_exact(q)
        probe = top_probes(q, dev["cents"], dev["cvalid"], nprobe, probe_metric)
        if "-pallas" not in path:   # the list scan's routes read no extents
            offs_p, eff = probe_extents(probe, dev["offsets"], dev["lens"], ms)
        kpad = dev["cents"].shape[0]
        if path.startswith("dense-sq8-pallas"):
            qc = q @ dev["cents"].T
            return fused_ivf_sq8_topk(
                q, dev["codes8"], dev["mins"], dev["scales"], dev["sq8norm"],
                dev["alive"], dev["crow"], dev["offsets"], dev["lens"], probe,
                qc, kpad, top_k, metric, max_len=dev["l_pad"],
            )
        if path.startswith("dense-exact-pallas"):
            return fused_ivf_topk(q, dev["xraw"], dev["xsqnorm"], dev["alive"],
                                  dev["crow"], dev["offsets"], dev["lens"], probe,
                                  kpad, top_k, metric, max_len=dev["l_pad"],
                                  promote_fp32=True)
        if path in ("dense-sq8-xla", "dense-exact-xla"):
            if path == "dense-exact-xla":
                xf = dev["xraw"].float()  # a bf16 slab widened once: exact products

                def scores_of(s, e):
                    return score_matrix(q[s:e], xf, metric, x_sqnorm=dev["xsqnorm"])
            else:  # [block, npad] transients, as the JAX package's XLA route
                def scores_of(s, e):
                    return sq8_scores(
                        q[s:e], q[s:e] @ dev["cents"].T, dev["codes8"], dev["mins"],
                        dev["scales"], dev["sq8norm"], dev["crow"],
                        metric == Metric.INNER_PRODUCT)
            return blocked_dense_topk(
                q.shape[0], dev["codes"].shape[0], scores_of,
                lambda s, e: dense_probe_mask(probe[s:e], eff[s:e], dev["crow"],
                                              dev["pos"], dev["alive"], kpad),
                top_k)
        if path == "dense-adc":
            return adc_scan_dense(
                dev["codes"], dev["alive"], q, dev["cents"], dev["codebooks"],
                dev["cdot"], dev["crow"], dev["pos"], probe, eff,
                k=top_k, metric=metric,
            )
        refine_r = max(top_k, min(self.refine * top_k, self._codes.shape[0] or top_k))
        shortlist = top_k if path == "probe-adc" else refine_r
        vals, cand = adc_scan_probed_lists(
            dev["codes"], dev["alive"], q, dev["cents"], dev["codebooks"],
            probe, offs_p, eff, k=shortlist, l_pad=dev["l_pad"], metric=metric,
        )
        if path == "probe-adc":
            return vals, cand
        if path == "probe-adc+rerank-sq8":
            return rerank_exact_sq8res(
                dev["codes8"], dev["mins"], dev["scales"], dev["crow"],
                dev["cents"], dev["sq8norm"], q, cand, top_k, metric,
            )
        return rerank_exact(dev["xraw"], dev["xsqnorm"], q, cand, top_k, metric)

    def device_search(
        self, q: torch.Tensor, top_k: int,
        options: SearchOptions = DEFAULT_SEARCH_OPTIONS,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident ADC(+rerank) query over the built slab (the
        buffer must be empty: build first). q [B, D] on the index device,
        pre-normalized for COSINE -> (scores [B, k], permuted rows [B, k])
        on the device; no host sync."""
        if self._buffer.get_stats().count:
            raise RuntimeError("device_search requires an empty buffer; call build()")
        if not self._built:
            raise RuntimeError("device_search requires a built index")
        if q.device != self.device:
            raise ValueError(f"query tensor on {q.device}, index on {self.device}")
        dev = self._sync()
        nprobe = min(options.nprobe or self.nprobe, dev["k_actual"])
        ms = options.max_scans if options.max_scans is not None else self._codes.shape[0]
        return self._run_scan(dev, q, top_k, nprobe, ms, q.shape[0])

    def describe_scan(self, batch: int, nprobe: Optional[int] = None,
                      max_scans: Optional[int] = None, *, top_k: int = 10) -> str:
        """Which route a (batch, nprobe, max_scans) query of ``top_k`` hits
        would run (max_scans None = full scan); 'buffer' before build."""
        if not self._built:
            return "buffer"
        dev = self._sync()
        np_eff = min(nprobe or self.nprobe, dev["k_actual"])
        ms = max_scans if max_scans is not None else self._codes.shape[0]
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
        ms = options.max_scans if options.max_scans is not None else self._codes.shape[0]
        qt = torch.from_numpy(np.ascontiguousarray(self._normalize(q))).to(self.device)
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

    def memory_bytes(self) -> dict:
        """Device bytes of the index state, as the JAX package counts them:
        codes, centroids and codebooks (the pure-ADC state), and the
        rerank slab apart."""
        kc = self._lens.shape[0]
        n = self._codes.shape[0]
        out = {
            "codes": int(n * self.pq.m),
            "centroids": int(kc * self.dim * 4),
            "codebooks": int(self.pq.m * self.pq.ksub * self.pq.sub * 4),
        }
        if self.refine > 0:
            if self.refine_storage == "sq8res":
                # uint8 codes + per-row (min, scale, sqnorm) fp32
                out["refine_slab"] = int(n * self.dim + n * 12)
            else:  # rows of 4 (fp32) or 2 (bf16) bytes an element + sqnorm
                elt = 2 if self.refine_storage == "bf16" else 4
                out["refine_slab"] = int(n * self.dim * elt + n * 4)
        return out

    def snapshot(self, path: str) -> None:
        """``pyrope_tpu.ivf_pq.v1`` npz, the JAX package's format."""
        with self.lock:  # live_vectors may return a view of the buffer slab
            bids, bvecs = self._buffer.live_vectors()
            meta = json.dumps({
                "format": FORMAT,
                "dim": self.dim,
                "metric": self.metric.value,
                "nlist": self.nlist,
                "nprobe": self.nprobe,
                "pq_m": self.pq.m,
                "ksub": self.pq.ksub,
                "built": self._built,
                "seed": self.seed,
                "refine": self.refine,
                "refine_storage": self.refine_storage,
                "scan_mode": self.scan_mode,
            })
            np.savez_compressed(
                path,
                meta=np.str_(meta),
                centroids=(self._centroids if self._centroids is not None
                           else np.zeros((0, self.dim), np.float32)),
                codebooks=(self.pq.codebooks if self.pq.codebooks is not None
                           else np.zeros(0, np.float32)),
                xperm=self._xperm,
                codes=self._codes,
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
        """Adopt ``pyrope_tpu.ivf_pq.v1`` state: a snapshot's arrays, or
        the JAX package's index state carried across (see convert.py). The
        device state is built at the next search."""
        meta = read_meta(arrays, FORMAT)
        if int(meta["dim"]) != self.dim:
            raise ValueError("snapshot dim mismatch")
        storage = str(meta.get("refine_storage", self.refine_storage))
        _check_storage(storage)
        self.metric = Metric.parse(meta["metric"])
        self.nlist = int(meta["nlist"])
        self.nprobe = int(meta["nprobe"])
        self.seed = int(meta.get("seed", COARSE_SEED))
        self.refine = int(meta.get("refine", self.refine))
        self.refine_storage = storage
        self.scan_mode = str(meta.get("scan_mode", self.scan_mode))
        self._built = bool(meta["built"])
        self.pq = ProductQuantizer.from_state({
            "m": meta["pq_m"], "ksub": meta["ksub"], "dim": self.dim,
            "codebooks": np.asarray(arrays["codebooks"], np.float32)})
        cents = np.asarray(arrays["centroids"], np.float32)
        self._centroids = cents if cents.size else None
        self._xperm = np.asarray(arrays["xperm"], np.float32)
        self._codes = np.asarray(arrays["codes"], np.uint8)
        self._perm_ids = [str(s) for s in arrays["perm_ids"]]
        self._alive = np.asarray(arrays["alive"], bool)
        self._offsets = np.asarray(arrays["offsets"], np.int32)
        self._lens = np.asarray(arrays["lens"], np.int32)
        self._main_pos = {pid: r for r, pid in enumerate(self._perm_ids)}
        self._main_live = int(self._alive.sum())
        self._buffer = FlatIndex(self.dim, self.metric, device=self.device)
        bids = [str(s) for s in arrays["buf_ids"]]
        if bids:
            self._buffer.add_batch(bids, np.asarray(arrays["buf_vecs"], np.float32))
        self._dirty = True
        self._dev = None


def _check_storage(refine_storage: str) -> None:
    if refine_storage not in ("bf16", "fp32", "sq8res"):
        raise ValueError(f"refine_storage must be bf16|fp32|sq8res, got {refine_storage}")

