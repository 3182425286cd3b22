"""Device-side slab construction (port of ``pyrope_tpu/ops/slab.py``).

Index builds permute the corpus cluster-major. The permuted search slab is
a device-side gather of the buffer k-means already moved to the device
(ops/kmeans.kmeans_build), so the corpus crosses the host link once;
out-of-range pad indices become zero rows.

The residual-SQ8 rerank slab (IVF-PQ ``refine_storage="sq8res"``) has one
encoder, ``sq8res_encode``: the build path runs it on the gathered rows
(``take_slab_sq8res``), the load path on the host rows it uploads
(``sq8res_encode_host``), the JAX package's two functions of the same
algebra.
"""

from __future__ import annotations

import numpy as np
import torch

SQ8_CHUNK = 262_144  # rows encoded per step: bounds the fp32 residual transient


def pad_order(order: np.ndarray, npad: int, oob: int, device="cuda") -> torch.Tensor:
    """Permutation padded to ``npad`` with the out-of-range index ``oob``;
    take_slab turns those rows into zeros."""
    out = np.full(npad, oob, np.int64)
    out[: order.size] = order
    return torch.from_numpy(out).to(device)


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Permuted rows x[idx], zero rows where idx >= len(x)."""
    n = x.shape[0]
    xp = x.index_select(0, torch.clamp(idx, max=max(n - 1, 0)))
    return xp.masked_fill_((idx >= n)[:, None], 0)  # in place: xp is fresh


def take_slab(x: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Permuted slab x[idx] with zero rows where idx >= len(x), plus the
    fp32 row sqnorms (0 on pad rows)."""
    xp = take_rows(x, idx)
    xf = xp.float()
    return xp, (xf * xf).sum(dim=-1)


def take_slab_cast(x: torch.Tensor, idx: torch.Tensor, *,
                   dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Permuted slab stored as ``dtype`` + fp32 sqnorms of the rows before
    the cast. Only float32 is ported: the scan kernel takes no bf16 slab
    yet."""
    if dtype != "float32":
        raise NotImplementedError(f"slab dtype {dtype!r} not yet ported")
    return take_slab(x, idx)


def sq8res_encode(xf: torch.Tensor, cents: torch.Tensor, crow: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual-SQ8 codes of rows ``xf`` [n, D] fp32 against their
    centroids cents[crow]: r = x - c, per-row affine uint8 codes over the
    row's own residual range. Returns (codes u8 [n, D], mins, scales,
    sqnorm fp32 [n]); ``sqnorm`` is ||x̂||² of the reconstruction
    x̂ = c + min + scale·code, so L2 off the slab is exact up to its
    storage rounding."""
    c = cents.index_select(0, crow.long())
    r = xf - c
    mn = r.amin(dim=1)
    scale = torch.clamp(r.amax(dim=1) - mn, min=1e-12) / 255.0
    code = torch.clamp(torch.round((r - mn[:, None]) / scale[:, None]), 0.0, 255.0)
    xhat = c + mn[:, None] + scale[:, None] * code
    return code.to(torch.uint8), mn, scale, (xhat * xhat).sum(dim=-1)


def _encode_chunks(rows_of, n: int, cents, crow, chunk: int):
    """sq8res_encode over [s, e) row chunks; ``rows_of(s, e)`` gives the
    fp32 rows."""
    parts = [sq8res_encode(rows_of(s, min(s + chunk, n)), cents,
                           crow[s : min(s + chunk, n)])
             for s in range(0, n, chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def take_slab_sq8res(x: torch.Tensor, idx: torch.Tensor, cents: torch.Tensor,
                     crow: torch.Tensor, *, chunk: int = SQ8_CHUNK
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The permuted slab x[idx] stored as residual-SQ8 (see
    ``sq8res_encode``), gathered and encoded a chunk at a time so no
    permuted fp32 slab is held. Pad rows (out-of-range idx) are zero rows
    and encode -c; they are alive=False everywhere. Returns (codes u8
    [npad, D], mins, scales, sqnorm fp32 [npad])."""
    return _encode_chunks(lambda s, e: take_rows(x, idx[s:e]).float(),
                          idx.shape[0], cents, crow, chunk)


def sq8res_encode_host(xp: np.ndarray, cents: torch.Tensor, crow: torch.Tensor,
                       npad: int, *, chunk: int = SQ8_CHUNK
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual-SQ8 slab of host rows ``xp`` [n, D] (a loaded index's
    permuted slab), uploaded and encoded a chunk at a time on cents'
    device; rows n..npad are zero (codes, mins, scales and sqnorm), as
    the JAX package uploads them."""
    n, d = xp.shape
    dev = cents.device
    codes = torch.zeros((npad, d), dtype=torch.uint8, device=dev)
    stats = torch.zeros((3, npad), dtype=torch.float32, device=dev)
    if n:
        c8, mn, sc, sq = _encode_chunks(
            lambda s, e: torch.from_numpy(np.ascontiguousarray(xp[s:e], np.float32)).to(dev),
            n, cents, crow, chunk)
        codes[:n] = c8
        stats[:, :n] = torch.stack([mn, sc, sq])
    return codes, stats[0], stats[1], stats[2]
