"""Comparison helpers for the PyTorch port's parity tests (test_torch_*.py).

The same numpy inputs go through the JAX function and its port. Both sides
compute in fp32 but sum in a different order (XLA's dot or the Pallas
kernel in interpret mode against torch's matmul or the port's chunked plain
scan), so scores agree to the JAX tests' own tolerance, rtol 1e-5 and atol
1e-4 (tests/test_pallas_scan.py), not bit for bit. Hit sets must be equal;
an ordered list may differ from the other only where adjacent scores lie
within that tolerance.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrope_tpu_torch.ops.fused_scan import fused_flat_topk_plain

RTOL = 1e-5
ATOL = 1e-4


# the JAX package's SQ8 kernel tolerance (tests/test_pallas_scan.py): the
# scale·(q·code) term's dot runs up to 255·Σ|q|, so summation order shows more
SQ8_RTOL = 1e-4


def assert_same_hits(vals_a, idx_a, vals_b, idx_b, rtol=RTOL) -> None:
    """Per-row equal hit sets, scores within tolerance, and order equal
    except inside runs of near-equal scores. Ids may be ints or strings."""
    va, vb = np.asarray(vals_a, np.float64), np.asarray(vals_b, np.float64)
    ia, ib = np.asarray(idx_a), np.asarray(idx_b)
    assert ia.shape == ib.shape, (ia.shape, ib.shape)
    for row in range(ia.shape[0]):
        assert set(ia[row].tolist()) == set(ib[row].tolist()), (row, ia[row], ib[row])
    np.testing.assert_allclose(va, vb, rtol=rtol, atol=ATOL)
    for row, j in zip(*np.nonzero(ia != ib)):
        near = [jj for jj in (j - 1, j + 1) if 0 <= jj < va.shape[1]
                and np.isclose(va[row, j], va[row, jj], rtol=rtol, atol=ATOL)]
        assert near, f"row {row} rank {j}: {ia[row]} vs {ib[row]} differ outside a tie"


def hits_to_arrays(results):
    """search_batch output -> (scores, ids) arrays padded with -inf / ''."""
    k = max((len(r) for r in results), default=0)
    vals = np.full((len(results), k), -np.inf)
    ids = np.full((len(results), k), "", dtype=object)
    for i, row in enumerate(results):
        for j, h in enumerate(row):
            vals[i, j], ids[i, j] = h.score, h.id
    return vals, ids


def assert_same_results(res_a, res_b, rtol=RTOL) -> None:
    """Two search_batch outputs name the same hits with the same scores."""
    assert_same_hits(*hits_to_arrays(res_a), *hits_to_arrays(res_b), rtol=rtol)


# ---- seeded inputs shared by the kernel tests ------------------------------


def as_tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def flat_case(seed, n, b, d):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), np.float32)
    q = rng.random((b, d), np.float32)
    sq = np.einsum("nd,nd->n", x, x).astype(np.float32)
    alive = np.ones(n, bool)
    alive[7:50] = False
    return x, q, sq, alive


def ivf_case(seed, n, b, d, kc, nprobe):
    x, q, sq, alive = flat_case(seed, n, b, d)
    rng = np.random.default_rng(seed + 100)
    lens = rng.multinomial(n, np.ones(kc) / kc)
    crow = np.repeat(np.arange(kc, dtype=np.int32), lens)  # cluster-major
    probe = np.stack([rng.choice(kc, size=nprobe, replace=False)
                      for _ in range(b)]).astype(np.int32)
    return x, q, sq, alive, crow, probe


def sq8_case(seed, n, b, d, kc, nprobe, kp):
    """ivf_case's corpus stored as residual SQ8 against per-cluster means,
    encoded as the JAX package's host encoder does. Returns (q, codes,
    mins, scales, sqnorm of the reconstruction, alive, crow, probe, cents
    [kp, D] zero-padded, qc = q·centsᵀ [B, kp])."""
    x, q, _, alive, crow, probe = ivf_case(seed, n, b, d, kc, nprobe)
    cents = np.zeros((kp, d), np.float32)
    for c in range(kc):
        if (crow == c).any():
            cents[c] = x[crow == c].mean(axis=0)
    r = x - cents[crow]
    mn = r.min(axis=1)
    sc = np.maximum(r.max(axis=1) - mn, 1e-12) / np.float32(255.0)
    codes = np.clip(np.round((r - mn[:, None]) / sc[:, None]), 0, 255).astype(np.uint8)
    xhat = cents[crow] + mn[:, None] + sc[:, None] * codes.astype(np.float32)
    sq = np.einsum("nd,nd->n", xhat, xhat).astype(np.float32)
    return q, codes, mn, sc, sq, alive, crow, probe, cents, q @ cents.T


def split_partials(q, x, sq, alive, k, per):
    """Per-split plain scans stacked as the scan kernel's [S, B, k] output."""
    parts = []
    for s in range(0, x.shape[0], per):
        split_alive = np.zeros_like(alive)
        split_alive[s:s + per] = alive[s:s + per]
        parts.append(fused_flat_topk_plain(as_tensor(q), as_tensor(x),
                                           as_tensor(sq), as_tensor(split_alive),
                                           x.shape[0], k))
    return (torch.stack([v for v, _ in parts]).contiguous(),
            torch.stack([i for _, i in parts]).contiguous())
