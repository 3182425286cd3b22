"""64-bit SimHash — the L1 fuzzy cache key.

Rebuild of the reference's ``LshService`` (ref: Services/LshService.cs):
deterministic random hyperplanes cached per dimension, seeded ``42 + dim``
(:21-47); the hash is the sign-of-dot-product bit per hyperplane (:49-70).
Nearby queries land on the same 64-bit hash and therefore share an L1 cache
line.

The projection is a single ``[D, 64]`` host numpy matmul, for one query or
a batch. The planes and the arithmetic are the JAX package's
(``pyrope_tpu/cache/lsh.py``), so both packages give every query the same
L1 key.
"""

from __future__ import annotations

import threading

import numpy as np

_BITS = 64


class LshService:
    def __init__(self, seed_base: int = 42):
        self._seed_base = seed_base
        self._planes: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def _hyperplanes(self, dim: int) -> np.ndarray:
        with self._lock:
            hp = self._planes.get(dim)
            if hp is None:
                rng = np.random.default_rng(self._seed_base + dim)
                hp = rng.standard_normal((dim, _BITS)).astype(np.float32)
                self._planes[dim] = hp
            return hp

    def simhash(self, vector: np.ndarray) -> int:
        """64-bit SimHash of one query vector."""
        return int(self.simhash_batch(np.asarray(vector)[None, :])[0])

    def simhash_batch(self, vectors: np.ndarray) -> np.ndarray:
        """[B] uint64 SimHashes for a [B, D] query batch."""
        v = np.asarray(vectors, dtype=np.float32)
        if v.ndim != 2:
            raise ValueError(f"expected [B, D], got shape {v.shape}")
        bits = (v @ self._hyperplanes(v.shape[1])) >= 0.0  # [B, 64]
        weights = (1 << np.arange(_BITS, dtype=np.uint64))
        return (bits.astype(np.uint64) * weights).sum(axis=1, dtype=np.uint64)
