"""Bucketing helpers (the port's copy of ``pyrope_tpu/utils/shapes.py``).

The port keeps the JAX package's capacity and batch buckets, so both
packages pad slabs and route batches alike.
"""

from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def next_pow2(x: int) -> int:
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


def capacity_bucket(n: int, minimum: int = 1024) -> int:
    """Slab capacity for n rows: power-of-2, at least `minimum` (and a
    multiple of 128 so tiles align to the lane dimension)."""
    return max(minimum, next_pow2(n))


def batch_bucket(b: int) -> int:
    """Pad query batch to a small set of sizes (routes are picked by the bucket,
    as in the JAX package)."""
    for cand in (8, 16, 32, 64, 128, 256, 512, 1024):
        if b <= cand:
            return cand
    return round_up(b, 1024)
