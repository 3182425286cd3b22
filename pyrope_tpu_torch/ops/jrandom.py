"""``jax.random``'s threefry draws, bit for bit, in PyTorch.

A copy of what the JAX package's k-means++ seeding reads from
``jax.random`` (JAX 0.9.0, ``jax_threefry_partitionable`` on, 64-bit types
off), so that the port draws the same centroids from the same seed:

  - ``threefry2x32``: the Threefry-2x32 hash, 20 rounds (``jax/_src/prng.py``
    ``_threefry2x32_lowering``);
  - ``prng_key(seed)``: the key (0, seed mod 2**32), as ``PRNGKey`` builds it
    from a seed it holds in 32 bits;
  - ``split(key, n)`` and ``random_bits(key, n)``: the hash of the counters
    (hi, lo) of the 64-bit iota 0 .. n-1, a row's bits depending only on its
    index (``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``:
    32-bit bits are the two words' xor);
  - ``uniform``, ``gumbel`` and ``categorical`` as ``jax/_src/random.py``
    turns bits into floats: the top 23 bits as the mantissa of a float in
    [1, 2), less 1, scaled into [minval, maxval); Gumbel noise -log(-log(u))
    with u uniform on [tiny, 1); a categorical draw the argmax of noise plus
    logits (the first maximum, as ``jnp.argmax``).

uint32 words are carried in int64 tensors and masked to 32 bits after every
add and shift. Keys are [2] int64 tensors on the draw's device, so a loop of
draws never syncs with the host. The floats go through ``torch.log``; where
its rounding differs from XLA's by an ulp, a draw can differ only where two
rows' noisy logits lie within that ulp.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the counter words (x1, x2) under key (k1, k2): uint32
    values in int64 tensors (k1, k2 broadcast against x1, x2)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s words as a [2] int64 tensor."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64, device=device)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the 64-bit iota 0 .. n-1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: [n, 2] int64."""
    hi, lo = _counters(n, key.device)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([a, b], dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,))``: [n] uint32 values in int64."""
    hi, lo = _counters(n, key.device)
    a, b = threefry2x32(key[0], key[1], hi, lo)
    return a ^ b


def uniform(key: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)``."""
    mant = ((random_bits(key, n) >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    # XLA fuses floats * (hi - lo) + lo into one fma: the product is exact
    # in float64, so one rounding of the sum to float32 follows it
    scaled = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (the default "low" mode)."""
    return -torch.log(-torch.log(uniform(key, n, _TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over a [n] float32 vector: a
    0-dim int64 tensor on the logits' device."""
    return torch.argmax(gumbel(key, logits.shape[0]) + logits)
