"""Lloyd's k-means on the device (port of ``pyrope_tpu/ops/kmeans.py``).

Each iteration scores a block of rows against the centroids (one fp32
matmul; with ``compute_dtype`` "bfloat16" the operands are rounded to bf16
and summed in fp32, the JAX package's bf16 training), takes the argmax,
and accumulates the centroid update in fp32 as the JAX package does: a one-hot product [K, block] @ [block, D] in fp32
(``segment_sum``). A matmul sums in an order fixed by its shapes, so a
build on the card gives the same centroids from the same seed every time;
``index_add_`` on a CUDA tensor adds with atomics in an unfixed order, and
flipping ``torch.use_deterministic_algorithms`` is the caller's process
state, not this module's. Counts are ``bincount``s of integers, exact in
any order. Blocks bound the [block, K] score and one-hot transients. Ties
in the assignment go to the lower centroid id (``torch.argmax`` returns
the first maximum, as ``jnp.argmax`` does).

Seeding: ``init="sample"`` draws the initial rows with the same numpy call
as the JAX package, so both start from equal centroids. ``init="kmeans++"``
samples each next centroid ∝ D²(x) as the JAX package does, step for step,
with ``jax.random``'s own draws (``ops/jrandom.py``: threefry keys split
from ``PRNGKey(seed)``, a categorical draw over log D²), so both pick the
same rows from the same seed but where rounding of D² or of ``log`` moves a
draw by an ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.ops import jrandom
from pyrope_tpu_torch.ops.distance import row_sqnorms, score_matrix

DEFAULT_ITERS = 10


def _upload(data: np.ndarray, device: torch.device) -> torch.Tensor:
    """The corpus on ``device`` (one host-to-device copy; on the CPU the
    tensor shares the array's memory and is only read)."""
    if not data.flags.writeable:
        data = data.copy()  # torch.from_numpy wants a writable buffer
    return torch.from_numpy(data).to(device)


def _kpp_init(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding on the device, the JAX package's ``_kpp_init``
    step for step: keys = split(PRNGKey(seed), k); the first row a
    categorical draw over uniform logits, each next one over log D²(x) of
    the rows with D² > 0; all-zero D² (a corpus of duplicates) degenerates
    to uniform. The JAX package pads x to a block multiple and masks the
    padding (``valid``); the port has no padding, and a row's draw depends
    only on its index, so every row draws what it draws there. Stays on
    the device: no host sync per step."""
    n, d = x.shape
    keys = jrandom.split(jrandom.prng_key(seed, x.device), k)
    xx = row_sqnorms(x)
    cents = torch.empty((k, d), dtype=torch.float32, device=x.device)
    uniform_logits = torch.zeros(n, dtype=torch.float32, device=x.device)
    neg_inf = torch.tensor(float("-inf"), device=x.device)

    def d2_to(c):  # ‖x−c‖² via the dot trick: one [N] matvec
        return torch.clamp(xx - 2.0 * (x @ c) + (c * c).sum(), min=0.0)

    idx = jrandom.categorical(keys[0], uniform_logits)
    cents[0] = x.index_select(0, idx.view(1))[0]
    d2 = d2_to(cents[0])
    for i in range(1, k):
        logits = torch.where(d2 > 0, torch.log(torch.clamp(d2, min=1e-30)), neg_inf)
        logits = torch.where((logits > neg_inf).any(), logits, uniform_logits)
        idx = jrandom.categorical(keys[i], logits)
        cents[i] = x.index_select(0, idx.view(1))[0]
        d2 = torch.minimum(d2, d2_to(cents[i]))
    return cents


def _init_cents(data: np.ndarray, x: torch.Tensor, k: int, seed: int,
                init: str) -> torch.Tensor:
    if init == "kmeans++":
        return _kpp_init(x, k, seed)
    if init == "sample":  # the JAX package's numpy draw, row for row
        rng = np.random.default_rng(seed)
        rows = rng.choice(data.shape[0], size=k, replace=False)
        return x.index_select(0, torch.from_numpy(rows).to(x.device)).float()
    raise ValueError(f"init must be kmeans++|sample, got {init!r}")


def _assign(x: torch.Tensor, cents: torch.Tensor, metric: Metric,
            block: int, compute=None) -> torch.Tensor:
    """Nearest centroid per row, blocked (the JAX package's
    ``_assign_blocked``). [N] int64."""
    return torch.cat([
        torch.argmax(score_matrix(x[s : s + block], cents, metric,
                                  compute_dtype=compute), dim=1)
        for s in range(0, x.shape[0], block)
    ])


def segment_sum(a: torch.Tensor, x: torch.Tensor, k: int) -> torch.Tensor:
    """Rows of ``x`` summed by segment id ``a`` (< k): [..., N] ids and
    [..., N, D] rows -> [..., k, D] fp32, as a one-hot matmul, whose
    summation order is fixed (see the module docstring)."""
    ids = torch.arange(k, device=a.device)
    onehot = (a[..., None] == ids).float()                   # [..., N, k]
    return torch.matmul(onehot.transpose(-1, -2), x.float())


def _lloyd(x: torch.Tensor, cents: torch.Tensor, metric: Metric, iters: int,
           block: int, compute=None) -> torch.Tensor:
    n, d = x.shape
    k = cents.shape[0]
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        for s in range(0, n, block):
            xb = x[s : s + block].float()
            a = torch.argmax(score_matrix(xb, cents, metric, compute_dtype=compute), dim=1)
            sums += segment_sum(a, xb, k)
            counts += torch.bincount(a, minlength=k).float()
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        # an empty cluster keeps its previous centroid
        cents = torch.where(counts[:, None] > 0, new, cents)
    return cents


def _prepare(data, k, metric, device):
    metric = Metric.parse(metric)
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    if n == 0:
        raise ValueError("kmeans on empty data")
    return metric, data, min(k, n), resolve_device(device)


def kmeans_train(
    data: np.ndarray,
    k: int,
    metric: Metric | str = Metric.L2,
    *,
    device="cuda",
    iters: int = DEFAULT_ITERS,
    seed: int = 42,
    block: int = 65536,
    compute_dtype: str | None = None,
    init: str = "kmeans++",
) -> np.ndarray:
    """Train k centroids (k clipped to N). Returns [k, D] float32.
    ``compute_dtype``: the Lloyd iterations' matmul dtype (None: fp32)."""
    metric, data, k, dev = _prepare(data, k, metric, device)
    x = _upload(data, dev)
    cents = _lloyd(x, _init_cents(data, x, k, seed, init), metric, iters, block,
                   compute_dtype)
    return cents.cpu().numpy()


def kmeans_build(
    data: np.ndarray,
    k: int,
    metric: Metric | str = Metric.L2,
    *,
    device="cuda",
    iters: int = DEFAULT_ITERS,
    seed: int = 42,
    block: int = 65536,
    compute_dtype: str | None = None,
    init: str = "kmeans++",
) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """Single-upload train + assign for index builds: the corpus moves to
    the device once and that buffer serves the Lloyd iterations, the final
    assignment and (by the caller) the permuted search slab.
    ``compute_dtype``: the Lloyd iterations' matmul dtype (None: fp32).

    Returns (centroids [k, D] fp32, assign [N] int32, x_dev [N, D])."""
    metric, data, k, dev = _prepare(data, k, metric, device)
    x = _upload(data, dev)
    cents = _lloyd(x, _init_cents(data, x, k, seed, init), metric, iters, block,
                   compute_dtype)
    # the final assignment is fp32 whatever the training dtype, like the
    # queries' centroid ranking (a bf16 assignment puts boundary rows in
    # lists the probes do not rank first)
    assign = _assign(x, cents, metric, block)
    return cents.cpu().numpy(), assign.int().cpu().numpy(), x


def kmeans_assign(
    data: np.ndarray,
    centroids: np.ndarray,
    metric: Metric | str = Metric.L2,
    *,
    device="cuda",
    block: int = 65536,
    compute_dtype: str | None = None,
) -> np.ndarray:
    """Nearest-centroid id per row, honoring the metric. Returns int32 [N]."""
    metric = Metric.parse(metric)
    data = np.asarray(data, np.float32)
    if data.shape[0] == 0:
        return np.zeros(0, np.int32)
    dev = resolve_device(device)
    cents = _upload(np.asarray(centroids, np.float32), dev)
    return _assign(_upload(data, dev), cents, metric, block,
                   compute_dtype).int().cpu().numpy()
