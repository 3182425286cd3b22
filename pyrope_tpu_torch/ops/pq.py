"""Product quantization (port of ``pyrope_tpu/ops/pq.py``).

Codebooks [m][ksub][sub] need dim % m == 0 and ksub <= 256 (uint8 codes);
each subspace is a k-means on L2 with 10 iterations, seeded 42+m;
encoding picks the nearest sub-centroid; the ADC tables score a query
against every codeword of every subspace.

Two training paths, as in the JAX package:
  - ``ProductQuantizer.train`` / ``encode``: per subspace through the
    port's ``kmeans_train(init="sample")`` / ``kmeans_assign`` (the
    fallback for corpora smaller than ksub);
  - ``pq_train_encode_device``: all subspaces at once on a residual buffer
    already on the device, Lloyd's update as the deterministic one-hot
    ``segment_sum`` of ops/kmeans.py, batched over subspaces.
Training and encoding run in fp32; the JAX package's bf16 training
(``compute="bfloat16"``) is not yet ported and raises.

The ADC accumulates are a gather per subspace, summed over subspaces in
the JAX package's order. Its one-hot matmul form is a TPU device for the
lack of a lane gather; a one-hot selects exactly one fp32 entry, so both
forms give the same sums.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyrope_tpu_torch.types import Metric
from pyrope_tpu_torch.ops.distance import check_fp32_exact
from pyrope_tpu_torch.ops.kmeans import kmeans_assign, kmeans_train, segment_sum


@dataclasses.dataclass
class ProductQuantizer:
    m: int                    # number of subspaces
    ksub: int                 # codes per subspace (<= 256)
    dim: int
    codebooks: np.ndarray | None = None  # [m, ksub, sub]

    def __post_init__(self):
        if self.dim % self.m != 0:
            raise ValueError(f"dim {self.dim} not divisible by m {self.m}")
        if self.ksub > 256:
            raise ValueError("ksub must be <= 256 (uint8 codes)")
        self.sub = self.dim // self.m

    @property
    def trained(self) -> bool:
        return self.codebooks is not None

    def _subspace(self, data: np.ndarray, mi: int) -> np.ndarray:
        return np.ascontiguousarray(data[:, mi * self.sub : (mi + 1) * self.sub])

    def train(self, data: np.ndarray, *, device="cuda", seed: int = 42,
              iters: int = 10) -> None:
        """Per-subspace k-means on L2 from sampled rows, seed 42+m. With
        fewer rows than ksub the last centroid fills the unused codes."""
        data = np.asarray(data, np.float32)
        ks = min(self.ksub, data.shape[0])
        cbs = np.zeros((self.m, self.ksub, self.sub), np.float32)
        for mi in range(self.m):
            c = kmeans_train(self._subspace(data, mi), ks, Metric.L2,
                             device=device, seed=seed + mi, iters=iters,
                             init="sample")
            cbs[mi, : c.shape[0]] = c
            cbs[mi, c.shape[0] :] = c[-1]  # unused codes stay harmless
        self.codebooks = cbs

    def encode(self, data: np.ndarray, *, device="cuda") -> np.ndarray:
        """[N, D] -> uint8 codes [N, m] (nearest sub-centroid)."""
        assert self.codebooks is not None
        data = np.asarray(data, np.float32)
        codes = np.empty((data.shape[0], self.m), np.uint8)
        for mi in range(self.m):
            codes[:, mi] = kmeans_assign(self._subspace(data, mi),
                                         self.codebooks[mi], Metric.L2,
                                         device=device)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        """uint8 codes [N, m] -> reconstruction [N, D]."""
        assert self.codebooks is not None
        codes = np.asarray(codes)
        out = np.empty((codes.shape[0], self.dim), np.float32)
        for mi in range(self.m):
            out[:, mi * self.sub : (mi + 1) * self.sub] = self.codebooks[mi][codes[:, mi]]
        return out

    def state(self) -> dict:
        return {"m": self.m, "ksub": self.ksub, "dim": self.dim,
                "codebooks": self.codebooks}

    @classmethod
    def from_state(cls, st: dict) -> "ProductQuantizer":
        pq = cls(m=int(st["m"]), ksub=int(st["ksub"]), dim=int(st["dim"]))
        cb = st.get("codebooks")
        pq.codebooks = None if cb is None or np.size(cb) == 0 else np.asarray(cb, np.float32)
        return pq


def _nearest_codes(xblk: torch.Tensor, cents: torch.Tensor,
                   cc: torch.Tensor) -> torch.Tensor:
    """Nearest sub-centroid of every subspace: xblk [B, M, S], cents
    [M, K, S], cc [M, K] = ||c||^2 -> [M, B] int64. The score 2q.c - ||c||^2
    has its argmax at the L2 argmin (ties to the lower code)."""
    d = torch.einsum("bms,mks->mbk", xblk, cents)
    return torch.argmax(2.0 * d - cc[:, None, :], dim=-1)


def _pq_lloyd(x: torch.Tensor, cents: torch.Tensor, iters: int,
              block: int) -> torch.Tensor:
    """Batched Lloyd over all subspaces: x [N, M, S] (valid rows only),
    cents [M, K, S] -> [M, K, S]. An empty code keeps its codeword."""
    n, m, _ = x.shape
    k = cents.shape[1]
    offs = torch.arange(m, device=x.device)[:, None] * k   # flat (m, code) ids
    for _ in range(iters):
        cc = (cents * cents).sum(dim=-1)
        sums = torch.zeros_like(cents)
        counts = torch.zeros(m * k, dtype=torch.float32, device=x.device)
        for s in range(0, n, block):
            xblk = x[s : s + block]
            a = _nearest_codes(xblk, cents, cc)                  # [M, B]
            sums += segment_sum(a, xblk.transpose(0, 1), k)      # [M, K, S]
            counts += torch.bincount((a + offs).reshape(-1), minlength=m * k).float()
        counts = counts.view(m, k)
        new = sums / torch.clamp(counts, min=1.0)[..., None]
        cents = torch.where(counts[..., None] > 0, new, cents)
    return cents


def _pq_encode(x: torch.Tensor, cents: torch.Tensor, block: int) -> torch.Tensor:
    """Nearest sub-centroid per row and subspace, fp32: x [N, M, S] ->
    codes [N, M] int32."""
    cc = (cents * cents).sum(dim=-1)
    return torch.cat([
        _nearest_codes(x[s : s + block], cents, cc).T.int()
        for s in range(0, x.shape[0], block)
    ])


def pq_train_encode_device(
    r_dev: torch.Tensor,
    n: int,
    pq: ProductQuantizer,
    *,
    seed: int = 42,
    iters: int = 10,
    block: int = 8192,
    compute: str | None = None,
) -> tuple[np.ndarray, torch.Tensor]:
    """Train codebooks and encode a residual buffer on the device (rows >=
    n are padding): the per-subspace seeds, init and Lloyd semantics of
    ``ProductQuantizer.train``, batched over subspaces, with no copy back
    to the host. Requires n >= ksub.

    Returns (codebooks [m, ksub, sub] numpy, codes [N, m] int32 on the
    device, for every row of ``r_dev``). ``compute`` is the JAX package's
    training dtype: only None (fp32) is ported. Unlike the JAX function,
    whose default is "bfloat16", the default here is None."""
    if compute is not None:
        raise NotImplementedError(f"PQ training compute={compute!r} not yet ported")
    m, ksub, sub = pq.m, pq.ksub, pq.sub
    check_fp32_exact(r_dev)
    x = r_dev.float().reshape(r_dev.shape[0], m, sub)
    # per-subspace random-sample init, seed 42+m: the JAX package's draws
    init_rows = np.stack([
        np.random.default_rng(seed + mi).choice(n, size=ksub, replace=False)
        for mi in range(m)
    ])                                                        # [m, ksub]
    rows = torch.from_numpy(init_rows).to(x.device)
    cents0 = x[rows, torch.arange(m, device=x.device)[:, None], :]  # [m, ksub, sub]
    cents = _pq_lloyd(x[:n], cents0, iters, block)
    # the stored codes are the index's truth: always encoded in fp32
    codes = _pq_encode(x, cents, block)
    return cents.cpu().numpy(), codes


# ---- asymmetric distance computation (ADC) -----------------------------------


def adc_l2_table(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query L2² tables: q [B, D] (the residual for IVF-PQ),
    codebooks [M, ksub, sub] -> [B, M, ksub], table[b, m, k] =
    ||q_sub(b, m) - cb[m, k]||²."""
    b = q.shape[0]
    m, _, sub = codebooks.shape
    qs = q.float().reshape(b, m, sub)
    dots = torch.einsum("bms,mks->bmk", qs, codebooks)
    qq = (qs * qs).sum(dim=-1)                            # [B, M]
    cc = (codebooks * codebooks).sum(dim=-1)              # [M, ksub]
    return qq[:, :, None] - 2.0 * dots + cc[None, :, :]


def adc_ip_table(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query dot tables: table[b, m, k] = q_sub(b, m) . cb[m, k]."""
    b = q.shape[0]
    m, _, sub = codebooks.shape
    return torch.einsum("bms,mks->bmk", q.float().reshape(b, m, sub), codebooks)


def adc_accumulate(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table [B, M, ksub], codes [B, L, M] -> [B, L] =
    sum_m table[b, m, codes[b, l, m]], summed in subspace order."""
    acc = None
    for mi in range(table.shape[1]):
        part = torch.gather(table[:, mi, :], 1, codes[:, :, mi].long())
        acc = part if acc is None else acc + part
    return acc


def adc_accumulate_shared(table: torch.Tensor, codes_all: torch.Tensor) -> torch.Tensor:
    """ADC against one code slab shared by every query: table [B, M,
    ksub], codes_all [N, M] -> [B, N]. One [B, N] gather per subspace: a
    single [B, N, M] gather would hold M times the memory."""
    acc = None
    for mi in range(table.shape[1]):
        part = table[:, mi, :].index_select(1, codes_all[:, mi].long())
        acc = part if acc is None else acc + part
    return acc
