"""The 1M Zipf rows' partition, built once by the JAX package and carried
into the port.

On ``synthetic_zipf(1_000_000, 128, 1000)`` Lloyd's bf16 iterations do not
converge, so a partition trained by either package moves with the order of
its fp32 sums. ``tests/make_zipf1m_partition.py`` trained the JAX
package's partitions on the CPU (seed 42 for IVF-Flat, 123 for IVF-PQ) and
wrote their centroids to ``tests/data/zipf1m_jax_centroids.npz``; chip_smoke
phase 23 assigns the rows to them on the card in fp32 and holds the recall
there to the JAX package's (``chip_smoke.ZIPF1M_RECALL_JAX``).

Here, on the CPU and on the file's centroids: the JAX package's
``kmeans_assign`` and the port's put every row in the same list but for
ties in fp32 (two centroids whose exact distances lie within an fp32
score's rounding), and each package's partition recall@10 at nprobe 3 (a
query's exact top-10 rows that lie in its three best lists) equals the
recorded constant within 0.005, for the first 256 queries of each seed and
all 1024 of seed 42.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from pyrope_tpu.index.ivf_flat import rank_probes
from pyrope_tpu.ops.kmeans import kmeans_assign as jax_assign
from pyrope_tpu.types import Metric as JMetric
from pyrope_tpu_torch.index.ivf_flat import top_probes
from pyrope_tpu_torch.ops.kmeans import kmeans_assign
from pyrope_tpu_torch.utils.datasets import synthetic_zipf, synthetic_zipf_queries

CENTROIDS = Path(__file__).resolve().parent / "data" / "zipf1m_jax_centroids.npz"
N, DIM, NLIST, NPROBE, K = 1_000_000, 128, 1000, 3, 10


def exact_top10(base: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Each query's exact top-10 rows (L2): a shortlist of 64 by fp32
    distances, ranked again in float64 (ties to the lower row), as the
    script's float64 truth ranks them."""
    x = torch.from_numpy(base)
    sq = (x * x).sum(1)
    out = []
    for s in range(0, len(queries), 256):
        qb = queries[s:s + 256]
        short = torch.topk(sq[None, :] - 2.0 * (torch.from_numpy(qb) @ x.T), 64, dim=1,
                           largest=False).indices.numpy()
        short.sort(axis=1)
        cand = base[short].astype(np.float64)
        d = ((cand - qb[:, None, :].astype(np.float64)) ** 2).sum(2)
        order = np.argsort(d, axis=1, kind="stable")[:, :K]
        out.append(np.take_along_axis(short, order, 1))
    return np.concatenate(out)


def partition_recall(probe: np.ndarray, assign: np.ndarray, truth: np.ndarray) -> float:
    """Share of the true top-10 rows that lie in their query's probed lists."""
    return float((assign[truth][:, :, None] == probe[:, None, :]).any(axis=2).mean())


@pytest.fixture(scope="module")
def corpus():
    base = synthetic_zipf(N, DIM, n_clusters=NLIST)
    queries = synthetic_zipf_queries(1024, DIM, n_clusters=NLIST)
    return base, queries, exact_top10(base, queries)


@pytest.mark.parametrize("seed", [42, 123])
def test_zipf1m_partition_is_the_jax_packages(corpus, seed):
    base, queries, truth = corpus
    with np.load(CENTROIDS) as z:
        cents = z[f"seed{seed}"]
    assert cents.shape == (NLIST, DIM) and cents.dtype == np.float32
    want = np.asarray(jax_assign(base, cents, JMetric.L2))
    got = kmeans_assign(base, cents, "L2", device="cpu")
    # a row may change lists only between two centroids that tie in fp32:
    # their exact distances (float64) apart by less than the rounding of an
    # fp32 score, 2e-6 of |x|^2 + |c|^2 (a 128-term sum at 6e-8 a term);
    # 323 and 406 rows of 1M at seeds 42 and 123, at most 6.9e-7 apart
    diff = np.flatnonzero(got != want)
    x = base[diff].astype(np.float64)
    cg, cw = cents[got[diff]].astype(np.float64), cents[want[diff]].astype(np.float64)
    gap = np.abs(((x - cg) ** 2).sum(1) - ((x - cw) ** 2).sum(1))
    assert (gap <= 2e-6 * ((x * x).sum(1) + (cg * cg).sum(1))).all()
    assert diff.size <= N // 1000, diff.size

    lens = np.bincount(want, minlength=NLIST).astype(np.int32)
    offsets = (np.cumsum(lens) - lens).astype(np.int32)
    jprobe = np.asarray(rank_probes(jnp.asarray(queries), jnp.asarray(cents),
                                    jnp.ones(NLIST, bool), jnp.asarray(offsets),
                                    jnp.asarray(lens), NPROBE, N, JMetric.L2, None)[0])
    tprobe = top_probes(torch.from_numpy(queries), torch.from_numpy(cents),
                        torch.ones(NLIST, dtype=torch.bool), NPROBE, "L2").numpy()
    for nq in ((256, 1024) if seed == 42 else (256,)):
        ref = chip_smoke.ZIPF1M_RECALL_JAX[(seed, nq)]
        jax_rec = partition_recall(jprobe[:nq], want, truth[:nq])
        port_rec = partition_recall(tprobe[:nq], got, truth[:nq])
        assert abs(jax_rec - ref) <= 0.005, (seed, nq, jax_rec, ref)
        assert abs(port_rec - ref) <= 0.005, (seed, nq, port_rec, ref)
