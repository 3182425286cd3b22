"""Build the 1M Zipf rows' IVF partitions with the JAX package, on the CPU,
and write their centroids to ``tests/data/zipf1m_jax_centroids.npz``.

bench.py's ``ivf1m_zipf_b1024`` / ``ivf1m_zipf_probe`` (IVF-Flat, seed 42)
and ``ivfpq1m_zipf_b256`` (IVF-PQ, coarse seed ``COARSE_SEED`` 123) train
nlist 1000 lists on ``synthetic_zipf(1_000_000, 128, n_clusters=1000)``
with bf16 Lloyd iterations. There Lloyd's 10 iterations do not converge,
and the partition moves with the order of its fp32 sums, in either
package. So the port's rows are held on the JAX package's own partition:
the card assigns the rows to these centroids in fp32 and must reach the
JAX package's partition recall printed here (chip_smoke's
``ZIPF1M_RECALL_JAX``, held on the CPU by
``tests/test_torch_zipf_partition.py``).

The partition recall@10 at nprobe 3: a query's exact top-10 rows (float64)
that lie in its 3 best lists (the JAX package's ``rank_probes``, fp32),
over 10, averaged. The list-scan and probe routes return it, since both
score every row of the probed lists exactly.

Run from the repo root (~3 min, ~4 GB):

    JAX_PLATFORMS=cpu python3 tests/make_zipf1m_partition.py
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))   # the repo root

from pyrope_tpu.index.ivf_flat import rank_probes  # noqa: E402 (after the path)
from pyrope_tpu.index.ivf_pq import COARSE_SEED  # noqa: E402
from pyrope_tpu.ops.kmeans import kmeans_build  # noqa: E402
from pyrope_tpu.types import Metric  # noqa: E402
from pyrope_tpu.utils.datasets import synthetic_zipf, synthetic_zipf_queries  # noqa: E402

OUT = Path(__file__).resolve().parent / "data" / "zipf1m_jax_centroids.npz"
N, DIM, NLIST, NPROBE, K = 1_000_000, 128, 1000, 3, 10
SEEDS = {"ivf_flat": 42, "ivf_pq": COARSE_SEED}


def exact_truth(base: np.ndarray, queries: np.ndarray, k: int = K) -> np.ndarray:
    """Each query's exact top-k rows (L2), float64, ties to the lower row."""
    x = base.astype(np.float64)
    sq = (x * x).sum(1)
    out = []
    for s in range(0, len(queries), 128):
        d = sq[None, :] - 2.0 * (queries[s:s + 128].astype(np.float64) @ x.T)
        part = np.argpartition(d, k, axis=1)[:, :k + 1]
        part.sort(axis=1)   # ascending rows: the stable sort breaks ties by row
        order = np.argsort(np.take_along_axis(d, part, 1), axis=1, kind="stable")
        out.append(np.take_along_axis(part, order, 1)[:, :k])
    return np.concatenate(out)


def partition_recall(probe: np.ndarray, assign: np.ndarray, truth: np.ndarray) -> float:
    """Share of the true top-k rows that lie in their query's probed lists."""
    hit = (assign[truth][:, :, None] == probe[:, None, :]).any(axis=2)
    return float(hit.mean())


def main() -> int:
    t0 = time.perf_counter()
    base = synthetic_zipf(N, DIM, n_clusters=NLIST)
    queries = synthetic_zipf_queries(1024, DIM, n_clusters=NLIST)
    truth = exact_truth(base, queries)
    print(f"data and truth {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    cents_out, recalls = {}, {}
    for name, seed in SEEDS.items():
        t0 = time.perf_counter()
        cents, assign, _ = kmeans_build(base, NLIST, Metric.L2, seed=seed,
                                        compute_dtype="bfloat16")
        lens = np.bincount(assign, minlength=NLIST).astype(np.int32)
        offsets = (np.cumsum(lens) - lens).astype(np.int32)
        probe = np.asarray(rank_probes(
            jnp.asarray(queries), jnp.asarray(cents), jnp.ones(NLIST, bool),
            jnp.asarray(offsets), jnp.asarray(lens), NPROBE, N, Metric.L2, None)[0])
        cents_out[f"seed{seed}"] = np.asarray(cents, np.float32)
        recalls[f"seed{seed}_q256"] = partition_recall(probe[:256], assign, truth[:256])
        recalls[f"seed{seed}_q1024"] = partition_recall(probe, assign, truth)
        recalls[f"seed{seed}_longest"] = int(lens.max())
        print(f"{name} seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(OUT, **cents_out)
    print(json.dumps(recalls))
    return 0


if __name__ == "__main__":
    sys.exit(main())
