"""Build parity on a bench-shaped corpus: the port's IVF-PQ build against
the JAX package's, each from the same numpy rows with the bench's config
and seeds (``ivfpq100k_sq8res_b1024``, ``bench.py:259-261``: 100k x 128
clustered rows, 100 natural clusters, nlist 100, pq_m 16, ksub 256, the
residual-SQ8 rerank slab, 1024 queries).

Scans over ONE build agree exactly (every test_torch_ivf_pq route test
loads the port from the JAX snapshot). Two builds do not: both packages sum
Lloyd's centroid update in fp32, the port as a one-hot matmul
(``ops/kmeans.segment_sum``), the JAX package as ``_lloyd``'s blocked
``jnp.dot``, and no matmul can be made to sum in XLA's order. A centroid
that moves by an ulp moves a boundary row to another list, and a query's
hits can then differ. The bound stated here is what both packages reach:
recall@10 equal, and at least 99% of the queries' hit sets equal. The
share of bit-equal centroid elements is printed, not held.
"""

import numpy as np
import pytest

import pyrope_tpu as jpt
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
from pyrope_tpu_torch.utils.datasets import (
    ground_truth,
    id_lists_to_rows,
    recall_at_k,
    synthetic_clustered,
    synthetic_clustered_queries,
)

N, D, NLIST, B, K = 100_000, 128, 100, 1024, 10
CONFIG = {"nlist": NLIST, "pq_m": 16, "ksub": 256, "refine_storage": "sq8res"}


@pytest.fixture(scope="module")
def builds():
    base = synthetic_clustered(N, D, n_clusters=NLIST)
    queries = synthetic_clustered_queries(B, D, n_clusters=NLIST)
    ids = [str(i) for i in range(N)]
    jix = jpt.IvfPqIndex(D, "L2", **CONFIG)
    tix = IvfPqIndex(D, "L2", device="cpu", **CONFIG)
    rows = {}
    for name, ix in (("jax", jix), ("port", tix)):
        ix.add_batch(ids, base)
        ix.build()
        hits = ix.search_batch(queries, K)
        rows[name] = id_lists_to_rows([[h.id for h in r] for r in hits], K)
    truth = ground_truth(base, queries, K, "L2")
    return jix, tix, rows, truth


def test_ivfpq100k_sq8res_builds_agree_to_the_bound(builds):
    jix, tix, rows, truth = builds
    rj, rp = (recall_at_k(rows[s], truth, K) for s in ("jax", "port"))
    same = sum(set(a) == set(b) for a, b in zip(rows["jax"], rows["port"]))
    cj = np.asarray(jix.get_centroids())
    cp = np.asarray(tix.get_centroids())
    print(f"recall@10 jax {rj} port {rp}; hit sets equal {same}/{B}; "
          f"bit-equal centroid elements {np.mean(cj == cp):.4f}, "
          f"max |diff| {np.abs(cj - cp).max():.3g}")
    assert cj.shape == cp.shape
    assert rp == rj
    assert same >= 0.99 * B
