"""Dry run of the sharded paths on an n-shard CPU mesh (the port's
counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``).

    python -m pyrope_tpu_torch.parallel.dryrun 8

One sharded Lloyd step and one sharded query through the search maker,
then each sharded family built and queried on the same mesh: IVF-Flat in
both layouts and routes, IVF-PQ, SQ8 Flat, both HNSW layouts, a Delta of
sharded halves, the 2-D batch x data mesh and the multi-slice mesh. Every
step asserts its shapes and that the routes agree.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from pyrope_tpu_torch.index.delta import DeltaIndex
from pyrope_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    make_mesh_multislice,
    replicate_shards,
    row_axes,
    shard_grid,
)
from pyrope_tpu_torch.parallel.sharded_flat import (
    ShardedFlatIndex,
    make_sharded_search,
    sharded_kmeans_step,
)
from pyrope_tpu_torch.parallel.sharded_hnsw import ShardedHnswCorpusIndex, ShardedHnswIndex
from pyrope_tpu_torch.parallel.sharded_ivf import ShardedIvfFlatIndex
from pyrope_tpu_torch.parallel.sharded_ivf_pq import ShardedIvfPqIndex
from pyrope_tpu_torch.types import Metric


def dryrun_multichip(n_devices: int) -> None:
    """Build and run every sharded path on an ``n_devices``-shard CPU mesh."""
    mesh = make_mesh(n_devices, device="cpu")
    d, kc, topk, b = 32, 4, 5, 8
    n = 16 * n_devices
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    ids = [str(i) for i in range(n)]

    # 1) build step: one sharded Lloyd iteration (partials summed)
    cents = sharded_kmeans_step(x, np.ones(n, bool), x[:kc], metric=Metric.L2, mesh=mesh)
    assert cents.shape == (kc, d)

    # 2) query step: per-shard top-k + merge through the search maker
    grid = shard_grid(mesh, row_axes(mesh))
    rows = n // n_devices
    xt = torch.from_numpy(x)
    shards = [{"vecs": xt[s * rows:(s + 1) * rows], "sqnorm": (xt[s * rows:(s + 1) * rows] ** 2)
               .sum(1), "alive": torch.ones(rows, dtype=torch.bool), "base": s * rows}
              for s in range(n_devices)]
    search = make_sharded_search(mesh, Metric.L2, topk, None)
    vals, hit_rows = search(replicate_shards(grid, shards), torch.from_numpy(q), n)
    assert vals.shape == (b, topk) and hit_rows.shape == (b, topk)

    # 3) sharded IVF: the dense kernel route and the probe route agree
    ivf = ShardedIvfFlatIndex(d, Metric.L2, mesh=mesh, nlist=kc)
    ivf.add_batch(ids, x)
    ivf.build()
    hits = ivf.search_batch(q, topk)
    assert len(hits) == b and hits[0][0].score <= 0.0
    ivf.scan_mode = "probe"
    assert [h.id for h in ivf.search_batch(q, topk)[0]] == [h.id for h in hits[0]]
    for scan_mode in ("probe", "dense"):   # whole lists a shard
        ivc = ShardedIvfFlatIndex(d, Metric.L2, mesh=mesh, nlist=kc, shard_by="cluster",
                                  scan_mode=scan_mode)
        ivc.add_batch(ids, x)
        ivc.build()
        assert [h.id for h in ivc.search_batch(q, topk)[0]] == [h.id for h in hits[0]]

    # 3b) sharded IVF-PQ, dense and probe
    pq = ShardedIvfPqIndex(d, Metric.L2, mesh=mesh, nlist=kc, pq_m=4, ksub=16)
    pq.add_batch(ids, x)
    pq.build()
    assert len(pq.search_batch(q, topk)) == b
    pq.scan_mode = "probe"
    assert len(pq.search_batch(q, topk)) == b

    # 3c) sharded SQ8 Flat
    s8 = ShardedFlatIndex(d, Metric.L2, mesh=mesh, storage="sq8")
    s8.add_batch(ids, x)
    hits = s8.search_batch(q, topk)
    assert len(hits) == b and len(hits[0]) == topk

    # 3d) HNSW: the graph replicated (queries split), then partitioned
    hn = ShardedHnswIndex(d, Metric.L2, mesh=mesh, m=8, ef_construction=32, ef_search=16)
    hn.add_batch(ids, x)
    assert hn.search_batch(q, topk)[0]
    hc = ShardedHnswCorpusIndex(d, Metric.L2, mesh=mesh, m=8, ef_construction=32,
                                ef_search=16)
    hc.add_batch(ids, x)
    hc.build()
    assert hc.search_batch(q, topk)[0]

    # 3e) Delta over sharded halves: compaction into the sharded tail
    dl = DeltaIndex(ShardedFlatIndex(d, Metric.L2, mesh=mesh),
                    ShardedIvfPqIndex(d, Metric.L2, mesh=mesh, nlist=kc, pq_m=4, ksub=16))
    dl.add_batch(ids[: n // 2], x[: n // 2])
    dl.build()
    dl.add_batch([f"h{i}" for i in range(8)], x[n // 2 : n // 2 + 8])
    assert len(dl.search_batch(q, topk)) == b

    # 4) 2-D batch x data and multi-slice meshes
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_mesh_2d(2, n_devices // 2, device="cpu")
        ivf2 = ShardedIvfFlatIndex(d, Metric.L2, mesh=mesh2d, nlist=kc)
        ivf2.add_batch(ids, x)
        ivf2.build()
        assert ivf2.search_batch(q, topk)[0][0].score <= 0.0
        ms = make_mesh_multislice(2, n_devices // 2, device="cpu")
        fl = ShardedFlatIndex(d, Metric.L2, mesh=ms, selection="pallas")
        fl.add_batch(ids, x)
        assert len(fl.search_batch(q, topk)[0]) == topk
        c2 = sharded_kmeans_step(x, np.ones(n, bool), x[:kc], metric=Metric.L2, mesh=ms)
        np.testing.assert_allclose(c2.numpy(), cents.numpy(), rtol=1e-5, atol=1e-6)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
    print("dryrun ok")
