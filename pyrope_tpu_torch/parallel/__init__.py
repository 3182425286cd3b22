"""Sharded execution (port of ``pyrope_tpu/parallel``): meshes, the
sharded Flat, IVF-Flat, IVF-PQ and HNSW families, and the sharded k-means
step, under one controller. A ``Mesh`` holds torch devices; a sharded
index holds per-shard tensors on them, runs the port's scans per shard at
shard shapes and merges the [B, k] lists (mesh.py). Delta composes sharded
halves (index/delta.py takes any two VectorIndex instances).
"""

from pyrope_tpu_torch.parallel.mesh import (
    default_mesh,
    make_mesh,
    make_mesh_2d,
    make_mesh_multislice,
)
from pyrope_tpu_torch.parallel.sharded_flat import ShardedFlatIndex, sharded_kmeans_step
from pyrope_tpu_torch.parallel.sharded_hnsw import (
    ShardedHnswCorpusIndex,
    ShardedHnswIndex,
)
from pyrope_tpu_torch.parallel.sharded_ivf import ShardedIvfFlatIndex
from pyrope_tpu_torch.parallel.sharded_ivf_pq import ShardedIvfPqIndex

__all__ = [
    "default_mesh",
    "make_mesh",
    "make_mesh_2d",
    "make_mesh_multislice",
    "ShardedFlatIndex",
    "ShardedHnswCorpusIndex",
    "ShardedHnswIndex",
    "ShardedIvfFlatIndex",
    "ShardedIvfPqIndex",
    "sharded_kmeans_step",
]
