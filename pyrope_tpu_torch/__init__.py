"""pyrope_tpu_torch — the PyTorch + CUDA port of pyrope_tpu.

A second package beside the JAX one, held against it as its reference. It
imports nothing of the JAX package and never jax: it keeps its own copies of
the framework-free modules (``types``, ``index/base``, ``index/delta``,
``utils``, ``native`` loader). Ported so far:

- ``FlatIndex``     — exact scan; ``selection="pallas"`` runs the fused CUDA
  scan kernel (ops/fused_scan.py, csrc/fused_scan.cu); fp32, bf16 or sq8
  storage
- ``DeviceFlatIndex`` — frozen exact scan over a slab already on the card
  (adopted in place, no host copy), the same scan kernel
- ``IvfFlatIndex``  — k-means + cluster-major slab; dense routes run the
  cluster-major list scan kernel (csrc/ivf_list_scan.cu)
- ``IvfPqIndex``    — coarse k-means + PQ codes + a rerank slab, fp32 or
  residual-SQ8 (``refine_storage="sq8res"``, the list scan in SQ8 mode)
- ``HnswIndex``     — host-built graph (native C++ builder, or the device
  bootstrap at 200k rows and up), batched beam search in plain torch
- ``DeltaIndex``    — the Head+Tail composite (numpy only)
- ``create_index`` / ``VectorIndexRegistry`` — Delta(Flat|HNSW,
  Flat|IVF_FLAT|IVF_PQ|HNSW)
- ``parallel``      — the sharded families (Flat, IVF-Flat, IVF-PQ, HNSW)
  over a mesh of devices driven from one process; each shard runs the
  scan kernels above at shard shapes, the merge kernel joins the shards

Every index and op takes a ``device``, ``"cuda"`` unless the caller asks
for the CPU; CUDA on a host without a GPU raises. Importing this package
loads no CUDA state and builds no kernel: the kernels build at first launch.
"""

from pyrope_tpu_torch.types import (
    IndexConfig,
    IndexParams,
    IndexStats,
    Metric,
    SearchOptions,
    SearchResult,
)

__all__ = [
    "Metric",
    "SearchOptions",
    "SearchResult",
    "IndexStats",
    "IndexConfig",
    "IndexParams",
    "FlatIndex",
    "DeviceFlatIndex",
    "IvfFlatIndex",
    "IvfPqIndex",
    "HnswIndex",
    "DeltaIndex",
    "VectorIndexRegistry",
    "create_index",
]

_LAZY = {
    "FlatIndex": "pyrope_tpu_torch.index.flat",
    "DeviceFlatIndex": "pyrope_tpu_torch.index.device_flat",
    "IvfFlatIndex": "pyrope_tpu_torch.index.ivf_flat",
    "IvfPqIndex": "pyrope_tpu_torch.index.ivf_pq",
    "HnswIndex": "pyrope_tpu_torch.index.hnsw",
    "DeltaIndex": "pyrope_tpu_torch.index.delta",
    "VectorIndexRegistry": "pyrope_tpu_torch.registry",
    "create_index": "pyrope_tpu_torch.registry",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
