"""Native (C++) host-side components, loaded through ctypes (the port's
own loader of the top-level ``native/`` sources).

Graph construction for HNSW is sequential host work (insert i depends on
the graph after insert i−1); ``native/hnsw_builder.cc`` does it, the same
source the JAX package builds. The port compiles it with g++ at first use
into ``build/pyrope_tpu_torch/`` and loads it from there. A missing
compiler or a failed build raises with g++'s output: nothing falls back to
per-row Python inserts.
"""

from pyrope_tpu_torch.native.build import load_native, native_available
from pyrope_tpu_torch.native.hnsw import hnsw_build_native

__all__ = ["load_native", "native_available", "hnsw_build_native"]
