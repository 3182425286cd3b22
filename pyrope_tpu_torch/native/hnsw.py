"""ctypes wrapper for the native HNSW graph builder (the port's copy of
``pyrope_tpu/native/hnsw.py``)."""

from __future__ import annotations

import ctypes

import numpy as np

from pyrope_tpu_torch.native.build import load_native


def hnsw_build_native(
    vecs: np.ndarray,      # [n, dim] float32 (cosine rows pre-normalized)
    levels: np.ndarray,    # [n] int32, pre-drawn geometric levels
    m: int,
    ef_construction: int,
    metric_is_l2: bool,
    heuristic: bool = True,
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Build the whole graph natively: (adj0 [n, 2m], adj_up [max_level, n,
    m], entry, top_level). Raises where the library cannot be built."""
    n, dim = vecs.shape
    if n == 0:
        raise ValueError("hnsw_build_native on an empty corpus")
    lib = load_native()
    v = np.ascontiguousarray(vecs, np.float32)
    sq = np.einsum("nd,nd->n", v, v).astype(np.float32)
    lv = np.ascontiguousarray(levels, np.int32)
    max_level = int(lv.max(initial=0))
    adj0 = np.full((n, 2 * m), -1, np.int32)
    adj_up = np.full((max(max_level, 1), n, m), -1, np.int32)
    top_out = np.zeros(1, np.int32)

    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    entry = lib.hnsw_build(
        v.ctypes.data_as(f32p), sq.ctypes.data_as(f32p),
        n, dim, m, ef_construction,
        0 if metric_is_l2 else 1,
        1 if heuristic else 0,
        lv.ctypes.data_as(i32p), max_level,
        adj0.ctypes.data_as(i32p), adj_up.ctypes.data_as(i32p),
        top_out.ctypes.data_as(i32p),
    )
    return adj0, adj_up[:max_level], int(entry), int(top_out[0])
