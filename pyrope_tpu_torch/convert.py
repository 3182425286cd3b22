"""State carried across from the JAX package.

The JAX package's indexes hold numpy host state; their snapshots store it
under fixed keys (``pyrope_tpu.ivf_flat.v1``, ``pyrope_tpu.ivf_pq.v1``,
``pyrope_tpu.flat.v1``, ``pyrope_tpu.hnsw.v1``, and the manifest of
``pyrope_tpu.sharded_hnsw.v1``). These functions build the port's index
from such arrays on a given device, or for the sharded families on a given
mesh (their snapshots are the single families' formats: the mesh lays
them out), so both packages search the same partition: same centroids,
same cluster-major slab, same lists, for IVF-PQ the same codebooks and
codes, and for HNSW the same graph.
Loading a JAX snapshot is this applied to ``np.load`` (the port's ``load``
runs the same ``_restore``).

``arrays`` is any mapping with the snapshot's keys: an ``np.load`` result,
or a dict built from a live JAX index. ``meta`` may be the snapshot's json
text or a dict. A bf16 slab is rounded from the fp32 rows the snapshot
holds, to nearest-even as JAX rounds it, so it is bit-equal to the JAX
index's. Options the snapshots do not record (``selection``,
``compute_dtype``, ``train_dtype``) are set on a constructed index that then
``load``s the snapshot, as in the JAX package.
"""

from __future__ import annotations

import json

import numpy as np

from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex
from pyrope_tpu_torch.index.flat import FlatIndex, read_meta
from pyrope_tpu_torch.index.hnsw import FORMAT as HNSW_FORMAT, HnswIndex
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
from pyrope_tpu_torch.index.ivf_pq import COARSE_SEED, FORMAT, IvfPqIndex
from pyrope_tpu_torch.parallel.sharded_flat import ShardedFlatIndex
from pyrope_tpu_torch.parallel.sharded_hnsw import ShardedHnswCorpusIndex
from pyrope_tpu_torch.parallel.sharded_ivf import ShardedIvfFlatIndex
from pyrope_tpu_torch.parallel.sharded_ivf_pq import ShardedIvfPqIndex


def _ivf_flat_kwargs(meta) -> dict:
    return dict(nlist=int(meta["nlist"]), nprobe=int(meta["nprobe"]),
                seed=int(meta.get("seed", 42)), scan_mode=str(meta.get("scan_mode", "auto")))


def _ivf_pq_kwargs(meta) -> dict:
    return dict(nlist=int(meta["nlist"]), pq_m=int(meta["pq_m"]), ksub=int(meta["ksub"]),
                nprobe=int(meta["nprobe"]), seed=int(meta.get("seed", COARSE_SEED)),
                refine=int(meta.get("refine", 64)),
                refine_storage=str(meta.get("refine_storage", "fp32")),
                scan_mode=str(meta.get("scan_mode", "auto")))


def ivf_flat_from_arrays(arrays, device="cuda") -> IvfFlatIndex:
    """IvfFlatIndex on ``device`` from ``pyrope_tpu.ivf_flat.v1`` arrays:
    meta, centroids, xperm, perm_ids, alive, offsets, lens, buf_ids,
    buf_vecs."""
    meta = read_meta(arrays, "pyrope_tpu.ivf_flat.v1")
    ix = IvfFlatIndex(int(meta["dim"]), meta["metric"], device=device,
                      **_ivf_flat_kwargs(meta))
    ix._restore(arrays)
    return ix


def ivf_pq_from_arrays(arrays, device="cuda") -> IvfPqIndex:
    """IvfPqIndex on ``device`` from ``pyrope_tpu.ivf_pq.v1`` arrays: meta,
    centroids, codebooks, xperm, codes, perm_ids, alive, offsets, lens,
    buf_ids, buf_vecs."""
    meta = read_meta(arrays, FORMAT)
    ix = IvfPqIndex(int(meta["dim"]), meta["metric"], device=device, **_ivf_pq_kwargs(meta))
    ix._restore(arrays)
    return ix


def flat_from_arrays(arrays, device="cuda") -> FlatIndex:
    """FlatIndex on ``device`` from ``pyrope_tpu.flat.v1`` arrays: meta,
    ids, vecs; the storage ("fp32", "bf16" or "sq8") as meta names it. An
    sq8 index quantizes the fp32 rows as the JAX package's does, so its
    codes equal the JAX index's."""
    meta = read_meta(arrays, "pyrope_tpu.flat.v1")
    ix = FlatIndex(int(meta["dim"]), meta["metric"], device=device,
                   storage=str(meta.get("storage", "fp32")))
    ix._restore(arrays)
    return ix


def hnsw_from_arrays(arrays, device="cuda") -> HnswIndex:
    """HnswIndex on ``device`` from ``pyrope_tpu.hnsw.v1`` arrays: meta,
    vecs, alive, levels, adj0, adj_up, ids (the same graph, entry and top
    level)."""
    meta = read_meta(arrays, HNSW_FORMAT)
    ix = HnswIndex(int(meta["dim"]), meta["metric"], device=device)
    ix._restore(arrays)
    return ix


def device_flat_from_arrays(arrays, device="cuda") -> DeviceFlatIndex:
    """DeviceFlatIndex on ``device`` from ``pyrope_tpu.flat.v1`` arrays
    (meta, ids, vecs), as a DeviceFlatIndex writes them: with
    ``implicit_ids`` the rows keep their implicit ``str(row)`` ids; a bf16
    storage re-adopts the rows rounded to bf16."""
    meta = read_meta(arrays, "pyrope_tpu.flat.v1")
    ix = DeviceFlatIndex(np.zeros((1, int(meta["dim"])), np.float32), meta["metric"],
                         device=device)
    ix._restore(arrays)
    return ix


def sharded_flat_from_arrays(arrays, mesh) -> ShardedFlatIndex:
    """ShardedFlatIndex on ``mesh`` from ``pyrope_tpu.flat.v1`` arrays (the
    JAX ShardedFlatIndex's snapshot); the storage as meta names it."""
    meta = read_meta(arrays, "pyrope_tpu.flat.v1")
    ix = ShardedFlatIndex(int(meta["dim"]), meta["metric"], mesh=mesh,
                          storage=str(meta.get("storage", "fp32")))
    ix._restore(arrays)
    return ix


def sharded_ivf_flat_from_arrays(arrays, mesh, shard_by: str = "rows") -> ShardedIvfFlatIndex:
    """ShardedIvfFlatIndex on ``mesh`` from ``pyrope_tpu.ivf_flat.v1``
    arrays; ``shard_by`` (not in the snapshot) picks the layout."""
    meta = read_meta(arrays, "pyrope_tpu.ivf_flat.v1")
    ix = ShardedIvfFlatIndex(int(meta["dim"]), meta["metric"], mesh=mesh,
                             shard_by=shard_by, **_ivf_flat_kwargs(meta))
    ix._restore(arrays)
    return ix


def sharded_ivf_pq_from_arrays(arrays, mesh) -> ShardedIvfPqIndex:
    """ShardedIvfPqIndex on ``mesh`` from ``pyrope_tpu.ivf_pq.v1`` arrays
    (an fp32 or bf16 rerank slab)."""
    meta = read_meta(arrays, FORMAT)
    ix = ShardedIvfPqIndex(int(meta["dim"]), meta["metric"], mesh=mesh,
                           **_ivf_pq_kwargs(meta))
    ix._restore(arrays)
    return ix


def sharded_hnsw_corpus_from_arrays(meta, shards, mesh) -> ShardedHnswCorpusIndex:
    """ShardedHnswCorpusIndex on ``mesh`` from ``pyrope_tpu.sharded_hnsw.v1``
    state: the manifest (a dict, or its json text) and each shard's
    ``pyrope_tpu.hnsw.v1`` arrays, one a mesh device in order."""
    meta = dict(meta) if isinstance(meta, dict) else json.loads(str(meta))
    ix = ShardedHnswCorpusIndex(int(meta["dim"]), meta["metric"], mesh=mesh)
    ix._restore(meta, shards)
    return ix
