"""State carried across from the JAX package.

The JAX package's indexes hold numpy host state; their snapshots store it
under fixed keys (``pyrope_tpu.ivf_flat.v1``, ``pyrope_tpu.ivf_pq.v1``,
``pyrope_tpu.flat.v1``). These functions build the port's index from such
arrays on a given device, so both packages search the same partition:
same centroids, same cluster-major slab, same lists, and for IVF-PQ the
same codebooks and codes. Loading a JAX snapshot is this applied to
``np.load`` (the port's ``load`` runs the same ``_restore``).

``arrays`` is any mapping with the snapshot's keys: an ``np.load`` result,
or a dict built from a live JAX index. ``meta`` may be the snapshot's json
text or a dict. A bf16 slab is rounded from the fp32 rows the snapshot
holds, to nearest-even as JAX rounds it, so it is bit-equal to the JAX
index's. Options the snapshots do not record (``selection``,
``compute_dtype``, ``train_dtype``) are set on a constructed index that then
``load``s the snapshot, as in the JAX package.
"""

from __future__ import annotations

from pyrope_tpu_torch.index.flat import FlatIndex, read_meta
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
from pyrope_tpu_torch.index.ivf_pq import COARSE_SEED, FORMAT, IvfPqIndex


def ivf_flat_from_arrays(arrays, device="cuda") -> IvfFlatIndex:
    """IvfFlatIndex on ``device`` from ``pyrope_tpu.ivf_flat.v1`` arrays:
    meta, centroids, xperm, perm_ids, alive, offsets, lens, buf_ids,
    buf_vecs."""
    meta = read_meta(arrays, "pyrope_tpu.ivf_flat.v1")
    ix = IvfFlatIndex(int(meta["dim"]), meta["metric"], device=device,
                      nlist=int(meta["nlist"]), nprobe=int(meta["nprobe"]),
                      seed=int(meta.get("seed", 42)),
                      scan_mode=str(meta.get("scan_mode", "auto")))
    ix._restore(arrays)
    return ix


def ivf_pq_from_arrays(arrays, device="cuda") -> IvfPqIndex:
    """IvfPqIndex on ``device`` from ``pyrope_tpu.ivf_pq.v1`` arrays: meta,
    centroids, codebooks, xperm, codes, perm_ids, alive, offsets, lens,
    buf_ids, buf_vecs."""
    meta = read_meta(arrays, FORMAT)
    ix = IvfPqIndex(int(meta["dim"]), meta["metric"], device=device,
                    nlist=int(meta["nlist"]), pq_m=int(meta["pq_m"]),
                    ksub=int(meta["ksub"]), nprobe=int(meta["nprobe"]),
                    seed=int(meta.get("seed", COARSE_SEED)),
                    refine=int(meta.get("refine", 64)),
                    refine_storage=str(meta.get("refine_storage", "fp32")),
                    scan_mode=str(meta.get("scan_mode", "auto")))
    ix._restore(arrays)
    return ix


def flat_from_arrays(arrays, device="cuda") -> FlatIndex:
    """FlatIndex on ``device`` from ``pyrope_tpu.flat.v1`` arrays: meta,
    ids, vecs; the storage ("fp32" or "bf16") as meta names it."""
    meta = read_meta(arrays, "pyrope_tpu.flat.v1")
    ix = FlatIndex(int(meta["dim"]), meta["metric"], device=device,
                   storage=str(meta.get("storage", "fp32")))
    ix._restore(arrays)
    return ix
