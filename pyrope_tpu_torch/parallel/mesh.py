"""Device meshes and the shard merge (port of ``pyrope_tpu/parallel/mesh.py``).

The JAX package runs its sharded families under one controller:
``jax.shard_map`` over a ``Mesh``, driven from one Python process, behind
the same ``VectorIndex`` API as every other family. The port keeps that
model: a ``Mesh`` here is a small object holding an array of
``torch.device`` and its axis names, and a sharded index holds per-shard
tensors on those devices. Each shard's work is the port's own scan
(kernels or plain torch) launched at shard shapes from this process; the
JAX all-gather + top-k of the [B, k] lists becomes a copy of each shard's
list to the merging device and one merge (``ops/fused_scan.merge_partials``:
the merge kernel on CUDA tensors, its plain version on CPU ones).

Axes: ``data`` (corpus rows), ``batch`` (queries, on a 2-D batch x data
mesh), ``slice`` (rows over slice x data on a multi-slice mesh). The JAX
package merges a multi-slice mesh data-first to keep traffic off the links
between TPU slices; one CUDA controller addresses one node's cards, so no
list crosses a slice link here and every row shard merges in one step
(the same answer: the merge is a top-k of the union). A mesh may repeat a
device: ``devices=["cuda:0"] * 4`` holds four shards on one card, the
counterpart of the JAX tests' virtual CPU devices; it exercises the shard
layouts, per-shard launches and the merge, and measures no interconnect.
On "cpu" a mesh is n logical shards of the CPU (8 unless asked).

Merge order. ``lax.top_k`` over the gathered lists breaks ties by position,
which is shard-major, then the shard's own (score desc, row asc) order. A
shard's rows are encoded ``shard * stride + local`` (or block-sharded
global rows), so the merge's key, score desc then lower row, gives the
same order.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

from pyrope_tpu_torch.device import resolve_device

DATA_AXIS = "data"    # corpus-row sharding axis
BATCH_AXIS = "batch"  # query-batch sharding axis (2-D meshes)
SLICE_AXIS = "slice"  # outer row axis of a multi-slice mesh

CPU_SHARDS = 8        # logical shards of a CPU mesh when none is asked


class Mesh:
    """An array of ``torch.device`` with named axes (JAX's Mesh shape)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        for i, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[i] = resolve_device(d)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-D devices for axes {tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device_list(n: Optional[int], device, devices) -> list:
    """The devices a mesh of ``n`` takes: ``devices`` as given (repeats
    allowed), else the first n cards on "cuda" (raising if the machine has
    fewer), else n logical CPU shards."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if n is not None:
            if n > len(devs):
                raise ValueError(f"asked for {n} devices, have {len(devs)}")
            devs = devs[:n]
        return devs
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (CPU_SHARDS if n is None else n)
    have = torch.cuda.device_count()
    n = have if n is None else n
    if n > have:
        raise ValueError(f"asked for {n} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: int | None = None, axis: str = DATA_AXIS, *,
              device="cuda", devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (see _device_list)."""
    return Mesh(np.array(_device_list(n_devices, device, devices), dtype=object), (axis,))


def make_mesh_2d(batch: int, data: int, *, device="cuda", devices=None) -> Mesh:
    """2-D (batch x data) mesh: queries split over ``batch``, corpus rows
    over ``data``."""
    devs = _device_list(batch * data, device, devices)
    return Mesh(np.array(devs, dtype=object).reshape(batch, data), (BATCH_AXIS, DATA_AXIS))


def make_mesh_multislice(n_slices: int, per_slice: int | None = None, *,
                         device="cuda", devices=None) -> Mesh:
    """2-D (slice x data) mesh: corpus rows shard over both axes (kept for
    the JAX package's API; the merge takes every row shard in one step).
    Slices group the devices in order (CUDA exposes no slice grouping; the
    JAX package groups by ``slice_index`` where it has one)."""
    devs = _device_list(None if per_slice is None else n_slices * per_slice,
                        device, devices)
    if len(devs) % n_slices:
        raise ValueError(f"{len(devs)} devices not divisible by {n_slices} slices")
    arr = np.array(devs, dtype=object).reshape(n_slices, len(devs) // n_slices)
    return Mesh(arr, (SLICE_AXIS, DATA_AXIS))


def row_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes corpus rows shard over: (slice, data) on a multi-slice
    mesh, (data,) otherwise; slice-major, so a shard's rows are contiguous
    in the global order."""
    return (SLICE_AXIS, DATA_AXIS) if SLICE_AXIS in mesh.axis_names else (DATA_AXIS,)


def row_shard_count(mesh: Mesh) -> int:
    """Number of row shards = product of the row-axis sizes."""
    n = 1
    for a in row_axes(mesh):
        n *= int(mesh.shape[a])
    return n


def shard_grid(mesh: Mesh, rows: Sequence[str]) -> np.ndarray:
    """[groups, shards] devices: a group per ``batch`` index (1 without a
    batch axis), a shard per index of the ``rows`` axes (slice-major).
    Other axes replicate the shards (the JAX specs that name only some
    axes): their first index holds them."""
    kept = [a for a in mesh.axis_names if a in rows or a == BATCH_AXIS]
    arr = mesh.devices[tuple(slice(None) if a in kept else 0 for a in mesh.axis_names)]
    if BATCH_AXIS in kept:
        arr = np.moveaxis(arr, kept.index(BATCH_AXIS), 0)
        return arr.reshape(arr.shape[0], -1)
    return arr.reshape(1, -1)


def default_mesh(device="cuda") -> Mesh:
    return make_mesh(device=device)


def on_device(device: torch.device):
    """The CUDA device context a launch on ``device`` needs (the kernels'
    C entries launch on the thread's current device); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def replicate_shards(grid: np.ndarray, shards: list[dict]) -> list[list[dict]]:
    """Per-group copies of per-shard state built on group 0's devices: a
    group whose device for shard s is group 0's shares its tensors (one
    card holding a 2 x 2 mesh keeps one copy of each shard)."""
    out = [shards]
    for g in range(1, grid.shape[0]):
        out.append([st if grid[g, s] == grid[0, s] else
                    {k: v.to(grid[g, s]) if isinstance(v, torch.Tensor) else v
                     for k, v in st.items()}
                    for s, st in enumerate(shards)])
    return out


def allgather_merge_topk(parts, k: int, device: torch.device):
    """The sharded-scan merge tail: every shard's [B, k] list (scores f32,
    encoded rows) copied to ``device``, stacked [nd, B, k] and merged to
    the final top-k by (score desc, row asc). Missing hits are -inf / -1.
    A row appears at most once across the lists, as the shards' scans give
    them (disjoint rows, one entry a row): a row repeated with two scores is
    outside the merge's contract, and the kernel and its plain version may
    keep different copies of it."""
    from pyrope_tpu_torch.ops.fused_scan import merge_partials

    vals = torch.stack([v.to(device).float() for v, _ in parts]).contiguous()
    rows = torch.stack([r.to(device).int() for _, r in parts]).contiguous()
    with on_device(device):
        return merge_partials(vals, rows, k=k)


def sharded_call(mesh: Mesh, rows: Sequence[str], shards: list[list[dict]], q: torch.Tensor,
                 local, k: int, prep=None):
    """One controller's shard_map: q [B, D] split over the batch groups;
    in group g each shard s runs ``local(s, shards[g][s], q_g)`` on its
    device -> its [B_g, k] (scores, encoded rows); the group's lists merge
    on its first device; the groups' results join on the mesh's first
    device (the JAX outputs, sharded over batch, gathered). ``prep(g,
    q_g)``, where given, is work every shard of a group would repeat (the
    same tensor from replicated state): it runs once on the group's first
    device, and its tensor is copied to each shard as local's fourth
    argument.

    The shards are issued one after another from this thread: they overlap
    on the devices only where a shard's work does not wait on the host
    (a beam that reads its exit test each step serializes the shards)."""
    grid = shard_grid(mesh, rows)
    groups = torch.tensor_split(q, grid.shape[0]) if grid.shape[0] > 1 else (q,)
    out = []
    for g, qg in enumerate(groups):
        pre = ()
        if prep is not None:
            with on_device(grid[g, 0]):
                pre = (prep(g, qg.to(grid[g, 0])),)
        parts = []
        for s, dev in enumerate(grid[g]):
            with on_device(dev):
                parts.append(local(s, shards[g][s], qg.to(dev), *(t.to(dev) for t in pre)))
        out.append(allgather_merge_topk(parts, k, grid[g, 0]))
    if len(out) == 1:
        return out[0]
    first = grid[0, 0]
    return (torch.cat([v.to(first) for v, _ in out]),
            torch.cat([r.to(first) for _, r in out]))


def encode_rows(rows: torch.Tensor, base: int) -> torch.Tensor:
    """Local rows -> the global candidate space (-1 stays -1)."""
    return torch.where(rows >= 0, rows.long() + base, -1).int()
