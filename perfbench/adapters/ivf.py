"""The port's IVF indexes (``IvfFlatIndex``, ``IvfPqIndex``): the class the
configuration names (``index_class``, a dotted path), built by
``add_batch`` + ``build`` and searched by ``device_search`` with the cell's
nprobe."""

from __future__ import annotations

import importlib
from pathlib import Path

import pyrope_tpu_torch
from pyrope_tpu_torch.kernels import build as kernels
from pyrope_tpu_torch.types import SearchOptions

SOURCES = Path(pyrope_tpu_torch.__file__).resolve().parent / "csrc"


def load_kernels() -> None:
    """Build (first run in a checkout) or load the port's kernel library."""
    kernels.load()


def build(cfg: dict, x, ids: list, device):
    module, name = cfg["index_class"].rsplit(".", 1)
    cls = getattr(importlib.import_module(module), name)
    ix = cls(cfg["dim"], cfg["metric"], device=device, **cfg["index_args"])
    ix.add_batch(ids, x)
    ix.build()
    return ix


def searcher(ix, k: int, nprobe: int):
    opts = SearchOptions(nprobe=nprobe)
    return lambda q: ix.device_search(q, k, opts)


def route(ix, batch: int, nprobe: int, k: int) -> str:
    return ix.describe_scan(batch, nprobe, top_k=k)


def state(ix) -> dict:
    """What the reference takes from the program: the k-means centroids
    (its partition cannot be drawn again outside the program)."""
    return {"centroids": ix.get_centroids()}


def resolve(ix, rows):
    return ix.resolve_rows(rows)
