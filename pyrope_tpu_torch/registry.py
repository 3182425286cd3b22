"""Index factory and multi-tenant registry (port of ``pyrope_tpu/registry.py``).

Every index is a Delta(head=Flat|HNSW, tail=<algo>): the numpy-only
``DeltaIndex`` over the port's Flat, IVF-Flat, IVF-PQ and HNSW indexes, all
on the device the caller names (``"cuda"`` by default). ``get_or_create``
validates dim/metric; a per-index epoch counter backs cache invalidation.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from pyrope_tpu_torch.index.base import VectorIndex
from pyrope_tpu_torch.index.delta import DeltaIndex
from pyrope_tpu_torch.types import IndexConfig, Metric
from pyrope_tpu_torch.device import resolve_device
from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.index.hnsw import HnswIndex
from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex


def create_index(config: IndexConfig, device="cuda") -> DeltaIndex:
    """Delta(head=Flat|HNSW, tail=algo) on ``device``."""
    algo = config.algorithm.upper().replace("-", "_").replace(" ", "_")
    if algo not in ("FLAT", "IVF_FLAT", "IVFFLAT", "IVF_PQ", "IVFPQ", "HNSW"):
        raise ValueError(
            f"unknown algorithm {config.algorithm!r} "
            "(expected FLAT | IVF_FLAT | IVF_PQ | HNSW)"
        )
    dev = resolve_device(device)
    p = config.params
    if config.head_algorithm.upper() == "HNSW":
        head: VectorIndex = HnswIndex(
            config.dim, config.metric, device=dev,
            m=p.m, ef_construction=p.ef_construction, ef_search=p.ef_search,
            neighbor_heuristic=p.neighbor_heuristic, search_dtype=p.search_dtype,
        )
    else:
        head = FlatIndex(config.dim, config.metric, device=dev)
    if algo == "HNSW":
        tail: VectorIndex = HnswIndex(
            config.dim, config.metric, device=dev,
            m=p.m, ef_construction=p.ef_construction, ef_search=p.ef_search,
            neighbor_heuristic=p.neighbor_heuristic, build_mode=p.build_mode,
            search_dtype=p.search_dtype,
        )
    elif algo == "FLAT":
        tail = FlatIndex(config.dim, config.metric, device=dev)
    elif algo in ("IVF_PQ", "IVFPQ"):
        tail = IvfPqIndex(config.dim, config.metric, device=dev, nlist=p.nlist,
                          pq_m=p.pq_m, ksub=p.k, nprobe=p.nprobe,
                          refine=p.refine, refine_storage=p.refine_storage,
                          scan_mode=p.scan_mode, train_init=p.train_init)
    else:  # IVF_FLAT, the default
        tail = IvfFlatIndex(config.dim, config.metric, device=dev,
                            nlist=p.nlist, nprobe=p.nprobe,
                            scan_mode=p.scan_mode, train_init=p.train_init)
    return DeltaIndex(head, tail)


@dataclasses.dataclass
class IndexState:
    """Index + its config + epoch."""

    index: DeltaIndex
    config: IndexConfig
    epoch: int = 0


class VectorIndexRegistry:
    """(tenant, index) -> IndexState with epoch-based cache invalidation;
    every index it creates lives on ``device``."""

    def __init__(self, device="cuda"):
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self._states: dict[tuple[str, str], IndexState] = {}

    @staticmethod
    def _key(tenant: str, index: str) -> tuple[str, str]:
        return (tenant, index)

    def create(self, tenant: str, index: str, config: IndexConfig) -> IndexState:
        with self._lock:
            key = self._key(tenant, index)
            if key in self._states:
                raise ValueError(f"index exists: {tenant}:{index}")
            st = IndexState(index=create_index(config, self._device), config=config)
            self._states[key] = st
            return st

    def get_or_create(
        self, tenant: str, index: str, dim: int, metric: Metric | str = Metric.L2
    ) -> IndexState:
        """Validates dim/metric on existing indexes."""
        metric = Metric.parse(metric)
        with self._lock:
            key = self._key(tenant, index)
            st = self._states.get(key)
            if st is not None:
                if st.config.dim != dim:
                    raise ValueError(
                        f"dim mismatch: index has {st.config.dim}, got {dim}"
                    )
                if st.config.metric != metric:
                    raise ValueError(
                        f"metric mismatch: index has {st.config.metric}, got {metric}"
                    )
                return st
            cfg = IndexConfig(dim=dim, metric=metric)
            st = IndexState(index=create_index(cfg, self._device), config=cfg)
            self._states[key] = st
            return st

    def try_get(self, tenant: str, index: str) -> Optional[IndexState]:
        with self._lock:
            return self._states.get(self._key(tenant, index))

    def increment_epoch(self, tenant: str, index: str) -> int:
        """Invalidates all cached results for the index."""
        with self._lock:
            st = self._states.get(self._key(tenant, index))
            if st is None:
                return -1
            st.epoch += 1
            return st.epoch

    def get_epoch(self, tenant: str, index: str) -> int:
        with self._lock:
            st = self._states.get(self._key(tenant, index))
            return -1 if st is None else st.epoch

    def list_indexes(self) -> list[tuple[str, str]]:
        with self._lock:
            return sorted(self._states.keys())

    def drop(self, tenant: str, index: str) -> bool:
        with self._lock:
            return self._states.pop(self._key(tenant, index), None) is not None
