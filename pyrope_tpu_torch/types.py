"""Core public types (the port's copy of ``pyrope_tpu/types.py``).

The JAX package's ``Metric`` is another class: code that crosses from one
package to the other passes the metric's string value (``"L2"``, ``"IP"``).

Mirrors the contract surface of the reference engine
(ref: src/Pyrope.GarnetServer/Vector/IVectorIndex.cs:5-31,
 Vector/SearchOptions.cs:3, Model/IndexConfig.cs:7-36).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class Metric(str, enum.Enum):
    """Distance metric (ref: IVectorIndex.cs VectorMetric{L2,InnerProduct,Cosine})."""

    L2 = "L2"
    INNER_PRODUCT = "IP"
    COSINE = "COSINE"

    @classmethod
    def parse(cls, s: "str | Metric") -> "Metric":
        if isinstance(s, Metric):
            return s
        t = s.strip().upper().replace("-", "_").replace(" ", "_")
        aliases = {
            "L2": cls.L2,
            "EUCLIDEAN": cls.L2,
            "IP": cls.INNER_PRODUCT,
            "INNERPRODUCT": cls.INNER_PRODUCT,
            "INNER_PRODUCT": cls.INNER_PRODUCT,
            "DOT": cls.INNER_PRODUCT,
            "COSINE": cls.COSINE,
            "COS": cls.COSINE,
        }
        if t not in aliases:
            raise ValueError(f"unknown metric: {s!r}")
        return aliases[t]


@dataclasses.dataclass(frozen=True)
class SearchOptions:
    """Per-query knobs (ref: Vector/SearchOptions.cs:3).

    max_scans: cap on number of rows scanned (exact indexes).
    nprobe: number of IVF lists probed (default 3, ref IvfFlatVectorIndex.cs:14).
    ef_search: HNSW beam width override.
    """

    max_scans: Optional[int] = None
    nprobe: Optional[int] = None
    ef_search: Optional[int] = None


DEFAULT_SEARCH_OPTIONS = SearchOptions()


@dataclasses.dataclass(frozen=True)
class SearchResult:
    """One hit (ref: IVectorIndex.cs SearchResult(Id, Score))."""

    id: str
    score: float


@dataclasses.dataclass(frozen=True)
class IndexStats:
    """Index statistics (ref: IVectorIndex.cs IndexStats(Count, Dim, Metric))."""

    count: int
    dim: int
    metric: Metric


@dataclasses.dataclass
class IndexParams:
    """Algorithm parameters (ref: Model/IndexConfig.cs params block,
    consumed at Services/VectorIndexRegistry.cs:87-126)."""

    m: int = 16                 # HNSW links / PQ subspaces (context-dependent)
    ef_construction: int = 200  # HNSW build beam
    ef_search: int = 10         # HNSW query beam (ref default 10)
    nlist: int = 100            # IVF coarse lists
    k: int = 256                # PQ sub-codebook size
    pq_m: int = 4               # PQ subspaces (ref IVF_PQ config m=4)
    nprobe: int = 3             # IVF probes (ref CombineNProbe=3)
    refine: int = 64            # IVF-PQ exact-rerank shortlist factor (0=off)
    refine_storage: str = "fp32"  # IVF-PQ rerank slab: fp32 | bf16 | sq8res
    scan_mode: str = "auto"     # IVF scan kernel: auto | dense | probe
    train_init: str = "kmeans++"  # IVF coarse init: kmeans++ | sample
    neighbor_heuristic: bool = True  # HNSW link selection (False = ref closest-M)
    build_mode: str = "auto"    # HNSW bulk build: auto | incremental | bootstrap
    search_dtype: str = "float32"  # HNSW beam slab: float32 | bfloat16 (+fp32 rerank)

    @classmethod
    def from_dict(cls, d: "dict[str, Any] | None") -> "IndexParams":
        p = cls()
        if not d:
            return p
        for key, val in d.items():
            kk = key.lower()
            if kk in ("m",):
                p.m = int(val)
            elif kk in ("ef_construction", "efconstruction"):
                p.ef_construction = int(val)
            elif kk in ("ef_search", "efsearch"):
                p.ef_search = int(val)
            elif kk in ("nlist", "n_list"):
                p.nlist = int(val)
            elif kk in ("k", "ksub", "k_sub"):
                p.k = int(val)
            elif kk in ("pq_m", "pqm"):
                p.pq_m = int(val)
            elif kk in ("nprobe", "n_probe"):
                p.nprobe = int(val)
            elif kk in ("refine",):
                p.refine = int(val)
            elif kk in ("refine_storage", "refinestorage"):
                rs = str(val).lower()
                if rs not in ("fp32", "bf16", "sq8res"):
                    raise ValueError(
                        f"refine_storage must be fp32|bf16|sq8res, got {val!r}")
                p.refine_storage = rs
            elif kk in ("scan_mode", "scanmode"):
                sm = str(val).lower()
                if sm not in ("auto", "dense", "probe"):
                    raise ValueError(f"scan_mode must be auto|dense|probe, got {val!r}")
                p.scan_mode = sm
            elif kk in ("train_init", "traininit"):
                ti = str(val).lower()
                if ti not in ("kmeans++", "sample"):
                    raise ValueError(f"train_init must be kmeans++|sample, got {val!r}")
                p.train_init = ti
            elif kk in ("neighbor_heuristic", "neighborheuristic"):
                p.neighbor_heuristic = bool(val) if not isinstance(val, str) \
                    else val.lower() in ("1", "true", "yes", "on")
            elif kk in ("build_mode", "buildmode"):
                bm = str(val).lower()
                if bm not in ("auto", "incremental", "bootstrap"):
                    raise ValueError(
                        f"build_mode must be auto|incremental|bootstrap, got {val!r}"
                    )
                p.build_mode = bm
            elif kk in ("search_dtype", "searchdtype"):
                sd = str(val).lower()
                if sd in ("bf16", "bfloat16"):
                    p.search_dtype = "bfloat16"
                elif sd in ("fp32", "float32"):
                    p.search_dtype = "float32"
                else:
                    raise ValueError(
                        f"search_dtype must be bfloat16|float32, got {val!r}"
                    )
            else:
                raise ValueError(f"unknown index param {key!r}")
        return p


@dataclasses.dataclass
class IndexConfig:
    """Per-index configuration (ref: Model/IndexConfig.cs:7-36).

    ``head_algorithm`` picks the Delta head family: FLAT (the reference's
    BruteForce default) or HNSW (the reference's Delta supports both heads,
    ref: DeltaVectorIndex.cs:124-158 Scan() of BruteForce or HNSW)."""

    dim: int
    metric: Metric = Metric.L2
    algorithm: str = "IVF_FLAT"  # FLAT | IVF_FLAT | IVF_PQ | HNSW (ref default IVF_FLAT)
    params: IndexParams = dataclasses.field(default_factory=IndexParams)
    head_algorithm: str = "FLAT"  # FLAT | HNSW

    def to_dict(self) -> dict:
        return {
            "dim": self.dim,
            "metric": self.metric.value,
            "algorithm": self.algorithm,
            "params": dataclasses.asdict(self.params),
            "head_algorithm": self.head_algorithm,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "IndexConfig":
        return cls(
            dim=int(d["dim"]),
            metric=Metric.parse(d.get("metric", "L2")),
            algorithm=str(d.get("algorithm", "IVF_FLAT")).upper(),
            params=IndexParams.from_dict(d.get("params")),
            head_algorithm=str(d.get("head_algorithm", "FLAT")).upper(),
        )
