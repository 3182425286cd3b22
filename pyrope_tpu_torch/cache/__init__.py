"""Multi-level semantic result cache.

Rebuild of the reference's cache stack (SURVEY §2.3):

- L0   exact-key result cache        (ref: Model/ResultCache.cs)
- L0.5 canonical-alias map           (ref: DataModel/CanonicalKeyMap.cs)
- L1   SimHash fuzzy key             (ref: Services/LshService.cs)
- L2   semantic-cluster key          (ref: Services/SemanticClusterRegistry.cs)

plus the TTL storage backend (ref: Model/MemoryCacheStorage.cs) and the
hot-path admission policy engines (ref: Policies/*).
"""

from pyrope_tpu_torch.cache.query_key import QueryKey, round_k
from pyrope_tpu_torch.cache.storage import CacheStorage, MemoryCacheStorage
from pyrope_tpu_torch.cache.result_cache import ResultCache
from pyrope_tpu_torch.cache.lsh import LshService
from pyrope_tpu_torch.cache.clusters import SemanticClusterRegistry
from pyrope_tpu_torch.cache.canonical import CanonicalKeyMap
from pyrope_tpu_torch.cache.policies import (
    CachePolicyConfig,
    CachePolicyStore,
    DynamicPolicyEngine,
    PolicyDecision,
    PolicyEngine,
    StaticPolicyEngine,
    WarmPathPolicy,
)

__all__ = [
    "QueryKey",
    "round_k",
    "CacheStorage",
    "MemoryCacheStorage",
    "ResultCache",
    "LshService",
    "SemanticClusterRegistry",
    "CanonicalKeyMap",
    "CachePolicyConfig",
    "CachePolicyStore",
    "DynamicPolicyEngine",
    "PolicyDecision",
    "PolicyEngine",
    "StaticPolicyEngine",
    "WarmPathPolicy",
]
