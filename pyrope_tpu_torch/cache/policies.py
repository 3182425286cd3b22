"""Hot-path cache admission policy engines.

Rebuild of the reference's policy stack (ref: Policies/*):

- ``PolicyEngine.evaluate(QueryKey) -> PolicyDecision{should_cache, ttl}``
  + ``update_policy(WarmPathPolicy)`` from the AI sidecar
  (ref: Policies/IPolicyEngine.cs:6-19)
- ``StaticPolicyEngine``: always-cache with fixed TTL, atomic state swap
  (ref: Policies/StaticPolicyEngine.cs:6-35)
- ``DynamicPolicyEngine`` + ``CachePolicyStore``: reads an atomically
  swapped ``CachePolicyConfig{enable_cache, default_ttl_seconds=60}`` and
  maps sidecar ``WarmPathPolicy.ttl_seconds`` into the store
  (ref: Policies/DynamicPolicyEngine.cs:6-46, Policies/CachePolicyStore.cs:7-16,
   Model/CachePolicyConfig.cs:3-8)

``WarmPathPolicy`` mirrors the proto message the sidecar returns
(ref: src/Protos/policy_service.proto:83-87).
"""

from __future__ import annotations

import abc
import dataclasses
import threading
from typing import Optional

from pyrope_tpu_torch.cache.query_key import QueryKey


@dataclasses.dataclass(frozen=True)
class WarmPathPolicy:
    """Sidecar policy (ref: policy_service.proto:83-87)."""

    admission_threshold: float = 0.1
    ttl_seconds: int = 60
    eviction_priority: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "WarmPathPolicy":
        return cls(
            admission_threshold=float(d.get("admission_threshold", 0.1)),
            ttl_seconds=int(d.get("ttl_seconds", 60)),
            eviction_priority=int(d.get("eviction_priority", 0)),
        )


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    should_cache: bool
    ttl_seconds: float


@dataclasses.dataclass(frozen=True)
class CachePolicyConfig:
    enable_cache: bool = True
    default_ttl_seconds: float = 60.0


class CachePolicyStore:
    """Atomically swapped config (ref: CachePolicyStore.cs:7-16)."""

    def __init__(self, initial: Optional[CachePolicyConfig] = None):
        self._current = initial or CachePolicyConfig()
        self._lock = threading.Lock()

    @property
    def current(self) -> CachePolicyConfig:
        return self._current  # reads are atomic (immutable dataclass swap)

    def update(self, config: CachePolicyConfig) -> None:
        with self._lock:
            self._current = config


class PolicyEngine(abc.ABC):
    @abc.abstractmethod
    def evaluate(self, key: QueryKey) -> PolicyDecision: ...

    @abc.abstractmethod
    def update_policy(self, policy: WarmPathPolicy) -> None: ...


class StaticPolicyEngine(PolicyEngine):
    """Always cache with a fixed TTL."""

    def __init__(self, ttl_seconds: float = 60.0):
        self._decision = PolicyDecision(True, float(ttl_seconds))

    def evaluate(self, key: QueryKey) -> PolicyDecision:
        return self._decision

    def update_policy(self, policy: WarmPathPolicy) -> None:
        self._decision = PolicyDecision(True, float(policy.ttl_seconds))


class DynamicPolicyEngine(PolicyEngine):
    """Reads the shared CachePolicyStore; sidecar updates flow through it."""

    def __init__(self, store: Optional[CachePolicyStore] = None):
        self.store = store or CachePolicyStore()

    def evaluate(self, key: QueryKey) -> PolicyDecision:
        cfg = self.store.current
        return PolicyDecision(cfg.enable_cache, cfg.default_ttl_seconds)

    def update_policy(self, policy: WarmPathPolicy) -> None:
        cur = self.store.current
        self.store.update(
            CachePolicyConfig(
                enable_cache=cur.enable_cache,
                default_ttl_seconds=float(policy.ttl_seconds),
            )
        )
