"""Tenant registry: configs, quotas, users, API keys.

Rebuild of the reference's tenancy data plane:
- ``TenantQuota`` (ref: Model/TenantConfig.cs:38-57): MaxQps,
  MaxConcurrentRequests, CacheMemoryMb, DailyRequestLimit,
  Priority (0 high / 1 normal / 2 low, default 1), MonthlyBudget.
- ``TenantRegistry`` (ref: Services/TenantRegistry.cs:8-70): tenant →
  config with a global API-key-uniqueness index.
- ``TenantUserRegistry`` (ref: Services/TenantUserRegistry.cs:16-70):
  per-tenant users with a Role and per-user API keys.
"""

from __future__ import annotations

import dataclasses
import secrets
import threading
from typing import Optional

from pyrope_tpu_torch.security.rbac import Role


@dataclasses.dataclass
class TenantQuota:
    max_qps: Optional[int] = None
    max_concurrent_requests: Optional[int] = None
    cache_memory_mb: Optional[float] = None
    daily_request_limit: Optional[int] = None
    priority: int = 1  # 0 high / 1 normal / 2 low
    monthly_budget: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TenantQuota":
        return cls(
            max_qps=d.get("max_qps"),
            max_concurrent_requests=d.get("max_concurrent_requests"),
            cache_memory_mb=d.get("cache_memory_mb"),
            daily_request_limit=d.get("daily_request_limit"),
            priority=int(d.get("priority", 1)),
            monthly_budget=d.get("monthly_budget"),
        )


@dataclasses.dataclass
class TenantConfig:
    tenant_id: str
    api_key: Optional[str] = None
    quotas: TenantQuota = dataclasses.field(default_factory=TenantQuota)


@dataclasses.dataclass
class TenantUser:
    tenant_id: str
    user_id: str
    role: Role
    api_key: str


class TenantRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, TenantConfig] = {}
        self._by_api_key: dict[str, str] = {}  # api_key -> tenant_id

    def create(
        self, tenant_id: str, api_key: Optional[str] = None,
        quotas: Optional[TenantQuota] = None,
    ) -> TenantConfig:
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant exists: {tenant_id}")
            if api_key is None:
                api_key = secrets.token_urlsafe(24)
            if api_key in self._by_api_key:
                raise ValueError("api key already in use")
            cfg = TenantConfig(tenant_id, api_key, quotas or TenantQuota())
            self._tenants[tenant_id] = cfg
            self._by_api_key[api_key] = tenant_id
            return cfg

    def try_get(self, tenant_id: str) -> Optional[TenantConfig]:
        with self._lock:
            return self._tenants.get(tenant_id)

    def exists(self, tenant_id: str) -> bool:
        with self._lock:
            return tenant_id in self._tenants

    def update_quotas(self, tenant_id: str, quotas: TenantQuota) -> bool:
        with self._lock:
            cfg = self._tenants.get(tenant_id)
            if cfg is None:
                return False
            cfg.quotas = quotas
            return True

    def rotate_api_key(self, tenant_id: str, new_key: Optional[str] = None) -> Optional[str]:
        with self._lock:
            cfg = self._tenants.get(tenant_id)
            if cfg is None:
                return None
            if new_key is None:
                new_key = secrets.token_urlsafe(24)
            if new_key in self._by_api_key and self._by_api_key[new_key] != tenant_id:
                raise ValueError("api key already in use")
            if cfg.api_key:
                self._by_api_key.pop(cfg.api_key, None)
            cfg.api_key = new_key
            self._by_api_key[new_key] = tenant_id
            return new_key

    def tenant_for_api_key(self, api_key: str) -> Optional[str]:
        with self._lock:
            return self._by_api_key.get(api_key)

    def list_tenants(self) -> list[str]:
        with self._lock:
            return sorted(self._tenants)

    def quota_cache_mb(self, tenant_id: str) -> Optional[float]:
        """Adapter handed to MemoryCacheStorage for quota enforcement."""
        with self._lock:
            cfg = self._tenants.get(tenant_id)
            return None if cfg is None else cfg.quotas.cache_memory_mb


class TenantUserRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._users: dict[tuple[str, str], TenantUser] = {}
        self._by_api_key: dict[str, tuple[str, str]] = {}

    def create_user(
        self, tenant_id: str, user_id: str, role: Role,
        api_key: Optional[str] = None,
    ) -> TenantUser:
        with self._lock:
            key = (tenant_id, user_id)
            if key in self._users:
                raise ValueError(f"user exists: {tenant_id}/{user_id}")
            if api_key is None:
                api_key = secrets.token_urlsafe(24)
            if api_key in self._by_api_key:
                raise ValueError("api key already in use")
            u = TenantUser(tenant_id, user_id, role, api_key)
            self._users[key] = u
            self._by_api_key[api_key] = key
            return u

    def try_get(self, tenant_id: str, user_id: str) -> Optional[TenantUser]:
        with self._lock:
            return self._users.get((tenant_id, user_id))

    def user_for_api_key(self, api_key: str) -> Optional[TenantUser]:
        with self._lock:
            key = self._by_api_key.get(api_key)
            return None if key is None else self._users.get(key)

    def update_role(self, tenant_id: str, user_id: str, role: Role) -> bool:
        with self._lock:
            u = self._users.get((tenant_id, user_id))
            if u is None:
                return False
            u.role = role
            return True

    def delete_user(self, tenant_id: str, user_id: str) -> bool:
        with self._lock:
            u = self._users.pop((tenant_id, user_id), None)
            if u is None:
                return False
            self._by_api_key.pop(u.api_key, None)
            return True

    def list_users(self, tenant_id: str) -> list[TenantUser]:
        with self._lock:
            return [u for (t, _), u in self._users.items() if t == tenant_id]
