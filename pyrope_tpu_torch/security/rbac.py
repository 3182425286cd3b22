"""Role-based access control.

Rebuild of the reference's RBAC model (ref: Security/Role.cs:7-18,
Security/Permission.cs:9-101, Security/RbacAuthorizationService.cs:11-58):
hierarchical roles Reader(0) ⊂ Operator(1) ⊂ TenantAdmin(2) over 17
permissions; API key resolves to a per-user role first, with a legacy
tenant-level key mapping to TenantAdmin.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from pyrope_tpu_torch.service.tenants import TenantRegistry, TenantUserRegistry


class Role(enum.IntEnum):
    READER = 0
    OPERATOR = 1
    TENANT_ADMIN = 2

    @classmethod
    def parse(cls, s: "str | int | Role") -> "Role":
        if isinstance(s, Role):
            return s
        if isinstance(s, int):
            return cls(s)
        t = s.strip().upper().replace("-", "_")
        aliases = {
            "READER": cls.READER,
            "OPERATOR": cls.OPERATOR,
            "TENANT_ADMIN": cls.TENANT_ADMIN,
            "TENANTADMIN": cls.TENANT_ADMIN,
            "ADMIN": cls.TENANT_ADMIN,
        }
        if t not in aliases:
            raise ValueError(f"unknown role: {s!r}")
        return aliases[t]


class Permission(str, enum.Enum):
    # Index operations
    INDEX_CREATE = "index.create"
    INDEX_DELETE = "index.delete"
    INDEX_BUILD = "index.build"
    INDEX_SNAPSHOT = "index.snapshot"
    INDEX_LOAD = "index.load"
    INDEX_READ = "index.read"
    # Tenant operations
    TENANT_CREATE = "tenant.create"
    TENANT_UPDATE = "tenant.update"
    TENANT_READ = "tenant.read"
    USER_MANAGE = "user.manage"
    # Cache operations
    CACHE_FLUSH = "cache.flush"
    CACHE_INVALIDATE = "cache.invalidate"
    POLICY_UPDATE = "policy.update"
    POLICY_READ = "policy.read"
    # Audit / billing
    AUDIT_READ = "audit.read"
    BILLING_READ = "billing.read"
    # System (global admin only)
    SYSTEM_MANAGE = "system.manage"


_READER = frozenset(
    {
        Permission.INDEX_READ,
        Permission.TENANT_READ,
        Permission.POLICY_READ,
        Permission.BILLING_READ,
    }
)
_OPERATOR = _READER | {
    Permission.INDEX_BUILD,
    Permission.INDEX_SNAPSHOT,
    Permission.INDEX_LOAD,
    Permission.CACHE_FLUSH,
    Permission.CACHE_INVALIDATE,
    Permission.POLICY_UPDATE,
    Permission.AUDIT_READ,
}
_TENANT_ADMIN = _OPERATOR | {
    Permission.INDEX_CREATE,
    Permission.INDEX_DELETE,
    Permission.TENANT_CREATE,
    Permission.TENANT_UPDATE,
    Permission.USER_MANAGE,
}

_ROLE_PERMISSIONS: dict[Role, frozenset[Permission]] = {
    Role.READER: frozenset(_READER),
    Role.OPERATOR: frozenset(_OPERATOR),
    Role.TENANT_ADMIN: frozenset(_TENANT_ADMIN),
}


def role_permissions(role: Role) -> frozenset[Permission]:
    return _ROLE_PERMISSIONS.get(role, frozenset())


def has_permission(role: Role, permission: Permission) -> bool:
    return permission in role_permissions(role)


class RbacAuthorizationService:
    """API key → role → permission check (ref: RbacAuthorizationService.cs).

    Resolution order: per-user key first; a legacy tenant-level key grants
    TenantAdmin on that tenant. SYSTEM_MANAGE is never grantable via tenant
    keys — only the admin key (checked by the HTTP layer) has it.
    """

    def __init__(self, tenants: "TenantRegistry", users: "TenantUserRegistry"):
        self._tenants = tenants
        self._users = users

    def resolve_role(self, api_key: str, tenant_id: str) -> Optional[Role]:
        if not api_key:
            return None
        user = self._users.user_for_api_key(api_key)
        if user is not None:
            return user.role if user.tenant_id == tenant_id else None
        owner = self._tenants.tenant_for_api_key(api_key)
        if owner is not None and owner == tenant_id:
            return Role.TENANT_ADMIN
        return None

    def authorize(self, api_key: str, tenant_id: str, permission: Permission) -> bool:
        role = self.resolve_role(api_key, tenant_id)
        return role is not None and has_permission(role, permission)
