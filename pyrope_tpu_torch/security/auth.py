"""Authentication plumbing.

Rebuilds of:
- ``TenantApiKeyAuthenticator`` (ref: Security/TenantApiKeyAuthenticator.cs:
  7-53): constant-time compare of a supplied key vs the tenant's key; no-op
  when auth is disabled.
- ``SessionAuthContext`` (ref: Security/SessionAuthContext.cs:13-28):
  AsyncLocal authenticated-tenant flag — here a ``contextvars.ContextVar``
  so each asyncio RESP connection carries its own authenticated tenant
  (set by ``AUTH tenant:key``), letting VEC.* skip per-command API_KEY.
- ``AuthSettings``: server auth config (admin key, enable flag), the analog
  of the reference's Auth options binding (ref: Program.cs:28-45).
"""

from __future__ import annotations

import contextvars
import dataclasses
import hmac
import os
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from pyrope_tpu_torch.service.tenants import TenantRegistry, TenantUserRegistry


@dataclasses.dataclass
class AuthSettings:
    enabled: bool = True
    admin_api_key: Optional[str] = None

    @classmethod
    def from_env(cls) -> "AuthSettings":
        key = os.environ.get("PYROPE_ADMIN_API_KEY")
        enabled = os.environ.get("PYROPE_AUTH_ENABLED", "1") not in ("0", "false")
        return cls(enabled=enabled, admin_api_key=key)


@dataclasses.dataclass(frozen=True)
class AuthContext:
    """Resolved identity for one request."""

    tenant_id: Optional[str] = None
    user_id: Optional[str] = None
    is_admin: bool = False


_session_tenant: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pyrope_session_tenant", default=None
)


class SessionAuthContext:
    """Per-connection authenticated tenant (RESP ``AUTH tenant:key``)."""

    @staticmethod
    def set_tenant(tenant_id: Optional[str]) -> None:
        _session_tenant.set(tenant_id)

    @staticmethod
    def get_tenant() -> Optional[str]:
        return _session_tenant.get()

    @staticmethod
    def clear() -> None:
        _session_tenant.set(None)


class TenantApiKeyAuthenticator:
    def __init__(
        self,
        tenants: "TenantRegistry",
        users: "Optional[TenantUserRegistry]" = None,
        settings: Optional[AuthSettings] = None,
    ):
        self._tenants = tenants
        self._users = users
        self._settings = settings or AuthSettings()

    @property
    def enabled(self) -> bool:
        return self._settings.enabled

    def authenticate(self, tenant_id: str, api_key: Optional[str]) -> bool:
        """True iff the key is valid for the tenant (tenant key or any of the
        tenant's user keys). Always True when auth is disabled."""
        if not self._settings.enabled:
            return True
        if not api_key:
            return False
        if self._settings.admin_api_key and hmac.compare_digest(
            api_key, self._settings.admin_api_key
        ):
            return True
        cfg = self._tenants.try_get(tenant_id)
        if cfg is not None and cfg.api_key and hmac.compare_digest(api_key, cfg.api_key):
            return True
        if self._users is not None:
            user = self._users.user_for_api_key(api_key)
            if user is not None and user.tenant_id == tenant_id:
                return True
        return False

    def is_admin_key(self, api_key: Optional[str]) -> bool:
        return bool(
            api_key
            and self._settings.admin_api_key
            and hmac.compare_digest(api_key, self._settings.admin_api_key)
        )
