"""RBAC + authentication (SURVEY §2.4 security rows).

Rebuild of the reference's ``Security/``: hierarchical Reader ⊂ Operator ⊂
TenantAdmin roles over 17 permissions, API-key → role resolution, and the
session auth context that lets RESP ``AUTH`` skip per-command API keys.
"""

from pyrope_tpu_torch.security.rbac import (
    Permission,
    RbacAuthorizationService,
    Role,
    role_permissions,
)
from pyrope_tpu_torch.security.auth import (
    AuthContext,
    AuthSettings,
    SessionAuthContext,
    TenantApiKeyAuthenticator,
)
from pyrope_tpu_torch.security.pem import (
    load_client_context,
    load_server_context,
    server_context_from_env,
)

__all__ = [
    "Permission",
    "RbacAuthorizationService",
    "Role",
    "role_permissions",
    "AuthContext",
    "AuthSettings",
    "SessionAuthContext",
    "TenantApiKeyAuthenticator",
    "load_client_context",
    "load_server_context",
    "server_context_from_env",
]
