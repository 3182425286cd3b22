"""Tenant/index name validation + key scheme helpers.

Rebuilds of ``TenantNamespace`` (ref: Utils/TenantNamespace.cs:6-54 —
``[A-Za-z0-9_-]+``) and ``KeyUtils`` (ref: Utils/KeyUtils.cs:3-32 — the
``cache:{t}:{i}:`` / ``idx:{t}:{i}`` / ``_meta:`` key scheme).
"""

from __future__ import annotations

import re

_NAME_RE = re.compile(r"^[A-Za-z0-9_-]+$")
MAX_NAME_LEN = 128


def is_valid_name(name: str) -> bool:
    return bool(name) and len(name) <= MAX_NAME_LEN and _NAME_RE.match(name) is not None


def validate_name(name: str, what: str = "name") -> str:
    if not is_valid_name(name):
        raise ValueError(f"invalid {what}: {name!r} (must match [A-Za-z0-9_-]+)")
    return name


def cache_prefix(tenant: str, index: str) -> str:
    return f"cache:{tenant}:{index}:"


def index_key(tenant: str, index: str) -> str:
    return f"idx:{tenant}:{index}"


def meta_key(tenant: str, index: str) -> str:
    return f"_meta:index:{tenant}:{index}"
