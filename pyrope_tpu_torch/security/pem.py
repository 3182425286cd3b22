"""PEM certificate loading for TLS/mTLS endpoints.

Rebuild of the reference's ``PemCertificateLoader``
(ref: Security/PemCertificateLoader.cs:7-26): loads PEM cert/key pairs and
an optional custom CA into SSL contexts. Used by the RESP and HTTP servers
(``PYROPE_TLS_CERT/KEY/CA`` env vars in the JAX package's app.py) and complementing the gRPC
channel/server credentials in the sidecar (which use grpc's own PEM
loading, ref: Extensions/SidecarExtensions.cs:42-108).
"""

from __future__ import annotations

import os
import ssl
from typing import Optional


def load_server_context(
    cert_path: str,
    key_path: str,
    ca_path: Optional[str] = None,
    require_client_cert: bool = False,
) -> ssl.SSLContext:
    """Server-side context; with ``ca_path`` + ``require_client_cert`` this
    is mTLS with a custom trust chain."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    if ca_path:
        ctx.load_verify_locations(ca_path)
        if require_client_cert:
            ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def load_client_context(
    ca_path: Optional[str] = None,
    cert_path: Optional[str] = None,
    key_path: Optional[str] = None,
) -> ssl.SSLContext:
    """Client-side context trusting a custom CA, optionally presenting a
    client cert (mTLS)."""
    ctx = ssl.create_default_context()
    if ca_path:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(ca_path)
        ctx.check_hostname = False  # dev certs carry IP SANs only
    if cert_path and key_path:
        ctx.load_cert_chain(cert_path, key_path)
    return ctx


def server_context_from_env(prefix: str = "PYROPE_TLS") -> Optional[ssl.SSLContext]:
    """Build the server context from ``{prefix}_{CERT,KEY,CA}`` env vars;
    None when TLS is not configured."""
    cert = os.environ.get(f"{prefix}_CERT")
    key = os.environ.get(f"{prefix}_KEY")
    if not (cert and key):
        return None
    return load_server_context(
        cert, key,
        ca_path=os.environ.get(f"{prefix}_CA"),
        require_client_cert=bool(os.environ.get(f"{prefix}_REQUIRE_CLIENT")),
    )
