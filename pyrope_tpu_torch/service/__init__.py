"""Tenancy, quotas, SLO guardrails, metrics, billing, audit — the ops layer.

Rebuild of the reference's `Services/` (SURVEY §2.4): multi-tenant QoS
(QPS/concurrency/budget quotas, noisy-neighbor priorities), SLO-driven
graceful degradation, Prometheus metrics, tamper-evident billing, audit
trail, and the record-of-truth vector store.
"""

from pyrope_tpu_torch.service.vector_store import VectorRecord, VectorStore
from pyrope_tpu_torch.service.tenants import (
    TenantConfig,
    TenantQuota,
    TenantRegistry,
    TenantUser,
    TenantUserRegistry,
)
from pyrope_tpu_torch.service.quota import TenantQuotaEnforcer, TenantRequestLease
from pyrope_tpu_torch.service.slo import SloGuardrails, SloGuardrailsOptions, SloMonitor
from pyrope_tpu_torch.service.metrics import MetricsCollector
from pyrope_tpu_torch.service.billing import BillingLogStore, BillingMeter
from pyrope_tpu_torch.service.audit import AuditEvent, AuditLogger
from pyrope_tpu_torch.service.cost import estimate_search_cost

__all__ = [
    "VectorRecord",
    "VectorStore",
    "TenantConfig",
    "TenantQuota",
    "TenantRegistry",
    "TenantUser",
    "TenantUserRegistry",
    "TenantQuotaEnforcer",
    "TenantRequestLease",
    "SloGuardrails",
    "SloGuardrailsOptions",
    "SloMonitor",
    "MetricsCollector",
    "BillingLogStore",
    "BillingMeter",
    "AuditEvent",
    "AuditLogger",
    "estimate_search_cost",
]
