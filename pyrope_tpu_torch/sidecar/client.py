"""gRPC client for the PolicyService — the engine side of the warm path.

Rebuild of the reference's DI-registered ``PolicyServiceClient``
(ref: Extensions/SidecarExtensions.cs:16-111, with optional mTLS custom
trust chain) exposing the calls the serving engine needs:
``report_system_metrics`` (with per-tenant metadata + warm-path deadline,
ref: SidecarMetricsReporter.cs:162-166 uses a 50 ms deadline),
``report_cluster_access`` / ``get_prefetch_rules`` (PredictivePrefetcher's
``PolicyClient`` protocol), and the model-management proxies used by the
AI controller.
"""

from __future__ import annotations

import os
from typing import Optional

import grpc

from pyrope_tpu_torch.sidecar import policy_service_pb2 as pb
from pyrope_tpu_torch.sidecar.server import SERVICE_NAME

WARM_PATH_DEADLINE_S = 0.050  # ref: 50 ms warm-path deadline


class SidecarUnavailable(Exception):
    pass


def _channel_credentials() -> Optional[grpc.ChannelCredentials]:
    """Optional mTLS (ref: SidecarExtensions.cs:42-108):
    PYROPE_SIDECAR_CLIENT_{CERT,KEY,CA}."""
    ca = os.environ.get("PYROPE_SIDECAR_CLIENT_CA")
    cert = os.environ.get("PYROPE_SIDECAR_CLIENT_CERT")
    key = os.environ.get("PYROPE_SIDECAR_CLIENT_KEY")
    if not ca:
        return None
    with open(ca, "rb") as f:
        root = f.read()
    cert_pem = key_pem = None
    if cert and key:
        with open(cert, "rb") as f:
            cert_pem = f.read()
        with open(key, "rb") as f:
            key_pem = f.read()
    return grpc.ssl_channel_credentials(
        root_certificates=root, private_key=key_pem, certificate_chain=cert_pem
    )


class PolicyServiceClient:
    def __init__(self, endpoint: str, warm_path_deadline_s: float = WARM_PATH_DEADLINE_S):
        creds = _channel_credentials()
        self._channel = (
            grpc.secure_channel(endpoint, creds)
            if creds is not None
            else grpc.insecure_channel(endpoint)
        )
        self.warm_path_deadline_s = warm_path_deadline_s
        self._stubs = {}

    def _stub(self, rpc: str, req_cls, resp_cls):
        key = rpc
        if key not in self._stubs:
            self._stubs[key] = self._channel.unary_unary(
                f"/{SERVICE_NAME}/{rpc}",
                request_serializer=req_cls.SerializeToString,
                response_deserializer=resp_cls.FromString,
            )
        return self._stubs[key]

    def close(self) -> None:
        self._channel.close()

    # ---- warm path (deadline-bounded) --------------------------------------

    def report_system_metrics(
        self, tenant: str, qps: float, miss_rate: float, p99_ms: float, cpu: float,
        timeout: Optional[float] = None,
    ) -> dict:
        """Returns {"policy": {...}, "next_report_interval_ms": N}.
        Raises SidecarUnavailable on deadline/connection errors — the caller
        records an AI-fallback and keeps its cached policy
        (ref: SidecarMetricsReporter.cs:177-186)."""
        stub = self._stub("ReportSystemMetrics", pb.SystemMetricsRequest, pb.PolicyResponse)
        req = pb.SystemMetricsRequest(
            tenant_id=tenant, qps=qps, cache_miss_rate=miss_rate,
            p99_latency_ms=p99_ms, cpu_utilization=cpu,
        )
        try:
            resp = stub(
                req,
                timeout=timeout if timeout is not None else self.warm_path_deadline_s,
                metadata=(("tenant-id", tenant),),
            )
        except grpc.RpcError as e:
            raise SidecarUnavailable(str(e.code())) from e
        return {
            "policy": {
                "admission_threshold": resp.policy.admission_threshold,
                "ttl_seconds": resp.policy.ttl_seconds,
                "eviction_priority": resp.policy.eviction_priority,
            },
            "next_report_interval_ms": resp.next_report_interval_ms,
        }

    # ---- PredictivePrefetcher's PolicyClient protocol ------------------------

    def report_cluster_access(self, events: list[dict]) -> None:
        stub = self._stub("ReportClusterAccess", pb.ClusterAccessBatch, pb.Ack)
        batch = pb.ClusterAccessBatch(
            events=[
                pb.ClusterAccessEvent(
                    tenant_id=e["tenant_id"], index_name=e["index_name"],
                    cluster_id=int(e["cluster_id"]), timestamp=float(e["timestamp"]),
                )
                for e in events
            ]
        )
        try:
            stub(batch, timeout=2.0)
        except grpc.RpcError as e:
            raise SidecarUnavailable(str(e.code())) from e

    def get_prefetch_rules(self) -> list[dict]:
        stub = self._stub("GetPrefetchRules", pb.PrefetchRulesRequest, pb.PrefetchRulesResponse)
        try:
            resp = stub(pb.PrefetchRulesRequest(), timeout=2.0)
        except grpc.RpcError as e:
            raise SidecarUnavailable(str(e.code())) from e
        return [
            {
                "tenant_id": r.tenant_id,
                "index_name": r.index_name,
                "from_cluster": r.from_cluster,
                "to_cluster": r.to_cluster,
                "confidence": r.confidence,
            }
            for r in resp.rules
        ]

    # ---- AI controller proxies (ref: Controllers/AiController.cs) ------------

    def get_model_status(self) -> dict:
        stub = self._stub("GetModelStatus", pb.Empty, pb.ModelStatusResponse)
        resp = stub(pb.Empty(), timeout=5.0)
        return {
            "active": resp.active_version or None,
            "canary": resp.canary_version or None,
            "canary_tenants": list(resp.canary_tenants),
            "staged": list(resp.staged_versions),
        }

    def trigger_training(self) -> dict:
        stub = self._stub("TriggerTraining", pb.Empty, pb.TrainingResponse)
        resp = stub(pb.Empty(), timeout=5.0)
        return {"status": resp.status, "job": resp.job_id}

    def deploy_model(self, version: str, canary_tenants: list[str]) -> dict:
        stub = self._stub("DeployModel", pb.DeployRequest, pb.DeployResponse)
        resp = stub(
            pb.DeployRequest(version=version, canary_tenants=canary_tenants), timeout=5.0
        )
        return {
            "status": resp.status,
            "version": resp.active_version or resp.canary_version,
            "canary": list(canary_tenants),
        }

    def rollback_model(self) -> dict:
        stub = self._stub("RollbackModel", pb.Empty, pb.DeployResponse)
        resp = stub(pb.Empty(), timeout=5.0)
        return {"status": resp.status, "active": resp.active_version or None}

    def get_evaluations(self) -> list[dict]:
        stub = self._stub("GetEvaluations", pb.Empty, pb.EvaluationsResponse)
        resp = stub(pb.Empty(), timeout=10.0)
        return [
            {
                "version": e.version,
                "precision": e.precision,
                "recall": e.recall,
                "simulated_p99_improvement_ms": e.simulated_p99_improvement_ms,
            }
            for e in resp.evaluations
        ]
