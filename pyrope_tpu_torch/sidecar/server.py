"""The gRPC PolicyService — the sidecar process (the port's copy of
``pyrope_tpu/sidecar/server.py``).

Rebuild of the reference's sidecar ``server.py``
(ref: src/Pyrope.AISidecar/server.py:46-351). ``ReportSystemMetrics``
orchestrates the full warm path (:116-203):

    canary latency tracking (auto-rollback) → bandit action select →
    policy from LLM engine (non-blocking, heuristic fallback) →
    bandit aggressive override (halve TTL, −0.1 admission) →
    bandit reward update (0.3 − miss_rate) → JSONL decision log

plus ``ReportClusterAccess``/``GetPrefetchRules`` feeding the Markov
prediction engine (:205-220) and the model-management RPCs (:224-253).

gRPC plumbing: the image ships no grpc_tools codegen plugin, so the
service is registered with ``grpc.method_handlers_generic_handler`` over
protoc-generated ``policy_service_pb2`` messages — same wire format a
generated stub would speak. Optional mTLS mirrors the reference
(:268-290) via PEM paths in env vars.
"""

from __future__ import annotations

import os
import threading
from concurrent import futures
from typing import Optional

import grpc

from pyrope_tpu_torch.sidecar import policy_service_pb2 as pb
from pyrope_tpu_torch.sidecar.bandit_engine import ACTION_AGGRESSIVE, ContextualBanditEngine
from pyrope_tpu_torch.sidecar.llm_policy_engine import LLMPolicyEngine
from pyrope_tpu_torch.sidecar.logger import QueryLogger
from pyrope_tpu_torch.sidecar.model_manager import ModelManager
from pyrope_tpu_torch.sidecar.prediction_engine import PredictionEngine
from pyrope_tpu_torch.sidecar.train_model import train as train_model

SERVICE_NAME = "pyrope.sidecar.PolicyService"
DEFAULT_REPORT_INTERVAL_MS = 10_000
REWARD_BASELINE = 0.3


class PolicyService:
    def __init__(self, data_dir: str = "sidecar_data"):
        os.makedirs(data_dir, exist_ok=True)
        self.models = ModelManager(os.path.join(data_dir, "models"))
        self.bandit = ContextualBanditEngine(
            model_path=os.path.join(data_dir, "bandit.pkl")
        )
        self.llm_policy = LLMPolicyEngine()
        self.prediction = PredictionEngine()
        self.logger = QueryLogger(os.path.join(data_dir, "decisions.jsonl"))
        self.decision_log_path = os.path.join(data_dir, "decisions.jsonl")
        # reward is one tick delayed: remember the previous (metrics, action)
        self._pending_reward: dict[str, tuple[dict, int]] = {}
        self._lock = threading.Lock()

    # ---- warm path -------------------------------------------------------

    def report_system_metrics(self, req: pb.SystemMetricsRequest) -> pb.PolicyResponse:
        metrics = {
            "qps": req.qps,
            "cache_miss_rate": req.cache_miss_rate,
            "p99_latency_ms": req.p99_latency_ms,
            "cpu_utilization": req.cpu_utilization,
        }
        tenant = req.tenant_id or "-"
        # canary latency tracking + auto-rollback (ref server.py:128-136)
        self.models.record_latency_p99(tenant, req.p99_latency_ms)
        # delayed bandit reward from the PREVIOUS tick (ref :150-170)
        with self._lock:
            pending = self._pending_reward.pop(tenant, None)
        if pending is not None:
            prev_metrics, prev_action = pending
            reward = REWARD_BASELINE - req.cache_miss_rate
            self.bandit.update(prev_metrics, prev_action, reward)
        action = self.bandit.select_action(metrics)
        policy = self.llm_policy.compute_policy(tenant, metrics)
        source = "llm_or_heuristic"
        if action == ACTION_AGGRESSIVE:
            # bandit override: halve TTL, −0.1 admission (ref :171-180)
            policy = dict(policy)
            policy["ttl_seconds"] = max(1, policy["ttl_seconds"] // 2)
            policy["admission_threshold"] = max(
                0.0, policy["admission_threshold"] - 0.1
            )
            source += "+bandit"
        with self._lock:
            self._pending_reward[tenant] = (metrics, action)
        self.logger.log_decision(tenant, metrics, policy, source, action)
        return pb.PolicyResponse(
            policy=pb.WarmPathPolicy(
                admission_threshold=policy["admission_threshold"],
                ttl_seconds=policy["ttl_seconds"],
                eviction_priority=policy["eviction_priority"],
            ),
            next_report_interval_ms=DEFAULT_REPORT_INTERVAL_MS,
        )

    # ---- prefetch ----------------------------------------------------------

    def report_cluster_access(self, req: pb.ClusterAccessBatch) -> pb.Ack:
        self.prediction.record_batch(
            [
                {
                    "tenant_id": e.tenant_id,
                    "index_name": e.index_name,
                    "cluster_id": e.cluster_id,
                    "timestamp": e.timestamp,
                }
                for e in req.events
            ]
        )
        return pb.Ack(ok=True)

    def get_prefetch_rules(self, req: pb.PrefetchRulesRequest) -> pb.PrefetchRulesResponse:
        return pb.PrefetchRulesResponse(
            rules=[
                pb.PrefetchRule(
                    tenant_id=r["tenant_id"],
                    index_name=r["index_name"],
                    from_cluster=r["from_cluster"],
                    to_cluster=r["to_cluster"],
                    confidence=r["confidence"],
                )
                for r in self.prediction.get_rules()
            ]
        )

    def get_index_policy(self, req: pb.IndexPolicyRequest) -> pb.IndexPolicyResponse:
        # simple static hints (the reference returns config-driven values)
        return pb.IndexPolicyResponse(recommended_nprobe=3, recommended_ef_search=50)

    # ---- model management -------------------------------------------------

    def get_model_status(self, req: pb.Empty) -> pb.ModelStatusResponse:
        st = self.models.get_status()
        return pb.ModelStatusResponse(
            active_version=st["active_version"] or "",
            canary_version=st["canary_version"] or "",
            canary_tenants=st["canary_tenants"],
            staged_versions=st["staged_versions"],
        )

    def trigger_training(self, req: pb.Empty) -> pb.TrainingResponse:
        out = self.models.trigger_training(
            lambda staging: train_model(self.decision_log_path, staging)
        )
        return pb.TrainingResponse(status=out["status"], job_id=out["job_id"])

    def deploy_model(self, req: pb.DeployRequest) -> pb.DeployResponse:
        out = self.models.deploy(req.version, list(req.canary_tenants))
        return pb.DeployResponse(
            status=out["status"],
            active_version=out.get("active_version") or "",
            canary_version=out.get("canary_version") or "",
        )

    def rollback_model(self, req: pb.Empty) -> pb.DeployResponse:
        out = self.models.rollback()
        return pb.DeployResponse(
            status=out["status"],
            active_version=out.get("active_version") or "",
            canary_version="",
        )

    def get_evaluations(self, req: pb.Empty) -> pb.EvaluationsResponse:
        from pyrope_tpu_torch.sidecar.evaluate_model import evaluate, load_samples

        try:
            samples = load_samples(self.decision_log_path)
        except OSError:
            samples = []
        entries = []
        for version in self.models.list_staged():
            path = self.models.staging / f"{version}.joblib"
            try:
                rep = evaluate(path, samples=samples)
            except (OSError, ValueError):
                continue
            entries.append(
                pb.EvaluationEntry(
                    version=version,
                    precision=rep.get("precision", 0.0),
                    recall=rep.get("recall", 0.0),
                    simulated_p99_improvement_ms=rep.get(
                        "simulated_p99_improvement_ms", 0.0
                    ),
                )
            )
        return pb.EvaluationsResponse(evaluations=entries)


# ---------------------------------------------------------------------------
# gRPC registration (hand-rolled generic handler; no grpc_tools in the image)
# ---------------------------------------------------------------------------

_RPCS: "list[tuple[str, str, type, type]]" = [
    ("ReportSystemMetrics", "report_system_metrics", pb.SystemMetricsRequest, pb.PolicyResponse),
    ("ReportClusterAccess", "report_cluster_access", pb.ClusterAccessBatch, pb.Ack),
    ("GetPrefetchRules", "get_prefetch_rules", pb.PrefetchRulesRequest, pb.PrefetchRulesResponse),
    ("GetIndexPolicy", "get_index_policy", pb.IndexPolicyRequest, pb.IndexPolicyResponse),
    ("GetModelStatus", "get_model_status", pb.Empty, pb.ModelStatusResponse),
    ("TriggerTraining", "trigger_training", pb.Empty, pb.TrainingResponse),
    ("DeployModel", "deploy_model", pb.DeployRequest, pb.DeployResponse),
    ("RollbackModel", "rollback_model", pb.Empty, pb.DeployResponse),
    ("GetEvaluations", "get_evaluations", pb.Empty, pb.EvaluationsResponse),
]


def add_policy_service(server: grpc.Server, service: PolicyService) -> None:
    handlers = {}
    for rpc_name, method_name, req_cls, resp_cls in _RPCS:
        method = getattr(service, method_name)

        def make(m):
            return lambda request, context: m(request)

        handlers[rpc_name] = grpc.unary_unary_rpc_method_handler(
            make(method),
            request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE_NAME, handlers),)
    )


def _server_credentials() -> Optional[grpc.ServerCredentials]:
    """Optional mTLS (ref: server.py:268-290): PYROPE_SIDECAR_MTLS_{CERT,KEY,CA}."""
    cert = os.environ.get("PYROPE_SIDECAR_MTLS_CERT")
    key = os.environ.get("PYROPE_SIDECAR_MTLS_KEY")
    ca = os.environ.get("PYROPE_SIDECAR_MTLS_CA")
    if not (cert and key):
        return None
    with open(key, "rb") as f:
        key_pem = f.read()
    with open(cert, "rb") as f:
        cert_pem = f.read()
    root = None
    if ca:
        with open(ca, "rb") as f:
            root = f.read()
    return grpc.ssl_server_credentials(
        [(key_pem, cert_pem)],
        root_certificates=root,
        require_client_auth=root is not None,
    )


def serve(
    port: int = 0,
    data_dir: str = "sidecar_data",
    max_workers: int = 8,
) -> tuple[grpc.Server, int, PolicyService]:
    """Start the sidecar; returns (server, bound_port, service)."""
    service = PolicyService(data_dir)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    add_policy_service(server, service)
    creds = _server_credentials()
    addr = f"127.0.0.1:{port}"
    bound = (
        server.add_secure_port(addr, creds)
        if creds is not None
        else server.add_insecure_port(addr)
    )
    server.start()
    return server, bound, service


def main() -> None:
    # The sidecar runs no device work: nothing it imports loads torch, so
    # it never touches the card the serving process uses.
    port = int(os.environ.get("PYROPE_SIDECAR_PORT", "50051"))
    data_dir = os.environ.get("PYROPE_SIDECAR_DATA", "sidecar_data")
    server, bound, _ = serve(port=port, data_dir=data_dir)
    print(f"pyrope sidecar listening on :{bound}", flush=True)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:  # SIGINT: stop serving and exit 0
        server.stop(grace=1.0).wait()


if __name__ == "__main__":
    main()
