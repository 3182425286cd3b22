"""The port's twin of ``tests/test_service.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Tenancy / QoS / billing / audit / SLO tests — deterministic via
ManualClock, mirroring the reference's service test suite
(ref: tests/.../Services/TenantQuotaEnforcerTests, SloGuardrailsTests,
BillingMeterTests, AuditLoggerTests; SURVEY §4 pattern 1)."""

from pathlib import Path

import numpy as np
import pytest

from pyrope_tpu_torch.security import (
    AuthSettings,
    Permission,
    RbacAuthorizationService,
    Role,
    TenantApiKeyAuthenticator,
    role_permissions,
)
from pyrope_tpu_torch.service import (
    AuditLogger,
    BillingLogStore,
    BillingMeter,
    MetricsCollector,
    SloGuardrails,
    SloGuardrailsOptions,
    SloMonitor,
    TenantQuota,
    TenantQuotaEnforcer,
    TenantRegistry,
    TenantUserRegistry,
    VectorRecord,
    VectorStore,
    estimate_search_cost,
)
from pyrope_tpu_torch.service.prefetch import PredictivePrefetcher, PrefetchBackgroundQueue
from pyrope_tpu_torch.service.sidecar_metrics import (
    SidecarMetricsCalculator,
    UsageSnapshot,
)
from pyrope_tpu_torch.types import IndexStats, Metric, SearchOptions
from pyrope_tpu_torch.utils.clock import ManualClock
from pyrope_tpu_torch.utils.naming import is_valid_name
from pyrope_tpu_torch.utils.parsing import encode_vector, parse_vector


class TestVectorStore:
    def test_add_get_delete(self):
        vs = VectorStore()
        r = VectorRecord("a", np.zeros(4, np.float32), meta={"k": "v"}, tags=("x",))
        assert vs.try_add("t", "i", r)
        assert not vs.try_add("t", "i", r)  # duplicate
        assert vs.try_get("t", "i", "a").meta == {"k": "v"}
        assert vs.try_mark_deleted("t", "i", "a")
        assert vs.try_get("t", "i", "a") is None
        assert not vs.try_mark_deleted("t", "i", "a")
        # re-add over tombstone allowed
        assert vs.try_add("t", "i", VectorRecord("a", np.ones(4, np.float32)))

    def test_upsert_byte_delta(self):
        vs = VectorStore()
        d1 = vs.upsert("t", "i", VectorRecord("a", np.zeros(4, np.float32)))
        assert d1 > 0
        d2 = vs.upsert("t", "i", VectorRecord("a", np.zeros(8, np.float32)))
        assert d2 == 16  # 4 extra float32


class TestQuotaEnforcer:
    def _mk(self, **quota):
        clk = ManualClock()
        reg = TenantRegistry()
        reg.create("t1", api_key="k1", quotas=TenantQuota(**quota))
        return TenantQuotaEnforcer(reg, clock=clk), clk

    def test_qps_window(self):
        enf, clk = self._mk(max_qps=2)
        assert enf.try_begin_request("t1")[0]
        assert enf.try_begin_request("t1")[0]
        ok, _, code, _ = enf.try_begin_request("t1")
        assert not ok and code == "VEC_ERR_QUOTA"
        clk.advance(1.0)  # next 1-second window
        assert enf.try_begin_request("t1")[0]

    def test_concurrency_lease(self):
        enf, _ = self._mk(max_concurrent_requests=1)
        ok, lease, _, _ = enf.try_begin_request("t1")
        assert ok and lease is not None
        ok2, _, code, _ = enf.try_begin_request("t1")
        assert not ok2 and code == "VEC_ERR_BUSY"
        lease.release()
        assert enf.try_begin_request("t1")[0]

    def test_daily_limit(self):
        enf, clk = self._mk(daily_request_limit=1)
        assert enf.try_begin_request("t1")[0]
        assert not enf.try_begin_request("t1")[0]
        clk.advance(86401)
        assert enf.try_begin_request("t1")[0]

    def test_unknown_tenant_unlimited(self):
        enf, _ = self._mk(max_qps=1)
        for _ in range(10):
            assert enf.try_begin_request("nobody")[0]

    def test_monthly_budget(self):
        enf, clk = self._mk(monthly_budget=10.0)
        assert not enf.is_over_budget("t1")
        enf.record_cost("t1", 11.0)
        assert enf.is_over_budget("t1")
        clk.advance(31 * 86400)  # next month window
        assert not enf.is_over_budget("t1")


class TestSlo:
    def test_hysteresis(self):
        g = SloGuardrails(SloGuardrailsOptions(target_p99_ms=50))
        assert not g.observe_p99(40)
        assert g.observe_p99(60)       # enter degraded
        assert g.observe_p99(45)       # 45 > 0.8*50 — still degraded
        assert not g.observe_p99(39)   # <= 40 — recover

    def test_degraded_search_options_by_priority(self):
        g = SloGuardrails(SloGuardrailsOptions(target_p99_ms=50, degraded_max_scans=5000))
        g.observe_p99(100)
        base = SearchOptions()
        assert g.get_search_options(base, tenant_priority=0).max_scans is None
        assert g.get_search_options(base, tenant_priority=1).max_scans == 5000
        assert g.should_force_cache_only(2)
        assert not g.should_force_cache_only(1)

    def test_monitor_p99_from_histogram_deltas(self):
        m = MetricsCollector()
        g = SloGuardrails(SloGuardrailsOptions(target_p99_ms=50, min_samples=10))
        mon = SloMonitor(m, g)
        assert mon.tick() is None  # below sample gate
        for _ in range(100):
            m.record_search_latency(120.0)
        p99 = mon.tick()
        assert p99 == 200.0 and g.is_degraded
        for _ in range(100):
            m.record_search_latency(2.0)
        p99 = mon.tick()
        assert p99 == 5.0 and not g.is_degraded


class TestMetrics:
    def test_prometheus_text(self):
        m = MetricsCollector()
        m.record_hit()
        m.record_miss()
        m.record_eviction("quota")
        m.record_search_latency(3.0)
        text = m.to_prometheus()
        assert "pyrope_cache_hits_total 1" in text
        assert 'le="5"' in text
        assert 'reason="quota"' in text
        assert text.endswith("\n")


class TestBilling:
    def test_usage_accumulation(self):
        meter = BillingMeter(clock=ManualClock())
        meter.record_request("t1", cache_hit=True)
        meter.record_request("t1", cache_hit=False)
        meter.record_compute("t1", 2.5)
        meter.record_vector_bytes("t1", 100)
        meter.record_vector_bytes("t1", -30)
        u = meter.get_usage("t1")
        assert u.requests_total == 2
        assert u.requests_cache_hit == 1
        assert u.compute_cost_units == 2.5
        assert u.vector_bytes == 70

    def test_hash_chain_integrity(self):
        clk = ManualClock()
        store = BillingLogStore(clock=clk)
        store.append("t1", {"a": 1})
        clk.advance(1)
        e2 = store.append("t1", {"a": 2})
        assert store.verify_chain()
        assert e2.prev_hash == store.entries()[0].hash
        e2.payload["a"] = 999  # tamper
        assert not store.verify_chain()

    def test_interval_gated_logging(self):
        clk = ManualClock()
        store = BillingLogStore(clock=clk)
        meter = BillingMeter(log_store=store, log_interval_s=60, clock=clk)
        meter.record_request("t1", True)
        meter.record_request("t1", True)  # within interval — no second entry
        assert len(store.entries()) == 1
        clk.advance(61)
        meter.record_request("t1", True)
        assert len(store.entries()) == 2


class TestAudit:
    def test_log_and_query(self):
        clk = ManualClock()
        log = AuditLogger(clock=clk)
        log.log("t1", "admin", "index.create", "t1/idx")
        clk.advance(10)
        log.log("t2", "u1", "index.build", "t2/idx")
        assert len(log.query(tenant_id="t1")) == 1
        assert len(log.query(action="index.build")) == 1
        assert len(log.query(since=clk.now() - 5)) == 1
        assert log.stats()["total"] == 2

    def test_ring_cap(self):
        log = AuditLogger(max_entries=5, clock=ManualClock())
        for i in range(10):
            log.log("t", "a", "x", str(i))
        assert log.stats()["total"] == 5


class TestRbac:
    def test_role_hierarchy(self):
        assert Permission.INDEX_READ in role_permissions(Role.READER)
        assert Permission.INDEX_BUILD not in role_permissions(Role.READER)
        assert Permission.INDEX_BUILD in role_permissions(Role.OPERATOR)
        assert Permission.INDEX_CREATE not in role_permissions(Role.OPERATOR)
        assert Permission.INDEX_CREATE in role_permissions(Role.TENANT_ADMIN)
        assert Permission.SYSTEM_MANAGE not in role_permissions(Role.TENANT_ADMIN)
        assert role_permissions(Role.READER) < role_permissions(Role.OPERATOR)
        assert role_permissions(Role.OPERATOR) < role_permissions(Role.TENANT_ADMIN)

    def test_api_key_resolution(self):
        tenants, users = TenantRegistry(), TenantUserRegistry()
        tenants.create("t1", api_key="tenant-key")
        users.create_user("t1", "alice", Role.READER, api_key="alice-key")
        rbac = RbacAuthorizationService(tenants, users)
        # per-user key wins, scoped to its tenant
        assert rbac.resolve_role("alice-key", "t1") == Role.READER
        assert rbac.resolve_role("alice-key", "t2") is None
        # legacy tenant key = TenantAdmin
        assert rbac.resolve_role("tenant-key", "t1") == Role.TENANT_ADMIN
        assert rbac.authorize("alice-key", "t1", Permission.INDEX_READ)
        assert not rbac.authorize("alice-key", "t1", Permission.INDEX_BUILD)
        assert rbac.authorize("tenant-key", "t1", Permission.INDEX_CREATE)

    def test_authenticator(self):
        tenants, users = TenantRegistry(), TenantUserRegistry()
        tenants.create("t1", api_key="tk")
        users.create_user("t1", "u", Role.OPERATOR, api_key="uk")
        auth = TenantApiKeyAuthenticator(
            tenants, users, AuthSettings(enabled=True, admin_api_key="admin")
        )
        assert auth.authenticate("t1", "tk")
        assert auth.authenticate("t1", "uk")
        assert auth.authenticate("t1", "admin") and auth.is_admin_key("admin")
        assert not auth.authenticate("t1", "wrong")
        assert not auth.authenticate("t2", "tk")
        off = TenantApiKeyAuthenticator(tenants, settings=AuthSettings(enabled=False))
        assert off.authenticate("t1", None)


class TestPrefetch:
    class FakeClient:
        def __init__(self):
            self.reported = []
            self.rules = [
                {"tenant_id": "t1", "index_name": "i", "from_cluster": 1, "to_cluster": 2}
            ]

        def report_cluster_access(self, events):
            self.reported.extend(events)

        def get_prefetch_rules(self):
            return self.rules

    def test_flush_and_rules(self):
        clk = ManualClock()
        client = self.FakeClient()
        pf = PredictivePrefetcher(client, clock=clk)
        pf.record_interaction("t1", "i", 1)
        pf.record_interaction("t1", "i", 2)
        clk.advance(100)  # past rules-refresh gate
        assert pf.tick() == 2
        assert len(client.reported) == 2
        assert pf.get_prediction("t1", "i", 1) == 2
        assert pf.get_prediction("t1", "i", 9) is None

    def test_background_queue_drop_on_full(self):
        q = PrefetchBackgroundQueue(capacity=2)
        ran = []
        assert q.try_enqueue(lambda: ran.append(1))
        assert q.try_enqueue(lambda: ran.append(2))
        assert not q.try_enqueue(lambda: ran.append(3))
        assert q.dropped == 1
        assert q.run_pending() == 2
        assert ran == [1, 2]


class TestSidecarMetricsCalculator:
    def test_deltas(self):
        from pyrope_tpu_torch.service.metrics import MetricsCollector

        m = MetricsCollector()
        calc = SidecarMetricsCalculator()
        assert calc.calculate(m.get_snapshot(), UsageSnapshot(0.0, 0.0)) is None
        m.record_miss()
        m.record_hit()
        m.record_hit()
        m.record_hit()
        for _ in range(20):
            m.record_search_latency(8.0)
        out = calc.calculate(m.get_snapshot(), UsageSnapshot(10.0, 5.0))
        assert out.qps == pytest.approx(2.0)
        assert out.cache_miss_rate == pytest.approx(0.25)
        assert out.p99_latency_ms == 10.0
        assert out.cpu_utilization == pytest.approx(0.5)


class TestCostAndUtils:
    def test_cost_formula(self):
        assert estimate_search_cost(IndexStats(10_000, 128, Metric.L2)) == 1.0
        assert estimate_search_cost(IndexStats(20_000, 256, Metric.L2)) == 4.0

    def test_name_validation(self):
        assert is_valid_name("tenant-1_A")
        assert not is_valid_name("bad name")
        assert not is_valid_name("")
        assert not is_valid_name("a/b")

    def test_vector_parsing_json_csv_binary(self):
        v = np.array([1.5, -2.0, 3.25], np.float32)
        assert np.allclose(parse_vector(b"[1.5, -2.0, 3.25]"), v)
        assert np.allclose(parse_vector(b"1.5,-2.0,3.25"), v)
        assert np.allclose(parse_vector(encode_vector(v), expected_dim=3), v)
        with pytest.raises(ValueError):
            parse_vector(b"{json object}")


class TestIndexMetadataManager:
    def test_roundtrip_and_persistence(self, tmp_path):
        from pyrope_tpu_torch.service.index_metadata import IndexMetadataManager
        from pyrope_tpu_torch.types import IndexConfig, IndexParams

        p = tmp_path / "meta.json"
        mm = IndexMetadataManager(p)
        cfg = IndexConfig(dim=64, algorithm="HNSW", params=IndexParams(m=8))
        mm.save("t1", "idx", cfg)
        got = mm.load("t1", "idx")
        assert got.dim == 64 and got.algorithm == "HNSW" and got.params.m == 8
        # survives restart
        mm2 = IndexMetadataManager(p)
        assert mm2.load("t1", "idx").dim == 64
        assert mm2.list_all()[0][:2] == ("t1", "idx")
        assert mm2.delete("t1", "idx")
        assert mm2.load("t1", "idx") is None


class TestPemLoader:
    def test_server_and_client_contexts(self, tmp_path):
        import ssl
        import subprocess

        from pyrope_tpu_torch.security import load_client_context, load_server_context
        from pyrope_tpu_torch.security.pem import server_context_from_env

        script = str(Path(__file__).resolve().parents[1] / "scripts" / "generate_mtls_certs.sh")
        subprocess.run([script, str(tmp_path)], check=True, capture_output=True)
        srv = load_server_context(
            str(tmp_path / "server.crt"), str(tmp_path / "server.key"),
            ca_path=str(tmp_path / "ca.crt"), require_client_cert=True,
        )
        assert srv.verify_mode == ssl.CERT_REQUIRED
        cli = load_client_context(
            ca_path=str(tmp_path / "ca.crt"),
            cert_path=str(tmp_path / "client.crt"),
            key_path=str(tmp_path / "client.key"),
        )
        assert isinstance(cli, ssl.SSLContext)

    def test_env_loader_absent(self, monkeypatch):
        from pyrope_tpu_torch.security.pem import server_context_from_env

        monkeypatch.delenv("PYROPE_TLS_CERT", raising=False)
        assert server_context_from_env() is None


class TestQuotaOrderingFix:
    def test_concurrency_rejection_does_not_burn_daily_quota(self):
        clk = ManualClock()
        reg = TenantRegistry()
        reg.create("t1", api_key="k",
                   quotas=TenantQuota(max_concurrent_requests=1, daily_request_limit=3))
        enf = TenantQuotaEnforcer(reg, clock=clk)
        ok, lease, _, _ = enf.try_begin_request("t1")
        assert ok
        # retries rejected on concurrency must not consume the daily limit
        for _ in range(10):
            ok2, _, code, _ = enf.try_begin_request("t1")
            assert not ok2 and code == "VEC_ERR_BUSY"
        lease.release()
        assert enf.try_begin_request("t1")[0]  # only 2nd daily slot used

    def test_quotas_none_is_unlimited_budget(self):
        from pyrope_tpu_torch.service.tenants import TenantConfig

        reg = TenantRegistry()
        reg.create("t1", api_key="k")
        reg._tenants["t1"].quotas = None  # degenerate config
        enf = TenantQuotaEnforcer(reg, clock=ManualClock())
        assert enf.try_begin_request("t1")[0]
        assert not enf.is_over_budget("t1")
