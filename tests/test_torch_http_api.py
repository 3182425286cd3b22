"""The port's twin of ``tests/test_http_api.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

HTTP control-plane tests.

Mirror of the reference's WebApplicationFactory-based API tests (SURVEY §4
pattern 3: Api/{Index,Tenant,Cache,Billing,Audit,HealthMetrics,Ai}ApiTests)
— in-memory admin key, no hosted services, fake sidecar client for the AI
proxy."""

import asyncio

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.server.http_api import HttpApi
from pyrope_tpu_torch.types import IndexConfig

ADMIN = {"X-API-KEY": "admin-key"}


class FakeSidecar:
    def get_model_status(self):
        return {"active": "v1", "canary": None}

    def trigger_training(self):
        return {"status": "training", "job": "j1"}

    def deploy_model(self, version, canary_tenants):
        return {"status": "deployed", "version": version, "canary": canary_tenants}

    def rollback_model(self):
        return {"status": "rolled_back"}

    def get_evaluations(self):
        return [{"version": "v1", "precision": 0.9}]


def run(coro_fn, snapshot_dir):
    """Build engine+app, run the async test body against a TestClient."""

    async def main():
        engine = PyropeEngine(
            EngineConfig(
                device="cpu",
                auth=AuthSettings(enabled=True, admin_api_key="admin-key"),
                snapshot_dir=str(snapshot_dir),
            )
        )
        api = HttpApi(engine, sidecar_client=FakeSidecar())
        client = TestClient(TestServer(api.build_app()))
        await client.start_server()
        try:
            await coro_fn(client, engine)
        finally:
            await client.close()

    asyncio.run(main())


class TestHealthAndAuth:
    def test_health_no_auth(self, tmp_path):
        async def body(client, engine):
            r = await client.get("/v1/health")
            assert r.status == 200
            assert (await r.json())["status"] == "ok"

        run(body, tmp_path)

    def test_metrics_exposition(self, tmp_path):
        async def body(client, engine):
            engine.metrics.record_hit()
            # /v1/metrics needs a valid key (only /v1/health is exempt)
            r = await client.get("/v1/metrics")
            assert r.status == 401
            r = await client.get("/v1/metrics", headers=ADMIN)
            assert r.status == 200
            assert "pyrope_cache_hits_total 1" in await r.text()

        run(body, tmp_path)

    def test_missing_key_401(self, tmp_path):
        async def body(client, engine):
            r = await client.post("/v1/indexes", json={"tenant": "t1", "index": "i", "dim": 4})
            assert r.status == 401

        run(body, tmp_path)


class TestIndexApi:
    def test_create_build_stats_flow(self, tmp_path):
        async def body(client, engine):
            r = await client.post(
                "/v1/indexes",
                json={"tenant": "t1", "index": "idx", "dim": 8, "algorithm": "IVF_FLAT",
                      "params": {"nlist": 4}},
                headers=ADMIN,
            )
            assert r.status == 201
            # duplicate -> 409
            r = await client.post(
                "/v1/indexes", json={"tenant": "t1", "index": "idx", "dim": 8}, headers=ADMIN
            )
            assert r.status == 409
            rng = np.random.default_rng(0)
            engine.add_batch("t1", "idx", [f"v{i}" for i in range(50)],
                             rng.random((50, 8), dtype=np.float32), api_key="admin-key")
            r = await client.post("/v1/indexes/t1/idx/build", headers=ADMIN)
            assert r.status == 200
            body_json = await r.json()
            assert body_json["stats"]["count"] == 50
            # centroid auto-sync happened
            assert engine.clusters.has_clusters("t1", "idx")
            r = await client.get("/v1/indexes/t1/idx/stats", headers=ADMIN)
            assert (await r.json())["dim"] == 8
            r = await client.get("/v1/indexes/t1/nope/stats", headers=ADMIN)
            assert r.status == 404
            # audit recorded create+build
            logs = engine.audit.query(tenant_id="t1")
            assert {e.action for e in logs} >= {"index.create", "index.build"}

        run(body, tmp_path)

    def test_snapshot_load_roundtrip_and_path_safety(self, tmp_path):
        async def body(client, engine):
            await client.post(
                "/v1/indexes", json={"tenant": "t1", "index": "s", "dim": 4, "algorithm": "FLAT"},
                headers=ADMIN,
            )
            engine.add_batch("t1", "s", ["a", "b"],
                             np.eye(2, 4, dtype=np.float32), api_key="admin-key")
            r = await client.post("/v1/indexes/t1/s/snapshot", json={"path": "s1.snap"},
                                  headers=ADMIN)
            assert r.status == 200 and (await r.json())["bytes"] > 0
            assert engine.billing.get_usage("t1").snapshot_bytes > 0
            r = await client.post("/v1/indexes/t1/s/load", json={"path": "s1.snap"},
                                  headers=ADMIN)
            assert r.status == 200
            # escape attempt rejected
            r = await client.post("/v1/indexes/t1/s/snapshot",
                                  json={"path": "../../etc/evil"}, headers=ADMIN)
            assert r.status == 400

        run(body, tmp_path)

    def test_push_centroids(self, tmp_path):
        async def body(client, engine):
            await client.post(
                "/v1/indexes", json={"tenant": "t1", "index": "c", "dim": 2}, headers=ADMIN
            )
            r = await client.post(
                "/v1/indexes/t1/c/centroids",
                json={"centroids": [[0.0, 0.0], [5.0, 5.0]]},
                headers=ADMIN,
            )
            assert r.status == 200 and (await r.json())["clusters"] == 2
            assert engine.clusters.has_clusters("t1", "c")

        run(body, tmp_path)


class TestTenantApi:
    def test_tenant_lifecycle_and_rbac(self, tmp_path):
        async def body(client, engine):
            r = await client.post("/v1/tenants",
                                  json={"tenant": "t1", "api_key": "tkey",
                                        "quotas": {"max_qps": 100, "priority": 0}},
                                  headers=ADMIN)
            assert r.status == 201
            data = await r.json()
            assert data["api_key"] == "tkey" and data["quotas"]["max_qps"] == 100
            # non-admin cannot create tenants
            r = await client.post("/v1/tenants", json={"tenant": "t2"},
                                  headers={"X-API-KEY": "tkey"})
            assert r.status == 403
            # tenant key (TenantAdmin role) can read/update own quotas
            hdr = {"X-API-KEY": "tkey"}
            r = await client.get("/v1/tenants/t1/quotas", headers=hdr)
            assert (await r.json())["max_qps"] == 100
            r = await client.put("/v1/tenants/t1/quotas",
                                 json={"max_qps": 50, "priority": 1}, headers=hdr)
            assert (await r.json())["max_qps"] == 50
            # user CRUD
            r = await client.post("/v1/tenants/t1/users",
                                  json={"user": "alice", "role": "READER"}, headers=hdr)
            assert r.status == 201
            alice_key = (await r.json())["api_key"]
            # reader cannot manage users
            r = await client.post("/v1/tenants/t1/users",
                                  json={"user": "bob"}, headers={"X-API-KEY": alice_key})
            assert r.status == 403
            # reader can read quotas
            r = await client.get("/v1/tenants/t1/quotas", headers={"X-API-KEY": alice_key})
            assert r.status == 200
            # role update
            r = await client.put("/v1/tenants/t1/users/alice/role",
                                 json={"role": "OPERATOR"}, headers=hdr)
            assert (await r.json())["role"] == "OPERATOR"
            r = await client.get("/v1/tenants/t1/users", headers=hdr)
            assert (await r.json()) == [{"user": "alice", "role": "OPERATOR"}]
            r = await client.delete("/v1/tenants/t1/users/alice", headers=hdr)
            assert r.status == 200

        run(body, tmp_path)

    def test_apikey_rotation(self, tmp_path):
        async def body(client, engine):
            await client.post("/v1/tenants", json={"tenant": "t1", "api_key": "old"},
                              headers=ADMIN)
            r = await client.put("/v1/tenants/t1/apikey", json={}, headers={"X-API-KEY": "old"})
            new_key = (await r.json())["api_key"]
            assert new_key != "old"
            # old key no longer works
            r = await client.get("/v1/tenants/t1/quotas", headers={"X-API-KEY": "old"})
            assert r.status == 403
            r = await client.get("/v1/tenants/t1/quotas", headers={"X-API-KEY": new_key})
            assert r.status == 200

        run(body, tmp_path)


class TestCacheApi:
    def test_policies_flush_invalidate(self, tmp_path):
        async def body(client, engine):
            r = await client.get("/v1/cache/policies", headers=ADMIN)
            assert (await r.json())["enable_cache"] is True
            r = await client.put("/v1/cache/policies",
                                 json={"enable_cache": False, "default_ttl_seconds": 5},
                                 headers=ADMIN)
            assert r.status == 200
            assert engine.policy.store.current.enable_cache is False
            engine.cache_storage.set("cache:t1:i:x", "v", 60, tenant="t1")
            engine.cache_storage.set("cache:t2:i:y", "v", 60, tenant="t2")
            r = await client.post("/v1/cache/invalidate", json={"tenant": "t1"}, headers=ADMIN)
            assert (await r.json())["removed"] == 1
            r = await client.post("/v1/cache/flush", headers=ADMIN)
            assert (await r.json())["removed"] == 1

        run(body, tmp_path)


class TestAiApi:
    def test_proxy_endpoints(self, tmp_path):
        async def body(client, engine):
            r = await client.get("/v1/ai/models", headers=ADMIN)
            assert (await r.json())["active"] == "v1"
            r = await client.post("/v1/ai/models/train", headers=ADMIN)
            assert (await r.json())["status"] == "training"
            r = await client.post("/v1/ai/models/deploy",
                                  json={"version": "v2", "canary_tenants": ["t1"]},
                                  headers=ADMIN)
            assert (await r.json())["version"] == "v2"
            r = await client.post("/v1/ai/models/rollback", headers=ADMIN)
            assert (await r.json())["status"] == "rolled_back"
            r = await client.get("/v1/ai/evaluations", headers=ADMIN)
            assert (await r.json())[0]["version"] == "v1"

        run(body, tmp_path)

    def test_503_when_sidecar_missing(self, tmp_path):
        async def body_no_sidecar():
            engine = PyropeEngine(
                EngineConfig(device="cpu",
                             auth=AuthSettings(enabled=True, admin_api_key="admin-key"))
            )
            api = HttpApi(engine, sidecar_client=None)
            client = TestClient(TestServer(api.build_app()))
            await client.start_server()
            try:
                r = await client.get("/v1/ai/models", headers=ADMIN)
                assert r.status == 503
            finally:
                await client.close()

        asyncio.run(body_no_sidecar())


class TestBillingAuditApi:
    def test_billing_and_audit(self, tmp_path):
        async def body(client, engine):
            await client.post("/v1/tenants", json={"tenant": "t1", "api_key": "tk"},
                              headers=ADMIN)
            engine.billing.record_request("t1", cache_hit=True)
            engine.billing.record_compute("t1", 2.0)
            r = await client.get("/v1/billing/usage?tenantId=t1", headers={"X-API-KEY": "tk"})
            usage = (await r.json())["t1"]
            assert usage["requests_cache_hit"] == 1 and usage["compute_cost_units"] == 2.0
            # global view requires admin
            r = await client.get("/v1/billing/usage", headers={"X-API-KEY": "tk"})
            assert r.status == 403
            r = await client.get("/v1/billing/usage", headers=ADMIN)
            assert "t1" in await r.json()
            # audit
            r = await client.get("/v1/audit/logs?tenantId=t1", headers={"X-API-KEY": "tk"})
            actions = [e["action"] for e in await r.json()]
            assert "tenant.create" in actions
            r = await client.get("/v1/audit/stats", headers=ADMIN)
            assert (await r.json())["total"] >= 1

        run(body, tmp_path)


class TestIndexDelete:
    def test_drop_index(self, tmp_path):
        async def body(client, engine):
            await client.post("/v1/indexes",
                              json={"tenant": "t1", "index": "d", "dim": 4},
                              headers=ADMIN)
            assert engine.registry.try_get("t1", "d") is not None
            r = await client.delete("/v1/indexes/t1/d", headers=ADMIN)
            assert r.status == 200
            assert engine.registry.try_get("t1", "d") is None
            assert engine.index_meta.load("t1", "d") is None
            r = await client.delete("/v1/indexes/t1/d", headers=ADMIN)
            assert r.status == 404

        run(body, tmp_path)


class TestCacheAlias:
    def test_register_alias(self, tmp_path):
        async def body(client, engine):
            r = await client.post(
                "/v1/cache/aliases",
                json={"tenant": "t1", "alias_hash": "aaa", "canonical_hash": "bbb",
                      "confidence": 0.9},
                headers=ADMIN,
            )
            assert r.status == 200
            # namespaced by the body tenant; other tenants (and the global
            # namespace) do not see it (ADVICE r1: alias poisoning)
            assert engine.canonical.try_get_canonical("aaa", tenant="t1") == "bbb"
            assert engine.canonical.try_get_canonical("aaa") is None
            assert engine.canonical.try_get_canonical("aaa", tenant="t2") is None
            r = await client.post("/v1/cache/aliases", json={}, headers=ADMIN)
            assert r.status == 400

        run(body, tmp_path)


class TestDebugTrace:
    def test_trace_writes_a_chrome_trace_and_an_audit_entry(self, tmp_path):
        """``debug_trace`` runs on torch.profiler: the same reply keys and
        audit entry as the JAX package's, and a Chrome trace file under
        ``path`` (CPU activity only on a CPU engine)."""
        import json

        trace_dir = tmp_path / "trace"

        async def body(client, engine):
            r = await client.post("/v1/debug/trace", json={"seconds": 0.2})
            assert r.status == 401
            r = await client.post("/v1/debug/trace",
                                  json={"seconds": 0.2, "path": str(trace_dir)},
                                  headers=ADMIN)
            assert r.status == 200
            assert await r.json() == {"status": "captured", "trace_dir": str(trace_dir),
                                      "seconds": 0.2}
            files = list(trace_dir.glob("pyrope_trace_*.json"))
            assert len(files) == 1
            assert "traceEvents" in json.loads(files[0].read_text())
            (entry,) = engine.audit.query(action="debug.trace")
            assert entry.resource == str(trace_dir)
            assert entry.detail == {"seconds": 0.2}

        run(body, tmp_path)
