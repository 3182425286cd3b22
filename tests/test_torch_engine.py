"""The port's twin of ``tests/test_engine.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Full-pipeline engine tests — the in-process analog of the reference's
RESP integration suite (SURVEY §4 pattern 2: VectorSearchCacheTests,
SemanticCacheTests, VectorSearchTraceTests, SearchDegradeIntegrationTests,
CacheHintForceTests, NoisyNeighborMitigationTests, CostAwareQueryTests,
RespAuthIntegrationTests) driven directly against PyropeEngine."""

import numpy as np
import pytest

from pyrope_tpu_torch.cache import StaticPolicyEngine
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.service import SloGuardrailsOptions, TenantQuota
from pyrope_tpu_torch.types import IndexConfig, SearchOptions
from pyrope_tpu_torch.utils.clock import ManualClock


def make_engine(auth_enabled=False, **cfg_kwargs):
    clk = ManualClock()
    cfg = EngineConfig(
        device="cpu", auth=AuthSettings(enabled=auth_enabled, admin_api_key="admin-key"),
        **cfg_kwargs,
    )
    eng = PyropeEngine(cfg, clock=clk)
    return eng, clk


def load_basic(eng, n=50, dim=8, tenant="t1", index="idx", algorithm="FLAT"):
    rng = np.random.default_rng(7)
    vecs = rng.random((n, dim), dtype=np.float32)
    eng.create_index(tenant, index, IndexConfig(dim=dim, algorithm=algorithm))
    for i in range(n):
        r = eng.add(tenant, index, f"v{i}", vecs[i],
                    meta={"i": i}, tags=("even",) if i % 2 == 0 else ("odd",))
        assert r.ok, r.error_message
    return vecs


class TestSearchPipeline:
    def test_basic_search_and_meta(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        r = eng.search("t1", "idx", vecs[3], top_k=5, with_meta=True)
        assert r.ok and r.hits[0].id == "v3"
        assert r.hits[0].meta == {"i": 3}

    def test_unknown_index(self):
        eng, _ = make_engine()
        r = eng.search("t1", "nope", np.zeros(4, np.float32))
        assert not r.ok and r.error_code == "VEC_ERR_NOT_FOUND"

    def test_dim_mismatch(self):
        eng, _ = make_engine()
        load_basic(eng, dim=8)
        r = eng.search("t1", "idx", np.zeros(4, np.float32))
        assert not r.ok and r.error_code == "VEC_ERR_DIM"
        w = eng.add("t1", "idx", "bad", np.zeros(3, np.float32))
        assert not w.ok and w.error_code == "VEC_ERR_DIM"

    def test_tag_filter(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        r = eng.search("t1", "idx", vecs[2], top_k=5, filter_tags=("even",))
        assert r.ok and all(int(h.id[1:]) % 2 == 0 for h in r.hits)

    def test_delete_visibility(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        assert eng.delete("t1", "idx", "v3").ok
        r = eng.search("t1", "idx", vecs[3], top_k=5)
        assert r.ok and all(h.id != "v3" for h in r.hits)
        assert not eng.delete("t1", "idx", "v3").ok  # already gone

    def test_duplicate_add_rejected_upsert_allowed(self):
        eng, _ = make_engine()
        vecs = load_basic(eng, n=5)
        assert not eng.add("t1", "idx", "v0", vecs[1]).ok
        assert eng.add("t1", "idx", "v0", vecs[1], upsert=True).ok
        r = eng.search("t1", "idx", vecs[1], top_k=2)
        assert r.hits[0].id in ("v0", "v1")


class TestCacheBehavior:
    def test_l0_hit_and_epoch_invalidation(self):
        eng, _ = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        vecs = load_basic(eng)
        r1 = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert not r1.trace.cache_hit
        r2 = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert r2.trace.cache_hit and r2.trace.cache_level == "L0"
        assert [h.id for h in r2.hits] == [h.id for h in r1.hits]
        # any write bumps the epoch -> cold again (ref VectorSearchCacheTests)
        eng.add("t1", "idx", "new", vecs[1] * 0.5)
        r3 = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert not r3.trace.cache_hit

    def test_cache_ttl_expiry(self):
        eng, clk = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=1)
        vecs = load_basic(eng)
        eng.search("t1", "idx", vecs[0], top_k=5)
        clk.advance(2)
        r = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert not r.trace.cache_hit

    def test_l1_simhash_hit_for_nearby_query(self):
        eng, _ = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        vecs = load_basic(eng, dim=32)
        eng.search("t1", "idx", vecs[0], top_k=5)
        nearby = vecs[0] + 1e-6
        r = eng.search("t1", "idx", nearby, top_k=5, trace=True)
        assert r.trace.cache_hit and r.trace.cache_level == "L1"

    def test_l2_cluster_hit_after_build(self):
        eng, _ = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        rng = np.random.default_rng(3)
        # two tight clusters far apart; small count keeps proxy cost low
        c0 = rng.normal(0, 0.01, (30, 8)).astype(np.float32)
        c1 = (rng.normal(0, 0.01, (30, 8)) + 5).astype(np.float32)
        eng.create_index("t1", "idx", IndexConfig(dim=8, algorithm="IVF_FLAT",
                                                  params=__import__("pyrope_tpu_torch.types", fromlist=["IndexParams"]).IndexParams(nlist=2)))
        for i, v in enumerate(np.concatenate([c0, c1])):
            eng.add("t1", "idx", f"v{i}", v)
        assert eng.build_index("t1", "idx")
        q1 = c0[0] + 0.001
        eng.search("t1", "idx", q1, top_k=5)
        # different exact vector, same cluster, within threshold -> L2 hit
        q2 = c0[1] + 0.001
        r = eng.search("t1", "idx", q2, top_k=5, trace=True)
        assert r.trace.cache_hit and r.trace.cache_level == "L2"

    def test_canonical_alias_l05(self):
        eng, _ = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        vecs = load_basic(eng)
        from pyrope_tpu_torch.cache import QueryKey

        eng.search("t1", "idx", vecs[0], top_k=5)
        canonical = QueryKey.create("t1", "idx", vecs[0], 5, "L2")
        alias = QueryKey.create("t1", "idx", vecs[9] * 7, 5, "L2")
        eng.canonical.set_alias(alias.cache_hash(), canonical.cache_hash(), 0.9)
        r = eng.search("t1", "idx", vecs[9] * 7, top_k=5, trace=True)
        assert r.trace.cache_hit and r.trace.cache_level == "L0.5"


class TestTrace:
    def test_trace_breakdown_fields(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        r = eng.search("t1", "idx", vecs[0], top_k=5, trace=True, request_id="req-1")
        t = r.trace.to_dict()
        assert t["request_id"] == "req-1"
        assert t["latency_ms"] > 0
        assert t["engine_ms"] > 0
        assert not t["cache_hit"]
        r2 = eng.search("t1", "idx", vecs[0], top_k=5)
        assert r2.trace is None  # opt-in only


class TestDegradation:
    def test_cache_hint_force_sheds_miss(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        r = eng.search("t1", "idx", vecs[0], top_k=5, cache_hint_force=True)
        assert not r.ok and r.error_code == "VEC_ERR_BUSY"

    def test_low_priority_shed_when_degraded(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        eng.tenants.create("t1", api_key="k", quotas=TenantQuota(priority=2))
        eng.slo.observe_p99(1000.0)  # force degraded
        r = eng.search("t1", "idx", vecs[0], top_k=5)
        assert not r.ok and r.error_code == "VEC_ERR_BUSY"
        # priority 0 tenant unaffected
        eng.tenants.update_quotas("t1", TenantQuota(priority=0))
        assert eng.search("t1", "idx", vecs[0], top_k=5).ok

    def test_budget_degradation_flag(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        eng.tenants.create("t1", api_key="k", quotas=TenantQuota(monthly_budget=0.0001))
        eng.quota.record_cost("t1", 1.0)
        r = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert r.ok and r.trace.budget_adjustment

    def test_qps_quota_rejects(self):
        eng, _ = make_engine()
        vecs = load_basic(eng)
        eng.tenants.create("t1", api_key="k", quotas=TenantQuota(max_qps=1))
        assert eng.search("t1", "idx", vecs[0], top_k=5).ok
        r = eng.search("t1", "idx", vecs[0], top_k=5)
        assert not r.ok and r.error_code == "VEC_ERR_QUOTA"


class TestAuth:
    def test_api_key_required_when_enabled(self):
        eng, _ = make_engine(auth_enabled=True)
        eng.tenants.create("t1", api_key="secret")
        eng.create_index("t1", "idx", IndexConfig(dim=4))
        v = np.ones(4, np.float32)
        assert eng.add("t1", "idx", "a", v, api_key="secret").ok
        r = eng.add("t1", "idx", "b", v, api_key="wrong")
        assert not r.ok and r.error_code == "VEC_ERR_AUTH"
        assert eng.search("t1", "idx", v, api_key=None).error_code == "VEC_ERR_AUTH"
        assert eng.search("t1", "idx", v, api_key="secret").ok
        assert eng.search("t1", "idx", v, api_key="admin-key").ok  # admin bypass

    def test_session_auth_skips_per_command_key(self):
        from pyrope_tpu_torch.security import SessionAuthContext

        eng, _ = make_engine(auth_enabled=True)
        eng.tenants.create("t1", api_key="secret")
        eng.create_index("t1", "idx", IndexConfig(dim=4))
        v = np.ones(4, np.float32)
        SessionAuthContext.set_tenant("t1")
        try:
            assert eng.add("t1", "idx", "a", v).ok
            assert eng.search("t1", "idx", v).ok
        finally:
            SessionAuthContext.clear()


class TestPrefetch:
    def test_prefetch_warms_predicted_cluster(self):
        eng, _ = make_engine()
        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        rng = np.random.default_rng(5)
        c0 = rng.normal(0, 0.01, (20, 8)).astype(np.float32)
        c1 = (rng.normal(0, 0.01, (20, 8)) + 5).astype(np.float32)
        from pyrope_tpu_torch.types import IndexParams

        eng.create_index("t1", "idx", IndexConfig(dim=8, algorithm="IVF_FLAT",
                                                  params=IndexParams(nlist=2)))
        for i, v in enumerate(np.concatenate([c0, c1])):
            eng.add("t1", "idx", f"v{i}", v)
        eng.build_index("t1", "idx")
        # figure out cluster ids
        a = eng.clusters.find_nearest_cluster("t1", "idx", c0[0])[0]
        b = eng.clusters.find_nearest_cluster("t1", "idx", c1[0])[0]
        eng.prefetcher.set_rules_for_test({("t1", "idx", a): b})
        eng.search("t1", "idx", c0[0], top_k=5)   # triggers prefetch of b
        assert eng.prefetch_queue.run_pending() == 1
        # centroid-of-b query now hits the L2 cache line
        cents = eng.clusters.get_centroids("t1", "idx")
        r = eng.search("t1", "idx", cents[b], top_k=5, trace=True)
        assert r.trace.cache_hit and r.trace.cache_level == "L2"


class TestStatsAndBatch:
    def test_stats(self):
        eng, _ = make_engine()
        load_basic(eng, n=10)
        s = eng.stats("t1", "idx")
        assert s["count"] == 10 and s["dim"] == 8 and s["epoch"] == 10
        assert eng.stats("t1", "nope") is None

    def test_add_batch(self):
        eng, _ = make_engine()
        rng = np.random.default_rng(0)
        vs = rng.random((100, 16), dtype=np.float32)
        eng.create_index("t1", "idx", IndexConfig(dim=16, algorithm="FLAT"))
        r = eng.add_batch("t1", "idx", [f"v{i}" for i in range(100)], vs)
        assert r.ok
        assert eng.stats("t1", "idx")["count"] == 100
        out = eng.search("t1", "idx", vs[42], top_k=1)
        assert out.hits[0].id == "v42"


class TestReviewFixes:
    """Regression tests for the code-review findings."""

    def test_roundk_bucket_serves_larger_k(self):
        # top_k=3 fills the bucket-5 cache line; a top_k=5 query on the same
        # bucket must get 5 hits, not the 3 originally requested.
        eng, _ = make_engine()
        from pyrope_tpu_torch.cache import StaticPolicyEngine

        eng.policy = StaticPolicyEngine(ttl_seconds=60)
        vecs = load_basic(eng, n=30)
        r3 = eng.search("t1", "idx", vecs[0], top_k=3)
        assert len(r3.hits) == 3
        r5 = eng.search("t1", "idx", vecs[0], top_k=5, trace=True)
        assert r5.trace.cache_hit
        assert len(r5.hits) == 5

    def test_snapshot_tenant_namespacing(self, tmp_path):
        from pyrope_tpu_torch.security import AuthSettings
        from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
        from pyrope_tpu_torch.types import IndexConfig
        import numpy as np

        eng = PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False),
                                        snapshot_dir=str(tmp_path)))
        eng.create_index("tA", "i", IndexConfig(dim=4, algorithm="FLAT"))
        eng.create_index("tB", "i", IndexConfig(dim=4, algorithm="FLAT"))
        eng.add("tA", "i", "secret", np.ones(4, np.float32))
        eng.snapshot_index("tA", "i", "snap")
        # tenant B loading the same relative path gets ITS OWN namespace
        import pytest as _pytest

        with _pytest.raises(Exception):
            eng.load_index("tB", "i", "snap")  # no such file in tB's dir

    def test_cache_sweep_reclaims_tenant_bytes(self):
        eng, clk = make_engine()
        eng.tenants.create("t1", api_key="k",
                           quotas=__import__("pyrope_tpu_torch.service", fromlist=["TenantQuota"]).TenantQuota(cache_memory_mb=1/1024.0))
        st = eng.cache_storage
        st.set("cache:t1:i:x", "v" * 500, ttl_seconds=5, tenant="t1")
        clk.advance(10)
        assert st.tenant_bytes("t1") > 0
        eng.tick_background()
        assert st.tenant_bytes("t1") == 0

    def test_add_batch_respects_quota_and_names(self):
        eng, _ = make_engine()
        import numpy as np

        from pyrope_tpu_torch.service import TenantQuota

        eng.tenants.create("t1", api_key="k", quotas=TenantQuota(max_qps=1))
        v = np.ones((2, 4), np.float32)
        assert eng.add_batch("t1", "idx", ["a", "b"], v).ok
        r = eng.add_batch("t1", "idx", ["c", "d"], v)
        assert not r.ok and r.error_code == "VEC_ERR_QUOTA"
        r = eng.add_batch("t2", "bad:name", ["a"], np.ones((1, 4), np.float32))
        assert not r.ok and r.error_code == "VEC_ERR_DIM"


class TestIndexParamsPlumbing:
    """New tuning knobs must be reachable through the server's IndexConfig
    (the reference parses all index params from config —
    ref: Services/VectorIndexRegistry.cs:87-126)."""

    def test_nprobe_and_refine_parse_and_apply(self):
        from pyrope_tpu_torch.registry import create_index
        from pyrope_tpu_torch.types import IndexConfig, IndexParams

        p = IndexParams.from_dict(
            {"nlist": 10, "pq_m": 4, "nprobe": 7, "refine": 16}
        )
        assert p.nprobe == 7 and p.refine == 16
        idx = create_index(IndexConfig(dim=32, algorithm="IVF_PQ", params=p), "cpu")
        assert idx.tail.nprobe == 7 and idx.tail.refine == 16
        idx2 = create_index(IndexConfig(dim=32, algorithm="IVF_FLAT", params=p), "cpu")
        assert idx2.tail.nprobe == 7

    def test_unknown_param_rejected(self):
        import pytest

        from pyrope_tpu_torch.types import IndexParams

        with pytest.raises(ValueError):
            IndexParams.from_dict({"bogus": 1})
