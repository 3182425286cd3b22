"""The port's twin of ``tests/test_cache.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Cache layer tests — mirror the reference's cache test strategy
(ref: tests/Pyrope.GarnetServer.Tests/Model/QueryKeyTests.cs,
 Model/ResultCacheTests.cs, Services/LshServiceTests-style coverage,
 SemanticClusterRegistry write-heat tests) with a ManualClock for
determinism (SURVEY §4 point 1)."""

import numpy as np
import pytest

from pyrope_tpu_torch.cache import (
    CachePolicyConfig,
    CachePolicyStore,
    CanonicalKeyMap,
    DynamicPolicyEngine,
    LshService,
    MemoryCacheStorage,
    QueryKey,
    ResultCache,
    SemanticClusterRegistry,
    StaticPolicyEngine,
    WarmPathPolicy,
    round_k,
)
from pyrope_tpu_torch.types import Metric, SearchResult
from pyrope_tpu_torch.utils.clock import ManualClock


def qk(vec, top_k=10, simhash=None, cluster_id=None, tags=()):
    return QueryKey.create(
        "t1", "idx", np.asarray(vec, np.float32), top_k, "L2",
        tags=tags, simhash=simhash, cluster_id=cluster_id,
    )


class TestQueryKey:
    def test_round_k_buckets(self):
        assert round_k(1) == 5
        assert round_k(5) == 5
        assert round_k(6) == 10
        assert round_k(11) == 20
        assert round_k(21) == 50
        assert round_k(51) == 100
        # above the last bucket k passes through unchanged (ref
        # Model/QueryKey.cs:52-60) so distinct large-k queries never share
        # a cache line filled with fewer hits than requested
        assert round_k(101) == 101
        assert round_k(1000) == 1000

    def test_exact_equality_on_vector(self):
        a, b = qk([1, 2, 3]), qk([1, 2, 3])
        c = qk([1, 2, 4])
        assert a == b and hash(a) == hash(b)
        assert a != c

    def test_topk_bucketing_equates_nearby_k(self):
        assert qk([1, 2], top_k=7) == qk([1, 2], top_k=9)
        assert qk([1, 2], top_k=5) != qk([1, 2], top_k=7)

    def test_simhash_precedence_over_vector(self):
        a = qk([1, 2, 3], simhash=42)
        b = qk([9, 9, 9], simhash=42)
        assert a == b and hash(a) == hash(b)

    def test_cluster_precedence_over_simhash(self):
        a = qk([1, 2, 3], simhash=1, cluster_id=7)
        b = qk([4, 5, 6], simhash=2, cluster_id=7)
        assert a == b
        assert qk([1, 2], cluster_id=7) != qk([1, 2], cluster_id=8)

    def test_tags_are_part_of_identity(self):
        assert qk([1, 2], tags=("a", "b")) == qk([1, 2], tags=("b", "a"))
        assert qk([1, 2], tags=("a",)) != qk([1, 2], tags=("b",))

    def test_roundtrip_dict(self):
        a = qk([1, 2, 3], simhash=5)
        assert QueryKey.from_dict(a.to_dict()) == a


class TestMemoryCacheStorage:
    def test_ttl_expiry(self):
        clk = ManualClock()
        st = MemoryCacheStorage(clock=clk)
        st.set("k", "v", ttl_seconds=10, tenant="t1")
        assert st.get("k") == "v"
        clk.advance(11)
        assert st.get("k") is None

    def test_tenant_quota_drops_set(self):
        clk = ManualClock()
        st = MemoryCacheStorage(clock=clk, tenant_quota_mb=lambda t: 1 / 1024.0)
        # quota = 1 KiB
        assert st.set("a", "x" * 100, 60, tenant="t1")
        assert not st.set("b", "y" * 2000, 60, tenant="t1")  # over quota, dropped
        assert st.get("b") is None
        assert st.get("a") == "x" * 100

    def test_overwrite_accounts_bytes_once(self):
        st = MemoryCacheStorage(clock=ManualClock())
        st.set("k", "aaaa", 60, tenant="t1")
        b1 = st.tenant_bytes("t1")
        st.set("k", "bbbb", 60, tenant="t1")
        assert st.tenant_bytes("t1") == b1

    def test_remove_by_prefix_and_clear(self):
        st = MemoryCacheStorage(clock=ManualClock())
        st.set("cache:t1:i1:a", "1", 60, tenant="t1")
        st.set("cache:t1:i2:b", "2", 60, tenant="t1")
        assert st.remove_by_prefix("cache:t1:i1:") == 1
        assert st.get("cache:t1:i1:a") is None
        assert st.get("cache:t1:i2:b") == "2"
        assert st.clear() == 1
        assert st.tenant_bytes("t1") == 0


class TestResultCache:
    def setup_method(self):
        self.clk = ManualClock()
        self.storage = MemoryCacheStorage(clock=self.clk)
        self.epochs = {("t1", "idx"): 0}
        self.cache = ResultCache(self.storage, lambda t, i: self.epochs.get((t, i), -1))
        self.hits = [SearchResult("a", 1.0), SearchResult("b", 0.5)]

    def test_set_get_roundtrip(self):
        key = qk([1, 2, 3])
        self.cache.set(key, self.hits, ttl_seconds=60)
        got = self.cache.try_get(key)
        assert got == self.hits

    def test_epoch_bump_invalidates(self):
        key = qk([1, 2, 3])
        self.cache.set(key, self.hits, 60)
        self.epochs[("t1", "idx")] += 1  # a write to the index
        assert self.cache.try_get(key) is None

    def test_ttl_expiry(self):
        key = qk([1, 2, 3])
        self.cache.set(key, self.hits, 5)
        self.clk.advance(6)
        assert self.cache.try_get(key) is None

    def test_aliased_get_skips_key_equality_but_checks_epoch(self):
        key = qk([1, 2, 3])
        self.cache.set(key, self.hits, 60)
        assert (
            self.cache.try_get_aliased("t1", "idx", key.cache_hash()) == self.hits
        )
        self.epochs[("t1", "idx")] += 1
        assert self.cache.try_get_aliased("t1", "idx", key.cache_hash()) is None

    def test_key_collision_rejected(self):
        # Same storage key contents but different QueryKey identity -> miss.
        key = qk([1, 2, 3])
        self.cache.set(key, self.hits, 60)
        other = qk([9, 9, 9])
        assert self.cache.try_get(other) is None


class TestLsh:
    def test_deterministic_and_stable(self):
        a = LshService().simhash(np.ones(64, np.float32))
        b = LshService().simhash(np.ones(64, np.float32))
        assert a == b

    def test_nearby_vectors_share_hash(self):
        lsh = LshService()
        rng = np.random.default_rng(0)
        v = rng.standard_normal(128).astype(np.float32)
        near = v + 1e-5 * rng.standard_normal(128).astype(np.float32)
        assert lsh.simhash(v) == lsh.simhash(near)

    def test_batch_matches_single(self):
        lsh = LshService()
        rng = np.random.default_rng(1)
        vs = rng.standard_normal((8, 64)).astype(np.float32)
        batch = lsh.simhash_batch(vs)
        for i in range(8):
            assert int(batch[i]) == lsh.simhash(vs[i])

    def test_different_dims_different_planes(self):
        lsh = LshService()
        assert lsh.simhash(np.ones(32, np.float32)) != lsh.simhash(
            np.ones(64, np.float32)
        )


class TestSemanticClusterRegistry:
    def test_nearest_cluster(self):
        reg = SemanticClusterRegistry(clock=ManualClock())
        cents = np.array([[0, 0], [10, 10], [20, 0]], np.float32)
        reg.update_centroids("t1", "idx", cents, Metric.L2)
        cid, score = reg.find_nearest_cluster("t1", "idx", np.array([9, 9], np.float32))
        assert cid == 1
        assert score == pytest.approx(-2.0)

    def test_no_centroids_returns_none(self):
        reg = SemanticClusterRegistry(clock=ManualClock())
        assert reg.find_nearest_cluster("t1", "idx", np.zeros(4, np.float32)) is None

    def test_semantic_ttl_hot_cluster(self):
        clk = ManualClock()
        reg = SemanticClusterRegistry(clock=clk)
        reg.update_centroids("t1", "idx", np.zeros((2, 4), np.float32))
        for _ in range(11):
            reg.record_write("t1", "idx", 0)
        assert reg.get_recommended_ttl("t1", "idx", 0, 60.0) == pytest.approx(6.0)
        assert reg.get_recommended_ttl("t1", "idx", 1, 60.0) == 60.0
        clk.advance(61)  # window rolls over
        reg.record_write("t1", "idx", 0)
        assert reg.get_recommended_ttl("t1", "idx", 0, 60.0) == 60.0

    def test_ttl_floor_one_second(self):
        reg = SemanticClusterRegistry(clock=ManualClock())
        reg.update_centroids("t1", "idx", np.zeros((1, 4), np.float32))
        for _ in range(11):
            reg.record_write("t1", "idx", 0)
        assert reg.get_recommended_ttl("t1", "idx", 0, 2.0) == 1.0


class TestCanonicalKeyMap:
    def test_alias_roundtrip_and_ttl(self):
        clk = ManualClock()
        m = CanonicalKeyMap(clock=clk)
        m.set_alias("alias1", "canon1", confidence=0.9, ttl_seconds=100)
        assert m.try_get_canonical("alias1") == "canon1"
        clk.advance(101)
        assert m.try_get_canonical("alias1") is None

    def test_low_confidence_rejected(self):
        m = CanonicalKeyMap(clock=ManualClock(), min_confidence=0.5)
        m.set_alias("a", "c", confidence=0.3)
        assert m.try_get_canonical("a") is None

    def test_cleanup_expired(self):
        clk = ManualClock()
        m = CanonicalKeyMap(clock=clk)
        m.set_alias("a", "c", ttl_seconds=10)
        m.set_alias("b", "c", ttl_seconds=100)
        clk.advance(50)
        assert m.cleanup_expired() == 1
        assert len(m) == 1


class TestPolicyEngines:
    def test_static_policy(self):
        eng = StaticPolicyEngine(ttl_seconds=30)
        d = eng.evaluate(qk([1]))
        assert d.should_cache and d.ttl_seconds == 30
        eng.update_policy(WarmPathPolicy(ttl_seconds=120))
        assert eng.evaluate(qk([1])).ttl_seconds == 120

    def test_dynamic_policy_reads_store(self):
        store = CachePolicyStore(CachePolicyConfig(enable_cache=False, default_ttl_seconds=15))
        eng = DynamicPolicyEngine(store)
        d = eng.evaluate(qk([1]))
        assert not d.should_cache and d.ttl_seconds == 15
        eng.update_policy(WarmPathPolicy(ttl_seconds=300))
        assert eng.store.current.default_ttl_seconds == 300
        # enable flag is preserved across sidecar updates
        assert eng.store.current.enable_cache is False


class TestDatasets:
    """Dataset readers (ref: Datasets/FvecsReader.cs, GloveTxtReader.cs)."""

    def test_fvecs_roundtrip_and_limit(self, tmp_path):
        from pyrope_tpu_torch.utils.datasets import read_fvecs, write_fvecs

        v = np.arange(24, dtype=np.float32).reshape(6, 4)
        p = tmp_path / "x.fvecs"
        write_fvecs(p, v)
        assert np.allclose(read_fvecs(p), v)
        assert read_fvecs(p, limit=2).shape == (2, 4)

    def test_glove_txt(self, tmp_path):
        from pyrope_tpu_torch.utils.datasets import read_glove_txt

        p = tmp_path / "g.txt"
        p.write_text("hello 0.1 0.2 0.3\nworld 0.4 0.5 0.6\nbad line notafloat x\n")
        toks, vecs = read_glove_txt(p)
        assert toks[:2] == ["hello", "world"]
        assert vecs.shape[1] == 3
        assert np.allclose(vecs[0], [0.1, 0.2, 0.3])

    def test_clustered_queries_share_centers(self):
        from pyrope_tpu_torch.utils.datasets import (
            synthetic_clustered,
            synthetic_clustered_queries,
        )

        base = synthetic_clustered(500, 16, n_clusters=5, spread=0.01)
        qs = synthetic_clustered_queries(50, 16, n_clusters=5, spread=0.01)
        # every query is near SOME base point (same centers)
        d = ((qs[:, None, :] - base[None, :, :]) ** 2).sum(-1).min(1)
        assert float(d.max()) < 0.5
