"""The port's twin of ``tests/test_sidecar.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

AI sidecar tests.

Mirrors the reference's Python test suite (SURVEY §4: mock-based unit
tests, canary-rollback behavior against a real PolicyService with temp
dirs, worker budget/rate-limit tests) plus a real end-to-end gRPC loop
(server on port 0 + PolicyServiceClient)."""

import json

import numpy as np
import pytest

from pyrope_tpu_torch.sidecar import policy_service_pb2 as pb
from pyrope_tpu_torch.sidecar.bandit_engine import ContextualBanditEngine
from pyrope_tpu_torch.sidecar.evaluate_model import evaluate
from pyrope_tpu_torch.sidecar.feature_engineering import QueryHistory, query_features
from pyrope_tpu_torch.sidecar.llm_dispatcher import LLMPrefetchDispatcher, LLMTTLAdvisor
from pyrope_tpu_torch.sidecar.llm_policy_engine import LLMPolicyEngine, clamp_policy, parse_llm_reply
from pyrope_tpu_torch.sidecar.llm_worker import LLMWorker
from pyrope_tpu_torch.sidecar.model_manager import ModelManager
from pyrope_tpu_torch.sidecar.policy_engine import HeuristicPolicyEngine
from pyrope_tpu_torch.sidecar.prediction_engine import PredictionEngine
from pyrope_tpu_torch.sidecar.server import PolicyService, serve
from pyrope_tpu_torch.sidecar.train_model import label_decision, train
from pyrope_tpu_torch.utils.clock import ManualClock


class TestHeuristic:
    def test_thresholds(self):
        eng = HeuristicPolicyEngine()
        assert eng.compute_policy({"cache_miss_rate": 0.6})["ttl_seconds"] == 300
        assert eng.compute_policy({"cache_miss_rate": 0.2})["ttl_seconds"] == 60


class TestBandit:
    def test_learns_preference(self):
        bandit = ContextualBanditEngine(epsilon=0.0, seed=1)
        hot = {"qps": 100, "cache_miss_rate": 0.9, "p99_latency_ms": 80, "cpu_utilization": 0.9}
        cool = {"qps": 5, "cache_miss_rate": 0.05, "p99_latency_ms": 5, "cpu_utilization": 0.1}
        for _ in range(30):
            bandit.update(hot, 1, reward=+0.2)    # aggressive good when hot
            bandit.update(cool, 0, reward=+0.25)  # normal good when cool
        assert bandit.select_action(hot) == 1
        assert bandit.select_action(cool) == 0

    def test_persistence(self, tmp_path):
        p = str(tmp_path / "bandit.pkl")
        b1 = ContextualBanditEngine(epsilon=0.0, model_path=p)
        m = {"qps": 1, "cache_miss_rate": 0.9, "p99_latency_ms": 99, "cpu_utilization": 0.9}
        for _ in range(10):
            b1.update(m, 1, +1.0)
        b1.save()
        b2 = ContextualBanditEngine(epsilon=0.0, model_path=p)
        assert b2.select_action(m) == 1


class TestPrediction:
    def test_markov_rule_emerges(self):
        eng = PredictionEngine()
        for _ in range(4):
            eng.record_access("t", "i", 1)
            eng.record_access("t", "i", 2)
        rules = eng.get_rules()
        assert {"tenant_id": "t", "index_name": "i", "from_cluster": 1,
                "to_cluster": 2} == {k: rules[0][k] for k in
                ("tenant_id", "index_name", "from_cluster", "to_cluster")}
        assert rules[0]["confidence"] > 0.5

    def test_below_min_count_no_rule(self):
        eng = PredictionEngine()
        eng.record_access("t", "i", 1)
        eng.record_access("t", "i", 2)
        assert eng.get_rules() == []


class TestLLMWorker:
    def test_disabled_without_key(self, monkeypatch):
        monkeypatch.delenv("GEMINI_API_KEY", raising=False)
        w = LLMWorker()
        assert not w.enabled
        assert not w.submit("p", lambda r: None)

    def test_rate_limit_per_minute(self):
        clk = ManualClock()
        w = LLMWorker(transport=lambda p: "{}", clock=clk)
        ok = 0
        for _ in range(100):
            if w.submit("x", lambda r: None):
                ok += 1
                w.process_one()  # drain so the queue never fills
        assert ok == 60 and w.stats["rejected_rate"] == 40
        clk.advance(61)
        assert w.submit("x", lambda r: None)

    def test_token_budget_per_minute(self):
        clk = ManualClock()
        w = LLMWorker(transport=lambda p: "{}", clock=clk)
        big = "x" * 4 * 60_000  # ~60k tokens
        assert w.submit(big, lambda r: None)
        assert not w.submit(big, lambda r: None)  # 120k > 100k/min
        assert w.stats["rejected_rate"] == 1

    def test_queue_fail_fast(self):
        w = LLMWorker(transport=lambda p: "{}", clock=ManualClock())
        for i in range(10):
            assert w.submit(f"p{i}", lambda r: None)
        assert not w.submit("overflow", lambda r: None)
        assert w.stats["rejected_queue"] == 1

    def test_retries_then_failure(self):
        calls = []

        def flaky(p):
            calls.append(1)
            raise RuntimeError("boom")

        w = LLMWorker(transport=flaky, clock=ManualClock())
        got = []
        w.submit("p", got.append)
        w.process_one()
        assert len(calls) == 3 and got == [None]
        assert w.stats["failed"] == 1


class TestLLMPolicyEngine:
    def test_clamping(self):
        p = clamp_policy({"admission_threshold": 9, "ttl_seconds": 99999, "eviction_priority": -3})
        assert p == {"admission_threshold": 1.0, "ttl_seconds": 3600, "eviction_priority": 0}

    def test_parse_reply_with_noise(self):
        assert parse_llm_reply('Sure! {"ttl_seconds": 120} done')["ttl_seconds"] == 120
        assert parse_llm_reply("no json here") is None

    def test_non_blocking_heuristic_then_cached_llm(self):
        w = LLMWorker(transport=lambda p: '{"admission_threshold":0.2,"ttl_seconds":240,"eviction_priority":1}',
                      clock=ManualClock())
        eng = LLMPolicyEngine(worker=w)
        m = {"qps": 10, "cache_miss_rate": 0.1, "p99_latency_ms": 10, "cpu_utilization": 0.2}
        p1 = eng.compute_policy("t1", m)
        assert p1["ttl_seconds"] == 60  # heuristic immediately
        w.process_one()                  # LLM reply lands in cache
        p2 = eng.compute_policy("t1", m)
        assert p2["ttl_seconds"] == 240  # cached LLM decision
        assert eng.stats["llm_decisions"] == 1


class TestLLMDispatchers:
    def test_prefetch_dispatch_confidence_gate(self):
        fired = []
        w = LLMWorker(transport=lambda p: '{"next_cluster": 7, "confidence": 0.9}',
                      clock=ManualClock())
        d = LLMPrefetchDispatcher(w, on_prefetch=lambda t, i, c: fired.append((t, i, c)))
        d.request_prediction("t", "i", [1, 2, 3])
        w.process_one()
        assert fired == [("t", "i", 7)]
        w2 = LLMWorker(transport=lambda p: '{"next_cluster": 7, "confidence": 0.3}',
                       clock=ManualClock())
        d2 = LLMPrefetchDispatcher(w2, on_prefetch=lambda t, i, c: fired.append("no"))
        d2.request_prediction("t", "i", [1])
        w2.process_one()
        assert len(fired) == 1  # low confidence suppressed

    def test_ttl_advisor_override(self):
        w = LLMWorker(transport=lambda p: '{"action": "shorten", "ttl_seconds": 5}',
                      clock=ManualClock())
        adv = LLMTTLAdvisor(w)
        adv.request_advice("i", 3, writes_per_min=50, ttl_seconds=60)
        w.process_one()
        assert adv.get_override("i", 3) == {"action": "shorten", "ttl_seconds": 5}


class TestTrainEval:
    def _write_log(self, path, n=60):
        rng = np.random.default_rng(0)
        with open(path, "w") as f:
            for i in range(n):
                hot = i % 2 == 0
                m = {
                    "qps": float(rng.uniform(1, 100)),
                    "cache_miss_rate": 0.6 if hot else 0.1,
                    "p99_latency_ms": 80.0 if hot else 10.0,
                    "cpu_utilization": 0.9 if hot else 0.2,
                }
                f.write(json.dumps({"metrics": m}) + "\n")

    def test_label_rule(self):
        assert label_decision({"cache_miss_rate": 0.4}) == 1
        assert label_decision({"cpu_utilization": 0.9}) == 1
        assert label_decision({"p99_latency_ms": 60}) == 1
        assert label_decision({"cache_miss_rate": 0.1, "cpu_utilization": 0.2,
                               "p99_latency_ms": 10}) == 0

    def test_train_and_evaluate(self, tmp_path):
        log = tmp_path / "d.jsonl"
        self._write_log(log)
        version = train(log, tmp_path / "staging", version="test-v1")
        assert (tmp_path / "staging" / "test-v1.joblib").exists()
        rep = evaluate(tmp_path / "staging" / f"{version}.joblib", log)
        assert rep["samples"] == 60
        assert rep["precision"] > 0.9 and rep["recall"] > 0.9
        assert rep["simulated_p99_improvement_ms"] > 0


class TestModelManager:
    def test_deploy_and_promote(self, tmp_path):
        mm = ModelManager(str(tmp_path))
        (mm.staging / "v1.joblib").write_bytes(b"model")
        out = mm.deploy("v1")
        assert out["status"] == "deployed" and out["active_version"] == "v1"
        (mm.staging / "v2.joblib").write_bytes(b"model2")
        mm.deploy("v2", canary_tenants=["t1"])
        st = mm.get_status()
        assert st["active_version"] == "v1" and st["canary_version"] == "v2"
        assert mm.is_canary_tenant("t1") and not mm.is_canary_tenant("t2")
        mm.promote_canary()
        assert mm.get_status()["active_version"] == "v2"

    def test_canary_auto_rollback(self, tmp_path):
        mm = ModelManager(str(tmp_path))
        (mm.staging / "v1.joblib").write_bytes(b"m")
        mm.deploy("v1", canary_tenants=["canary-t"])
        for _ in range(20):
            mm.record_latency_p99("baseline-t", 10.0)
        # two breaches then a good sample resets the counter
        assert not mm.record_latency_p99("canary-t", 20.0)
        assert not mm.record_latency_p99("canary-t", 20.0)
        assert not mm.record_latency_p99("canary-t", 10.0)
        assert not mm.record_latency_p99("canary-t", 20.0)
        assert not mm.record_latency_p99("canary-t", 20.0)
        assert mm.record_latency_p99("canary-t", 20.0)  # 3rd consecutive -> rollback
        assert mm.get_status()["canary_version"] is None

    def test_state_persists(self, tmp_path):
        mm = ModelManager(str(tmp_path))
        (mm.staging / "v1.joblib").write_bytes(b"m")
        mm.deploy("v1")
        mm2 = ModelManager(str(tmp_path))
        assert mm2.get_status()["active_version"] == "v1"


class TestPolicyServiceInProcess:
    def test_warm_path_decision_and_log(self, tmp_path):
        svc = PolicyService(str(tmp_path))
        req = pb.SystemMetricsRequest(
            tenant_id="t1", qps=50, cache_miss_rate=0.7,
            p99_latency_ms=80, cpu_utilization=0.5,
        )
        resp = svc.report_system_metrics(req)
        assert resp.policy.ttl_seconds >= 1
        assert resp.next_report_interval_ms == 10_000
        # second report triggers the delayed bandit reward update
        svc.report_system_metrics(req)
        assert svc.bandit.rewards_seen == 1
        log_lines = (tmp_path / "decisions.jsonl").read_text().strip().split("\n")
        assert len(log_lines) == 2

    def test_prefetch_roundtrip(self, tmp_path):
        svc = PolicyService(str(tmp_path))
        events = []
        for t in range(4):
            events += [
                pb.ClusterAccessEvent(tenant_id="t", index_name="i", cluster_id=1,
                                      timestamp=float(2 * t)),
                pb.ClusterAccessEvent(tenant_id="t", index_name="i", cluster_id=2,
                                      timestamp=float(2 * t + 1)),
            ]
        svc.report_cluster_access(pb.ClusterAccessBatch(events=events))
        rules = svc.get_prefetch_rules(pb.PrefetchRulesRequest())
        assert rules.rules[0].from_cluster == 1 and rules.rules[0].to_cluster == 2


class TestGrpcLoop:
    def test_end_to_end_grpc(self, tmp_path):
        from pyrope_tpu_torch.sidecar.client import PolicyServiceClient

        server, port, svc = serve(port=0, data_dir=str(tmp_path))
        try:
            client = PolicyServiceClient(f"127.0.0.1:{port}")
            out = client.report_system_metrics("t1", 10, 0.6, 40, 0.3, timeout=5.0)
            assert out["policy"]["ttl_seconds"] >= 1
            client.report_cluster_access(
                [{"tenant_id": "t", "index_name": "i", "cluster_id": 1, "timestamp": 1.0},
                 {"tenant_id": "t", "index_name": "i", "cluster_id": 2, "timestamp": 2.0}]
                * 4
            )
            rules = client.get_prefetch_rules()
            assert isinstance(rules, list)
            status = client.get_model_status()
            assert status["active"] is None
            client.close()
        finally:
            server.stop(0)

    def test_warm_path_deadline_raises(self, tmp_path):
        import grpc as grpc_mod

        from pyrope_tpu_torch.sidecar.client import PolicyServiceClient, SidecarUnavailable

        # nothing listening on this port -> deadline/unavailable
        client = PolicyServiceClient("127.0.0.1:1")
        with pytest.raises(SidecarUnavailable):
            client.report_system_metrics("t1", 1, 0.1, 1, 0.1)
        client.close()


class TestFeatureEngineering:
    def test_query_features(self):
        f = query_features([3.0, 4.0], 10, ("a",))
        assert f == [5.0, 10.0, 1.0]
        assert query_features([1.0], 5)[2] == 0.0

    def test_query_history(self):
        t = [0.0]
        h = QueryHistory(capacity=2, now=lambda: t[0])
        h.record("a", True)
        t[0] = 10
        h.record("a", False)
        assert h.hit_rate("a") == 0.5
        assert h.revisit_interval("a") == 10.0
        h.record("b", True)
        h.record("c", True)  # evicts "a" (LRU)
        assert h.hit_rate("a") is None


class TestWorkerAutostart:
    def test_policy_engine_starts_worker_thread(self):
        done = []
        w = LLMWorker(transport=lambda p: '{"ttl_seconds": 99}')
        eng = LLMPolicyEngine(worker=w)  # must start the consumer thread
        m = {"qps": 1, "cache_miss_rate": 0.1, "p99_latency_ms": 5, "cpu_utilization": 0.1}
        eng.compute_policy("t", m)
        import time
        for _ in range(100):
            if eng.stats["llm_decisions"]:
                break
            time.sleep(0.02)
        assert eng.stats["llm_decisions"] == 1
        assert eng.compute_policy("t", m)["ttl_seconds"] == 99
        w.stop()

    def test_bandit_periodic_persistence(self, tmp_path):
        p = str(tmp_path / "b.pkl")
        b = ContextualBanditEngine(epsilon=0.0, model_path=p)
        m = {"qps": 1, "cache_miss_rate": 0.9, "p99_latency_ms": 99, "cpu_utilization": 0.9}
        for _ in range(25):  # hits the save-every-25 gate
            b.update(m, 1, +1.0)
        import os
        assert os.path.exists(p)
        b2 = ContextualBanditEngine(epsilon=0.0, model_path=p)
        assert b2.select_action(m) == 1


class TestOnnxExportGate:
    """The gated ONNX export path (ref: train_model.py:96-130 — convert +
    checker + onnxruntime smoke inference). The image ships no onnx, so the
    flow is exercised with fake modules; the ImportError path must degrade
    to the joblib-only artifact."""

    def _fake_modules(self, calls):
        import sys
        import types

        import numpy as np

        class FakeOnx:
            def SerializeToString(self):
                return b"fake-onnx-bytes"

        skl2onnx = types.ModuleType("skl2onnx")
        skl2onnx.convert_sklearn = lambda model, initial_types: (
            calls.append(("convert", len(initial_types))) or FakeOnx()
        )
        dt = types.ModuleType("skl2onnx.common.data_types")
        dt.FloatTensorType = lambda shape: ("float_tensor", tuple(shape))
        common = types.ModuleType("skl2onnx.common")
        common.data_types = dt
        skl2onnx.common = common

        onnx = types.ModuleType("onnx")
        onnx.checker = types.SimpleNamespace(
            check_model=lambda m: calls.append(("check", type(m).__name__))
        )

        class FakeSession:
            def __init__(self, blob):
                calls.append(("ort_session", blob))

            def run(self, outs, feeds):
                calls.append(("ort_run", sorted(feeds)))
                return [np.zeros((1, 2))]

        ort = types.ModuleType("onnxruntime")
        ort.InferenceSession = FakeSession
        return {
            "skl2onnx": skl2onnx,
            "skl2onnx.common": common,
            "skl2onnx.common.data_types": dt,
            "onnx": onnx,
            "onnxruntime": ort,
        }

    def test_export_flow_convert_check_ort_write(self, tmp_path, monkeypatch):
        import sys

        from pyrope_tpu_torch.sidecar.train_model import maybe_export_onnx

        calls = []
        for name, mod in self._fake_modules(calls).items():
            monkeypatch.setitem(sys.modules, name, mod)
        out = tmp_path / "m.onnx"
        assert maybe_export_onnx(object(), out) is True
        assert [c[0] for c in calls] == ["convert", "check", "ort_session", "ort_run"]
        assert calls[3][1] == ["input"]  # ort fed through the declared input
        assert out.read_bytes() == b"fake-onnx-bytes"

    def test_ort_failure_aborts_export(self, tmp_path, monkeypatch):
        import sys

        import pytest

        from pyrope_tpu_torch.sidecar.train_model import maybe_export_onnx

        calls = []
        mods = self._fake_modules(calls)

        class BrokenSession:
            def __init__(self, blob):
                pass

            def run(self, outs, feeds):
                return []  # graph answers nothing

        mods["onnxruntime"].InferenceSession = BrokenSession
        for name, mod in mods.items():
            monkeypatch.setitem(sys.modules, name, mod)
        out = tmp_path / "m.onnx"
        with pytest.raises(RuntimeError):
            maybe_export_onnx(object(), out)
        assert not out.exists()  # nothing staged on a failed smoke inference

    def test_missing_toolchain_uses_handrolled_emitter(self, tmp_path):
        """Without skl2onnx/onnx the export falls back to the hand-rolled
        serializer (sidecar/onnx_emit.py) and still stages a REAL .onnx
        artifact (full semantics covered in tests/test_onnx_emit.py)."""
        import numpy as np
        from sklearn.ensemble import GradientBoostingClassifier

        from pyrope_tpu_torch.sidecar import onnx_emit
        from pyrope_tpu_torch.sidecar.train_model import maybe_export_onnx

        rng = np.random.default_rng(3)
        x = rng.random((80, 4))
        y = (x[:, 0] > 0.5).astype(int)
        model = GradientBoostingClassifier(random_state=42, n_estimators=5)
        model.fit(x, y)
        out = tmp_path / "m.onnx"
        assert maybe_export_onnx(model, out) is True  # image has no onnx
        info = onnx_emit.check_model(out.read_bytes())
        assert info["op_type"] == "TreeEnsembleClassifier"
