"""The port's twin of ``tests/test_app.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Full-stack smoke test: sidecar + server in one process group.

Mirror of the reference's E2E smoke test + warm-path loop coverage
(SURVEY §4: tests/smoke_test.py drives a launched server over redis-py;
SidecarMetricsReporter applies returned policies)."""

import asyncio
import threading

import numpy as np
import pytest

from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.app import PyropeApp, SidecarMetricsReporter
from pyrope_tpu_torch.server.engine import EngineConfig
from pyrope_tpu_torch.server.resp_client import RespClient
from pyrope_tpu_torch.sidecar.server import serve
from pyrope_tpu_torch.utils.parsing import encode_vector


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    sidecar_server, sidecar_port, sidecar_svc = serve(
        port=0, data_dir=str(tmp_path_factory.mktemp("sidecar"))
    )
    app = PyropeApp(
        config=EngineConfig(device="cpu", auth=AuthSettings(enabled=False)),
        resp_port=0,
        http_port=0,
        sidecar_endpoint=f"127.0.0.1:{sidecar_port}",
    )
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(app.start())
        started.set()
        loop.run_forever()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    started.wait(15)
    yield app, sidecar_svc
    asyncio.run_coroutine_threadsafe(app.stop(), loop).result(10)
    loop.call_soon_threadsafe(loop.stop)
    t.join(timeout=5)
    sidecar_server.stop(0)


def test_smoke_resp_flow(stack):
    app, _ = stack
    rng = np.random.default_rng(1)
    vecs = rng.random((50, 16), dtype=np.float32)
    with RespClient("127.0.0.1", app.resp.port) as c:
        assert c.ping()
        for i in range(50):
            assert c.vec_add("smoke", "idx", f"v{i}", encode_vector(vecs[i])) == "VEC_OK"
        hits = c.vec_search("smoke", "idx", encode_vector(vecs[13]), 3)
        assert hits[0][0] == "v13"
        assert c.vec_del("smoke", "idx", "v13") == "VEC_OK"
        hits = c.vec_search("smoke", "idx", encode_vector(vecs[13]), 3)
        assert all(h[0] != "v13" for h in hits)


def test_warm_path_reporter_applies_policy(stack):
    app, sidecar_svc = stack
    reporter = SidecarMetricsReporter(app.engine, app.sidecar_client)
    # seed traffic so deltas exist, with heavy misses -> aggressive policy
    for _ in range(20):
        app.engine.metrics.record_miss()
        app.engine.metrics.record_search_latency(80.0)
    assert reporter.tick() is None  # first tick establishes the baseline
    for _ in range(50):
        app.engine.metrics.record_miss()
        app.engine.metrics.record_search_latency(80.0)
    out = reporter.tick()
    assert out is not None
    # miss rate 1.0 > 0.5 -> heuristic aggressive ttl 300 (possibly bandit-halved)
    ttl = app.engine.policy.store.current.default_ttl_seconds
    assert ttl in (300.0, 150.0)
    assert reporter.interval_s == 10.0  # server-advertised cadence


def test_reporter_fallback_when_sidecar_down(stack):
    app, _ = stack
    from pyrope_tpu_torch.sidecar.client import PolicyServiceClient

    dead = PolicyServiceClient("127.0.0.1:1")
    reporter = SidecarMetricsReporter(app.engine, dead)
    before = app.engine.metrics.get_snapshot().ai_fallbacks
    app.engine.metrics.record_search_latency(5.0)
    reporter.tick()  # baseline
    app.engine.metrics.record_search_latency(5.0)
    reporter.tick()
    assert app.engine.metrics.get_snapshot().ai_fallbacks > before
    dead.close()


def test_prefetcher_uses_grpc_client(stack):
    app, sidecar_svc = stack
    # teach the sidecar a transition t:i 1 -> 2
    for _ in range(4):
        app.engine.prefetcher.record_interaction("pf", "idx", 1)
        app.engine.prefetcher.record_interaction("pf", "idx", 2)
    app.engine.prefetcher.tick()  # flush access events
    # force rules refresh regardless of the 60 s gate
    app.engine.prefetcher._rules_refreshed_at = 0.0
    app.engine.prefetcher.tick()
    assert app.engine.prefetcher.get_prediction("pf", "idx", 1) == 2


def test_restart_persistence_roundtrip(tmp_path):
    """Checkpoint/resume story (SURVEY §5.4): index CONFIGS restore on
    engine construction (IndexMetadataManager) and DATA restores via
    snapshot/load — a full restart round trip."""
    import numpy as np

    from pyrope_tpu_torch.security import AuthSettings
    from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
    from pyrope_tpu_torch.types import IndexConfig, IndexParams

    cfg = EngineConfig(
        device="cpu",
        auth=AuthSettings(enabled=False),
        snapshot_dir=str(tmp_path / "snaps"),
        index_meta_path=str(tmp_path / "meta.json"),
    )
    eng1 = PyropeEngine(cfg)
    eng1.create_index("t1", "idx", IndexConfig(dim=8, algorithm="IVF_FLAT",
                                               params=IndexParams(nlist=4)))
    rng = np.random.default_rng(0)
    vecs = rng.random((200, 8), dtype=np.float32)
    eng1.add_batch("t1", "idx", [f"v{i}" for i in range(200)], vecs)
    eng1.build_index("t1", "idx")
    assert eng1.snapshot_index("t1", "idx", "backup") > 0

    # "restart": a fresh engine against the same metadata + snapshot dir
    eng2 = PyropeEngine(cfg)
    state = eng2.registry.try_get("t1", "idx")  # config restored
    assert state is not None and state.config.algorithm == "IVF_FLAT"
    assert state.config.params.nlist == 4
    assert eng2.stats("t1", "idx")["count"] == 0  # data needs the snapshot
    assert eng2.load_index("t1", "idx", "backup")
    assert eng2.stats("t1", "idx")["count"] == 200
    r = eng2.search("t1", "idx", vecs[42], 3)
    assert r.ok and r.hits[0].id == "v42"


def test_serving_executor_exceeds_cpu_default(stack):
    """asyncio.to_thread's default pool is min(32, cpu+4) — 5 threads on a
    1-core host, which silently caps concurrent engine calls and pins the
    micro-batcher's group size at the pool size instead of client
    concurrency (measured: avg_batch 3 / max 5 at concurrency 64).
    PyropeApp.start must install a serving-sized executor."""
    import concurrent.futures

    app, _ = stack
    barrier = threading.Barrier(16, timeout=10)
    errors = []

    def blocker():
        try:
            barrier.wait()  # only passes if >= 16 run simultaneously
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    async def fan_out():
        await asyncio.gather(*(asyncio.to_thread(blocker) for _ in range(16)))

    loop = app._bg_task.get_loop()
    asyncio.run_coroutine_threadsafe(fan_out(), loop).result(20)
    assert not errors, errors
