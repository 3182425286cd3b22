"""The port's data plane under concurrent requests, on the CPU.

The RESP server runs device work on worker threads (the executor behind
``search_resume``, ``asyncio.to_thread`` for slow writes) and the
micro-batcher lets two device batches run at once. These cases hold what
those threads share: the kernels' launch counts, an index searched while
it is written, and the micro-batcher's batches against the index's own
``search_batch``. The engine's device is checked as every entry point's is.
"""

import threading

import numpy as np
import pytest
import torch

from pyrope_tpu_torch.ops import fused_scan as fs
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.batcher import MicroBatcher
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.types import IndexConfig, IndexParams, SearchOptions

D = 16


def _engine(**kw):
    return PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False), **kw))


def _built(eng, n=3000, seed=0):
    rows = np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)
    eng.create_index("t", "ix", IndexConfig(dim=D, algorithm="IVF_FLAT",
                                            params=IndexParams(nlist=16, nprobe=4)))
    assert eng.add_batch("t", "ix", [f"v{i}" for i in range(n)], rows).ok
    assert eng.build_index("t", "ix")
    return rows


def _run(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)


def test_engine_defaults_to_the_card():
    assert EngineConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PyropeEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PyropeEngine(EngineConfig(device="cuda:0"))


def test_engine_refuses_an_unknown_device():
    with pytest.raises(ValueError):
        PyropeEngine(EngineConfig(device="meta"))


def test_engine_indexes_live_on_its_device():
    eng = _engine()
    _built(eng, n=500)
    st = eng.registry.try_get("t", "ix")
    assert st.index.tail.device == torch.device("cpu")
    assert st.index.head.device == torch.device("cpu")


def test_launch_counts_hold_under_threads():
    fs.reset_launches()
    per, nthreads = 5000, 8

    def count():
        for _ in range(per):
            fs.count_launch("ivf_scan")
            fs.count_launch("merge")

    _run([threading.Thread(target=count) for _ in range(nthreads)])
    assert fs.LAUNCHES["ivf_scan"] == per * nthreads
    assert fs.LAUNCHES["merge"] == per * nthreads
    fs.reset_launches()
    assert not any(fs.LAUNCHES.values())


def test_concurrent_singles_ride_shared_batches_with_the_same_hits():
    eng = _engine(microbatch_max=32, microbatch_wait_ms=20)
    rows = _built(eng)
    st = eng.registry.try_get("t", "ix")
    queries = rows[:64] + np.float32(0.01)
    got = {}

    def one(i):
        r = eng.search("t", "ix", queries[i], 10)
        assert r.ok, r.error_message
        got[i] = [(h.id, h.score) for h in r.hits]

    _run([threading.Thread(target=one, args=(i,)) for i in range(len(queries))])
    direct = st.index.search_batch(queries, 10, SearchOptions())
    for i, hits in enumerate(direct):
        assert [h.id for h in hits] == [g[0] for g in got[i]]
        np.testing.assert_allclose([h.score for h in hits], [g[1] for g in got[i]],
                                   rtol=1e-5, atol=1e-4)
    stats = eng.batcher.to_dict()
    assert stats["queries"] == len(queries)
    assert stats["batches"] < len(queries)


def test_searches_and_writes_at_once():
    """Writers upsert far from the corpus while readers search it: every
    search sees the corpus's own hits, every write is read back."""
    eng = _engine()
    rows = _built(eng)
    st = eng.registry.try_get("t", "ix")
    queries = rows[:48]
    before = st.index.search_batch(queries, 10, SearchOptions())
    writes = (np.random.default_rng(1).standard_normal((400, D)) + 100).astype(np.float32)
    errors = []

    def writer(w):
        for i in range(w, len(writes), 4):
            r = eng.add("t", "ix", f"w{i}", writes[i], upsert=True)
            if not r.ok:
                errors.append(r.error_message)

    def reader(r0):
        for i in range(r0, len(queries), 4):
            r = eng.search("t", "ix", queries[i], 10)
            if not r.ok or [h.id for h in r.hits] != [h.id for h in before[i]]:
                errors.append((i, r.error_message, [h.id for h in r.hits]))

    _run([threading.Thread(target=writer, args=(w,)) for w in range(4)]
         + [threading.Thread(target=reader, args=(r,)) for r in range(4)])
    assert not errors, errors[:3]
    assert eng.stats("t", "ix")["count"] == len(rows) + len(writes)
    found = st.index.search_batch(writes, 1, SearchOptions())
    assert [h[0].id for h in found] == [f"w{i}" for i in range(len(writes))]


def test_batcher_rider_errors_reach_every_rider():
    class Broken:
        def search_batch(self, q, k, opts):
            raise RuntimeError("device lost")

    b = MicroBatcher(max_batch=8, max_wait_ms=20)
    seen = []

    def one():
        try:
            b.search(Broken(), np.zeros(D, np.float32), 5)
        except Exception as e:  # noqa: BLE001
            seen.append(type(e).__name__)

    _run([threading.Thread(target=one) for _ in range(6)])
    assert seen == ["BatchError"] * 6
