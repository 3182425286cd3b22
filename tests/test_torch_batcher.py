"""The port's twin of ``tests/test_batcher.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

Micro-batching scheduler tests (pyrope_tpu_torch/server/batcher.py)."""

import threading

import numpy as np

from pyrope_tpu_torch.index.flat import FlatIndex
from pyrope_tpu_torch.server.batcher import MicroBatcher
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.types import IndexConfig


def make_index(n=64, dim=8):
    rng = np.random.default_rng(0)
    vecs = rng.random((n, dim), dtype=np.float32)
    idx = FlatIndex(dim, "L2", device="cpu")
    idx.add_batch([f"v{i}" for i in range(n)], vecs)
    return idx, vecs


class TestMicroBatcher:
    def test_single_query_correct(self):
        idx, vecs = make_index()
        b = MicroBatcher(max_batch=8, max_wait_ms=1)
        hits = b.search(idx, vecs[5], 3)
        assert hits[0].id == "v5"
        assert b.stats.batches == 1 and b.stats.queries == 1

    def test_concurrent_queries_share_batches(self):
        idx, vecs = make_index()
        b = MicroBatcher(max_batch=16, max_wait_ms=20)
        results = {}
        barrier = threading.Barrier(12)

        def worker(i):
            barrier.wait()
            results[i] = b.search(idx, vecs[i], 1)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        for i in range(12):
            assert results[i][0].id == f"v{i}"
        # 12 queries in far fewer than 12 device batches
        assert b.stats.batches < 12
        assert b.stats.max_batch_seen > 1
        assert b.stats.queries == 12

    def test_max_batch_closes_group(self):
        idx, vecs = make_index()
        b = MicroBatcher(max_batch=2, max_wait_ms=1000)  # long wait: must close by size
        out = {}
        t0 = threading.Thread(target=lambda: out.update(a=b.search(idx, vecs[1], 1)))
        t1 = threading.Thread(target=lambda: out.update(b=b.search(idx, vecs[2], 1)))
        t0.start(); t1.start()
        t0.join(timeout=10); t1.join(timeout=10)
        assert out["a"][0].id == "v1" and out["b"][0].id == "v2"
        assert b.stats.max_batch_seen == 2

    def test_error_propagates_to_riders(self):
        from pyrope_tpu_torch.server.batcher import BatchError

        idx, vecs = make_index(dim=8)
        b = MicroBatcher(max_batch=4, max_wait_ms=5)
        bad = np.zeros(3, np.float32)  # dim mismatch -> search_batch raises
        with np.testing.assert_raises(BatchError):
            b.search(idx, bad, 1)
        # pre-batched arrays are rejected up front, not flattened
        with np.testing.assert_raises(ValueError):
            b.search(idx, vecs[:4], 1)

    def test_distinct_options_do_not_mix(self):
        import pyrope_tpu_torch as pt

        idx, vecs = make_index()
        b = MicroBatcher(max_batch=8, max_wait_ms=5)
        h1 = b.search(idx, vecs[0], 1, pt.SearchOptions(max_scans=10))
        h2 = b.search(idx, vecs[0], 1, pt.SearchOptions())
        assert b.stats.batches == 2
        assert h2[0].id == "v0"


class TestEngineIntegration:
    def test_engine_search_through_batcher(self):
        eng = PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False),
                                        microbatch_max=8, microbatch_wait_ms=1))
        rng = np.random.default_rng(1)
        vecs = rng.random((32, 8), dtype=np.float32)
        eng.create_index("t", "i", IndexConfig(dim=8, algorithm="FLAT"))
        eng.add_batch("t", "i", [f"v{i}" for i in range(32)], vecs)
        r = eng.search("t", "i", vecs[7], 3)
        assert r.ok and r.hits[0].id == "v7"
        assert eng.stats("t", "i")["microbatch"]["queries"] >= 1

    def test_engine_batcher_disabled(self):
        eng = PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False),
                                        microbatch_max=0))
        assert eng.batcher is None
        vecs = np.eye(4, dtype=np.float32)
        eng.create_index("t", "i", IndexConfig(dim=4, algorithm="FLAT"))
        eng.add_batch("t", "i", ["a", "b", "c", "d"], vecs)
        assert eng.search("t", "i", vecs[1], 1).hits[0].id == "b"


class _SlowIndex:
    """Fake index with a fixed per-batch service time — models a busy
    device (or a high-RTT link) for the in-flight gate tests."""

    def __init__(self, inner, delay_s: float):
        self.inner = inner
        self.delay_s = delay_s
        self.batch_sizes: list = []

    def search_batch(self, batch, top_k, options):
        import time

        self.batch_sizes.append(len(batch))
        time.sleep(self.delay_s)
        return self.inner.search_batch(batch, top_k, options)


class TestInflightGate:
    def test_groups_grow_while_device_busy(self):
        """With the gate, arrivals during an in-flight batch join the OPEN
        group instead of dispatching their own: 32 staggered requests
        against a 30 ms service time must coalesce into a few batches, not
        ~32 near-singleton dispatches (the pre-gate behavior: the 0.5 ms
        wait window closes groups long before the device frees up)."""
        import time

        idx, vecs = make_index(n=64, dim=8)
        slow = _SlowIndex(idx, delay_s=0.03)
        b = MicroBatcher(max_batch=64, max_wait_ms=0.5, max_inflight=1)
        results = [None] * 32
        errs = []

        def worker(i):
            try:
                results[i] = b.search(slow, vecs[i % 64], 3)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
            time.sleep(0.002)  # staggered arrivals, all within ~3 batches
        for t in threads:
            t.join()
        assert not errs
        assert all(r is not None for r in results)
        # every query correct despite riding shared batches
        for i, r in enumerate(results):
            assert r[0].id == f"v{i % 64}"
        # the gate is what keeps this small: 32 arrivals over ~64 ms of
        # device busy time -> a handful of batches (ungated: ~one per
        # arrival after the first). Bound is loose (16 vs the ungated ~32)
        # because the single-core CI host can stretch the 2 ms stagger.
        assert b.stats.batches <= 16, slow.batch_sizes
        assert b.stats.max_batch_seen >= 4, slow.batch_sizes

    def test_ungated_matches_old_behavior(self):
        idx, vecs = make_index(n=64, dim=8)
        b = MicroBatcher(max_batch=8, max_wait_ms=1, max_inflight=0)
        hits = b.search(idx, vecs[3], 3)
        assert hits[0].id == "v3"

    def test_full_group_closes_under_gate(self):
        """max_batch fill while the gate is held must still close/dispatch
        exactly once and keep slots consistent."""
        idx, vecs = make_index(n=64, dim=8)
        slow = _SlowIndex(idx, delay_s=0.02)
        b = MicroBatcher(max_batch=4, max_wait_ms=50, max_inflight=1)
        results = [None] * 12
        errs = []

        def worker(i):
            try:
                results[i] = b.search(slow, vecs[i], 3)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs
        for i, r in enumerate(results):
            assert r[0].id == f"v{i}"
        # groups cap at max_batch even while the gate backs them up
        assert max(slow.batch_sizes) <= 4


class TestLinger:
    def test_linger_merges_second_cohort(self):
        """Two request waves separated by less than the linger must ride ONE
        batch: without the post-acquire hold the leader dispatches the
        instant the gate frees and the second wave forms its own group
        (the closed-loop ping-pong that pins avg_batch at half the offered
        concurrency)."""
        import time

        idx, vecs = make_index(n=64, dim=8)
        # Generous linger: under a loaded single-core full-suite run, just
        # starting the second thread wave can take tens of ms — the window
        # must dwarf scheduler jitter or this flakes.
        b = MicroBatcher(max_batch=64, max_wait_ms=0.5, max_inflight=1,
                         linger_ms=1000.0)
        results = [None] * 16
        errs = []

        def worker(i):
            try:
                results[i] = b.search(idx, vecs[i], 3)
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        first = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        second = [threading.Thread(target=worker, args=(i,))
                  for i in range(8, 16)]
        for t in first:
            t.start()
        time.sleep(0.02)  # well inside the 1000 ms linger window
        for t in second:
            t.start()
        for t in first + second:
            t.join()
        assert not errs
        for i, r in enumerate(results):
            assert r is not None and r[0].id == f"v{i}"
        assert b.stats.batches == 1, b.to_dict()
        assert b.stats.max_batch_seen == 16, b.to_dict()

    def test_linger_early_exits_when_full(self):
        """A full group must not serve out the whole linger."""
        import time

        idx, vecs = make_index(n=8, dim=8)
        b = MicroBatcher(max_batch=8, max_wait_ms=0.5, max_inflight=1,
                         linger_ms=5000.0)
        results = [None] * 8

        def worker(i):
            results[i] = b.search(idx, vecs[i], 3)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        took = time.perf_counter() - t0
        assert took < 2.0, took  # early exit, not the 5 s linger
        assert all(r is not None for r in results)
        assert b.stats.max_batch_seen == 8


class TestLingerGating:
    def test_no_linger_without_gate(self):
        """Ungated configs (max_inflight=0) must not pay the linger tax:
        there is no device-pressure signal, so the post-acquire hold is
        skipped and a lone query dispatches after max_wait alone."""
        import time

        idx, vecs = make_index(n=8, dim=8)
        b = MicroBatcher(max_batch=8, max_wait_ms=5.0, max_inflight=0,
                         linger_ms=5000.0)
        t0 = time.perf_counter()
        r = b.search(idx, vecs[0], 3)
        took = time.perf_counter() - t0
        assert r, "search returned no hits"
        assert took < 2.0, f"ungated search served out the linger: {took}"
