"""The port's twin of ``tests/test_write_coalescer.py``, case for case: the same cases
against ``pyrope_tpu_torch`` on the CPU (``device="cpu"``).

AsyncWriteCoalescer auth-isolation and failure-path regression tests
(session identity must be part of the group key; every leader
exit must resolve follower futures; cancellation must propagate)."""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest

from pyrope_tpu_torch.security import AuthSettings, SessionAuthContext
from pyrope_tpu_torch.server.batcher import AsyncWriteCoalescer, BatchError
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.service import VectorRecord


def _req(tenant="t1", index="ix", id="a", dim=4, api_key=None):
    return SimpleNamespace(
        tenant=tenant, index=index, id=id,
        vector=np.ones(dim, np.float32), meta=None, tags=(),
        numeric_fields=None, api_key=api_key,
    )


def test_session_identity_isolates_groups():
    """A session-AUTH'd connection's api_key=None write must never share a
    group (and thus the leader's auth result) with an unauthenticated
    connection's write for the same (tenant, index, api_key)."""
    engine = PyropeEngine(
        EngineConfig(device="cpu", auth=AuthSettings(enabled=True, admin_api_key="adm"))
    )
    engine.tenants.create("t1", api_key="sek")
    # the index must exist: anonymous writes should fail auth, not create
    engine.write_batch(
        "t1", "ix", [VectorRecord(id="seed", vector=np.ones(4, np.float32))],
        [True], api_key="sek",
    )

    async def run(authed_first: bool):
        co = AsyncWriteCoalescer(engine)

        async def authed():
            SessionAuthContext.set_tenant("t1")  # per-task contextvar
            return await co.submit(_req(id="s"), True)

        async def anon():
            SessionAuthContext.clear()
            return await co.submit(_req(id="n"), True)

        coros = [authed(), anon()] if authed_first else [anon(), authed()]
        tasks = [asyncio.create_task(c) for c in coros]
        res = await asyncio.gather(*tasks)
        return res if authed_first else res[::-1]

    for authed_first in (True, False):
        auth_res, anon_res = asyncio.run(run(authed_first))
        assert auth_res.ok, f"session-auth'd write rejected (leader order {authed_first})"
        assert not anon_res.ok and anon_res.error_code == "VEC_ERR_AUTH", (
            f"unauthenticated write accepted under coalescing (order {authed_first})"
        )


def test_engine_failure_resolves_all_span_futures():
    class Boom:
        def write_batch(self, *a, **k):
            raise RuntimeError("boom")

    async def run():
        co = AsyncWriteCoalescer(Boom())
        t1 = asyncio.create_task(co.submit(_req(id="x"), True))
        t2 = asyncio.create_task(co.submit(_req(id="y"), True))
        return await asyncio.gather(t1, t2, return_exceptions=True)

    r1, r2 = asyncio.run(asyncio.wait_for(run(), timeout=10))
    assert isinstance(r1, BatchError) and isinstance(r2, BatchError)


def test_record_build_failure_fails_futures_not_hangs():
    """VectorRecord construction sits before the engine call; a failure
    there used to leave every span future unresolved (writes hung)."""
    class Eng:
        def write_batch(self, *a, **k):  # pragma: no cover - never reached
            return []

    async def run():
        co = AsyncWriteCoalescer(Eng())
        bad = _req(id="b")
        bad.tags = None  # tuple(None) raises TypeError during record build
        with pytest.raises(BatchError):
            await asyncio.wait_for(co.submit(bad, True), timeout=5)

    asyncio.run(run())


def test_leader_cancel_fails_followers_and_propagates():
    """Cancelling a leader blocked on the gate must fail its followers'
    futures (no hang) and re-raise CancelledError (not BatchError)."""
    class Eng:
        def write_batch(self, tenant, index, records, upserts, api_key=None):
            return [SimpleNamespace(ok=True)] * len(records)

    async def run():
        co = AsyncWriteCoalescer(Eng())
        await co._gate.acquire()  # wedge the gate so the leader blocks
        leader = asyncio.create_task(co.submit(_req(id="l"), True))
        await asyncio.sleep(0)  # leader now awaits the gate
        follower = asyncio.create_task(co.submit(_req(id="f"), True))
        await asyncio.sleep(0)  # follower joined the open group
        leader.cancel()
        with pytest.raises(asyncio.CancelledError):
            await leader
        with pytest.raises(BatchError):
            await asyncio.wait_for(follower, timeout=5)
        co._gate.release()
        # the coalescer must still work after the failed group
        ok = await asyncio.wait_for(co.submit(_req(id="z"), True), timeout=5)
        assert ok.ok

    asyncio.run(asyncio.wait_for(run(), timeout=20))
