"""The data plane of both packages, over the wire, on the same state.

An IVF_FLAT index (2,000 x 16 clustered rows from a numpy seed, nlist 8)
is built by the JAX package's engine and snapshotted; the port's engine
loads that snapshot (``load_index``) and takes the loaded index's centroids
as its L2 cluster keys (``push_centroids``, as the JAX engine's
``build_index`` did). A ``RespServer`` of each package then serves its
engine on a port of its own, and one scripted session (writes, searches
with and without FILTER / WITH_META / TRACE, an L0, L1 and L2 cache hit,
deletes, stats, a pipelined write burst) is played against both with the
port's ``RespClient``. The replies must be equal: ids, error codes and
messages exactly, scores within ``_torch_parity.RTOL`` / ``ATOL``, and the
TRACE's cache layer by name (its times are not compared).

The second case builds the same rows in each engine and holds the build
parity bound of ``tests/test_torch_build_parity.py``: recall@10 equal, and
at least 99% of the queries' hit sets equal.
"""

import asyncio
import json

import numpy as np
import pytest
from _torch_parity import ATOL, RTOL, port_config

from pyrope_tpu.cache import StaticPolicyEngine as JStaticPolicy
from pyrope_tpu.security import AuthSettings as JAuth
from pyrope_tpu.server.engine import EngineConfig as JEngineConfig
from pyrope_tpu.server.engine import PyropeEngine as JEngine
from pyrope_tpu.server.resp import RespServer as JRespServer
from pyrope_tpu.types import IndexConfig, IndexParams
from pyrope_tpu_torch.cache import LshService, StaticPolicyEngine
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.engine import EngineConfig, PyropeEngine
from pyrope_tpu_torch.server.resp import RespServer, ThreadedServer
from pyrope_tpu_torch.server.resp_client import RespError
from pyrope_tpu_torch.utils.datasets import ground_truth, id_lists_to_rows, recall_at_k
from pyrope_tpu_torch.utils.parsing import encode_vector

N, D, NLIST, K = 2000, 16, 8, 10
T, IX = "t", "ix"


def _corpus(seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, (NLIST, D)).astype(np.float32) * 3
    assign = rng.integers(0, NLIST, N)
    rows = centers[assign] + rng.normal(0.0, 0.05, (N, D)).astype(np.float32)
    queries = centers[rng.integers(0, NLIST, 64)] + rng.normal(
        0.0, 0.05, (64, D)).astype(np.float32)
    return rows.astype(np.float32), queries.astype(np.float32)


def _config():
    return IndexConfig(dim=D, algorithm="IVF_FLAT", params=IndexParams(nlist=NLIST))


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("snapshots"))
    rows, _ = _corpus()
    jeng = JEngine(JEngineConfig(auth=JAuth(enabled=False), snapshot_dir=snap))
    jeng.create_index(T, IX, _config())
    assert jeng.add_batch(T, IX, [str(i) for i in range(N)], rows).ok
    assert jeng.build_index(T, IX)
    assert jeng.snapshot_index(T, IX, "ivf") > 0

    peng = PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False),
                                     snapshot_dir=snap))
    peng.create_index(T, IX, port_config(_config()))
    assert peng.load_index(T, IX, "ivf")
    cents = peng.registry.try_get(T, IX).index.get_centroids()
    np.testing.assert_array_equal(
        cents, np.asarray(jeng.registry.try_get(T, IX).index.get_centroids()))
    assert peng.push_centroids(T, IX, cents)

    jeng.policy = JStaticPolicy(ttl_seconds=60)
    peng.policy = StaticPolicyEngine(ttl_seconds=60)
    pair = (ThreadedServer(JRespServer(jeng, "127.0.0.1", 0), timeout=10),
            ThreadedServer(RespServer(peng, "127.0.0.1", 0), timeout=10))
    yield pair
    for s in pair:
        s.stop(timeout=5)


def _near_pairs(cents):
    """(q1, q2) near one centroid with different SimHashes: the second
    misses L0 and L1 and hits the L2 line the first filled."""
    lsh = LshService()
    rng = np.random.default_rng(5)
    for c in cents:
        q1 = c + rng.normal(0.0, 0.01, D).astype(np.float32)
        for _ in range(50):
            q2 = (c + rng.normal(0.0, 0.02, D)).astype(np.float32)
            if lsh.simhash(q2) != lsh.simhash(q1):
                return q1.astype(np.float32), q2
    raise AssertionError("no pair with distinct SimHashes")


def _script(cents):
    rows, queries = _corpus()
    q0 = queries[0]
    q1, q2 = _near_pairs(cents)
    new = np.full(D, 0.25, np.float32)
    s = [
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(q0)),
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(q0),
         "TRACE", "REQUEST_ID", "r-1"),                        # L0
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR",
         encode_vector(q0 + np.float32(1e-6)), "TRACE"),       # L1
        ("search", "VEC.SEARCH", T, IX, "TOPK", 5, "VECTOR", encode_vector(q1), "TRACE"),
        ("search", "VEC.SEARCH", T, IX, "TOPK", 5, "VECTOR", encode_vector(q2), "TRACE"),  # L2
        ("write", "VEC.ADD", T, IX, "new1", "VECTOR", encode_vector(new),
         "META", '{"lang": "en"}', "TAGS", "x,y"),
        ("write", "VEC.ADD", T, IX, "new1", "VECTOR", encode_vector(new)),
        ("write", "VEC.ADD", T, IX, "new2", "VECTOR", json.dumps([0.24] * D).encode(),
         "TAGS", "x"),
        ("write", "VEC.UPSERT", T, IX, "5", "VECTOR", encode_vector(new + 0.5)),
        ("search", "VEC.SEARCH", T, IX, "TOPK", 3, "VECTOR", encode_vector(new),
         "WITH_META", "TRACE"),
        ("search", "VEC.SEARCH", T, IX, "TOPK", 5, "VECTOR", encode_vector(new),
         "FILTER", "y", "WITH_META"),
        ("search", "VEC.SEARCH", T, IX, "TOPK", 5, "VECTOR", encode_vector(new),
         "FILTER", "x"),
        ("write", "VEC.DEL", T, IX, "5"),
        ("write", "VEC.DEL", T, IX, "5"),
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(new + 0.5)),
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(rows[7])),
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", b"[1,2,3]"),
        ("search", "VEC.SEARCH", T, "nope", "TOPK", K, "VECTOR", encode_vector(q0)),
        ("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(q0),
         "NPROBE", 8, "TRACE"),
    ]
    # queries off the clusters' cores: too far from any centroid for an L2
    # hit, so every one of them is scanned on both sides
    far = rows[:32] + np.random.default_rng(3).normal(0.0, 0.5, (32, D)).astype(np.float32)
    s += [("search", "VEC.SEARCH", T, IX, "TOPK", K, "VECTOR", encode_vector(q))
          for q in far]
    s.append(("stats", "VEC.STATS", T, IX))
    return s


def _pipelined_burst():
    rng = np.random.default_rng(9)
    return [("VEC.UPSERT", T, IX, f"p{i}", "VECTOR",
             encode_vector(rng.normal(0.0, 1.0, D).astype(np.float32)))
            for i in range(32)]


def _play(client, script):
    out = []
    for kind, *args in script:
        try:
            out.append((kind, "ok", client.execute(*args)))
        except RespError as e:
            out.append((kind, "err", str(e)))
    burst = _pipelined_burst()
    for args in burst:
        client.send(*args)
    out += [("write", "ok", client.read_reply()) for _ in burst]
    for kind, *args in [
        ("search", "VEC.SEARCH", T, IX, "TOPK", 3, "VECTOR", burst[11][-1], "TRACE"),
        ("stats", "VEC.STATS", T, IX),
    ]:
        out.append((kind, "ok", client.execute(*args)))
    return out


def _assert_same_hits(a, b, where):
    assert [h[0] for h in a] == [h[0] for h in b], where
    for ha, hb in zip(a, b):
        np.testing.assert_allclose(float(ha[1]), float(hb[1]), rtol=RTOL, atol=ATOL,
                                   err_msg=str(where))
        assert ha[2:] == hb[2:], where  # WITH_META's JSON


def _layers(trace_json):
    tr = json.loads(trace_json)
    return {k: tr[k] for k in ("request_id", "cache_hit", "cache_level",
                               "budget_adjustment")}


def test_one_session_gives_the_same_replies(servers):
    jax_srv, port_srv = servers
    cents = port_srv.server.engine.registry.try_get(T, IX).index.get_centroids()
    script = _script(cents)
    with jax_srv.client() as cj, port_srv.client() as cp:
        got_j, got_p = _play(cj, script), _play(cp, script)
    assert len(got_j) == len(got_p)
    levels = []
    for i, ((kind, sj, rj), (_, sp, rp)) in enumerate(zip(got_j, got_p)):
        where = (i, kind, rj, rp)
        assert sj == sp, where
        if sj == "err" or kind in ("write", "stats"):
            assert rj == rp, where
            continue
        traced = len(rj) == 2 and isinstance(rj[1], str)
        if traced:
            assert len(rp) == 2 and isinstance(rp[1], str), where
            assert _layers(rj[1]) == _layers(rp[1]), where
            levels.append(_layers(rj[1])["cache_level"])
            rj, rp = rj[0], rp[0]
        _assert_same_hits(rj, rp, where)
    # the session reached the device and every host cache layer it names
    assert {"", "L0", "L1", "L2"} <= set(levels), levels
    st_j = dict(zip(got_j[-1][2][::2], got_j[-1][2][1::2]))
    assert st_j["cache_misses"] >= 32 + 6, st_j
    # the written rows were read back, the deleted one is gone
    assert got_p[9][2][0][0][0] == "new1"
    assert "5" not in {h[0] for h in got_p[14][2]}
    assert got_p[-2][2][0][0][0] == "p11"
    stats = dict(zip(got_p[-1][2][::2], got_p[-1][2][1::2]))
    assert stats["count"] == N + 2 + 32 - 1


@pytest.mark.parametrize("seed", [11])
def test_builds_in_each_engine_agree_to_the_bound(seed):
    rows, queries = _corpus(seed)
    ids = [str(i) for i in range(N)]
    jeng = JEngine(JEngineConfig(auth=JAuth(enabled=False), microbatch_max=0))
    peng = PyropeEngine(EngineConfig(device="cpu", auth=AuthSettings(enabled=False),
                                     microbatch_max=0))
    jeng.create_index(T, IX, _config())
    peng.create_index(T, IX, port_config(_config()))
    found = {}
    for name, eng in (("jax", jeng), ("port", peng)):
        assert eng.add_batch(T, IX, ids, rows).ok
        assert eng.build_index(T, IX)
        hits = []
        for q in queries:
            r = eng.search(T, IX, q, K)
            assert r.ok, r.error_message
            hits.append([h.id for h in r.hits])
        found[name] = id_lists_to_rows(hits, K)
    truth = ground_truth(rows, queries, K, "L2")
    rj, rp = (recall_at_k(found[s], truth, K) for s in ("jax", "port"))
    same = sum(set(a) == set(b) for a, b in zip(found["jax"], found["port"]))
    assert rp == rj, (rj, rp)
    assert same >= 0.99 * len(queries), same



@pytest.mark.parametrize("metric", ["L2", "IP", "COSINE"])
def test_cache_keys_are_the_jax_packages(metric):
    """The same query gets the same L0 key, L1 SimHash and L2 cluster in
    both packages, so a cache line means the same thing in each."""
    from pyrope_tpu.cache import LshService as JLsh
    from pyrope_tpu.cache import QueryKey as JKey
    from pyrope_tpu.cache import SemanticClusterRegistry as JClusters
    from pyrope_tpu_torch.cache import QueryKey, SemanticClusterRegistry

    rng = np.random.default_rng(4)
    cents = rng.standard_normal((NLIST, D)).astype(np.float32)
    queries = rng.standard_normal((64, D)).astype(np.float32)
    jl, pl = JLsh(), LshService()
    jc, pc = JClusters(), SemanticClusterRegistry()
    jc.update_centroids(T, IX, cents, metric)
    pc.update_centroids(T, IX, cents, metric)
    np.testing.assert_array_equal(jl.simhash_batch(queries), pl.simhash_batch(queries))
    for i, q in enumerate(queries):
        jk = JKey.create(T, IX, q, 1 + i % 20, metric, tags=("a", "b")[: i % 3])
        pk = QueryKey.create(T, IX, q, 1 + i % 20, metric, tags=("a", "b")[: i % 3])
        assert jk.storage_key() == pk.storage_key()
        assert jk.cache_hash() == pk.cache_hash()
        h = pl.simhash(q)
        assert h == jl.simhash(q)
        assert jk.with_simhash(h).storage_key() == pk.with_simhash(h).storage_key()
        (jcid, jscore), (pcid, pscore) = (jc.find_nearest_cluster(T, IX, q),
                                          pc.find_nearest_cluster(T, IX, q))
        assert jcid == pcid and jscore == pscore
        assert jk.with_cluster(jcid).storage_key() == pk.with_cluster(pcid).storage_key()


@pytest.mark.parametrize("reply", [
    [["v1", "-0.5"], ["v2", "-1.25"]],
    [[["a", "-0", '{"lang": "en"}'], ["b", "-0.0016", None]], '{"cache_hit": true}'],
    ["count", 2033, "dim", 16, "microbatch", "{'batches': 1}"],
    [1.5, -2, b"raw\r\nbytes", None, []],
    None,
])
def test_resp_encoding_is_the_jax_packages(reply):
    """Both servers put the same bytes on the wire for the same reply, and
    read the same command back from it."""
    from pyrope_tpu.server import resp as jresp
    from pyrope_tpu_torch.server import resp as presp

    assert presp.encode_array(reply) == jresp.encode_array(reply)
    for text in ("VEC_OK", "bad\r\nline"):
        assert presp.encode_simple(text) == jresp.encode_simple(text)
        assert presp.encode_error(text) == jresp.encode_error(text)
    args = [b"VEC.SEARCH", b"t", b"ix", b"TOPK", b"5", b"VECTOR", b"\x00\x01\r\n"]
    wire = b"*%d\r\n" % len(args) + b"".join(
        b"$%d\r\n%s\r\n" % (len(a), a) for a in args)

    async def read(mod):
        reader = asyncio.StreamReader()
        reader.feed_data(wire)
        reader.feed_eof()
        return await mod.read_command(reader)

    assert asyncio.run(read(presp)) == asyncio.run(read(jresp)) == args

def test_chip_smoke_serving_recall_is_the_jax_packages():
    """chip_smoke's phase 18 holds the port's recall on serving_bench's
    100k corpus to the JAX package's (SERVING_RECALL_JAX): this is where
    that value comes from. The corpus and the pool are
    ``scripts/serving_bench.py``'s (one generator, seed 42), the index the
    registry's Delta(Flat, IVF_FLAT) at nlist 100, the queries the pool's
    first 2000, the truth exact in float64."""
    import chip_smoke
    from pyrope_tpu import registry as jreg
    from pyrope_tpu.types import SearchOptions

    rng = np.random.default_rng(42)
    base = rng.standard_normal((100_000, 128)).astype(np.float32)
    queries = rng.standard_normal((4096, 128)).astype(np.float32)[:2000]
    ix = jreg.create_index(IndexConfig(dim=128, algorithm="IVF_FLAT",
                                       params=IndexParams(nlist=100, nprobe=3)))
    ix.add_batch([f"v{i}" for i in range(len(base))], base)
    ix.build()
    truth = ground_truth(base, queries, K)
    got = {}
    for nprobe in chip_smoke.SERVING_RECALL_JAX:
        hits = []
        for s in range(0, len(queries), 250):
            hits += ix.search_batch(queries[s:s + 250], K, SearchOptions(nprobe=nprobe))
        rows = id_lists_to_rows([[int(h.id[1:]) for h in r] for r in hits], K)
        got[nprobe] = recall_at_k(rows, truth, K)
    assert got == chip_smoke.SERVING_RECALL_JAX
