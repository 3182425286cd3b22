"""The control plane and the sidecar of both packages, on the same state.

- **HTTP.** An IVF_FLAT index (2,000 x 16 clustered rows from a numpy seed,
  nlist 8) is built by the JAX package's engine and snapshotted. Each
  package's ``PyropeApp`` (auth on, an admin key, HTTP and RESP on port 0)
  gets a fresh copy of that snapshot dir at one path, and one scripted HTTP session (tenants,
  users and roles, quotas, index create / load / stats / build / centroids
  / snapshot / drop, cache policies / aliases / flush / invalidate, billing,
  audit, health, metrics, the AI proxy without a sidecar) is played against
  both. Status codes and JSON bodies must be equal once ``_normalize`` has
  replaced what is random or timed by design, and only that:
  ``NORMALIZED_KEYS`` (generated API keys, audit timestamps) and the
  Prometheus lines in ``TIMED_METRICS`` (latency bucket counts and sums).
- **gRPC.** The JAX package's ``PolicyServiceClient`` against the port's
  sidecar, and the port's client against the JAX package's sidecar: every
  RPC of the service gives the same reply across the two wires (model
  versions, named by the clock, normalized).
- **ONNX.** ``onnx_emit.gbdt_to_onnx`` of one fitted sklearn model writes
  equal bytes in both packages.
- **Centroids.** Both packages' ``SemanticModelTrainer.train`` on one
  seed-made 20,000 x 32 set at k 64: the same k-means++ rows, and at least
  99% of the vectors assigned to the same centroid index (the build-parity
  bound style: Lloyd's sums run in another order).
- **The entry point.** ``python -m pyrope_tpu_torch.server --device cpu``
  answers ``/v1/health`` and exits 0 on SIGINT; ``--device cuda`` on a host
  without a GPU exits non-zero with the device error before binding a port.
"""

import asyncio
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pyrope_tpu.ops import kmeans as jkmeans
from pyrope_tpu.security import AuthSettings as JAuth
from pyrope_tpu.server.app import PyropeApp as JApp
from pyrope_tpu.server.engine import EngineConfig as JEngineConfig
from pyrope_tpu.server.engine import PyropeEngine as JEngine
from pyrope_tpu.sidecar import onnx_emit as jonnx
from pyrope_tpu.sidecar import policy_service_pb2 as jpb
from pyrope_tpu.sidecar.client import PolicyServiceClient as JClient
from pyrope_tpu.sidecar.semantic_model import SemanticModelTrainer as JTrainer
from pyrope_tpu.sidecar.server import serve as jserve
from pyrope_tpu.types import IndexConfig, IndexParams
from pyrope_tpu_torch.ops import kmeans as tkmeans
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.app import PyropeApp
from pyrope_tpu_torch.server.engine import EngineConfig
from pyrope_tpu_torch.sidecar import onnx_emit
from pyrope_tpu_torch.sidecar import policy_service_pb2 as pb
from pyrope_tpu_torch.sidecar.client import PolicyServiceClient
from pyrope_tpu_torch.sidecar.semantic_model import SemanticModelTrainer
from pyrope_tpu_torch.sidecar.server import serve

REPO = pathlib.Path(__file__).resolve().parent.parent
N, D, NLIST = 2000, 16, 8
T, IX = "t", "ix"
ADMIN_KEY = "admin-key"

# what differs between two runs of one package by design, and nothing else
NORMALIZED_KEYS = ("api_key", "timestamp")
TIMED_METRICS = ("pyrope_search_latency_ms_bucket", "pyrope_search_latency_ms_sum")


def _corpus(seed=11):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 1.0, (NLIST, D)).astype(np.float32) * 3
    rows = centers[rng.integers(0, NLIST, N)] + rng.normal(0.0, 0.05, (N, D))
    queries = centers[rng.integers(0, NLIST, 8)] + rng.normal(0.0, 0.05, (8, D))
    return rows.astype(np.float32), queries.astype(np.float32)


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """A snapshot dir holding the JAX engine's built IVF_FLAT index ``ivf``
    under tenant ``t``, and that index's centroids."""
    snap = tmp_path_factory.mktemp("jax_snapshot")
    rows, _ = _corpus()
    eng = JEngine(JEngineConfig(auth=JAuth(enabled=False), snapshot_dir=str(snap)))
    eng.create_index(T, IX, IndexConfig(dim=D, algorithm="IVF_FLAT",
                                        params=IndexParams(nlist=NLIST)))
    assert eng.add_batch(T, IX, [f"v{i}" for i in range(N)], rows).ok
    assert eng.build_index(T, IX)
    assert eng.snapshot_index(T, IX, "ivf") > 0
    return snap, np.asarray(eng.registry.try_get(T, IX).index.get_centroids())


class _Running:
    """A PyropeApp started on a loop of its own thread; ``url`` is its HTTP
    address (the port the OS gave to port 0)."""

    def __init__(self, app):
        self.app = app
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(app.start())
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30), "the app did not start"
        host, port = app._http_runner.addresses[0][:2]
        self.url = f"http://{host}:{port}"

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(10)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _http(url, method, path, key=None, body=None):
    """(status, JSON body or text) of one request."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    if key is not None:
        req.add_header("X-API-KEY", key)
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw, ctype = r.status, r.read(), r.headers.get_content_type()
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get_content_type()
    return status, json.loads(raw) if ctype == "application/json" else raw.decode()


def _normalize(value):
    """``value`` with the fields random or timed by design replaced: keys of
    NORMALIZED_KEYS (each must hold a non-empty value) and TIMED_METRICS
    lines of the Prometheus text."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k in NORMALIZED_KEYS:
                assert v, (k, v)
                out[k] = "<normalized>"
            else:
                out[k] = _normalize(v)
        return out
    if isinstance(value, list):
        return [_normalize(v) for v in value]
    if isinstance(value, str) and value.startswith("# TYPE"):
        return "\n".join(ln.rsplit(" ", 1)[0] + " <timed>" if ln.startswith(TIMED_METRICS)
                         else ln for ln in value.splitlines())
    return value


def _session(running, engine, cents, queries):
    """The scripted session against one app: a list of (step, status,
    body). Steps that read a key the app generated use that app's key."""
    url, out = running.url, []
    admin, tkey = ADMIN_KEY, "tenant-key"

    def call(step, method, path, key=None, body=None):
        status, got = _http(url, method, path, key, body)
        out.append((step, status, got))
        return got

    call("health", "GET", "/v1/health")
    call("metrics without a key", "GET", "/v1/metrics")
    call("create index without a key", "POST", "/v1/indexes",
         body={"tenant": T, "index": IX, "dim": D})
    call("create tenant", "POST", "/v1/tenants", admin,
         {"tenant": T, "api_key": tkey, "quotas": {"max_qps": 500, "priority": 1}})
    call("create tenant again", "POST", "/v1/tenants", admin, {"tenant": T})
    call("create tenant, bad name", "POST", "/v1/tenants", admin, {"tenant": "a b"})
    other = call("create tenant, generated key", "POST", "/v1/tenants", admin,
                 {"tenant": "u"})["api_key"]
    call("create tenant as a tenant", "POST", "/v1/tenants", tkey, {"tenant": "w"})
    call("quotas", "GET", f"/v1/tenants/{T}/quotas", tkey)
    call("quotas of another tenant", "GET", f"/v1/tenants/{T}/quotas", other)
    call("put quotas", "PUT", f"/v1/tenants/{T}/quotas", tkey,
         {"max_qps": 250, "priority": 0, "cache_quota_mb": 64})
    call("quotas of a missing tenant", "GET", "/v1/tenants/nope/quotas", admin)
    call("create user", "POST", f"/v1/tenants/{T}/users", tkey,
         {"user": "alice", "role": "READER", "api_key": "alice-key"})
    bob = call("create user, generated key", "POST", f"/v1/tenants/{T}/users", tkey,
               {"user": "bob", "role": "OPERATOR"})["api_key"]
    call("create user, bad role", "POST", f"/v1/tenants/{T}/users", tkey,
         {"user": "carol", "role": "EMPEROR"})
    call("reader manages users", "POST", f"/v1/tenants/{T}/users", "alice-key",
         {"user": "dave"})
    call("reader reads quotas", "GET", f"/v1/tenants/{T}/quotas", "alice-key")
    call("role update", "PUT", f"/v1/tenants/{T}/users/alice/role", tkey,
         {"role": "OPERATOR"})
    call("role update of a missing user", "PUT", f"/v1/tenants/{T}/users/zed/role",
         tkey, {"role": "READER"})
    call("users", "GET", f"/v1/tenants/{T}/users", tkey)
    call("operator reads quotas", "GET", f"/v1/tenants/{T}/quotas", bob)
    call("delete user", "DELETE", f"/v1/tenants/{T}/users/bob", tkey)
    call("delete user again", "DELETE", f"/v1/tenants/{T}/users/bob", tkey)

    call("create index", "POST", "/v1/indexes", admin,
         {"tenant": T, "index": IX, "dim": D, "algorithm": "IVF_FLAT",
          "params": {"nlist": NLIST}})
    call("create index again", "POST", "/v1/indexes", admin,
         {"tenant": T, "index": IX, "dim": D})
    call("create index, bad config", "POST", "/v1/indexes", admin,
         {"tenant": T, "index": "bad", "dim": D, "metric": "HAMMING"})
    call("stats before load", "GET", f"/v1/indexes/{T}/{IX}/stats", tkey)
    call("load the JAX snapshot", "POST", f"/v1/indexes/{T}/{IX}/load", tkey,
         {"path": "ivf"})
    call("load a missing snapshot", "POST", f"/v1/indexes/{T}/{IX}/load", tkey,
         {"path": "nope"})
    call("load without a path", "POST", f"/v1/indexes/{T}/{IX}/load", tkey, {})
    call("centroids", "POST", f"/v1/indexes/{T}/{IX}/centroids", tkey,
         {"centroids": cents.tolist()})
    call("centroids, not 2-D", "POST", f"/v1/indexes/{T}/{IX}/centroids", tkey,
         {"centroids": [1.0, 2.0]})
    call("centroids of a missing index", "POST", f"/v1/indexes/{T}/nope/centroids",
         tkey, {"centroids": [[0.0] * D]})
    call("stats after load", "GET", f"/v1/indexes/{T}/{IX}/stats", "alice-key")
    # searches through the engine: cache entries, billing, metrics
    for q in (queries[0], queries[1], queries[0]):
        r = engine.search(T, IX, q, 5, api_key=tkey)
        out.append(("search", r.ok, [(h.id, round(h.score, 3)) for h in r.hits]))
    call("snapshot escaping its dir", "POST", f"/v1/indexes/{T}/{IX}/snapshot", tkey,
         {"path": "../../evil"})
    # before the build: both hold the JAX build's arrays, so equal bytes
    call("snapshot", "POST", f"/v1/indexes/{T}/{IX}/snapshot", tkey, {"path": "again"})
    call("build", "POST", f"/v1/indexes/{T}/{IX}/build", tkey)
    call("build a missing index", "POST", f"/v1/indexes/{T}/nope/build", tkey)
    call("stats after build", "GET", f"/v1/indexes/{T}/{IX}/stats", tkey)

    call("cache policies", "GET", "/v1/cache/policies", admin)
    call("cache policies as a tenant", "GET", "/v1/cache/policies", tkey)
    call("put cache policies", "PUT", "/v1/cache/policies", admin,
         {"enable_cache": True, "default_ttl_seconds": 120})
    call("alias", "POST", "/v1/cache/aliases", tkey,
         {"tenant": T, "alias_hash": "aaa", "canonical_hash": "bbb", "confidence": 0.9})
    call("alias without hashes", "POST", "/v1/cache/aliases", admin, {"tenant": T})
    for q in (queries[2], queries[2]):
        r = engine.search(T, IX, q, 5, api_key=tkey)
        out.append(("search", r.ok, [(h.id, round(h.score, 3)) for h in r.hits]))
    call("invalidate", "POST", "/v1/cache/invalidate", tkey, {"tenant": T, "index": IX})
    call("invalidate without a tenant", "POST", "/v1/cache/invalidate", admin, {})
    engine.search(T, IX, queries[3], 5, api_key=tkey)
    call("flush", "POST", "/v1/cache/flush", admin)

    call("rotate key", "PUT", f"/v1/tenants/{T}/apikey", tkey, {"api_key": "tenant-key-2"})
    call("old key", "GET", f"/v1/tenants/{T}/quotas", tkey)
    tkey = "tenant-key-2"
    generated = call("rotate key, generated", "PUT", f"/v1/tenants/{T}/apikey", tkey,
                     {})["api_key"]
    call("generated key reads quotas", "GET", f"/v1/tenants/{T}/quotas", generated)
    tkey = generated

    call("billing of the tenant", "GET", f"/v1/billing/usage?tenantId={T}", tkey)
    call("billing of all as a tenant", "GET", "/v1/billing/usage", tkey)
    call("billing of all", "GET", "/v1/billing/usage", admin)
    call("audit of the tenant", "GET", f"/v1/audit/logs?tenantId={T}&limit=500", tkey)
    call("audit, one action", "GET", "/v1/audit/logs?action=index.load", admin)
    call("audit, bad limit", "GET", "/v1/audit/logs?limit=many", admin)
    call("audit stats", "GET", "/v1/audit/stats", admin)
    call("ai models without a sidecar", "GET", "/v1/ai/models", admin)
    call("metrics", "GET", "/v1/metrics", tkey)
    call("drop index", "DELETE", f"/v1/indexes/{T}/{IX}", admin)
    call("drop index again", "DELETE", f"/v1/indexes/{T}/{IX}", admin)
    call("stats after drop", "GET", f"/v1/indexes/{T}/{IX}/stats", admin)
    return out


def test_http_session_gives_equal_replies(jax_snapshot, tmp_path):
    snap, cents = jax_snapshot
    _, queries = _corpus()
    replies = []
    for name, make in (
        ("jax", lambda d: JApp(JEngineConfig(auth=JAuth(admin_api_key=ADMIN_KEY),
                                             snapshot_dir=d), resp_port=0, http_port=0)),
        ("port", lambda d: PyropeApp(EngineConfig(device="cpu",
                                                  auth=AuthSettings(admin_api_key=ADMIN_KEY),
                                                  snapshot_dir=d),
                                     resp_port=0, http_port=0)),
    ):
        d = tmp_path / "snapshots"   # one path for both: replies name it
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(snap, d)
        running = _Running(make(str(d)))
        try:
            replies.append(_session(running, running.app.engine, cents, queries))
        finally:
            running.stop()
    jax_replies, port_replies = replies
    assert [r[0] for r in port_replies] == [r[0] for r in jax_replies]
    for (step, *want), (_, *got) in zip(jax_replies, port_replies):
        assert _normalize(got) == _normalize(want), step
    # the session reached what it was written for
    got = dict((step, (status, body)) for step, status, body in port_replies)
    assert got["load the JAX snapshot"][1]["stats"]["count"] == N
    assert got["invalidate"][1]["removed"] >= 1
    assert got["flush"][1]["removed"] >= 1
    assert got["ai models without a sidecar"][0] == 503


# ---- gRPC: each package's client against the other package's sidecar ------

REPORTS = 12

def _rpc_script(client, svc, pbm):
    """Every RPC of the PolicyService once or more, in one order; the
    replies as plain values."""
    out = []
    # hot and cool reports in turn: rewards from the second report on, and a
    # decision log of two label classes that training takes (>= 10 lines)
    for i in range(REPORTS):
        hot = i % 2 == 0
        out.append(("ReportSystemMetrics", client.report_system_metrics(
            "t1", 10.0 + i, 0.6 if hot else 0.05, 80.0 if hot else 5.0,
            0.9 if hot else 0.1, timeout=10.0)))
    events = [{"tenant_id": "t", "index_name": "i", "cluster_id": c, "timestamp": float(s)}
              for s, c in enumerate([1, 2] * 4 + [3, 4] * 3)]
    client.report_cluster_access(events)
    out.append(("ReportClusterAccess", svc.prediction.get_rules()))
    out.append(("GetPrefetchRules", client.get_prefetch_rules()))
    policy = client._stub("GetIndexPolicy", pbm.IndexPolicyRequest,
                          pbm.IndexPolicyResponse)(
        pbm.IndexPolicyRequest(tenant_id="t", index_name="i"), timeout=10.0)
    out.append(("GetIndexPolicy", (policy.recommended_nprobe,
                                   policy.recommended_ef_search)))
    out.append(("GetModelStatus", client.get_model_status()))
    out.append(("TriggerTraining", client.trigger_training()))
    svc.models._train_thread.join(timeout=60)
    assert not svc.models._train_thread.is_alive()
    status = client.get_model_status()
    out.append(("GetModelStatus", {**status, "staged": len(status["staged"])}))
    (version,) = status["staged"]
    evals = client.get_evaluations()
    assert [e["version"] for e in evals] == [version]
    out.append(("GetEvaluations", [{**e, "version": "<clock>"} for e in evals]))
    out.append(("DeployModel", {**client.deploy_model(version, ["t1"]), "version": "<clock>"}))
    out.append(("DeployModel", client.deploy_model("nope", [])))
    out.append(("RollbackModel", client.rollback_model()))
    status = client.get_model_status()
    out.append(("GetModelStatus", {**status, "canary": status["canary"] and "<clock>",
                                   "staged": len(status["staged"])}))
    return out


def test_grpc_replies_equal_across_the_two_wires(tmp_path, monkeypatch):
    monkeypatch.delenv("GEMINI_API_KEY", raising=False)   # the LLM engine off
    assert jpb.SystemMetricsRequest.DESCRIPTOR.full_name == \
        pb.SystemMetricsRequest.DESCRIPTOR.full_name == "pyrope.sidecar.SystemMetricsRequest"
    replies = []
    for served, client_cls, pbm, name in ((serve, JClient, jpb, "port_sidecar"),
                                          (jserve, PolicyServiceClient, pb, "jax_sidecar")):
        server, port, svc = served(port=0, data_dir=str(tmp_path / name))
        client = client_cls(f"127.0.0.1:{port}")
        try:
            replies.append(_rpc_script(client, svc, pbm))
            decisions = (tmp_path / name / "decisions.jsonl").read_text().splitlines()
            assert len(decisions) == REPORTS
        finally:
            client.close()
            server.stop(0)
    jax_client_on_port, port_client_on_jax = replies
    assert [r[0] for r in jax_client_on_port] == [r[0] for r in port_client_on_jax]
    for (rpc, a), (_, b) in zip(jax_client_on_port, port_client_on_jax):
        assert a == b, rpc
    names = {r[0] for r in port_client_on_jax}
    assert names == {"ReportSystemMetrics", "ReportClusterAccess", "GetPrefetchRules",
                     "GetIndexPolicy", "GetModelStatus", "TriggerTraining",
                     "GetEvaluations", "DeployModel", "RollbackModel"}


def test_onnx_bytes_equal_in_both_packages():
    from sklearn.ensemble import GradientBoostingClassifier

    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 4))
    y = (x[:, 0] - x[:, 2] > 0.1).astype(int)
    model = GradientBoostingClassifier(random_state=3, n_estimators=12).fit(x, y)
    blob = onnx_emit.gbdt_to_onnx(model, 4)
    assert blob == jonnx.gbdt_to_onnx(model, 4)
    assert onnx_emit.check_model(blob)["op_type"] == "TreeEnsembleClassifier"


# ---- the semantic trainer ------------------------------------------------

# measured on this test's set: 20,000 of 20,000 vectors assigned alike
SEMANTIC_SAME_ASSIGNMENT = 0.99


def test_semantic_trainers_pick_the_same_rows_and_agree():
    rng = np.random.default_rng(21)
    centers = rng.normal(0.0, 1.0, (64, 32)) * 2
    x = (centers[rng.integers(0, 64, 20_000)]
         + rng.normal(0.0, 0.3, (20_000, 32))).astype(np.float32)
    # the k-means++ rows, from the trainers' seed
    x_dev, valid = jkmeans._upload_padded(x, 65536)
    want = np.asarray(jkmeans._kpp_init(x_dev, valid, 42, k=64))
    np.testing.assert_array_equal(tkmeans._kpp_init(torch.from_numpy(x), 64, 42).numpy(),
                                  want)

    got = SemanticModelTrainer("http://unused", k=64, device="cpu").train(x)
    ref = np.asarray(JTrainer("http://unused", k=64).train(x))
    assert got.shape == ref.shape == (64, 32)

    def assign(c):
        return ((x[:, None, :] - c[None]) ** 2).sum(-1).argmin(1)

    same = float((assign(got) == assign(ref)).mean())
    print(f"same centroid index: {same}")
    assert same >= SEMANTIC_SAME_ASSIGNMENT


# ---- python -m pyrope_tpu_torch.server ----------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _server_env(tmp_path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYROPE_")}
    env.update(PYTHONPATH=str(REPO), PYROPE_SNAPSHOT_DIR=str(tmp_path / "snapshots"))
    return env


def test_module_entry_point_serves_on_the_cpu_and_refuses_cuda(tmp_path):
    resp, http = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyrope_tpu_torch.server", "--device", "cpu",
         "--resp-port", str(resp), "--http-port", str(http)],
        cwd=tmp_path, env=_server_env(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "serving RESP" in line and "device cpu" in line, (line, proc.stderr.read())
        assert _http(f"http://127.0.0.1:{http}", "GET", "/v1/health") == \
            (200, {"status": "ok"})
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    if torch.cuda.is_available():
        return   # the refusal below is what a host without a GPU does
    out = subprocess.run(
        [sys.executable, "-m", "pyrope_tpu_torch.server", "--device", "cuda",
         "--resp-port", str(resp), "--http-port", str(http)],
        cwd=tmp_path, env=_server_env(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert "serving" not in out.stdout
