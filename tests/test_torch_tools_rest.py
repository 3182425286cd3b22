"""The last twins of the JAX package's tools, on the CPU at tiny sizes.

- ``scripts/make_policy_artifact.py``: its output is the committed
  artifact of both packages, byte for byte, and the JAX generator's
  functions (never its ``main``, which writes into the JAX package) give
  the same bytes from the same log;
- ``scripts/serving_bench.py``'s pipelined thread and process writers and
  its micro-batcher flags: the cells' keys are the JAX script's (read from
  its source), every write acknowledged, an error fails the cell;
- the AI model lifecycle (``scripts/ai_lifecycle.py`` and
  ``test_ai_lifecycle.sh``) against the port's own sidecar and app;
- the demo notebook's code cells: their top hits are the JAX notebook's,
  both run the same way on the CPU;
- the shell twins parse (``bash -n``), and check_quality's import step runs.
"""

import ast
import asyncio
import importlib.util
import io
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_parity import jax_native_build_dir  # noqa: F401 (an autouse fixture)

import chip_smoke
from pyrope_tpu_torch.scripts import ai_lifecycle, make_policy_artifact, serving_bench
from pyrope_tpu_torch.scripts.load_test import start_app
from pyrope_tpu_torch.security import AuthSettings
from pyrope_tpu_torch.server.app import PyropeApp
from pyrope_tpu_torch.server.engine import EngineConfig
from pyrope_tpu_torch.sidecar.server import serve
from pyrope_tpu_torch.types import IndexConfig, IndexParams

REPO = Path(__file__).resolve().parent.parent
JAX_ARTIFACT = REPO / "pyrope_tpu" / "sidecar" / "policy_model.onnx"
PORT_ARTIFACT = REPO / "pyrope_tpu_torch" / "sidecar" / "policy_model.onnx"
SHELL_TWINS = sorted((REPO / "pyrope_tpu_torch" / "scripts").glob("*.sh"))
ADMIN_KEY = "lifecycle-admin-key"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module, as in
    test_torch_scripts.py (the tier-1 run's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _subprocess_env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return env


# ---- the policy artifact ---------------------------------------------------


def test_artifact_twin_writes_the_committed_bytes(tmp_path):
    out = subprocess.run([sys.executable, "-m", "pyrope_tpu_torch.scripts.make_policy_artifact",
                          "--out", str(tmp_path)], env=_subprocess_env(), cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    blob = (tmp_path / "policy_model.onnx").read_bytes()
    assert f"({len(blob)} bytes)" in out.stdout
    assert blob == JAX_ARTIFACT.read_bytes() == PORT_ARTIFACT.read_bytes()


def test_artifact_twin_is_the_jax_generator(tmp_path):
    """The JAX generator's log and training, called into a directory of
    the test's: the same log and the same bytes as the twin's."""
    jscript = _jax_script("make_policy_artifact")
    jlog, log = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jscript.synth_log(jlog)
    make_policy_artifact.synth_log(log)
    assert jlog.read_bytes() == log.read_bytes()
    assert len(log.read_text().splitlines()) == 400
    jdir = tmp_path / "jax"
    version = jscript.train_model.train(jlog, jdir, version="policy_model")
    dst = make_policy_artifact.make_artifact(tmp_path / "twin.onnx")
    assert dst == tmp_path / "twin.onnx"
    assert dst.read_bytes() == (jdir / f"{version}.onnx").read_bytes()


def test_artifact_twin_refuses_without_sklearn(tmp_path, monkeypatch, capsys):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "sklearn" else real(name, *a))
    assert make_policy_artifact.main(["--out", str(tmp_path)]) == 1
    assert "scikit-learn is not installed" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []


# ---- serving_bench's writers and micro-batcher flags -------------------------


def _jax_cell_keys() -> dict:
    """The keys of the JAX script's cells, read from its source: the
    upsert cell of thread and of process writers, the search cell's (the
    JAX load_test's run_cell and what serving_bench adds) and its
    micro-batch counts'."""
    tree = ast.parse((REPO / "scripts" / "serving_bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_upsert_cell")
    upserts = [{k.value for k in r.value.keys} for r in ast.walk(fn)
               if isinstance(r, ast.Return) and isinstance(r.value, ast.Dict)]
    procs = next(k for k in upserts if "writer_procs" in k)
    threads = next(k for k in upserts if "writer_procs" not in k)
    load = ast.parse((REPO / "scripts" / "load_test.py").read_text())
    run_cell = next(n for n in load.body if isinstance(n, ast.FunctionDef)
                    and n.name == "run_cell")
    search = {k.value for r in ast.walk(run_cell) if isinstance(r, ast.Return)
              for k in r.value.keys}
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    microbatch = {k.value for d in ast.walk(main) if isinstance(d, ast.Dict)
                  for k in d.keys if isinstance(k, ast.Constant)} & {
        "batches", "queries", "max_batch_seen_cum"}
    return {"threads": threads | {"coalescer"}, "procs": procs | {"coalescer"},
            "search": search | {"cell", "nprobe", "microbatch"},
            "microbatch": microbatch | {"avg_batch"}}


SMALL = ["--device", "cpu", "--n", "2000", "--dim", "16", "--writers", "2", "--pipeline", "4"]


def test_serving_bench_pipelined_threads_and_batcher_flags(capsys, tmp_path, monkeypatch):
    made = []
    real = serving_bench.MicroBatcher

    def recording(*args, **kw):
        made.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(serving_bench, "MicroBatcher", recording)
    rc = serving_bench.main([*SMALL, "--cells", "upsert", "search", "--nprobe", "3",
                             "--concurrency", "8", "--duration", "0.3", "--pool", "64",
                             "--max-batch", "16", "--linger-ms", "0.2", "--inflight", "3",
                             "--out", str(tmp_path)])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert made == [((16, 0.5), {"max_inflight": 3, "linger_ms": 0.2})]
    assert out["microbatcher"] == {"max_batch": 16, "max_wait_ms": 0.5, "max_inflight": 3,
                                   "linger_ms": 0.2}
    keys = _jax_cell_keys()
    upsert, search = out["cells"]
    assert set(upsert) == keys["threads"]
    assert (upsert["writers"], upsert["pipeline"], upsert["errors"]) == (2, 4, 0)
    assert upsert["requests"] == upsert["n"] == 2000 and upsert["vec_per_s"] > 0
    assert keys["search"] <= set(search) and set(search) - keys["search"] == {"route_b1"}
    assert set(search["microbatch"]) == keys["microbatch"]
    assert search["errors"] == 0 and search["requests"] > 0
    assert 0 < search["microbatch"]["max_batch_seen_cum"] <= 16


def test_serving_bench_pipelined_process_writers(capsys):
    rc = serving_bench.main([*SMALL, "--cells", "upsert", "--writer-procs"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    (upsert,) = out["cells"]
    assert set(upsert) == _jax_cell_keys()["procs"]
    assert upsert["writer_procs"] is True and upsert["pipeline"] == 4
    assert upsert["requests"] == upsert["n"] == 2000 and upsert["errors"] == 0
    assert upsert["coalescer"]["writes"] > 0


def test_serving_bench_defaults_are_the_jax_scripts():
    args = serving_bench.parse_args([])
    assert (args.pipeline, args.writer_procs, args.inflight, args.linger_ms,
            args.max_batch, args.writers) == (1, False, None, None, None, 4)
    jax_src = (REPO / "scripts" / "serving_bench.py").read_text()
    for flag, default in (("--pipeline", "default=1"), ("--inflight", "default=None"),
                          ("--linger-ms", "default=None"), ("--max-batch", "default=None")):
        line = jax_src[jax_src.index(f'"{flag}"'):].split("\n")[0]
        assert default in line, (flag, line)


@pytest.mark.parametrize("procs", [False, True], ids=["threads", "procs"])
def test_a_refused_write_fails_the_upsert_cell(procs):
    """Rows of the wrong width: every write refused, counted as errors."""
    running = start_app("cpu")
    try:
        running.app.engine.create_index("lt", "narrow", IndexConfig(
            dim=8, algorithm="IVF_FLAT", params=IndexParams.from_dict({"nlist": 4})))
        base = np.random.default_rng(0).random((40, 16), dtype=np.float32)
        cell = serving_bench.run_upsert_cell(running.port, "narrow", base, 2, 4, procs)
    finally:
        running.close()
    assert cell["errors"] > 0 and cell["error_sample"]


# ---- the AI model lifecycle ------------------------------------------------


class _Stack:
    """The port's sidecar and app on the CPU, as test_torch_app.py and
    test_torch_control_plane_parity.py start them (the sidecar's server on
    port 0, the app's loop on a thread of its own, auth on with an admin
    key); ``seeded``: the sidecar's decision log holds make_policy_artifact's
    synthetic log (else a fresh stack's empty one)."""

    def __init__(self, data_dir: Path, seeded: bool):
        data_dir.mkdir(parents=True, exist_ok=True)
        if seeded:
            make_policy_artifact.synth_log(data_dir / "decisions.jsonl")
        self.server, port, self.svc = serve(port=0, data_dir=str(data_dir))
        self.app = PyropeApp(
            EngineConfig(device="cpu", auth=AuthSettings(admin_api_key=ADMIN_KEY),
                         snapshot_dir=str(data_dir / "snapshots")),
            resp_port=0, http_port=0, sidecar_endpoint=f"127.0.0.1:{port}")
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        try:
            asyncio.run_coroutine_threadsafe(self.app.start(), self.loop).result(60)
        except BaseException:
            self._stop_loop()
            raise
        host, http = self.app._http_runner.addresses[0][:2]
        self.url = f"http://{host}:{http}"

    def _stop_loop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.server.stop(0)
        assert not self.thread.is_alive()

    def close(self):
        try:
            asyncio.run_coroutine_threadsafe(self.app.stop(), self.loop).result(30)
        finally:
            self._stop_loop()


def test_lifecycle_trains_deploys_a_canary_and_rolls_back(tmp_path):
    stack = _Stack(tmp_path / "sidecar", seeded=True)
    try:
        shell = subprocess.run(
            ["bash", str(REPO / "pyrope_tpu_torch" / "scripts" / "test_ai_lifecycle.sh"),
             "--host", stack.url, "--wait", "120"],
            env={**_subprocess_env(), "ADMIN_KEY": ADMIN_KEY}, capture_output=True,
            text=True, timeout=300)
        assert shell.returncode == 0, shell.stderr
        lines = shell.stdout.strip().splitlines()
        assert lines[-1] == "AI LIFECYCLE OK"
        titles = [line for line in lines if line.startswith("== ")]
        assert [t.split()[1] for t in titles] == [
            "model", "trigger", "staged", "canary", "evaluations", "rollback"]
        staged = json.loads(lines[lines.index("== staged versions ==") + 1])["staged"]
        assert staged and titles[3] == f"== canary deploy {staged[-1]} =="
        deploy = json.loads(lines[lines.index(titles[3]) + 1])
        assert deploy == {"status": "deployed", "version": staged[-1], "canary": ["canary-t"]}
        rollback = json.loads(lines[lines.index("== rollback ==") + 1])
        assert rollback["status"] == "rolled_back", rollback
        status = stack.svc.models.get_status()
        assert status["canary_version"] is None and status["canary_tenants"] == []
        # the steps in order, through the module's run()
        printed = io.StringIO()
        steps = ai_lifecycle.run(stack.url, ADMIN_KEY, wait=120, out=printed)
        assert steps == ["status", "train", "staged", "deploy", "evaluations", "rollback"]
        assert printed.getvalue().strip().splitlines()[-1] == "AI LIFECYCLE OK"
    finally:
        stack.close()


def test_lifecycle_on_a_fresh_stack_stages_nothing_and_exits_0(tmp_path, capsys,
                                                               monkeypatch):
    monkeypatch.delenv("ADMIN_KEY", raising=False)
    stack = _Stack(tmp_path / "sidecar", seeded=False)
    try:
        assert ai_lifecycle.main(["--host", stack.url, "--admin-key", ADMIN_KEY,
                                  "--wait", "1"]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert out[-1] == ai_lifecycle.NO_STAGED
        assert ai_lifecycle.main(["--host", stack.url, "--admin-key", "wrong",
                                  "--wait", "1"]) == 1
        assert ai_lifecycle.main(["--host", stack.url]) == 1     # no admin key given
    finally:
        stack.close()


# ---- the demo notebook -------------------------------------------------------


def test_demo_notebook_hits_are_the_jax_notebooks():
    """Both notebooks' code cells run in order on the CPU (the JAX
    notebook's ``enable_compilation_cache()`` call left out here, not in
    its file): the same top hits, each within its fp32 ties."""
    jcells = chip_smoke.notebook_code(str(REPO / "examples" / "pyrope_tpu_demo.ipynb"),
                                      drop=("enable_compilation_cache()",))
    jns: dict = {}
    jhits = chip_smoke.demo_hits(chip_smoke.run_cells(jcells, jns), jns)
    outs, ns = chip_smoke.run_demo("cpu")
    hits = chip_smoke.demo_hits(outs, ns)
    assert chip_smoke.quickstart_hits_match(jhits, chip_smoke.DEMO_HITS_JAX), jhits
    assert chip_smoke.quickstart_hits_match(hits, chip_smoke.DEMO_HITS_JAX), hits
    for key, ties in chip_smoke.DEMO_HITS_JAX.items():
        if key == "flat_top3" or len(ties) == 1:
            assert hits[key] == jhits[key], key
    assert hits["engine_hit_level"] == jhits["engine_hit_level"] == "L0"
    assert len(outs) == len(jcells) + 1          # the DEVICE cell
    assert ns["DEVICE"] == "cpu" and ns["flat"].device.type == "cpu"


def test_demo_notebook_stores_no_outputs_and_claims_no_tpu():
    nb = json.loads((REPO / chip_smoke.DEMO_NOTEBOOK).read_text())
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert all(c["outputs"] == [] and c["execution_count"] is None for c in code)
    assert "".join(code[0]["source"]).startswith('DEVICE = "cuda"')
    text = " ".join("".join(c["source"]) for c in nb["cells"] if c["cell_type"] == "markdown")
    for claim in ("TPU", "MXU", "one-hot"):
        assert claim not in text, claim


# ---- the shell twins ---------------------------------------------------------


@pytest.mark.parametrize("path", SHELL_TWINS, ids=lambda p: p.name)
def test_shell_twin_parses(path):
    out = subprocess.run(["bash", "-n", str(path)], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert os.access(path, os.X_OK), f"{path.name} is not executable"


def test_check_quality_import_step_runs():
    script = str(REPO / "pyrope_tpu_torch" / "scripts" / "check_quality.sh")
    out = subprocess.run(["bash", script, "2"], env=_subprocess_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "package import ok; native builder: available" in out.stdout
    bad = subprocess.run(["bash", script, "5"], capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "unknown step 5" in bad.stderr
