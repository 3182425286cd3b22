"""The run as a process: no card, no result; nothing of JAX loaded."""

import json
import os
import subprocess
import sys

from core import harness, manifest

ROOT = manifest.ROOT


def test_no_card_exits_non_zero_without_a_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                           "sift1m-ivf-flat.b1024", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_banned_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyrope_tpu_torch_fake.x", sys)
    assert not [m for m in harness.banned_modules() if m.startswith("pyrope_tpu_torch")]
    monkeypatch.setitem(sys.modules, "pyrope_tpu.fake", sys)
    assert "pyrope_tpu.fake" in harness.banned_modules()


SCRIPT = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
sys.path.insert(0, {tests!r})
from conftest import tiny
from core import harness, manifest
man = manifest.load()
for cell in [w["name"] for w in man["workloads"]]:
    out = harness.run_cell(man, cell, 4_000_000_013, 0.3, False, device="cpu",
                           overrides=tiny(man, cell))
    assert out["correct"], (cell, out["checks"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_nothing_of_jax():
    bench = str(manifest.BENCH_DIR)
    code = SCRIPT.format(bench=bench, root=str(ROOT), tests=str(manifest.BENCH_DIR / "tests"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    top = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "pyrope_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pyrope_tpu"}
