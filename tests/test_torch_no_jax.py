"""The port stands apart from the JAX package, and runs on the card by default.

Importing every pyrope_tpu_torch module must load neither jax nor any
module of the JAX package (the port keeps its own copies of the
framework-free ones), must not initialize CUDA, and asking for a CUDA
device (the default) on a host without one raises instead of running on
the CPU.
"""

import functools
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from pyrope_tpu_torch.device import resolve_device

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "pyrope_tpu_torch"
ALLOWED = ()  # modules of the JAX package the port may import: none

_PROBE = """
import importlib, json, pkgutil, sys, threading
import pyrope_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pyrope_tpu_torch.__path__,
                                               "pyrope_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import torch
print(json.dumps({
    "modules": len(names),
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "jax_package": sorted(m for m in sys.modules
                          if m == "pyrope_tpu" or m.startswith("pyrope_tpu.")),
    "cuda_initialized": torch.cuda.is_initialized(),
    "entry_points": sorted(m for m in sys.modules if m in ENTRY_POINTS),
    "names": names,
    "threads": sorted(t.name for t in threading.enumerate()),
}))
"""
# modules whose import must start nothing: the servers' entry points
ENTRY_POINTS = ("pyrope_tpu_torch.server.__main__", "pyrope_tpu_torch.server.app",
                "pyrope_tpu_torch.sidecar.server")
MODULES = 116  # every module of the package, the tools' twins (scripts/) included
# the modules that complete the port: Flat sq8 lives in index/flat.py
COMPLETING = ("pyrope_tpu_torch.index.flat", "pyrope_tpu_torch.index.device_flat",
              "pyrope_tpu_torch.parallel", "pyrope_tpu_torch.parallel.mesh",
              "pyrope_tpu_torch.parallel.sharded_flat", "pyrope_tpu_torch.parallel.sharded_ivf",
              "pyrope_tpu_torch.parallel.sharded_ivf_pq",
              "pyrope_tpu_torch.parallel.sharded_hnsw", "pyrope_tpu_torch.parallel.dryrun")


@functools.lru_cache(maxsize=1)
def _probe() -> dict:
    """Import every port module in a fresh interpreter; what it loaded."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    probe = f"ENTRY_POINTS = {ENTRY_POINTS!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_every_module_loads_no_jax():
    got = _probe()
    assert got["modules"] >= MODULES  # every module was imported
    assert got["jax"] == []
    assert not got["cuda_initialized"]


def test_the_completing_modules_are_imported_and_stand_apart():
    """The probe walked index/device_flat.py and every parallel/ module, and
    their sources name neither jax nor the JAX package."""
    got = _probe()
    assert set(COMPLETING) <= set(got["names"]) | {"pyrope_tpu_torch.parallel"}
    pat = re.compile(r"^\s*(?:from|import)\s+(jax\b|pyrope_tpu\b(?!_torch))", re.M)
    for mod in COMPLETING:
        rel = mod.replace(".", "/")
        path = REPO / (rel + ".py") if (REPO / (rel + ".py")).exists() else REPO / rel / "__init__.py"
        assert not pat.findall(path.read_text()), path


def test_importing_the_entry_points_starts_no_server():
    """``python -m`` entry points run only under ``__main__``: the probe
    imported each one, and the process has no thread but its own."""
    got = _probe()
    assert got["entry_points"] == sorted(ENTRY_POINTS)
    assert got["threads"] == ["MainThread"]
    assert not got["cuda_initialized"]


def test_the_sidecar_server_loads_no_torch():
    """The sidecar runs no device work: serving it imports no torch, so it
    can touch no card."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    code = ("import sys, pyrope_tpu_torch.sidecar.server, pyrope_tpu_torch.sidecar.client; "
            "print(sorted(m for m in sys.modules if m == 'torch' or m == 'jax'))")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_importing_every_module_loads_no_jax_package_module():
    assert _probe()["jax_package"] == []


def test_sources_import_only_framework_free_pyrope_tpu_modules():
    """Now: no module of the JAX package at all (ALLOWED is empty), in the
    package and in chip_smoke.py."""
    pat = re.compile(r"^\s*(?:from|import)\s+(jax\b|pyrope_tpu(?:\.[\w.]+)?\b)", re.M)
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for mod in pat.findall(path.read_text()):
            assert mod != "jax", path
            assert ALLOWED and mod.startswith(ALLOWED), (path, mod)


def test_the_examples_and_shell_twins_stand_apart():
    """The demo notebook's code cells (examples/, no Python package: the
    probe does not walk it) and the shell twins (scripts/*.sh) import
    neither jax nor the JAX package, and the tools' twins are modules the
    probe imported."""
    pat = re.compile(r"^\s*(?:from|import)\s+(jax\b|pyrope_tpu\b(?!_torch))", re.M)
    notebooks = sorted((PKG / "examples").glob("*.ipynb"))
    assert notebooks
    for path in notebooks:
        cells = json.loads(path.read_text())["cells"]
        code = "\n".join("".join(c["source"]) for c in cells if c["cell_type"] == "code")
        assert "import pyrope_tpu_torch" in code and not pat.findall(code), path
    shells = sorted((PKG / "scripts").glob("*.sh"))
    assert shells
    for path in shells:
        assert not re.findall(r"\bpyrope_tpu(?!_torch)", path.read_text()), path
    names = set(_probe()["names"])
    for path in (PKG / "scripts").glob("*.py"):
        if path.stem != "__init__":
            assert f"pyrope_tpu_torch.scripts.{path.stem}" in names, path


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.registry import VectorIndexRegistry

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlatIndex(8, "L2", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VectorIndexRegistry("cuda:0")


def test_device_is_required_and_checked():
    """Every entry point defaults to the card: without one, constructing
    with no device raises as an explicit "cuda" does."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    from pyrope_tpu_torch import convert
    from pyrope_tpu_torch.index.flat import FlatIndex
    from pyrope_tpu_torch.index.ivf_flat import IvfFlatIndex
    from pyrope_tpu_torch.index.ivf_pq import IvfPqIndex
    from pyrope_tpu_torch.registry import VectorIndexRegistry, create_index
    from pyrope_tpu_torch.types import IndexConfig

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    import numpy as np

    from pyrope_tpu_torch import parallel
    from pyrope_tpu_torch.index.device_flat import DeviceFlatIndex

    for make in (lambda: IvfFlatIndex(8, "L2"), lambda: FlatIndex(8, "L2"),
                 lambda: IvfPqIndex(8, "L2"), VectorIndexRegistry,
                 lambda: create_index(IndexConfig(dim=8)),
                 lambda: FlatIndex(8, "L2", storage="sq8"),
                 lambda: DeviceFlatIndex(np.zeros((4, 8), np.float32)),
                 parallel.make_mesh, parallel.default_mesh,
                 lambda: parallel.make_mesh_2d(2, 2),
                 lambda: parallel.make_mesh_multislice(2),
                 lambda: parallel.ShardedFlatIndex(8),
                 lambda: parallel.ShardedIvfFlatIndex(8),
                 lambda: parallel.ShardedIvfPqIndex(8),
                 lambda: parallel.ShardedHnswIndex(8),
                 lambda: parallel.ShardedHnswCorpusIndex(8)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    meta = '{"format": "pyrope_tpu.flat.v1", "dim": 8, "metric": "L2"}'
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.flat_from_arrays({"meta": meta, "ids": [], "vecs": []})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.device_flat_from_arrays({"meta": meta, "ids": [], "vecs": []})
