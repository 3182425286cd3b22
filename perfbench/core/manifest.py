"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix, and has a file of the limits
that decide its ``correct``; a configuration's file names the adapter that
builds and drives its index and the reference that judges it; every metric
has a reader of its own, which a split name (``list_scan_ms.device_paced``:
the same quantity in cells that report another end-to-end metric) shares
with its base name. So a later cell, configuration or metric is a set of
new files and entries, never an edit of these.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    """The configuration entry merged over its file (the sizes as run)."""
    for c in man["configs"]:
        if c["name"] == name:
            return {**json.loads((ROOT / c["file"]).read_text()), "name": name}
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((BENCH_DIR / "traffic" / f"{name}.json").read_text())


def limits(cell: str) -> dict:
    """The limit of each number compared in ``cell``."""
    return json.loads((BENCH_DIR / "limits" / f"{cell}.json").read_text())


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a split
    name whose file is absent, that of the part before the first dot."""
    if not (BENCH_DIR / "metrics" / f"{name}.py").exists() and "." in name:
        name = name.split(".")[0]
    return module("metrics", name)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` prints: the end-to-end ones without the
    trace, the per-layer ones with it."""
    return [m for m in man["per_layer" if trace else "end_to_end"] if applies(m, cell)]


_MODULES: dict[Path, object] = {}


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, loaded by path (names may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name}".replace(".", "_"), path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"{kind} {name!r}: no file {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]
