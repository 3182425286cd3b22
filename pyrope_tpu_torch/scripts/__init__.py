"""Twins of the JAX package's tools (``scripts/*.py``, ``examples/quickstart.py``).

Each module keeps the name of the script it stands for and runs as

    python -m pyrope_tpu_torch.scripts.<name> [--device cuda|cpu] [--out DIR]

on the card unless ``--device cpu`` is given (``cuda`` without a GPU
raises; nothing falls back to the CPU). Each prints one JSON object as the
last line of its standard output, progress on standard error, and writes
files only under ``--out`` (its JSON there as ``<name>.json``). Every
result names the device it ran on: a number from a CPU run is the CPU's.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from pyrope_tpu_torch.device import resolve_device


def add_common(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None,
                    help="directory for the JSON result (and any trace)")
    return ap


def start_device(device: str) -> torch.device:
    """The checked device; on the card the kernels are built (nvcc, first
    use of a checkout) or loaded before anything is timed, and TF32 is off
    so fp32 products stay fp32, as the JAX package's are."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from pyrope_tpu_torch.kernels import build as kbuild

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kbuild.load()
    return dev


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_info(dev: torch.device) -> dict:
    """What ran the numbers: the card's name and power limit as nvidia-smi
    gives them, or the CPU."""
    if dev.type != "cuda":
        return {"platform": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "nvidia_smi": smi}


def emit(name: str, result: dict, out: str | None) -> None:
    """Print ``result`` as one JSON line; with ``out``, also write it to
    ``out``/``name``.json."""
    text = json.dumps(result, default=float)
    if out:
        path = Path(out)
        path.mkdir(parents=True, exist_ok=True)
        (path / f"{name}.json").write_text(json.dumps(result, indent=1, default=float) + "\n")
    print(text, flush=True)
