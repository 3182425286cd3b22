"""Regenerate the policy model artifact the sidecar ships.

The port's twin of ``scripts/make_policy_artifact.py``: a seeded synthetic
decision log (400 rows, ``default_rng(42)``, the four metrics) ->
``sidecar/train_model.train`` (GradientBoostingClassifier, random_state 42)
-> the hand-rolled TreeEnsembleClassifier ONNX of ``sidecar/onnx_emit.py``,
staged to ``pyrope_tpu_torch/sidecar/policy_model.onnx`` or to ``--out``.
Seeded log and seeded fit: a rerun gives the committed bytes, which are
the JAX package's byte for byte.

Training needs scikit-learn, so this runs on the host's CPU only and uses
no device; without scikit-learn it says so and exits 1, writing nothing.

    python -m pyrope_tpu_torch.scripts.make_policy_artifact [--out PATH]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from pyrope_tpu_torch.sidecar import train_model

ARTIFACT = Path(train_model.__file__).resolve().parent / "policy_model.onnx"


def synth_log(path: Path, n: int = 400, seed: int = 42) -> None:
    """``n`` decision-log lines of uniformly drawn metrics, seeded."""
    rng = np.random.default_rng(seed)
    with path.open("w") as f:
        for _ in range(n):
            m = {
                "qps": float(rng.uniform(10, 2000)),
                "cache_miss_rate": float(rng.uniform(0, 1)),
                "p99_latency_ms": float(rng.uniform(1, 120)),
                "cpu_utilization": float(rng.uniform(0, 1)),
            }
            f.write(json.dumps({"metrics": m}) + "\n")


def make_artifact(dst: Path) -> Path:
    """Train on the synthetic log in a temporary directory and copy the
    emitted ONNX to ``dst`` (an existing directory: ``dst``/policy_model.onnx)."""
    if dst.is_dir():
        dst = dst / ARTIFACT.name
    dst.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="pyrope_policy_") as tmp:
        log = Path(tmp) / "decisions.jsonl"
        synth_log(log)
        version = train_model.train(log, tmp, version="policy_model")
        shutil.copyfile(Path(tmp) / f"{version}.onnx", dst)
    return dst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ARTIFACT),
                    help="file or directory to write (default: the port's "
                         "sidecar/policy_model.onnx)")
    args = ap.parse_args(argv)
    if importlib.util.find_spec("sklearn") is None:
        print("make_policy_artifact: scikit-learn is not installed; training the "
              "policy model needs it (run this on a host that has it)", file=sys.stderr)
        return 1
    dst = make_artifact(Path(args.out))
    print(f"staged {dst} ({dst.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
