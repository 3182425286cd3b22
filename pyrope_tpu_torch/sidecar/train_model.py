"""Offline policy-model training from decision logs.

Rebuild of the reference's ``train_model.py``
(ref: src/Pyrope.AISidecar/train_model.py:20-130): load JSONL decision
logs, derive heuristic labels (aggressive iff miss_rate > 0.3 ∨ cpu > 0.8
∨ p99 > 50 ms), fit a ``GradientBoostingClassifier``, persist the
artifact. The reference exports ONNX via skl2onnx; this image ships no
onnx/skl2onnx, so the export path is import-gated and the default artifact
is a joblib dump the ModelManager deploys directly.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional

import numpy as np

FEATURES = ("qps", "cache_miss_rate", "p99_latency_ms", "cpu_utilization")


def label_decision(metrics: dict) -> int:
    """Heuristic label: 1 (aggressive) iff miss>0.3 ∨ cpu>0.8 ∨ p99>50."""
    return int(
        float(metrics.get("cache_miss_rate", 0)) > 0.3
        or float(metrics.get("cpu_utilization", 0)) > 0.8
        or float(metrics.get("p99_latency_ms", 0)) > 50.0
    )


def load_dataset(log_path: "str | Path") -> tuple[np.ndarray, np.ndarray]:
    xs, ys = [], []
    with Path(log_path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            m = rec.get("metrics", rec)
            xs.append([float(m.get(k, 0.0)) for k in FEATURES])
            ys.append(label_decision(m))
    return np.asarray(xs, np.float64), np.asarray(ys, np.int64)


def train(
    log_path: "str | Path",
    out_dir: "str | Path",
    version: Optional[str] = None,
) -> str:
    """Train and stage a model; returns the staged version name."""
    from sklearn.ensemble import GradientBoostingClassifier

    x, y = load_dataset(log_path)
    if len(x) < 10:
        raise ValueError(f"not enough decisions to train on ({len(x)} < 10)")
    if len(set(y.tolist())) < 2:
        raise ValueError("decision log has only one label class")
    model = GradientBoostingClassifier(random_state=42)
    model.fit(x, y)
    version = version or f"gbdt-{time.strftime('%Y%m%d-%H%M%S')}"
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    import joblib

    joblib.dump({"model": model, "features": FEATURES}, out / f"{version}.joblib")
    maybe_export_onnx(model, out / f"{version}.onnx")
    return version


def maybe_export_onnx(model, path: Path) -> bool:
    """ONNX export mirroring the reference's full flow — convert, structural
    checker, then a smoke inference that the exported graph actually answers
    on a feature row before the artifact is staged
    (ref: src/Pyrope.AISidecar/train_model.py:96-130).

    Preferred path: skl2onnx + onnx.checker (+ optional onnxruntime smoke),
    exactly like the reference, when those libraries are installed. This
    image ships none of them, so the default path is the hand-rolled
    serializer (sidecar/onnx_emit.py): a real TreeEnsembleClassifier
    ModelProto emitted directly, structurally checked, and smoke-evaluated
    by decoding the emitted bytes back."""
    try:
        from skl2onnx import convert_sklearn  # type: ignore
        from skl2onnx.common.data_types import FloatTensorType  # type: ignore
        import onnx  # type: ignore
    except ImportError:
        return _export_onnx_handrolled(model, path)
    onx = convert_sklearn(
        model, initial_types=[("input", FloatTensorType([None, len(FEATURES)]))]
    )
    onnx.checker.check_model(onx)
    blob = onx.SerializeToString()
    # ort smoke inference (gated separately: ort may be absent even when
    # skl2onnx is present); a failed run aborts the export entirely
    try:
        import onnxruntime as ort  # type: ignore
    except ImportError:
        ort = None
    if ort is not None:
        sess = ort.InferenceSession(blob)
        probe = np.zeros((1, len(FEATURES)), np.float32)
        out = sess.run(None, {"input": probe})
        if not out:
            raise RuntimeError("onnx export produced a graph with no outputs")
    path.write_bytes(blob)
    return True


def _export_onnx_handrolled(model, path: Path) -> bool:
    """Library-free export: emit, check, smoke-infer, stage."""
    from pyrope_tpu_torch.sidecar import onnx_emit

    blob = onnx_emit.gbdt_to_onnx(model, len(FEATURES))
    onnx_emit.check_model(blob)  # structural checker (reference flow step 2)
    probe = np.zeros((1, len(FEATURES)), np.float32)
    labels, probs = onnx_emit.evaluate(blob, probe)  # smoke inference (step 3)
    if not labels or len(probs[0]) != 2:
        raise RuntimeError("onnx export produced a graph with no outputs")
    path.write_bytes(blob)
    return True


def predict(artifact_path: "str | Path", metrics: dict) -> int:
    import joblib

    art = joblib.load(artifact_path)
    x = np.asarray([[float(metrics.get(k, 0.0)) for k in art["features"]]])
    return int(art["model"].predict(x)[0])
