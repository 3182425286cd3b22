"""Offline policy-model evaluation.

Rebuild of the reference's ``evaluate_model.py``
(ref: src/Pyrope.AISidecar/evaluate_model.py:15-108): replay a decision log
against a trained model, score interventions as TP/FP/FN vs the heuristic
labels, and report a simulated P99 improvement where each correct
intervention halves that sample's latency.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from pyrope_tpu_torch.sidecar.train_model import label_decision


def load_samples(log_path: "str | Path") -> list[dict]:
    """Parse the decision log once (reused across per-version evaluations)."""
    samples = []
    with Path(log_path).open() as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                samples.append(rec.get("metrics", rec))
    return samples


def evaluate(
    artifact_path: "str | Path",
    log_path: "str | Path | None" = None,
    samples: "list[dict] | None" = None,
) -> dict:
    if samples is None:
        samples = load_samples(log_path)
    if not samples:
        return {"samples": 0}

    import joblib

    art = joblib.load(artifact_path)
    x = np.asarray([[float(m.get(k, 0.0)) for k in art["features"]] for m in samples])
    pred = art["model"].predict(x).astype(int)
    truth = np.asarray([label_decision(m) for m in samples])

    tp = int(((pred == 1) & (truth == 1)).sum())
    fp = int(((pred == 1) & (truth == 0)).sum())
    fn = int(((pred == 0) & (truth == 1)).sum())
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0

    # simulated P99: a correct intervention halves that sample's latency
    lat = np.asarray([float(m.get("p99_latency_ms", 0.0)) for m in samples])
    improved = np.where((pred == 1) & (truth == 1), lat * 0.5, lat)
    p99_before = float(np.percentile(lat, 99)) if len(lat) else 0.0
    p99_after = float(np.percentile(improved, 99)) if len(improved) else 0.0

    return {
        "samples": len(samples),
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "precision": precision,
        "recall": recall,
        "simulated_p99_before_ms": p99_before,
        "simulated_p99_after_ms": p99_after,
        "simulated_p99_improvement_ms": p99_before - p99_after,
    }
