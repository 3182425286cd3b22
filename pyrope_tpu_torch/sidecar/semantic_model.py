"""Semantic cluster trainer: vectors → centroids → control plane.

Rebuild of the reference's ``SemanticModelTrainer``
(ref: src/Pyrope.AISidecar/semantic_model.py:9-56 — sklearn KMeans(256)
over sampled vectors, POSTed to ``/v1/indexes/{t}/{i}/centroids``).

Difference from the reference: clustering runs on the card (``device``,
``"cuda"`` unless the caller asks for the CPU; CUDA on a host without a GPU
raises) with the engine's own Lloyd's k-means (``pyrope_tpu_torch.ops.kmeans``,
k-means++ on ``jax.random``'s draws, so both packages pick the same rows)
instead of sklearn — the trainer shares the index's op library.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Optional

import numpy as np

from pyrope_tpu_torch.ops.kmeans import kmeans_train
from pyrope_tpu_torch.types import Metric


class SemanticModelTrainer:
    def __init__(self, control_plane_url: str, api_key: Optional[str] = None, k: int = 256,
                 device="cuda"):
        self.base_url = control_plane_url.rstrip("/")
        self.api_key = api_key
        self.k = k
        self.device = device

    def train(self, vectors: np.ndarray, metric: "Metric | str" = Metric.L2) -> np.ndarray:
        v = np.asarray(vectors, dtype=np.float32)
        k = min(self.k, len(v))
        # kmeans++ seeding is deliberate here (not the reference's random
        # sample, ref: semantic_model.py sklearn KMeans — which also uses
        # ++ init): better-separated centroids directly improve L2
        # semantic-cache cluster assignment quality
        return kmeans_train(v, k, metric=Metric.parse(metric), device=self.device,
                            seed=42, init="kmeans++")

    def push(self, tenant: str, index: str, centroids: np.ndarray) -> dict:
        url = f"{self.base_url}/v1/indexes/{tenant}/{index}/centroids"
        body = json.dumps({"centroids": np.asarray(centroids, np.float32).tolist()})
        req = urllib.request.Request(
            url, data=body.encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        if self.api_key:
            req.add_header("X-API-KEY", self.api_key)
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def train_and_push(self, tenant: str, index: str, vectors: np.ndarray) -> dict:
        return self.push(tenant, index, self.train(vectors))
