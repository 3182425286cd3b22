"""Contextual bandit over policy aggressiveness.

Rebuild of the reference's ``ContextualBanditEngine``
(ref: src/Pyrope.AISidecar/bandit_engine.py:10-87): ε-greedy (ε=0.1) over
actions {0: normal, 1: aggressive} with an ``SGDClassifier(log_loss)``
contextual model on features [qps, miss_rate, p99_ms, cpu]; the reward
(0.3 − miss_rate, fed back a tick later) is reduced to a binary label for
partial_fit; pickle persistence.
"""

from __future__ import annotations

import pickle
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ACTION_NORMAL = 0
ACTION_AGGRESSIVE = 1


class ContextualBanditEngine:
    def __init__(self, epsilon: float = 0.1, model_path: Optional[str] = None, seed: int = 0):
        self.epsilon = epsilon
        self._lock = threading.Lock()  # gRPC serves from a thread pool
        self.model_path = Path(model_path) if model_path else None
        self._rng = np.random.default_rng(seed)
        self._model = None
        self._fitted = False
        self.decisions = 0
        self.rewards_seen = 0
        if self.model_path is not None and self.model_path.exists():
            self.load()

    def _ensure_model(self):
        if self._model is None:
            from sklearn.linear_model import SGDClassifier

            self._model = SGDClassifier(loss="log_loss", random_state=0)
        return self._model

    @staticmethod
    def _features(metrics: dict) -> np.ndarray:
        from pyrope_tpu_torch.sidecar.feature_engineering import system_features

        return np.asarray(system_features(metrics), dtype=np.float64)

    def select_action(self, metrics: dict) -> int:
        with self._lock:
            self.decisions += 1
            if not self._fitted or self._rng.random() < self.epsilon:
                return int(self._rng.integers(0, 2))
            x = self._features(metrics).reshape(1, -1)
            p_aggressive_good = self._model.predict_proba(x)[0][1]
            return ACTION_AGGRESSIVE if p_aggressive_good > 0.5 else ACTION_NORMAL

    def update(self, metrics: dict, action: int, reward: float) -> None:
        """Reward→label reduction: a positive reward reinforces the taken
        action; negative reinforces the opposite. Periodically persisted so
        learned state survives restarts."""
        with self._lock:
            self.rewards_seen += 1
            x = self._features(metrics).reshape(1, -1)
            label = action if reward > 0 else 1 - action
            model = self._ensure_model()
            model.partial_fit(x, [label], classes=[0, 1])
            self._fitted = True
            persist = self.rewards_seen % 25 == 0
        if persist:
            self.save()

    def save(self) -> None:
        if self.model_path is None or self._model is None:
            return
        with self._lock:
            payload = pickle.dumps({"model": self._model, "fitted": self._fitted})
        self.model_path.write_bytes(payload)

    def load(self) -> None:
        try:
            with self.model_path.open("rb") as f:
                st = pickle.load(f)
            self._model = st["model"]
            self._fitted = st["fitted"]
        except (OSError, pickle.PickleError, KeyError):
            self._model, self._fitted = None, False
