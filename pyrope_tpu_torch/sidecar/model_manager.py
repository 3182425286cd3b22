"""Policy-model lifecycle: staging → deploy → canary → auto-rollback.

Rebuild of the reference's ``ModelManager``
(ref: src/Pyrope.AISidecar/model_manager.py:14-239): scans a staging dir
for trained model artifacts, runs training jobs on a thread, deploys a
version as active or canary (file copy + ``state.json``), tracks canary
tenants, and auto-rolls-back the canary when 3 consecutive P99 samples
exceed 1.2× the rolling baseline (window 100)
(ref: model_manager.py:150-184).

Model artifacts are joblib dumps (the environment ships no ONNX runtime;
``train_model.export_onnx`` is gated on the ``onnx``/``skl2onnx`` imports).
"""

from __future__ import annotations

import json
import shutil
import threading
from collections import deque
from pathlib import Path
from typing import Callable, Optional

ROLLBACK_CONSECUTIVE = 3
ROLLBACK_FACTOR = 1.2
BASELINE_WINDOW = 100


class ModelManager:
    def __init__(self, base_dir: str):
        self.base = Path(base_dir)
        self.staging = self.base / "staging"
        self.active_dir = self.base / "active"
        self.staging.mkdir(parents=True, exist_ok=True)
        self.active_dir.mkdir(parents=True, exist_ok=True)
        self._state_path = self.base / "state.json"
        self._lock = threading.Lock()
        self._state = {"active": None, "canary": None, "canary_tenants": []}
        self._baseline_p99: deque[float] = deque(maxlen=BASELINE_WINDOW)
        self._canary_breaches = 0
        self._train_thread: Optional[threading.Thread] = None
        self._job_counter = 0
        self.on_rollback: Optional[Callable[[str], None]] = None
        self._load_state()

    # ---- state ------------------------------------------------------------

    def _load_state(self) -> None:
        if self._state_path.exists():
            try:
                self._state.update(json.loads(self._state_path.read_text()))
            except (json.JSONDecodeError, OSError):
                pass

    def _save_state(self) -> None:
        self._state_path.write_text(json.dumps(self._state))

    def get_status(self) -> dict:
        with self._lock:
            return {
                "active_version": self._state["active"],
                "canary_version": self._state["canary"],
                "canary_tenants": list(self._state["canary_tenants"]),
                "staged_versions": self.list_staged(),
                "training": self._train_thread is not None and self._train_thread.is_alive(),
            }

    def list_staged(self) -> list[str]:
        return sorted(p.stem for p in self.staging.glob("*.joblib"))

    # ---- training ------------------------------------------------------------

    def trigger_training(
        self, train_fn: Callable[[Path], str], block: bool = False
    ) -> dict:
        """Run ``train_fn(staging_dir) -> version`` on a worker thread
        (ref: threaded train job, model_manager.py:60-92)."""
        def work():
            try:
                train_fn(self.staging)
            except Exception:
                pass  # job failure leaves staging unchanged

        with self._lock:
            # alive-check and thread registration in ONE critical section so
            # two concurrent triggers can't both start jobs
            if self._train_thread is not None and self._train_thread.is_alive():
                return {"status": "already_training", "job_id": str(self._job_counter)}
            self._job_counter += 1
            job = self._job_counter
            t = threading.Thread(target=work, daemon=True, name=f"pyrope-train-{job}")
            self._train_thread = t
        t.start()
        if block:
            t.join()
        return {"status": "training", "job_id": str(job)}

    # ---- deploy / canary / rollback ------------------------------------------

    def deploy(self, version: str, canary_tenants: Optional[list[str]] = None) -> dict:
        src = self.staging / f"{version}.joblib"
        if not src.exists():
            return {"status": "not_found", "version": version}
        shutil.copy(src, self.active_dir / f"{version}.joblib")
        with self._lock:
            if canary_tenants:
                self._state["canary"] = version
                self._state["canary_tenants"] = list(canary_tenants)
                self._canary_breaches = 0
            else:
                self._state["active"] = version
                self._state["canary"] = None
                self._state["canary_tenants"] = []
            self._save_state()
            return {
                "status": "deployed",
                "active_version": self._state["active"],
                "canary_version": self._state["canary"],
            }

    def promote_canary(self) -> dict:
        with self._lock:
            if self._state["canary"] is None:
                return {"status": "no_canary"}
            self._state["active"] = self._state["canary"]
            self._state["canary"] = None
            self._state["canary_tenants"] = []
            self._save_state()
            return {"status": "promoted", "active_version": self._state["active"]}

    def rollback(self) -> dict:
        with self._lock:
            rolled = self._state["canary"]
            self._state["canary"] = None
            self._state["canary_tenants"] = []
            self._canary_breaches = 0
            self._save_state()
        if rolled and self.on_rollback:
            self.on_rollback(rolled)
        return {
            "status": "rolled_back" if rolled else "no_canary",
            "active_version": self._state["active"],
            "canary_version": None,
        }

    def record_latency_p99(self, tenant: str, p99_ms: float) -> bool:
        """Feed warm-path P99 samples; returns True if this sample caused a
        canary auto-rollback (ref: model_manager.py:150-184)."""
        with self._lock:
            canary = self._state["canary"]
            is_canary_tenant = canary is not None and (
                not self._state["canary_tenants"] or tenant in self._state["canary_tenants"]
            )
            if not is_canary_tenant:
                self._baseline_p99.append(p99_ms)
                return False
            if len(self._baseline_p99) < 5:
                return False  # not enough baseline yet
            baseline = sum(self._baseline_p99) / len(self._baseline_p99)
            if p99_ms > baseline * ROLLBACK_FACTOR:
                self._canary_breaches += 1
            else:
                self._canary_breaches = 0
            if self._canary_breaches < ROLLBACK_CONSECUTIVE:
                return False
        self.rollback()
        return True

    def is_canary_tenant(self, tenant: str) -> bool:
        with self._lock:
            return (
                self._state["canary"] is not None
                and tenant in self._state["canary_tenants"]
            )
