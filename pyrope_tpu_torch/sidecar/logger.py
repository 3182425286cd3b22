"""Decision log: JSONL append, doubling as the training dataset.

Rebuild of the reference's ``QueryLogger``
(ref: src/Pyrope.AISidecar/logger.py:6-21).
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path


class QueryLogger:
    def __init__(self, path: "str | Path"):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def log_decision(
        self, tenant: str, metrics: dict, policy: dict, source: str, action: int
    ) -> None:
        rec = {
            "ts": time.time(),
            "tenant": tenant,
            "metrics": metrics,
            "policy": policy,
            "source": source,
            "bandit_action": action,
        }
        line = json.dumps(rec)
        with self._lock:
            with self.path.open("a") as f:
                f.write(line + "\n")
