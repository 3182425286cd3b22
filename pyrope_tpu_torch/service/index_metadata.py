"""Index-config metadata persistence.

Rebuild of the reference's ``IndexMetadataManager``
(ref: Services/IndexMetadataManager.cs:9-39): (de)serializes each
``IndexConfig`` under a ``sys:index:{tenant}:{index}`` key so index
definitions survive restarts. The store is pluggable; the default is a
JSON file per manager (the reference writes into its KV store).
"""

from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Optional

from pyrope_tpu_torch.types import IndexConfig
from pyrope_tpu_torch.utils.naming import meta_key


class IndexMetadataManager:
    def __init__(self, path: "str | Path | None" = None):
        self._path = Path(path) if path else None
        self._lock = threading.Lock()
        self._data: dict[str, dict] = {}
        if self._path is not None and self._path.exists():
            try:
                self._data = json.loads(self._path.read_text())
            except (json.JSONDecodeError, OSError):
                self._data = {}

    def _persist(self) -> None:
        if self._path is None:
            return
        tmp = self._path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self._data, indent=1))
        tmp.replace(self._path)  # atomic (same pattern as Delta snapshots)

    def save(self, tenant: str, index: str, config: IndexConfig) -> None:
        with self._lock:
            self._data[meta_key(tenant, index)] = config.to_dict()
            self._persist()

    def load(self, tenant: str, index: str) -> Optional[IndexConfig]:
        with self._lock:
            d = self._data.get(meta_key(tenant, index))
            return None if d is None else IndexConfig.from_dict(d)

    def delete(self, tenant: str, index: str) -> bool:
        with self._lock:
            removed = self._data.pop(meta_key(tenant, index), None) is not None
            if removed:
                self._persist()
            return removed

    def list_all(self) -> list[tuple[str, str, IndexConfig]]:
        with self._lock:
            out = []
            for key, d in self._data.items():
                _, _, tenant, index = key.split(":", 3)
                out.append((tenant, index, IndexConfig.from_dict(d)))
            return out
