"""Vector payload sniffing.

Rebuild of the reference's ``VectorParsing`` (ref: Utils/VectorParsing.cs:
10-60): a vector payload on the wire may be a JSON array, a CSV string, or
raw little-endian float32 binary; try in that order.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np


def parse_vector(payload: bytes, expected_dim: Optional[int] = None) -> np.ndarray:
    """Decode one query/record vector from a wire payload."""
    # 1. JSON array
    stripped = payload.strip()

    def _validated(v: np.ndarray) -> np.ndarray:
        if expected_dim is not None and v.shape[0] != expected_dim:
            raise ValueError(f"vector has dim {v.shape[0]}, expected {expected_dim}")
        if not np.all(np.isfinite(v)):
            raise ValueError("vector contains NaN/inf (e.g. JSON null)")
        return v

    if stripped[:1] == b"[":
        try:
            arr = json.loads(stripped)
            v = np.asarray(arr, dtype=np.float32)
        except (json.JSONDecodeError, ValueError, TypeError):
            v = None
        if v is not None and v.ndim == 1 and v.size:
            return _validated(v)
    # 2. CSV text
    if _looks_texty(stripped):
        try:
            parts = stripped.decode("utf-8").replace(";", ",").split(",")
            v = np.asarray([float(p) for p in parts if p.strip()], dtype=np.float32)
            if v.size:
                return _validated(v)
        except (UnicodeDecodeError, ValueError) as e:
            if "expected" in str(e) or "NaN" in str(e):
                raise
    # 3. Raw little-endian float32 binary
    if len(payload) % 4 == 0 and len(payload) > 0:
        v = np.frombuffer(payload, dtype="<f4").astype(np.float32)
        if expected_dim is None or len(v) == expected_dim:
            return v
    raise ValueError(
        f"cannot parse vector payload ({len(payload)} bytes"
        + (f", expected dim {expected_dim}" if expected_dim else "")
        + ")"
    )


def _looks_texty(b: bytes) -> bool:
    probe = b[:64]
    if not probe:
        return False
    allowed = set(b"0123456789.,;+-eE \t\r\nnainfNAINF")
    return all(c in allowed for c in probe)


def encode_vector(v: np.ndarray) -> bytes:
    """float32 → LE byte blob (ref: Benchmarks/Encoding/VectorEncoding.cs:8-16)."""
    return np.ascontiguousarray(np.asarray(v, dtype="<f4")).tobytes()
