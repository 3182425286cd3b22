"""Build and load the native library (the port's copy of
``pyrope_tpu/native/build.py``).

g++ compiles the top-level ``native/*.cc`` sources, unedited and with the
JAX package's flags, into ``build/pyrope_tpu_torch/`` at the repo root. The
library is written under a temporary name and moved into place with
``os.replace``, so processes that build at once (test workers) each load a
whole file. A stale library (older than a source) is built anew. A failed
build raises with the compiler's stderr: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC_DIR = _ROOT / "native"
_SOURCES = ["hnsw_builder.cc"]
BUILD_DIR = _ROOT / "build" / "pyrope_tpu_torch"
LIB_NAME = "libpyrope_native.so"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_INT = ctypes.c_int


def _compile() -> Path:
    """The library's path, compiled first where it is missing or stale."""
    srcs = [_SRC_DIR / s for s in _SOURCES]
    lib_path = BUILD_DIR / LIB_NAME
    newest_src = max(s.stat().st_mtime for s in srcs)
    if lib_path.exists() and lib_path.stat().st_mtime >= newest_src:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=LIB_NAME + ".", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, *map(str, srcs)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed to build {LIB_NAME} (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load_native() -> ctypes.CDLL:
    """The loaded native library, built at first use. Raises where g++ is
    missing or the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_compile()))
            lib.hnsw_build.restype = _INT
            lib.hnsw_build.argtypes = [
                _F32P, _F32P,   # vecs [n, dim], sqnorm [n]
                _INT, _INT,     # n, dim
                _INT, _INT,     # m, ef_construction
                _INT,           # metric (0 L2, 1 IP / normalized cosine)
                _INT,           # heuristic (0 = the reference's closest-M)
                _I32P, _INT,    # levels [n], max_level
                _I32P, _I32P,   # adj0 [n, 2m], adj_up [max_level, n, m]
                _I32P,          # top_level_out [1]
            ]
            _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library builds and loads here: the loader's
    own answer (g++ present, the build succeeds). A False does not make the
    HNSW builder fall back to anything: it raises, as ``load_native``
    does."""
    try:
        load_native()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True
