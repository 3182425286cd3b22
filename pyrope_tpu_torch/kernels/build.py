"""Build and load the port's CUDA kernels (``pyrope_tpu_torch/csrc/*.cu``).

nvcc compiles each source to an object, all at once in parallel, and links
them into one shared library with a plain C interface at first use; ctypes
loads it. Tensors cross as ``data_ptr()`` integers and
the stream as ``torch.cuda.current_stream().cuda_stream``, every one
declared ``c_void_p`` so ctypes never cuts a pointer to 32 bits.

The library lands in ``build/pyrope_tpu_torch/`` at the repo root, named
after a hash of the sources, their headers and the nvcc flags, so a changed source builds
anew and an unchanged one is loaded as it is. A missing nvcc or a failed
build raises with nvcc's own output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "pyrope_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_log = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIST_TABLES = [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                _I, _I, _I, _I, _P, _P, _P, _I, _I, _P]
_SIGNATURES = {
    # k, query tile
    "pyrope_scan_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # k, query tile, D, the wide candidate buffer's entries
    "pyrope_flat_tc_smem_bytes": (ctypes.c_longlong, [_I, _I, _I, _I]),
    # k, mode (1 IVF, 2 SQ8, 3 BF16)
    "pyrope_list_scan_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # k, D: the tensor-core list scan's
    "pyrope_list_tc_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # k, D: the promote list scan's (0: it does not take D)
    "pyrope_list_promote_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    "pyrope_error_string": (ctypes.c_char_p, [_I]),
    # q, x, sqnorm, alive, B, N, D, k, list width kw, metric_ip, max_scans,
    # rows_per_split, rows_scan, n_splits, query tile, vec, part_v, part_i,
    # pub, pub_c, pub_g, floor0, cap, fills, the first pass's floor counts
    # and floors (fcnt, fout) and g, stream
    "pyrope_fused_scan": (
        _I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P],
    ),
    # k, the wide candidate buffer's entries
    "pyrope_scan_wide_smem_bytes": (ctypes.c_longlong, [_I, _I]),
    # q (bf16), x (bf16), qsq, sqnorm, alive, then as pyrope_fused_scan
    "pyrope_flat_scan_tc": (
        _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
             _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P],
    ),
    # q, x, sqnorm, alive, then the tables: pairs, P, cstart, ccnt, item_end,
    # item_c, slot_end, offsets, lens, nclus, grid, B, D, k, slot width kw,
    # metric_ip, seg, sample, nslots, vec, part_v, part_i, pub (the slots'
    # published keys), pub_c, pub_g, stream
    "pyrope_ivf_list_scan": (_I, [_P, _P, _P, _P, *_LIST_TABLES]),
    # q, x (bf16), qsq (or null: promote_fp32), sqnorm, alive, the tables
    "pyrope_ivf_list_scan_bf16": (_I, [_P, _P, _P, _P, _P, *_LIST_TABLES]),
    # q (fp32), x (bf16), sqnorm, alive, N, the tables (bf16(q) on the
    # tensor cores, k <= 128)
    "pyrope_ivf_list_scan_tc": (_I, [_P, _P, _P, _P, _I, *_LIST_TABLES]),
    # q (fp32), x (bf16), sqnorm, alive, blocks (the walking grid), the
    # tables (promote_fp32 at k <= 128, D <= 256)
    "pyrope_ivf_list_scan_promote": (_I, [_P, _P, _P, _P, _I, *_LIST_TABLES]),
    # q, codes, mins, scales, sqnorm, alive, qc, kp, the tables
    "pyrope_ivf_list_scan_sq8": (_I, [_P, _P, _P, _P, _P, _P, _P, _I, *_LIST_TABLES]),
    # part_v, part_i, S, B, k, qend (null: S lists a query at the strides),
    # P, qstride, lstride, out_v, out_i, stream
    "pyrope_merge_partials": (
        _I, [_P, _P, _I, _I, _I, _P, _I, ctypes.c_longlong, ctypes.c_longlong,
             _P, _P, _P],
    ),
    # part_v, part_i, S, B, k, list width, qend, P, qstride, lstride, fills
    # (null, or the lists' real entries), out_v, out_i, stream
    "pyrope_merge_partials_wide": (
        _I, [_P, _P, _I, _I, _I, _I, _P, _I, ctypes.c_longlong, ctypes.c_longlong,
             _P, _P, _P, _P],
    ),
    # keys [nslots] u64, nslots, qend [B, P], B, P, g, base [B], out [B], stream
    "pyrope_floor_select_list": (_I, [_P, _I, _P, _I, _I, _I, _P, _P, _P]),
    # B, kp: the inversion's scratch bytes
    "pyrope_invert_scratch_bytes": (ctypes.c_longlong, [_I, _I]),
    # probe, probe is int64, lens, B, P, kp, seg, chunk, grid, then pairs,
    # cstart, ccnt, item_end, item_c, slot_end, scratch, keys (zeroed),
    # n_keys, stream
    "pyrope_invert_probes": (
        _I, [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
             ctypes.c_longlong, _P],
    ),
}


def _sources() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(_SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA kernels of "
        "pyrope_tpu_torch build from source and need the CUDA toolkit"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpyrope_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the sources unless the library for them exists. ``verbose``
    also builds when it exists and keeps ptxas's per-kernel register,
    shared-memory and spill report in ``build_log()``."""
    global _build_log
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
             "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    procs: list[subprocess.Popen] = []
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]   # one nvcc per source
        logs = []
        for c, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(c)}\n{stderr}")
            logs.append(stdout + stderr)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for proc in procs:  # after a failure, stop the other compiles too
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    _build_log = "".join(logs)
    return out


def build_log() -> str:
    """nvcc's output from the last build in this process."""
    return _build_log


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError)."""
    if code != 0:
        msg = load().pyrope_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
