"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

The sources compile with `nvcc` for sm_90a into one shared library with a
plain C interface, loaded with ctypes. The build happens at first use,
under a lock (the dispatch leader and the tile-warm threads can both get
here first), into `surrealdb_tpu_torch/_build/<hash of the sources>/`, so a
checkout builds its own sources once and an edited source rebuilds. The
one-time build is recorded in compile_log as subsystem `kernel_build`.

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the plain PyTorch versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)
_LIB_NAME = "libsurreal_knn.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, None if cached
build_log: str = ""  # nvcc's output (ptxas register / shared-memory report)

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (restype, argtypes)
    "knn_pairwise": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P, _P]),
    "knn_row_mean": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P]),
    "knn_select": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  _P, _P, _P, _P, _P, ctypes.c_longlong, _P]),
    "knn_select_mid_elems": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]),
    "knn_select_smem_pairs": (ctypes.c_int, []),
    "knn_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def _sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh"))
    )


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this machine")


def _build(sources, out_dir: str) -> str:
    global build_seconds, build_log
    import time

    from surrealdb_tpu_torch import compile_log

    so = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(s for s in sources if s.endswith(".cu"))]
    t0 = time.perf_counter()
    with compile_log.tracked("kernel_build", (os.path.basename(out_dir),)):
        proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + build_log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees no half-written library
    build_seconds = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            sources = _sources()
            so = _build(sources, os.path.join(BUILD_ROOT, _digest(sources)))
            handle = ctypes.CDLL(so)
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = handle
    return _lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned right after a launch."""
    if status != 0:
        name = lib().knn_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed with error {status} ({name})")
