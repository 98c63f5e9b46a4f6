"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Each source compiles with `nvcc` for sm_90a into an object, all at once
(one nvcc process a source), and the objects link into one shared library
with a plain C interface, loaded with ctypes. The build happens at first use,
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-lineinfo", "-Xptxas", "-v",
)
_LIB_NAME = "libsurreal_kernels.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build, None if cached
build_log: str = ""  # nvcc's output (ptxas register / shared-memory report)
build_source_seconds: dict = {}  # source -> wall seconds of its nvcc -c, side by side

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (restype, argtypes)
    "knn_pairwise": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P,
                                    ctypes.c_longlong, _P, _P]),
    "knn_pairwise_scratch_bytes": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong,
                                                       ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "knn_search": (ctypes.c_int, [_P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, _P, _P,
                                  _P, ctypes.c_longlong, _P, _P, _P]),
    "knn_search_scratch_bytes": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong,
                                                     ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_int]),
    "knn_search_max_k": (ctypes.c_int, []),
    "knn_row_mean": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P, _P]),
    "knn_select": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  _P, _P, _P, _P, _P, ctypes.c_longlong, _P]),
    "knn_select_mid_elems": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]),
    "knn_select_smem_pairs": (ctypes.c_int, []),
    "knn_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    "ivf_assign": (ctypes.c_int, [_P, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_longlong,
                                  _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]),
    "ivf_assign_limb_pitch": (ctypes.c_int, [ctypes.c_int]),
    "ivf_kmeans_update": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                         _P, _P, ctypes.c_int, _P, _P, _P, _P]),
    "ivf_kmeans_update_scratch_bytes": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_int,
                                                            ctypes.c_int]),
    "ivf_rerank": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                  _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_longlong, _P, _P,
                                  ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, _P, _P, _P, _P]),
    "ivf_rerank_plan": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       _P]),
    "graph_dense_count": (ctypes.c_int, [_P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int,
                                         ctypes.c_int, _P, _P, _P, _P]),
    "graph_csc_count": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P,
                                       ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _P, _P, _P, ctypes.c_longlong, _P, _P]),
    "graph_chain": (ctypes.c_int, [_P, _P, _P, _P, _P, _P, ctypes.c_int, _P, _P, _P,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                                   ctypes.c_int, _P, _P, _P, _P]),
    "graph_chain_bitmap_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "graph_chain_state_entries": (ctypes.c_longlong, [ctypes.c_longlong]),
    "bm25_scores": (ctypes.c_int, [_P, ctypes.c_int, _P, _P, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, _P, _P]),
    "bm25_match_scores": (ctypes.c_longlong, [_P, _P, _P, _P, _P, _P, ctypes.c_int,
                                              ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                                              ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                              ctypes.c_float, _P, _P, _P, _P,
                                              ctypes.c_longlong, _P]),
    "bm25_match_by_value_terms": (ctypes.c_int, []),
    "bm25_match_state_entries": (ctypes.c_longlong, [ctypes.c_longlong]),
    "ml_linear": (ctypes.c_int, [_P, ctypes.c_int, _P, ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, _P, _P, _P]),
    "ml_softmax": (ctypes.c_int, [_P, ctypes.c_longlong, ctypes.c_int, _P, _P]),
    "ml_ewise": (ctypes.c_int, [_P, _P]),
    "ml_reduce": (ctypes.c_int, [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_float, _P, ctypes.c_longlong, _P,
                                 _P]),
    "ml_reduce_scratch_floats": (ctypes.c_longlong, [ctypes.c_longlong, ctypes.c_longlong,
                                                     ctypes.c_longlong]),
    "mesh_topk_merge": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P, _P,
                                       _P]),
    "mesh_knn_2d": (ctypes.c_int, [_P, ctypes.c_longlong, ctypes.c_int, _P, ctypes.c_int,
                                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, _P,
                                   ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P,
                                   ctypes.c_longlong, _P, _P, _P]),
    "mesh_knn_2d_scratch_bytes": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_longlong,
                                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "mesh_frontier_hop": (ctypes.c_int, [_P, ctypes.c_longlong, _P, ctypes.c_longlong, _P, _P,
                                         ctypes.c_longlong, ctypes.c_int, _P, _P, _P]),
    "mesh_dedup_frontier": (ctypes.c_int, [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P,
                                           ctypes.c_int, _P, _P, _P]),
    "mesh_dedup_bitmap_words": (ctypes.c_longlong, [ctypes.c_longlong]),
    "mesh_dedup_state_entries": (ctypes.c_longlong, [ctypes.c_longlong]),
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


def _run_all(cmds, out_dir: str, seconds=None):
    """Run the commands side by side; (returncode, output) of each. Output
    goes to files, so a chatty process never blocks on a full pipe. With a
    list for seconds, each command's wall time is appended to it."""
    import tempfile
    import time

    logs = [tempfile.TemporaryFile("w+", dir=out_dir) for _ in cmds]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
        for cmd, log in zip(cmds, logs)
    ]
    done = [None] * len(procs)
    while None in done:
        for i, p in enumerate(procs):
            if done[i] is None and p.poll() is not None:
                done[i] = time.perf_counter() - t0
        time.sleep(0.05)
    if seconds is not None:
        seconds.extend(done)
    out = []
    for p, log in zip(procs, logs):
        log.seek(0)
        out.append((p.returncode, log.read()))
        log.close()
    return out


def _build(sources, out_dir: str) -> str:
    global build_seconds, build_log, build_source_seconds
    import time

    from surrealdb_tpu_torch import compile_log

    so = os.path.join(out_dir, _LIB_NAME)
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in sources if s.endswith(".cu")]
    objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o") for s in cus]
    compile_cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(cus, objs)]
    tmp = f"{so}.{tag}"
    link_cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]
    t0 = time.perf_counter()
    with compile_log.tracked("kernel_build", (os.path.basename(out_dir),)):
        secs = []
        results = _run_all(compile_cmds, out_dir, secs)
        if all(rc == 0 for rc, _ in results):
            results.append(_run_all([link_cmd], out_dir)[0])
    build_log = "".join(out for _, out in results)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(" ".join(c) for c in compile_cmds + [link_cmd]) + "\n" + build_log)
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    failed = [rc for rc, _ in results if rc != 0]
    if failed or len(results) != len(compile_cmds) + 1:
        raise RuntimeError(f"nvcc failed ({failed}):\n{build_log[-4000:]}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees no half-written library
    build_seconds = time.perf_counter() - t0
    build_source_seconds = {os.path.basename(c): t for c, t in zip(cus, secs)}
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


def check(status: int, what: str, via=None) -> None:
    """Raise on a non-zero cudaError_t returned right after a launch; `via`
    is the library that returned it (default: the built one)."""
    if status != 0:
        name = (via or lib()).knn_error_string(status).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA launch failed with error {status} ({name})")
