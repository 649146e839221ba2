"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each `csrc/*.cu` is compiled by its own nvcc process, all started
together, into `truetrace_tpu_torch/_build/` (git-ignored) at first use,
for sm_90a with `-O3 --fmad=false`. `--fmad=false` keeps every mul and
add rounded on its own, so the kernels reproduce the plain PyTorch
versions bit for bit; the few mul-adds that XLA contracts are written as
explicit `__fmaf_rn` in the sources. The sources expose plain C entry
points (no PyTorch headers, so a build takes seconds); every entry point
launches on the stream it is given and returns `cudaGetLastError()`.
Importing this module needs no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = ("traverse.cu", "step_core.cu", "atrous.cu")
HEADERS = ("cwbvh_core.cuh",)
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

_lock = threading.Lock()
_libs: dict = {}
build_seconds = None        # wall time of the last build (set by build_all)
build_log: dict = {}        # source -> nvcc output (ptxas registers, spills)

P, I = ctypes.c_void_p, ctypes.c_int
# argtypes of every C entry point; each returns cudaError_t as int
_SIGNATURES = {
    "traverse.cu": {
        "tt_traverse": [P, I, I, I, I, I, P, P, P, I, I, P, P, P, P, P],
    },
    "step_core.cu": {
        "tt_step_core": [P, P, P, P, I, I, P],
    },
    "atrous.cu": {
        "tt_atrous_pass": [P, P, P, P, P, P, I, I, I, P],
    },
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(src: str) -> str:
    h = hashlib.sha256()
    for name in (src,) + HEADERS + ("_flags",):
        if name == "_flags":
            h.update(" ".join(NVCC_FLAGS).encode())
        else:
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:12]


def _so_path(src: str) -> str:
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"tt_{stem}_{_digest(src)}.so")


def build_all() -> dict:
    """Compile every missing kernel library, one nvcc per source in
    parallel, and load them all. Raises with the compiler's output when a
    build fails. Returns {source: ctypes.CDLL}."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in SOURCES:
            so = _so_path(src)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT), tmp, so)
        errors = []
        for src, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate(timeout=900)
            build_log[src] = out.decode()
            if proc.returncode != 0:
                errors.append(f"nvcc {src} failed:\n{out.decode()}")
            else:
                os.replace(tmp, so)
        if errors:
            raise RuntimeError("\n".join(errors))
        for src in SOURCES:
            lib = ctypes.CDLL(_so_path(src))
            for fn, argtypes in _SIGNATURES[src].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[src] = lib
        build_seconds = time.perf_counter() - t0
        return _libs


def lib(src: str) -> ctypes.CDLL:
    return build_all()[src]


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (refused launches never
    run, and a later synchronize does not report them)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def stream_ptr(t) -> int:
    """Raw handle of the current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
