"""Build and load the port's CUDA kernels (nvcc -> shared library ->
ctypes).

Each `csrc/*.cu` is compiled by its own nvcc process, all started
together, into `truetrace_tpu_torch/_build/` (git-ignored) at first use,
for sm_90a with `-O3` and the flags of its own (`NVCC_FLAGS[source]`):

- `traverse.cu`, `step_core.cu`, `traverse_tlas.cu`, `heightmap.cu`,
  `traverse_bvh2.cu`: `--fmad=false`. Their contract is bitwise: every
  mul and add rounds on its own, as in the plain PyTorch versions, and
  the few mul-adds that XLA contracts are written as explicit
  `__fmaf_rn` in the sources.
- `atrous.cu`: no `--fmad=false`. Its contract is a tolerance (rtol 1e-4,
  atol 1e-5 against the plain pass), so nvcc contracts mul-adds; the few
  roundings the tolerance cannot absorb are written `__fmul_rn` /
  `__fadd_rn` in the source.

A library's name carries a digest of its source, the shared header and
its flags. The sources expose plain C entry points (no PyTorch headers,
so a build takes seconds); every entry point launches on the stream it is
given and returns `cudaGetLastError()`. Importing this module needs no
nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
HEADERS = ("cwbvh_core.cuh", "traverse_common.cuh")
_BASE_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
BITWISE_FLAGS = _BASE_FLAGS + ["--fmad=false"]
# source -> its nvcc flags (see the module docstring for why)
NVCC_FLAGS = {"traverse.cu": BITWISE_FLAGS, "step_core.cu": BITWISE_FLAGS,
              "atrous.cu": _BASE_FLAGS, "traverse_tlas.cu": BITWISE_FLAGS,
              "heightmap.cu": BITWISE_FLAGS,
              "traverse_bvh2.cu": BITWISE_FLAGS}
SOURCES = tuple(NVCC_FLAGS)

_lock = threading.Lock()
_libs: dict = {}
build_seconds = None        # wall time of the last build (set by build_all)
build_log: dict = {}        # source -> nvcc output (ptxas registers, spills),
                            # kept beside each library as <library>.log

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point; each returns cudaError_t as int
_SIGNATURES = {
    "traverse.cu": {
        "tt_traverse": [P, I, I, I, I, P, P, P, I, I, P, P, P, P, P, P],
        "tt_transmit": [P, I, I, I, I, P, I, P, P, P, I, P, P, P],
        "tt_traverse_smem": [I],
    },
    "step_core.cu": {
        "tt_step_core": [P, P, P, P, I, I, P],
    },
    "atrous.cu": {
        "tt_atrous_pass": [P, P, P, I, I, I, I, P],
        "tt_atrous_staged_ok": [I, I, I],
    },
    "traverse_tlas.cu": {
        "tt_tlas_traverse": [P, I, I, I, I, I, P, P, P, I, I, P, P, P, P, P,
                             P, P],
        "tt_tlas_transmit": [P, I, I, I, I, I, P, I, P, P, P, I, P, P, P],
        "tt_tlas_smem": [I],
    },
    "heightmap.cu": {
        "tt_heightmap": [P, P, I, I] + [F] * 10 + [P, P, P, I, I, I, I, P,
                                                    P, P, P, P],
    },
    "traverse_bvh2.cu": {
        "tt_bvh2": [P, I, I, P, P, P, I, I, I, I, P, P, P, P, P, P],
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


def _digest(src: str, csrc: str, flags: list) -> str:
    h = hashlib.sha256()
    for name in (src,) + HEADERS:
        with open(os.path.join(csrc, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:12]


def _so_path(src: str, csrc: str, flags: list) -> str:
    stem = os.path.splitext(src)[0]
    return os.path.join(BUILD_DIR, f"tt_{stem}_{_digest(src, csrc, flags)}.so")


def _start(src: str, csrc: str, flags: list):
    """Start nvcc on csrc/src with `flags` unless its library is built;
    returns (process, temporary output, library path) or None."""
    so = _so_path(src, csrc, flags)
    if os.path.exists(so):
        return None
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(csrc, src)]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT), tmp, so)


def _finish(src: str, job) -> str | None:
    """Wait for a job of _start; keep its output beside the library as
    <library>.log. Returns an error message, or None."""
    proc, tmp, so = job
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        return f"nvcc {src} failed:\n{out.decode()}"
    with open(f"{so}.log", "wb") as f:
        f.write(out)
    os.replace(tmp, so)
    return None


def _load(so: str) -> tuple:
    """(ctypes.CDLL, the nvcc output it was built with)."""
    log = ""
    if os.path.exists(f"{so}.log"):
        with open(f"{so}.log") as f:
            log = f.read()
    return ctypes.CDLL(so), log


def build_file(csrc: str, src: str, flags: list | None = None) -> tuple:
    """Build one source of another directory of kernel sources (an
    earlier version of csrc/, to time against), with `flags` or else the
    port's flags for a source of that name. Returns (ctypes.CDLL, nvcc
    output); the caller sets its argtypes."""
    flags = NVCC_FLAGS[src] if flags is None else flags
    os.makedirs(BUILD_DIR, exist_ok=True)
    job = _start(src, csrc, flags)
    if job is not None:
        err = _finish(src, job)
        if err:
            raise RuntimeError(err)
    return _load(_so_path(src, csrc, flags))


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
        jobs = {src: _start(src, CSRC, NVCC_FLAGS[src]) for src in SOURCES}
        errors = [_finish(src, job) for src, job in jobs.items()
                  if job is not None]
        if any(errors):
            raise RuntimeError("\n".join(e for e in errors if e))
        for src in SOURCES:
            lib, build_log[src] = _load(_so_path(src, CSRC,
                                                  NVCC_FLAGS[src]))
            for fn, argtypes in _SIGNATURES[src].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[src] = lib
        build_seconds = time.perf_counter() - t0
        return _libs


def lib(src: str) -> ctypes.CDLL:
    return build_all()[src]


def ptxas_report(src: str, log: str | None = None) -> dict:
    """Per kernel of `src` (mangled name -> dict), what `ptxas -v` said
    when the loaded library was built (or in the nvcc output `log`):
    registers, spill stores/loads and stack frame bytes, static shared
    memory bytes."""
    out, cur = {}, None
    for line in (build_log.get(src, "") if log is None
                 else log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), dict(
                registers=0, spill_stores=0, spill_loads=0, stack_frame=0,
                smem=0))
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            cur = out.get(m.group(1), cur)
            continue
        if cur is None:
            continue
        for key, pat in (("stack_frame", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return out


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (refused launches never
    run, and a later synchronize does not report them)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def refuse_grad(what: str, detach_site: str, *tensors) -> None:
    """Raise ValueError when a kernel wrapper is given a tensor that
    requires grad. A launch on data_ptr() (and the plain versions' integer
    views) would cut the autograd graph without a word; no kernel of the
    port is differentiated, so the caller detaches at `detach_site`."""
    if any(getattr(t, "requires_grad", False) for t in tensors):
        raise ValueError(f"{what} is not differentiated and got a tensor "
                         f"that requires grad: detach it, as {detach_site}")


def stream_ptr(t) -> int:
    """Raw handle of the current stream on t's device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
