"""ctypes loader for the native C++ BVH builders.

The sources are this package's own copies (`build/native/{bvh2,
cwbvh}.cpp`) of the JAX package's builders, byte for byte
(tests/test_torch_scene.py), compiled with g++ into the git-ignored
`_build/` directory with the JAX loader's flags, so both packages build
identical trees. Importing this module compiles nothing; the first large
build does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "build", "native")
BUILD_DIR = os.path.join(_PKG, "_build")
# versioned name: bump when the C ABI grows so a stale library rebuilds
_SO = os.path.join(BUILD_DIR, "libttnative_v3.so")
SOURCES = ("bvh2.cpp", "cwbvh.cpp")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def make_native() -> bool:
    """Compile the native builders into `_build/`. Returns success.

    Same flags as the JAX package's loader, so the trees match bit for
    bit. Writes to a per-process temporary name and renames it, so
    concurrent test workers never load a half-written library."""
    if os.path.exists(_SO):
        return True
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(SRC_DIR, s) for s in SOURCES]
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
           "-std=c++17", *srcs, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return False
    os.replace(tmp, _SO)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not make_native():
            return None
        lib = ctypes.CDLL(_SO)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        lib.bvh2_build.restype = ctypes.c_void_p
        lib.bvh2_build.argtypes = [
            f32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.bvh2_emit.restype = None
        lib.bvh2_emit.argtypes = [ctypes.c_void_p, f32p, i32p, i32p, i32p]
        lib.bvh2_free.restype = None
        lib.bvh2_free.argtypes = [ctypes.c_void_p]
        lib.cwbvh_build.restype = ctypes.c_void_p
        lib.cwbvh_build.argtypes = [
            f32p, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.cwbvh_emit.restype = None
        lib.cwbvh_emit.argtypes = [ctypes.c_void_p, u32p, i32p, i32p, i32p,
                                   i32p, i32p, i32p]
        lib.cwbvh_free.restype = None
        lib.cwbvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def build_bvh2_native(prim_box: np.ndarray, max_leaf: int, sah_cap: int):
    """Returns (box [N,2,3], left [N], count [N], order [T], depth), or None
    when the library cannot be built (the caller then takes the numpy
    builder, which gives the same tree)."""
    lib = _load()
    if lib is None:
        return None
    pb = np.ascontiguousarray(prim_box.reshape(-1, 6), np.float32)
    n = np.int32(pb.shape[0])
    n_nodes = ctypes.c_int32()
    depth = ctypes.c_int32()
    handle = lib.bvh2_build(pb, n, np.int32(max_leaf), np.int32(sah_cap),
                            ctypes.byref(n_nodes), ctypes.byref(depth))
    try:
        N = int(n_nodes.value)
        box = np.empty((N, 6), np.float32)
        left = np.empty(N, np.int32)
        count = np.empty(N, np.int32)
        order = np.empty(int(n), np.int32)
        lib.bvh2_emit(handle, box, left, count, order)
    finally:
        lib.bvh2_free(handle)
    return box.reshape(N, 2, 3), left, count, order, int(depth.value)


def build_cwbvh_native(box: np.ndarray, left: np.ndarray, count: np.ndarray,
                       p_max: int = 3):
    """CWBVH collapse of a BVH2. Returns (nodes [C,20] u32, tri_index [T],
    leaf_start [N2], depth, node_depth [C], slot_child [C,8],
    slot_tri_base [C,8], slot_tri_count [C,8]) or None when the library
    cannot be built."""
    lib = _load()
    if lib is None:
        return None
    boxf = np.ascontiguousarray(box.reshape(-1, 6), np.float32)
    left = np.ascontiguousarray(left, np.int32)
    count = np.ascontiguousarray(count, np.int32)
    n2 = np.int32(boxf.shape[0])
    n_nodes = ctypes.c_int32()
    n_tri = ctypes.c_int32()
    depth = ctypes.c_int32()
    handle = lib.cwbvh_build(boxf, left, count, n2, np.int32(p_max),
                             ctypes.byref(n_nodes), ctypes.byref(n_tri),
                             ctypes.byref(depth))
    try:
        Cn = int(n_nodes.value)
        T = int(n_tri.value)
        nodes = np.empty((Cn, 20), np.uint32)
        tri_index = np.empty(T, np.int32)
        leaf_start = np.empty(int(n2), np.int32)
        node_depth = np.empty(Cn, np.int32)
        slot_child = np.empty((Cn, 8), np.int32)
        slot_tri_base = np.empty((Cn, 8), np.int32)
        slot_tri_count = np.empty((Cn, 8), np.int32)
        lib.cwbvh_emit(handle, nodes, tri_index, leaf_start, node_depth,
                       slot_child.reshape(-1), slot_tri_base.reshape(-1),
                       slot_tri_count.reshape(-1))
    finally:
        lib.cwbvh_free(handle)
    return (nodes, tri_index, leaf_start, int(depth.value), node_depth,
            slot_child, slot_tri_base, slot_tri_count)
