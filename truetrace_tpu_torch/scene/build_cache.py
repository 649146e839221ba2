"""On-disk acceleration-structure cache for compiled scenes.

Counterpart of the reference's persisted aggregated BVH ("Build Aggregated
BVH" editor action, the reference's README.md:131 — built once in the
editor and reloaded at play time). TPU form: the pure build products of
`compile_scene` (BVH2 arrays, CWBVH nodes + packed leaf rows, light-BVH
tables) are written to one .npz keyed by a content hash of the triangle
soup + build parameters, so a second process start of a multi-million-
triangle scene skips the ~seconds of native build entirely.

The hash covers everything the cached products depend on: post-presplit
geometry bytes, per-tri material ids, material emissions (light BVH
powers), the leaf_k / flags, and a BUILD_VERSION bumped whenever any
builder's output format changes.

Enable per call (`compile_scene(..., cache_dir=...)`) or process-wide via
the TRUETRACE_BUILD_CACHE env var.

Port of `truetrace_tpu/scene/build_cache.py`: the same BUILD_VERSION, key
(SHA-256 over the same bytes), file name and npz member names, so an entry
written by either package serves the other (tests/test_torch_build_opts.py).
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict, Optional

import numpy as np

# bump when bvh2/cwbvh/pack_leaf_rows/lightbvh output formats change
BUILD_VERSION = 1


def default_cache_dir() -> Optional[str]:
    return os.environ.get("TRUETRACE_BUILD_CACHE") or None


def scene_build_key(tris: Dict[str, np.ndarray], mats,
                    leaf_k: int, with_light_bvh: bool,
                    hot_order: bool = False) -> str:
    """Content hash of every input the cached build products depend on."""
    h = hashlib.sha256()
    h.update(f"v{BUILD_VERSION};k{leaf_k};lb{int(with_light_bvh)}"
             f";h{int(hot_order)}".encode())
    for key in ("p0", "e1", "e2", "mat"):
        a = np.ascontiguousarray(tris[key])
        h.update(key.encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    emis = np.asarray([m.emission for m in mats], np.float32)
    h.update(emis.tobytes())
    return h.hexdigest()[:32]


def load_build(cache_dir: str, key: str) -> Optional[dict]:
    path = os.path.join(cache_dir, f"scene_{key}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None          # corrupt/truncated cache entry: rebuild


def save_build(cache_dir: str, key: str, products: dict) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"scene_{key}.npz")
    # atomic publish: concurrent processes never see a partial file
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **products)
        os.replace(tmp, path)
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
