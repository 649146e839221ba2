"""AABB helper of the host-side build (numpy).

Port of `truetrace_tpu/core/aabb.py` `from_tris`, the part the port's
`compile_scene` uses. Boxes are [..., 2, 3]: mins then maxs.
"""
from __future__ import annotations

import numpy as np


def from_tris(p0, p1, p2):
    """Per-triangle AABBs from three vertex arrays [N,3] -> [N,2,3]."""
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    return np.stack([lo, hi], axis=-2)
