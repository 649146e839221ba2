"""Procedural Cornell box — BASELINE config 1 test scene.

Standard Cornell geometry (white floor/ceiling/back, red left wall, green
right wall, two boxes, area light in the ceiling) in meters, y-up.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from truetrace_tpu_torch.scene.ir import Camera
from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh

WHITE = (0.73, 0.73, 0.73)
RED = (0.65, 0.05, 0.05)
GREEN = (0.12, 0.45, 0.15)

MAT_WHITE, MAT_RED, MAT_GREEN, MAT_LIGHT = 0, 1, 2, 3


def _quad(p00, p10, p11, p01):
    """Two triangles for a quad, CCW winding -> normal by right-hand rule."""
    verts = np.array([p00, p10, p11, p01], np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, idx


def _box(lo, hi, rot_y_deg=0.0, center=None):
    """Axis-aligned box (optionally rotated about y) as 12 triangles with
    outward normals."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    corners = np.array([
        [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
    ], np.float32)
    if rot_y_deg:
        c = np.cos(np.deg2rad(rot_y_deg))
        s = np.sin(np.deg2rad(rot_y_deg))
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        pivot = center if center is not None else 0.5 * (lo + hi)
        corners = (corners - pivot) @ rot.T + pivot
    faces = np.array([
        [0, 2, 1], [0, 3, 2],   # -z
        [4, 5, 6], [4, 6, 7],   # +z
        [0, 1, 5], [0, 5, 4],   # -y
        [3, 6, 2], [3, 7, 6],   # +y
        [0, 4, 7], [0, 7, 3],   # -x
        [1, 2, 6], [1, 6, 5],   # +x
    ], np.int32)
    return corners, faces


def make(light_radiance: float = 15.0, device="cuda",
         ) -> Tuple[List[HostMesh], List[HostMaterial], Camera]:
    """Build the Cornell box; the camera lives on `device`. Returns
    (meshes, materials, camera)."""
    mats = [
        HostMaterial(base_color=WHITE, roughness=1.0),
        HostMaterial(base_color=RED, roughness=1.0),
        HostMaterial(base_color=GREEN, roughness=1.0),
        HostMaterial(base_color=(0.0, 0.0, 0.0),
                     emission=(light_radiance,) * 3, roughness=1.0),
    ]

    verts_list, idx_list, mat_list = [], [], []
    off = 0

    def add(verts, idx, mat_id):
        nonlocal off
        verts_list.append(verts)
        idx_list.append(idx + off)
        mat_list.append(np.full(idx.shape[0], mat_id, np.int32))
        off += verts.shape[0]

    s = 0.5527  # box half-ish scale in meters (classic box is 552.8 units)
    # floor (y=0), normal +y
    add(*_quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0]), MAT_WHITE)
    # ceiling (y=s), normal -y
    add(*_quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s]), MAT_WHITE)
    # back wall (z=s), normal -z
    add(*_quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s]), MAT_WHITE)
    # left wall (x=s -> red in classic data the left from camera at +x)
    add(*_quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0]), MAT_RED)
    # right wall (x=0), green
    add(*_quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s]), MAT_GREEN)
    # light: quad slightly below ceiling, normal -y (faces floor)
    lx0, lx1 = 0.213, 0.343
    lz0, lz1 = 0.227, 0.332
    ly = s - 1e-3
    add(*_quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
               [lx0, ly, lz1]), MAT_LIGHT)
    # short box
    add(*_box([0.065, 0.0, 0.065], [0.230, 0.165, 0.230],
              rot_y_deg=-18.0), MAT_WHITE)
    # tall box
    add(*_box([0.290, 0.0, 0.255], [0.455, 0.330, 0.420],
              rot_y_deg=16.5), MAT_WHITE)

    mesh = HostMesh(
        positions=np.concatenate(verts_list),
        indices=np.concatenate(idx_list),
        mat_id=np.concatenate(mat_list))

    # classic Cornell camera: 800 units back from the open face (scaled)
    cam = Camera.look_at(eye=(s * 0.5, s * 0.5, -0.8),
                         target=(s * 0.5, s * 0.5, 0.0),
                         fov_y_deg=39.0, device=device)
    return [mesh], mats, cam
