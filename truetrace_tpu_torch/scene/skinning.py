"""Linear-blend skinning feeding the CWBVH refit (torch ops).

Port of `truetrace_tpu/scene/skinning.py`: bone palette matrices times
vertex weights -> deformed vertices -> edge-form triangles, which
`build/refit.py refit_cwbvh` requantises the CWBVH for. The JAX
`skin_vertices` runs under jit, where XLA:CPU contracts the mul-adds of
its small matrix products and of the weighted sum; the port writes those
as `core.math.fma`, so the deformed vertices are the JAX bits
(tests/test_torch_dynamic.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from truetrace_tpu_torch.core.math import fma


class SkinnedMesh(NamedTuple):
    """Static skinning data on the device."""
    rest_verts: torch.Tensor   # [V,3] bind-pose positions
    bone_idx: torch.Tensor     # [V,4] int64
    bone_w: torch.Tensor       # [V,4] weights (sum to 1)
    tri_vidx: torch.Tensor     # [F,3] int64 triangle -> vertex ids
    inv_bind: torch.Tensor     # [B,3,4] inverse bind matrices (rows)


def make_two_bone_cylinder(n_radial=16, n_height=24, radius=0.3,
                           height=2.0, device="cuda") -> SkinnedMesh:
    """Test asset: a cylinder skinned to 2 bones (root + tip), weights
    blended along the height, the classic bend-test mesh. As in the JAX
    package every vertex names bones 0-3 with zero weight on 2 and 3;
    `skin_vertices` clamps those indices to the last bone."""
    from truetrace_tpu_torch.scene.primitives import cylinder
    v, idx, _ = cylinder(n_radial, n_height, radius, height, cap=True)
    V = v.shape[0]
    t = np.clip(v[:, 1] / height, 0.0, 1.0)
    w1 = np.clip((t - 0.25) / 0.5, 0.0, 1.0)
    bone_w = np.stack([1.0 - w1, w1, np.zeros(V), np.zeros(V)], axis=-1)
    bone_idx = np.broadcast_to(np.array([0, 1, 2, 3], np.int64), (V, 4))
    inv_bind = np.zeros((2, 3, 4), np.float32)
    inv_bind[0, :, :3] = np.eye(3)
    inv_bind[1, :, :3] = np.eye(3)
    inv_bind[1, 1, 3] = -height * 0.5     # bone 1 origin at half height
    t_ = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=device)
    return SkinnedMesh(rest_verts=t_(v, torch.float32),
                       bone_idx=t_(bone_idx, torch.int64),
                       bone_w=t_(bone_w.astype(np.float32), torch.float32),
                       tri_vidx=t_(idx, torch.int64),
                       inv_bind=t_(inv_bind, torch.float32))


def bone_matrix(rot_axis, angle, translate, device="cuda") -> torch.Tensor:
    """[3,4] bone transform from axis-angle + translation (Rodrigues).
    `angle` may be a 0-d tensor on the device (then nothing is copied
    from the host)."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    a = f(rot_axis)
    a = a / torch.clamp(torch.linalg.norm(a), min=1e-9)
    angle = f(angle)
    c, s = torch.cos(angle), torch.sin(angle)
    x, y, z = a[0], a[1], a[2]
    R = torch.stack([
        torch.stack([c + x * x * (1 - c), x * y * (1 - c) - z * s,
                     x * z * (1 - c) + y * s]),
        torch.stack([y * x * (1 - c) + z * s, c + y * y * (1 - c),
                     y * z * (1 - c) - x * s]),
        torch.stack([z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                     c + z * z * (1 - c)])])
    return torch.cat([R, f(translate)[:, None]], 1)


def _dot_fma(a, b):
    """sum_k a[..., k] * b[..., k] as XLA:CPU's contracted dot: the first
    product rounded, each later one fused into the running sum."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = fma(a[..., k], b[..., k], acc)
    return acc


def skin_vertices(mesh: SkinnedMesh, bones: torch.Tensor) -> torch.Tensor:
    """bones [B,3,4] world transforms. Returns deformed verts [V,3].

    An out-of-range bone index is clamped to [0, B-1] (a negative one
    counts from the end first), as XLA's gather clamps it; its term still
    enters the weighted sum, times its weight."""
    B = bones.shape[0]
    inv = mesh.inv_bind[:B]
    # palette = bone_world @ inv_bind (two [3,4] row transforms composed)
    R = torch.stack([torch.stack([_dot_fma(bones[:, i, :3], inv[:, :3, j])
                                  for j in range(3)], -1)
                     for i in range(3)], 1)
    t = torch.stack([_dot_fma(bones[:, i, :3], inv[:, :3, 3])
                     for i in range(3)], -1) + bones[:, :, 3]
    palette = torch.cat([R, t[..., None]], -1)                 # [B,3,4]
    idx = mesh.bone_idx
    idx = torch.clamp(torch.where(idx < 0, idx + B, idx), 0, B - 1)
    pal = palette[idx]                                         # [V,4,3,4]
    v = mesh.rest_verts
    v_h = torch.cat([v, torch.ones_like(v[:, :1])], -1)[:, None, None, :]
    per_bone = _dot_fma(pal, v_h)                              # [V,4,3]
    return _dot_fma(per_bone.transpose(1, 2), mesh.bone_w[:, None, :])


def skinned_tris(mesh: SkinnedMesh, bones: torch.Tensor):
    """Deformed edge-form triangles (p0, e1, e2) ready for refit_cwbvh."""
    v = skin_vertices(mesh, bones)
    p0 = v[mesh.tri_vidx[:, 0]]
    p1 = v[mesh.tri_vidx[:, 1]]
    p2 = v[mesh.tri_vidx[:, 2]]
    return p0, p1 - p0, p2 - p0
