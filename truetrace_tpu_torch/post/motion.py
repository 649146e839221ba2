"""Motion vectors for temporal reprojection.

Port of `truetrace_tpu/post/motion.py`. Each pixel's world position is
rebuilt from the current camera ray and its depth, projected into the
previous camera, and reported as the pixel offset (cur - prev). On an
instanced scene, a pixel whose primary hit lies on an instance is first
carried back through that instance's previous transform (per-object
motion).
"""
from __future__ import annotations

import torch

from truetrace_tpu_torch.scene.ir import Camera


def world_from_depth(cam: Camera, depth: torch.Tensor):
    """World positions [H,W,3] from hit distances along the centre rays."""
    H, W = depth.shape
    dev = depth.device
    x = (torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5) \
        / W * 2.0 - 1.0
    y = 1.0 - (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
               + 0.5) / H * 2.0
    tan_half = torch.tan(cam.fov_y * 0.5)
    aspect = W / H
    vx = x * tan_half * aspect
    vy = y * tan_half
    d = (vx[..., None] * cam.c2w[0, :3] + vy[..., None] * cam.c2w[1, :3]
         - cam.c2w[2, :3].expand(H, W, 3))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return cam.c2w[3, :3] + d * depth[..., None]


def project(cam: Camera, p: torch.Tensor, width: int, height: int):
    """World -> pixel coordinates (x, y) + in-front flag for `cam`."""
    rel = p - cam.c2w[3, :3]
    cx = (rel * cam.c2w[0, :3]).sum(-1)
    cy = (rel * cam.c2w[1, :3]).sum(-1)
    cz = (rel * cam.c2w[2, :3]).sum(-1)     # +back; in front => cz < 0
    tan_half = torch.tan(cam.fov_y * 0.5)
    aspect = width / height
    z = torch.clamp(-cz, min=1e-6)
    ndc_x = cx / (z * tan_half * aspect)
    ndc_y = cy / (z * tan_half)
    px = (ndc_x + 1.0) * 0.5 * width - 0.5
    py = (1.0 - ndc_y) * 0.5 * height - 0.5
    return px, py, cz < 0


def motion_vectors(prev_cam: Camera, cam: Camera, depth: torch.Tensor):
    """Per-pixel motion [H,W,2] = (dx, dy): history lives at (x-dx, y-dy).
    Pixels behind the previous camera or without a hit get 1e4."""
    H, W = depth.shape
    dev = depth.device
    p = world_from_depth(cam, depth)
    px, py, ok = project(prev_cam, p, W, H)
    cur_x = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    cur_y = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    keep = ok & (depth > 0)
    dx = torch.where(keep, cur_x - 0.5 - px, 1e4)
    dy = torch.where(keep, cur_y - 0.5 - py, 1e4)
    return torch.stack([dx, dy], -1)


def _inv3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of [I,3,3] matrices by the adjugate: elementwise work
    only, so no solver launch and no error check that reads the card back
    (torch.linalg.inv's)."""
    c = lambda i, j: m[:, i % 3, j % 3]
    cof = torch.stack([torch.stack([
        c(i + 1, j + 1) * c(i + 2, j + 2) - c(i + 1, j + 2) * c(i + 2, j + 1)
        for j in range(3)], -1) for i in range(3)], -2)      # cofactors
    det = (m[:, 0] * cof[:, 0]).sum(-1)
    return cof.transpose(1, 2) / det[:, None, None]


def object_motion_transforms(l2w_prev: torch.Tensor, l2w_cur: torch.Tensor):
    """Per-instance [I,3,4] transforms taking a current-frame world point
    on instance i to its previous-frame position: l2w_prev_i o
    inv(l2w_cur_i), in the 3x4 row layout (scene/instances.py _mat34)."""
    A_cur = l2w_cur[:, :, :3]
    A_prev = l2w_prev[:, :, :3]
    A = torch.einsum("iab,ibc->iac", A_prev, _inv3(A_cur))
    t = l2w_prev[:, :, 3] - torch.einsum("iab,ib->ia", A, l2w_cur[:, :, 3])
    return torch.cat([A, t[..., None]], -1)


def motion_vectors_objects(prev_cam: Camera, cam: Camera,
                           depth: torch.Tensor, inst: torch.Tensor,
                           l2w_prev: torch.Tensor, l2w_cur: torch.Tensor):
    """Per-pixel motion [H,W,2] with per-object motion: pixels whose
    primary hit lies on instance i (inst >= 0, the integrator's "inst"
    stat) are carried back through instance i's previous transform before
    the projection into the previous camera."""
    H, W = depth.shape
    dev = depth.device
    p = world_from_depth(cam, depth)
    M = object_motion_transforms(l2w_prev, l2w_cur)
    mi = M[torch.clamp(inst, 0, M.shape[0] - 1)]            # [H,W,3,4]
    p_obj = torch.einsum("hwab,hwb->hwa", mi[..., :3], p) + mi[..., 3]
    p = torch.where((inst >= 0)[..., None], p_obj, p)
    px, py, ok = project(prev_cam, p, W, H)
    cur_x = torch.arange(W, dtype=torch.float32, device=dev)[None, :] + 0.5
    cur_y = torch.arange(H, dtype=torch.float32, device=dev)[:, None] + 0.5
    keep = ok & (depth > 0)
    dx = torch.where(keep, cur_x - 0.5 - px, 1e4)
    dy = torch.where(keep, cur_y - 0.5 - py, 1e4)
    return torch.stack([dx, dy], -1)
