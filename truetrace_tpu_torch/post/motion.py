"""Camera motion vectors for temporal reprojection.

Port of `truetrace_tpu/post/motion.py` (camera-only vectors; per-object
motion of instanced scenes is ROADMAP.md A.14). Each pixel's world
position is rebuilt from the current camera ray and its depth, projected
into the previous camera, and reported as the pixel offset (cur - prev).
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
