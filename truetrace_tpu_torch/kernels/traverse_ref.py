"""Hit record and the brute-force test oracle.

Port of `truetrace_tpu/kernels/traverse_ref.py` (`Hit`,
`brute_force_closest`, `transmit_brute`); the BVH2 traversal there is not
ported (ROADMAP.md A.19).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from truetrace_tpu_torch.core.math import ray_tri


class Hit(NamedTuple):
    t: torch.Tensor        # [R] hit distance (t_max if miss)
    tri: torch.Tensor      # [R] int32 triangle id (-1 if miss)
    u: torch.Tensor        # [R] barycentric u
    v: torch.Tensor        # [R] barycentric v


def brute_force_closest(p0, e1, e2, ro, rd, t_max) -> Hit:
    """O(R*T) ground truth: every ray against every triangle."""
    h, t, u, v = ray_tri(ro[:, None, :], rd[:, None, :], p0[None], e1[None],
                         e2[None], t_max)
    t = torch.where(h, t, torch.inf)
    i = torch.argmin(t, dim=1)
    rows = torch.arange(ro.shape[0], device=ro.device)
    ti = t[rows, i]
    hit_any = torch.isfinite(ti)
    return Hit(t=torch.where(hit_any, ti, torch.as_tensor(
                   t_max, dtype=torch.float32, device=ro.device)),
               tri=torch.where(hit_any, i, -1).to(torch.int32),
               u=u[rows, i], v=v[rows, i])


def transmit_brute(p0, e1, e2, tint, ro, rd, t_max):
    """O(R*T) shadow-transmittance oracle [R,3]: the product of the shadow
    tints [T,3] of every triangle crossed before t_max (scalar or [R]),
    taken as exp of a sum of logs, 0 where the largest channel falls
    below 1e-3."""
    tm = torch.as_tensor(t_max, dtype=torch.float32,
                         device=ro.device).expand(ro.shape[0])
    h, t, _, _ = ray_tri(ro[:, None, :], rd[:, None, :], p0[None], e1[None],
                         e2[None], tm[:, None])
    crossed = h & (t < tm[:, None])
    f = torch.where(crossed[..., None], tint[None], 1.0)
    tp = torch.exp(torch.log(torch.clamp(f, min=1e-30)).sum(1))
    return torch.where(tp.amax(-1, keepdim=True) < 1e-3, 0.0, tp)
