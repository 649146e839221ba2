"""ReCur denoiser: the reference author's recurrent denoiser.

Port of `truetrace_tpu/post/recur.py`: SSAO from the depth G-buffer and
its edge-aware blur, a reprojected temporal pass with a 3x3 min/max
clamp, a three-scale edge-stopping blur whose strength falls as history
converges (its output is next frame's history), a slower secondary
accumulator, and the re-modulation by albedo and AO. Every pass is a
whole-image stencil of torch ops (`torch.roll`), as the JAX passes are
XLA ops. State is an explicit dataclass threaded through frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from truetrace_tpu_torch.core.math import dot, luminance
from truetrace_tpu_torch.post.svgf import _shift

ALPHA_MAIN = 0.15
ALPHA_SECOND = 0.05
SSAO_RADIUS = 0.15       # fraction of depth
SSAO_TAPS = 8
SIGMA_N = 64.0
SIGMA_Z = 8.0


@dataclass
class ReCurState:
    color: torch.Tensor      # [H,W,3] primary history (demodulated)
    second: torch.Tensor     # [H,W,3] secondary history
    hist_len: torch.Tensor   # [H,W]
    normal: torch.Tensor     # [H,W,3]
    depth: torch.Tensor      # [H,W]
    ao: torch.Tensor         # [H,W] AO history

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "ReCurState":
        z = lambda *s: torch.zeros((h, w) + s, device=device)
        return ReCurState(color=z(3), second=z(3), hist_len=z(),
                          normal=z(3), depth=z(),
                          ao=torch.ones((h, w), device=device))

    @staticmethod
    def from_numpy(d: dict, device) -> "ReCurState":
        return ReCurState(**{k: torch.from_numpy(d[k].copy()).to(device)
                             for k in ("color", "second", "hist_len",
                                       "normal", "depth", "ao")})


def _ssao(normal, depth):
    """Screen-space AO: nearer neighbours at 8 fixed offsets (the radius
    doubling on the last four) occlude."""
    ao = torch.zeros_like(depth)
    offs = [(1, 0), (0, 1), (-1, 0), (0, -1),
            (2, 2), (-2, 2), (2, -2), (-2, -2)][:SSAO_TAPS]
    for i, (dy, dx) in enumerate(offs):
        s = 1 + (i // 4)
        dz = depth - _shift(depth, dy * s, dx * s)
        r = SSAO_RADIUS * torch.clamp(depth, min=1e-3)
        ao = ao + torch.clamp(dz / r, 0.0, 1.0) * (dz > 1e-4)
    return torch.clamp(1.0 - ao / float(len(offs)), 0.0, 1.0)


def _ssao_filter(ao, normal, depth):
    """Edge-aware 5x5 AO blur."""
    acc = torch.zeros_like(ao)
    wacc = torch.zeros_like(ao)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            w_n = torch.clamp(dot(normal, _shift(normal, dy, dx)),
                              min=0.0) ** 8
            w_z = torch.exp(-(depth - _shift(depth, dy, dx)).abs()
                            / (0.05 * torch.clamp(depth, min=1e-3) + 1e-4))
            w = w_n * w_z
            acc = acc + _shift(ao, dy, dx) * w
            wacc = wacc + w
    return acc / torch.clamp(wacc, min=1e-6)


def _neighborhood_clamp(hist, cur):
    """3x3 min/max clamp of history against the current frame."""
    lo = hi = cur
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            q = _shift(cur, dy, dx)
            lo = torch.minimum(lo, q)
            hi = torch.maximum(hi, q)
    return torch.minimum(torch.maximum(hist, lo), hi)


def _edge_blur(color, normal, depth, hist_len, step: int):
    """Edge-stopping 3x3 blur at `step`, faded out as history converges."""
    conv = torch.clamp(hist_len / 32.0, 0.0, 1.0)   # 0 young, 1 converged
    acc = torch.zeros_like(color)
    wacc = torch.zeros_like(depth)
    lum = luminance(color)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            sy, sx = dy * step, dx * step
            if dy == 0 and dx == 0:
                w = torch.ones_like(depth)
            else:
                w_n = torch.pow(torch.clamp(
                    dot(normal, _shift(normal, sy, sx)), min=0.0), SIGMA_N)
                w_z = torch.exp(-(depth - _shift(depth, sy, sx)).abs()
                                / (torch.clamp(depth, min=1e-3) * 0.05
                                   * step + 1e-4))
                w_l = torch.exp(-(lum - _shift(lum, sy, sx)).abs()
                                / (0.5 + 4.0 * (1.0 - conv)))
                w = w_n * w_z * w_l
            acc = acc + _shift(color, sy, sx) * w[..., None]
            wacc = wacc + w
    blurred = acc / torch.clamp(wacc, min=1e-6)[..., None]
    return blurred * (1.0 - conv)[..., None] + color * conv[..., None]


def recur_denoise(noisy, albedo, normal, depth, state: ReCurState,
                  motion: Optional[torch.Tensor] = None,
                  emissive: Optional[torch.Tensor] = None):
    """One ReCur frame. Returns (denoised [H,W,3], new_state).

    motion: [H,W,2] pixel offsets (None = static); emissive: noise-free
    directly visible radiance, passed through unfiltered (the albedo
    floor 0.05 is svgf.py's)."""
    if emissive is not None:
        noisy = torch.clamp(noisy - emissive, min=0.0)
    demod = noisy / torch.clamp(albedo, min=0.05)

    # ---- reproject history (nearest)
    prev = [state.color, state.second, state.hist_len, state.normal,
            state.depth, state.ao]
    if motion is not None:
        H, W = depth.shape
        dev = depth.device
        ys = torch.clamp(torch.round(
            torch.arange(H, device=dev)[:, None] - motion[..., 1]).to(
                torch.int64), 0, H - 1)
        xs = torch.clamp(torch.round(
            torch.arange(W, device=dev)[None, :] - motion[..., 0]).to(
                torch.int64), 0, W - 1)
        prev = [x[ys, xs] for x in prev]
    prev_color, prev_second, prev_len, prev_n, prev_z, prev_ao = prev
    valid = ((dot(normal, prev_n) > 0.9)
             & ((depth - prev_z).abs() < 0.1 * torch.clamp(depth, min=1e-3))
             & (prev_len > 0))
    hist_len = torch.where(valid, prev_len + 1.0, 1.0)

    # ---- SSAO, its blur and its own small temporal
    ao = _ssao_filter(_ssao(normal, depth), normal, depth)
    ao = torch.where(valid, prev_ao * 0.9 + ao * 0.1, ao)

    # ---- primary temporal with the neighbourhood clamp
    a = torch.clamp(1.0 / hist_len, min=ALPHA_MAIN)[..., None]
    clamped = _neighborhood_clamp(prev_color, demod)
    color_t = torch.where(valid[..., None],
                          clamped + a * (demod - clamped), demod)

    # ---- recurrent blur ladder (3 scales)
    color_b = color_t
    for i in range(3):
        color_b = _edge_blur(color_b, normal, depth, hist_len, 1 << i)

    # ---- secondary temporal on the blurred result
    a2 = torch.clamp(1.0 / hist_len, min=ALPHA_SECOND)[..., None]
    second = torch.where(valid[..., None],
                         prev_second + a2 * (color_b - prev_second), color_b)

    out = second * torch.clamp(albedo, min=0.05) * ao[..., None]
    if emissive is not None:
        out = out + emissive
    return out, ReCurState(color=color_b, second=second, hist_len=hist_len,
                           normal=normal, depth=depth, ao=ao)
