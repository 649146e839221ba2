"""SVGF denoiser: temporal accumulation + variance-guided a-trous filter.

Port of `truetrace_tpu/post/svgf.py`. State is an explicit dataclass
threaded through frames. The a-trous passes run the Hopper kernel on
CUDA tensors at every frame size, on planes packed once a frame
(kernels/atrous_pallas.atrous_filter).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from truetrace_tpu_torch.core.math import dot, luminance

ALPHA_COLOR = 0.2
ALPHA_MOMENTS = 0.2
SIGMA_Z = 1.0
SIGMA_N = 128.0
SIGMA_L = 4.0
# the 7x7 spatial-variance weights exp(-r2 / 8) by squared radius r2, in
# float32, made once on the CPU; exact float32 values, so `x * k` rounds
# as the product with a 0-d float32 tensor did
_SPATIAL_W = {r2: float(torch.exp(torch.tensor(-0.5 * r2 / 4.0,
                                                 dtype=torch.float32)))
              for r2 in range(19)}


@dataclass
class SVGFState:
    color: torch.Tensor      # [H,W,3] filtered history (demodulated)
    moments: torch.Tensor    # [H,W,2] first/second luminance moments
    hist_len: torch.Tensor   # [H,W]
    normal: torch.Tensor     # [H,W,3]
    depth: torch.Tensor      # [H,W]

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "SVGFState":
        z = lambda *s: torch.zeros((h, w) + s, device=device)
        return SVGFState(color=z(3), moments=z(2), hist_len=z(),
                         normal=z(3), depth=z())

    @staticmethod
    def from_numpy(d: dict, device) -> "SVGFState":
        return SVGFState(**{k: torch.from_numpy(d[k].copy()).to(device)
                            for k in ("color", "moments", "hist_len",
                                      "normal", "depth")})


def _shift(img, dy, dx):
    """out[y, x] = img[y - dy, x - dx], cyclic (jnp.roll)."""
    return torch.roll(img, shifts=(dy, dx), dims=(0, 1))


def _edge_weights(normal, depth, lum, var, dy, dx, step):
    """Edge-stopping weights against the (dy,dx)-shifted neighbour."""
    n_q = _shift(normal, dy, dx)
    z_q = _shift(depth, dy, dx)
    l_q = _shift(lum, dy, dx)
    w_n = torch.pow(torch.clamp(dot(normal, n_q), min=0.0), SIGMA_N)
    dz = (depth - z_q).abs()
    w_z = torch.exp(-dz / (SIGMA_Z * abs(step) * (depth.abs() * 0.02 + 1e-2)
                           + 1e-8))
    w_l = torch.exp(-(lum - l_q).abs()
                    / (SIGMA_L * torch.sqrt(torch.clamp(var, min=1e-10))
                       + 1e-8))
    return w_n * w_z * w_l


# 5x5 B3-spline a-trous kernel (separable 1/16,1/4,3/8,1/4,1/16)
_K1D = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)


def _var_prefilter3(var):
    """3x3 (1,2,1)^2 prefilter of the variance for the luminance sigma."""
    acc = torch.zeros_like(var)
    wsum = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            k = (2.0 if dy == 0 else 1.0) * (2.0 if dx == 0 else 1.0)
            acc = acc + _shift(var, dy, dx) * k
            wsum += k
    return acc / wsum


def _atrous_pass(color, var, normal, depth, step: int):
    lum = luminance(color)
    var_w = _var_prefilter3(var)
    acc_c = torch.zeros_like(color)
    acc_v = torch.zeros_like(var)
    acc_w = torch.zeros_like(var)
    for i, ky in enumerate(_K1D):
        for j, kx in enumerate(_K1D):
            dy = (i - 2) * step
            dx = (j - 2) * step
            k = ky * kx
            if dy == 0 and dx == 0:
                w = torch.full_like(var, k)
            else:
                w = _edge_weights(normal, depth, lum, var_w, dy, dx,
                                  step) * k
            acc_c = acc_c + _shift(color, dy, dx) * w[..., None]
            acc_v = acc_v + _shift(var, dy, dx) * (w * w)
            acc_w = acc_w + w
    inv = 1.0 / torch.clamp(acc_w, min=1e-8)
    return acc_c * inv[..., None], acc_v * inv * inv


def svgf_denoise(noisy, albedo, normal, depth, state: SVGFState,
                 n_atrous: int = 5, motion: Optional[torch.Tensor] = None,
                 alpha_map: Optional[torch.Tensor] = None,
                 emissive: Optional[torch.Tensor] = None):
    """One frame of SVGF. Returns (denoised [H,W,3], new_state).

    motion: [H,W,2] pixel offsets (None = static); alpha_map: [H,W]
    per-pixel temporal blend that replaces the fixed alphas and caps the
    history length at 1 / alpha (ASVGF's gradients drive it,
    post/asvgf.py); emissive: noise-free directly visible radiance,
    passed through unfiltered."""
    from truetrace_tpu_torch.kernels.atrous_pallas import atrous_filter
    if emissive is not None:
        noisy = torch.clamp(noisy - emissive, min=0.0)
    # demodulate albedo (floor 0.05, the same floor as the re-modulation)
    demod = noisy / torch.clamp(albedo, min=0.05)
    lum = luminance(demod)

    # ---- temporal reprojection + validity (normal/depth similarity gate)
    prev_color, prev_moments, prev_len = (state.color, state.moments,
                                          state.hist_len)
    if motion is not None:
        H, W = depth.shape
        dev = depth.device
        ys = torch.clamp(torch.round(
            torch.arange(H, device=dev)[:, None] - motion[..., 1]).to(
                torch.int64), 0, H - 1)
        xs = torch.clamp(torch.round(
            torch.arange(W, device=dev)[None, :] - motion[..., 0]).to(
                torch.int64), 0, W - 1)
        prev_color = prev_color[ys, xs]
        prev_moments = prev_moments[ys, xs]
        prev_len = prev_len[ys, xs]
        prev_n = state.normal[ys, xs]
        prev_z = state.depth[ys, xs]
    else:
        prev_n, prev_z = state.normal, state.depth
    valid = ((dot(normal, prev_n) > 0.9)
             & ((depth - prev_z).abs() < 0.1 * torch.clamp(depth, min=1e-3))
             & (prev_len > 0))

    hist_len = torch.where(valid, prev_len + 1.0, 1.0)
    if alpha_map is None:
        a_c = torch.clamp(1.0 / hist_len, min=ALPHA_COLOR)
        a_m = torch.clamp(1.0 / hist_len, min=ALPHA_MOMENTS)
    else:
        hist_len = torch.minimum(
            hist_len, 1.0 / torch.clamp(alpha_map, min=1e-3))
        a_c = a_m = torch.maximum(alpha_map, 1.0 / hist_len)
    color_t = torch.where(valid[..., None],
                          prev_color + a_c[..., None] * (demod - prev_color),
                          demod)
    mom = torch.stack([lum, lum * lum], -1)
    moments_t = torch.where(valid[..., None],
                            prev_moments + a_m[..., None]
                            * (mom - prev_moments), mom)

    # RCRS firefly clamp on the temporally integrated signal, gated on
    # short history (< 4 frames)
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _shift(color_t, dy, dx)
            nmax = n if nmax is None else torch.maximum(nmax, n)
    color_t = torch.where((hist_len < 4.0)[..., None],
                          torch.minimum(color_t, nmax * 3.0 + 1e-3), color_t)

    # variance: temporal when history is long enough, else 7x7 spatial
    var_t = torch.clamp(moments_t[..., 1] - moments_t[..., 0] ** 2, min=0.0)
    sp_m = torch.zeros_like(moments_t)
    sp_w = torch.zeros_like(lum)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            k = _SPATIAL_W[dy * dy + dx * dx]
            sp_m = sp_m + _shift(mom, dy, dx) * k
            sp_w = sp_w + k
    sp_m = sp_m / sp_w[..., None]
    var_sp = torch.clamp(sp_m[..., 1] - sp_m[..., 0] ** 2, min=0.0)
    var = torch.where(hist_len >= 4.0, var_t, var_sp)

    # ---- a-trous iterations; the first filtered result feeds the history
    new_hist_color, color_f, _ = atrous_filter(color_t, var, normal, depth,
                                               n_atrous)

    out = color_f * torch.clamp(albedo, min=0.05)
    if emissive is not None:
        out = out + emissive
    return out, SVGFState(color=new_hist_color, moments=moments_t,
                          hist_len=hist_len, normal=normal, depth=depth)
