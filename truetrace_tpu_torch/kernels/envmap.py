"""Equirect environment map: eval, importance sample, pdf (torch ops).

Port of `truetrace_tpu/kernels/envmap.py` (the reference's SampleLI +
FindInterval CDF inversion, CommonData.cginc:1423-1464, and the equirect
eval of its shade kernel). Gathers and elementwise work over the
wavefront, as the rest of the integrator.

Direction convention: y-up; theta = polar from +y, phi = atan2(z, x);
u = phi/2pi (+ rotation), v = theta/pi. Float `%` is floor-mod in JAX, so
it is `torch.remainder` here (never `torch.fmod`); `jnp.searchsorted` is
side="left", so `torch.searchsorted(right=False)`.
"""
from __future__ import annotations

import math

import torch

from truetrace_tpu_torch.scene.ir import EnvMap


def _uv(env: EnvMap, d):
    """Equirect (u, v) of directions d [R,3], and theta."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 2], d[..., 0]) - env.rotation
    u = torch.remainder(phi / (2.0 * math.pi), 1.0)
    v = torch.clamp(theta / math.pi, 0.0, 1.0 - 1e-6)
    return u, v, theta


def env_eval(env: EnvMap, d):
    """Radiance [R,3] for directions d [R,3], bilinear (azimuth wraps,
    poles clamp). env_sample/env_pdf use the piecewise-constant pdf of the
    same table, which is nonzero wherever this bilinear signal is."""
    H, W = env.image.shape[0], env.image.shape[1]
    if H == 1 and W == 1:
        return (env.image[0, 0] * env.intensity).expand(
            d.shape[:-1] + (3,))
    u, v, _ = _uv(env, d)
    fx = u * W - 0.5
    fy = v * H - 0.5
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    tx = (fx - x0.to(torch.float32))[..., None]
    ty = (fy - y0.to(torch.float32))[..., None]
    x0w = torch.remainder(x0, W)                   # azimuth wraps
    x1w = torch.remainder(x0 + 1, W)
    y0c = torch.clamp(y0, 0, H - 1)                # poles clamp
    y1c = torch.clamp(y0 + 1, 0, H - 1)
    img = env.image
    top = img[y0c, x0w] * (1 - tx) + img[y0c, x1w] * tx
    bot = img[y1c, x0w] * (1 - tx) + img[y1c, x1w] * tx
    return (top * (1 - ty) + bot * ty) * env.intensity


def env_sample(env: EnvMap, u2):
    """Importance sample a direction: (d [R,3], pdf_sa [R], radiance
    [R,3]). Continuous within the texel (PBRT's piecewise-constant 2-D
    distribution): the CDF inversion remainders place the sample
    uniformly inside the selected texel, so its density over directions
    is the pdf `env_pdf` evaluates."""
    H, W = env.image.shape[0], env.image.shape[1]
    u0, u1 = u2[..., 0].contiguous(), u2[..., 1]
    y = torch.clamp(torch.searchsorted(env.cdf_y, u0, right=False), 0, H - 1)
    cy_hi = env.cdf_y[y]
    cy_lo = torch.where(y > 0, env.cdf_y[torch.clamp(y - 1, min=0)], 0.0)
    uy = torch.clamp((u0 - cy_lo) / torch.clamp(cy_hi - cy_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    row_cdf = env.cdf_x[y]                          # [R,W]
    # the row-wise search as a count of entries below u (rows ascend)
    x = torch.clamp((row_cdf < u1[..., None]).sum(-1), 0, W - 1)
    cx_hi = torch.gather(row_cdf, -1, x[..., None])[..., 0]
    cx_lo = torch.where(
        x > 0, torch.gather(row_cdf, -1,
                            torch.clamp(x - 1, min=0)[..., None])[..., 0],
        0.0)
    ux = torch.clamp((u1 - cx_lo) / torch.clamp(cx_hi - cx_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    theta = math.pi * (y.to(torch.float32) + uy) / H
    phi = 2.0 * math.pi * (x.to(torch.float32) + ux) / W + env.rotation
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                     sin_t * torch.sin(phi)], -1)
    rad = env_eval(env, d)
    texel = env.image[y, x]
    lum = (0.2126 * texel[..., 0] + 0.7152 * texel[..., 1]
           + 0.0722 * texel[..., 2])
    # solid-angle pdf: the tables weight texels by sin(theta) at the row
    # centre; the in-texel uniform density maps through 1/sin(theta)
    sin_c = torch.sin(math.pi * (y.to(torch.float32) + 0.5) / H)
    pdf = (lum / torch.clamp(env.total, min=1e-20)
           * sin_c / torch.clamp(sin_t, min=1e-6))
    return d, pdf, rad


def env_pdf(env: EnvMap, d):
    """Solid-angle pdf with which env_sample would generate direction d:
    the MIS weight of a BSDF ray that escapes to the sky."""
    H, W = env.image.shape[0], env.image.shape[1]
    if H == 1 and W == 1:
        return torch.zeros(d.shape[:-1], dtype=torch.float32,
                           device=d.device)
    u, v, theta = _uv(env, d)
    x = torch.clamp((u * W).to(torch.int64), 0, W - 1)
    y = torch.clamp((v * H).to(torch.int64), 0, H - 1)
    img = env.image[y, x]
    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
           + 0.0722 * img[..., 2])
    sin_c = torch.sin(math.pi * (y.to(torch.float32) + 0.5) / H)
    sin_t = torch.clamp(torch.sin(theta), min=1e-6)
    return lum / torch.clamp(env.total, min=1e-20) * sin_c / sin_t
