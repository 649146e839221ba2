"""Core math primitives for the torch port (the subset the frame uses).

Port of `truetrace_tpu/core/math.py`. Arrays are [..., 3]. Reductions
over the last axis of length 3 are written out left to right, which is
the order XLA uses, so the results round the same way as the JAX ones.
"""
from __future__ import annotations

import math

import torch

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(v, eps: float = 1e-20):
    return v * torch.rsqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def luminance(rgb):
    """Rec.709 luminance."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722


def onb(n):
    """Branchless orthonormal basis (Duff et al. 2017). Returns (t, b)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], -1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def to_world(n, v_local):
    """Rotate a tangent-space vector (z = normal) into world space."""
    t, b = onb(n)
    return (v_local[..., 0:1] * t + v_local[..., 1:2] * b
            + v_local[..., 2:3] * n)


def to_local(n, v_world):
    t, b = onb(n)
    return torch.stack([dot(v_world, t), dot(v_world, b), dot(v_world, n)],
                       -1)


def power_heuristic(pdf_a, pdf_b):
    """Veach power heuristic (beta=2) with clamped pdfs."""
    a = torch.clamp(pdf_a, 0.0, 1e8)
    b = torch.clamp(pdf_b, 0.0, 1e8)
    a2 = a * a
    return a2 / torch.clamp(a2 + b * b, min=1e-20)


def sample_cosine_hemisphere(u):
    """u [...,2] -> cosine-weighted tangent-space direction (z-up)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - u[..., 0], min=0.0))
    return torch.stack([x, y, z], -1)


def ray_tri(ro, rd, p0, e1, e2, t_max):
    """Moller-Trumbore against edge-form triangles. Returns (hit, t, u, v)."""
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = ro - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 1e-4) & (t < t_max) & (det.abs() > 1e-12))
    return hit, t, u, v


def finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def fma(a, b, c):
    """a * b + c rounded once to float32, as XLA:CPU computes the mul-adds
    it contracts (its LLVM backend always allows FMA fusion) and as the
    CUDA kernels' __fmaf_rn does.

    The product of two float32 values is exact in float64. The float64
    sum is made round-to-odd (TwoSum gives its exact error; an inexact
    sum with an even last bit moves one ulp towards the error), and a
    round-to-odd result with 29 spare bits rounds to float32 exactly as
    the exact sum would, so there is no double-rounding error."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    fix = (err != 0) & ((bits & 1) == 0)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


# sqrt(1/3) rounded to float32, made once on the CPU: an exact float32
# value, so `_SQRT_THIRD * s` rounds as the 0-d tensor product did
_SQRT_THIRD = float(torch.sqrt(torch.tensor(1.0 / 3.0, dtype=torch.float32)))


def hue_rotate(rgb, degrees):
    """Rotate RGB hue around the grey axis by `degrees` [...] (the
    reference's Unity_Hue_Degrees, RayTracingShader.compute:640)."""
    th = torch.deg2rad(degrees)
    c = torch.cos(th)
    s = torch.sin(th)
    one3 = (1.0 - c) / 3.0
    rt3s = _SQRT_THIRD * s
    m00 = c + one3
    m01 = one3 - rt3s
    m02 = one3 + rt3s
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack([m00 * r + m01 * g + m02 * b,
                        m02 * r + m00 * g + m01 * b,
                        m01 * r + m02 * g + m00 * b], -1)


def adjust_color(rgb, hue_deg, brightness, saturation, contrast,
                 blend_color, blend_factor):
    """The reference's albedo adjustment chain (kernel_shade,
    RayTracingShader.compute:630-649): hue -> brightness -> saturation ->
    contrast -> saturate -> blend toward a flat colour."""
    c = hue_rotate(rgb, hue_deg)
    c = c * brightness[..., None]
    lum = luminance(c)[..., None]
    c = lum + (c - lum) * saturation[..., None]
    c = (c - 0.5) * contrast[..., None] + 0.5
    c = torch.clamp(c, 0.0, 1.0)
    return c + (blend_color - c) * blend_factor[..., None]
