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


def cross_fma(a, b):
    """cross(a, b) as jnp.cross compiles on XLA:CPU: each component's
    first product fused into the difference, fma(a1, b2, -(a2 * b1))."""
    return torch.stack([fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                        fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                        fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))],
                       -1)


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


def dot_fma(a, b):
    """dot(a, b) as XLA:CPU compiles jnp.sum(a * b, -1) inside the BVH2
    traversal loop: a reduce from 0 whose every product is fused into the
    running sum, fma(a2, b2, fma(a1, b1, fma(a0, b0, 0)))."""
    s = a[..., 0] * b[..., 0] + 0.0
    s = fma(a[..., 1], b[..., 1], s)
    return fma(a[..., 2], b[..., 2], s)


def ray_tri_fma(ro, rd, p0, e1, e2, t_max):
    """ray_tri with the mul-adds XLA:CPU contracts in the BVH2 traversal
    loop (truetrace_tpu/kernels/traverse_ref.py `_traverse`): the two
    cross products as cross_fma, the four dot products as dot_fma; the
    three scalings by 1/det and u + v stay plain (their products have
    other uses). Returns (hit, t, u, v)."""
    pvec = cross_fma(rd, e2)
    det = dot_fma(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvec = ro - p0
    u = dot_fma(tvec, pvec) * inv_det
    qvec = cross_fma(tvec, e1)
    v = dot_fma(rd, qvec) * inv_det
    t = dot_fma(e2, qvec) * inv_det
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > 1e-4) & (t < t_max) & (det.abs() > 1e-12))
    return hit, t, u, v


def ray_aabb(ro, inv_rd, bmin, bmax, t_max):
    """Slab test against boxes [..., 3]: (hit, t_near). Minima and maxima
    propagate NaN, as XLA's do."""
    t0 = (bmin - ro) * inv_rd
    t1 = (bmax - ro) * inv_rd
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    hit = (t_far >= torch.clamp_min(t_near, 0.0)) & (t_near < t_max)
    return hit, t_near


def finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi): torch.clamp's value, with JAX's gradient at
    a bound (lax.max and lax.min split a tie's cotangent in half, where
    torch.clamp passes all of it), so a parameter that sits on a bound
    (metallic 0, roughness 1) gets the JAX package's gradient. Without
    grad it is torch.clamp alone."""
    y = torch.clamp(x, lo, hi)
    if not x.requires_grad:
        return y
    tie = ((x == lo) | (x == hi)).to(x.dtype)
    return y - 0.5 * tie * (x - x.detach())


def safe_div(a, b, eps: float = 1e-20):
    """a / b with |b| raised to eps, keeping its sign (b = 0 counts as
    positive)."""
    return a / torch.where(b.abs() < eps, torch.where(b >= 0, eps, -eps), b)


def sqrt_rn(x):
    """float32 sqrt rounded to nearest, as XLA:CPU and CUDA's sqrtf give
    it. torch.sqrt on a CPU float32 tensor is not correctly rounded (its
    vectorised kernel misses the nearest value on ~0.7% of inputs); the
    square root of the exact float64 value, rounded once to float32, is
    (float64 carries more than twice float32's precision)."""
    return torch.sqrt(x.double()).float()


_LIBM = None


def _libm_f32(name: str, x, *args):
    """The C library's float function `name` of a float32 CPU tensor x
    (and float arguments), value by value. A tensor on another device
    raises: it is never moved to the host."""
    global _LIBM
    if x.device.type != "cpu":
        raise ValueError(f"{name}_libm is a host bake's helper: x is on "
                         f"{x.device}, not the CPU")
    import ctypes
    import ctypes.util
    if _LIBM is None:
        _LIBM = ctypes.CDLL(ctypes.util.find_library("m"))
        for fn, n in (("powf", 2), ("sinf", 1), ("cosf", 1)):
            getattr(_LIBM, fn).restype = ctypes.c_float
            getattr(_LIBM, fn).argtypes = [ctypes.c_float] * n
    f = getattr(_LIBM, name)
    flat = x.detach().reshape(-1).tolist()
    out = torch.tensor([f(v, *args) for v in flat], dtype=torch.float32)
    return out.reshape(x.shape)


def powf_libm(x, y: float):
    """x ** y for a float32 CPU tensor by the C library's powf, value by
    value: XLA:CPU calls it for jnp.power (not correctly rounded: it
    differs from the nearest float32 on ~0.07% of inputs), where
    torch.pow differs on ~2%. For host bakes of a few thousand values
    only: a tensor on another device raises (it is never moved to the
    host)."""
    return _libm_f32("powf", x, y)


def sinf_libm(x):
    """sin of a float32 CPU tensor by the C library's sinf, as XLA:CPU
    computes jnp.sin (torch.sin, and sin in float64 rounded once, differ
    from it on ~1% of values). For host bakes only, as powf_libm."""
    return _libm_f32("sinf", x)


def cosf_libm(x):
    """cos of a float32 CPU tensor by the C library's cosf, as XLA:CPU
    computes jnp.cos. For host bakes only, as powf_libm."""
    return _libm_f32("cosf", x)


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


# XLA:CPU's float32 log and exp (the Cephes polynomials its CPU backend
# emits, with the mul-adds it contracts written as fma), for the few
# places where a log or exp decides an integer that must be the JAX
# package's: the refit's quantisation exponent (build/refit.py). torch's
# own log2 / exp2 differ from XLA's by an ulp near powers of two, which
# moves ceil(log2(x)) by one (tests/test_torch_dynamic.py).
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_FLT_MIN = 1.17549435e-38
_LN2 = 0.693147182           # float32 ln 2, jnp.exp2's factor
_INV_LN2 = 1.4426950408889634


def _c(x, v):
    return torch.full_like(x, v)


def log_xla(x):
    """XLA:CPU's float32 natural log, bit for bit (x > 0, finite)."""
    x = torch.clamp(x, min=_FLT_MIN)
    b = x.view(torch.int32)
    e = ((b >> 23) - 0x7f).to(torch.float32) + 1.0
    m = ((b & ~0x7f800000) | 0x3f000000).view(torch.float32)  # in [0.5, 1)
    small = m < 0.707106781186547524
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    p = [_c(m, v) for v in _LOG_P]
    x2 = m * m
    x3 = x2 * m
    y = fma(p[0], m, p[1])
    y1 = fma(p[3], m, p[4])
    y2 = fma(p[6], m, p[7])
    y = fma(y, m, p[2])
    y1 = fma(y1, m, p[5])
    y2 = fma(y2, m, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * -2.12194440e-4)
    # x2 * 0.5 and e * 0.693359375 are exact: no rounding to contract
    return ((m - x2 * 0.5) + y) + e * 0.693359375


def log2_xla(x):
    """jnp.log2 on XLA:CPU: log(x) times the float32 1/ln 2."""
    return log_xla(x) * _INV_LN2


def exp2_xla(x):
    """jnp.exp2 on XLA:CPU, bit for bit: exp(x * float32 ln 2) by the
    Cephes polynomial, a denormal result flushed to zero."""
    return exp_xla(x * _LN2)


def exp_xla(x):
    """jnp.exp on XLA:CPU (float32), bit for bit below x = 88.376 (above
    it XLA still returns finite values where this returns inf): the
    Cephes polynomial with its contracted mul-adds, a denormal result
    flushed to zero."""
    a = torch.clamp(x, -88.3762626647949, 88.3762626647950)
    fx = torch.floor(fma(a, _c(a, 1.44269504088896341), _c(a, 0.5)))
    r = fma(_c(a, -0.693359375), fx, a)
    r = fma(_c(a, 2.12194440e-4), fx, r)
    z = r * r
    p = [_c(r, v) for v in _EXP_P]
    y = fma(r, p[0], p[1])
    for k in range(2, 6):
        y = fma(y, r, p[k])
    y = fma(y, z, r) + 1.0
    pow2n = ((fx.to(torch.int32) + 0x7f) << 23).view(torch.float32)
    out = y * pow2n
    return torch.where(out.abs() < _FLT_MIN, 0.0, out)
