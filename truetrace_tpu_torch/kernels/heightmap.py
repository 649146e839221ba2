"""Heightfield ray tracing: a fixed march with a bisection ladder.

Port of `truetrace_tpu/kernels/heightmap.py`. Each ray is clipped to the
terrain's box, takes MARCH_STEPS uniform steps looking for the first sign
change of f(t) = ray_y(t) - h(x(t), z(t)) (h: the bilinear height, four
fetches from the flat height grid), refines the bracket by BISECT_STEPS
bisections, and reports t, the central-difference normal and the clamped
terrain uv.

Two implementations of one march:

* `heightmap_closest` / `heightmap_any` launch the CUDA kernel
  `csrc/heightmap.cu` (one ray a thread; march steps that the terrain's
  `height_top` proves lie above the grid skipped) on CUDA tensors and
  run the plain version on CPU tensors; each counts its launches in
  `launches`.
* `heightmap_closest_plain` / `heightmap_any_plain`: plain PyTorch over
  all lanes, the JAX march op for op.

The mul-adds XLA:CPU contracts are fma()s in both (the bilinear blend,
the march's t and the ray points), so t, normal and uv are bitwise the
JAX package's. The any hit stops at the first crossing: in JAX it is the
closest hit with one bisection, whose `valid` does not depend on the
bisection.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from truetrace_tpu_torch.core.math import fma
from truetrace_tpu_torch.kernels import _cuda

MARCH_STEPS = 96
BISECT_STEPS = 10


class TerrainHit(NamedTuple):
    t: torch.Tensor        # [R] hit distance (t_max on a miss)
    valid: torch.Tensor    # [R] bool
    normal: torch.Tensor   # [R,3]
    uv: torch.Tensor       # [R,2]


def _f32(x: float) -> float:
    return float(np.float32(x))


def _sample_height(ter, x, z, last: bool = False):
    """Bilinear world-space height at world (x, z), clamped to the grid
    edge. XLA:CPU contracts the blend's last mul-add at its first product
    alone and at its second inside f(t) (`last`)."""
    Hm, Wm = ter.hm_shape
    ox, _, oz, sx, sz, _ = ter.consts
    fx = torch.clamp((x - ox) / sx * float(Wm - 1), 0.0, _f32(Wm - 1.001))
    fz = torch.clamp((z - oz) / sz * float(Hm - 1), 0.0, _f32(Hm - 1.001))
    ix = fx.to(torch.int64)
    iz = fz.to(torch.int64)
    wx = fx - ix.to(torch.float32)
    wz = fz - iz.to(torch.float32)
    base = iz * Wm + ix
    h = ter.height
    h0 = fma(h[base + 1], wx, h[base] * (1.0 - wx))
    h1 = fma(h[base + Wm + 1], wx, h[base + Wm] * (1.0 - wx))
    if last:
        return fma(h1, wz, h0 * (1.0 - wz))
    return fma(h0, 1.0 - wz, h1 * wz)


def _spacing(ter):
    """The normal's sample spacing (dx, dz): one grid cell, the extent
    times float32(1 / (cells)) as XLA:CPU rewrites the division by a
    constant."""
    Hm, Wm = ter.hm_shape
    _, _, _, sx, sz, _ = ter.consts
    f = np.float32
    return _f32(f(sx) * f(1.0 / (Wm - 1))), _f32(f(sz) * f(1.0 / (Hm - 1)))


def _normal(ter, x, z):
    """Central-difference normal with one-cell spacing, normalised by
    sqrt((x^2 + y^2) + z^2)."""
    dx, dz = _spacing(ter)
    gx = (_sample_height(ter, x + dx, z) - _sample_height(ter, x - dx, z)) \
        / _f32(2 * np.float32(dx))
    gz = (_sample_height(ter, x, z + dz) - _sample_height(ter, x, z - dz)) \
        / _f32(2 * np.float32(dz))
    n = torch.stack([-gx, torch.ones_like(gx), -gz], -1)
    length = torch.sqrt((n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1])
                        + n[:, 2] * n[:, 2])
    return n / length[:, None]


def _box(ter):
    """The terrain's box: lo (the origin) and hi, summed in float32."""
    ox, oy, oz, sx, sz, hm = ter.consts
    f = np.float32
    return (ox, oy, oz), (_f32(f(ox) + f(sx)), _f32(f(oy) + f(hm)),
                          _f32(f(oz) + f(sz)))


def _aabb_clip(ter, ro, rd, t_max):
    lo, hi = _box(ter)
    inv = 1.0 / torch.where(rd.abs() < 1e-12,
                            torch.where(rd >= 0, 1e-12, -1e-12), rd)
    tn = tf = None
    for a in range(3):
        t0 = (lo[a] - ro[:, a]) * inv[:, a]
        t1 = (hi[a] - ro[:, a]) * inv[:, a]
        lo_a, hi_a = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo_a if tn is None else torch.maximum(tn, lo_a)
        tf = hi_a if tf is None else torch.minimum(tf, hi_a)
    tn = torch.clamp(tn, min=0.0)
    tf = torch.minimum(tf, t_max)
    return tn, tf, tf >= tn


def _march_plain(ter, ro, rd, t_max, closest: bool, steps: int,
                 bisect: int, counts: dict | None = None):
    R = ro.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=ro.device).expand(R)
    tn, tf, inside = _aabb_clip(ter, ro, rd, t_max)
    # XLA:CPU divides by the constant step count as a product with its
    # float32 reciprocal
    dt = torch.where(inside, (tf - tn) * _f32(1.0 / steps), 0.0)

    def f_at(t):
        x = fma(rd[:, 0], t, ro[:, 0])
        z = fma(rd[:, 2], t, ro[:, 2])
        return fma(rd[:, 1], t, ro[:, 1]) - _sample_height(ter, x, z, True)

    f_prev, t_prev = f_at(tn), tn
    lo, hi = tn, tf
    found = torch.zeros((R,), dtype=torch.bool, device=ro.device)
    first = torch.full((R,), steps, dtype=torch.int64, device=ro.device)
    for i in range(steps):
        t = fma(dt, torch.full_like(dt, float(i + 1)), tn)
        f = f_at(t)
        crossed = inside & ~found & (torch.sign(f) != torch.sign(f_prev))
        lo = torch.where(crossed, t_prev, lo)
        hi = torch.where(crossed, t, hi)
        first = torch.where(crossed, i, first)
        found = found | crossed
        f_prev, t_prev = f, t
    if counts is not None:
        # the samples (4 height fetches each) the function needs, as the
        # kernel takes them: the start (the any hit skips it on a lane
        # whose clip is empty), the march up to the first crossing, on a
        # lane whose clip has length (dt = 0 samples tn again and again,
        # so its first step decides: only a NaN start crosses), then
        # (closest) the bisection's start and steps and the normal's four
        marched = inside & (dt > 0)
        march = torch.where(marched, torch.where(found, first + 1, steps), 0)
        start = torch.ones_like(march) if closest else inside.long()
        counts.update(samples=start + march
                      + (1 + bisect + 4 if closest else 0),
                      march_steps=march)
    if not closest:
        return TerrainHit(t=t_max, valid=found, normal=None, uv=None)
    flo = f_at(lo)
    for _ in range(bisect):
        mid = 0.5 * (lo + hi)
        fm = f_at(mid)
        same = torch.sign(fm) == torch.sign(flo)
        lo = torch.where(same, mid, lo)
        flo = torch.where(same, fm, flo)
        hi = torch.where(same, hi, mid)
    t_hit = 0.5 * (lo + hi)
    px = fma(rd[:, 0], t_hit, ro[:, 0])
    pz = fma(rd[:, 2], t_hit, ro[:, 2])
    ox, _, oz, sx, sz, _ = ter.consts
    uv = torch.stack([(px - ox) / sx, (pz - oz) / sz], -1)
    return TerrainHit(t=torch.where(found, t_hit, t_max), valid=found,
                      normal=_normal(ter, px, pz),
                      uv=torch.clamp(uv, 0.0, 1.0))


def heightmap_closest_plain(ter, ro, rd, t_max, steps: int = MARCH_STEPS,
                            bisect: int = BISECT_STEPS,
                            counts: dict | None = None) -> TerrainHit:
    """Closest-hit march of rays ro/rd [R,3] up to t_max (scalar or [R]).
    counts: if a dict, it receives "samples" [R] (bilinear height samples
    the kernel takes for each ray) and "march_steps" [R]."""
    return _march_plain(ter, ro, rd, t_max, True, steps, bisect, counts)


def heightmap_any_plain(ter, ro, rd, t_max, steps: int = MARCH_STEPS,
                        counts: dict | None = None):
    """Occlusion bool [R]: a crossing before t_max."""
    return _march_plain(ter, ro, rd, t_max, False, steps, 0, counts).valid


def sample_layers(ter, uv):
    """Bilinear alphamap fetch -> [R,4] layer weights, normalised over the
    layers in use."""
    A0, A1 = ter.alphamap.shape[0], ter.alphamap.shape[1]
    fz = torch.clamp(uv[:, 1] * float(A0 - 1), 0.0, _f32(A0 - 1.001))
    fx = torch.clamp(uv[:, 0] * float(A1 - 1), 0.0, _f32(A1 - 1.001))
    iz = fz.to(torch.int64)
    ix = fx.to(torch.int64)
    wz = (fz - iz.to(torch.float32))[:, None]
    wx = (fx - ix.to(torch.float32))[:, None]
    am = ter.alphamap
    w0 = fma(am[iz, ix + 1], wx, am[iz, ix] * (1.0 - wx))
    w1 = fma(am[iz + 1, ix + 1], wx, am[iz + 1, ix] * (1.0 - wx))
    w = fma(w0, 1.0 - wz, w1 * wz)
    w = w * (ter.mat_ids >= 0).to(torch.float32)[None]
    s = w[:, 0] + w[:, 1] + w[:, 2] + w[:, 3]
    return w / torch.clamp(s, min=1e-6)[:, None]


# ---------------------------------------------------------------------------
# The kernel's table of block maxima (Terrain.height_top)
# ---------------------------------------------------------------------------

TOP_HEADER = 32    # height_top's level offsets, ahead of its levels


def top_levels(Hm: int, Wm: int) -> list:
    """(rows, columns) of each level of height_top for a Hm x Wm grid:
    level l has a window at every 2^l grid points a corner of a cell can
    start at, enough levels that one window holds any rectangle of
    cells."""
    n = 1 + math.ceil(math.log2(max(Hm, Wm) - 1))
    return [(((Hm - 2) >> lv) + 1, ((Wm - 2) >> lv) + 1) for lv in range(n)]


def height_top(height: torch.Tensor, Hm: int, Wm: int) -> torch.Tensor:
    """The height grid's block maxima, for the march kernel's skip test:
    float32 [TOP_HEADER + sum of the levels' sizes] on height's device.
    Entry (bz, bx) of level l bounds the grid points z in [bz 2^l, bz 2^l +
    2^(l+1)), x in [bx 2^l, bx 2^l + 2^(l+1)): their maximum M plus 2^-16
    of their largest |height| plus 2^-120, rounded up to float32 (the
    bilinear blend of four of them, rounded in float32, stays below it),
    and +inf where one of them is NaN or infinite. The first TOP_HEADER
    words hold each level's offset (int32 bits)."""
    h = height.reshape(1, 1, Hm, Wm).double()
    bad = ~torch.isfinite(h)
    hi = torch.where(bad, math.inf, h)
    mag = torch.where(bad, math.inf, h.abs())
    levels, offs = [], []
    at = TOP_HEADER
    for lv, (nz, nx) in enumerate(top_levels(Hm, Wm)):
        c = 1 << lv
        pad = (0, nx * c + c - Wm, 0, nz * c + c - Hm)
        m, a = (torch.nn.functional.max_pool2d(
            torch.nn.functional.pad(x, pad, value=v), 2 * c, c)[
                0, 0, :nz, :nx] for x, v in ((hi, -math.inf), (mag, 0.0)))
        bound = m + a * 2.0 ** -16 + 2.0 ** -120
        top = bound.float()
        top = torch.where(top.double() < bound,
                          torch.nextafter(top, torch.full_like(top, math.inf)),
                          top)
        levels.append(top.reshape(-1))
        offs.append(at)
        at += nz * nx
    head = torch.zeros(TOP_HEADER, dtype=torch.int32)
    head[:len(offs)] = torch.tensor(offs, dtype=torch.int32)
    return torch.cat([head.to(height.device).view(torch.float32)] + levels)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _launch(ter, ro, rd, t_max, closest: bool, steps: int, bisect: int,
            lib=None):
    """Check the arguments, allocate the outputs, launch
    csrc/heightmap.cu (or `lib`, another build of it) over the
    terrain's height grid and its table of block maxima."""
    dev = ro.device
    R = ro.shape[0]
    for name, x in (("ro", ro), ("rd", rd), ("height", ter.height),
                    ("height_top", ter.height_top)):
        if (x.device != dev or x.dtype != torch.float32
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous float32 tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    if ro.shape != (R, 3) or rd.shape != (R, 3):
        raise ValueError(f"ro/rd must be [R,3], got {tuple(ro.shape)}, "
                         f"{tuple(rd.shape)}")
    Hm, Wm = ter.hm_shape
    if Hm < 2 or Wm < 2 or ter.height.shape != (Hm * Wm,):
        raise ValueError(f"height {tuple(ter.height.shape)} is not a flat "
                         f"{Hm}x{Wm} grid")
    top = TOP_HEADER + sum(nz * nx for nz, nx in top_levels(Hm, Wm))
    if ter.height_top.shape != (top,):
        raise ValueError(f"height_top {tuple(ter.height_top.shape)} is not "
                         f"the {Hm}x{Wm} grid's table of {top} words")
    if isinstance(t_max, torch.Tensor):
        tm = t_max.to(device=dev, dtype=torch.float32).expand(R).contiguous()
    else:
        tm = torch.full((R,), float(t_max), dtype=torch.float32, device=dev)
    (ox, oy, oz), (hx, hy, hz) = _box(ter)
    _, _, _, sx, sz, _ = ter.consts
    valid = torch.empty((R,), dtype=torch.bool, device=dev)
    if closest:
        t = torch.empty((R,), dtype=torch.float32, device=dev)
        n = torch.empty((R, 3), dtype=torch.float32, device=dev)
        uv = torch.empty((R, 2), dtype=torch.float32, device=dev)
        outs = (t.data_ptr(), n.data_ptr(), uv.data_ptr())
    else:
        outs = (0, 0, 0)
    lib = _cuda.lib("heightmap.cu") if lib is None else lib
    err = lib.tt_heightmap(
        ter.height.data_ptr(), ter.height_top.data_ptr(), Hm, Wm, ox, oy, oz,
        hx, hy, hz, sx, sz, *_spacing(ter),
        ro.data_ptr(), rd.data_ptr(), tm.data_ptr(), R, steps, bisect,
        int(closest), valid.data_ptr(), *outs, _cuda.stream_ptr(ro))
    _cuda.check(err, "tt_heightmap")
    if not closest:
        return valid
    return TerrainHit(t=t, valid=valid, normal=n, uv=uv)


# where the integrator's rays lose their grad before the march
_DETACH_SITE = ("integrate/pathtrace.py marches after detaching the hit "
                "record, and its shadow rays carry no grad (the "
                "detached-sampling estimator does not differentiate the "
                "march)")


def heightmap_closest(ter, ro, rd, t_max, steps: int = MARCH_STEPS,
                      bisect: int = BISECT_STEPS) -> TerrainHit:
    """Closest-hit march of rays ro/rd [R,3] up to t_max (scalar or [R])
    against the Terrain `ter`. CUDA tensors launch csrc/heightmap.cu; CPU
    tensors take heightmap_closest_plain. A tensor that requires grad
    raises ValueError (the march is not differentiated)."""
    _cuda.refuse_grad("heightmap_closest", _DETACH_SITE, ro, rd, t_max)
    if ro.device.type == "cpu":
        return heightmap_closest_plain(ter, ro, rd, t_max, steps, bisect)
    hit = _launch(ter, ro, rd, t_max, True, steps, bisect)
    heightmap_closest.launches += 1
    return hit


def heightmap_any(ter, ro, rd, t_max, steps: int = MARCH_STEPS):
    """Occlusion bool [R] (a crossing before t_max); dispatch as
    heightmap_closest."""
    _cuda.refuse_grad("heightmap_any", _DETACH_SITE, ro, rd, t_max)
    if ro.device.type == "cpu":
        return heightmap_any_plain(ter, ro, rd, t_max, steps)
    valid = _launch(ter, ro, rd, t_max, False, steps, 0)
    heightmap_any.launches += 1
    return valid


heightmap_closest.launches = 0
heightmap_any.launches = 0
