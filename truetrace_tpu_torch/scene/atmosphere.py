"""Physically based sky: the atmosphere LUTs and the baked sky env map.

Port of `truetrace_tpu/scene/atmosphere.py` (Hillaire 2020: the
transmittance LUT, the multiple-scattering LUT Psi_ms(altitude, sun
angle) and the ground irradiance LUT, then a single-scattering march with
Psi_ms per step for the sky radiance). A host-side bake in plain torch
float32 on the CPU: it runs once per sun position and no frame runs it;
`bake_sky_env` hands its equirect image to build_env_cdf, whose EnvMap
goes to `device`. The JAX package's terrain scenes light themselves with
it (scripts/demo.py scene 4).

The three LUTs and the sky of `bake_sky_env` round as the JAX package's
do on XLA:CPU, bit for bit (ROADMAP.md C.3): the mul-adds XLA contracts
in each jitted LUT builder are fmas here, at the sites read from its
optimised IR and machine code; exp is XLA's, pow, sin and cos the C
library's (`core/math.py` `exp_xla`, `powf_libm`, `sinf_libm`,
`cosf_libm`), divisions by constants products with their float32
reciprocals, and square roots rounded to nearest.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from truetrace_tpu_torch.core.math import (
    cosf_libm, dot_fma, exp_xla, fma, powf_libm, sinf_libm, sqrt_rn)

R_GROUND = 6360.0
R_TOP = 6460.0
H_RAYLEIGH = 8.0
H_MIE = 1.2
BETA_R = (5.802e-3, 13.558e-3, 33.1e-3)    # /km
BETA_M_SCAT = 3.996e-3
BETA_M_ABS = 4.4e-3
BETA_OZONE = (0.650e-3, 1.881e-3, 0.085e-3)
MIE_G = 0.8
GROUND_ALBEDO = 0.3

T_W, T_H = 256, 64          # transmittance LUT
N_STEPS = 40
MS_N = 32                   # multiple-scattering LUT (mu_s x altitude)
MS_DIRS = 64
MS_STEPS = 20
IR_W = 64                   # ground irradiance LUT over mu_s

F32 = torch.float32


class AtmosphereLUTs(NamedTuple):
    transmittance: torch.Tensor            # [T_H, T_W, 3]
    multiscatter: Optional[torch.Tensor] = None   # [MS_N, MS_N, 3]
    irradiance: Optional[torch.Tensor] = None     # [IR_W, 3]


def _c3(v) -> torch.Tensor:
    return torch.tensor(v, dtype=F32)


# XLA turns a division by a constant into a product with its float32
# reciprocal (x / 1.2 -> x * 0.833333313, x / 15 -> x * 0.0666666701)
_INV_H_MIE = float(np.float32(1.0 / H_MIE))
_INV_15 = float(np.float32(1.0 / 15.0))
_INV_R_GROUND = float(np.float32(1.0 / R_GROUND))
_ALBEDO_PI = float(np.float32(GROUND_ALBEDO / math.pi))


def _densities(h, fused: bool = True):
    """(rayleigh, mie, ozone) density profiles at altitude h (km) with
    XLA's own exp. fused: as XLA:CPU compiles them inside a jitted LUT
    builder, the divisions as reciprocal products and the ozone tent's
    1 - |h - 25| / 15 one fma; else op by op, as the JAX package's eager
    sky bake runs them."""
    hp = torch.clamp(h, min=0.0)
    if not fused:
        return (exp_xla(-hp / H_RAYLEIGH), exp_xla(-hp / H_MIE),
                torch.clamp(1.0 - (h - 25.0).abs() / 15.0, min=0.0))
    rho_r = exp_xla(-hp * (1.0 / H_RAYLEIGH))
    rho_m = exp_xla(-hp * _INV_H_MIE)
    rho_o = torch.clamp(fma(-(h - 25.0).abs(), _k(h, _INV_15), _k(h, 1.0)),
                        min=0.0)
    return rho_r, rho_m, rho_o


def _k(x, v):
    return torch.full_like(x, v)


def _extinction(h, fused: bool = True):
    """[..., 3] extinction. fused: the JAX package's sum as XLA:CPU
    contracts it in the LUT builders, fma(rho_o, beta_o, fma(rho_r,
    beta_r, beta_m * rho_m)); else the sum's plain products."""
    rho_r, rho_m, rho_o = _densities(h, fused)
    if not fused:
        return (_c3(BETA_R) * rho_r[..., None]
                + (BETA_M_SCAT + BETA_M_ABS) * rho_m[..., None]
                + _c3(BETA_OZONE) * rho_o[..., None])
    shape = (*h.shape, 3)
    m = ((BETA_M_SCAT + BETA_M_ABS) * rho_m)[..., None].expand(shape)
    s = fma(rho_r[..., None].expand(shape), _c3(BETA_R).expand(shape), m)
    return fma(rho_o[..., None].expand(shape), _c3(BETA_OZONE).expand(shape),
               s)


def _scattering(h):
    """[..., 3] scattering, op by op (the eager sky bake's)."""
    rho_r, rho_m, _ = _densities(h, False)
    return _c3(BETA_R) * rho_r[..., None] + BETA_M_SCAT * rho_m[..., None]


def _dist_to_top(r, mu):
    disc = r * r * (mu * mu - 1.0) + R_TOP * R_TOP
    return torch.clamp(-r * mu + sqrt_rn(torch.clamp(disc, min=0.0)),
                       min=0.0)


def _dist_to_ground(r, mu):
    """Distance to the ground, +inf where the ray misses it."""
    disc = r * r * (mu * mu - 1.0) + R_GROUND * R_GROUND
    hit = (disc >= 0.0) & (mu < 0.0)
    d = -r * mu - sqrt_rn(torch.clamp(disc, min=0.0))
    return torch.where(hit & (d > 0.0), d, math.inf)


_H_ATM = float(np.float32(math.sqrt(R_TOP ** 2 - R_GROUND ** 2)))


def _uv_to_rmu(u, v):
    """The transmittance LUT's (r, mu) at texel (u, v), with XLA:CPU's
    contractions: d = fma(u, d_max - d_min, d_min) and mu's numerator
    fma(-d, d, fma(-rho, rho, H^2)). mu's own fusion adds d_max = rho + H
    in two roundings (rho has a second use there); the test d > 1e-6
    runs in the step fusions, where d_max = fma(v, H, H). r = sqrt(rho^2
    + R_ground^2) stays two roundings (XLA folds it to constants)."""
    rho = v * _H_ATM
    r = sqrt_rn(rho * rho + R_GROUND * R_GROUND)
    d_min = R_TOP - r
    d = fma(u, (rho + _H_ATM) - d_min, d_min)
    d_test = fma(u, fma(v, _k(v, _H_ATM), _k(v, _H_ATM)) - d_min, d_min)
    num = fma(-d, d, fma(-rho, rho, _k(rho, _H_ATM * _H_ATM)))
    mu = torch.where(d_test > 1e-6,
                     num / torch.clamp(2.0 * r * d, min=1e-9), 1.0)
    return r, torch.clamp(mu, -1.0, 1.0)


def _dist_to_top_fma(r, mu):
    """_dist_to_top as XLA:CPU contracts it in the LUT builders:
    sqrt(fma(r^2, fma(mu, mu, -1), R_top^2)), then fma(-r, mu, .)."""
    disc = fma(r * r, fma(mu, mu, _k(mu, -1.0)), _k(mu, R_TOP * R_TOP))
    return torch.clamp(fma(-r, mu, sqrt_rn(torch.clamp(disc, min=0.0))),
                       min=0.0)


def _rmu_to_uv(r, mu):
    rho = sqrt_rn(torch.clamp(r * r - R_GROUND * R_GROUND, min=0.0))
    d = _dist_to_top(r, mu)
    d_min = R_TOP - r
    d_max = rho + _H_ATM
    u = torch.clamp((d - d_min) / torch.clamp(d_max - d_min, min=1e-9),
                    0.0, 1.0)
    v = torch.clamp(rho / _H_ATM, 0.0, 1.0)
    return u, v


def build_transmittance() -> torch.Tensor:
    """[T_H, T_W, 3] transmittance to the top of the atmosphere, bit for
    bit the JAX package's on XLA:CPU: t = ts_i d a product, the march's
    radius sqrt(fma(2 r mu, t, fma(t, t, r^2))), dt = d * 0.025 (XLA's
    reciprocal of 1 / N_STEPS), the optical depth summed as fma(ext, dt,
    od) after a first fma(ext_0, dt, ext_1 dt), and XLA's own exp."""
    vs, us = torch.meshgrid((torch.arange(T_H, dtype=F32) + 0.5) / T_H,
                            (torch.arange(T_W, dtype=F32) + 0.5) / T_W,
                            indexing="ij")
    r, mu = _uv_to_rmu(us, vs)
    d = _dist_to_top_fma(r, mu)
    inv_n = float(np.float32(1.0 / N_STEPS))
    ts = (torch.arange(N_STEPS, dtype=F32) + 0.5) * inv_n
    dt = (d * inv_n)[..., None].expand(*d.shape, 3)
    rr, r2mu = r * r, 2.0 * r * mu
    od = None
    for i in range(N_STEPS):
        t = ts[i] * d
        rad = sqrt_rn(fma(r2mu, t, fma(t, t, rr)))
        ext = _extinction(rad - R_GROUND)
        if i == 0:
            ext0 = ext
        elif i == 1:
            od = fma(ext0, dt, ext * dt)
        else:
            od = fma(ext, dt, od)
    return exp_xla(-od)


def sample_transmittance(lut, r, mu):
    u, v = _rmu_to_uv(r, mu)
    x = torch.clamp((u * T_W).to(torch.int64), 0, T_W - 1)
    y = torch.clamp((v * T_H).to(torch.int64), 0, T_H - 1)
    return lut[y, x]


def _earth_lit(rad, mu_s):
    """1 where the planet does not shadow the sun at radius rad."""
    return (mu_s > -sqrt_rn(torch.clamp(
        1.0 - (R_GROUND / rad) ** 2, min=0.0))).to(F32)


def _fibonacci_sphere(n: int) -> torch.Tensor:
    i = np.arange(n) + 0.5
    phi = np.pi * (1.0 + 5.0 ** 0.5) * i
    y = 1.0 - 2.0 * i / n
    s = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    return torch.from_numpy(np.stack([s * np.cos(phi), y, s * np.sin(phi)],
                                     axis=-1).astype(np.float32))


def _sample_transmittance_fused(lut, r, mu):
    """sample_transmittance as XLA:CPU computes it inside the
    multiple-scattering builder: the distance to the top contracted
    (_dist_to_top_fma), rho's r^2 - R_ground^2 in two roundings."""
    rho = sqrt_rn(torch.clamp(r * r - R_GROUND * R_GROUND, min=0.0))
    d = _dist_to_top_fma(r, mu)
    d_min = R_TOP - r
    u = torch.clamp((d - d_min) / torch.clamp(rho + _H_ATM - d_min, min=1e-9),
                    0.0, 1.0)
    v = torch.clamp(rho / _H_ATM, 0.0, 1.0)
    x = torch.clamp((u * T_W).to(torch.int64), 0, T_W - 1)
    y = torch.clamp((v * T_H).to(torch.int64), 0, T_H - 1)
    return lut[y, x]


def _window_mean64(x):
    """The mean over axis 1 (64 values) as XLA:CPU reduces it: two
    32-wide windows summed in order, added, times 1/64. Returns (sum,
    mean)."""
    halves = []
    for k in (0, 32):
        acc = torch.zeros_like(x[:, 0])
        for j in range(k, k + 32):
            acc = acc + x[:, j]
        halves.append(acc)
    total = halves[0] + halves[1]
    return total, total * (1.0 / 64.0)


def build_multiscatter(tlut) -> torch.Tensor:
    """[MS_N, MS_N, 3] Psi_ms(r, mu_s): the radiance all scattering
    orders >= 2 add per unit scattering coefficient (isotropic
    approximation: the second order over the sphere and the geometric
    transfer 1 / (1 - f_ms)). Rows: altitude; columns: mu_s.

    With XLA:CPU's sites of the JAX builder: the ray ends with a shared
    r mu product (both distances live in one fusion), dt = t_end * 0.05,
    the march's radius and local sun cosine as fmas, the optical depth
    and the L2 / f_ms sums as fma(x, dt, sum) after a first fma(x_0, dt,
    x_1 dt), the mean over directions as two 32-wide windows; in the
    ground bounce the sun cosine's numerator fused, the division by
    R_GROUND a product with its reciprocal and the albedo constant moved
    onto the cosine. The JAX LUT's bits (ROADMAP.md C.3)."""
    g = (torch.arange(MS_N, dtype=F32) + 0.5) / MS_N
    mu_s = 2.0 * g - 1.0
    r0 = R_GROUND + g * (R_TOP - R_GROUND) * 0.99 + 0.05
    r, mu_s = torch.meshgrid(r0, mu_s, indexing="ij")
    r = r.reshape(-1)
    mu_s = mu_s.reshape(-1)
    G = r.shape[0]
    dirs = _fibonacci_sphere(MS_DIRS)
    mu_v = dirs[:, 1][None, :].expand(G, MS_DIRS)
    sin_s = sqrt_rn(torch.clamp(1.0 - mu_s * mu_s, min=0.0))
    cos_vs = mu_s[:, None] * mu_v + sin_s[:, None] * dirs[None, :, 2]
    rg = r[:, None].expand(G, MS_DIRS)
    rr, rm = rg * rg, rg * mu_v
    c = mu_v * mu_v - 1.0
    disc_g = fma(rr, c, _k(rr, R_GROUND * R_GROUND))
    d_g = -rm - sqrt_rn(torch.clamp(disc_g, min=0.0))
    hits_ground = (disc_g >= 0.0) & (mu_v < 0.0) & (d_g > 0.0)
    d_t = torch.clamp(
        -rm + sqrt_rn(torch.clamp(fma(rr, c, _k(rr, R_TOP * R_TOP)),
                                  min=0.0)), min=0.0)
    t_end = torch.where(hits_ground, d_g, d_t)
    dt = (t_end * float(np.float32(1.0 / MS_STEPS)))[..., None].expand(
        G, MS_DIRS, 3)
    p_u = 1.0 / (4.0 * math.pi)
    rms = rg * mu_s[:, None]
    for i in range(MS_STEPS):
        t = (i + 0.5) / MS_STEPS * t_end
        rad = sqrt_rn(fma(2.0 * rg * mu_v, t, fma(t, t, rr)))
        h = rad - R_GROUND
        ext = _extinction(h)
        rho_r, rho_m, _ = _densities(h)
        sig_s = fma(rho_r[..., None].expand_as(ext),
                    _c3(BETA_R).expand_as(ext),
                    (BETA_M_SCAT * rho_m)[..., None].expand_as(ext))
        mu_sx = torch.clamp(fma(t, cos_vs, rms) / rad, -1.0, 1.0)
        t_sun = _sample_transmittance_fused(tlut, rad, mu_sx)
        lit = _earth_lit(rad, mu_sx)
        if i == 0:
            od = ext * dt
        elif i == 1:
            od = fma(ext0, dt, ext * dt)
        else:
            od = fma(ext, dt, od)
        t_view = exp_xla(-od)
        xf = t_view * sig_s
        xl = xf * p_u * t_sun * lit[..., None]
        if i == 0:
            ext0, xf0, xl0 = ext, xf, xl
        elif i == 1:
            fms, L2 = fma(xf0, dt, xf * dt), fma(xl0, dt, xl * dt)
        else:
            fms, L2 = fma(xf, dt, fms), fma(xl, dt, L2)
    # the ground bounce: XLA contracts the sun cosine's numerator, turns
    # the division by R_GROUND into a product with its reciprocal and
    # moves the albedo constant onto the cosine
    rad_g = torch.full_like(t_end, R_GROUND)
    mu_sg = torch.clamp(fma(t_end, cos_vs, rms) * _INV_R_GROUND, -1.0, 1.0)
    t_sun_g = sample_transmittance(tlut, rad_g, mu_sg)
    L2 = L2 + torch.where(
        hits_ground[..., None],
        exp_xla(-od) * (torch.clamp(mu_sg, min=0.0) * _ALBEDO_PI)[..., None]
        * t_sun_g, 0.0)
    _, L2 = _window_mean64(L2)
    f_sum, _ = _window_mean64(fms)
    psi = L2 / torch.clamp(fma(-f_sum, _k(f_sum, 1.0 / 64.0),
                               torch.ones_like(f_sum)), min=1e-3)
    return psi.reshape(MS_N, MS_N, 3)


def sample_multiscatter(ms_lut, r, mu_s):
    """Bilinear Psi_ms at radius r and local sun cosine mu_s."""
    u = torch.clamp((mu_s * 0.5 + 0.5) * MS_N - 0.5, 0.0, MS_N - 1.0)
    v = torch.clamp((r - R_GROUND) / (R_TOP - R_GROUND) * MS_N - 0.5,
                    0.0, MS_N - 1.0)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    u1 = torch.clamp(u0 + 1, max=MS_N - 1)
    v1 = torch.clamp(v0 + 1, max=MS_N - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    a = ms_lut[v0, u0] * (1 - fu) + ms_lut[v0, u1] * fu
    b = ms_lut[v1, u0] * (1 - fu) + ms_lut[v1, u1] * fu
    return a * (1 - fv) + b * fv


def build_irradiance(tlut, ms_lut) -> torch.Tensor:
    """[IR_W, 3] ground irradiance per unit sun irradiance over mu_s: the
    transmitted sun and the cosine-weighted sky (single and multiple
    scattering) over a 16 x 8 stratified hemisphere: the JAX builder's
    jitted, vmapped march with XLA:CPU's sites (_irradiance_sky); the
    directions' sin and cos the C library's, as XLA:CPU's; the mean over
    the 128 directions as four 32-wide sums in order times pi / 128; the
    direct term's product fused into the sum."""
    mu_s = 2.0 * (torch.arange(IR_W, dtype=F32) + 0.5) / IR_W - 1.0
    mx = torch.clamp(mu_s, min=0.0)
    t_sun = sample_transmittance(tlut, torch.full((IR_W,), R_GROUND + 0.01),
                                 mx)
    nth, nph = 8, 16
    u1 = (torch.arange(nth, dtype=F32) + 0.5) / nth
    u2 = (torch.arange(nph, dtype=F32) + 0.5) / nph
    ct = sqrt_rn(u1)
    st = sqrt_rn(1.0 - u1)
    phi = 2.0 * math.pi * u2
    dirs = torch.stack(torch.broadcast_tensors(
        st[:, None] * cosf_libm(phi)[None, :],
        ct[:, None] * torch.ones((1, nph)),
        st[:, None] * sinf_libm(phi)[None, :]), -1).reshape(-1, 3)
    L = _irradiance_sky(tlut, ms_lut, dirs, mu_s)
    total = None
    for k in range(0, 128, 32):
        part = torch.zeros_like(L[:, 0])
        for j in range(k, k + 32):
            part = part + L[:, j]
        total = part if total is None else total + part
    return fma(t_sun, mx[:, None].expand(IR_W, 3),
               total * float(np.float32(math.pi / 128)))


def _irradiance_sky(tlut, ms_lut, dirs, mu_s, n_steps: int = 12):
    """[IR_W, D, 3] sky radiance per unit sun irradiance for dirs [D,3]
    and suns (0, mu_s, sqrt(1 - mu_s^2)) from R_GROUND + 0.01, without
    the ground bounce: _sky_march as XLA:CPU compiles it inside the
    jitted, vmapped irradiance builder. What depends on the direction
    alone (the distance, dt = d x float32(1/12), the densities, the
    optical depth as fma(ext, dt, sum) after fma(ext_0, dt, ext_1 dt))
    is computed once a direction; XLA's sites besides: cos_vs a dot
    product reduced with fmas, the phases' 1 + c^2 and the Mie base as
    fmas, the Rayleigh constant moved onto the density, the local sun
    cosine's numerator fused, the in-scattering's Rayleigh product and
    the multiple-scattering lookup's coordinates (v = fma(h, 0.32, -0.5))
    and bilinear blends fused, the step's multiple-scattering product
    fused into the single-scattering term, and the running sum as the
    optical depth's."""
    r0 = R_GROUND + 0.01
    W, D = mu_s.shape[0], dirs.shape[0]
    mu = dirs[:, 1]
    sun = torch.stack([0.0 * mu_s, mu_s,
                       sqrt_rn(torch.clamp(1.0 - mu_s * mu_s, min=0.0))], -1)
    cos_vs = dot_fma(dirs[None].expand(W, D, 3),
                     sun[:, None].expand(W, D, 3))
    one_c2 = fma(cos_vs, cos_vs, torch.ones_like(cos_vs))
    g = MIE_G
    ph_m = (3.0 / (8.0 * math.pi) * (1.0 - g * g)) * one_c2 / (
        (2.0 + g * g) * powf_libm(fma(_k(cos_vs, -2.0 * g), cos_vs,
                                      _k(cos_vs, 1.0 + g * g)), 1.5))
    d_g = _dist_to_ground(r0, mu)
    d = torch.where(torch.isfinite(d_g), d_g, _dist_to_top(r0, mu))
    dt = d * float(np.float32(1.0 / n_steps))
    dt3 = dt[:, None].expand(D, 3)
    rms = r0 * sun[:, 1][:, None].expand(W, D)
    beta_r = _c3(BETA_R)
    k_r = float(np.float32(3.0 / (16.0 * math.pi)))
    shape = (W, D, 3)
    for i in range(n_steps):
        t = (i + 0.5) / n_steps * d
        rad = sqrt_rn(r0 * r0 + t * t + 2.0 * r0 * mu * t)
        h = rad - R_GROUND
        rho_r, rho_m, _ = _densities(h)
        ext = _extinction(h)
        if i == 0:
            od = ext * dt3
        elif i == 1:
            od = fma(ext0, dt3, ext * dt3)
        else:
            od = fma(ext, dt3, od)
        t_view = exp_xla(-od)
        mu_l = torch.clamp(fma(t[None].expand(W, D), cos_vs, rms)
                           / rad[None], -1.0, 1.0)
        t_sun = sample_transmittance(tlut, rad[None].expand(W, D), mu_l)
        lit = _earth_lit(rad[None].expand(W, D), mu_l)
        scat = fma(beta_r.expand(shape),
                   (one_c2 * (rho_r * k_r)[None])[..., None].expand(shape),
                   ((ph_m * rho_m[None]) * BETA_M_SCAT)[..., None].expand(
                       shape))
        # the multiple-scattering LUT, bilinear at (altitude, mu_l)
        u = torch.clamp(fma(fma(mu_l, _k(mu_l, 0.5), _k(mu_l, 0.5)),
                            _k(mu_l, float(MS_N)), _k(mu_l, -0.5)),
                        0.0, MS_N - 1.0)
        v = torch.clamp(fma(h, _k(h, float(np.float32(0.32))), _k(h, -0.5)),
                        0.0, MS_N - 1.0)[None].expand(W, D)
        u0 = torch.floor(u).to(torch.int64)
        v0 = torch.floor(v).to(torch.int64)
        u1 = torch.clamp(u0 + 1, max=MS_N - 1)
        v1 = torch.clamp(v0 + 1, max=MS_N - 1)
        fu = (u - u0)[..., None].expand(shape)
        fv = (v - v0)[..., None].expand(shape)
        a = fma(ms_lut[v0, u0], 1 - fu, ms_lut[v0, u1] * fu)
        b = fma(ms_lut[v1, u0], 1 - fu, ms_lut[v1, u1] * fu)
        psi = fma(a, 1 - fv, b * fv)
        scat_ms = fma(beta_r.expand(D, 3), rho_r[:, None].expand(D, 3),
                      (rho_m * BETA_M_SCAT)[:, None].expand(D, 3))
        step = fma(scat_ms[None].expand(shape), psi,
                   scat * lit[..., None] * t_sun)
        x = t_view[None] * step
        if i == 0:
            ext0, x0 = ext, x
            L = x * dt3[None]
        elif i == 1:
            L = fma(x0, dt3[None].expand(shape), x * dt3[None])
        else:
            L = fma(x, dt3[None].expand(shape), L)
    return L


def sample_irradiance(ir_lut, mu_s):
    x = torch.clamp(((mu_s * 0.5 + 0.5) * IR_W).to(torch.int64), 0, IR_W - 1)
    return ir_lut[x]


def build_luts() -> AtmosphereLUTs:
    """The full bake: transmittance -> multiple scattering -> ground
    irradiance."""
    t = build_transmittance()
    ms = build_multiscatter(t)
    return AtmosphereLUTs(transmittance=t, multiscatter=ms,
                          irradiance=build_irradiance(t, ms))


def _phase_rayleigh(c):
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def _phase_mie(c, g=MIE_G):
    g2 = g * g
    return (3.0 / (8.0 * math.pi) * (1.0 - g2) * (1.0 + c * c)
            / ((2.0 + g2) * powf_libm(1.0 + g2 - 2.0 * g * c, 1.5)))


def _sum3(v):
    """The last axis's three values summed in order, as XLA reduces
    them."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _sky_march(luts: AtmosphereLUTs, view_dir, sun_dir, r0,
               n_steps: int = 24, ground_albedo: float = GROUND_ALBEDO):
    """Sky radiance per unit sun irradiance for view dirs [R,3] from
    radius r0 (y up): single scattering with the real phases, Psi_ms
    multiple scattering per step, the transmitted ground bounce for rays
    that hit the planet, rounded as the JAX package's eager sky bake
    runs it, op by op (XLA's exp, the C library's powf, correctly rounded
    sqrt)."""
    mu = view_dir[..., 1]
    cos_vs = _sum3(view_dir * sun_dir)
    mu_s0 = sun_dir[..., 1]
    d_g = _dist_to_ground(r0, mu)
    hits_ground = torch.isfinite(d_g)
    d = torch.where(hits_ground, d_g, _dist_to_top(r0, mu))
    ph_r = _phase_rayleigh(cos_vs)
    ph_m = _phase_mie(cos_vs)
    L = torch.zeros((*mu.shape, 3))
    od = torch.zeros((*mu.shape, 3))
    dt = d / n_steps
    for i in range(n_steps):
        t = (i + 0.5) / n_steps * d
        rad = sqrt_rn(r0 * r0 + t * t + 2.0 * r0 * mu * t)
        h = rad - R_GROUND
        rho_r, rho_m, _ = _densities(h, False)
        od = od + _extinction(h, False) * dt[..., None]
        t_view = exp_xla(-od)
        mu_s = torch.clamp((r0 * mu_s0 + t * cos_vs) / rad, -1.0, 1.0)
        t_sun = sample_transmittance(luts.transmittance, rad, mu_s)
        lit = _earth_lit(rad, mu_s)
        scat = (_c3(BETA_R) * (ph_r * rho_r)[..., None]
                + BETA_M_SCAT * (ph_m * rho_m)[..., None])
        step_L = scat * lit[..., None] * t_sun
        if luts.multiscatter is not None:
            step_L = step_L + _scattering(h) * sample_multiscatter(
                luts.multiscatter, rad, mu_s)
        L = L + t_view * step_L * dt[..., None]
    if ground_albedo > 0.0:
        mu_sg = torch.clamp((r0 * mu_s0 + d * cos_vs) / R_GROUND, -1.0, 1.0)
        if luts.irradiance is not None:
            e_g = sample_irradiance(luts.irradiance, mu_sg)
        else:
            e_g = sample_transmittance(
                luts.transmittance, torch.full_like(mu_sg, R_GROUND + 0.01),
                mu_sg) * torch.clamp(mu_sg, min=0.0)[..., None]
        L = L + torch.where(hits_ground[..., None],
                            exp_xla(-od) * (ground_albedo / math.pi) * e_g,
                            0.0)
    return L


def sky_radiance(luts: AtmosphereLUTs, view_dir, sun_dir,
                 altitude_km: float = 0.2, sun_irradiance: float = 20.0,
                 n_steps: int = 24, ground_albedo: float = GROUND_ALBEDO):
    """Sky radiance for view directions [R,3] (every scattering order with
    `luts.multiscatter`, else single scattering)."""
    return _sky_march(luts, view_dir, sun_dir, R_GROUND + altitude_km,
                      n_steps=n_steps,
                      ground_albedo=ground_albedo) * sun_irradiance


def bake_sky_env(sun_dir=(0.3, 0.4, 0.2), h: int = 64, w: int = 128,
                 sun_irradiance: float = 20.0,
                 sun_disk_intensity: float = 5e3, sun_cos: float = 0.9999,
                 luts: Optional[AtmosphereLUTs] = None, stars: float = 0.0,
                 device="cuda"):
    """An equirect EnvMap with its importance CDFs, baked from the
    atmosphere for `sun_dir`, on `device` (the card unless the caller
    asks for the CPU). Pass `luts` to reuse one bake across sun positions;
    stars > 0 adds the star field, faded in as the sun sets."""
    from truetrace_tpu_torch.build.env_cdf import build_env_cdf, star_field
    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    sd_t = torch.from_numpy(sd.astype(np.float32))
    ys, xs = torch.meshgrid((torch.arange(h, dtype=F32) + 0.5) / h,
                            (torch.arange(w, dtype=F32) + 0.5) / w,
                            indexing="ij")
    theta = math.pi * ys
    phi = 2.0 * math.pi * xs
    # the C library's sinf and cosf, which XLA:CPU's jnp.sin and jnp.cos
    # are (torch's float32 kernels are not)
    d = torch.stack([sinf_libm(theta) * cosf_libm(phi), cosf_libm(theta),
                     sinf_libm(theta) * sinf_libm(phi)], -1).reshape(-1, 3)
    if luts is None:
        luts = build_luts()
    L = sky_radiance(luts, d, sd_t, sun_irradiance=sun_irradiance)
    cos_sun = _sum3(d * sd_t)
    t_sun = sample_transmittance(
        luts.transmittance, torch.full(d.shape[:1], R_GROUND + 0.2),
        cos_sun * 0 + float(sd[1]))
    above = d[:, 1] > 0.0
    L = L + ((cos_sun > sun_cos) & above).to(F32)[..., None] * t_sun \
        * sun_disk_intensity
    img = L.reshape(h, w, 3).numpy()
    if stars > 0.0:
        fade = float(np.clip(0.5 - sd[1] / 0.17, 0.0, 1.0))
        up = (d[:, 1].numpy().reshape(h, w) > 0.0)[..., None]
        img = img + star_field(h, w, brightness=stars) * fade * up
    return build_env_cdf(np.maximum(img, 0.0), device=device)
