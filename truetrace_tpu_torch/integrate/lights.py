"""Analytic light sampling: point / directional / spot / quad / disk.

Port of `truetrace_tpu/integrate/lights.py` (the reference's Unity-light
NEE path, `SelectUnityLight`, CommonData.cginc:1806). Delta lights
(point, directional, spot) return `is_delta=True`: they have no
BSDF-sampled counterpart to weigh against. Streaming RIS picks one of
many lights by a cheap unshadowed-contribution target.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from truetrace_tpu_torch.core.math import dot, normalize, onb
from truetrace_tpu_torch.scene.ir import AnalyticLights

LIGHT_POINT, LIGHT_DIR, LIGHT_SPOT, LIGHT_QUAD, LIGHT_DISK = range(5)


class AnalyticSample(NamedTuple):
    wi: torch.Tensor        # [R,3]
    dist: torch.Tensor      # [R] distance to the light (1e30 directional)
    radiance: torch.Tensor  # [R,3] incident radiance (delta: I / d^2)
    pdf_sa: torch.Tensor    # [R] solid-angle pdf (1 for delta lights)
    pmf: torch.Tensor       # [R] light-selection probability
    is_delta: torch.Tensor  # [R] bool
    valid: torch.Tensor     # [R] bool


def _empty_sample(R: int, device) -> AnalyticSample:
    z = torch.zeros((R,), device=device)
    z3 = torch.zeros((R, 3), device=device)
    f = torch.zeros((R,), dtype=torch.bool, device=device)
    return AnalyticSample(wi=z3, dist=z, radiance=z3, pdf_sa=z, pmf=z,
                          is_delta=f, valid=f)


def _uniform_index(u, K: int):
    return torch.clamp((u * K).to(torch.int64), 0, K - 1)


def sample_analytic(lights: AnalyticLights, p, u_sel, u2) -> AnalyticSample:
    """Select one analytic light uniformly and sample it from points p."""
    K = lights.position.shape[0]
    R = p.shape[0]
    if K == 0:
        return _empty_sample(R, p.device)
    pmf = torch.full((R,), 1.0 / K, device=p.device)
    return sample_analytic_idx(lights, _uniform_index(u_sel, K), pmf, p, u2)


def sample_analytic_idx(lights: AnalyticLights, idx, pmf, p,
                        u2) -> AnalyticSample:
    """Sample light `idx` of each lane (pmf: its selection probability,
    uniform or from RIS)."""
    R = p.shape[0]
    lt = lights.ltype[idx]
    lpos = lights.position[idx]
    ldir = normalize(lights.direction[idx])
    lrad = lights.radiance[idx]
    ext = lights.extent[idx]
    soft = lights.softness[idx]
    zr = (lights.z_rot[idx] if lights.z_rot is not None
          else torch.zeros_like(soft))

    # soft shadows for delta lights (reference Softness,
    # RayTracingShader.compute:361-375): point and spot positions jitter
    # inside a ball of radius softness * 0.1, with no pdf term (a biased
    # penumbra, as the reference's)
    u_mag = (u2[..., 0] * 7919.0) % 1.0
    phi_s = 2.0 * math.pi * u2[..., 0]
    ct_s = 2.0 * u2[..., 1] - 1.0
    st_s = torch.sqrt(torch.clamp(1.0 - ct_s * ct_s, min=0.0))
    sphere = torch.stack([st_s * torch.cos(phi_s), st_s * torch.sin(phi_s),
                          ct_s], -1)
    is_soft_pt = ((lt == LIGHT_POINT) | (lt == LIGHT_SPOT)) & (soft > 0.0)
    lpos = torch.where(is_soft_pt[..., None],
                       lpos + sphere * (u_mag * soft * 0.1)[..., None], lpos)

    # point / spot: toward the position, inverse-square falloff, the
    # spot's cone
    to_l = lpos - p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-8)
    dist_p = torch.sqrt(d2)
    wi_p = to_l / dist_p[..., None]
    rad_point = lrad / d2[..., None]
    cos_spot = -dot(wi_p, ldir)
    inner = lights.spot_cos[idx, 0]
    outer = lights.spot_cos[idx, 1]
    spot_w = torch.clamp((cos_spot - outer)
                         / torch.clamp(inner - outer, min=1e-6), 0.0, 1.0)
    rad_spot = rad_point * (spot_w * spot_w)[..., None]

    # directional: "infinite" distance; softness tilts the direction
    # inside a disk of angular radius softness * 0.01
    # (RayTracingShader.compute:366-370)
    t_ax, b_ax = onb(ldir)
    r_sun = torch.sqrt(u2[..., 0]) * soft * 0.01
    phi_d = 2.0 * math.pi * u2[..., 1]
    wi_d = normalize(-ldir + (r_sun * torch.cos(phi_d))[..., None] * t_ax
                     + (r_sun * torch.sin(phi_d))[..., None] * b_ax)
    dist_d = torch.full((R,), 1e30, device=p.device)

    # quad: the rectangle about lpos on the axes of ldir, rotated in
    # plane by z_rot (reference ZAxisRotation, CommonData.cginc:1826)
    cz, sz = torch.cos(zr), torch.sin(zr)
    ou = (u2[..., 0] - 0.5) * 2.0 * ext[:, 0]
    ov = (u2[..., 1] - 0.5) * 2.0 * ext[:, 1]
    ou, ov = cz * ou - sz * ov, sz * ou + cz * ov
    qpos = lpos + ou[..., None] * t_ax + ov[..., None] * b_ax
    to_q = qpos - p
    d2q = torch.clamp(dot(to_q, to_q), min=1e-8)
    dist_q = torch.sqrt(d2q)
    wi_q = to_q / dist_q[..., None]
    cos_q = -dot(wi_q, ldir)
    area_q = torch.clamp(4.0 * ext[:, 0] * ext[:, 1], min=1e-8)
    pdf_q = d2q / torch.clamp(cos_q * area_q, min=1e-8)

    # disk of radius ext[:, 0]
    r_d = torch.sqrt(u2[..., 0]) * ext[:, 0]
    phi = 2.0 * math.pi * u2[..., 1]
    dpos = (lpos + (r_d * torch.cos(phi))[..., None] * t_ax
            + (r_d * torch.sin(phi))[..., None] * b_ax)
    to_dk = dpos - p
    d2d = torch.clamp(dot(to_dk, to_dk), min=1e-8)
    dist_dk = torch.sqrt(d2d)
    wi_dk = to_dk / dist_dk[..., None]
    cos_dk = -dot(wi_dk, ldir)
    area_d = torch.clamp(math.pi * ext[:, 0] * ext[:, 0], min=1e-8)
    pdf_d = d2d / torch.clamp(cos_dk * area_d, min=1e-8)

    is_quad = lt == LIGHT_QUAD
    is_disk = lt == LIGHT_DISK
    is_dir = lt == LIGHT_DIR
    is_spot = lt == LIGHT_SPOT
    is_area = is_quad | is_disk
    v = lambda m: m[..., None]
    wi = torch.where(v(is_dir), wi_d, torch.where(
        v(is_quad), wi_q, torch.where(v(is_disk), wi_dk, wi_p)))
    dist = torch.where(is_dir, dist_d, torch.where(
        is_quad, dist_q, torch.where(is_disk, dist_dk, dist_p)))
    radiance = torch.where(v(is_dir), lrad, torch.where(
        v(is_spot), rad_spot, torch.where(v(is_area), lrad, rad_point)))
    pdf_sa = torch.where(is_quad, pdf_q, torch.where(is_disk, pdf_d, 1.0))
    valid = torch.where(is_quad, cos_q > 1e-6, torch.where(
        is_disk, cos_dk > 1e-6, torch.where(is_spot, spot_w > 0.0, True)))
    return AnalyticSample(wi=wi, dist=dist, radiance=radiance,
                          pdf_sa=torch.clamp(pdf_sa, min=1e-12), pmf=pmf,
                          is_delta=~is_area, valid=valid)


# ---------------------------------------------------------------------------
# streaming RIS selection (reference SelectUnityLight + its RIS count):
# N uniform candidates, each weighted by a cheap unshadowed-contribution
# target, one kept by reservoir sampling; its unbiased RIS weight is
# returned as an effective pmf
# ---------------------------------------------------------------------------

def analytic_target_weight(lights: AnalyticLights, idx, p):
    """A positive target ~ the unshadowed luminance contribution of light
    `idx` seen from `p` (light sampled at its centre), plus a floor that
    keeps every light with power selectable (soft-jittered spots,
    edge-on area lights)."""
    lt = lights.ltype[idx]
    lpos = lights.position[idx]
    ldir = normalize(lights.direction[idx])
    lum = (0.2126 * lights.radiance[idx, 0]
           + 0.7152 * lights.radiance[idx, 1]
           + 0.0722 * lights.radiance[idx, 2])
    ext = lights.extent[idx]
    to_l = lpos - p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-8)
    wi = to_l / torch.sqrt(d2)[..., None]
    w_point = lum / d2
    cos_spot = -dot(wi, ldir)
    inner = lights.spot_cos[idx, 0]
    outer = lights.spot_cos[idx, 1]
    spot_w = torch.clamp((cos_spot - outer)
                         / torch.clamp(inner - outer, min=1e-6), 0.0, 1.0)
    w_spot = w_point * spot_w * spot_w
    area = torch.where(lt == LIGHT_DISK, math.pi * ext[:, 0] * ext[:, 0],
                       4.0 * ext[:, 0] * ext[:, 1])
    w_area = lum * area * torch.clamp(-dot(wi, ldir), min=0.0) / d2
    w = torch.where(lt == LIGHT_DIR, lum, torch.where(
        lt == LIGHT_SPOT, w_spot, torch.where(
            (lt == LIGHT_QUAD) | (lt == LIGHT_DISK), w_area, w_point)))
    return w + 1e-4 * lum / (1.0 + d2)


def sample_analytic_ris(lights: AnalyticLights, p, u_cands, u_keep,
                        u2) -> AnalyticSample:
    """Streaming RIS over N = u_cands.shape[1] uniform candidates
    (u_cands / u_keep [R,N]: the pick and keep uniforms). The kept
    light's effective pmf is 1/W with W = sum_c w_c / (N w_sel) and
    w_c = K target(c): the standard RIS estimator, unbiased."""
    K = lights.position.shape[0]
    R = p.shape[0]
    if K == 0:
        return _empty_sample(R, p.device)
    N = u_cands.shape[1]
    wsum = torch.zeros((R,), device=p.device)
    sel_idx = torch.zeros((R,), dtype=torch.int64, device=p.device)
    sel_tw = torch.zeros((R,), device=p.device)
    for c in range(N):
        idx_c = _uniform_index(u_cands[:, c], K)
        tw = analytic_target_weight(lights, idx_c, p)
        w_c = tw * K                       # target / (1/K) proposal
        wsum = wsum + w_c
        take = u_keep[:, c] * torch.clamp(wsum, min=1e-20) < w_c
        sel_idx = torch.where(take, idx_c, sel_idx)
        sel_tw = torch.where(take, tw, sel_tw)
    W = wsum / torch.clamp(N * sel_tw, min=1e-20)
    pmf_eff = 1.0 / torch.clamp(W, min=1e-20)
    s = sample_analytic_idx(lights, sel_idx, pmf_eff, p, u2)
    return s._replace(valid=s.valid & (wsum > 0.0))
