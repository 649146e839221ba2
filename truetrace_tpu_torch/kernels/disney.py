"""Full Disney BSDF (Burley 2012/2015): sample, evaluate, pdf — torch ops.

Port of `truetrace_tpu/kernels/disney.py`, line for line. Tangent space
has the shading normal as +z; `wo` points away from the surface, `wi` is
the sampled / evaluated direction. `mat` is a per-ray MaterialTable
(scene/ir.py `MaterialTable.gather`).

Lobes: 0 diffuse (+ retro, sheen, thin SSS blend), 1 specular (aniso
GGX, VNDF-sampled), 2 clearcoat (GTR1), 3 specular transmission.
`disney_sample` returns the pdf `disney_eval` reports for the same
direction (they share `_eval_local`).
"""
from __future__ import annotations

import math

import torch

from truetrace_tpu_torch.core.math import (
    cross, dot, luminance, normalize, to_local, to_world)

MIN_ALPHA = 1e-4
PI = math.pi


def _cmax(x, lo):
    return torch.clamp(x, min=lo)


def _schlick_weight(cos_t):
    m = torch.clamp(1.0 - cos_t, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _fresnel_dielectric(cos_i, eta):
    """Exact unpolarized dielectric Fresnel; eta = n_t / n_i."""
    cos_i = torch.clamp(cos_i, 0.0, 1.0)
    sin2_t = (1.0 - cos_i * cos_i) / _cmax(eta * eta, 1e-12)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(_cmax(1.0 - sin2_t, 1e-12))
    rs = (cos_i - eta * cos_t) / _cmax(cos_i + eta * cos_t, 1e-12)
    rp = (cos_t - eta * cos_i) / _cmax(cos_t + eta * cos_i, 1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, torch.clamp(f, 0.0, 1.0))


def _tint(base_color):
    lum = luminance(base_color)[..., None]
    return torch.where(lum > 0.0, base_color / _cmax(lum, 1e-6), 1.0)


def _alphas(mat):
    aspect = torch.sqrt(1.0 - 0.9 * mat.anisotropic)
    r2 = _cmax(mat.roughness * mat.roughness, MIN_ALPHA)
    ax = _cmax(r2 / aspect, MIN_ALPHA)
    ay = _cmax(r2 * aspect, MIN_ALPHA)
    return ax, ay


def _cc_alpha(mat):
    return _cmax((1.0 - mat.clearcoat_gloss) * 0.1
                 + mat.clearcoat_gloss * 0.001, 0.001)


def _ggx_d_aniso(h, ax, ay):
    hx = h[..., 0] / ax
    hy = h[..., 1] / ay
    t = hx * hx + hy * hy + h[..., 2] * h[..., 2]
    return 1.0 / _cmax(PI * ax * ay * t * t, 1e-12)


def _smith_lambda_aniso(w, ax, ay):
    wx = w[..., 0] * ax
    wy = w[..., 1] * ay
    wz = _cmax(w[..., 2].abs(), 1e-6)
    return 0.5 * (-1.0 + torch.sqrt(1.0 + (wx * wx + wy * wy) / (wz * wz)))


def _smith_g1_aniso(w, ax, ay):
    return 1.0 / (1.0 + _smith_lambda_aniso(w, ax, ay))


def _smith_g2_aniso(wo, wi, ax, ay):
    return 1.0 / (1.0 + _smith_lambda_aniso(wo, ax, ay)
                  + _smith_lambda_aniso(wi, ax, ay))


def _sample_vndf(wo, ax, ay, u2):
    """Heitz 2018 visible-normal sampling of anisotropic GGX (wo.z > 0)."""
    v = normalize(torch.stack([wo[..., 0] * ax, wo[..., 1] * ay,
                               wo[..., 2]], -1))
    lensq = v[..., 0] ** 2 + v[..., 1] ** 2
    inv = 1.0 / torch.sqrt(_cmax(lensq, 1e-12))
    t1 = torch.where(lensq[..., None] > 1e-9,
                     torch.stack([-v[..., 1] * inv, v[..., 0] * inv,
                                  torch.zeros_like(inv)], -1),
                     torch.tensor([1.0, 0.0, 0.0], device=v.device))
    t2 = cross(v, t1)
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v[..., 2])
    p2 = (1.0 - s) * torch.sqrt(_cmax(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(_cmax(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * v
    return normalize(torch.stack([nh[..., 0] * ax, nh[..., 1] * ay,
                                  _cmax(nh[..., 2], 1e-6)], -1))


def _gtr1_d(hz, a):
    hz = torch.clamp(hz, 0.0, 1.0)
    a2 = a * a
    t = _cmax(1.0 + (a2 - 1.0) * hz * hz, 1e-12)
    return (a2 - 1.0) / (PI * torch.log(a2) * t)


def _g1_cc(w):
    """Smith G1 with fixed alpha 0.25 (Disney clearcoat convention)."""
    a = 0.25
    wz = _cmax(w[..., 2].abs(), 1e-6)
    tan2 = (1.0 - wz * wz) / (wz * wz)
    return 2.0 / (1.0 + torch.sqrt(1.0 + a * a * tan2))


def lobe_probs(mat):
    metallic_brdf = mat.metallic
    specular_bsdf = (1.0 - mat.metallic) * mat.spec_trans
    dielectric_brdf = (1.0 - mat.spec_trans) * (1.0 - mat.metallic)
    p_spec = metallic_brdf + dielectric_brdf
    p_diff = dielectric_brdf
    p_cc = torch.clamp(mat.clearcoat, 0.0, 1.0)
    p_trans = specular_bsdf
    total = _cmax(p_spec + p_diff + p_cc + p_trans, 1e-9)
    return (p_diff / total, p_spec / total, p_cc / total, p_trans / total)


def _eval_diffuse(mat, wo, wi, h):
    cos_o = wo[..., 2].abs()
    cos_i = wi[..., 2]
    cos_d = dot(wi, h)
    fl = _schlick_weight(cos_i.abs())
    fv = _schlick_weight(cos_o)

    rr = 2.0 * mat.roughness * cos_d * cos_d
    f_lambert = (1.0 - 0.5 * fl) * (1.0 - 0.5 * fv)
    f_retro = rr * (fl + fv + fl * fv * (rr - 1.0))
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / _cmax(cos_i.abs() + cos_o, 1e-4) - 0.5) + 0.5)
    diff_w = torch.where(mat.thin > 0.5,
                         (1.0 - mat.subsurface) * (f_lambert + f_retro)
                         + mat.subsurface * ss,
                         f_lambert + f_retro)

    sheen_col = (1.0 - mat.sheen_tint)[..., None] + \
        mat.sheen_tint[..., None] * _tint(mat.base_color)
    f_sheen = (mat.sheen[..., None] * sheen_col
               * _schlick_weight(cos_d.abs())[..., None])

    f = mat.base_color / PI * diff_w[..., None] + f_sheen
    dt = mat.diff_trans * (mat.thin > 0.5)
    f = f * (1.0 - dt[..., None])
    refl = cos_i > 0.0
    f = torch.where(refl[..., None], f, 0.0)
    pdf = torch.where(refl, cos_i.abs() / PI, 0.0)
    return f, pdf


def _eval_specular(mat, wo, wi, h):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    refl = (cos_i > 0.0) & (cos_o > 0.0)
    ax, ay = _alphas(mat)
    d = _ggx_d_aniso(h, ax, ay)
    g1o = _smith_g1_aniso(wo, ax, ay)
    g2 = _smith_g2_aniso(wo, wi, ax, ay)
    hdotv = dot(wo, h).abs()

    tint = _tint(mat.base_color)
    f0_diel = (0.08 * mat.specular)[..., None] * \
        ((1.0 - mat.spec_tint)[..., None] + mat.spec_tint[..., None] * tint)
    f0 = f0_diel * (1.0 - mat.metallic)[..., None] \
        + mat.base_color * mat.metallic[..., None]
    fcol = f0 + (1.0 - f0) * _schlick_weight(hdotv)[..., None]

    denom = _cmax(4.0 * cos_i.abs() * cos_o.abs(), 1e-6)
    f = fcol * (d * g2 / denom)[..., None]
    pdf = d * g1o / _cmax(4.0 * cos_o.abs(), 1e-6)
    f = torch.where(refl[..., None], f, 0.0)
    pdf = torch.where(refl, pdf, 0.0)
    return f, pdf


def _eval_clearcoat(mat, wo, wi, h):
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    refl = (cos_i > 0.0) & (cos_o > 0.0)
    a = _cc_alpha(mat)
    d = _gtr1_d(h[..., 2].abs(), a)
    fr = 0.04 + 0.96 * _schlick_weight(dot(wo, h).abs())
    g = _g1_cc(wo) * _g1_cc(wi)
    denom = _cmax(4.0 * cos_i.abs() * cos_o.abs(), 1e-6)
    val = 0.25 * mat.clearcoat * d * fr * g / denom
    f = torch.where(refl, val, 0.0)[..., None] * torch.ones_like(
        mat.base_color)
    pdf = d * h[..., 2].abs() / _cmax(4.0 * dot(wo, h).abs(), 1e-6)
    pdf = torch.where(refl, pdf, 0.0)
    return f, pdf


def _eval_transmission(mat, wo, wi, eta):
    """Refraction side of the rough dielectric (wi.z < 0 < wo.z)."""
    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    trans = (cos_i < 0.0) & (cos_o > 0.0)
    ax, ay = _alphas(mat)
    h = normalize(wo + wi * eta[..., None])
    h = h * torch.where(h[..., 2:3] < 0.0, -1.0, 1.0)
    hdoto = dot(wo, h)
    hdoti = dot(wi, h)
    d = _ggx_d_aniso(h, ax, ay)
    g2 = _smith_g2_aniso(wo, wi, ax, ay)
    g1o = _smith_g1_aniso(wo, ax, ay)
    fr = _fresnel_dielectric(hdoto.abs(), eta)
    denom = hdoto + eta * hdoti
    denom2 = _cmax(denom * denom, 1e-8)
    val = (1.0 - fr) * d * g2 * (hdoto * hdoti).abs() \
        / _cmax((cos_o * cos_i).abs() * denom2, 1e-8)
    col = torch.sqrt(torch.clamp(mat.base_color, 1e-6, 1.0))
    f = torch.where(trans[..., None], val[..., None] * col, 0.0)
    jac = eta * eta * hdoti.abs() / denom2
    pdf_h = d * g1o * hdoto.abs() / _cmax(cos_o.abs(), 1e-6)
    pdf = pdf_h * jac * (1.0 - fr)
    pdf = torch.where(trans, pdf, 0.0)
    return f, pdf


def _eval_local(mat, wo, wi):
    """Combined BSDF value + effective sampling pdf, tangent space,
    wo.z > 0 (the caller flips the frame)."""
    p_diff, p_spec, p_cc, p_trans = lobe_probs(mat)
    eta = mat.ior

    hsum = wo + wi
    h_ok = dot(hsum, hsum) > 1e-12
    h_refl = normalize(hsum)
    h_refl = h_refl * torch.where(h_refl[..., 2:3] < 0.0, -1.0, 1.0)

    f_d, pdf_d = _eval_diffuse(mat, wo, wi, h_refl)
    f_s, pdf_s = _eval_specular(mat, wo, wi, h_refl)
    f_c, pdf_c = _eval_clearcoat(mat, wo, wi, h_refl)
    f_t, pdf_t = _eval_transmission(mat, wo, wi, eta)
    f_s = torch.where(h_ok[..., None], f_s, 0.0)
    f_c = torch.where(h_ok[..., None], f_c, 0.0)
    pdf_s = torch.where(h_ok, pdf_s, 0.0)
    pdf_c = torch.where(h_ok, pdf_c, 0.0)

    diel = (1.0 - mat.metallic) * (1.0 - mat.spec_trans)
    trans_w = (1.0 - mat.metallic) * mat.spec_trans
    fr_refl = _fresnel_dielectric(dot(wo, h_refl).abs(), eta)
    # the transmission lobe's Fresnel-reflect branch (untinted dielectric
    # GGX reflection weighted by the exact Fresnel)
    ax_t, ay_t = _alphas(mat)
    refl_up = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0) & h_ok
    den_r = _cmax(4.0 * (wi[..., 2] * wo[..., 2]).abs(), 1e-6)
    f_tr = torch.where(refl_up,
                       fr_refl * _ggx_d_aniso(h_refl, ax_t, ay_t)
                       * _smith_g2_aniso(wo, wi, ax_t, ay_t) / den_r, 0.0)
    f = (f_d * diel[..., None] + f_s + f_c + f_t * trans_w[..., None]
         + f_tr[..., None] * trans_w[..., None])
    pdf = (p_diff * pdf_d + (p_spec + p_trans * fr_refl) * pdf_s
           + p_cc * pdf_c + p_trans * pdf_t)
    return f, pdf


def _flip_frame(w, s):
    return w * torch.cat([torch.ones_like(s), torch.ones_like(s), s], -1)


def disney_eval(mat, n, wo_w, wi_w):
    """BSDF value + MIS pdf for world-space directions (two-sided: the
    frame is flipped so wo is in the upper hemisphere)."""
    wo = to_local(n, wo_w)
    wi = to_local(n, wi_w)
    s = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)[..., None]
    return _eval_local(mat, _flip_frame(wo, s), _flip_frame(wi, s))


def disney_sample(mat, n, wo_w, u_lobe, u2):
    """Sample the BSDF. Returns (wi_world, f, pdf, lobe_id)."""
    wo = to_local(n, wo_w)
    s = torch.where(wo[..., 2] < 0.0, -1.0, 1.0)[..., None]
    wo_u = _flip_frame(wo, s)

    p_diff, p_spec, p_cc, p_trans = lobe_probs(mat)
    c1 = p_diff
    c2 = c1 + p_spec
    c3 = c2 + p_cc
    lobe = torch.where(u_lobe < c1, 0, torch.where(
        u_lobe < c2, 1, torch.where(u_lobe < c3, 2, 3))).to(torch.int32)

    ax, ay = _alphas(mat)
    eta = mat.ior

    # diffuse: cosine hemisphere
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    wi_diff = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                           torch.sqrt(_cmax(1.0 - u2[..., 0], 0.0))], -1)

    # specular: VNDF half-vector reflect
    h_spec = _sample_vndf(wo_u, ax, ay, u2)
    wi_spec = 2.0 * dot(wo_u, h_spec)[..., None] * h_spec - wo_u

    # clearcoat: GTR1 half-vector reflect
    a_cc = _cc_alpha(mat)
    a2 = a_cc * a_cc
    cos2 = (1.0 - torch.pow(a2, 1.0 - u2[..., 0])) / (1.0 - a2)
    cos_h = torch.sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_h = torch.sqrt(_cmax(1.0 - cos2, 0.0))
    h_cc = torch.stack([sin_h * torch.cos(phi), sin_h * torch.sin(phi),
                        cos_h], -1)
    wi_cc = 2.0 * dot(wo_u, h_cc)[..., None] * h_cc - wo_u

    # transmission: same VNDF h; Fresnel picks reflect / refract with the
    # stretched remainder of u_lobe
    u_fr = torch.clamp((u_lobe - c3) / _cmax(p_trans, 1e-6), 0.0, 1.0)
    hdoto = dot(wo_u, h_spec)
    fr = _fresnel_dielectric(hdoto.abs(), eta)
    inv_eta = 1.0 / _cmax(eta, 1e-6)
    cos_ti2 = 1.0 - inv_eta * inv_eta * (1.0 - hdoto * hdoto)
    tir = cos_ti2 <= 0.0
    cos_ti = torch.sqrt(_cmax(cos_ti2, 0.0))
    wi_refr = normalize(-wo_u * inv_eta[..., None]
                        + (inv_eta * hdoto - cos_ti)[..., None] * h_spec)
    take_refl = tir | (u_fr < fr)
    wi_trans = torch.where(take_refl[..., None], wi_spec, wi_refr)

    lb = lobe[..., None]
    wi_u = torch.where(lb == 0, wi_diff, torch.where(
        lb == 1, wi_spec, torch.where(lb == 2, wi_cc, wi_trans)))

    f, pdf = _eval_local(mat, wo_u, wi_u)
    wi_world = to_world(n, _flip_frame(wi_u, s))
    return wi_world, f, pdf, lobe
