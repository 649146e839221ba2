"""ReSTIR DI: reservoir-based spatiotemporal reuse of direct-light samples.

Port of `truetrace_tpu/integrate/restir_di.py`: streaming RIS over fresh
light samples, then temporal (motion-reprojected) and spatial reuse
(Bitterli et al. 2020). A sample is a point on an emissive triangle
(position, normal, radiance) in area measure, so spatial reuse needs no
Jacobian. Target p_hat = luminance(Le) * G, BSDF-free; the BSDF and the
visibility come in once, at the path tracer's bounce-0 NEE, which takes
the reservoir samples (`pathtrace.trace_rays(di_sample=...)`).

Reservoirs are image-shaped tensors; the randomness is the tracer's
counter RNG, so the port draws the JAX package's numbers. A reservoir
keeps a candidate where u * wsum < w: where the two sides agree to the
last ulps, the two packages may decide a lane differently.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from truetrace_tpu_torch.core import rng
from truetrace_tpu_torch.core.math import cross, dot, luminance, safe_div
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.scene.ir import Camera, Scene

M_CAP = 32.0
SPATIAL_TAPS = ((2, 1), (-1, 2), (-2, -1), (1, -2))
DEPTH_GATE = 0.1
NORMAL_GATE = 0.9


def _state_from_numpy(cls, d: dict, device):
    return cls(**{f.name: torch.from_numpy(d[f.name].astype("float32"))
                  .to(device) for f in dataclasses.fields(cls)})


@dataclass
class ReSTIRDIState:
    pos: torch.Tensor     # [H,W,3] point on light
    ln: torch.Tensor      # [H,W,3] light normal
    rad: torch.Tensor     # [H,W,3] emitted radiance
    M: torch.Tensor       # [H,W]
    W: torch.Tensor       # [H,W] unbiased contribution weight (area)
    normal: torch.Tensor  # [H,W,3] receiver G-buffer of last frame
    depth: torch.Tensor   # [H,W]

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "ReSTIRDIState":
        z = lambda *s: torch.zeros((h, w) + s, device=device)
        return ReSTIRDIState(pos=z(3), ln=z(3), rad=z(3), M=z(), W=z(),
                             normal=z(3), depth=z())

    @staticmethod
    def from_numpy(d: dict, device) -> "ReSTIRDIState":
        return _state_from_numpy(ReSTIRDIState, d, device)


def reproject(state, mv):
    """The reservoir image `state` (a dataclass of [H,W,...] tensors) read
    at each pixel's history position (motion mv [H,W,2]); M is 0 where
    that position falls outside the frame."""
    H, W = state.M.shape
    dev = mv.device
    sy = torch.arange(H, device=dev)[:, None] - mv[..., 1]
    sx = torch.arange(W, device=dev)[None, :] - mv[..., 0]
    ys = torch.clamp(torch.round(sy).to(torch.int64), 0, H - 1)
    xs = torch.clamp(torch.round(sx).to(torch.int64), 0, W - 1)
    inb = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    out = {f.name: getattr(state, f.name)[ys, xs]
           for f in dataclasses.fields(state)}
    out["M"] = torch.where(inb, out["M"], 0.0)
    return type(state)(**out)


def neighbour(dy: int, dx: int, H: int, W: int, device):
    """(nb, inb): nb(a)[y, x] = a[y - dy, x - dx] (cyclic, jnp.roll), and
    the mask of pixels whose source lies inside the frame."""
    ys = torch.arange(H, device=device)[:, None] - dy
    xs = torch.arange(W, device=device)[None, :] - dx
    inb = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    return (lambda a: torch.roll(a, shifts=(dy, dx), dims=(0, 1))), inb


def geometry_gate(n1, depth, n_other, d_other):
    """Receivers alike enough to share reservoirs: normals within
    NORMAL_GATE, depths within DEPTH_GATE (relative)."""
    return (dot(n1, n_other) > NORMAL_GATE) \
        & ((depth - d_other).abs()
           < DEPTH_GATE * torch.clamp(depth, min=1e-3))


def keep(u, wsum, w):
    """The reservoir's streaming pick: take the new candidate of weight
    w, out of a running sum wsum, where u * wsum < w."""
    return (u * torch.clamp(wsum, min=1e-20)) < w


def _p_hat(x1, n1, pos, ln, rad):
    """Target: luminance(Le) * G = lum * cos1 * cos_l / d^2 (area
    measure, unshadowed)."""
    d = pos - x1
    d2 = torch.clamp(dot(d, d), min=1e-8)
    wi = d * torch.rsqrt(d2)[..., None]
    cos1 = torch.clamp(dot(wi, n1), min=0.0)
    cos_l = torch.clamp(-dot(wi, ln), min=0.0)
    return luminance(rad) * cos1 * cos_l / d2


def _pick3(take, new, old):
    return tuple(torch.where(take[..., None], a, b) for a, b in zip(new, old))


def restir_di_reservoirs(scene: Scene, cam: Camera, cfg: RenderConfig,
                         state: ReSTIRDIState, sample_id, x1, n1, depth,
                         n_candidates: int = 8, n_spatial: int = 1,
                         prev_cam: Optional[Camera] = None, motion=None):
    """RIS + temporal + spatial reservoir reuse over light samples.

    x1/n1/depth: this frame's primary G-buffer images [H,W(,3)]. Returns
    (di_sample {pos, ln, rad [R,3], W [R]} flattened for
    pathtrace.trace_rays, new state)."""
    H, W = cfg.height, cfg.width
    dev = depth.device
    sid = sample_id
    has_surf = depth > 0
    lt = scene.light_tris
    L = lt.tri_index.shape[0]
    pix2 = torch.arange(H * W, device=dev).reshape(H, W)
    u1 = lambda dim: rng.uniform1(pix2, sid, dim)
    u2 = lambda dim: rng.uniform2(pix2, sid, dim)

    # ---- streaming RIS over n_candidates fresh light samples
    res = (torch.zeros((H, W, 3), device=dev),) * 3        # pos, ln, rad
    wsum = torch.zeros((H, W), device=dev)
    for k in range(n_candidates):
        us = u1(300 + 3 * k)
        uv = u2(301 + 3 * k)
        idx = torch.clamp(torch.searchsorted(lt.cdf, us), 0, L - 1)
        pmf = lt.pmf[idx]
        tid = lt.tri_index[idx]
        e1, e2 = scene.tri_e1[tid], scene.tri_e2[tid]
        su = torch.sqrt(uv[..., 0])
        b1 = 1.0 - su
        b2 = uv[..., 1] * su
        pos = scene.tri_p0[tid] + e1 * b1[..., None] + e2 * b2[..., None]
        gn = cross(e1, e2)
        area2 = torch.linalg.norm(gn, dim=-1)
        ln = gn / torch.clamp(area2, min=1e-20)[..., None]
        rad = scene.materials.emission[scene.tri_mat[tid]]
        pdf_area = safe_div(pmf, torch.clamp(0.5 * area2, min=1e-12))
        ph = _p_hat(x1, n1, pos, ln, rad)
        w = torch.where(has_surf & (pdf_area > 0), safe_div(ph, pdf_area),
                        0.0)
        wsum_new = wsum + w
        res = _pick3(keep(u1(302 + 3 * k), wsum_new, w), (pos, ln, rad), res)
        wsum = wsum_new
    M = torch.full((H, W), float(n_candidates), device=dev)

    # ---- temporal reuse (motion-reprojected)
    prev = state
    if prev_cam is not None or motion is not None:
        if motion is None:
            from truetrace_tpu_torch.post.motion import motion_vectors
            motion = motion_vectors(prev_cam, cam, depth)
        prev = reproject(state, motion)
    hist_ok = geometry_gate(n1, depth, prev.normal, prev.depth) \
        & (prev.M > 0)
    M_prev = torch.where(hist_ok, torch.clamp(prev.M, max=M_CAP), 0.0)
    w_prev = prev.W * M_prev * _p_hat(x1, n1, prev.pos, prev.ln, prev.rad)
    wsum_new = wsum + w_prev
    res = _pick3(keep(u1(340), wsum_new, w_prev),
                 (prev.pos, prev.ln, prev.rad), res)
    wsum = wsum_new
    M = M + M_prev
    ph_sel = _p_hat(x1, n1, *res)
    W_out = torch.where(ph_sel > 1e-12, safe_div(
        wsum, M * torch.clamp(ph_sel, min=1e-12)), 0.0)

    # ---- spatial reuse (no Jacobian: samples live in area measure).
    # Each tap reads the pass-start M and W but the reservoir as the
    # earlier taps of the pass left it, as the JAX package does.
    for sp in range(n_spatial):
        wsum = W_out * M * _p_hat(x1, n1, *res)
        acc_M = M
        for k, (dy0, dx0) in enumerate(SPATIAL_TAPS):
            nb, inb = neighbour(dy0 * (sp + 1), dx0 * (sp + 1), H, W, dev)
            ok = inb & geometry_gate(n1, depth, nb(n1), nb(depth)) \
                & (nb(M) > 0) & (nb(W_out) > 0)
            cand = tuple(nb(a) for a in res)
            M_n = torch.where(ok, torch.clamp(nb(M), max=M_CAP), 0.0)
            w_n = torch.where(ok, nb(W_out) * M_n * _p_hat(x1, n1, *cand),
                              0.0)
            wsum_new = wsum + w_n
            res = _pick3(keep(u1(350 + sp * 8 + k), wsum_new, w_n), cand,
                         res)
            wsum = wsum_new
            acc_M = acc_M + M_n
        M = acc_M
        ph_sel = _p_hat(x1, n1, *res)
        W_out = torch.where(ph_sel > 1e-12, safe_div(
            wsum, M * torch.clamp(ph_sel, min=1e-12)), 0.0)

    r_pos, r_ln, r_rad = res
    new_state = ReSTIRDIState(pos=r_pos, ln=r_ln, rad=r_rad, M=M, W=W_out,
                              normal=n1, depth=depth)
    di_sample = {"pos": r_pos.reshape(-1, 3), "ln": r_ln.reshape(-1, 3),
                 "rad": r_rad.reshape(-1, 3),
                 "W": torch.where(has_surf, W_out, 0.0).reshape(-1)}
    return di_sample, new_state


def restir_di_step(scene: Scene, cam: Camera, cfg: RenderConfig,
                   state: ReSTIRDIState, sample_id, n_candidates: int = 8,
                   n_spatial: int = 1, prev_cam: Optional[Camera] = None):
    """One standalone ReSTIR DI frame: a 1-bounce G-buffer prepass feeds
    the reservoirs, then the full path trace (cfg.bounces) runs with the
    reservoir samples driving its bounce-0 mesh-light NEE. Returns
    (image [H,W,3], new state, {"emitted": prepass image})."""
    H, W = cfg.height, cfg.width
    pixel = torch.arange(H * W, device=scene.device)
    gcfg = dataclasses.replace(cfg, bounces=1, use_nee=False,
                               restir_capture=True)
    emitted, st = render_sample_with_stats(scene, cam, gcfg, pixel,
                                           sample_id)
    di_sample, new_state = restir_di_reservoirs(
        scene, cam, cfg, state, sample_id, st["x1"].reshape(H, W, 3),
        st["normal"].reshape(H, W, 3), st["depth"].reshape(H, W),
        n_candidates=n_candidates, n_spatial=n_spatial, prev_cam=prev_cam)
    rad, _ = render_sample_with_stats(scene, cam, cfg, pixel, sample_id,
                                      di_sample=di_sample)
    img = torch.nan_to_num(rad.reshape(H, W, 3), nan=0.0, posinf=0.0)
    return img, new_state, {"emitted": emitted.reshape(H, W, 3)}
