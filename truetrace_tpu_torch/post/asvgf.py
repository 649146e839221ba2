"""ASVGF: SVGF driven by sparse temporal gradient samples.

Port of `truetrace_tpu/post/asvgf.py`. A 1-in-9 stratum of pixels is
traced again with the previous frame's sample id (the RNG is a pure
counter stream, so that replays last frame's random decisions); the
relative luminance difference against what last frame saw is diffused
by a max-preserving à-trous chain at 1/3 resolution into a per-pixel
history-clamp alpha. The demodulated irradiance is split into a
1/3-resolution low-frequency field (a long, gradient-clamped history
and wide depth-stopped passes) and a full-resolution residual that goes
through SVGF with the alpha map. With ReSTIR GI the gradient comes from
its temporal validation instead (`gradient_alpha`), with no replay.

The stencils are torch ops (`torch.roll`), as the JAX ones are XLA ops;
the replay runs the traversal kernels at (H/3)(W/3) lanes and the
residual's SVGF the à-trous kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from truetrace_tpu_torch.core.math import luminance
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.post.svgf import SVGFState, _shift, svgf_denoise

STRATUM = 3           # 1-in-9 gradient pixels, like the reference
ALPHA_MIN = 0.05
ALPHA_MAX = 1.0
N_GRAD_ATROUS = 5
N_LF_ATROUS = 4
LF_ALPHA = 0.1        # LF temporal blend (long history)


@dataclass
class ASVGFState:
    svgf: SVGFState             # HF chain state
    prev_lum: torch.Tensor      # [Hs,Ws] stratum luminance of last frame
    prev_sid: torch.Tensor      # [] int64, last frame's sample id
    lf_hist: torch.Tensor       # [Hl,Wl,3] low-frequency history
    lf_len: torch.Tensor        # [Hl,Wl] LF history length

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "ASVGFState":
        hs, ws = h // STRATUM, w // STRATUM
        hl, wl = -(-h // STRATUM), -(-w // STRATUM)
        return ASVGFState(
            svgf=SVGFState.create(h, w, device),
            prev_lum=torch.zeros((hs, ws), device=device),
            prev_sid=torch.zeros((), dtype=torch.int64, device=device),
            lf_hist=torch.zeros((hl, wl, 3), device=device),
            lf_len=torch.zeros((hl, wl), device=device))

    @staticmethod
    def from_numpy(d: dict, device) -> "ASVGFState":
        t = lambda k, dt=None: torch.from_numpy(
            d[k].astype(dt) if dt else d[k].copy()).to(device)
        return ASVGFState(svgf=SVGFState.from_numpy(d["svgf"], device),
                          prev_lum=t("prev_lum"),
                          prev_sid=t("prev_sid", "int64"),
                          lf_hist=t("lf_hist"), lf_len=t("lf_len"))


def sample_id_tensor(sample_id, device) -> torch.Tensor:
    """A sample id (a Python int, or a 0-d tensor on the card as
    graph_step captures it) as a 0-d int64 tensor: the id kept as the
    next frame's prev_sid. A fill kernel, not a copy of host data."""
    if isinstance(sample_id, torch.Tensor):
        return sample_id.to(torch.int64)
    return torch.full((), sample_id, dtype=torch.int64, device=device)


def _stratum_pixels(h: int, w: int, device):
    ys = torch.arange(h // STRATUM, device=device) * STRATUM + 1
    xs = torch.arange(w // STRATUM, device=device) * STRATUM + 1
    return (ys[:, None] * w + xs[None, :]).reshape(-1)


_K1D = (1 / 4, 1 / 2, 1 / 4)


def gradient_atrous(grad, n_passes: int = N_GRAD_ATROUS):
    """Diffuse the sparse stratum gradient into a smooth field:
    max-preserving weighted à-trous, so a single changed cell discounts
    its neighbourhood's history."""
    g = grad
    for it in range(n_passes):
        step = 1 << it
        acc = torch.zeros_like(g)
        wacc = torch.zeros_like(g)
        for i, ky in enumerate(_K1D):
            for j, kx in enumerate(_K1D):
                k = ky * kx
                acc = acc + _shift(g, (i - 1) * step, (j - 1) * step) * k
                wacc = wacc + k
        g = torch.maximum(acc / wacc, 0.7 * g)
    return g


def _down3(img):
    """3x3 box downsample to stratum resolution (edge-padded)."""
    H, W = img.shape[:2]
    ph, pw = (-H) % STRATUM, (-W) % STRATUM
    if ph or pw:
        rows = torch.cat([torch.arange(H, device=img.device),
                          torch.full((ph,), H - 1, device=img.device)])
        cols = torch.cat([torch.arange(W, device=img.device),
                          torch.full((pw,), W - 1, device=img.device)])
        img = img[rows][:, cols]
    hl, wl = img.shape[0] // STRATUM, img.shape[1] // STRATUM
    return img.reshape((hl, STRATUM, wl, STRATUM) + img.shape[2:]).mean(
        dim=(1, 3))


def _up3(img, h, w):
    up = img.repeat_interleave(STRATUM, 0).repeat_interleave(STRATUM, 1)
    return up[:h, :w]


def _lf_atrous(lf, depth_l, n_passes: int = N_LF_ATROUS):
    """Wide à-trous at 1/3 resolution, depth-edge-stopped."""
    out = lf
    for it in range(n_passes):
        step = 1 << it
        acc = torch.zeros_like(out)
        wacc = torch.zeros(out.shape[:2], dtype=out.dtype,
                           device=out.device)
        for i, ky in enumerate(_K1D):
            for j, kx in enumerate(_K1D):
                k = ky * kx
                dy, dx = (i - 1) * step, (j - 1) * step
                if (i, j) == (1, 1):
                    wgt = torch.full_like(depth_l, k)
                else:
                    dz = (depth_l - _shift(depth_l, dy, dx)).abs()
                    wgt = k * torch.exp(-dz / (depth_l.abs() * 0.05 + 1e-2))
                acc = acc + _shift(out, dy, dx) * wgt[..., None]
                wacc = wacc + wgt
        out = acc / torch.clamp(wacc, min=1e-8)[..., None]
    return out


def _alpha(grad_full):
    return torch.clamp(ALPHA_MIN + grad_full * (ALPHA_MAX - ALPHA_MIN),
                       ALPHA_MIN, ALPHA_MAX)


def asvgf_gradient(scene, cam, cfg: RenderConfig, state: ASVGFState,
                   sample_id, rad_flat):
    """Stratum replay with the previous sample id, the gradient, its
    à-trous chain. Returns (alpha_map [H,W], grad_full [H,W], the
    stratum luminance of this frame [Hs,Ws], the sample id as a 0-d
    int64 tensor)."""
    H, W = cfg.height, cfg.width
    dev = rad_flat.device
    sid = sample_id_tensor(sample_id, dev)
    strat = _stratum_pixels(H, W, dev)
    Hs, Ws = H // STRATUM, W // STRATUM
    replay, _ = render_sample_with_stats(scene, cam, cfg, strat,
                                         state.prev_sid)
    lum_replay = luminance(replay).reshape(Hs, Ws)
    denom = torch.clamp(torch.maximum(lum_replay, state.prev_lum), min=1e-4)
    grad_s = (lum_replay - state.prev_lum).abs() / denom
    g = gradient_atrous(grad_s)
    grad_full = _up3(g, H, W)
    if grad_full.shape != (H, W):
        rows = torch.clamp(torch.arange(H, device=dev),
                           max=grad_full.shape[0] - 1)
        cols = torch.clamp(torch.arange(W, device=dev),
                           max=grad_full.shape[1] - 1)
        grad_full = grad_full[rows][:, cols]
    cur_lum = luminance(rad_flat[strat]).reshape(Hs, Ws)
    return _alpha(grad_full), grad_full, cur_lum, sid


def gradient_alpha(gradient, h, w):
    """A full-resolution sparse gradient image (ReSTIR GI's validation
    gradients) through the stratum-resolution chain to a history-clamp
    alpha map. Returns (alpha [h,w], the diffused gradient [h,w])."""
    gl = _down3(gradient) * (STRATUM * STRATUM)   # sparse cells -> density
    gl = gradient_atrous(torch.clamp(gl, 0.0, 1.0))
    gf = _up3(gl, h, w)
    return _alpha(gf), gf


def asvgf_filter(img, albedo, normal, depth, state: ASVGFState,
                 alpha_map, motion=None, emissive=None):
    """LF/HF split filtering. Returns (filtered [H,W,3], new SVGF state,
    new LF history, new LF history length). emissive: directly visible
    radiance, passed through unfiltered."""
    H, W = depth.shape
    if emissive is not None:
        img = torch.clamp(img - emissive, min=0.0)
    alb = torch.clamp(albedo, min=0.05)
    demod = img / alb

    # ---- LF: 1/3-res field, long gradient-clamped history, wide filter
    lf_cur = _down3(demod)
    depth_l = _down3(depth)
    a_l = torch.clamp(_down3(alpha_map), min=LF_ALPHA)
    lf_len = torch.minimum(state.lf_len + 1.0,
                           1.0 / torch.clamp(a_l, min=1e-3))
    a_eff = torch.maximum(a_l, 1.0 / torch.clamp(lf_len, min=1.0))
    lf_t = torch.where((state.lf_len > 0)[..., None],
                       state.lf_hist + a_eff[..., None]
                       * (lf_cur - state.lf_hist), lf_cur)
    lf_full = _up3(_lf_atrous(lf_t, depth_l), H, W)

    # ---- HF: full-res residual through the variance-guided SVGF chain
    hf = (demod - lf_full) * alb
    hf_f, new_svgf = svgf_denoise(hf, albedo, normal, depth, state.svgf,
                                  alpha_map=alpha_map, motion=motion)
    out = torch.clamp(lf_full * alb + hf_f, min=0.0)
    if emissive is not None:
        out = out + emissive
    return out, new_svgf, lf_t, lf_len


def asvgf_step(scene, cam, cfg: RenderConfig, state: ASVGFState,
               sample_id):
    """Render one sample per pixel and denoise it with ASVGF. Returns
    (denoised [H,W,3], new_state, aux {gradient, alpha})."""
    H, W = cfg.height, cfg.width
    pixel = torch.arange(H * W, device=scene.device)
    rad, st = render_sample_with_stats(scene, cam, cfg, pixel, sample_id)
    alpha_map, grad_full, cur_lum, sid = asvgf_gradient(
        scene, cam, cfg, state, sample_id, rad)
    out, new_svgf, lf_hist, lf_len = asvgf_filter(
        rad.reshape(H, W, 3), st["albedo"].reshape(H, W, 3),
        st["normal"].reshape(H, W, 3), st["depth"].reshape(H, W), state,
        alpha_map, emissive=st["emitted0"].reshape(H, W, 3))
    return out, ASVGFState(svgf=new_svgf, prev_lum=cur_lum, prev_sid=sid,
                           lf_hist=lf_hist, lf_len=lf_len), {
        "gradient": grad_full, "alpha": alpha_map}


def restir_asvgf_step(scene, cam, cfg: RenderConfig, restir_state,
                      state: ASVGFState, sample_id, prev_cam=None):
    """ReSTIR-ASVGF: the ASVGF filter driven by ReSTIR GI's temporal
    validation gradients instead of a replay stratum. Returns (denoised
    [H,W,3], new ReSTIR state, new ASVGF state, aux {gradient, alpha})."""
    from truetrace_tpu_torch.integrate.restir import restir_gi_step
    H, W = cfg.height, cfg.width
    img, new_restir, aux = restir_gi_step(scene, cam, cfg, restir_state,
                                          sample_id, prev_cam=prev_cam)
    alpha_map, gf = gradient_alpha(aux["gradient"], H, W)
    out, new_svgf, lf_hist, lf_len = asvgf_filter(
        img, aux["albedo"], aux["normal"], aux["depth"], state, alpha_map,
        emissive=aux.get("emitted0"))
    return out, new_restir, ASVGFState(
        svgf=new_svgf, prev_lum=state.prev_lum,
        prev_sid=sample_id_tensor(sample_id, img.device),
        lf_hist=lf_hist, lf_len=lf_len), {"gradient": gf,
                                          "alpha": alpha_map}
