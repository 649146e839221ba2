"""ReSTIR GI: reservoir-based spatiotemporal reuse of indirect samples.

Port of `truetrace_tpu/integrate/restir.py` (the reference's ReSTIR GI
pipeline, ReSTIRGI.compute: temporal merge with M-cap, spatial taps with
geometric and material gates). A reservoir pixel stores the second path
vertex x2 (position, normal) and the radiance it sends toward the
receiver ("reconnection shift"); reuse at another receiver re-evaluates
the BSDF toward x2 and applies the solid-angle Jacobian. Target p_hat =
luminance(L) * cos(theta1), BSDF-free; the BSDF and the visibility (the
any-hit traversal kernel) come in once, at the final shade.

Every pass is image -> image (`torch.roll` taps gated at the frame's
edges); the randomness is the tracer's counter RNG.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from truetrace_tpu_torch.core import rng
from truetrace_tpu_torch.core.math import dot, luminance, normalize, safe_div
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, _occluded, get_bsdf, render_sample_with_stats)
from truetrace_tpu_torch.integrate.restir_di import (
    _state_from_numpy, geometry_gate, keep, neighbour, reproject)
from truetrace_tpu_torch.scene.ir import Camera, Scene

M_CAP = 20.0
SPATIAL_TAPS = ((3, 1), (-2, 3), (-3, -2), (2, -3))


@dataclass
class ReSTIRState:
    x2: torch.Tensor      # [H,W,3] sample point
    n2: torch.Tensor      # [H,W,3] sample normal
    rad: torch.Tensor     # [H,W,3] outgoing radiance of x2 toward receiver
    M: torch.Tensor       # [H,W]
    W: torch.Tensor       # [H,W] unbiased contribution weight
    normal: torch.Tensor  # [H,W,3] receiver G-buffer of last frame
    depth: torch.Tensor   # [H,W]

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "ReSTIRState":
        z = lambda *s: torch.zeros((h, w) + s, device=device)
        return ReSTIRState(x2=z(3), n2=z(3), rad=z(3), M=z(), W=z(),
                           normal=z(3), depth=z())

    @staticmethod
    def from_numpy(d: dict, device) -> "ReSTIRState":
        return _state_from_numpy(ReSTIRState, d, device)


def _p_hat(x1, n1, x2, rad):
    """Target function at receiver (x1, n1) for sample (x2, rad)."""
    to_s = x2 - x1
    d2 = torch.clamp(dot(to_s, to_s), min=1e-8)
    wi = to_s * torch.rsqrt(d2)[..., None]
    return luminance(rad) * torch.clamp(dot(wi, n1), min=0.0)


def _jacobian(x1_from, x1_to, x2, n2):
    """Solid-angle reconnection Jacobian of a sample made at receiver
    x1_from, moved to receiver x1_to."""
    def geom(x1):
        d = x1 - x2
        d2 = torch.clamp(dot(d, d), min=1e-8)
        return dot(d * torch.rsqrt(d2)[..., None], n2).abs() / d2
    return torch.clamp(safe_div(geom(x1_to), geom(x1_from)), 0.0, 10.0)


def _weight(wsum, M, p_hat):
    """The reservoir's unbiased contribution weight."""
    return torch.where(p_hat > 1e-9, safe_div(
        wsum, M * torch.clamp(p_hat, min=1e-9)), 0.0)


def restir_gi_step(scene: Scene, cam: Camera, cfg: RenderConfig,
                   state: ReSTIRState, sample_id, n_spatial: int = 2,
                   prev_cam: Camera = None, motion=None):
    """One ReSTIR GI frame: (image [H,W,3], new state, aux). The image is
    the path-traced direct light (bounce 0) plus the reservoir-shaded
    indirect. cfg.restir_capture must be True."""
    pixel = torch.arange(cfg.height * cfg.width, device=scene.device)
    _, st = render_sample_with_stats(scene, cam, cfg, pixel, sample_id)
    return restir_gi_from_stats(scene, cam, cfg, state, sample_id, st,
                                n_spatial=n_spatial, prev_cam=prev_cam,
                                motion=motion)


def restir_gi_from_stats(scene: Scene, cam: Camera, cfg: RenderConfig,
                         state: ReSTIRState, sample_id, st,
                         n_spatial: int = 2, prev_cam: Camera = None,
                         motion=None):
    """Reservoir update and final shade from a traced frame's capture
    dict `st` (render_sample_with_stats with restir_capture=True), so a
    composed frame shares one trace between the integrator, ReSTIR GI
    and the denoiser. Returns (image [H,W,3], new state, aux with the
    direct and indirect images, the temporal-validation gradient and the
    primary G-buffer)."""
    H, W = cfg.height, cfg.width
    dev = st["depth"].device
    im = lambda x, c=None: x.reshape((H, W) if c is None else (H, W, c))
    direct = im(st["direct"], 3)
    x1 = im(st["x1"], 3)
    n1 = im(st["normal"], 3)
    depth = im(st["depth"])
    mat1 = im(st["mat1"])
    # candidate: the radiance arriving from x2 (indirect over the first
    # bounce's throughput), where the path reached a second vertex
    L_cand = safe_div(im(st["indirect"], 3),
                      torch.clamp(im(st["tp1"], 3), min=1e-6))
    x2_c = im(st["x2"], 3)
    n2_c = im(st["n2"], 3)
    pdf1 = im(st["pdf1"])
    cand_ok = im(st["cand_valid"]) & (pdf1 > 1e-9) & (depth > 0)
    w_c = torch.where(cand_ok, safe_div(_p_hat(x1, n1, x2_c, L_cand), pdf1),
                      0.0)
    pix2 = torch.arange(H * W, device=dev).reshape(H, W)
    u = lambda dim: rng.uniform1(pix2, sample_id, dim)

    # ---- history, motion-reprojected; temporal merge gated on the
    # reprojected receiver G-buffer
    prev = state
    if prev_cam is not None or motion is not None:
        if motion is None:
            from truetrace_tpu_torch.post.motion import motion_vectors
            motion = motion_vectors(prev_cam, cam, depth)
        prev = reproject(state, motion)
    hist_ok = geometry_gate(n1, depth, prev.normal, prev.depth) \
        & (prev.M > 0)
    M_prev = torch.where(hist_ok, torch.clamp(prev.M, max=M_CAP), 0.0)

    # ---- temporal validation: where the fresh path found the same x2, a
    # large luminance change marks the stored radiance stale (history
    # dropped, a gradient for the denoiser)
    same_x2 = (torch.linalg.norm(x2_c - prev.x2, dim=-1)
               < 0.02 * torch.clamp(depth, min=1.0)) & cand_ok & hist_ok
    lum_old = luminance(prev.rad)
    lum_new = luminance(L_cand)
    denom = torch.clamp(torch.maximum(lum_old, lum_new), min=1e-4)
    gradient = torch.where(same_x2, (lum_new - lum_old).abs() / denom, 0.0)
    M_prev = torch.where(same_x2 & (gradient > 0.5), 0.0, M_prev)

    wsum = prev.W * M_prev * _p_hat(x1, n1, prev.x2, prev.rad) + w_c
    take_c = keep(u(101), wsum, w_c) | (M_prev <= 0)
    res = tuple(torch.where(take_c[..., None], a, b) for a, b in zip(
        (x2_c, n2_c, L_cand), (prev.x2, prev.n2, prev.rad)))
    res_M = M_prev + 1.0
    res_W = _weight(wsum, res_M, _p_hat(x1, n1, res[0], res[2]))

    # ---- spatial passes: each tap reads the pass-start reservoirs
    for sp in range(n_spatial):
        wsum = res_W * res_M * _p_hat(x1, n1, res[0], res[2])
        acc_M = res_M
        cur = res
        for k, (dy0, dx0) in enumerate(SPATIAL_TAPS):
            nb, inb = neighbour(dy0 * (sp + 1), dx0 * (sp + 1), H, W, dev)
            # in-frame, same material (reservoirs must not bleed across
            # material boundaries, ReSTIRGI.compute:319), alike geometry
            ok = inb & (nb(mat1) == mat1) \
                & geometry_gate(n1, depth, nb(n1), nb(depth)) \
                & (nb(res_M) > 0) & (nb(res_W) > 0)
            x2_n, n2_n, rad_n = (nb(a) for a in res)
            p_hat_n = _p_hat(x1, n1, x2_n, rad_n) \
                * _jacobian(nb(x1), x1, x2_n, n2_n)
            M_n = torch.where(ok, torch.clamp(nb(res_M), max=M_CAP), 0.0)
            w_n = torch.where(ok, nb(res_W) * M_n * p_hat_n, 0.0)
            wsum_new = wsum + w_n
            take = keep(u(110 + sp * 8 + k), wsum_new, w_n)
            cur = tuple(torch.where(take[..., None], a, b)
                        for a, b in zip((x2_n, n2_n, rad_n), cur))
            wsum = wsum_new
            acc_M = acc_M + M_n
        res = cur
        res_M = acc_M
        res_W = _weight(wsum, res_M, _p_hat(x1, n1, res[0], res[2]))

    # ---- final shade: the BSDF toward the chosen x2, and its visibility
    res_x2, res_n2, res_rad = res
    flat = lambda a, c=None: a.reshape((-1,) if c is None else (-1, c))
    to_s = res_x2 - x1
    dist = torch.sqrt(torch.clamp(dot(to_s, to_s), min=1e-8))
    wi = flat(to_s / dist[..., None], 3)
    _, bsdf_eval = get_bsdf(cfg.bsdf)
    mat = scene.materials.gather(flat(mat1))
    wo = normalize(cam.c2w[3, :3] - x1)
    f, _ = bsdf_eval(mat, flat(n1, 3), flat(wo, 3), wi)
    cos1 = torch.clamp(dot(wi, flat(n1, 3)), min=0.0)
    blocked = _occluded(scene, flat(x1 + n1 * 1e-4, 3).contiguous(),
                        wi.contiguous(), flat(dist) - 2e-4, cfg)
    contrib = f * flat(res_rad, 3) * (cos1 * flat(res_W) * ~blocked)[
        ..., None]
    indirect = torch.where((flat(res_M) > 0)[..., None], contrib, 0.0)
    indirect_img = torch.nan_to_num(indirect.reshape(H, W, 3), nan=0.0,
                                    posinf=0.0)
    new_state = ReSTIRState(x2=res_x2, n2=res_n2, rad=res_rad, M=res_M,
                            W=res_W, normal=n1, depth=depth)
    aux = {"direct": direct, "indirect": indirect_img, "gradient": gradient,
           "albedo": im(st["albedo"], 3), "normal": n1, "depth": depth,
           "emitted0": im(st["emitted0"], 3)}
    return direct + indirect_img, new_state, aux
