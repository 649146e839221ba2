"""Wavefront path-tracing integrator — torch port of the slice's path.

Port of `truetrace_tpu/integrate/pathtrace.py`: a fixed-shape ray batch
stepped through the bounces (a Python loop where JAX has fori_loop) with
masked dead lanes; NEE with MIS (power heuristic) against the emissive
triangles, by light-tree cut selection or the power CDF; Disney or
Lambert BSDF; Russian roulette; primary-hit G-buffer.

What the port covers is the opaque single-BLAS scene with a constant
environment, traversed by the CWBVH wavefront kernels. Everything else
raises NotImplementedError naming its ROADMAP.md item, never silently
ignored.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from truetrace_tpu_torch.core import rng
from truetrace_tpu_torch.core.math import (
    cross, dot, finite_or_zero, luminance, normalize, power_heuristic,
    sample_cosine_hemisphere, to_world)
from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
    any_hit_wavefront, closest_hit_wavefront)
from truetrace_tpu_torch.kernels.traverse_ref import Hit
from truetrace_tpu_torch.scene.ir import Camera, Scene, camera_rays

T_MAX = 1e30
SHADOW_EPS = 1e-4


@dataclass(frozen=True)
class RenderConfig:
    """The JAX package's RenderConfig fields. The port renders pcg
    sampling, wavefront traversal, and no ReSTIR / cache capture; the
    other values raise in `check_supported`."""
    width: int = 256
    height: int = 256
    bounces: int = 4
    use_nee: bool = True
    rr_start: int = 3
    bsdf: str = "lambert"
    max_leaf: int = 4
    traversal: str = "bvh2"
    light_sampling: str = "cdf"
    restir_capture: bool = False
    cache_capture: bool = False
    cache_query_bounce: int = -1
    nee_mis: str = "approx"
    sampler: str = "pcg"
    nee_rr: float = 0.0
    remat: bool = False
    debug_nee: str = ""
    fuse_nee: bool = False
    nee_sort: bool = False
    analytic_ris: int = 8


def _todo(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def check_supported(scene: Scene, cfg: RenderConfig) -> None:
    """Raise for every scene feature and option outside the ported path."""
    if cfg.traversal != "wavefront":
        _todo(f"traversal={cfg.traversal!r}",
              "A.14" if cfg.traversal == "tlas" else "A.19")
    if cfg.sampler != "pcg":
        _todo(f"sampler={cfg.sampler!r}", "A.19")
    if cfg.restir_capture:
        _todo("ReSTIR GI capture", "A.11")
    if cfg.cache_capture or cfg.cache_query_bounce >= 0:
        _todo("radiance cache", "A.12")
    if cfg.fuse_nee:
        _todo("fuse_nee (mixed_hit_wavefront)", "B")
    if cfg.nee_sort:
        _todo("nee_sort", "A.19")
    if cfg.debug_nee:
        _todo(f"debug_nee={cfg.debug_nee!r}", "A.19")
    if cfg.remat:
        _todo("remat (differentiable rendering)", "A.16")
    if cfg.nee_mis not in ("approx", "exact"):
        raise ValueError(f"unknown nee_mis {cfg.nee_mis!r}")
    if cfg.light_sampling not in ("tree", "cdf"):
        raise ValueError(f"unknown light_sampling {cfg.light_sampling!r}")
    if scene.tri_shadow is not None or scene.has_media:
        _todo("cutout / transmissive materials (transmit_wavefront, media)",
              "A.9")
    if scene.env.image.shape[0] > 1:
        _todo("textured environment maps", "A.6")
    if scene.lights.position.shape[0] > 0:
        _todo("analytic lights", "A.8")
    if scene.atlas_rects.shape[0] > 0:
        _todo("texture atlas", "A.7")
    if scene.terrain is not None:
        _todo("heightmap terrain", "A.14")


# ---------------------------------------------------------------------------
# BSDFs
# ---------------------------------------------------------------------------

def lambert_sample(mat, n, wo, u_lobe, u2):
    wi = to_world(n, sample_cosine_hemisphere(u2))
    cos_i = torch.clamp(dot(wi, n), min=0.0)
    pdf = cos_i / math.pi
    f = mat.base_color / math.pi
    return wi, f, pdf, torch.zeros_like(pdf, dtype=torch.int32)


def lambert_eval(mat, n, wo, wi):
    cos_i = torch.clamp(dot(wi, n), min=0.0)
    f = mat.base_color / math.pi * (cos_i > 0.0)[..., None]
    return f, cos_i / math.pi


def get_bsdf(name: str):
    if name == "lambert":
        return lambert_sample, lambert_eval
    if name == "disney":
        from truetrace_tpu_torch.kernels.disney import (
            disney_eval, disney_sample)
        return disney_sample, disney_eval
    raise ValueError(f"unknown bsdf {name!r}")


# ---------------------------------------------------------------------------
# light sampling (emissive triangles)
# ---------------------------------------------------------------------------

class LightSample(NamedTuple):
    pos: torch.Tensor       # [R,3] point on light
    normal: torch.Tensor    # [R,3] light geometric normal
    radiance: torch.Tensor  # [R,3]
    pdf_sa: torch.Tensor    # [R] solid-angle pdf from the shading point
    valid: torch.Tensor     # [R] bool
    pdf_w: torch.Tensor     # [R] MIS weighting pdf


def sample_light_tris(scene: Scene, p, u_sel, u2, sn=None,
                      use_tree: bool = False,
                      approx_mis: bool = False) -> LightSample:
    """One point on one emissive triangle per lane, from the packed
    [L,16] light rows (emission gathered live from the material table)."""
    lt = scene.light_tris
    L = lt.tri_index.shape[0]
    if use_tree:
        from truetrace_tpu_torch.kernels.lighttree import (
            sample_light_tree_cut)
        idx, pmf, _ = sample_light_tree_cut(
            scene.lbvh_pairs, scene.lbvh_prim, scene.lcut_bounds,
            scene.lcut_link, p, sn, u_sel, depth=scene.lbvh_depth,
            select_dtype=torch.bfloat16 if approx_mis else torch.float32)
        idx = torch.clamp(idx, 0, L - 1)
    else:
        idx = torch.clamp(torch.searchsorted(lt.cdf, u_sel), 0, L - 1)
        pmf = lt.pmf[idx]
    row = lt.rows[idx].t()                    # [16,R]
    su = torch.sqrt(u2[..., 0])
    b1 = 1.0 - su
    b2 = u2[..., 1] * su
    lpx = row[0] + row[3] * b1 + row[6] * b2
    lpy = row[1] + row[4] * b1 + row[7] * b2
    lpz = row[2] + row[5] * b1 + row[8] * b2
    tox = lpx - p[..., 0]
    toy = lpy - p[..., 1]
    toz = lpz - p[..., 2]
    d2 = torch.clamp(tox * tox + toy * toy + toz * toz, min=1e-12)
    inv_d = torch.rsqrt(d2)
    wix, wiy, wiz = tox * inv_d, toy * inv_d, toz * inv_d
    cos_l = -(wix * row[9] + wiy * row[10] + wiz * row[11])
    geo = d2 / torch.clamp(cos_l * row[12], min=1e-12)
    pdf_sa = pmf * geo
    valid = (cos_l > 1e-6) & (L > 0)
    pdf_w = row[13] * geo if (use_tree and approx_mis) else pdf_sa
    mid = row[14].to(torch.int64)
    emis = scene.materials.emission[torch.clamp(
        mid, 0, scene.materials.n_materials() - 1)]
    return LightSample(pos=torch.stack([lpx, lpy, lpz], -1),
                       normal=torch.stack([row[9], row[10], row[11]], -1),
                       radiance=emis, pdf_sa=pdf_sa, valid=valid,
                       pdf_w=pdf_w)


def light_pdf_sa(scene: Scene, tid, p, hit_p, cos_l, sn_prev=None,
                 use_tree: bool = False):
    """Solid-angle pdf with which NEE would have sampled this emissive
    hit (the MIS weight of BSDF-sampled emissive hits)."""
    li = scene.light_tris.tri_to_light[tid]
    if use_tree:
        from truetrace_tpu_torch.kernels.lighttree import light_tree_pdf_cut
        pmf = light_tree_pdf_cut(
            scene.lbvh_pairs, scene.lbvh_trail, scene.lcut_bounds,
            scene.lcut_link, scene.lcut_of_light, scene.lcut_skip,
            li, p, sn_prev, depth=scene.lbvh_depth)
    else:
        pmf = scene.light_tris.pmf[torch.clamp(li, min=0)]
    area = scene.light_tris.rows[torch.clamp(li, min=0), 12]
    to_l = hit_p - p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    pdf = pmf * d2 / torch.clamp(cos_l * area, min=1e-12)
    return torch.where(li >= 0, pdf, 0.0)


# ---------------------------------------------------------------------------
# traversal dispatch
# ---------------------------------------------------------------------------

def _trace(scene: Scene, ro, rd, alive) -> Hit:
    """Closest hit; dead lanes get t_max = 0 (they never hit)."""
    t_max = torch.where(alive, T_MAX, 0.0)
    return closest_hit_wavefront(scene.cw_table(), scene.cw_nodes.shape[0],
                                 ro, rd, t_max, max_stack=scene.cw_stack)


def _occluded(scene: Scene, ro, rd, t_max):
    return any_hit_wavefront(scene.cw_table(), scene.cw_nodes.shape[0],
                             ro, rd, t_max, max_stack=scene.cw_stack)


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------

def render_sample(scene: Scene, cam: Camera, cfg: RenderConfig,
                  sample_id) -> torch.Tensor:
    """One sample per pixel of the whole frame: [H*W,3] radiance."""
    pixel = torch.arange(cfg.width * cfg.height, device=scene.device)
    radiance, _ = render_sample_with_stats(scene, cam, cfg, pixel, sample_id)
    return radiance


def render_sample_with_stats(scene: Scene, cam: Camera, cfg: RenderConfig,
                             pixel, sample_id, cache=None, di_sample=None,
                             jitter=None):
    """One sample for the flat pixel ids `pixel` [R]. Returns (radiance
    [R,3], stats) with stats n_trace, n_shadow (ray counts), albedo,
    normal, depth and emitted0 (primary-hit G-buffer)."""
    if cache is not None or di_sample is not None:
        _todo("radiance cache / ReSTIR DI inputs", "A.11, A.12")
    if jitter is not None:
        _todo("TAAU jitter", "A.10")
    W, H = cfg.width, cfg.height
    pixel = pixel.to(torch.int64)
    jit2 = rng.uniform2(pixel, sample_id, rng.DIM_CAMERA_JITTER)
    lens_u = rng.uniform2(pixel, rng.u32(sample_id, pixel.device)
                          + 0x9E3779B9, rng.DIM_CAMERA_JITTER)
    ro, rd = camera_rays(cam, W, H, pixel, jit2, lens_u=lens_u)
    return trace_rays(scene, ro, rd, cfg, pixel, sample_id, cam=cam)


def trace_rays(scene: Scene, ro, rd, cfg: RenderConfig, pixel, sample_id,
               cam: Optional[Camera] = None):
    """Path-trace explicit primary rays. Returns (radiance [R,3], stats)."""
    check_supported(scene, cfg)
    dev = ro.device
    R = ro.shape[0]
    pixel = pixel.to(torch.int64)
    sid = sample_id
    bsdf_sample, bsdf_eval = get_bsdf(cfg.bsdf)
    u1 = lambda dim: rng.uniform1(pixel, sid, dim)
    u2 = lambda dim: rng.uniform2(pixel, sid, dim)

    f32 = dict(dtype=torch.float32, device=dev)
    radiance = torch.zeros((R, 3), **f32)
    throughput = torch.ones((R, 3), **f32)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    g_albedo = torch.ones((R, 3), **f32)
    g_normal = torch.zeros((R, 3), **f32)
    g_depth = torch.zeros((R,), **f32)
    r_emit0 = torch.zeros((R, 3), **f32)
    prev_pdf = torch.zeros((R,), **f32)   # 0 => previous bounce not MIS-able
    prev_n = torch.zeros((R, 3), **f32)
    n_trace = torch.zeros((), **f32)
    n_shadow = torch.zeros((), **f32)
    use_tree = (cfg.light_sampling == "tree"
                and scene.lbvh_pairs.shape[0] > 0)
    has_mesh = scene.light_tris.tri_index.shape[0] > 0
    n_groups = int(has_mesh) if cfg.use_nee else 0
    p_group = 1.0 / n_groups if n_groups else 1.0
    env_rgb = scene.env.image[0, 0] * scene.env.intensity

    for b in range(cfg.bounces):
        n_trace = n_trace + alive.float().sum()
        hit = _trace(scene, ro, rd, alive)
        hit_ok = (hit.tri >= 0) & alive

        # ---- miss: constant environment
        radiance = radiance + torch.where(
            (alive & ~(hit.tri >= 0))[..., None], throughput * env_rgb, 0.0)

        tid = torch.clamp(hit.tri.to(torch.int64), min=0)
        p = ro + rd * hit.t[..., None]
        gn = normalize(cross(scene.tri_e1[tid], scene.tri_e2[tid]))
        n0 = scene.tri_n[tid]
        w = 1.0 - hit.u - hit.v
        sn = normalize(n0[:, 0] * w[..., None] + n0[:, 1] * hit.u[..., None]
                       + n0[:, 2] * hit.v[..., None])
        # face-forward both normals against the incoming ray
        flip = dot(gn, rd) > 0.0
        front = ~flip
        gn = torch.where(flip[..., None], -gn, gn)
        sn = torch.where((dot(sn, rd) > 0.0)[..., None], -sn, sn)

        mid = scene.tri_mat[tid]
        mat = scene.materials.gather(mid)
        # roughness/metallic remap ranges ((0,1) = identity)
        mat.roughness = torch.clamp(
            mat.rough_remap[:, 0] + mat.roughness
            * (mat.rough_remap[:, 1] - mat.rough_remap[:, 0]), 1e-5, 1.0)
        mat.metallic = torch.clamp(
            mat.metal_remap[:, 0] + mat.metallic
            * (mat.metal_remap[:, 1] - mat.metal_remap[:, 0]), 0.0, 1.0)

        # ---- primary-hit G-buffer
        if b == 0:
            g_albedo = torch.where(hit_ok[..., None], mat.base_color,
                                   g_albedo)
            g_normal = torch.where(hit_ok[..., None], sn, g_normal)
            g_depth = torch.where(hit_ok, hit.t, g_depth)

        # ---- emissive hit (MIS against NEE)
        emis = mat.emission
        is_emis = emis.amax(-1) > 0.0
        cos_l = -dot(rd, gn)
        if cfg.use_nee and has_mesh and b > 0:
            l_pdf = light_pdf_sa(
                scene, tid, ro, p, torch.clamp(cos_l, min=1e-6),
                sn_prev=prev_n,
                use_tree=use_tree and cfg.nee_mis == "exact") * p_group
            mis_w = torch.where(prev_pdf <= 0.0, 1.0,
                                power_heuristic(prev_pdf, l_pdf))
        else:
            mis_w = torch.ones((R,), **f32)
        emit_take = hit_ok & is_emis & front
        radiance = radiance + torch.where(
            emit_take[..., None], throughput * emis * mis_w[..., None], 0.0)
        if b == 0:
            # emitted-at-primary (+ env on miss), before NEE: the
            # denoiser passes it through unfiltered
            r_emit0 = radiance

        # ---- NEE against the mesh lights
        wo = -rd
        if n_groups > 0:
            u_sel = u1(rng.path_dim(b, rng.DIM_LIGHT_SELECT))
            u_l2 = u2(rng.path_dim(b, rng.DIM_LIGHT_SAMPLE))
            g_pick = torch.clamp((u_sel * n_groups).to(torch.int64),
                                 0, n_groups - 1)
            u_resc = torch.clamp(u_sel * n_groups - g_pick.float(),
                                 0.0, 1.0 - 1e-7)
            ls = sample_light_tris(scene, p, u_resc, u_l2, sn=sn,
                                   use_tree=use_tree,
                                   approx_mis=cfg.nee_mis == "approx")
            to_l = ls.pos - p
            d_m = torch.linalg.norm(to_l, dim=-1)
            wi_l = to_l / torch.clamp(d_m, min=1e-12)[..., None]
            dist_l = d_m
            rad_l = ls.radiance
            pdf_l = ls.pdf_sa * p_group
            pdfw_l = ls.pdf_w * p_group
            valid_l = ls.valid

            f_l, pdf_b = bsdf_eval(mat, sn, wo, wi_l)
            cos_s = torch.clamp(dot(wi_l, sn), min=0.0)
            cand = (hit_ok & valid_l & (cos_s > 0.0) & (pdf_l > 1e-12)
                    & (f_l.amax(-1) > 0.0) & ~is_emis)
            w_mis = power_heuristic(pdfw_l, pdf_b)
            contrib = finite_or_zero(
                throughput * f_l * rad_l
                * (cos_s * w_mis / torch.clamp(pdf_l, min=1e-12))[..., None])
            if cfg.nee_rr > 0.0:
                u_srr = u1(rng.path_dim(b, rng.DIM_NEE_RR))
                p_s = torch.clamp(luminance(contrib) / cfg.nee_rr, 0.05, 1.0)
                cand = cand & (u_srr < p_s)
                contrib = contrib / p_s[..., None]
            sro = p + gn * SHADOW_EPS
            n_shadow = n_shadow + cand.float().sum()
            # non-candidate lanes shoot zero-length shadow rays
            s_tm = torch.where(cand, dist_l - 2.0 * SHADOW_EPS, 0.0)
            blocked = _occluded(scene, sro.contiguous(),
                                wi_l.contiguous(), s_tm)
            trans = torch.where(blocked[..., None], 0.0, 1.0)
            radiance = radiance + torch.where(cand[..., None],
                                              contrib * trans, 0.0)

        # ---- BSDF sample / continue
        u_lobe = u1(rng.path_dim(b, rng.DIM_BSDF_LOBE))
        u_dir = u2(rng.path_dim(b, rng.DIM_BSDF_SAMPLE))
        wi, f, pdf, _ = bsdf_sample(mat, sn, wo, u_lobe, u_dir)
        cos_i = dot(wi, sn).abs()
        ok = hit_ok & (pdf > 1e-9)
        new_tp = finite_or_zero(
            throughput * f * (cos_i / torch.clamp(pdf, min=1e-9))[..., None])

        # russian roulette
        if b >= cfg.rr_start:
            u_rr = u1(rng.path_dim(b, rng.DIM_RR))
            q = torch.clamp(new_tp.amax(-1), 0.05, 1.0)
            survive = u_rr < q
            new_tp = new_tp / torch.clamp(q, min=1e-9)[..., None]
        else:
            survive = torch.ones_like(ok)

        alive = ok & survive & (new_tp.amax(-1) > 0.0)
        side = torch.where(dot(wi, gn) >= 0.0, 1.0, -1.0)
        ro = (p + gn * (SHADOW_EPS * side[..., None])).contiguous()
        rd = wi.contiguous()
        throughput = torch.where(alive[..., None], new_tp, throughput)
        prev_pdf = torch.where(alive, pdf, 0.0)
        prev_n = sn

    stats = {"n_trace": n_trace, "n_shadow": n_shadow, "albedo": g_albedo,
             "normal": g_normal, "depth": g_depth, "emitted0": r_emit0}
    return radiance, stats


def render(scene: Scene, cam: Camera, cfg: RenderConfig, spp: int = 16,
           base_sample: int = 0) -> torch.Tensor:
    """[H, W, 3] averaging `spp` samples per pixel."""
    acc = torch.zeros((cfg.height * cfg.width, 3), device=scene.device)
    for s in range(spp):
        acc = acc + render_sample(scene, cam, cfg, base_sample + s)
    return (acc / spp).reshape(cfg.height, cfg.width, 3)
