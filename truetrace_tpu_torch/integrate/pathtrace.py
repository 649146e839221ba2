"""Wavefront path-tracing integrator — torch port of the slice's path.

Port of `truetrace_tpu/integrate/pathtrace.py`: a fixed-shape ray batch
stepped through the bounces (a Python loop where JAX has fori_loop) with
masked dead lanes; NEE with MIS (power heuristic) against the emissive
triangles, by light-tree cut selection or the power CDF; Disney or
Lambert BSDF; Russian roulette; primary-hit G-buffer.

What the port covers is the single-BLAS scene (traversal="bvh2", the
default, over the BVH2 of any build; traversal="wavefront" over the
CWBVH) and the instanced one (traversal="tlas": the two-level kernels,
normals and tangents rotated by the hit instance's L2W, NEE over the
instances' world light rows, the primary hit's instance in the stats),
each with or without a heightfield terrain (marched after the meshes,
the nearer hit kept, its layers' Disney parameters blended), under a
constant or textured environment (env NEE + MIS) and analytic lights (a
third NEE group, uniform or RIS selection; integrate/lights.py), with
atlas textures fetched at ray-cone mip levels; a per-frame TAAU subpixel
jitter; glass and cutout materials (shadow transmittance through the
tinted surfaces, the stochastic cutout pass-through, and the
nested-dielectric medium stack with Beer-Lambert absorption), and the
hooks of the composed frame: the ReSTIR GI capture (`restir_capture`),
the radiance cache's per-bounce records (`cache_capture`) and query
(`cache_query_bounce`), and the ReSTIR DI light samples that drive the
bounce-0 NEE (`di_sample`). Everything else raises NotImplementedError
naming its ROADMAP.md item, never silently ignored.

The loop is an autograd graph in the scene's parameters (material
columns, env intensity, analytic-light radiance; diff/render_grad.py)
with the JAX package's detached-sampling estimator: the hit record, the
shadow transmittance and the sampled direction and pdf are detached, so
no kernel is differentiated (their wrappers refuse a tensor that requires
grad). With `RenderConfig.remat` each bounce is a non-reentrant
`torch.utils.checkpoint` of `bounce`, a pure function of the loop-carried
state.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from truetrace_tpu_torch.core import rng
from truetrace_tpu_torch.core.math import (
    clip, cross, dot, finite_or_zero, luminance, normalize, power_heuristic,
    sample_cosine_hemisphere, to_world)
from truetrace_tpu_torch.kernels.cwbvh_tlas import (
    any_hit_tlas, closest_hit_tlas, transmit_tlas)
from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
    any_hit_wavefront, closest_hit_wavefront, transmit_wavefront)
from truetrace_tpu_torch.kernels.traverse_ref import (
    Hit, any_hit_bvh2, closest_hit_bvh2, transmit_brute)
from truetrace_tpu_torch.scene.ir import Camera, Scene, camera_rays

T_MAX = 1e30
SHADOW_EPS = 1e-4
# nested-dielectric medium stack depth (glass in water in ...); a push on
# a full stack overwrites the top entry
MED_STACK = 4


@dataclass(frozen=True)
class RenderConfig:
    """The JAX package's RenderConfig fields and defaults. The port
    renders pcg sampling and the bvh2 (the default), wavefront and tlas
    traversals without fuse_nee; the other values raise in
    `check_supported`."""
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
    if cfg.traversal not in ("bvh2", "wavefront", "tlas"):
        _todo(f"traversal={cfg.traversal!r}", "A.19")
    if cfg.traversal == "tlas" and scene.inst_rows is None:
        raise ValueError("traversal='tlas' needs an instanced scene "
                         "(scene/instances.py compile_scene_instanced)")
    if cfg.traversal == "bvh2" and scene.bvh2_box.shape[0] == 0:
        raise ValueError("traversal='bvh2' needs a single-BLAS scene "
                         "(scene/mesh.py compile_scene)")
    if cfg.traversal == "wavefront" and scene.cw_nodes.shape[0] == 0:
        raise ValueError("traversal='wavefront' needs a CWBVH: "
                         "compile_scene(with_cwbvh=True)")
    if cfg.sampler != "pcg":
        _todo(f"sampler={cfg.sampler!r}", "A.19")
    if cfg.fuse_nee:
        _todo("fuse_nee (mixed_hit_wavefront)", "B")
    if cfg.nee_sort:
        _todo("nee_sort", "A.19")
    if cfg.debug_nee:
        _todo(f"debug_nee={cfg.debug_nee!r}", "A.19")
    if cfg.nee_mis not in ("approx", "exact"):
        raise ValueError(f"unknown nee_mis {cfg.nee_mis!r}")
    if cfg.light_sampling not in ("tree", "cdf"):
        raise ValueError(f"unknown light_sampling {cfg.light_sampling!r}")


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
    """One point on one emissive triangle per lane: light-tree selection
    (the cut, or the descent from the root when the scene has no cut) or
    the power CDF; the triangle from the packed [L,16] light rows
    (emission gathered live from the material table), or from the
    triangle tables when the light list has no rows."""
    lt = scene.light_tris
    L = lt.tri_index.shape[0]
    if use_tree:
        from truetrace_tpu_torch.kernels import lighttree
        if scene.lcut_bounds is not None:
            idx, pmf, _ = lighttree.sample_light_tree_cut(
                scene.lbvh_pairs, scene.lbvh_prim, scene.lcut_bounds,
                scene.lcut_link, p, sn, u_sel, depth=scene.lbvh_depth,
                select_dtype=torch.bfloat16 if approx_mis else torch.float32)
        else:
            idx, pmf, _ = lighttree.sample_light_tree(
                scene.lbvh_pairs, scene.lbvh_prim, p, sn, u_sel,
                depth=scene.lbvh_depth)
        idx = torch.clamp(idx, 0, L - 1)
    else:
        idx = torch.clamp(torch.searchsorted(lt.cdf, u_sel), 0, L - 1)
        pmf = lt.pmf[idx]
    su = torch.sqrt(u2[..., 0])
    b1 = 1.0 - su
    b2 = u2[..., 1] * su
    if lt.rows is None:
        tid = lt.tri_index[idx]
        p0, e1, e2 = scene.tri_p0[tid], scene.tri_e1[tid], scene.tri_e2[tid]
        lp = p0 + e1 * b1[..., None] + e2 * b2[..., None]
        gn = cross(e1, e2)
        area2 = torch.linalg.norm(gn, dim=-1)
        gn = gn / torch.clamp(area2, min=1e-20)[..., None]
        to_l = lp - p
        d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
        wi = to_l / torch.sqrt(d2)[..., None]
        cos_l = -dot(wi, gn)
        geo = d2 / torch.clamp(cos_l * (0.5 * area2), min=1e-12)
        pdf_sa = pmf * geo
        pdf_w = lt.pmf[idx] * geo if (use_tree and approx_mis) else pdf_sa
        return LightSample(pos=lp, normal=gn,
                           radiance=scene.materials.emission[
                               scene.tri_mat[tid]],
                           pdf_sa=pdf_sa, valid=(cos_l > 1e-6) & (L > 0),
                           pdf_w=pdf_w)
    row = lt.rows[idx].t()                    # [16,R]
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
                 use_tree: bool = False, inst=None):
    """Solid-angle pdf with which NEE would have sampled this emissive
    hit (the MIS weight of BSDF-sampled emissive hits). `inst`: the hit
    instances of an instanced scene, whose local emissive rows map to a
    light row per instance (inst_light_offset[inst] + inst_em_rank[tid])."""
    li = scene.light_tris.tri_to_light[tid]
    if inst is not None:
        rank = scene.inst_em_rank[tid]
        off = scene.inst_light_offset[torch.clamp(inst, min=0)]
        li = torch.where(inst >= 0, torch.where(
            (rank >= 0) & (off >= 0), off + rank, -1), li)
    if use_tree:
        from truetrace_tpu_torch.kernels import lighttree
        if scene.lcut_bounds is not None:
            pmf = lighttree.light_tree_pdf_cut(
                scene.lbvh_pairs, scene.lbvh_trail, scene.lcut_bounds,
                scene.lcut_link, scene.lcut_of_light, scene.lcut_skip,
                li, p, sn_prev, depth=scene.lbvh_depth)
        else:
            pmf = lighttree.light_tree_pdf(scene.lbvh_pairs,
                                           scene.lbvh_trail, li, p, sn_prev,
                                           depth=scene.lbvh_depth)
    else:
        pmf = scene.light_tris.pmf[torch.clamp(li, min=0)]
    lt = scene.light_tris
    if lt.rows is not None and lt.rows.shape[0] > 0:
        area = lt.rows[torch.clamp(li, min=0), 12]
    else:
        # the light's own triangle (an instanced scene's world copy)
        L = lt.tri_index.shape[0]
        tid_l = lt.tri_index[torch.clamp(li, 0, max(L - 1, 0))] \
            if L > 0 else tid
        area = 0.5 * torch.linalg.norm(
            cross(scene.tri_e1[tid_l], scene.tri_e2[tid_l]), dim=-1)
    to_l = hit_p - p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-12)
    pdf = pmf * d2 / torch.clamp(cos_l * area, min=1e-12)
    return torch.where(li >= 0, pdf, 0.0)


def _di_light_sample(di, p) -> LightSample:
    """A ReSTIR DI reservoir sample {pos, ln, rad, W} as the light sample
    of shading points p: its pdf encodes the unbiased contribution weight
    W (contribution f Le cos_s W cos_l / d2)."""
    to = di["pos"] - p
    d2 = torch.clamp(dot(to, to), min=1e-12)
    wi = to / torch.sqrt(d2)[..., None]
    cos_l = -dot(wi, di["ln"])
    pdf = d2 / torch.clamp(di["W"] * cos_l, min=1e-12)
    return LightSample(pos=di["pos"], normal=di["ln"], radiance=di["rad"],
                       pdf_sa=pdf, valid=(di["W"] > 0.0) & (cos_l > 1e-6),
                       pdf_w=pdf)


def _analytic_sample(scene: Scene, cfg: RenderConfig, p, u_resc, u_l2, u2,
                     b: int):
    """One analytic light sample a lane: streaming RIS over
    cfg.analytic_ris candidates where there are more lights than that,
    else a uniform pick. Candidate c draws its pick and keep uniforms in
    the light-select dimension offset by 0x9E3779 (c + 1)."""
    from truetrace_tpu_torch.integrate.lights import (
        sample_analytic, sample_analytic_ris)
    N = cfg.analytic_ris
    if 0 < N < scene.lights.position.shape[0]:
        base = rng.path_dim(b, rng.DIM_LIGHT_SELECT)
        u = torch.stack([u2(rng.u32(base + 0x9E3779 * (c + 1)))
                         for c in range(N)], 1)            # [R,N,2]
        return sample_analytic_ris(scene.lights, p, u[..., 0], u[..., 1],
                                   u_l2)
    return sample_analytic(scene.lights, p, u_resc, u_l2)


# ---------------------------------------------------------------------------
# traversal dispatch
# ---------------------------------------------------------------------------

def _tables(scene: Scene):
    """(table, node rows, leaf rows) of the scene's traversal table."""
    return (scene.cw_table(), scene.cw_nodes.shape[0],
            scene.cw_leaf_rows.shape[0])


def _scene_max_leaf(scene: Scene, cfg: RenderConfig) -> int:
    """The BVH2 traversal's leaf capacity: a CWBVH build's BVH2 has
    leaves of up to leaf_k triangles (the packed row width), a plain
    build's cfg.max_leaf (where its SAH left a leaf larger, the
    triangles past cfg.max_leaf are skipped, as in the JAX package)."""
    if scene.cw_leaf_rows.shape[0] > 0:
        return max(cfg.max_leaf, scene.cw_leaf_rows.shape[1] // 10)
    return cfg.max_leaf


def _bvh2(scene: Scene):
    """The BVH2 traversal's tables: boxes, left, count, p0, e1, e2."""
    return (scene.bvh2_box, scene.bvh2_left, scene.bvh2_count, scene.tri_p0,
            scene.tri_e1, scene.tri_e2)


def _trace(scene: Scene, ro, rd, alive, cfg: RenderConfig):
    """Closest hit: (Hit, inst [R] int64, the hit instance on the tlas
    path, else -1). Dead lanes get t_max = 0 (they never hit)."""
    t_max = torch.where(alive, T_MAX, 0.0)
    if cfg.traversal == "tlas":
        hit, inst = closest_hit_tlas(*_tables(scene), ro, rd, t_max)
        return hit, inst.to(torch.int64)
    if cfg.traversal == "wavefront":
        hit = closest_hit_wavefront(scene.cw_table(),
                                    scene.cw_nodes.shape[0], ro, rd, t_max,
                                    max_stack=scene.cw_stack)
    else:
        hit = closest_hit_bvh2(*_bvh2(scene), ro, rd, t_max,
                               max_leaf=_scene_max_leaf(scene, cfg),
                               table=scene.bvh2_table())
    return hit, torch.full((ro.shape[0],), -1, dtype=torch.int64,
                           device=ro.device)


def _occluded_mesh(scene: Scene, ro, rd, t_max, cfg: RenderConfig):
    if cfg.traversal == "tlas":
        return any_hit_tlas(*_tables(scene), ro, rd, t_max)
    if cfg.traversal == "wavefront":
        return any_hit_wavefront(scene.cw_table(), scene.cw_nodes.shape[0],
                                 ro, rd, t_max, max_stack=scene.cw_stack)
    return any_hit_bvh2(*_bvh2(scene), ro, rd, t_max,
                        max_leaf=_scene_max_leaf(scene, cfg),
                        table=scene.bvh2_table())


def _occluded(scene: Scene, ro, rd, t_max, cfg: RenderConfig):
    """Occlusion [R] by the meshes or, where there is one, the terrain
    (the reference's kernel_shadow_heightmap)."""
    blocked = _occluded_mesh(scene, ro, rd, t_max, cfg)
    if scene.terrain is not None:
        from truetrace_tpu_torch.kernels.heightmap import heightmap_any
        blocked = blocked | heightmap_any(scene.terrain, ro, rd, t_max)
    return blocked


def _transmission(scene: Scene, ro, rd, t_max, cfg: RenderConfig):
    """Shadow-ray transmittance [R,3]: binary visibility on all-opaque
    scenes, else the product of the shadow tints of every surface crossed
    (cutout alpha and stained glass; reference
    CommonData.cginc:593-634), on the single-BLAS and the two-level path;
    a terrain blocks."""
    if scene.tri_shadow is None:
        blocked = _occluded(scene, ro, rd, t_max, cfg)
        return torch.where(blocked[..., None], 0.0, 1.0)
    if cfg.traversal == "tlas":
        tp = transmit_tlas(*_tables(scene), scene.tri_shadow, ro, rd, t_max)
    elif cfg.traversal == "wavefront":
        tp = transmit_wavefront(scene.cw_table(), scene.cw_nodes.shape[0],
                                scene.tri_shadow, ro, rd, t_max,
                                max_stack=scene.cw_stack)
    else:
        # the JAX package's O(R*T) oracle path on the other traversals
        tp = transmit_brute(scene.tri_p0, scene.tri_e1, scene.tri_e2,
                            scene.tri_shadow, ro, rd, t_max)
    if scene.terrain is not None:
        from truetrace_tpu_torch.kernels.heightmap import heightmap_any
        tp = torch.where(heightmap_any(scene.terrain, ro, rd, t_max)[
            ..., None], 0.0, tp)
    return tp


# ---------------------------------------------------------------------------
# the medium stack (nested dielectrics)
# ---------------------------------------------------------------------------

def _medium(scene: Scene, mat, m_ids, m_sp, hit, hit_ok, front, throughput):
    """Glass interior transport at a bounce's hit: the segment that
    landed is attenuated by the current medium's Beer-Lambert extinction
    over hit.t (reference Materials.cginc:350 CalculateExtinction;
    scatter_dist <= 0 counts as 1, and a white medium is clear), and a
    non-thin transmissive surface gets the relative eta n_dest / n_src
    as its ior (in place on `mat`). Returns (throughput, transmissive)."""
    mats = scene.materials
    top = lambda k: torch.gather(
        m_ids, 1, torch.clamp(m_sp - k, 0, MED_STACK - 1)[:, None])[:, 0]
    in_medium = m_sp > 0
    safe_med = torch.clamp(top(1), min=0)
    med_tc = mats.transmit_color[safe_med]
    med_ior = mats.ior[safe_med]
    # the apparent interior colour: the authored transmittance colour
    # where there is one, else the surface tint
    app = torch.where((med_tc >= 0.0).all(-1, keepdim=True),
                      torch.clamp(1.0 - med_tc, 0.0, 1.0),
                      torch.clamp(1.0 - mats.base_color[safe_med], 0.0, 1.0))
    s_ext = 1.9 - app + 3.5 * (app - 0.8) ** 2
    med_sd = mats.scatter_dist[safe_med]
    sd = torch.where(med_sd <= 0.0, 1.0, med_sd)
    att = torch.where(app <= 0.0, 1.0,
                      torch.exp(-hit.t[..., None] / (s_ext * sd[..., None])))
    throughput = torch.where((in_medium & hit_ok)[..., None],
                             throughput * att, throughput)
    transmissive = hit_ok & (mat.spec_trans > 0.0) & (mat.thin < 0.5)
    n_cur = torch.where(in_medium, med_ior, 1.0)
    n_below = torch.where(m_sp > 1, mats.ior[torch.clamp(top(2), min=0)],
                          1.0)
    ior_eff = torch.where(front, mat.ior / torch.clamp(n_cur, min=1e-6),
                          n_below / torch.clamp(mat.ior, min=1e-6))
    mat.ior = torch.where(transmissive, ior_eff, mat.ior)
    return throughput, transmissive


def _medium_update(m_ids, m_sp, crossed, front, mid):
    """A sampled direction that crosses a non-thin transmissive surface
    enters its medium (front face: push its id; on a full stack the push
    overwrites the top slot) or leaves it (back face: remove the topmost
    entry with its id, so interleaved boundaries and stray backfaces of
    never-entered open meshes do no harm). Returns (m_ids, m_sp)."""
    push = crossed & front
    pop = crossed & ~front
    slots = torch.arange(MED_STACK, device=m_ids.device)[None, :]
    top = torch.clamp(m_sp, 0, MED_STACK - 1)[:, None]
    m_ids = torch.where(push[:, None] & (slots == top), mid[:, None], m_ids)
    match = (m_ids == mid[:, None]) & (slots < m_sp[:, None])
    top_match = torch.where(match, slots, -1).amax(1)
    do_pop = pop & match.any(1)
    shifted = torch.cat([m_ids[:, 1:], torch.full_like(m_ids[:, :1], -1)],
                        1)
    m_ids = torch.where(do_pop[:, None] & (slots >= top_match[:, None]),
                        shifted, m_ids)
    m_sp = torch.clamp(m_sp + push.long() - do_pop.long(), 0, MED_STACK)
    return m_ids, m_sp


# ---------------------------------------------------------------------------
# the integrator
# ---------------------------------------------------------------------------

# the bounce loop's carried state: always, and with cache queries (n_cq,
# n_ch), the medium stack (m_ids, m_sp) or the ReSTIR GI capture (r_*)
_STATE = ("ro", "rd", "radiance", "throughput", "alive", "prev_pdf",
          "prev_n", "g_albedo", "g_normal", "g_depth", "g_inst", "r_emit0",
          "cone_w", "cone_s", "n_trace", "n_shadow")
_STATE_OPT = ("n_cq", "n_ch", "m_ids", "m_sp", "r_direct", "r_x2", "r_n2",
              "r_tp1", "r_pdf1", "r_valid", "r_x1", "r_mat1")


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
    normal, depth and emitted0 (primary-hit G-buffer), and the captures
    `trace_rays` describes. `cache` is the radiance cache the query reads
    (integrate/radiance_cache.py), `di_sample` the ReSTIR DI reservoir
    samples (integrate/restir_di.py). `jitter` is a [2] subpixel offset
    that every pixel takes this frame (the TAAU sequence,
    post/pipeline.py taau_jitter); None draws each pixel its own."""
    W, H = cfg.width, cfg.height
    pixel = pixel.to(torch.int64)
    if jitter is None:
        jit2 = rng.uniform2(pixel, sample_id, rng.DIM_CAMERA_JITTER)
    else:
        jit2 = jitter.to(torch.float32).expand(pixel.shape[0], 2)
    lens_u = rng.uniform2(pixel, rng.u32(sample_id) + 0x9E3779B9,
                          rng.DIM_CAMERA_JITTER)
    ro, rd = camera_rays(cam, W, H, pixel, jit2, lens_u=lens_u)
    # per-pixel ray-cone spread (texture LOD; ray cones stand in for the
    # reference's hardware-derivative texture fetches)
    spread0 = 2.0 * torch.tan(cam.fov_y * 0.5) / H
    return trace_rays(scene, ro, rd, cfg, pixel, sample_id, cam=cam,
                      cone_spread=spread0, cache=cache, di_sample=di_sample)


# the slots read at the uv2_scale transform
_UV2_SLOTS = {"tex_normal", "tex_rough_metal", "tex_metallic",
              "tex_roughness", "tex_alpha"}


def _pick(sel, new, old):
    """Lane-wise strategy select; `sel` None means every lane."""
    if sel is None:
        return new
    return torch.where(sel[..., None] if new.dim() > sel.dim() else sel,
                       new, old)


def _rotate(rot, v):
    """Per-lane 3x3 rotations rot [R,3,3] applied to v [R,3]."""
    return torch.einsum("rij,rj->ri", rot, v)


def _textures(scene: Scene, mat, used, tid, hit, w, rd, gn, sn, hit_ok,
              cone_w, cone_s, cam, b, inst=None, ter=None):
    """The texture fetches of one bounce (reference kernel_shade atlas
    reads, RayTracingShader.compute:129-159, 623-662): UV transforms,
    tangent-space normal map, albedo with ray-cone mips and the colour
    adjustment chain, rough/metal, metallic, roughness, alpha, emission,
    and the matcap at the primary hit. Updates `mat` in place and returns
    the (possibly normal-mapped) shading normal. `used` names the texture
    slots some material sets; the others would only select their
    untextured value and are skipped. `inst`: the hit instances (their
    L2W rotates the local tangents); `ter`: (terrain lanes, terrain uv),
    whose uv replaces the triangle's."""
    from truetrace_tpu_torch.core.math import adjust_color
    from truetrace_tpu_torch.scene.atlas import sample_atlas, transform_uv
    at, rects = scene.atlas, scene.atlas_rects
    uv0 = scene.tri_uv[tid]
    uv = (uv0[:, 0] * w[..., None] + uv0[:, 1] * hit.u[..., None]
          + uv0[:, 2] * hit.v[..., None])
    if ter is not None:
        uv = torch.where(ter[0][..., None], ter[1], uv)
    # albedo/emission/matcap use uv_scale; normal/metallic/roughness use
    # uv2_scale with the shared offset (reference AlignUV call sites,
    # RayTracingShader.compute:623-627)
    uv_a = transform_uv(uv, mat.uv_scale, mat.uv_rot)
    if used & _UV2_SLOTS:
        uv_s = transform_uv(uv, torch.cat([mat.uv2_scale,
                                           mat.uv_scale[:, 2:4]], 1),
                            mat.uv_rot)
    if "tex_normal" in used:
        nm = sample_atlas(at, rects, mat.tex_normal, uv_s)
        tan = scene.tri_tan[tid]
        if inst is not None:
            rot = scene.inst_l2w[torch.clamp(inst, min=0)][:, :, :3]
            tan = torch.where((inst >= 0)[..., None], _rotate(rot, tan), tan)
        tan_ok = dot(tan, tan) > 1e-8
        t_ = tan - sn * dot(tan, sn)[..., None]
        t_ = t_ / torch.clamp(torch.linalg.norm(t_, dim=-1, keepdim=True),
                              min=1e-8)
        b_ = cross(sn, t_)
        # NormalStrength scales the tangent-plane deflection (reference
        # RayTracingShader.compute:134); z is rebuilt to renormalise
        n_xy = (nm[:, 0:2] * 2.0 - 1.0) * mat.normal_strength[:, None]
        n_z = torch.sqrt(torch.clamp(
            1.0 - (n_xy[:, 0:1] * n_xy[:, 0:1] + n_xy[:, 1:2] * n_xy[:, 1:2]),
            min=0.0025))
        sn_m = normalize(t_ * n_xy[:, 0:1] + b_ * n_xy[:, 1:2] + sn * n_z)
        use_nm = (mat.tex_normal >= 0) & tan_ok & hit_ok
        sn = torch.where(use_nm[..., None], sn_m, sn)
    if "tex_albedo" in used:
        width = cone_w + hit.t * cone_s
        lod = (scene.tri_lod[tid] + torch.log2(torch.clamp(width, min=1e-12))
               - torch.log2(torch.clamp(dot(rd, gn).abs(), min=0.05)))
        alb = sample_atlas(at, rects, mat.tex_albedo, uv_a, lod=lod,
                           level_y=scene.atlas_level_y)
        tex_col = adjust_color(mat.base_color * alb[:, :3], mat.hue,
                               mat.brightness, mat.saturation, mat.contrast,
                               mat.blend_color, mat.blend_factor)
        has = mat.tex_albedo >= 0
        mat.base_color = torch.where(has[..., None], tex_col, mat.base_color)
        # texture-driven cutout alpha (reference AdvancedAlphaMapped)
        mat.alpha = torch.where(has, mat.alpha * alb[:, 3], mat.alpha)
    if "tex_rough_metal" in used:
        rm = sample_atlas(at, rects, mat.tex_rough_metal, uv_s)
        has = mat.tex_rough_metal >= 0
        mat.roughness = torch.where(has, mat.roughness * rm[:, 1],
                                    mat.roughness)
        mat.metallic = torch.where(has, mat.metallic * rm[:, 2],
                                   mat.metallic)
    if "tex_metallic" in used:
        # single-channel overrides (reference MetallicTex / RoughnessTex,
        # RayTracingShader.compute:654-657): metallic gated off for full
        # spec_trans, roughness optionally inverted smoothness
        mtl = sample_atlas(at, rects, mat.tex_metallic, uv_s)
        mat.metallic = torch.where(
            (mat.tex_metallic >= 0) & (mat.spec_trans < 1.0), mtl[:, 0],
            mat.metallic)
    if "tex_roughness" in used:
        rgh = sample_atlas(at, rects, mat.tex_roughness, uv_s)[:, 0]
        rgh = torch.where(mat.rough_tex_invert > 0.5, 1.0 - rgh, rgh)
        mat.roughness = torch.where(mat.tex_roughness >= 0,
                                    torch.clamp(rgh, 0.0, 1.0),
                                    mat.roughness)
    if "tex_alpha" in used:
        # dedicated alpha texture (reference AlphaTex cutout fetch,
        # IntersectionKernels.compute:38-39)
        alp = sample_atlas(at, rects, mat.tex_alpha, uv_s)
        mat.alpha = torch.where(mat.tex_alpha >= 0, mat.alpha * alp[:, 0],
                                mat.alpha)
    if "tex_emission" in used:
        em = sample_atlas(at, rects, mat.tex_emission, uv_a)
        mat.emission = torch.where((mat.tex_emission >= 0)[..., None],
                                   mat.emission * em[:, :3], mat.emission)
    if "tex_matcap" in used and cam is not None and b == 0:
        # matcap: view-space-normal lookup modulating the base colour at
        # the primary hit; MatCapMask lerps base -> matcap by the mask,
        # no mask keeps the multiply blend (RayTracingShader.compute:129-159)
        vx = dot(sn, cam.c2w[0, :3])
        vy = dot(sn, cam.c2w[1, :3])
        uv_m = transform_uv(torch.stack([vx, vy], -1) * 0.5 + 0.5,
                            mat.uv_scale, mat.uv_rot)
        mc = sample_atlas(at, rects, mat.tex_matcap, uv_m)
        mk = sample_atlas(at, rects, mat.tex_matcap_mask, uv_a)
        bc = mat.base_color
        mc_col = torch.where((mat.tex_matcap_mask >= 0)[..., None],
                             bc + (mc[:, :3] - bc) * mk[:, 0:1],
                             bc * mc[:, :3])
        mat.base_color = torch.where((mat.tex_matcap >= 0)[..., None],
                                     mc_col, bc)
    return sn


def trace_rays(scene: Scene, ro, rd, cfg: RenderConfig, pixel, sample_id,
               cam: Optional[Camera] = None, cone_spread=None, cache=None,
               di_sample=None):
    """Path-trace explicit primary rays. Returns (radiance [R,3], stats).
    cone_spread: the primary rays' cone spread angle per unit distance
    (texture LOD); None = 0.002.

    cfg.restir_capture adds the ReSTIR GI candidate to the stats: direct
    (radiance at the end of bounce 0), indirect (the rest), the first
    vertex x1 and its material mat1, the second vertex x2 / n2 with
    cand_valid, and bounce 0's sampled tp1 = f cos / pdf and pdf1.
    cfg.cache_capture adds each bounce's cache record [R,B]: the vertex's
    packed cell (cache_w0, cache_w1), the radiance gathered before it
    (cache_prefix), the throughput at entry (cache_tp), cache_live.
    With `cache` and cfg.cache_query_bounce >= 0, a path ends at a
    vertex of bounce >= cache_query_bounce that finds a confident cache
    entry, which adds its radiance (stats cache_hit_rate).
    di_sample {pos, ln, rad [R,3], W [R]}: the ReSTIR DI reservoir sample
    replaces bounce 0's mesh-light sample at full weight (contribution f
    Le cos W cos_l / d2, no MIS split), and the BSDF-sampled emissive hit
    at bounce 1, its complement, is dropped."""
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
    # ray cones for texture LOD: width at the origin + spread per unit t
    cone_w = torch.zeros((R,), **f32)
    cone_s = (cone_spread.expand(R).to(**f32) if cone_spread is not None
              else torch.full((R,), 0.002, **f32))
    n_trace = torch.zeros((), **f32)
    n_shadow = torch.zeros((), **f32)
    if cfg.restir_capture:
        r_direct = torch.zeros((R, 3), **f32)
        r_x2 = torch.zeros((R, 3), **f32)
        r_n2 = torch.zeros((R, 3), **f32)
        r_tp1 = torch.ones((R, 3), **f32)
        r_pdf1 = torch.zeros((R,), **f32)
        r_valid = torch.zeros((R,), dtype=torch.bool, device=dev)
        r_x1 = torch.zeros((R, 3), **f32)
        r_mat1 = torch.zeros((R,), dtype=torch.int64, device=dev)
    cache_rec = {k: [] for k in ("cache_w0", "cache_w1", "cache_prefix",
                                 "cache_tp", "cache_live")}
    query = cache is not None and cfg.cache_query_bounce >= 0
    if query:
        n_cq = torch.zeros((), **f32)   # cache queries attempted
        n_ch = torch.zeros((), **f32)   # cache hits taken
    if cfg.cache_capture or query:
        from truetrace_tpu_torch.integrate.radiance_cache import (
            cache_cell_packed, cache_query)
        cam_pos = cam.c2w[3, :3] if cam is not None else ro[0]
    use_tree = (cfg.light_sampling == "tree"
                and scene.lbvh_pairs.shape[0] > 0)
    # NEE strategy mix (the reference picks a light group per shade,
    # RayTracingShader.compute:328-344): mesh emitters, the env map and
    # the analytic lights
    has_mesh = scene.light_tris.tri_index.shape[0] > 0
    has_env_tex = scene.env.image.shape[0] > 1
    has_analytic = scene.lights.position.shape[0] > 0
    n_groups = ((int(has_mesh) + int(has_env_tex) + int(has_analytic))
                if cfg.use_nee else 0)
    p_group = 1.0 / n_groups if n_groups else 1.0
    env_const = (None if has_env_tex
                 else scene.env.image[0, 0] * scene.env.intensity)
    used = set(scene.tex_slots)
    # cutout pass-through is possible only where a texture lowers alpha or
    # a material has alpha < 1 (then the scene has a shadow tint table)
    cutout = (bool(used & {"tex_albedo", "tex_alpha"})
              or scene.tri_shadow is not None)
    g_inst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    terrain = scene.terrain
    instanced = scene.inst_l2w is not None
    if terrain is not None:
        from truetrace_tpu_torch.kernels.heightmap import (
            heightmap_closest, sample_layers)
        # the layers' material rows, blended on terrain lanes
        ter_rows = scene.materials.gather(torch.clamp(terrain.mat_ids,
                                                      min=0))
    if scene.has_media:
        # the dielectrics each lane is inside, innermost at slot m_sp - 1
        m_ids = torch.full((R, MED_STACK), -1, dtype=torch.int64,
                           device=dev)
        m_sp = torch.zeros((R,), dtype=torch.int64, device=dev)

    def bounce(b: int, st: dict):
        """Bounce b: the loop-carried state `st` in; the next state and
        the bounce's cache records out. Pure (no effect outside its
        return), so a checkpoint's recompute replays it, traversals
        included (as jax.checkpoint of the JAX bounce body does)."""
        (ro, rd, radiance, throughput, alive, prev_pdf, prev_n, g_albedo,
         g_normal, g_depth, g_inst, r_emit0, cone_w, cone_s, n_trace,
         n_shadow) = (st[k] for k in _STATE)
        (n_cq, n_ch, m_ids, m_sp, r_direct, r_x2, r_n2, r_tp1, r_pdf1,
         r_valid, r_x1, r_mat1) = (st.get(k) for k in _STATE_OPT)
        rec = {}
        n_trace = n_trace + alive.float().sum()
        hit, inst = _trace(scene, ro, rd, alive, cfg)
        # the detached-sampling estimator: the traversal is not
        # differentiated (JAX stop_gradient on the hit record and inst)
        hit = Hit(*(x.detach() for x in hit))
        inst = inst.detach()
        # the terrain is marched after the meshes against their hit t, and
        # the nearer hit is kept (reference kernel_heightmap after
        # kernel_trace); a terrain lane keeps the mesh hit's tri and inst
        ter_take = None
        if terrain is not None:
            th = heightmap_closest(terrain, ro, rd, hit.t)
            ter_take = alive & th.valid & (th.t < hit.t)
            hit = Hit(t=torch.where(ter_take, th.t, hit.t), tri=hit.tri,
                      u=hit.u, v=hit.v)
        hit_ok = (hit.tri >= 0) & alive
        missed = alive & ~(hit.tri >= 0)
        if ter_take is not None:
            hit_ok = hit_ok | ter_take
            missed = missed & ~ter_take

        # ---- miss: environment (MIS against env NEE when it is active)
        env_rgb = env_const
        if has_env_tex:
            from truetrace_tpu_torch.kernels.envmap import env_eval, env_pdf
            env_rgb = env_eval(scene.env, rd)
            if cfg.use_nee and b > 0:
                e_pdf = env_pdf(scene.env, rd) * p_group
                w_env = torch.where(prev_pdf <= 0.0, 1.0,
                                    power_heuristic(prev_pdf, e_pdf))
                env_rgb = env_rgb * w_env[..., None]
        radiance = radiance + torch.where(missed[..., None],
                                          throughput * env_rgb, 0.0)

        tid = torch.clamp(hit.tri.to(torch.int64), min=0)
        p = ro + rd * hit.t[..., None]
        gn = normalize(cross(scene.tri_e1[tid], scene.tri_e2[tid]))
        n0 = scene.tri_n[tid]
        w = 1.0 - hit.u - hit.v
        sn = normalize(n0[:, 0] * w[..., None] + n0[:, 1] * hit.u[..., None]
                       + n0[:, 2] * hit.v[..., None])
        if instanced:
            # instance-local triangles: normals into world space by the
            # hit instance's L2W
            rot = scene.inst_l2w[torch.clamp(inst, min=0)][:, :, :3]
            on_inst = (inst >= 0)[..., None]
            gn = torch.where(on_inst, normalize(_rotate(rot, gn)), gn)
            sn = torch.where(on_inst, normalize(_rotate(rot, sn)), sn)
        # face-forward both normals against the incoming ray
        flip = dot(gn, rd) > 0.0
        front = ~flip
        gn = torch.where(flip[..., None], -gn, gn)
        sn = torch.where((dot(sn, rd) > 0.0)[..., None], -sn, sn)

        mid = scene.tri_mat[tid]
        if terrain is not None:
            # terrain lanes: the heightfield normal, the dominant layer's
            # material, the blend of the layers' Disney parameters
            # (reference RayTracingShader.compute:587-616)
            tn = th.normal
            tn = torch.where((dot(tn, rd) > 0.0)[..., None], -tn, tn)
            gn = torch.where(ter_take[..., None], tn, gn)
            sn = torch.where(ter_take[..., None], tn, sn)
            front = front | ter_take
            layer_w = sample_layers(terrain, th.uv)
            dom = torch.argmax(layer_w, dim=-1)
            mid = torch.where(ter_take, torch.clamp(terrain.mat_ids[dom],
                                                    min=0), mid)
        mat = scene.materials.gather(mid)
        if terrain is not None:
            for f in dataclasses.fields(mat):
                cur = getattr(mat, f.name)
                if cur.dtype.is_floating_point:
                    mix = torch.einsum("rk,k...->r...", layer_w,
                                       getattr(ter_rows, f.name))
                    keep = ter_take.reshape((R,) + (1,) * (cur.dim() - 1))
                    setattr(mat, f.name, torch.where(keep, mix, cur))
        if used:
            sn = _textures(scene, mat, used, tid, hit, w, rd, gn, sn, hit_ok,
                           cone_w, cone_s, cam, b,
                           inst=inst if instanced else None,
                           ter=None if terrain is None else (ter_take,
                                                             th.uv))
        # roughness/metallic remap ranges ((0,1) = identity)
        mat.roughness = clip(
            mat.rough_remap[:, 0] + mat.roughness
            * (mat.rough_remap[:, 1] - mat.rough_remap[:, 0]), 1e-5, 1.0)
        mat.metallic = clip(
            mat.metal_remap[:, 0] + mat.metallic
            * (mat.metal_remap[:, 1] - mat.metal_remap[:, 0]), 0.0, 1.0)

        if scene.has_media:
            throughput, transmissive = _medium(scene, mat, m_ids, m_sp,
                                               hit, hit_ok, front,
                                               throughput)

        # ---- cutout alpha: stochastically pass straight through partial
        # surfaces (reference alpha-mapped closest-hit skips,
        # IntersectionKernels.compute:264-498); the lane keeps flying
        passthru = None
        if cutout:
            u_cut = u1(rng.path_dim(b, rng.DIM_AUX))
            passthru = hit_ok & (mat.alpha < 1.0) & (u_cut >= mat.alpha)
            hit_ok = hit_ok & ~passthru

        # ---- primary-hit G-buffer
        if b == 0:
            g_albedo = torch.where(hit_ok[..., None], mat.base_color,
                                   g_albedo)
            g_normal = torch.where(hit_ok[..., None], sn, g_normal)
            g_depth = torch.where(hit_ok, hit.t, g_depth)
            # the primary hit's instance (per-object motion vectors); a
            # terrain lane keeps the instance behind it, as in JAX
            g_inst = torch.where(hit_ok, inst, g_inst)
        if cfg.restir_capture:
            # the first vertex and its material; the second vertex (the
            # GI sample point)
            if b == 0:
                r_x1 = torch.where(hit_ok[..., None], p, r_x1)
                r_mat1 = torch.where(hit_ok, mid, r_mat1)
            if b == 1:
                r_x2 = torch.where(hit_ok[..., None], p, r_x2)
                r_n2 = torch.where(hit_ok[..., None], gn, r_n2)
                r_valid = r_valid | hit_ok
        if cfg.cache_capture:
            # the vertex cell, and the radiance and throughput at entry
            _, _, v_w0, v_w1 = cache_cell_packed(p, sn, cam_pos)
            rec = dict(cache_w0=torch.where(hit_ok, v_w0, 0),
                       cache_w1=torch.where(hit_ok, v_w1, 0),
                       cache_prefix=radiance, cache_tp=throughput,
                       cache_live=hit_ok)
        if query and b >= cfg.cache_query_bounce:
            # end paths at a confident cache entry (reference radiance-
            # cache hooks, RayTracingShader.compute:303-326)
            q_rad, q_hit = cache_query(cache, p, sn, cam_pos)
            q_take = hit_ok & q_hit
            n_cq = n_cq + hit_ok.float().sum()
            n_ch = n_ch + q_take.float().sum()
            radiance = radiance + torch.where(q_take[..., None],
                                              throughput * q_rad, 0.0)
            alive = alive & ~q_take
            hit_ok = hit_ok & ~q_take

        # ---- emissive hit (MIS against NEE)
        emis = mat.emission
        is_emis = emis.amax(-1) > 0.0
        cos_l = -dot(rd, gn)
        if cfg.use_nee and has_mesh and b > 0:
            l_pdf = light_pdf_sa(
                scene, tid, ro, p, torch.clamp(cos_l, min=1e-6),
                sn_prev=prev_n,
                use_tree=use_tree and cfg.nee_mis == "exact",
                inst=inst if instanced else None) * p_group
            mis_w = torch.where(prev_pdf <= 0.0, 1.0,
                                power_heuristic(prev_pdf, l_pdf))
        else:
            mis_w = torch.ones((R,), **f32)
        if di_sample is not None and b == 1:
            # the DI reservoirs estimate bounce 0's direct mesh light
            # alone: drop its BSDF-sampled complement
            mis_w = torch.zeros_like(mis_w)
        emit_take = hit_ok & is_emis & front
        radiance = radiance + torch.where(
            emit_take[..., None], throughput * emis * mis_w[..., None], 0.0)
        if b == 0:
            # emitted-at-primary (+ env on miss), before NEE: the
            # denoiser passes it through unfiltered
            r_emit0 = radiance

        # ---- NEE: one strategy {mesh, env} per lane
        wo = -rd
        if n_groups > 0:
            u_sel = u1(rng.path_dim(b, rng.DIM_LIGHT_SELECT))
            u_l2 = u2(rng.path_dim(b, rng.DIM_LIGHT_SAMPLE))
            g_pick = torch.clamp((u_sel * n_groups).to(torch.int64),
                                 0, n_groups - 1)
            u_resc = torch.clamp(u_sel * n_groups - g_pick.float(),
                                 0.0, 1.0 - 1e-7)
            # strategy results, selected lane-wise (no select with one)
            wi_l = torch.zeros((R, 3), **f32)
            dist_l = torch.zeros((R,), **f32)
            rad_l = torch.zeros((R, 3), **f32)
            pdf_l = torch.zeros((R,), **f32)    # solid-angle pdf * p_group
            pdfw_l = torch.zeros((R,), **f32)   # MIS weighting pdf
            valid_l = torch.zeros((R,), dtype=torch.bool, device=dev)
            delta = None        # lanes of full weight (no MIS split)
            gi = 0
            if has_mesh:
                if di_sample is not None and b == 0:
                    ls = _di_light_sample(di_sample, p)
                else:
                    ls = sample_light_tris(scene, p, u_resc, u_l2, sn=sn,
                                           use_tree=use_tree,
                                           approx_mis=cfg.nee_mis == "approx")
                to_l = ls.pos - p
                d_m = torch.linalg.norm(to_l, dim=-1)
                sel = None if n_groups == 1 else g_pick == gi
                wi_l = _pick(sel, to_l / torch.clamp(d_m, min=1e-12)[
                    ..., None], wi_l)
                dist_l = _pick(sel, d_m, dist_l)
                rad_l = _pick(sel, ls.radiance, rad_l)
                pdf_l = _pick(sel, ls.pdf_sa * p_group, pdf_l)
                pdfw_l = _pick(sel, ls.pdf_w * p_group, pdfw_l)
                valid_l = _pick(sel, ls.valid, valid_l)
                if di_sample is not None and b == 0:
                    delta = torch.ones_like(valid_l) if sel is None else sel
                gi += 1
            if has_env_tex:
                from truetrace_tpu_torch.kernels.envmap import env_sample
                d_env, p_env, r_env = env_sample(scene.env, u_l2)
                sel = None if n_groups == 1 else g_pick == gi
                wi_l = _pick(sel, d_env, wi_l)
                dist_l = _pick(sel, torch.full_like(dist_l, 1e30), dist_l)
                rad_l = _pick(sel, r_env, rad_l)
                pdf_l = _pick(sel, p_env * p_group, pdf_l)
                pdfw_l = _pick(sel, p_env * p_group, pdfw_l)
                valid_l = _pick(sel, p_env > 1e-12, valid_l)
                gi += 1
            if has_analytic:
                al = _analytic_sample(scene, cfg, p, u_resc, u_l2, u2, b)
                sel = None if n_groups == 1 else g_pick == gi
                wi_l = _pick(sel, al.wi, wi_l)
                dist_l = _pick(sel, al.dist, dist_l)
                # the selection pmf goes into the radiance (a delta
                # light's pdf_sa is 1)
                rad_l = _pick(sel, al.radiance / al.pmf[..., None], rad_l)
                pdf_l = _pick(sel, al.pdf_sa * p_group, pdf_l)
                pdfw_l = _pick(sel, al.pdf_sa * p_group, pdfw_l)
                valid_l = _pick(sel, al.valid, valid_l)
                delta = _pick(sel, al.is_delta, torch.zeros_like(valid_l)
                              if delta is None else delta)
                gi += 1

            f_l, pdf_b = bsdf_eval(mat, sn, wo, wi_l)
            cos_s = torch.clamp(dot(wi_l, sn), min=0.0)
            cand = (hit_ok & valid_l & (cos_s > 0.0) & (pdf_l > 1e-12)
                    & (f_l.amax(-1) > 0.0) & ~is_emis)
            w_mis = power_heuristic(pdfw_l, pdf_b)
            if delta is not None:
                w_mis = torch.where(delta, 1.0, w_mis)
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
            trans = _transmission(scene, sro.contiguous(),
                                  wi_l.contiguous(), s_tm, cfg).detach()
            radiance = radiance + torch.where(cand[..., None],
                                              contrib * trans, 0.0)

        # ---- BSDF sample / continue
        u_lobe = u1(rng.path_dim(b, rng.DIM_BSDF_LOBE))
        u_dir = u2(rng.path_dim(b, rng.DIM_BSDF_SAMPLE))
        wi, f, pdf, _ = bsdf_sample(mat, sn, wo, u_lobe, u_dir)
        # the detached-sampling estimator: the sampled direction and its
        # pdf are constants of the backward pass; gradients flow through f
        # and the NEE and emission terms only (JAX stop_gradient)
        wi, pdf = wi.detach(), pdf.detach()
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
        if "tex_albedo" in used:       # the cones feed the albedo LOD only
            cone_w = torch.where(hit_ok, cone_w + hit.t * cone_s, cone_w)
            cone_s = torch.where(hit_ok, cone_s + 0.25 * mat.roughness ** 2,
                                 cone_s)
        side = torch.where(dot(wi, gn) >= 0.0, 1.0, -1.0)
        ro_n = p + gn * (SHADOW_EPS * side[..., None])
        tp_n = torch.where(alive[..., None], new_tp, throughput)
        pdf_n = torch.where(alive, pdf, 0.0)
        if cutout:
            # pass-through lanes keep flying unperturbed
            alive = alive | passthru
            ro_n = torch.where(passthru[..., None], p + rd * SHADOW_EPS, ro_n)
            wi = torch.where(passthru[..., None], rd, wi)
            tp_n = torch.where(passthru[..., None], throughput, tp_n)
            pdf_n = torch.where(passthru, prev_pdf, pdf_n)
            sn = torch.where(passthru[..., None], prev_n, sn)
        if scene.has_media:
            crossed = alive & transmissive & (dot(wi, gn) < 0.0)
            if passthru is not None:
                crossed = crossed & ~passthru
            m_ids, m_sp = _medium_update(m_ids, m_sp, crossed, front, mid)
        if cfg.restir_capture and b == 0:
            # direct radiance, and the first bounce's throughput factor
            r_direct = radiance
            tp1 = f * (cos_i / torch.clamp(pdf, min=1e-9))[..., None]
            r_tp1 = torch.where(alive[..., None], finite_or_zero(tp1), r_tp1)
            r_pdf1 = torch.where(alive, pdf, 0.0)
        out = dict(
            ro=ro_n.contiguous(), rd=wi.contiguous(), radiance=radiance,
            throughput=tp_n, alive=alive, prev_pdf=pdf_n, prev_n=sn,
            g_albedo=g_albedo, g_normal=g_normal, g_depth=g_depth,
            g_inst=g_inst, r_emit0=r_emit0, cone_w=cone_w, cone_s=cone_s,
            n_trace=n_trace, n_shadow=n_shadow, n_cq=n_cq, n_ch=n_ch,
            m_ids=m_ids, m_sp=m_sp, r_direct=r_direct, r_x2=r_x2, r_n2=r_n2,
            r_tp1=r_tp1, r_pdf1=r_pdf1, r_valid=r_valid, r_x1=r_x1,
            r_mat1=r_mat1)
        return {k: out[k] for k in st}, rec

    st = dict(ro=ro, rd=rd, radiance=radiance, throughput=throughput,
              alive=alive, prev_pdf=prev_pdf, prev_n=prev_n,
              g_albedo=g_albedo, g_normal=g_normal, g_depth=g_depth,
              g_inst=g_inst, r_emit0=r_emit0, cone_w=cone_w, cone_s=cone_s,
              n_trace=n_trace, n_shadow=n_shadow)
    if query:
        st.update(n_cq=n_cq, n_ch=n_ch)
    if scene.has_media:
        st.update(m_ids=m_ids, m_sp=m_sp)
    if cfg.restir_capture:
        st.update(r_direct=r_direct, r_x2=r_x2, r_n2=r_n2, r_tp1=r_tp1,
                  r_pdf1=r_pdf1, r_valid=r_valid, r_x1=r_x1, r_mat1=r_mat1)
    remat = cfg.remat and torch.is_grad_enabled()
    for b in range(cfg.bounces):
        if remat:
            # RenderConfig.remat: the bounce's shading residuals are
            # recomputed in backward (jax.checkpoint of the bounce body)
            st, rec = checkpoint(bounce, b, st, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            st, rec = bounce(b, st)
        for k, v in rec.items():
            cache_rec[k].append(v)
    radiance = st["radiance"]
    stats = {"n_trace": st["n_trace"], "n_shadow": st["n_shadow"],
             "albedo": st["g_albedo"], "normal": st["g_normal"],
             "depth": st["g_depth"], "emitted0": st["r_emit0"],
             "inst": st["g_inst"]}
    if query:
        stats["cache_hit_rate"] = st["n_ch"] / torch.clamp(st["n_cq"],
                                                           min=1.0)
    if cfg.restir_capture:
        stats.update({k: st[f"r_{k}"] for k in (
            "direct", "x2", "n2", "tp1", "pdf1", "x1", "mat1")},
            cand_valid=st["r_valid"], indirect=radiance - st["r_direct"])
    if cfg.cache_capture:
        stats.update({k: torch.stack(v, 1) for k, v in cache_rec.items()})
    return radiance, stats


# the most lanes `render_sum` traces in one pass of the bounce loop
RENDER_LANES = 1 << 20


def render_sum(scene: Scene, cam: Camera, cfg: RenderConfig, spp: int,
               base_sample: int = 0):
    """([H*W, 3] sum of samples base_sample .. base_sample + spp - 1, the
    last sample's per-lane stats). The samples go through the bounce loop
    together, as many as fit in RENDER_LANES lanes (the sample id is a
    per-lane counter, so a sample takes the same path alone or beside
    others), and are summed in sample order, as the JAX package's
    fori_loop sums them; with RenderConfig.remat each pass's bounces are
    the checkpoints."""
    R = cfg.width * cfg.height
    per = max(1, RENDER_LANES // R)
    pixel = torch.arange(R, device=scene.device)
    acc = torch.zeros((R, 3), device=scene.device)
    for s0 in range(0, spp, per):
        n = min(per, spp - s0)
        sid = torch.arange(base_sample + s0, base_sample + s0 + n,
                           device=scene.device).repeat_interleave(R)
        rad, st = render_sample_with_stats(scene, cam, cfg, pixel.repeat(n),
                                           sid)
        for s in range(n):
            acc = acc + rad[s * R:(s + 1) * R]
    last = {k: v[(n - 1) * R:] for k, v in st.items()
            if v.dim() and v.shape[0] == n * R}
    return acc, last


def render(scene: Scene, cam: Camera, cfg: RenderConfig, spp: int = 16,
           base_sample: int = 0) -> torch.Tensor:
    """[H, W, 3] averaging `spp` samples per pixel (render_sum)."""
    acc, _ = render_sum(scene, cam, cfg, spp, base_sample)
    return (acc / spp).reshape(cfg.height, cfg.width, 3)
