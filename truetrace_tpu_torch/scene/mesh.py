"""Host-side mesh container + scene compilation into the port's Scene.

Port of `truetrace_tpu/scene/mesh.py` for the single-BLAS scene (the
BVH2 alone, the JAX default, or with the CWBVH):
numpy in, a `Scene` of tensors on `device` out. The tables are bitwise
equal to the JAX package's (tests/test_torch_scene.py), the texture
atlas and per-triangle texture LOD included (tests/test_torch_sponza.py).
A terrain (scene/terrain.py) rides along on the scene. Presplit
(build/presplit.py), the on-disk build cache (scene/build_cache.py, whose
entries either package can read) and heat-ordered leaf rows are the JAX
package's too (tests/test_torch_build_opts.py); the MXU brute-force
tables are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from truetrace_tpu_torch.build.bvh2 import build_bvh2
from truetrace_tpu_torch.core import aabb as aabb_ops
from truetrace_tpu_torch.scene.ir import (
    AnalyticLights, EnvMap, LightTris, MaterialTable, Scene)


@dataclass
class HostMesh:
    """One mesh: positions [V,3], triangle indices [F,3], per-face material."""
    positions: np.ndarray
    indices: np.ndarray
    mat_id: np.ndarray                    # [F] int32 (global material id)
    normals: Optional[np.ndarray] = None  # [V,3] or None -> geometric
    uvs: Optional[np.ndarray] = None      # [V,2] or None -> zeros


@dataclass
class HostMaterial:
    """Host-side Disney material description (defaults = matte gray);
    the JAX package's field set, tex_* = atlas ids (-1 = untextured)."""
    base_color: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0
    spec_trans: float = 0.0
    ior: float = 1.5
    specular: float = 0.5
    spec_tint: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.5
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.97
    anisotropic: float = 0.0
    subsurface: float = 0.0
    diff_trans: float = 0.0
    thin: float = 0.0
    alpha: float = 1.0
    hue: float = 0.0
    brightness: float = 1.0
    saturation: float = 1.0
    contrast: float = 1.0
    blend_color: tuple = (0.0, 0.0, 0.0)
    blend_factor: float = 0.0
    rough_remap: tuple = (0.0, 1.0)
    metal_remap: tuple = (0.0, 1.0)
    scatter_dist: float = 0.0
    transmit_color: tuple = (-1.0, -1.0, -1.0)
    uv_scale: tuple = (1.0, 1.0, 0.0, 0.0)
    uv2_scale: tuple = (1.0, 1.0)
    uv_rot: float = 0.0
    normal_strength: float = 1.0
    rough_tex_invert: float = 0.0
    tex_albedo: int = -1
    tex_normal: int = -1
    tex_emission: int = -1
    tex_rough_metal: int = -1
    tex_matcap: int = -1
    tex_metallic: int = -1
    tex_roughness: int = -1
    tex_alpha: int = -1
    tex_matcap_mask: int = -1


_INT_COLS = ("tex_albedo", "tex_normal", "tex_emission", "tex_rough_metal",
             "tex_matcap", "tex_metallic", "tex_roughness", "tex_alpha",
             "tex_matcap_mask")


def material_table(mats: List[HostMaterial], device) -> MaterialTable:
    import dataclasses
    cols = {}
    for f in dataclasses.fields(MaterialTable):
        dt = np.int32 if f.name in _INT_COLS else np.float32
        cols[f.name] = np.array([getattr(m, f.name) for m in mats], dt)
    return MaterialTable.from_numpy(cols, device)


def flatten_meshes(meshes: List[HostMesh]):
    """Concatenate meshes into world-space triangle soup. Returns a dict of
    numpy arrays: p0,e1,e2 [T,3], n [T,3,3], uv [T,3,2], tan [T,3], mat [T]."""
    p0l, e1l, e2l, nl, uvl, ml, tanl = [], [], [], [], [], [], []
    for mesh in meshes:
        pos = mesh.positions.astype(np.float32)
        idx = mesh.indices.astype(np.int64)
        v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
        p0l.append(v0)
        e1l.append(v1 - v0)
        e2l.append(v2 - v0)
        if mesh.normals is not None:
            nrm = mesh.normals.astype(np.float32)
            tn = np.stack([nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]]], 1)
        else:
            gn = np.cross(v1 - v0, v2 - v0)
            gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
            tn = np.repeat(gn[:, None, :], 3, axis=1)
        nl.append(tn)
        if mesh.uvs is not None:
            uv = mesh.uvs.astype(np.float32)
            tuv = np.stack([uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]], 1)
        else:
            tuv = np.zeros((idx.shape[0], 3, 2), np.float32)
        uvl.append(tuv)
        # per-face tangent aligned with +u: T = (e1*dv2 - e2*dv1) / det
        du1 = tuv[:, 1] - tuv[:, 0]
        du2 = tuv[:, 2] - tuv[:, 0]
        det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
        e1f, e2f = v1 - v0, v2 - v0
        tan = (e1f * du2[:, 1:2] - e2f * du1[:, 1:2]) \
            / np.where(np.abs(det) < 1e-12, 1.0, det)[:, None]
        nrm = np.linalg.norm(tan, axis=-1, keepdims=True)
        tan = np.where(nrm > 1e-8, tan / np.maximum(nrm, 1e-12), 0.0)
        tan[np.abs(det) < 1e-12] = 0.0
        tanl.append(tan.astype(np.float32))
        ml.append(mesh.mat_id.astype(np.int32))
    return dict(
        p0=np.concatenate(p0l), e1=np.concatenate(e1l),
        e2=np.concatenate(e2l), n=np.concatenate(nl),
        uv=np.concatenate(uvl), tan=np.concatenate(tanl),
        mat=np.concatenate(ml))


def pack_light_rows_torch(p0, e1, e2, mat_id, pmf):
    """[L,16] packed per-light NEE sample rows: p0(0:3) e1(3:6) e2(6:9)
    unit-gn(9:12) area(12) pmf(13) mat_id(14, exact float) pad(15), from
    tensors on any device (pose_scene rebuilds them on the card).

    The JAX package computes these with jnp.cross and jnp.linalg.norm,
    which XLA:CPU compiles with contracted mul-adds; the cross product is
    therefore formed as fma(a1, b2, -(a2*b1)) (core/math.py cross_fma),
    and the norm by torch.linalg.norm, which rounds the same way."""
    from truetrace_tpu_torch.core.math import cross_fma
    gn = cross_fma(e1, e2)
    area2 = torch.linalg.norm(gn, dim=-1)
    gnu = gn / torch.clamp(area2, min=1e-20)[:, None]
    L = p0.shape[0]
    return torch.cat([p0, e1, e2, gnu, (0.5 * area2)[:, None], pmf[:, None],
                      mat_id.to(torch.float32)[:, None],
                      torch.zeros((L, 1), device=p0.device)], 1)


def pack_light_rows(p0, e1, e2, mat_id, pmf):
    """`pack_light_rows_torch` on numpy arrays."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return pack_light_rows_torch(
        t(p0.astype(np.float32)), t(e1.astype(np.float32)),
        t(e2.astype(np.float32)), t(np.asarray(mat_id)),
        t(pmf.astype(np.float32))).numpy()


def _emissive_light_tris(tris, mats: List[HostMaterial], device) -> LightTris:
    """Emissive triangles + power CDF + packed sample rows."""
    T = tris["mat"].shape[0]
    emis = np.array([np.max(m.emission) for m in mats], np.float32)
    is_emis = emis[tris["mat"]] > 0.0
    ids = np.nonzero(is_emis)[0].astype(np.int32)
    if ids.size == 0:
        return LightTris.from_numpy(dict(
            tri_index=np.zeros((0,), np.int32),
            power=np.zeros((0,), np.float32), cdf=np.zeros((0,), np.float32),
            pmf=np.zeros((0,), np.float32),
            tri_to_light=np.full((T,), -1, np.int32),
            rows=np.zeros((0, 16), np.float32)), device)
    area = 0.5 * np.linalg.norm(
        np.cross(tris["e1"][ids], tris["e2"][ids]), axis=-1)
    lum = np.array([0.2126 * m.emission[0] + 0.7152 * m.emission[1]
                    + 0.0722 * m.emission[2] for m in mats], np.float32)
    power = area * lum[tris["mat"][ids]] * np.pi
    cdf = np.cumsum(power)
    cdf /= max(cdf[-1], 1e-20)
    pmf = np.diff(np.concatenate([[0.0], cdf])).astype(np.float32)
    inv = np.full((T,), -1, np.int32)
    inv[ids] = np.arange(ids.size, dtype=np.int32)
    return LightTris.from_numpy(dict(
        tri_index=ids, power=power.astype(np.float32),
        cdf=cdf.astype(np.float32), pmf=pmf, tri_to_light=inv,
        rows=pack_light_rows(tris["p0"][ids], tris["e1"][ids],
                             tris["e2"][ids], tris["mat"][ids], pmf)),
        device)


def shadow_tint_table(mats: List[HostMaterial], tri_mat: np.ndarray):
    """Per-tri shadow transmittance tint [T,3], or None when every
    material is opaque."""
    alpha = np.array([m.alpha for m in mats], np.float32)
    st = np.array([m.spec_trans for m in mats], np.float32)
    if np.all(alpha >= 1.0) and np.all(st <= 0.0):
        return None
    bc = np.array([m.base_color for m in mats], np.float32)
    tint = (1.0 - alpha)[:, None] + (alpha * st)[:, None] * bc
    return np.clip(tint[tri_mat], 0.0, 1.0)


def texture_lod(tris, mats: List[HostMaterial], atlas_rects) -> np.ndarray:
    """Base texture LOD per triangle [T]: 0.5 * log2(albedo texel area /
    world area) for albedo-textured triangles, else 0 (the ray-cone mip
    selection adds the cone's width to it; the reference derives LOD from
    hardware derivatives)."""
    T = tris["p0"].shape[0]
    if atlas_rects is None or len(atlas_rects) == 0:
        return np.zeros((T,), np.float32)
    alb = np.array([m.tex_albedo for m in mats], np.int32)[tris["mat"]]
    rect = np.asarray(atlas_rects)[np.maximum(alb, 0)]
    texels = np.maximum(rect[:, 2] * rect[:, 3], 1).astype(np.float64)
    duv1 = tris["uv"][:, 1] - tris["uv"][:, 0]
    duv2 = tris["uv"][:, 2] - tris["uv"][:, 0]
    uv_area = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1]
                           - duv2[:, 0] * duv1[:, 1])
    w_area = 0.5 * np.linalg.norm(np.cross(tris["e1"], tris["e2"]), axis=-1)
    dens = uv_area * texels / np.maximum(w_area, 1e-12)
    return np.where(alb >= 0, 0.5 * np.log2(np.maximum(dens, 1e-12)),
                    0.0).astype(np.float32)


def compile_scene(meshes: List[HostMesh], mats: List[HostMaterial],
                  env: Optional[EnvMap] = None,
                  lights: Optional[AnalyticLights] = None,
                  atlas=None, atlas_rects=None, atlas_level_y=None,
                  max_leaf: int = 4, with_cwbvh: bool = False,
                  with_light_bvh: bool = False, terrain=None,
                  presplit: float = 0.0, leaf_k: Optional[int] = None,
                  cache_dir: Optional[str] = None, hot_order: bool = False,
                  device="cuda") -> Scene:
    """Build the render-ready single-BLAS Scene on `device` (the card
    unless the caller asks for the CPU). `env` may be constant or
    textured (build/env_cdf.py); `atlas`, `atlas_rects` and
    `atlas_level_y` come from AtlasBuilder.build (scene/obj_loader.py
    load_obj_scene returns them).

    leaf_k: triangles per CWBVH leaf row (any K; rows are 10K words).
    None picks the JAX package's rule (6 up to 400k triangles, else 12),
    so both packages build the same scene; the port's own default on the
    H100 is open (ROADMAP.md).

    cache_dir: directory of the on-disk build cache (scene/build_cache.py);
    None reads the TRUETRACE_BUILD_CACHE environment variable, and unset
    means no cache. presplit > 0 bisects triangles whose AABB half-area
    exceeds `presplit` x the scene mean before the build
    (build/presplit.py). hot_order places the leaf-row groups of the
    hottest nodes first (cwbvh_wavefront.reorder_leaf_rows_hot).

    with_cwbvh=False (the default, as in the JAX package) builds the BVH2
    alone, with leaves of `max_leaf` triangles (the SAH may stop at up to
    24), for traversal="bvh2": the triangles in BVH2 leaf order, empty
    CWBVH tables, cw_stack 16 and no build cache."""
    tris = flatten_meshes(meshes)
    if presplit > 0.0:
        from truetrace_tpu_torch.build.presplit import presplit_triangles
        tris = presplit_triangles(tris, max_ratio=presplit)
    tri_box = aabb_ops.from_tris(
        tris["p0"], tris["p0"] + tris["e1"], tris["p0"] + tris["e2"])
    if leaf_k is None:
        leaf_k = 6 if tris["p0"].shape[0] <= 400_000 else 12

    from truetrace_tpu_torch.scene import build_cache as _bc
    if cache_dir is None:
        cache_dir = _bc.default_cache_dir()
    cache_key = cached = new_products = None
    if cache_dir is not None and with_cwbvh:
        cache_key = _bc.scene_build_key(tris, mats, leaf_k, with_light_bvh,
                                        hot_order=hot_order)
        cached = _bc.load_build(cache_dir, cache_key)

    if cached is not None:
        full_perm = cached["full_perm"]
        for key in ("p0", "e1", "e2", "n", "uv", "tan", "mat"):
            tris[key] = tris[key][full_perm]
        bvh_box, bvh_left, bvh_count = (cached["bvh2_box"],
                                        cached["bvh2_left"],
                                        cached["bvh2_count"])
        nodes2, tri_index, rows = (cached["cw_nodes"],
                                   cached["cw_tri_index"],
                                   cached["cw_leaf_rows"])
        cw_stack = int(cached["cw_stack"])
    elif with_cwbvh:
        # CWBVH collapse needs BVH2 leaves with <= leaf_k prims
        bvh = build_bvh2(tri_box, max_leaf=leaf_k, sah_leaf_cap=leaf_k)
        perm = bvh.order
        for key in ("p0", "e1", "e2", "n", "uv", "tan", "mat"):
            tris[key] = tris[key][perm]
        from truetrace_tpu_torch.build.cwbvh import build_cwbvh
        cw = build_cwbvh(bvh, tri_box[perm], p_max=leaf_k)
        # re-permute triangles into CWBVH emit order; remap BVH2 leaf starts
        for key in ("p0", "e1", "e2", "n", "uv", "tan", "mat"):
            tris[key] = tris[key][cw.tri_index]
        leaf = bvh.count > 0
        bvh.left[leaf] = cw.leaf_start[leaf]
        from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
            pack_leaf_rows, reorder_leaf_rows_hot)
        nodes2, rows = pack_leaf_rows(
            cw.nodes, cw.slot_tri_base, cw.slot_tri_count,
            tris["p0"], tris["e1"], tris["e2"], k=leaf_k)
        if hot_order:
            nodes2, rows = reorder_leaf_rows_hot(nodes2, rows)
        bvh_box, bvh_left, bvh_count = bvh.box, bvh.left, bvh.count
        tri_index = cw.tri_index
        cw_stack = int(cw.depth) + 1
        if cache_key is not None:
            new_products = dict(
                full_perm=perm[cw.tri_index].astype(np.int32),
                bvh2_box=bvh.box, bvh2_left=bvh.left, bvh2_count=bvh.count,
                cw_nodes=nodes2, cw_tri_index=cw.tri_index,
                cw_leaf_rows=rows, cw_stack=np.int32(cw_stack),
                bvh2_depth=np.int32(bvh.depth))
    else:
        bvh = build_bvh2(tri_box, max_leaf=max_leaf)
        # triangles in BVH2 leaf order (contiguous leaf runs)
        for key in ("p0", "e1", "e2", "n", "uv", "tan", "mat"):
            tris[key] = tris[key][bvh.order]
        bvh_box, bvh_left, bvh_count = bvh.box, bvh.left, bvh.count
        nodes2 = np.zeros((0, 20), np.uint32)
        tri_index = np.zeros((0,), np.int32)
        rows = np.zeros((0, 30), np.float32)
        cw_stack = 16

    light_tris = _emissive_light_tris(tris, mats, device)
    tri_lod = texture_lod(tris, mats, atlas_rects)

    lb_np = dict(lbvh_nodes=np.zeros((0, 12), np.float32),
                 lbvh_info=np.zeros((0, 2), np.int32),
                 lbvh_prim=np.zeros((0,), np.int32),
                 lbvh_trail=np.zeros((0,), np.uint32),
                 lbvh_pairs=np.zeros((0, 26), np.float32),
                 lbvh_pair_children=np.zeros((0, 2), np.int32))
    if with_light_bvh and int(light_tris.tri_index.shape[0]) > 1:
        lcut_keys = ("lcut_bounds", "lcut_link", "lcut_node_ids",
                     "lcut_of_light", "lcut_skip")
        if cached is not None and "lbvh_nodes" in cached:
            lb_np = {k: cached[k] for k in tuple(lb_np) + lcut_keys}
        else:
            from truetrace_tpu_torch.build.lightbvh import (
                build_cut, build_light_bvh, build_pairs)
            lb = build_light_bvh(tris, light_tris.tri_index.cpu().numpy(),
                                 light_tris.power.cpu().numpy())
            pairs, pair_children = build_pairs(lb.nodes, lb.info)
            cut = build_cut(lb)
            lb_np = dict(lbvh_nodes=lb.nodes, lbvh_info=lb.info,
                         lbvh_prim=lb.prim, lbvh_trail=lb.trail,
                         lbvh_pairs=pairs, lbvh_pair_children=pair_children,
                         lcut_bounds=cut.bounds, lcut_link=cut.link,
                         lcut_node_ids=cut.node_ids,
                         lcut_of_light=cut.of_light, lcut_skip=cut.skip)
            if new_products is not None:
                new_products.update(lb_np)
    if new_products is not None:
        _bc.save_build(cache_dir, cache_key, new_products)

    tint = shadow_tint_table(mats, tris["mat"])
    d = dict(
        tri_p0=tris["p0"], tri_e1=tris["e1"], tri_e2=tris["e2"],
        tri_n=tris["n"], tri_uv=tris["uv"], tri_tan=tris["tan"],
        tri_mat=tris["mat"], bvh2_box=bvh_box, bvh2_left=bvh_left,
        bvh2_count=bvh_count, cw_nodes=nodes2, cw_tri_index=tri_index,
        cw_leaf_rows=rows,
        atlas=np.asarray(atlas, np.float32) if atlas is not None
        else np.zeros((1, 1, 4), np.float32),
        atlas_rects=np.asarray(atlas_rects, np.int32)
        if atlas_rects is not None else np.zeros((0, 4), np.int32),
        atlas_level_y=np.asarray(atlas_level_y, np.int32)
        if atlas_level_y is not None else np.zeros((1,), np.int32),
        tri_lod=tri_lod,
        tri_shadow=tint, cw_stack=cw_stack,
        has_media=any(m.spec_trans > 0.0 and m.thin < 0.5 for m in mats),
        **lb_np)
    scene = Scene.from_parts(
        d, material_table(mats, device), light_tris,
        lights.to(device) if lights is not None
        else AnalyticLights.none(device),
        env.to(device) if env is not None
        else EnvMap.constant((0.0, 0.0, 0.0), device), device)
    if terrain is not None:
        scene.terrain = terrain.to(device)
    return scene
