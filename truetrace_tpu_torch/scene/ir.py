"""Scene intermediate representation: plain dataclasses of tensors.

Port of `truetrace_tpu/scene/ir.py` (flax pytrees there). Every tensor of
one object lives on one device. `from_numpy` constructors carry objects
across from the JAX package: they take its leaves as numpy arrays, in a
dict keyed by field name, so the port never imports JAX.

Bit patterns: uint32 tables (`cw_nodes`) are held as int32 tensors of the
same bits; integer index arrays are int64 (torch indexing).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch


def _t(a, device, dtype=None) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on `device`, uint32 as int32 bits."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dtype is not None:
        t = t.to(dtype)
    elif t.dtype == torch.int32:
        t = t.to(torch.int64)
    return t.to(device)


def _from_dict(cls, d: dict, device, bits=(), **given):
    """Build dataclass `cls` from a dict of numpy leaves; fields in `bits`
    keep their int32 bit pattern, other integer arrays become int64.
    `given` fields are passed through as they are."""
    kw = dict(given)
    for f in dataclasses.fields(cls):
        if f.name not in d or f.name in given:
            continue
        v = d[f.name]
        if v is None or isinstance(v, (bool, int, float)):
            kw[f.name] = v
        elif f.name in bits:
            kw[f.name] = _t(v, device, torch.int32)
        else:
            kw[f.name] = _t(v, device)
    return cls(**kw)


@dataclass
class MaterialTable:
    """Disney BSDF parameter table, one row per material (the JAX
    package's MaterialTable field set; texture slots are int64, -1 =
    none)."""
    base_color: torch.Tensor
    emission: torch.Tensor
    roughness: torch.Tensor
    metallic: torch.Tensor
    spec_trans: torch.Tensor
    ior: torch.Tensor
    specular: torch.Tensor
    spec_tint: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    anisotropic: torch.Tensor
    subsurface: torch.Tensor
    diff_trans: torch.Tensor
    thin: torch.Tensor
    alpha: torch.Tensor
    tex_albedo: torch.Tensor
    tex_normal: torch.Tensor
    tex_emission: torch.Tensor
    tex_rough_metal: torch.Tensor
    tex_matcap: torch.Tensor
    tex_metallic: torch.Tensor
    tex_roughness: torch.Tensor
    tex_alpha: torch.Tensor
    tex_matcap_mask: torch.Tensor
    rough_tex_invert: torch.Tensor
    uv_scale: torch.Tensor
    uv2_scale: torch.Tensor
    uv_rot: torch.Tensor
    normal_strength: torch.Tensor
    hue: torch.Tensor
    brightness: torch.Tensor
    saturation: torch.Tensor
    contrast: torch.Tensor
    blend_color: torch.Tensor
    blend_factor: torch.Tensor
    rough_remap: torch.Tensor
    metal_remap: torch.Tensor
    scatter_dist: torch.Tensor
    transmit_color: torch.Tensor

    @staticmethod
    def from_numpy(d: dict, device) -> "MaterialTable":
        return _from_dict(MaterialTable, d, device)

    def n_materials(self) -> int:
        return self.roughness.shape[0]

    def gather(self, mid: torch.Tensor) -> "MaterialTable":
        """Per-ray material rows (every column indexed by `mid`)."""
        return MaterialTable(**{f.name: getattr(self, f.name)[mid]
                                for f in dataclasses.fields(self)})


@dataclass
class LightTris:
    """Emissive-triangle list with its power CDF and packed sample rows
    [L,16]: p0(0:3) e1(3:6) e2(6:9) unit-gn(9:12) area(12) pmf(13)
    mat_id(14) pad(15). Without rows (None) NEE reads the light's
    triangle from the scene's triangle tables."""
    tri_index: torch.Tensor
    power: torch.Tensor
    cdf: torch.Tensor
    pmf: torch.Tensor
    tri_to_light: torch.Tensor
    rows: Optional[torch.Tensor] = None

    @staticmethod
    def from_numpy(d: dict, device) -> "LightTris":
        return _from_dict(LightTris, d, device)


@dataclass
class AnalyticLights:
    """Unity-style analytic lights (reference RayTracingLights.cs
    LightData): ltype 0 point, 1 directional, 2 spot, 3 quad, 4 disk
    (integrate/lights.py)."""
    position: torch.Tensor     # [K,3]
    direction: torch.Tensor    # [K,3]
    radiance: torch.Tensor     # [K,3]
    ltype: torch.Tensor        # [K] int64
    spot_cos: torch.Tensor     # [K,2] a spot's inner / outer cosine
    extent: torch.Tensor       # [K,2] quad half-extents / disk radius
    softness: torch.Tensor     # [K] point / spot / directional penumbra
    z_rot: Optional[torch.Tensor] = None   # [K] a quad's in-plane turn

    @staticmethod
    def none(device="cuda") -> "AnalyticLights":
        z3 = torch.zeros((0, 3), device=device)
        z2 = torch.zeros((0, 2), device=device)
        z1 = torch.zeros((0,), device=device)
        return AnalyticLights(z3, z3, z3, torch.zeros((0,), dtype=torch.int64,
                                                      device=device),
                              z2, z2, z1, z1)

    @staticmethod
    def from_numpy(d: dict, device) -> "AnalyticLights":
        return _from_dict(AnalyticLights, d, device)

    def to(self, device) -> "AnalyticLights":
        return AnalyticLights(**{
            f.name: None if getattr(self, f.name) is None
            else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclass
class EnvMap:
    """Equirect environment with its 2-D CDF importance tables
    (build/env_cdf.py; reference CDFCreator.compute + SampleLI,
    CommonData.cginc:1437-1464). A 1x1 image is the constant env: no
    tables, no env NEE. image [H,W,3], cdf_x [H,W] per-row inclusive
    CDFs, cdf_y [H] marginal CDF (sin-theta weighted), total, rotation
    and intensity 0-d."""
    image: torch.Tensor
    cdf_x: torch.Tensor
    cdf_y: torch.Tensor
    total: torch.Tensor
    rotation: torch.Tensor
    intensity: torch.Tensor

    @staticmethod
    def constant(rgb=(0.0, 0.0, 0.0), device="cuda") -> "EnvMap":
        f = lambda a: torch.tensor(a, dtype=torch.float32, device=device)
        img = f(np.asarray(rgb, np.float32)).reshape(1, 1, 3)
        return EnvMap(image=img, cdf_x=f(np.ones((1, 1), np.float32)),
                      cdf_y=f(np.ones((1,), np.float32)),
                      total=f(np.float32(np.mean(rgb))),
                      rotation=f(np.float32(0.0)),
                      intensity=f(np.float32(1.0)))

    @staticmethod
    def from_numpy(d: dict, device) -> "EnvMap":
        return _from_dict(EnvMap, d, device)

    def to(self, device) -> "EnvMap":
        return EnvMap(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


@dataclass
class MeshTable:
    """The instance table of an instanced scene, one row per instance:
    world <-> local transforms [I,4,4] (row-vector convention), the BLAS
    root node and first triangle, the first world light row (-1 none),
    the world bounds [I,2,3]."""
    w2l: torch.Tensor
    l2w: torch.Tensor
    node_offset: torch.Tensor
    tri_offset: torch.Tensor
    light_node_offset: torch.Tensor
    aabb: torch.Tensor

    @staticmethod
    def from_numpy(d: dict, device) -> "MeshTable":
        return _from_dict(MeshTable, d, device)


# the texture slots the integrator's texture block reads (tex_matcap_mask
# is read with tex_matcap)
TEX_SLOTS = ("tex_albedo", "tex_normal", "tex_emission", "tex_rough_metal",
             "tex_matcap", "tex_metallic", "tex_roughness", "tex_alpha")


@dataclass
class Scene:
    """The render-ready scene (the fields the port's frame reads).
    Triangles are in CWBVH leaf order; `cw_nodes` are the
    pack_leaf_rows-patched 20-word nodes (int32 bits), `cw_leaf_rows` the
    [L,10K] leaf rows (f32, id columns hold int32 bits). An instanced
    scene (scene/instances.py) holds local-space triangles of its sources
    followed by world copies of its emissive instance triangles, the TLAS
    nodes before the BLAS nodes, and `inst_rows` [I,10K] (W2L, the BLAS
    root, the instance id), `inst_l2w` [I,3,4], `inst_em_rank` [T] (a
    local row's rank among its source's emitters, -1 none) and
    `inst_light_offset` [I] (an instance's first world light row, -1
    none). `terrain` is a heightfield (scene/terrain.py) traced after the
    meshes."""
    tri_p0: torch.Tensor
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_n: torch.Tensor
    tri_uv: torch.Tensor
    tri_tan: torch.Tensor
    tri_mat: torch.Tensor
    bvh2_box: torch.Tensor
    bvh2_left: torch.Tensor
    bvh2_count: torch.Tensor
    cw_nodes: torch.Tensor
    cw_tri_index: torch.Tensor
    cw_leaf_rows: torch.Tensor
    # texture atlas (scene/atlas.py; no rects = no textures): [AHm,AW,4]
    # f32 with the mip chain stacked below level 0, rects [NT,4] (x, y,
    # w, h in level-0 texels), each level's row origin, and the base
    # texture LOD per triangle (0.5 log2 of texel over world area)
    atlas: torch.Tensor
    atlas_rects: torch.Tensor
    atlas_level_y: torch.Tensor
    tri_lod: torch.Tensor
    materials: MaterialTable
    light_tris: LightTris
    lights: AnalyticLights
    env: EnvMap
    lbvh_nodes: torch.Tensor
    lbvh_info: torch.Tensor
    lbvh_prim: torch.Tensor
    lbvh_trail: torch.Tensor
    lbvh_pairs: torch.Tensor
    lbvh_pair_children: torch.Tensor
    lcut_bounds: Optional[torch.Tensor] = None
    lcut_link: Optional[torch.Tensor] = None
    lcut_node_ids: Optional[torch.Tensor] = None
    lcut_of_light: Optional[torch.Tensor] = None
    lcut_skip: Optional[torch.Tensor] = None
    tri_shadow: Optional[torch.Tensor] = None
    terrain: Optional[object] = None
    mesh_table: Optional[MeshTable] = None
    inst_rows: Optional[torch.Tensor] = None
    inst_l2w: Optional[torch.Tensor] = None
    inst_em_rank: Optional[torch.Tensor] = None
    inst_light_offset: Optional[torch.Tensor] = None
    cw_stack: int = 16
    has_media: bool = True
    # the TEX_SLOTS some material sets, fixed when the scene is built
    # (empty without an atlas): the integrator fetches only these
    tex_slots: tuple = ()
    # levels of internal nodes in the light BVH, fixed when the scene is
    # built: the bound on every light-tree descent loop
    lbvh_depth: int = 0
    # the traversal's unified [C+L(+I), 10K] node, leaf-row (and instance
    # row) table, built at first use (kernels/cwbvh_wavefront.py
    # pack_table)
    _cw_table: Optional[torch.Tensor] = field(default=None, repr=False)

    def n_tris(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_p0.device

    def cw_table(self) -> torch.Tensor:
        if self._cw_table is None:
            from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
                pack_table)
            self._cw_table = pack_table(self.cw_nodes, self.cw_leaf_rows,
                                        self.inst_rows)
        return self._cw_table

    @staticmethod
    def from_numpy(d: dict, device) -> "Scene":
        """Scene from the JAX Scene's leaves (numpy arrays keyed by field
        name, nested dicts for materials/light_tris/lights/env and an
        instanced scene's mesh_table and a terrain)."""
        scene = Scene.from_parts(
            d, MaterialTable.from_numpy(d["materials"], device),
            LightTris.from_numpy(d["light_tris"], device),
            AnalyticLights.from_numpy(d["lights"], device),
            EnvMap.from_numpy(d["env"], device), device)
        if d.get("mesh_table") is not None:
            scene.mesh_table = MeshTable.from_numpy(d["mesh_table"], device)
        if d.get("terrain") is not None:
            from truetrace_tpu_torch.scene.terrain import Terrain
            scene.terrain = Terrain.from_numpy(d["terrain"], device)
        return scene

    @staticmethod
    def from_parts(d: dict, materials, light_tris, lights, env,
                   device) -> "Scene":
        """Scene from numpy table leaves plus already-built parts."""
        slots = ()
        if np.asarray(d["atlas_rects"]).shape[0] > 0:
            slots = tuple(k for k in TEX_SLOTS
                          if bool((getattr(materials, k) >= 0).any()))
        d = {k: v for k, v in d.items()
             if k not in ("mesh_table", "terrain")}
        return _from_dict(Scene, d, device, bits=("cw_nodes", "lbvh_trail"),
                          materials=materials, light_tris=light_tris,
                          lights=lights, env=env, tex_slots=slots,
                          lbvh_depth=light_bvh_depth(d["lbvh_info"]))


def light_bvh_depth(info) -> int:
    """Levels of internal nodes in a light BVH of node rows `info` [N,2]
    (child, -sibling where internal), capped at 32: the depth at which
    the JAX package's descent while_loops stop."""
    info = np.asarray(info)
    if info.shape[0] == 0:
        return 0
    depth, frontier = 0, [0]
    while frontier:
        frontier = [c for n in frontier if info[n, 1] < 0
                    for c in (info[n, 0], -info[n, 1])]
        depth += 1
    return min(depth, 32)


@dataclass
class Camera:
    """Pinhole + thin-lens camera: c2w [4,4] row-vector convention (rows:
    right, up, back, eye), fov_y/aperture/focus_dist 0-d tensors."""
    c2w: torch.Tensor
    fov_y: torch.Tensor
    aperture: torch.Tensor
    focus_dist: torch.Tensor

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_y_deg=40.0,
                aperture=0.0, focus_dist=1.0, device="cuda") -> "Camera":
        eye = np.asarray(eye, np.float32)
        fwd = np.asarray(target, np.float32) - eye
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float32))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        m = np.eye(4, dtype=np.float32)
        m[0, :3] = right
        m[1, :3] = true_up
        m[2, :3] = -fwd          # camera looks down -z
        m[3, :3] = eye
        return Camera.from_numpy(dict(
            c2w=m, fov_y=np.float32(np.deg2rad(fov_y_deg)),
            aperture=np.float32(aperture),
            focus_dist=np.float32(focus_dist)), device)

    @staticmethod
    def from_numpy(d: dict, device) -> "Camera":
        return _from_dict(Camera, d, device)

    def to(self, device) -> "Camera":
        return Camera(**{f.name: getattr(self, f.name).to(device)
                         for f in dataclasses.fields(self)})


def camera_rays(cam: Camera, width: int, height: int, pixel_id, jitter,
                lens_u=None):
    """Primary rays for flat pixel ids [R] (y*width+x) with jitter [R,2]
    and optional thin-lens samples lens_u [R,2]. Returns (ro, rd) [R,3]."""
    x = (pixel_id % width).to(torch.float32) + jitter[..., 0]
    y = torch.div(pixel_id, width, rounding_mode="floor").to(
        torch.float32) + jitter[..., 1]
    ndc_x = (x / width) * 2.0 - 1.0
    ndc_y = 1.0 - (y / height) * 2.0
    tan_half = torch.tan(cam.fov_y * 0.5)
    aspect = width / height
    vx = ndc_x * tan_half * aspect
    vy = ndc_y * tan_half
    d_cam = torch.stack([vx, vy, -torch.ones_like(vx)], -1)

    right = cam.c2w[0, :3]
    up = cam.c2w[1, :3]
    back = cam.c2w[2, :3]
    eye = cam.c2w[3, :3]
    rd = (d_cam[..., 0:1] * right + d_cam[..., 1:2] * up
          - d_cam[..., 2:3] * (-back))
    rd = rd / _norm3(rd)
    ro = eye.expand(rd.shape)

    if lens_u is not None:
        # thin lens: offset the origin on the lens disk, refocus at
        # focus_dist (the offset vanishes for a pinhole, aperture 0)
        r = torch.sqrt(lens_u[..., 0]) * cam.aperture
        phi = 2.0 * math.pi * lens_u[..., 1]
        off = (r * torch.cos(phi))[..., None] * right + \
              (r * torch.sin(phi))[..., None] * up
        rb = rd * back
        focus_p = ro + rd * (cam.focus_dist / torch.clamp(
            -(rb[..., 0:1] + rb[..., 1:2] + rb[..., 2:3]), min=1e-6))
        ro = ro + off
        rd = focus_p - ro
        rd = rd / _norm3(rd)
    return ro, rd


def _norm3(v):
    """Euclidean norm over the last axis, keepdim. torch.linalg.norm rounds
    as jnp.linalg.norm does on the CPU (tests/test_torch_core.py)."""
    return torch.linalg.norm(v, dim=-1, keepdim=True)
