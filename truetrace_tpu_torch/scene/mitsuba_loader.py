"""Minimal Mitsuba 0.x/2.x XML scene importer -> HostMesh/HostMaterial.

Scene-interchange breadth beyond the reference's Unity-side ingestion
(the reference consumes Unity scenes/GLTF; classic research scenes —
Cornell variants, Veach doors, teapots — ship as Mitsuba XML). Supported
subset, chosen to cover the common research-scene corpus:

* shapes: ``obj`` (filename ref), ``rectangle``, ``cube``, ``sphere``
  (lat-long tessellation), with ``to_world`` transforms
  (matrix / translate / scale / rotate / lookat compositions).
* bsdfs: ``diffuse`` (rgb/spectrum reflectance), ``roughconductor`` /
  ``conductor`` (metal, alpha -> roughness), ``dielectric`` /
  ``roughdielectric`` (glass, int_ior), ``plastic`` / ``roughplastic``,
  ``twosided`` (unwrapped). Unknown bsdfs degrade to diffuse gray.
* emitters: ``area`` (radiance rgb) attached to a shape; scene-level
  ``constant`` emitter -> EnvMap.constant.
* sensor: ``perspective`` (fov + to_world; lookat or matrix).

Returns ``(meshes, mats, cam, env)`` ready for ``compile_scene``.

Port of `truetrace_tpu/scene/mitsuba_loader.py`, with the same meshes,
materials, camera and env (tests/test_torch_sources.py). Bitmaps are
decoded by the port's own PNG codec (scene/png.py) where the JAX package
uses Pillow: another format raises NotImplementedError (ROADMAP.md A.27)
and a PNG that cannot be decoded raises ValueError, where the JAX loader
drops the texture; a missing file is skipped by both.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh


def _parse_rgb(value: str) -> Tuple[float, float, float]:
    value = value.replace(",", " ")
    parts = [float(x) for x in value.split()]
    if len(parts) == 1:
        return (parts[0],) * 3
    return tuple(parts[:3])


def _named(elem, name, default=None):
    for child in elem:
        if child.get("name") == name:
            if child.tag in ("rgb", "spectrum", "color"):
                return _parse_rgb(child.get("value", "0.5"))
            if child.tag in ("float", "integer"):
                return float(child.get("value"))
            if child.tag in ("string", "boolean"):
                return child.get("value")
            if child.tag == "point":
                # <point name="center" x=.. y=.. z=..> — the authored
                # form for sphere centers (ADVICE r4: unhandled points
                # silently placed spheres at the origin)
                if child.get("value") is not None:
                    return tuple(float(x) for x in
                                 child.get("value").replace(",", " ")
                                 .split())
                return tuple(float(child.get(a, 0)) for a in "xyz")
    return default


def _transform_matrix(elem) -> np.ndarray:
    """Compose a Mitsuba <transform> into a 4x4 COLUMN-vector matrix."""
    M = np.eye(4)
    if elem is None:
        return M
    for op in elem:
        T = np.eye(4)
        if op.tag == "matrix":
            vals = [float(x) for x in op.get("value").replace(",", " ").split()]
            T = np.asarray(vals, np.float64).reshape(4, 4)
        elif op.tag == "translate":
            T[:3, 3] = [float(op.get(a, 0)) for a in "xyz"]
        elif op.tag == "scale":
            if op.get("value") is not None:
                T[0, 0] = T[1, 1] = T[2, 2] = float(op.get("value"))
            else:
                for i, a in enumerate("xyz"):
                    T[i, i] = float(op.get(a, 1))
        elif op.tag == "rotate":
            ax = np.asarray([float(op.get(a, 0)) for a in "xyz"])
            n = np.linalg.norm(ax)
            ax = ax / (n if n > 0 else 1.0)
            th = np.deg2rad(float(op.get("angle", 0)))
            c, s = np.cos(th), np.sin(th)
            x, y, z = ax
            T[:3, :3] = np.array([
                [c + x * x * (1 - c), x * y * (1 - c) - z * s,
                 x * z * (1 - c) + y * s],
                [y * x * (1 - c) + z * s, c + y * y * (1 - c),
                 y * z * (1 - c) - x * s],
                [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
                 c + z * z * (1 - c)]])
        elif op.tag in ("lookat", "look_at"):
            origin = np.asarray(_parse_rgb(op.get("origin")))
            target = np.asarray(_parse_rgb(op.get("target")))
            up = np.asarray(_parse_rgb(op.get("up", "0, 1, 0")))
            T = np.eye(4)
            fwd = target - origin
            fwd = fwd / max(np.linalg.norm(fwd), 1e-12)
            right = np.cross(fwd, up)
            right = right / max(np.linalg.norm(right), 1e-12)
            true_up = np.cross(right, fwd)
            # Mitsuba camera space: +x right, +y up, +z FORWARD
            T[:3, 0] = right
            T[:3, 1] = true_up
            T[:3, 2] = fwd
            T[:3, 3] = origin
        M = T @ M
    return M


def _apply(M: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return (pts @ M[:3, :3].T + M[:3, 3]).astype(np.float32)


class _TexCtx:
    """Bitmap-texture loading context: resolves inline <texture> elements
    and <ref>s to scene-level <texture id=..> declarations into atlas
    texture ids (+ a per-texture UV scale from uscale/vscale floats or a
    to_uv transform). Mitsuba textured scenes (e.g. the obj-with-texture
    staircase/bathroom corpus) otherwise degrade to flat reflectance."""

    def __init__(self, atlas_builder, base_dir, root):
        self.atlas = atlas_builder
        self.base = base_dir
        self.decl = {t.get("id"): t for t in root.findall("texture")
                     if t.get("id")}
        self.cache: Dict[str, Tuple[int, tuple]] = {}

    def load(self, tex_elem) -> Tuple[int, tuple]:
        if tex_elem.get("type") != "bitmap":
            return -1, (1.0, 1.0)
        fname = _named(tex_elem, "filename")
        if not fname:
            return -1, (1.0, 1.0)
        us = float(_named(tex_elem, "uscale", 1.0) or 1.0)
        vs = float(_named(tex_elem, "vscale", 1.0) or 1.0)
        for tr in tex_elem.findall("transform"):
            if tr.get("name") == "to_uv":
                M = _transform_matrix(tr)
                us, vs = us * float(M[0, 0]), vs * float(M[1, 1])
        key = fname
        if key not in self.cache:
            tid = -1
            fpath = os.path.join(self.base, fname)
            if os.path.exists(fpath):
                from truetrace_tpu_torch.scene.png import read_texture
                tid = self.atlas.add(read_texture(fpath))
            self.cache[key] = (tid, None)
        tid, _ = self.cache[key]
        return tid, (us, vs)

    def lookup(self, elem, name) -> Tuple[int, tuple]:
        """Texture bound to parameter `name` on a bsdf element."""
        for child in elem:
            if child.get("name") != name:
                continue
            if child.tag == "texture":
                return self.load(child)
            if child.tag == "ref" and child.get("id") in self.decl:
                return self.load(self.decl[child.get("id")])
        return -1, (1.0, 1.0)


def _bsdf_to_material(elem, tex: Optional[_TexCtx] = None) -> HostMaterial:
    t = elem.get("type", "diffuse")

    def tex_kw(name):
        if tex is None:
            return {}
        tid, uvs = tex.lookup(elem, name)
        if tid < 0:
            return {}
        return {"tex_albedo": tid,
                "uv_scale": (uvs[0], uvs[1], 0.0, 0.0)}

    if t == "twosided":
        inner = elem.find("bsdf")
        if inner is not None:
            return _bsdf_to_material(inner, tex)
        t = "diffuse"
    if t == "diffuse":
        kw = tex_kw("reflectance")
        base = (1.0, 1.0, 1.0) if kw else \
            _named(elem, "reflectance", (0.5, 0.5, 0.5))
        return HostMaterial(base_color=base, roughness=1.0, **kw)
    if t in ("conductor", "roughconductor"):
        alpha = _named(elem, "alpha", 0.1 if t == "roughconductor"
                       else 0.01)
        return HostMaterial(
            base_color=_named(elem, "specular_reflectance",
                              (0.9, 0.9, 0.9)),
            metallic=1.0, roughness=float(np.sqrt(float(alpha))))
    if t in ("dielectric", "roughdielectric", "thindielectric"):
        alpha = _named(elem, "alpha", 0.0)
        ior = _named(elem, "int_ior", 1.5046)
        ior = 1.5046 if isinstance(ior, str) else float(ior)
        return HostMaterial(
            base_color=(1.0, 1.0, 1.0), spec_trans=1.0, ior=ior,
            roughness=max(float(np.sqrt(float(alpha))), 0.02),
            specular=0.0, thin=1.0 if t == "thindielectric" else 0.0)
    if t in ("plastic", "roughplastic"):
        alpha = _named(elem, "alpha", 0.1)
        kw = tex_kw("diffuse_reflectance")
        base = (1.0, 1.0, 1.0) if kw else \
            _named(elem, "diffuse_reflectance", (0.5, 0.5, 0.5))
        return HostMaterial(base_color=base,
                            roughness=float(np.sqrt(float(alpha))),
                            specular=0.5, **kw)
    return HostMaterial()       # unknown: matte gray


_RECT = (np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                  np.float32),
         np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def _cube():
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _sphere(n_lat=16, n_lon=24):
    from truetrace_tpu_torch.scene.primitives import uv_sphere
    v, f, _ = uv_sphere(n_lat, n_lon, radius=1.0)
    v = v.astype(np.float32)
    # lat-long UVs from the unit-sphere directions (Mitsuba sphere
    # parameterization; the lon seam shares wrapped vertices — fine for
    # the importer subset)
    uv = np.stack([np.arctan2(v[:, 2], v[:, 0]) / (2 * np.pi) + 0.5,
                   np.arccos(np.clip(v[:, 1], -1, 1)) / np.pi],
                  axis=1).astype(np.float32)
    return v, f.astype(np.int32), uv


def load_mitsuba(path: str, atlas_builder=None, device="cuda"):
    """Parse a Mitsuba XML scene. Returns (meshes, mats, cam, env):
    cam is a Camera or None; env an EnvMap or None. Pass an
    scene.atlas.AtlasBuilder to import bitmap textures (tex_albedo ids +
    per-texture UV scale); call its .build() afterwards and hand the
    result to compile_scene(atlas=..., atlas_rects=..., ...). The camera
    and env are on `device` (the card unless the caller asks for the
    CPU)."""
    from truetrace_tpu_torch.scene.ir import Camera, EnvMap

    base = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    tex = _TexCtx(atlas_builder, base, root) \
        if atlas_builder is not None else None

    # id -> material for referenced bsdfs
    mat_by_id: Dict[str, HostMaterial] = {}
    mats: List[HostMaterial] = []
    meshes: List[HostMesh] = []
    env = None
    cam = None

    for b in root.findall("bsdf"):
        if b.get("id"):
            mat_by_id[b.get("id")] = _bsdf_to_material(b, tex)

    def add_mat(m: HostMaterial) -> int:
        mats.append(m)
        return len(mats) - 1

    for shape in root.findall("shape"):
        stype = shape.get("type")
        M = _transform_matrix(shape.find("transform"))

        # material: inline bsdf > ref > default
        mat = None
        inline = shape.find("bsdf")
        if inline is not None:
            mat = _bsdf_to_material(inline, tex)
        else:
            ref = shape.find("ref")
            if ref is not None and ref.get("id") in mat_by_id:
                mat = mat_by_id[ref.get("id")]
        if mat is None:
            mat = HostMaterial()
        emitter = shape.find("emitter")
        if emitter is not None and emitter.get("type") == "area":
            rad = _named(emitter, "radiance", (1.0, 1.0, 1.0))
            mat = HostMaterial(**{**mat.__dict__,
                                  "base_color": (0.0, 0.0, 0.0),
                                  "emission": rad})
        mid = add_mat(mat)

        if stype == "obj":
            fname = _named(shape, "filename")
            from truetrace_tpu_torch.scene.obj_loader import load_obj
            sub_meshes, _ = load_obj(os.path.join(base, fname))
            for sm in sub_meshes:
                meshes.append(HostMesh(
                    _apply(M, sm.positions), sm.indices,
                    np.full(sm.indices.shape[0], mid, np.int32),
                    uvs=sm.uvs))
        elif stype in ("rectangle", "cube", "sphere"):
            uvs = None
            if stype == "rectangle":
                v, f = _RECT
                uvs = (v[:, :2] * 0.5 + 0.5).astype(np.float32)
            elif stype == "cube":
                v, f = _cube()
            else:
                v, f, uvs = _sphere()
                c = _named(shape, "center")
                r = _named(shape, "radius", 1.0)
                if r is not None:
                    v = v * float(r)
                if c is not None:
                    v = v + np.asarray(c, np.float32)
            meshes.append(HostMesh(
                _apply(M, v), f, np.full(f.shape[0], mid, np.int32),
                uvs=uvs))
        # unsupported shapes are skipped

    for emitter in root.findall("emitter"):
        if emitter.get("type") in ("constant", "envmap"):
            rad = _named(emitter, "radiance", (1.0, 1.0, 1.0))
            if isinstance(rad, tuple):
                env = EnvMap.constant(rad, device)

    sensor = root.find("sensor")
    if sensor is not None and sensor.get("type") == "perspective":
        fov = _named(sensor, "fov", 45.0)
        M = _transform_matrix(sensor.find("transform"))
        origin = M[:3, 3]
        fwd = M[:3, 2]          # Mitsuba camera looks down +z
        cam = Camera.look_at(eye=tuple(origin),
                             target=tuple(origin + fwd),
                             fov_y_deg=float(fov), device=device)

    return meshes, mats, cam, env
