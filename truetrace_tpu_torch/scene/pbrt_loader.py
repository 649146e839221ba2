"""PBRT scene importer (v3/v4 text subset).

Counterpart of the reference's scene-ingestion breadth: TrueTrace ships
Unity asset extraction plus a Mitsuba-parser lineage
(`Images/Early-Mitsuba-Parser-Tests.png`; our scene/mitsuba_loader.py)
— PBRT is the other lingua franca the renderer's demo scenes circulate
in (pbrt.org scene suite: Sponza, San Miguel, ...). Supported subset:

* `LookAt` + `Camera "perspective"` (fov)
* graphics-state stack: `AttributeBegin/End`, `TransformBegin/End`,
  `Translate`, `Scale`, `Rotate`, `Transform`, `ConcatTransform`,
  `Identity`
* `Material` / `MakeNamedMaterial` + `NamedMaterial`: matte/diffuse,
  plastic/coateddiffuse, glass/dielectric, metal/conductor, mirror,
  uber, disney (common params: Kd/reflectance, roughness, eta/index,
  Ks, Kr, Kt, metallic, opacity)
* `Shape "trianglemesh"` (P/indices/uv/N), `Shape "sphere"` (radius)
* `AreaLightSource "diffuse"` (L/scale)
* `LightSource`: infinite (constant L -> EnvMap), point (I), distant (L)
* `Scale -1 1 1`-style CTMs handled by general 4x4 composition;
  `Texture`, `plymesh`, mediums and unsupported shapes are skipped with
  a warning list returned via `load_pbrt(..., strict=False)`.

Returns (meshes, materials, camera, env, lights) ready for
compile_scene.

Port of `truetrace_tpu/scene/pbrt_loader.py`, with the same meshes,
materials, camera, env and lights (tests/test_torch_sources.py); the
camera, env and lights are built on `device`.
"""
from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from truetrace_tpu_torch.scene.ir import AnalyticLights, Camera, EnvMap
from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def _tokenize(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        h = line.find("#")
        if h >= 0:
            line = line[:h]
        out.extend(_TOKEN.findall(line))
    return out


def _is_number(t: str) -> bool:
    try:
        float(t)
        return True
    except ValueError:
        return False


class _Tokens:
    def __init__(self, toks: List[str]):
        self.t = toks
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.t[self.i] if self.i < len(self.t) else None

    def next(self) -> str:
        tok = self.t[self.i]
        self.i += 1
        return tok

    def params(self) -> Dict[str, object]:
        """Parse `"type name" [v...]` parameter lists until the next
        directive (a bare capitalized word)."""
        out: Dict[str, object] = {}
        while True:
            tok = self.peek()
            if tok is None or not tok.startswith('"'):
                return out
            decl = self.next().strip('"').split()
            name = decl[-1]
            vals: List[object] = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    v = self.next()
                    vals.append(float(v) if _is_number(v)
                                else v.strip('"'))
                self.next()
            else:
                v = self.next()
                vals.append(float(v) if _is_number(v) else v.strip('"'))
            out[name] = vals


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    return np.diag([x, y, z, 1.0]).astype(np.float64)


def _rotate(angle_deg, x, y, z):
    a = math.radians(angle_deg)
    ax = np.asarray([x, y, z], np.float64)
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    c, s = math.cos(a), math.sin(a)
    K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]],
                  [-ax[1], ax[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) * c + (1 - c) * np.outer(ax, ax) + s * K
    return m


def _rgb(vals, default=(0.5, 0.5, 0.5)) -> Tuple[float, float, float]:
    if vals is None:
        return default
    v = [float(x) for x in vals]
    if len(v) == 1:
        return (v[0], v[0], v[0])
    return (v[0], v[1], v[2])


def _mat_from_pbrt(mtype: str, p: Dict) -> HostMaterial:
    g = p.get
    rough = float(g("roughness", [0.3])[0]) if "roughness" in p else None
    kd = _rgb(g("Kd") or g("reflectance"), (0.5, 0.5, 0.5))
    if mtype in ("matte", "diffuse", ""):
        return HostMaterial(base_color=kd, roughness=1.0)
    if mtype in ("plastic", "coateddiffuse", "substrate"):
        return HostMaterial(base_color=kd,
                            roughness=rough if rough is not None else 0.3,
                            metallic=0.0)
    if mtype in ("glass", "dielectric", "thindielectric"):
        ior = float((g("eta") or g("index") or [1.5])[0])
        return HostMaterial(base_color=_rgb(g("Kt"), (1, 1, 1)),
                            spec_trans=1.0, ior=ior,
                            roughness=rough if rough is not None else 0.02,
                            thin=1.0 if mtype == "thindielectric" else 0.0)
    if mtype in ("metal", "conductor"):
        return HostMaterial(base_color=_rgb(g("reflectance") or g("Kr"),
                                            (0.9, 0.75, 0.4)),
                            metallic=1.0,
                            roughness=rough if rough is not None else 0.05)
    if mtype == "mirror":
        return HostMaterial(base_color=_rgb(g("Kr"), (0.95, 0.95, 0.95)),
                            metallic=1.0, roughness=0.02)
    if mtype in ("uber", "disney"):
        return HostMaterial(
            base_color=kd if "Kd" in p or "reflectance" in p
            else _rgb(g("color"), (0.5, 0.5, 0.5)),
            roughness=rough if rough is not None else 0.4,
            metallic=float(g("metallic", [0.0])[0]),
            spec_trans=float(g("specTrans", [0.0])[0]),
            ior=float((g("eta") or g("index") or [1.5])[0]),
            alpha=float(g("opacity", [1.0])[0]))
    return HostMaterial(base_color=kd)


@dataclass
class _GState:
    ctm: np.ndarray = field(default_factory=lambda: np.eye(4))
    mat: HostMaterial = field(default_factory=HostMaterial)
    area_light: Optional[Tuple[float, float, float]] = None
    reverse: bool = False


def load_pbrt(path: str, strict: bool = False, device="cuda"):
    """Parse a .pbrt file. Returns (meshes, mats, cam, env, lights,
    skipped) — `skipped` lists unsupported directives encountered
    (raises instead when strict=True). The camera, env and lights are on
    `device` (the card unless the caller asks for the CPU)."""
    with open(path, "r", errors="replace") as f:
        toks = _Tokens(_tokenize(f.read()))

    base = os.path.dirname(os.path.abspath(path))
    meshes: List[HostMesh] = []
    mats: List[HostMaterial] = []
    named: Dict[str, HostMaterial] = {}
    skipped: List[str] = []
    env: Optional[EnvMap] = None
    an_pos, an_dir, an_rad, an_type = [], [], [], []

    eye = np.array([0.0, 0.0, 0.0])
    target = np.array([0.0, 0.0, 1.0])
    up = np.array([0.0, 1.0, 0.0])
    fov = 45.0

    gs = _GState()
    stack: List[_GState] = []

    def add_mat(m: HostMaterial) -> int:
        mats.append(m)
        return len(mats) - 1

    def emit_mesh(pos, idx, uvs=None, normals=None):
        m = gs.mat
        if gs.area_light is not None:
            m = replace(m, base_color=(0, 0, 0), emission=gs.area_light)
        mid = add_mat(m)
        p4 = np.concatenate([pos, np.ones((pos.shape[0], 1))], 1)
        pw = (gs.ctm @ p4.T).T[:, :3].astype(np.float32)
        ind = np.asarray(idx, np.int32).reshape(-1, 3)
        # a CTM with negative determinant flips winding — restore it
        if np.linalg.det(gs.ctm[:3, :3]) < 0:
            ind = ind[:, ::-1].copy()
        meshes.append(HostMesh(pw, ind,
                               np.full(ind.shape[0], mid, np.int32),
                               uvs=uvs, normals=None if normals is None
                               else _normal_xform(gs.ctm, normals)))

    def _normal_xform(M, n):
        inv_t = np.linalg.inv(M[:3, :3]).T
        out = (inv_t @ np.asarray(n, np.float32).T).T
        nl = np.linalg.norm(out, axis=1, keepdims=True)
        return (out / np.maximum(nl, 1e-12)).astype(np.float32)

    while toks.peek() is not None:
        d = toks.next()
        if d == "LookAt":
            v = [float(toks.next()) for _ in range(9)]
            eye, target, up = (np.asarray(v[0:3]), np.asarray(v[3:6]),
                               np.asarray(v[6:9]))
        elif d == "Camera":
            ctype = toks.next().strip('"')
            p = toks.params()
            if "fov" in p:
                fov = float(p["fov"][0])
            if ctype != "perspective":
                skipped.append(f"Camera {ctype}")
        elif d in ("WorldBegin", "WorldEnd", "Identity"):
            if d == "Identity":
                gs.ctm = np.eye(4)
            elif d == "WorldBegin":
                gs = _GState()
                stack.clear()
        elif d in ("AttributeBegin", "TransformBegin", "ObjectBegin"):
            stack.append(_GState(gs.ctm.copy(), gs.mat, gs.area_light,
                                 gs.reverse))
            if d == "ObjectBegin":
                toks.next()     # object name (instancing unsupported)
                skipped.append("ObjectBegin")
        elif d in ("AttributeEnd", "TransformEnd", "ObjectEnd"):
            if stack:
                gs = stack.pop()
        elif d == "Translate":
            gs.ctm = gs.ctm @ _translate(*[float(toks.next())
                                           for _ in range(3)])
        elif d == "Scale":
            gs.ctm = gs.ctm @ _scale(*[float(toks.next())
                                       for _ in range(3)])
        elif d == "Rotate":
            gs.ctm = gs.ctm @ _rotate(*[float(toks.next())
                                        for _ in range(4)])
        elif d in ("Transform", "ConcatTransform"):
            if toks.peek() == "[":
                toks.next()
                v = []
                while toks.peek() != "]":
                    v.append(float(toks.next()))
                toks.next()
            else:
                v = [float(toks.next()) for _ in range(16)]
            M = np.asarray(v, np.float64).reshape(4, 4).T  # column-major
            gs.ctm = M if d == "Transform" else gs.ctm @ M
        elif d == "ReverseOrientation":
            gs.reverse = not gs.reverse
        elif d == "Material":
            mtype = toks.next().strip('"')
            gs.mat = _mat_from_pbrt(mtype, toks.params())
        elif d == "MakeNamedMaterial":
            name = toks.next().strip('"')
            p = toks.params()
            mtype = (p.get("type") or ["matte"])[0]
            named[name] = _mat_from_pbrt(str(mtype), p)
        elif d == "NamedMaterial":
            gs.mat = named.get(toks.next().strip('"'), gs.mat)
        elif d == "AreaLightSource":
            toks.next()                      # "diffuse"
            p = toks.params()
            L = np.asarray(_rgb(p.get("L"), (1, 1, 1)))
            L = L * float(p.get("scale", [1.0])[0])
            gs.area_light = tuple(L)
        elif d == "LightSource":
            ltype = toks.next().strip('"')
            p = toks.params()
            if ltype in ("infinite", "constant"):
                L = _rgb(p.get("L"), (1, 1, 1))
                sc = float(p.get("scale", [1.0])[0])
                env = EnvMap.constant(tuple(np.asarray(L) * sc), device)
                if "filename" in p or "mapname" in p:
                    skipped.append("infinite filename (no image IO here)")
            elif ltype == "point":
                I = np.asarray(_rgb(p.get("I"), (1, 1, 1)))
                frm = (gs.ctm @ np.asarray(
                    list(_rgb(p.get("from"), (0, 0, 0))) + [1.0]))[:3]
                an_pos.append(frm)
                an_dir.append((0.0, -1.0, 0.0))
                an_rad.append(I)
                an_type.append(0)
            elif ltype == "distant":
                L = np.asarray(_rgb(p.get("L"), (1, 1, 1)))
                frm = np.asarray(_rgb(p.get("from"), (0, 0, 0)))
                to = np.asarray(_rgb(p.get("to"), (0, 0, 1)))
                dirv = to - frm
                dirv = dirv / max(np.linalg.norm(dirv), 1e-12)
                an_pos.append((0.0, 0.0, 0.0))
                an_dir.append(tuple(dirv))
                an_rad.append(L)
                an_type.append(1)
            else:
                skipped.append(f"LightSource {ltype}")
        elif d == "Shape":
            stype = toks.next().strip('"')
            p = toks.params()
            if stype == "trianglemesh":
                P = np.asarray(p["P"], np.float32).reshape(-1, 3)
                idx = np.asarray(p["indices"], np.int64)
                uv = (np.asarray(p.get("uv") or p.get("st"),
                                 np.float32).reshape(-1, 2)
                      if ("uv" in p or "st" in p) else None)
                N = (np.asarray(p["N"], np.float32).reshape(-1, 3)
                     if "N" in p else None)
                emit_mesh(P, idx, uvs=uv, normals=N)
            elif stype == "sphere":
                r = float(p.get("radius", [1.0])[0])
                v, f_ = _sphere_mesh()
                emit_mesh(v * r, f_)
            elif stype == "plymesh":
                fn = str(p.get("filename", [""])[0])
                fpath = os.path.join(base, fn)
                if os.path.exists(fpath):
                    from truetrace_tpu_torch.scene.ply_loader import load_ply
                    P_, idx, N, uv = load_ply(fpath)
                    emit_mesh(P_, idx, uvs=uv, normals=N)
                else:
                    skipped.append(f"plymesh {fn} (missing)")
            else:
                skipped.append(f"Shape {stype}")
        elif d == "Include":
            inc = toks.next().strip('"')
            ipath = os.path.join(base, inc)
            if os.path.exists(ipath):
                with open(ipath, "r", errors="replace") as f:
                    toks.t[toks.i:toks.i] = _tokenize(f.read())
            else:
                skipped.append(f"Include {inc}")
        elif d in ("Integrator", "Sampler", "Film", "PixelFilter",
                   "Accelerator", "ColorSpace", "Option"):
            toks.next()
            toks.params()
        elif d in ("Texture",):
            toks.next()
            toks.next()
            toks.next()
            toks.params()
            skipped.append("Texture")
        elif d in ("MakeNamedMedium", "MediumInterface"):
            if d == "MakeNamedMedium":
                toks.next()
                toks.params()
            else:
                toks.next()
                if toks.peek() and toks.peek().startswith('"'):
                    toks.next()
            skipped.append(d)
        else:
            # unknown directive: skip its parameter list defensively
            skipped.append(d)
            toks.params()

    if strict and skipped:
        raise ValueError(f"unsupported PBRT directives: {skipped}")

    cam = Camera.look_at(eye=tuple(eye), target=tuple(target),
                         up=tuple(up), fov_y_deg=fov, device=device)
    lights = None
    if an_pos:
        K = len(an_pos)
        lights = AnalyticLights.from_numpy(dict(
            position=np.asarray(an_pos, np.float32),
            direction=np.asarray(an_dir, np.float32),
            radiance=np.asarray(an_rad, np.float32),
            ltype=np.asarray(an_type, np.int32),
            spot_cos=np.tile(np.asarray([[0.9, 0.7]], np.float32), (K, 1)),
            extent=np.tile(np.asarray([[0.1, 0.1]], np.float32), (K, 1)),
            softness=np.zeros((K,), np.float32),
            z_rot=np.zeros((K,), np.float32)), device)
    return meshes, mats, cam, env, lights, skipped


def _sphere_mesh(n_theta: int = 12, n_phi: int = 18):
    th = np.linspace(0, np.pi, n_theta)
    ph = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    T, P = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P),
                  np.cos(T)], -1).reshape(-1, 3).astype(np.float32)
    f = []
    for i in range(n_theta - 1):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c = a + n_phi
            d = b + n_phi
            f.append([a, c, b])
            f.append([b, c, d])
    return v, np.asarray(f, np.int32)
