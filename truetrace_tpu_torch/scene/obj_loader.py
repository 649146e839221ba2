"""Wavefront OBJ/MTL loader -> HostMesh + HostMaterial list, plus the
textures the MTL names, packed into one atlas.

Port of `truetrace_tpu/scene/obj_loader.py` (the reference ingests
geometry through Unity, ParentObject.LoadData,
Objects/ParentObject.cs:452-635). `_parse_mtl` and `load_obj` are the JAX
package's numpy code; `load_obj_scene` decodes textures with the port's
own PNG codec (scene/png.py) in place of Pillow, with the same result as
Pillow's convert("RGBA"), and halves a texture wider than `max_tex` with
the port's copy of Pillow's bicubic resize (scene/resize.py). Texture
files other than PNG raise (ROADMAP.md A.27).
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh


def _parse_mtl(path: str, tex_paths: Optional[Dict[str, dict]] = None
               ) -> Dict[str, HostMaterial]:
    """Parse an MTL file. When `tex_paths` is given, texture map statements
    (map_Kd/map_Ke/map_bump|norm/map_Pr) are recorded there as
    {mat_name: {field: abspath}} for load_obj_scene to atlas."""
    mats: Dict[str, HostMaterial] = {}
    if not os.path.exists(path):
        return mats
    base = os.path.dirname(os.path.abspath(path))
    cur: Optional[dict] = None
    name = None
    _TEXKEYS = {"map_kd": "tex_albedo", "map_ke": "tex_emission",
                "map_bump": "tex_normal", "bump": "tex_normal",
                "norm": "tex_normal", "map_pr": "tex_rough_metal",
                "map_d": "tex_alpha", "map_pm": "tex_metallic"}
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.strip().split()
            if not t:
                continue
            if t[0] == "newmtl":
                if name is not None:
                    mats[name] = HostMaterial(**cur)
                name = t[1] if len(t) > 1 else f"mat{len(mats)}"
                cur = {}
            elif cur is None:
                continue
            elif t[0].lower() in _TEXKEYS and len(t) >= 2:
                if tex_paths is not None:
                    # last token is the filename (skip -options)
                    tex_paths.setdefault(name, {})[_TEXKEYS[t[0].lower()]] \
                        = os.path.join(base, t[-1])
                # map statement -o/-s options -> per-material UV
                # offset/scale (applied to every map of the material —
                # MTL has no per-map transform split; reference analogue
                # AlbedoTextureScale, CommonVars.cs:123)
                uvt = list(cur.get("uv_scale", (1.0, 1.0, 0.0, 0.0)))
                # MTL -s/-o take 1-3 numeric args (u [v [w]]): consume a
                # variable-length float run, default v=u, ignore w; the
                # last token (filename) is never consumed (ADVICE r4:
                # fixed 2-arg parsing crashed on "map_Kd -s 2 brick.png")
                oi = 1
                while oi < len(t) - 1:
                    tok = t[oi]
                    if tok in ("-s", "-o"):
                        vals = []
                        j = oi + 1
                        while j < len(t) - 1 and len(vals) < 3:
                            try:
                                vals.append(float(t[j]))
                            except ValueError:
                                break
                            j += 1
                        if vals:
                            u = vals[0]
                            v = vals[1] if len(vals) > 1 else u
                            if tok == "-s":
                                uvt[0], uvt[1] = u, v
                            else:
                                uvt[2], uvt[3] = u, v
                        oi = j
                    else:
                        oi += 1
                if uvt != [1.0, 1.0, 0.0, 0.0]:
                    cur["uv_scale"] = tuple(uvt)
                    cur["uv2_scale"] = (uvt[0], uvt[1])
            elif t[0] == "Kd" and len(t) >= 4:
                cur["base_color"] = tuple(float(x) for x in t[1:4])
            elif t[0] == "Ke" and len(t) >= 4:
                ke = tuple(float(x) for x in t[1:4])
                if max(ke) > 0:
                    cur["emission"] = ke
            elif t[0] == "Ns" and len(t) >= 2:
                # Phong exponent -> roughness (Blinn-Phong to GGX heuristic)
                ns = float(t[1])
                cur["roughness"] = float(np.clip(
                    np.sqrt(2.0 / (ns + 2.0)) ** 0.5, 0.03, 1.0))
            elif t[0] == "Ni" and len(t) >= 2:
                cur["ior"] = float(t[1])
            elif t[0] == "d" and len(t) >= 2:
                cur["alpha"] = float(t[1])
            elif t[0] == "Tf" and len(t) >= 4:
                # transmission filter color -> authored glass interior
                # transmittance (reference TransmittanceColor,
                # CommonVars.cs:109); ignore the no-op white filter
                tf = tuple(float(x) for x in t[1:4])
                if min(tf) < 1.0:
                    cur["transmit_color"] = tf
            elif t[0] == "Pm" and len(t) >= 2:   # PBR extension
                cur["metallic"] = float(t[1])
            elif t[0] == "Pr" and len(t) >= 2:
                cur["roughness"] = float(t[1])
    if name is not None:
        mats[name] = HostMaterial(**cur)
    return mats


def load_obj(path: str, scale: float = 1.0, _tex_paths=None,
             _return_names: bool = False
             ) -> Tuple[List[HostMesh], List[HostMaterial]]:
    """Load an OBJ (+ its MTL) into a single HostMesh with per-face
    material ids. Supports v/vn/vt, usemtl groups, tri + quad + n-gon faces
    (fan triangulated), and negative indices."""
    with open(path, "r", errors="replace") as f:
        lines = f.read().splitlines()

    v_rows, vn_rows, vt_rows = [], [], []
    face_rows: List[Tuple[str, int]] = []   # (face line, mat id)
    mtl_files: List[str] = []
    mat_names: List[str] = []
    cur_mat = 0

    for line in lines:
        if line.startswith("v "):
            v_rows.append(line[2:])
        elif line.startswith("vn "):
            vn_rows.append(line[3:])
        elif line.startswith("vt "):
            vt_rows.append(line[3:])
        elif line.startswith("f "):
            face_rows.append((line[2:], cur_mat))
        elif line.startswith("usemtl"):
            nm = line.split(None, 1)[1].strip() if " " in line else ""
            if nm not in mat_names:
                mat_names.append(nm)
            cur_mat = mat_names.index(nm)
        elif line.startswith("mtllib"):
            mtl_files.append(line.split(None, 1)[1].strip())

    pos = np.array([r.split()[:3] for r in v_rows], np.float32) * scale
    nrm = (np.array([r.split()[:3] for r in vn_rows], np.float32)
           if vn_rows else None)
    uv = (np.array([r.split()[:2] for r in vt_rows], np.float32)
          if vt_rows else None)

    # triangulate faces; build corner index triples (v, vt, vn)
    tri_v, tri_vt, tri_vn, tri_m = [], [], [], []
    for face, m in face_rows:
        corners = face.split()
        idx = []
        for c in corners:
            parts = c.split("/")
            vi = int(parts[0])
            ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
            ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
            idx.append((vi, ti, ni))
        for k in range(1, len(idx) - 1):      # fan
            for (vi, ti, ni) in (idx[0], idx[k], idx[k + 1]):
                tri_v.append(vi)
                tri_vt.append(ti)
                tri_vn.append(ni)
            tri_m.append(m)

    def fix(ids, n):
        a = np.asarray(ids, np.int64)
        return np.where(a > 0, a - 1, np.where(a < 0, n + a, 0))

    vi = fix(tri_v, len(v_rows)).reshape(-1, 3)
    F = vi.shape[0]

    # build a unified vertex stream per corner (positions mandatory)
    positions = pos
    indices = vi.astype(np.int32)
    normals = None
    uvs = None
    if nrm is not None and any(tri_vn):
        # per-corner normals -> expand to unique corner vertices
        ni = fix(tri_vn, len(vn_rows)).reshape(-1, 3)
        ti = (fix(tri_vt, len(vt_rows)).reshape(-1, 3)
              if uv is not None and any(tri_vt) else np.zeros_like(vi))
        key = vi * (len(vn_rows) + 1) * (len(vt_rows) + 1) \
            + ni * (len(vt_rows) + 1) + ti
        uniq, inv = np.unique(key.reshape(-1), return_inverse=True)
        first = np.zeros(uniq.shape[0], np.int64)
        first[inv[::-1]] = np.arange(3 * F - 1, -1, -1)
        positions = pos[vi.reshape(-1)[first]]
        normals = nrm[ni.reshape(-1)[first]]
        if uv is not None and any(tri_vt):
            uvs = uv[ti.reshape(-1)[first]]
        indices = inv.reshape(-1, 3).astype(np.int32)

    # materials
    base = os.path.dirname(os.path.abspath(path))
    mtl: Dict[str, HostMaterial] = {}
    for mf in mtl_files:
        mtl.update(_parse_mtl(os.path.join(base, mf),
                              tex_paths=_tex_paths))
    mats = [mtl.get(nm, HostMaterial()) for nm in mat_names] \
        or [HostMaterial()]
    mat_id = np.asarray(tri_m, np.int32) if tri_m else \
        np.zeros(F, np.int32)

    mesh = HostMesh(positions=positions.astype(np.float32),
                    indices=indices, mat_id=mat_id,
                    normals=None if normals is None
                    else normals.astype(np.float32),
                    uvs=None if uvs is None else uvs.astype(np.float32))
    if _return_names:
        return [mesh], mats, (mat_names or [""])
    return [mesh], mats


def load_obj_scene(path: str, scale: float = 1.0, max_tex: int = 1024,
                   auto_pair: bool = False, rules=None):
    """load_obj + texture ingestion: decodes every map_Kd/map_Ke/map_bump/
    map_Pr/map_d/map_Pm the MTL names, packs them into one atlas
    (scene/atlas.py shelf packer + mips) and assigns the tex_* ids on the
    materials (the reference's CreateAtlas, AssetManager.cs:396-533).

    Returns (meshes, mats, atlas, rects, level_y); the atlas triple is
    (None, None, None) when no texture resolves. A texture file that is
    missing is skipped, as in the JAX package; one that is present but
    cannot be read raises."""
    from truetrace_tpu_torch.scene.atlas import AtlasBuilder
    from truetrace_tpu_torch.scene.png import read_texture
    from truetrace_tpu_torch.scene.resize import halve_to_fit

    tex_paths: Dict[str, dict] = {}
    meshes, mats, names = load_obj(path, scale, _tex_paths=tex_paths,
                                   _return_names=True)
    if auto_pair:
        # naming-convention pairing for foreign assets with no manifest
        # (reference MaterialMappings.xml; scene/material_rules.py)
        from truetrace_tpu_torch.scene.material_rules import (
            auto_pair as _ap)
        mats = _ap(names, mats, rules)
    builder = AtlasBuilder()
    cache: Dict[str, Optional[int]] = {}
    out_mats: List[HostMaterial] = []
    for nm, m in zip(names, mats):
        fields = {}
        for field, tp in tex_paths.get(nm, {}).items():
            if tp not in cache:
                tid = None
                if os.path.exists(tp):
                    tid = builder.add(halve_to_fit(read_texture(tp),
                                                   max_tex))
                cache[tp] = tid
            if cache[tp] is not None:
                fields[field] = cache[tp]
        out_mats.append(replace(m, **fields) if fields else m)
    if builder.images:
        atlas, rects, level_y = builder.build()
    else:
        atlas = rects = level_y = None
    return meshes, out_mats, atlas, rects, level_y
