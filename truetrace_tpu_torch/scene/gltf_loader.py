"""Minimal glTF 2.0 loader (.gltf / .glb) -> HostMesh + HostMaterial.

Scene-ingestion counterpart of the reference's Unity asset extraction
(ParentObject.LoadData, ParentObject.cs:452-635 pulls meshes, transforms
and materials out of Unity objects; our OBJ loader covers the classic
format, this covers the modern interchange one). Dependency-free: JSON +
struct + base64 only.

Supported: binary GLB container and JSON glTF with external/embedded
(data:) buffers; node hierarchy with TRS/matrix transforms (flattened to
world space); POSITION / NORMAL / TEXCOORD_0 attributes; u8/u16/u32
indices and non-indexed primitives; pbrMetallicRoughness baseColorFactor,
metallicFactor, roughnessFactor, emissiveFactor (+KHR_materials_emissive_
strength), KHR_materials_transmission, KHR_materials_ior; baseColor /
normal / metallicRoughness / emissive textures routed into the atlas
builder when one is supplied.

Port of `truetrace_tpu/scene/gltf_loader.py`, with the same meshes and
materials (tests/test_torch_sources.py). Textures are decoded by the
port's own PNG codec (scene/png.py) where the JAX package uses Pillow:
another image format raises NotImplementedError (ROADMAP.md A.27), and a
PNG that cannot be decoded raises ValueError where the JAX loader drops
the texture. A strided accessor is read in one numpy gather.
"""
from __future__ import annotations

import base64
import json
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh

_COMP_DTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_TYPE_N = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
           "MAT4": 16}


def _load_container(path: str) -> Tuple[dict, List[bytes]]:
    """Returns (gltf json, buffer list)."""
    with open(path, "rb") as f:
        head = f.read(4)
        f.seek(0)
        data = f.read()
    if head == b"glTF":                       # GLB
        _, _, _ = struct.unpack_from("<III", data, 0)
        off = 12
        doc = None
        bin_chunk = b""
        while off < len(data):
            clen, ctype = struct.unpack_from("<II", data, off)
            chunk = data[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:           # JSON
                doc = json.loads(chunk.decode("utf-8"))
            elif ctype == 0x004E4942:         # BIN
                bin_chunk = chunk
            off += 8 + clen + (-clen) % 4
        buffers = []
        for b in doc.get("buffers", []):
            if "uri" not in b:
                buffers.append(bin_chunk)
            else:
                buffers.append(_load_uri(b["uri"], os.path.dirname(path)))
        return doc, buffers
    doc = json.loads(data.decode("utf-8"))
    buffers = [_load_uri(b["uri"], os.path.dirname(path))
               for b in doc.get("buffers", [])]
    return doc, buffers


def _load_uri(uri: str, base_dir: str) -> bytes:
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(base_dir, uri), "rb") as f:
        return f.read()


def _accessor(doc, buffers, idx) -> np.ndarray:
    acc = doc["accessors"][idx]
    n_comp = _TYPE_N[acc["type"]]
    dtype = _COMP_DTYPE[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        return np.zeros((count, n_comp), dtype)
    bv = doc["bufferViews"][acc["bufferView"]]
    buf = buffers[bv["buffer"]]
    start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride", 0)
    itemsize = np.dtype(dtype).itemsize * n_comp
    if stride and stride != itemsize:
        if count == 0:
            return np.zeros((0, n_comp), dtype)
        raw = np.frombuffer(buf, np.uint8, stride * (count - 1) + itemsize,
                            start)
        rows = np.lib.stride_tricks.as_strided(
            raw, (count, itemsize), (stride, 1))
        return np.ascontiguousarray(rows).view(dtype).reshape(count, n_comp)
    arr = np.frombuffer(buf, dtype, count * n_comp, start)
    return arr.reshape(count, n_comp).copy()


def _node_matrix(node: dict) -> np.ndarray:
    """Column-vector 4x4 local transform."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], np.float64)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
             2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
             2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w),
             1 - 2 * (x * x + y * y)]])
        m = np.block([[r @ m[:3, :3], np.zeros((3, 1))],
                      [np.zeros((1, 3)), np.ones((1, 1))]])
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _texture_image(doc, buffers, tex_idx, base_dir) -> Optional[np.ndarray]:
    """The texture's image as uint8 RGBA, or None where the JAX loader
    finds none (no source, a missing file)."""
    from truetrace_tpu_torch.scene.png import decode_png, is_png, to_rgba
    src = doc["textures"][tex_idx].get("source")
    if src is None:
        return None
    img = doc["images"][src]
    mime = img.get("mimeType")
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            mime = uri[5:].split(";", 1)[0].split(",", 1)[0] or mime
        elif not os.path.exists(os.path.join(base_dir, uri)):
            return None
        name = uri if not uri.startswith("data:") else f"image {src}"
        raw = _load_uri(uri, base_dir)
    else:
        bv = doc["bufferViews"][img["bufferView"]]
        buf = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0)
        raw = buf[start:start + bv["byteLength"]]
        name = f"image {src}"
    png = mime == "image/png" if mime else (
        is_png(raw) or name.lower().endswith(".png"))
    if not png:
        raise NotImplementedError(
            f"glTF {name} ({mime or 'no mimeType'}): only PNG textures "
            f"are read (ROADMAP.md A.27)")
    return to_rgba(decode_png(bytes(raw), name))


def load_gltf(path: str, atlas_builder=None, auto_pair: bool = False,
              rules=None) -> Tuple[List[HostMesh], List[HostMaterial]]:
    """Load a glTF/GLB file. Returns (meshes, materials) for
    compile_scene. Pass an AtlasBuilder to also import textures.
    auto_pair: fill Disney fields glTF cannot express from material-name
    rules (scene/material_rules.py; reference MaterialMappings.xml) —
    explicit glTF PBR data always wins."""
    doc, buffers = _load_container(path)
    base_dir = os.path.dirname(path)

    # materials
    mats: List[HostMaterial] = []
    tex_cache = {}

    def tex_id(t):
        if atlas_builder is None or t is None:
            return -1
        i = t.get("index")
        if i is None:
            return -1
        if i not in tex_cache:
            img = _texture_image(doc, buffers, i, base_dir)
            tex_cache[i] = atlas_builder.add(img) if img is not None else -1
        return tex_cache[i]

    for m in doc.get("materials", [{}]):
        pbr = m.get("pbrMetallicRoughness", {})
        bc = pbr.get("baseColorFactor", [1, 1, 1, 1])
        emis = m.get("emissiveFactor", [0, 0, 0])
        strength = m.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get(
            "emissiveStrength", 1.0)
        trans = m.get("extensions", {}).get(
            "KHR_materials_transmission", {}).get("transmissionFactor", 0.0)
        ior = m.get("extensions", {}).get(
            "KHR_materials_ior", {}).get("ior", 1.5)
        # KHR_materials_volume -> authored glass interior (reference
        # TransmittanceColor + scatterDistance, CommonVars.cs:109,129)
        vol = m.get("extensions", {}).get("KHR_materials_volume", {})
        att_col = vol.get("attenuationColor")
        # spec default for attenuationDistance is +inf (no attenuation),
        # NOT 0 (the integrator maps scatter_dist<=0 to distance 1) — an
        # authored attenuationColor without a distance means no Beer-
        # Lambert absorption, so drop the color entirely (ADVICE r4)
        att_dist = vol.get("attenuationDistance")
        if att_dist is None or not np.isfinite(att_dist):
            att_col, att_dist = None, 0.0
        # KHR_texture_transform on the baseColor texture -> per-material
        # UV transform (reference AlbedoTextureScale/Rotation,
        # CommonVars.cs:123-136); secondary scale from the
        # metallicRoughness texture's transform
        def _tt(tinfo):
            return (tinfo or {}).get("extensions", {}).get(
                "KHR_texture_transform", {})
        tt = _tt(pbr.get("baseColorTexture"))
        sc = tt.get("scale", [1.0, 1.0])
        off = tt.get("offset", [0.0, 0.0])
        rot = float(tt.get("rotation", 0.0))
        tt2 = _tt(pbr.get("metallicRoughnessTexture"))
        sc2 = tt2.get("scale", sc)
        mats.append(HostMaterial(
            base_color=tuple(bc[:3]),
            emission=tuple(np.asarray(emis) * strength),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            spec_trans=float(trans), ior=float(ior),
            alpha=float(bc[3]) if len(bc) > 3 else 1.0,
            transmit_color=(tuple(att_col[:3]) if att_col is not None
                            else (-1.0, -1.0, -1.0)),
            scatter_dist=float(att_dist),
            uv_scale=(float(sc[0]), float(sc[1]),
                      float(off[0]), float(off[1])),
            uv2_scale=(float(sc2[0]), float(sc2[1])),
            # glTF rotates CW about the uv origin; our transform rotates
            # about (0.5, 0.5) — exact for 90-degree multiples of tiled
            # textures, approximate otherwise
            uv_rot=-rot,
            normal_strength=float(
                (m.get("normalTexture") or {}).get("scale", 1.0)),
            tex_albedo=tex_id(pbr.get("baseColorTexture")),
            tex_normal=tex_id(m.get("normalTexture")),
            tex_rough_metal=tex_id(pbr.get("metallicRoughnessTexture")),
            tex_emission=tex_id(m.get("emissiveTexture")),
        ))
    if not doc.get("materials"):
        mats = [HostMaterial()]
    elif auto_pair:
        from truetrace_tpu_torch.scene.material_rules import (
            auto_pair as _ap)
        mats = _ap([m.get("name", "") for m in doc["materials"]], mats,
                   rules)

    # flatten the node hierarchy of the default scene
    meshes: List[HostMesh] = []
    scene = doc.get("scenes", [{}])[doc.get("scene", 0)]

    def visit(node_idx, parent_m):
        node = doc["nodes"][node_idx]
        m = parent_m @ _node_matrix(node)
        if "mesh" in node:
            gmesh = doc["meshes"][node["mesh"]]
            for prim in gmesh.get("primitives", []):
                if prim.get("mode", 4) != 4:          # triangles only
                    continue
                attrs = prim["attributes"]
                pos = _accessor(doc, buffers, attrs["POSITION"]
                                ).astype(np.float64)
                pos_w = (pos @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
                nrm = None
                if "NORMAL" in attrs:
                    n0 = _accessor(doc, buffers, attrs["NORMAL"]
                                   ).astype(np.float64)
                    nm = np.linalg.inv(m[:3, :3]).T
                    nrm = n0 @ nm.T
                    nrm /= np.maximum(np.linalg.norm(
                        nrm, axis=-1, keepdims=True), 1e-12)
                    nrm = nrm.astype(np.float32)
                uv = (_accessor(doc, buffers, attrs["TEXCOORD_0"]
                                ).astype(np.float32)
                      if "TEXCOORD_0" in attrs else None)
                if "indices" in prim:
                    idx = _accessor(doc, buffers, prim["indices"]
                                    ).reshape(-1).astype(np.int64)
                else:
                    idx = np.arange(pos.shape[0], dtype=np.int64)
                faces = idx.reshape(-1, 3)
                mat = prim.get("material", 0)
                meshes.append(HostMesh(
                    positions=pos_w, indices=faces.astype(np.int32),
                    mat_id=np.full(faces.shape[0], mat, np.int32),
                    normals=nrm, uvs=uv))
        for ch in node.get("children", []):
            visit(ch, m)

    for root in scene.get("nodes", []):
        visit(root, np.eye(4))
    return meshes, mats
