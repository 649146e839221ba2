"""Torch port, scene sources: the glTF / GLB, PLY, pbrt, Mitsuba and
manifest loaders, the material rules, material JSON and the texture
downscale, each against the JAX package's on the same files: meshes bit
for bit, materials field for field, cameras, envs and lights equal at
device="cpu", manifest scenes table for table. Fixtures are small files
written under tmp_path (sponza_like's export at detail 0.5 written in
every format by chip_smoke.py's writers among them). Textures: the port
reads PNG only (ROADMAP.md A.27) and raises on a PNG it cannot decode,
where the JAX loaders drop it; both are pinned here."""
import base64
import dataclasses
import contextlib
import json
import struct

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_gltf import _tri_gltf
from tests.test_mitsuba import XML as MITSUBA_XML
from tests.test_pbrt import PBRT, _write_ply_ascii
from truetrace_tpu.scene import gltf_loader as jgltf
from truetrace_tpu.scene import manifest as jmanifest
from truetrace_tpu.scene import material_rules as jrules
from truetrace_tpu.scene import materials_io as jio
from truetrace_tpu.scene import mitsuba_loader as jmitsuba
from truetrace_tpu.scene import obj_loader as jobj
from truetrace_tpu.scene import pbrt_loader as jpbrt
from truetrace_tpu.scene import ply_loader as jply
from truetrace_tpu.scene.atlas import AtlasBuilder as JAtlas
from truetrace_tpu.scene.mesh import HostMaterial as JMaterial
from truetrace_tpu_torch.scene import gltf_loader as tgltf
from truetrace_tpu_torch.scene import manifest as tmanifest
from truetrace_tpu_torch.scene import material_rules as trules
from truetrace_tpu_torch.scene import materials_io as tio
from truetrace_tpu_torch.scene import mitsuba_loader as tmitsuba
from truetrace_tpu_torch.scene import obj_loader as tobj
from truetrace_tpu_torch.scene import pbrt_loader as tpbrt
from truetrace_tpu_torch.scene import ply_loader as tply
from truetrace_tpu_torch.scene import sponza_like as tsponza
from truetrace_tpu_torch.scene.atlas import AtlasBuilder as TAtlas
from truetrace_tpu_torch.scene.mesh import HostMaterial as TMaterial
from truetrace_tpu_torch.scene.png import write_png
from truetrace_tpu_torch.scene.resize import resize_rgba

from torch_parity import leaves

A27 = "ROADMAP.md A.27"


def _bits(a):
    return np.ascontiguousarray(a).tobytes()


def same_meshes(jm, tm):
    """HostMesh lists: positions, indices, mat_id, normals, uvs equal in
    dtype, shape and bits."""
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        for f in ("positions", "indices", "mat_id", "normals", "uvs"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert (x.dtype, x.shape) == (y.dtype, y.shape), f
                assert _bits(x) == _bits(y), f


def same_mats(jl, tl):
    """HostMaterial lists field for field."""
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)


def same_leaves(jobj_, tobj_):
    """A JAX Camera / EnvMap / AnalyticLights against the port's on the
    CPU: every field equal (floats bit for bit)."""
    assert (jobj_ is None) == (tobj_ is None)
    if jobj_ is None:
        return
    jl = leaves(jobj_)
    for f in dataclasses.fields(tobj_):
        x, y = jl[f.name], getattr(tobj_, f.name)
        assert (x is None) == (y is None), f.name
        if x is None:
            continue
        y = y.numpy()
        # the port keeps a camera's 0-d scalars as [1] tensors
        assert x.shape == y.shape or x.size == y.size == 1, f.name
        if x.dtype.kind == "f":
            assert x.dtype == y.dtype and _bits(x) == _bits(y), f.name
        else:
            assert np.array_equal(x.astype(np.int64), y), f.name


def same_atlas(ja, ta):
    a, b = ja.build(), ta.build()
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


def _png_bytes(tmp_path, name, img):
    p = tmp_path / name
    write_png(str(p), img)
    return p.read_bytes()


# ---------------------------------------------------------------------------
# glTF / GLB
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("glb", [False, True], ids=["json", "glb"])
def test_gltf_matches_jax(tmp_path, glb):
    """tests/test_gltf.py's triangle (a child node's translate + scale,
    u16 indices, the emissive strength, transmission and ior extensions)
    as JSON with a data: buffer and as GLB."""
    p = _tri_gltf(tmp_path, glb=glb)
    jm, jmat = jgltf.load_gltf(p)
    tm, tmat = tgltf.load_gltf(p)
    same_meshes(jm, tm)
    same_mats(jmat, tmat)


def _rich_gltf(tmp_path, image_uri=None, bad_png=False):
    """Two meshes under a node hierarchy (a TRS root with a rotation, a
    child with a matrix, a grandchild with TRS): an interleaved
    POSITION / NORMAL / TEXCOORD_0 buffer view (byteStride 32) with u8
    indices, a tight non-indexed primitive, a u32-indexed one and a line
    primitive (skipped); three materials (textures embedded as a
    buffer-view PNG and as a data: URI, one shared; KHR_texture_transform,
    KHR_materials_volume, a normal scale; names the rules pair). Returns
    the GLB path."""
    r = np.random.default_rng(3)
    quad = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.float32([0, 0, 1]), (4, 1))
    uv = r.uniform(0, 1, (4, 2)).astype(np.float32)
    inter = np.concatenate([quad, nrm, uv], 1).astype(np.float32)
    tri = r.normal(size=(6, 3)).astype(np.float32)
    i8 = np.array([0, 1, 2, 0, 2, 3], np.uint8)
    i32 = np.array([0, 2, 1, 3, 5, 4], np.uint32)
    rgb = r.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    rgba = r.integers(0, 256, (4, 6, 4), dtype=np.uint8)
    png0 = _png_bytes(tmp_path, "a.png", rgb)
    if bad_png:
        png0 = png0[:8] + bytes(40)
    png1 = _png_bytes(tmp_path, "b.png", rgba)
    blob = bytearray()
    views = []

    def view(data, **kw):
        views.append(dict(buffer=0, byteOffset=len(blob),
                          byteLength=len(data), **kw))
        blob.extend(data + b"\0" * ((-len(data)) % 4))
        return len(views) - 1

    v_int = view(inter.tobytes(), byteStride=32)
    v_i8 = view(i8.tobytes())
    v_tri = view(tri.tobytes())
    v_i32 = view(i32.tobytes())
    v_png = view(png0)
    acc = [dict(bufferView=v_int, byteOffset=0, componentType=5126,
                count=4, type="VEC3"),
           dict(bufferView=v_int, byteOffset=12, componentType=5126,
                count=4, type="VEC3"),
           dict(bufferView=v_int, byteOffset=24, componentType=5126,
                count=4, type="VEC2"),
           dict(bufferView=v_i8, componentType=5121, count=6,
                type="SCALAR"),
           dict(bufferView=v_tri, componentType=5126, count=6, type="VEC3"),
           dict(bufferView=v_i32, componentType=5125, count=6,
                type="SCALAR")]
    img1 = image_uri or ("data:image/png;base64,"
                         + base64.b64encode(png1).decode())
    q = np.array([0.1, 0.7, -0.2, 0.6])
    q = (q / np.linalg.norm(q)).tolist()
    m = np.eye(4)
    m[:3, :3] = [[0, -1.5, 0], [1.5, 0, 0], [0, 0, 1.5]]
    m[:3, 3] = [0.25, -1.0, 3.0]
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [
            {"rotation": q, "scale": [1.0, 2.0, 0.5],
             "translation": [1.0, -2.0, 0.5], "children": [1, 2]},
            {"matrix": m.T.reshape(-1).tolist(), "mesh": 0},
            {"translation": [0.0, 0.0, -4.0], "mesh": 1,
             "children": [3]},
            {"scale": [3.0, 3.0, 3.0], "mesh": 0}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                            "TEXCOORD_0": 2},
                             "indices": 3, "material": 0}]},
            {"primitives": [{"attributes": {"POSITION": 4}, "material": 1},
                            {"attributes": {"POSITION": 4}, "indices": 5,
                             "material": 2},
                            {"attributes": {"POSITION": 4}, "mode": 1}]}],
        "materials": [
            {"name": "gold_trim", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.6, 0.2, 0.75],
                "baseColorTexture": {"index": 0, "extensions": {
                    "KHR_texture_transform": {"scale": [2, 3],
                                              "offset": [0.1, 0.2],
                                              "rotation": 0.5}}},
                "metallicRoughnessTexture": {"index": 1}},
             "normalTexture": {"index": 1, "scale": 0.5},
             "emissiveFactor": [0.5, 0.25, 0.0]},
            {"name": "window_glass", "extensions": {
                "KHR_materials_volume": {"attenuationColor": [1, 0.5, 0.2],
                                         "attenuationDistance": 0.25},
                "KHR_materials_transmission": {"transmissionFactor": 1.0}},
             "emissiveTexture": {"index": 0}},
            {"name": "plain"}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"bufferView": v_png, "mimeType": "image/png"},
                   {"uri": img1}],
        "accessors": acc, "bufferViews": views,
        "buffers": [{"byteLength": len(blob)}]}
    js = json.dumps(doc).encode()
    js += b" " * ((-len(js)) % 4)
    out = (b"glTF" + struct.pack("<II", 2, 28 + len(js) + len(blob))
           + struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))
    p = tmp_path / "rich.glb"
    p.write_bytes(out)
    return str(p)


@pytest.mark.parametrize("auto_pair", [False, True])
def test_gltf_hierarchy_stride_textures_match_jax(tmp_path, auto_pair):
    p = _rich_gltf(tmp_path)
    ja, ta = JAtlas(), TAtlas()
    jm, jmat = jgltf.load_gltf(p, atlas_builder=ja, auto_pair=auto_pair)
    tm, tmat = tgltf.load_gltf(p, atlas_builder=ta, auto_pair=auto_pair)
    same_meshes(jm, tm)
    same_mats(jmat, tmat)
    assert len(tm) == 4 and len(ta.images) == 2
    assert tmat[0].tex_albedo == 0 and tmat[0].tex_normal == 1
    same_atlas(ja, ta)
    if auto_pair:
        assert tmat[1].specular == 0.0 and tmat[2].specular == 0.5


def test_gltf_attenuation_matches_jax(tmp_path):
    """tests/test_loader_fixes.py:42's case: an attenuationColor without
    a distance is dropped; with one it is kept."""
    for i, vol in enumerate(({"attenuationColor": [1.0, 0.5, 0.2]},
                             {"attenuationColor": [1.0, 0.5, 0.2],
                              "attenuationDistance": 0.25}, {})):
        p = tmp_path / f"v{i}.gltf"
        p.write_text(json.dumps({
            "asset": {"version": "2.0"}, "buffers": [],
            "materials": [{"extensions": {"KHR_materials_volume": vol}}]}))
        same_mats(jgltf.load_gltf(str(p))[1], tgltf.load_gltf(str(p))[1])


def test_gltf_texture_divergences_are_pinned(tmp_path):
    """Where the JAX loader decodes with Pillow and drops what fails, the
    port reads PNG only: a JPEG image raises naming A.27, a PNG it cannot
    decode raises ValueError, and a missing file is skipped by both."""
    jpeg = "data:image/jpeg;base64," + base64.b64encode(
        b"\xff\xd8\xff\xe0" + bytes(16)).decode()
    p = _rich_gltf(tmp_path, image_uri=jpeg)
    assert jgltf.load_gltf(p, atlas_builder=JAtlas())[1][0].tex_normal == -1
    with pytest.raises(NotImplementedError, match=A27):
        tgltf.load_gltf(p, atlas_builder=TAtlas())
    p = _rich_gltf(tmp_path, bad_png=True)
    assert jgltf.load_gltf(p, atlas_builder=JAtlas())[1][0].tex_albedo == -1
    with pytest.raises(ValueError):
        tgltf.load_gltf(p, atlas_builder=TAtlas())
    p = _rich_gltf(tmp_path, image_uri="gone.png")
    ja, ta = JAtlas(), TAtlas()
    jm = jgltf.load_gltf(p, atlas_builder=ja)[1]
    tm = tgltf.load_gltf(p, atlas_builder=ta)[1]
    same_mats(jm, tm)
    assert tm[0].tex_normal == -1
    same_atlas(ja, ta)


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

def _binary_ply(path, endian, faces, extra=True):
    r = np.random.default_rng(1)
    V = 9
    cols = ["x", "y", "z"] + (["nx", "ny", "nz", "s", "t"] if extra else [])
    vdata = r.normal(size=(V, len(cols))).astype(np.float32)
    head = (f"ply\nformat binary_{endian}_endian 1.0\ncomment t\n"
            f"element vertex {V}\n"
            + "".join(f"property float {c}\n" for c in cols)
            + f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n")
    e = "<" if endian == "little" else ">"
    body = vdata.astype(e + "f4").tobytes()
    for f in faces:
        body += struct.pack(e + "B", len(f)) + np.asarray(
            f, e + "i4").tobytes()
    path.write_bytes(head.encode() + body)


@pytest.mark.parametrize("case", ["ascii", "little", "big", "little_fans",
                                  "big_mixed"])
def test_ply_matches_jax(tmp_path, case):
    """ASCII (tests/test_pbrt.py's quad) and binary in both endians:
    triangles, equal-sized fans (the port's one-call read) and mixed
    polygons (the per-record loop), normals and s/t coordinates."""
    p = tmp_path / "m.ply"
    if case == "ascii":
        _write_ply_ascii(p)
    else:
        endian = case.split("_")[0]
        faces = {"": [[0, 1, 2], [3, 4, 5], [6, 7, 8]],
                 "fans": [[0, 1, 2, 3], [4, 5, 6, 7], [8, 0, 4, 2]],
                 "mixed": [[0, 1, 2], [3, 4, 5, 6, 7], [8, 0, 1, 2]]}[
            case[len(endian) + 1:]]
        _binary_ply(p, endian, faces, extra=case != "big_mixed")
    a, b = jply.load_ply(str(p)), tply.load_ply(str(p))
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert (x.dtype, x.shape) == (y.dtype, y.shape)
            assert _bits(x) == _bits(y)


# ---------------------------------------------------------------------------
# pbrt
# ---------------------------------------------------------------------------

_INCLUDE = """
LookAt 0 0 3 0 0 0 0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point3 from" [0 5 0] "point3 to" [0 0 0]
LightSource "point" "rgb I" [2 1 2] "point3 from" [0 1.5 1]
Include "inc.pbrt"
Texture "t" "spectrum" "imagemap" "string filename" "x.png"
WorldEnd
"""
_PLYMESH = """
LookAt 1 2 3 0 0.5 0 0 1 0
Camera "perspective" "float fov" [38]
WorldBegin
AttributeBegin
  Translate 1 2 0
  Rotate 33 0.2 1 0.3
  Scale -1 1 2
  Material "conductor" "float roughness" [0.2]
  Shape "plymesh" "string filename" "mesh.ply"
AttributeEnd
Shape "plymesh" "string filename" "gone.ply"
WorldEnd
"""


@pytest.mark.parametrize("case", ["structure", "include_distant",
                                  "plymesh"])
def test_pbrt_matches_jax(tmp_path, case):
    """tests/test_pbrt.py's Cornell-ish scene (named materials, the
    graphics-state stack, Rotate, Scale -1 restoring the winding, the
    sphere, area, point and infinite lights), Include with distant and
    point lights (and a skipped Texture), and a transformed plymesh
    with normals and uvs (and a missing one): meshes, materials, camera,
    env, lights and the skipped list."""
    (tmp_path / "inc.pbrt").write_text(
        'Material "metal" "float roughness" [.1]\n'
        'Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0] '
        '"integer indices" [0 1 2] "normal N" [0 0 1 0 0 1 0 0 1] '
        '"point2 uv" [0 0 1 0 0 1]\n')
    _write_ply_ascii(tmp_path / "mesh.ply")
    text = dict(structure=PBRT, include_distant=_INCLUDE,
                plymesh=_PLYMESH)[case]
    p = tmp_path / "s.pbrt"
    p.write_text(text)
    ja = jpbrt.load_pbrt(str(p))
    ta = tpbrt.load_pbrt(str(p), device="cpu")
    same_meshes(ja[0], ta[0])
    same_mats(ja[1], ta[1])
    for x, y in zip(ja[2:5], ta[2:5]):
        same_leaves(x, y)
    assert ja[5] == ta[5]
    if case == "structure":
        v, f = ta[0][2].positions, ta[0][2].indices[0]
        assert np.cross(v[f[1]] - v[f[0]], v[f[2]] - v[f[0]])[1] < 0
    with pytest.raises(ValueError) if ta[5] else contextlib.nullcontext():
        tpbrt.load_pbrt(str(p), strict=True, device="cpu")


# ---------------------------------------------------------------------------
# Mitsuba
# ---------------------------------------------------------------------------

_MITSUBA_TEX = """<scene version="2.0.0">
  <sensor type="perspective">
    <float name="fov" value="40"/>
    <transform name="to_world">
      <lookat origin="1, 2, 3" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
  </sensor>
  <texture type="bitmap" id="shared">
    <string name="filename" value="half.png"/>
    <float name="uscale" value="2"/>
    <transform name="to_uv"><scale x="3" y="0.5"/></transform>
  </texture>
  <bsdf type="roughplastic" id="pl">
    <ref name="diffuse_reflectance" id="shared"/>
    <float name="alpha" value="0.2"/>
  </bsdf>
  <shape type="rectangle">
    <bsdf type="diffuse">
      <texture type="bitmap" name="reflectance">
        <string name="filename" value="half.png"/>
      </texture>
    </bsdf>
  </shape>
  <shape type="sphere">
    <point name="center" x="3" y="4" z="5"/>
    <float name="radius" value="0.5"/>
    <ref id="pl"/>
  </shape>
  <shape type="sphere">
    <point name="center" value="1, -1, 2"/>
    <bsdf type="thindielectric"><float name="int_ior" value="1.33"/></bsdf>
  </shape>
  <shape type="obj">
    <string name="filename" value="t.obj"/>
    <transform name="to_world">
      <matrix value="1 0 0 1  0 0 -1 2  0 1 0 3  0 0 0 1"/>
      <rotate z="1" angle="30"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="4, 3, 2"/></emitter>
  </shape>
  <emitter type="constant"><spectrum name="radiance" value="0.25"/>
  </emitter>
</scene>"""


@pytest.mark.parametrize("case", ["parse", "textures"])
def test_mitsuba_matches_jax(tmp_path, case):
    """tests/test_mitsuba.py's Cornell XML (twosided, dielectric, rough
    conductor, area light, the lookat sensor), and a scene with PNG
    bitmaps (inline and referenced, uscale and to_uv), point-centred
    spheres (x/y/z and value forms), an obj shape under a matrix and a
    rotate, and a constant emitter."""
    (tmp_path / "t.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
        "vt 1 1\nf 1/1 2/2 3/3\nf 2/2 4/4 3/3\n")
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = (255, 0, 0)
    img[:, 4:] = (0, 0, 255)
    write_png(str(tmp_path / "half.png"), img)
    p = tmp_path / "s.xml"
    p.write_text(MITSUBA_XML if case == "parse" else _MITSUBA_TEX)
    ja, ta = JAtlas(), TAtlas()
    jr = jmitsuba.load_mitsuba(str(p), atlas_builder=ja)
    tr = tmitsuba.load_mitsuba(str(p), atlas_builder=ta, device="cpu")
    same_meshes(jr[0], tr[0])
    same_mats(jr[1], tr[1])
    same_leaves(jr[2], tr[2])
    same_leaves(jr[3], tr[3])
    if case == "textures":
        assert len(ta.images) == 1 and tr[1][1].uv_scale[:2] == (6.0, 0.5)
        same_atlas(ja, ta)
        c = tr[0][1].positions.mean(0)
        np.testing.assert_allclose(c, (3, 4, 5), atol=0.05)


def test_mitsuba_texture_divergences_are_pinned(tmp_path):
    """A JPEG bitmap raises naming A.27 in the port (the JAX loader
    decodes it with Pillow); a PNG it cannot decode raises ValueError
    (the JAX loader drops it)."""
    (tmp_path / "t.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    (tmp_path / "half.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    p = tmp_path / "s.xml"
    p.write_text(_MITSUBA_TEX.replace("half.png", "half.jpg"))
    with pytest.raises(NotImplementedError, match=A27):
        tmitsuba.load_mitsuba(str(p), atlas_builder=TAtlas(), device="cpu")
    (tmp_path / "half.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    p.write_text(_MITSUBA_TEX)
    assert jmitsuba.load_mitsuba(str(p), atlas_builder=JAtlas())[1][
        0].tex_albedo == -1
    with pytest.raises(ValueError):
        tmitsuba.load_mitsuba(str(p), atlas_builder=TAtlas(), device="cpu")


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

TABLES = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
          "tri_mat", "tri_lod", "bvh2_box", "bvh2_left", "bvh2_count",
          "cw_nodes", "cw_tri_index", "cw_leaf_rows", "atlas",
          "atlas_rects", "atlas_level_y", "lbvh_nodes", "lbvh_info",
          "lbvh_prim", "lbvh_trail", "lbvh_pairs", "lbvh_pair_children",
          "lcut_bounds", "lcut_link", "lcut_node_ids", "lcut_of_light",
          "lcut_skip")


def same_scene(js, ts):
    """A JAX Scene against the port's, table for table and bit for bit
    (materials, light list, env and lights too; a terrain's fields)."""
    def eq(x, y, what):
        assert (x is None) == (y is None), what
        if x is None:
            return
        x = np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, what
        if x.dtype.kind == "f":
            assert _bits(x.astype(np.float32)) == _bits(y), what
        else:
            assert np.array_equal(x.astype(np.int64) & 0xFFFFFFFF,
                                  y.astype(np.int64) & 0xFFFFFFFF), what
    for f in TABLES:
        eq(getattr(js, f), getattr(ts, f), f)
    for part in ("materials", "light_tris", "env", "lights"):
        for f in dataclasses.fields(getattr(ts, part)):
            eq(getattr(getattr(js, part), f.name),
               getattr(getattr(ts, part), f.name), f"{part}.{f.name}")
    assert (js.cw_stack, js.has_media) == (ts.cw_stack, ts.has_media)
    assert (js.terrain is None) == (ts.terrain is None)
    if ts.terrain is not None:
        for f in ("height", "origin", "size", "h_max", "alphamap",
                  "mat_ids"):
            eq(getattr(js.terrain, f), getattr(ts.terrain, f), f)


def _rules_file(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps([{"match": "tri|wall", "set": {
        "clearcoat": 0.7, "!roughness": 0.21}}]))
    return "rules.json"


def _manifest_doc(tmp_path, case):
    np.save(tmp_path / "hills.npy", np.random.default_rng(2).uniform(
        0, 1, (9, 9)).astype(np.float32))
    img = np.random.default_rng(4).integers(0, 256, (6, 5, 4), np.uint8)
    write_png(str(tmp_path / "rgba.png"), img)
    render = {"width": 16, "height": 16, "bounces": 2, "bsdf": "disney",
              "traversal": "wavefront", "light_sampling": "tree"}
    if case == "roundtrip":
        return {
            "meshes": [
                {"primitive": "uv_sphere", "translate": [0, 1.5, 0],
                 "radius": 0.6, "rings": 6, "segments": 8,
                 "material": "glow"},
                {"primitive": "grid", "sx": 6.0, "sz": 6.0,
                 "material": "floor", "scale": 1.5}],
            "materials": {
                "glow": {"emission": [8, 6, 2]},
                "floor": {"base_color": [0.6, 0.6, 0.6], "roughness": 0.9,
                          "tex_file_albedo": "rgba.png"},
                "grass": {"base_color": [0.3, 0.5, 0.2]}},
            "material_overrides": {"floor": {"roughness": 0.4,
                                             "rough_remap": [0.1, 0.9]}},
            "env": {"constant": [0.1, 0.12, 0.2]},
            "terrain": {"heightmap": "hills.npy", "origin": [-5, -1, -5],
                        "size": [10, 10], "materials": ["grass"],
                        "height_scale": 0.5},
            "camera": {"eye": [0, 2.5, 6], "target": [0, 1, 0], "fov": 45,
                       "aperture": 0.05, "focus": 4.0},
            "render": render}
    _tri_gltf(tmp_path)
    (tmp_path / "t.obj").write_text(
        "mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\n"
        "usemtl stone_wall\nf 1 2 3\nusemtl gold_lamp\nf 2 4 3\n")
    (tmp_path / "t.mtl").write_text(
        "newmtl stone_wall\nKd 0.5 0.4 0.3\nnewmtl gold_lamp\n"
        "Kd 0.9 0.8 0.1\n")
    doc = {"meshes": [{"gltf": "tri.gltf"}, {"obj": "t.obj"},
                      {"primitive": "uv_sphere", "rings": 6,
                       "segments": 8, "material": "ball"}],
           "materials": {"ball": {"metallic": 1.0}},
           "env": {"constant": [0.2, 0.3, 0.4]},
           "camera": {"eye": [3, 1, 5], "target": [3, 0.7, 0]},
           "render": render}
    if case == "auto_pair":
        doc.update(auto_pair=True, material_rules=_rules_file(tmp_path))
    return doc


@pytest.mark.parametrize("case", ["roundtrip", "gltf", "auto_pair"])
def test_manifest_matches_jax(tmp_path, case):
    """tests/test_manifest.py's round trip (primitives, materials with a
    PNG texture, overrides, a constant env, a .npy terrain, the camera)
    and its glTF entry (with an OBJ entry and a sphere), and auto_pair
    with a user rules file (the baked sky: test_written_manifest): the port's Scene, camera and
    RenderConfig against the JAX load_manifest's, on the wavefront
    traversal with the light tree."""
    doc = _manifest_doc(tmp_path, case)
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(doc))
    js, jc, jcfg = jmanifest.load_manifest(str(p))
    ts, tc, tcfg = tmanifest.load_manifest(str(p), device="cpu")
    same_scene(js, ts)
    same_leaves(jc, tc)
    assert dataclasses.asdict(jcfg) == {
        k: v for k, v in dataclasses.asdict(tcfg).items()
        if k in dataclasses.asdict(jcfg)}
    if case == "auto_pair":
        # t.obj's "stone_wall" (after the glTF's unnamed material)
        assert float(ts.materials.clearcoat[1]) == np.float32(0.7)
        assert float(ts.materials.roughness[1]) == np.float32(0.21)


def test_manifest_divergences_raise(tmp_path):
    """A manifest whose traversal the port does not run (cwbvh) raises
    naming A.19; a tex_file_* other than PNG raises naming A.27. A bvh2
    manifest, which raised before the port's BVH2 traversal, builds the
    JAX package's scene without the CWBVH, table for table."""
    doc = _manifest_doc(tmp_path, "roundtrip")
    doc["render"]["traversal"] = "cwbvh"
    (tmp_path / "a.json").write_text(json.dumps(doc))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.19"):
        tmanifest.load_manifest(str(tmp_path / "a.json"), device="cpu")
    doc["render"]["traversal"] = "bvh2"
    (tmp_path / "c.json").write_text(json.dumps(doc))
    js, _, jcfg = jmanifest.load_manifest(str(tmp_path / "c.json"))
    ts, _, tcfg = tmanifest.load_manifest(str(tmp_path / "c.json"),
                                          device="cpu")
    same_scene(js, ts)
    assert tcfg.traversal == jcfg.traversal == "bvh2"
    assert ts.cw_nodes.shape[0] == 0
    doc["render"]["traversal"] = "wavefront"
    (tmp_path / "t.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    doc["materials"]["floor"]["tex_file_albedo"] = "t.jpg"
    (tmp_path / "b.json").write_text(json.dumps(doc))
    with pytest.raises(NotImplementedError, match=A27):
        tmanifest.load_manifest(str(tmp_path / "b.json"), device="cpu")


# ---------------------------------------------------------------------------
# material rules and material JSON
# ---------------------------------------------------------------------------

NAMES = ["gold_trim_01", "window_GLASS", "curtain_red", "ceiling_lamp",
         "concrete_floor", "x", "Water", "ivy_leaves", "porcelain_tile",
         "oak_wood", "skin", "brass_lamp", "mirror", "neon_sign"]


def test_material_rules_match_jax(tmp_path):
    """The defaults the rules test against are the JAX HostMaterial's,
    field for field; DEFAULT_RULES, load_rules and apply_rules /
    auto_pair give the same materials on names of every rule, over
    default and explicit materials, with forced keys."""
    assert dataclasses.asdict(TMaterial()) == dataclasses.asdict(JMaterial())
    assert trules.DEFAULT_RULES == jrules.DEFAULT_RULES
    path = str(tmp_path / _rules_file(tmp_path))
    assert trules.load_rules(path) == jrules.load_rules(path)
    bases = [dict(), dict(roughness=0.1), dict(base_color=(1, 0.5, 0.2)),
             dict(emission=(1.0, 1.0, 1.0), metallic=0.5)]
    for rules in (None, jrules.load_rules(path),
                  [{"match": "x|lamp", "set": {"!roughness": 0.77,
                                               "!emission_from_color": 2.0,
                                               "base_color": [0.1, 0.2,
                                                              0.3]}}]):
        for kw in bases:
            jm = jrules.auto_pair(NAMES, [JMaterial(**kw)] * len(NAMES),
                                  rules)
            tm = trules.auto_pair(NAMES, [TMaterial(**kw)] * len(NAMES),
                                  rules)
            same_mats(jm, tm)
    (tmp_path / "bad.json").write_text(json.dumps([{"match": "a"}]))
    for mod in (jrules, trules):
        with pytest.raises(ValueError):
            mod.load_rules(str(tmp_path / "bad.json"))


def test_materials_io_round_trips_across(tmp_path):
    """A material set saved by either package loads in the other with
    every field equal (tuples come back as tuples); apply_overrides
    edits the named ones alike."""
    mats = [TMaterial(base_color=(0.1, 0.2, 0.3), roughness=0.25,
                      uv_scale=(2.0, 1.0, 0.5, 0.0), tex_albedo=3),
            TMaterial(emission=(4.0, 3.0, 2.0), rough_remap=(0.2, 0.8)),
            TMaterial()]
    names = ["a", "b", "c"]
    tio.save_materials(str(tmp_path / "t.json"), mats, names)
    jm, jn = jio.load_materials(str(tmp_path / "t.json"))
    jio.save_materials(str(tmp_path / "j.json"), jm, jn)
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    tm, tn = tio.load_materials(str(tmp_path / "j.json"))
    assert tn == jn == names
    same_mats(jm, tm)
    assert all(dataclasses.asdict(a) == dataclasses.asdict(b)
               for a, b in zip(mats, tm))
    tio.save_materials(str(tmp_path / "u.json"), mats)
    assert tio.load_materials(str(tmp_path / "u.json"))[1] == [
        "mat_0", "mat_1", "mat_2"]
    over = {"b": {"roughness": 0.9, "base_color": (1.0, 0.0, 0.0)}}
    same_mats(jio.apply_overrides(jm, names, over),
              tio.apply_overrides(tm, names, over))


# ---------------------------------------------------------------------------
# the texture downscale and the OBJ loader's remnants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 9), (16, 16), (33, 20), (1, 5),
                                   (64, 31), (2, 1)])
def test_resize_is_pillows(shape):
    """Pillow's default Image.resize on RGBA (premultiplied, bicubic,
    22-bit fixed point, horizontal pass first), bit for bit: random
    images of odd and even sizes with alpha 0, 255 and partial, halved
    one to three times."""
    from PIL import Image
    r = np.random.default_rng(sum(shape))
    img = r.integers(0, 256, shape + (4,), dtype=np.uint8)
    a = img[..., 3]
    img[..., 3] = np.where(r.random(shape) < 0.3, 0,
                           np.where(r.random(shape) < 0.5, 255, a))
    im, mine = Image.fromarray(img, "RGBA"), img
    for _ in range(3):
        w, h = max(im.size[0] // 2, 1), max(im.size[1] // 2, 1)
        im = im.resize((w, h))
        mine = resize_rgba(mine, w, h)
        assert np.array_equal(np.asarray(im), mine)


@pytest.fixture(scope="module")
def sponza_dir(tmp_path_factory):
    """sponza_like at detail 0.5 (6132 triangles), exported by the port,
    and written in every other format by chip_smoke.write_sources."""
    d = tmp_path_factory.mktemp("sponza")
    obj = tsponza.export(str(d), 0.5)
    from truetrace_tpu_torch.scene.ir import Camera
    cam = Camera.look_at(eye=(-9.5, 2.1, 0.0), target=(6.0, 3.2, -0.5),
                         fov_y_deg=55, device="cpu")
    return d, obj, chip_smoke.write_sources(str(d), obj, cam)


@pytest.mark.parametrize("opts", [dict(max_tex=128, auto_pair=True),
                                  dict(max_tex=100)])
def test_obj_scene_options_match_jax(sponza_dir, opts):
    """load_obj_scene with auto_pair and with textures wider than max_tex
    (halved once to 128, twice where 128 > 100): materials and the atlas
    bit for bit the JAX loader's (Pillow's resize)."""
    _, obj, _ = sponza_dir
    jr = jobj.load_obj_scene(obj, **opts)
    tr = tobj.load_obj_scene(obj, **opts)
    same_meshes(jr[0], tr[0])
    same_mats(jr[1], tr[1])
    for x, y in zip(jr[2:], tr[2:]):
        assert np.array_equal(x, y)
    assert int(tr[3][:, 2:].max()) == (128 if opts["max_tex"] == 128
                                       else 64)


@pytest.mark.parametrize("source", ["glb", "ply", "pbrt", "xml"])
def test_written_sources_match_jax_and_obj(sponza_dir, source):
    """chip_smoke.py's writers on sponza_like: each file loads in both
    packages alike (the GLB with its atlas), and its triangle soup is the
    OBJ load's bit for bit (the GLB's grouped by material, keeping each
    material's material id; the others one material)."""
    d, obj, src = sponza_dir
    p = src["paths"][source]
    ref = chip_smoke.soup(src["obj"][0])
    order = np.argsort(ref[1], kind="stable")
    if source == "glb":
        ja, ta = JAtlas(), TAtlas()
        jm, jmat = jgltf.load_gltf(p, atlas_builder=ja)
        tm, tmat = tgltf.load_gltf(p, atlas_builder=ta)
        same_mats(jmat, tmat)
        same_atlas(ja, ta)
        assert len(ta.images) == 8
        want = (ref[0][order], ref[1][order])
    elif source == "ply":
        from truetrace_tpu_torch.scene.mesh import HostMesh
        a, b = jply.load_ply(p), tply.load_ply(p)
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert _bits(x) == _bits(y)
        tm = [HostMesh(b[0], b[1], np.zeros(b[1].shape[0], np.int32))]
        jm = None
        want = (ref[0], np.zeros_like(ref[1]))
    elif source == "pbrt":
        ja = jpbrt.load_pbrt(p)
        ta = tpbrt.load_pbrt(p, device="cpu")
        jm, tm = ja[0], ta[0]
        same_mats(ja[1], ta[1])
        for x, y in zip(ja[2:5], ta[2:5]):
            same_leaves(x, y)
        assert ja[5] == ta[5] == []
        want = (ref[0], np.zeros_like(ref[1]))
    else:
        ja = jmitsuba.load_mitsuba(p)
        ta = tmitsuba.load_mitsuba(p, device="cpu")
        jm, tm = ja[0], ta[0]
        same_mats(ja[1], ta[1])
        same_leaves(ja[2], ta[2])
        same_leaves(ja[3], ta[3])
        want = (ref[0], np.zeros_like(ref[1]))
    if jm is not None:
        same_meshes(jm, tm)
    chip_smoke.same_soup(chip_smoke.soup(tm), want, source)


def test_written_manifest_matches_jax(sponza_dir, monkeypatch):
    """The manifest chip_smoke.py writes (the GLB, a textured sphere,
    auto_pair, material_overrides, a sky) builds the JAX package's Scene
    table for table. Its sky entry reaches bake_sky_env with the same
    sun in both packages (recorded here, with a constant env in its
    place: the bake itself is held in tests/test_torch_terrain.py)."""
    from truetrace_tpu.scene import atmosphere as jatm
    from truetrace_tpu.scene.ir import EnvMap as JEnv
    from truetrace_tpu_torch.scene import atmosphere as tatm
    from truetrace_tpu_torch.scene.ir import EnvMap as TEnv
    seen = []

    def fake(env, **kw):
        def bake(**a):
            seen.append({k: v for k, v in a.items() if k != "device"})
            return env((0.5, 0.6, 0.7), **kw)
        return bake

    monkeypatch.setattr(jatm, "bake_sky_env", fake(JEnv.constant))
    monkeypatch.setattr(tatm, "bake_sky_env", fake(TEnv.constant,
                                                   device="cpu"))
    d, _, src = sponza_dir
    p = src["paths"]["json"]
    js, jc, _ = jmanifest.load_manifest(p)
    ts, tc, tcfg = tmanifest.load_manifest(p, device="cpu")
    assert seen[0] == seen[1] == dict(
        sun_dir=tuple(chip_smoke.SOURCES_SKY["sun_dir"]),
        sun_irradiance=chip_smoke.SOURCES_SKY["sun_irradiance"])
    same_scene(js, ts)
    same_leaves(jc, tc)
    assert ts.atlas_rects.shape[0] == 9
    assert (tcfg.width, tcfg.height) == (512, 512)
