"""Torch port, the sponza_like slice: the asset pipeline (export -> OBJ,
MTL and PNG files -> load_obj_scene -> atlas -> compile_scene) against
the JAX package's, file for file and table for table; the port's own
sponza_like.make -> compile_scene -> Renderer.step at 32x24 against a
fresh, eager JAX Renderer (one sample and two SVGF frames); the texture
block on a small synthetic scene that sets every tex_* field; and the
export -> load round trip in a process where Pillow cannot be imported.

The JAX reference's bounce loop compiles anew at every eager sample
(about 10 s on a CPU), so the one-sample reference is the JAX Renderer's
own first-frame render_sample_with_stats call, recorded on the way
through (its arguments and results pass unchanged), not a third trace.

Tolerances: files, meshes, materials, the atlas, tri_lod and every scene
table bitwise. Renders by the share of pixels, as tests/test_torch_frame.py:
the RNG, camera rays and traversal are bitwise, so pixels differ by the
ulps of transcendentals and contracted mul-adds, and on a few lanes by a
branch flip (a bf16 light pick, round(lod) at a half, a cutout or lobe
choice at equality)."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import truetrace_tpu.renderer as jrenderer
from truetrace_tpu.build.env_cdf import build_env_cdf as jbuild_env
from truetrace_tpu.build.env_cdf import procedural_sky as jsky
from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.integrate.pathtrace import (
    render_sample_with_stats as jrender_sample_with_stats)
from truetrace_tpu.scene import sponza_like as jsponza
from truetrace_tpu.scene.atlas import AtlasBuilder as JAtlasBuilder
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import HostMaterial as JHostMaterial
from truetrace_tpu.scene.mesh import HostMesh as JHostMesh
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu.scene.obj_loader import load_obj_scene as jload
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.renderer import Renderer, RendererConfig
from truetrace_tpu_torch.scene import sponza_like as tsponza
from truetrace_tpu_torch.scene.ir import TEX_SLOTS, Camera, Scene
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile
from truetrace_tpu_torch.scene.obj_loader import load_obj_scene as tload
from truetrace_tpu_torch.scene.png import read_png, write_png

from torch_parity import check_sample, close_share, leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DETAIL = 0.5
W, H = 32, 24
TABLES = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
          "tri_mat", "tri_lod", "bvh2_box", "bvh2_left", "bvh2_count",
          "cw_nodes", "cw_tri_index", "cw_leaf_rows", "lbvh_nodes",
          "lbvh_pairs", "lcut_bounds", "atlas", "atlas_rects",
          "atlas_level_y")
CFG = dict(width=W, height=H, bounces=3, bsdf="disney",
           traversal="wavefront", light_sampling="tree", denoiser="svgf")


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64) & 0xFFFFFFFF,
                                      b.astype(np.int64) & 0xFFFFFFFF,
                                      err_msg=what)


@pytest.fixture(scope="module")
def sponza(tmp_path_factory):
    """Both packages' exports at detail 0.5, the JAX package's loaded and
    compiled scene, and the port's, made through sponza_like.make."""
    jdir = str(tmp_path_factory.mktemp("sponza_jax"))
    tdir = str(tmp_path_factory.mktemp("sponza_port"))
    jobj = jsponza.export(jdir, DETAIL)
    tobj = tsponza.export(tdir, DETAIL)
    jm = jsponza.make(DETAIL, assets_dir=jdir)
    js = jcompile(jm[0], jm[1], env=jm[6], atlas=jm[2], atlas_rects=jm[3],
                  atlas_level_y=jm[4], with_cwbvh=True, with_light_bvh=True)
    tm = tsponza.make(DETAIL, assets_dir=tdir, device="cpu")
    ts = tcompile(tm[0], tm[1], env=tm[6], atlas=tm[2], atlas_rects=tm[3],
                  atlas_level_y=tm[4], with_cwbvh=True, with_light_bvh=True,
                  device="cpu")
    return dict(jobj=jobj, tobj=tobj, jm=jm, js=js, tm=tm, ts=ts)


@pytest.fixture(scope="module")
def jax_frames(sponza):
    """Two frames of a fresh, eager JAX Renderer on the JAX package's
    scene, with the render_sample_with_stats call of each frame
    recorded."""
    calls, orig = [], jrenderer.render_sample_with_stats

    def record(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out
    r = jrenderer.Renderer(sponza["js"], sponza["jm"][5],
                           jrenderer.RendererConfig(**CFG))
    st, frames = r.init_state(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_sample_with_stats", record)
        for _ in range(2):
            disp, acc, st = r.step(st)
            frames.append((np.asarray(disp), np.asarray(acc)))
    return dict(frames=frames, calls=calls)


def test_export_matches_jax(sponza):
    """The OBJ and MTL bytes are the JAX export's; every texture decodes
    to the same pixels from either package's PNG (the JAX package writes
    with Pillow, the port with scene/png.py), both ways."""
    jobj, tobj = sponza["jobj"], sponza["tobj"]
    for a, b in ((jobj, tobj), (jobj[:-3] + "mtl", tobj[:-3] + "mtl")):
        assert open(a, "rb").read() == open(b, "rb").read(), b
    names = sorted(os.listdir(os.path.join(os.path.dirname(jobj),
                                           "textures")))
    assert names == sorted(f"{n}.png" for n in jsponza.make_textures())
    for n in names:
        pj = os.path.join(os.path.dirname(jobj), "textures", n)
        pt = os.path.join(os.path.dirname(tobj), "textures", n)
        img = read_png(pt)
        assert img.shape == (256, 256, 3)
        np.testing.assert_array_equal(read_png(pj), img)
        np.testing.assert_array_equal(np.asarray(Image.open(pt)), img)


def test_load_obj_scene_matches_jax(sponza):
    """The port's loader on the JAX package's files: meshes, materials and
    the atlas triple bit for bit."""
    jmeshes, jmats, ja, jr, jl = jload(sponza["jobj"])
    tmeshes, tmats, ta, tr, tl = tload(sponza["jobj"])
    assert len(jmeshes) == len(tmeshes) == 1
    for f in ("positions", "indices", "mat_id", "normals", "uvs"):
        _same_bits(getattr(jmeshes[0], f), getattr(tmeshes[0], f), f)
    assert ([dataclasses.asdict(m) for m in jmats]
            == [dataclasses.asdict(m) for m in tmats])
    assert sum(m.tex_albedo >= 0 for m in tmats) == 8
    for a, b, what in ((ja, ta, "atlas"), (jr, tr, "rects"),
                       (jl, tl, "level_y")):
        _same_bits(a, b, what)
    assert ta.shape == (1920, 736, 4) and tl.tolist() == [0, 1024, 1536, 1792]


def test_compile_scene_textured_bitwise(sponza):
    """compile_scene with the atlas and the textured sky: every table, the
    per-triangle texture LOD and the env tables are the JAX package's;
    Scene.from_numpy carries the atlas fields across unchanged."""
    js, ts = sponza["js"], sponza["ts"]
    assert ts.n_tris() == js.tri_p0.shape[0] == 6132
    for f in TABLES:
        _same_bits(getattr(js, f), getattr(ts, f).numpy(), f)
    for f in ("image", "cdf_x", "cdf_y", "total", "rotation", "intensity"):
        _same_bits(getattr(js.env, f), getattr(ts.env, f).numpy(),
                   f"env.{f}")
    for part in ("materials", "light_tris"):
        for f, v in leaves(getattr(js, part)).items():
            _same_bits(v, getattr(getattr(ts, part), f).numpy(),
                       f"{part}.{f}")
    assert ts.light_tris.tri_index.shape[0] == 72
    assert ts.cw_stack == js.cw_stack and ts.tri_shadow is None
    assert ts.tex_slots == ("tex_albedo",)
    assert float(ts.tri_lod.abs().max()) > 0
    for f, v in leaves(sponza["jm"][5]).items():   # scalars as [1]
        _same_bits(np.ravel(v), getattr(sponza["tm"][5], f).numpy().ravel(),
                   f"camera.{f}")
    cs = Scene.from_numpy(leaves(js), "cpu")
    for f in ("atlas", "atlas_rects", "atlas_level_y", "tri_lod"):
        assert torch.equal(getattr(cs, f), getattr(ts, f)), f
    assert cs.tex_slots == ts.tex_slots


def test_render_sample_matches_jax(sponza, jax_frames):
    """The port's own sponza_like.make -> compile_scene scene, the first
    frame's sample (sample id 0, every pixel), 3 bounces, Disney, tree +
    env NEE with MIS, textured albedo at ray-cone mips, against the JAX
    Renderer's: >= 99% of pixels agree; the open roof shows sky at the
    primary hit."""
    (args, kw, (jr, jst)) = jax_frames["calls"][0]
    assert int(args[4]) == 0 and kw.get("di_sample") is None
    np.testing.assert_array_equal(np.asarray(args[3]), np.arange(W * H))
    ts, tcam = sponza["ts"], sponza["tm"][5]
    rcfg = Renderer(ts, tcam, RendererConfig(**CFG)).rcfg
    tr, tst = render_sample_with_stats(ts, tcam, rcfg, torch.arange(W * H),
                                       0)
    check_sample(jr, jst, tr, tst, 0.99)
    sky = float((tst["depth"] == 0).float().mean())
    assert 0.01 < sky < 0.5


def test_renderer_two_svgf_frames_match_jax(sponza, jax_frames):
    """Two Renderer.step frames with SVGF of the port's own scene
    (textured albedo demodulation, sky pixels with zero normal in the
    a-trous guide, TAA from frame 2) against the fresh, eager JAX
    Renderer: the displays agree to 1e-3 on >= 99% of pixels and their
    means to rtol 1e-4."""
    assert len(jax_frames["calls"]) == 2
    tr = Renderer(sponza["ts"], sponza["tm"][5], RendererConfig(**CFG))
    tst = tr.init_state()
    for jd, ja in jax_frames["frames"]:
        td, ta, tst = tr.step(tst)
        td = td.numpy()
        assert td.shape == (H, W, 3)
        assert np.isfinite(td).all() and td.min() >= 0 and td.max() <= 1
        assert close_share(jd, td, 0.0, 1e-3) >= 0.99
        np.testing.assert_allclose(jd.mean(), td.mean(), rtol=1e-4)
        np.testing.assert_allclose(ja.mean(), ta.numpy().mean(), rtol=1e-4)


def test_texture_slot_skip_is_exact(sponza):
    """The integrator fetches only the texture slots some material sets
    (sponza_like: albedo); fetching all of them, as the JAX block does,
    gives the same sample bit for bit (a slot no material sets selects
    the material's own value on every lane)."""
    ts, tcam = sponza["ts"], sponza["tm"][5]
    cfg = RenderConfig(width=16, height=12, bounces=2, bsdf="disney",
                       traversal="wavefront", light_sampling="tree")
    pix = torch.arange(16 * 12)
    a, sa = render_sample_with_stats(ts, tcam, cfg, pix, 3)
    every = dataclasses.replace(ts, tex_slots=TEX_SLOTS)
    b, sb = render_sample_with_stats(every, tcam, cfg, pix, 3)
    assert torch.equal(a, b)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def _textured_scene():
    """Four quads facing the camera under a textured sky, whose materials
    between them set every tex_* slot, non-identity uv_scale / uv2_scale,
    a uv rotation, normal strength, the colour adjustment chain, an
    inverted roughness map and alpha below 1 in the textures (cutout
    pass-through)."""
    r = np.random.default_rng(21)
    ab = JAtlasBuilder()
    y, x = np.mgrid[0:48, 0:40] / 40.0
    tex = [ab.add(r.integers(0, 256, (48, 40, 4), dtype=np.uint8))]
    nmap = np.stack([0.5 + 0.4 * np.sin(7 * x), 0.5 + 0.4 * np.cos(5 * y),
                     np.ones_like(x)], -1)
    tex.append(ab.add(nmap.astype(np.float32)))                  # normal
    tex.append(ab.add(r.random((32, 32, 4)).astype(np.float32)))  # generic
    tex.append(ab.add(r.integers(0, 256, (20, 28), dtype=np.uint8)))
    atlas, rects, level_y = ab.build()
    mats = [
        JHostMaterial(base_color=(0.9, 0.7, 0.5), tex_albedo=0, tex_normal=1,
                      normal_strength=0.7, uv_scale=(2.0, 3.0, 0.1, 0.2),
                      uv2_scale=(0.5, 1.5), uv_rot=0.7, hue=30.0,
                      brightness=1.2, saturation=0.8, contrast=1.1,
                      blend_color=(0.1, 0.2, 0.3), blend_factor=0.2),
        JHostMaterial(base_color=(0.6, 0.6, 0.6), emission=(1.5, 1.0, 0.5),
                      tex_rough_metal=2, tex_emission=3, metallic=0.8,
                      tex_matcap=2, tex_matcap_mask=3),
        JHostMaterial(base_color=(0.4, 0.5, 0.7), tex_metallic=3,
                      tex_roughness=2, rough_tex_invert=1.0, tex_alpha=0,
                      uv_rot=-1.1),
        JHostMaterial(base_color=(0.8, 0.8, 0.3), tex_matcap=0,
                      tex_albedo=3, roughness=0.3),
    ]
    P, I, M, UV = [], [], [], []
    for k in range(4):
        x0, z = -2.2 + 1.1 * k, 0.3 * k
        P.append(np.array([[x0, -1, z], [x0 + 1.0, -1, z],
                           [x0 + 1.0, 1, z + 0.4], [x0, 1, z + 0.4]],
                          np.float32))
        UV.append(np.array([[0, 0], [1.3, 0], [1.3, 2.1], [0, 2.1]],
                           np.float32))
        I.append(np.array([[0, 1, 2], [0, 2, 3]], np.int32) + 4 * k)
        M.append(np.full(2, k, np.int32))
    mesh = JHostMesh(positions=np.concatenate(P), indices=np.concatenate(I),
                     mat_id=np.concatenate(M), uvs=np.concatenate(UV))
    env = jbuild_env(jsky(h=16, w=32, sun_angle_deg=10.0,
                          sun_intensity=20.0))
    cam = JCamera.look_at(eye=(0.0, 0.2, -2.0), target=(0.0, 0.0, 0.5),
                          fov_y_deg=60)
    js = jcompile([mesh], mats, env=env, atlas=atlas, atlas_rects=rects,
                  atlas_level_y=level_y, with_cwbvh=True)
    return js, cam


def test_texture_block_matches_jax():
    """Every texture slot through one sample (BSDF sampling only, the
    texture block's own path): >= 97% of pixels and G-buffer texels
    agree. The other lanes may take the other side of round(lod) at a
    half, of a cutout test against a texture alpha, or of a lobe choice."""
    js, jcam = _textured_scene()
    ts = Scene.from_numpy(leaves(js), "cpu")
    for k in ("tex_albedo", "tex_normal", "tex_emission", "tex_rough_metal",
              "tex_matcap", "tex_metallic", "tex_roughness", "tex_alpha",
              "tex_matcap_mask"):
        assert bool((getattr(ts.materials, k) >= 0).any()), k
    cfg = dict(width=W, height=H, bounces=2, bsdf="disney",
               traversal="wavefront", use_nee=False)
    jr, jst = jrender_sample_with_stats(
        js, jcam, JRenderConfig(**cfg), jnp.arange(W * H, dtype=jnp.uint32),
        0)
    tr, tst = render_sample_with_stats(
        ts, Camera.from_numpy(leaves(jcam), "cpu"), RenderConfig(**cfg),
        torch.arange(W * H), 0)
    check_sample(jr, jst, tr, tst, 0.97)
    assert float((tst["depth"] > 0).float().mean()) > 0.3


def test_export_load_without_pillow(tmp_path):
    """The card's machine has no Pillow: the port's export -> load round
    trip at detail 0.5 (sponza_like.make) in a process where importing
    PIL fails."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'PIL':\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from truetrace_tpu_torch.scene import sponza_like\n"
        f"m = sponza_like.make({DETAIL}, assets_dir=sys.argv[1], "
        "device='cpu')\n"
        "assert 'PIL' not in sys.modules\n"
        "print(m[0][0].indices.shape[0], m[2].shape, len(m[3]))\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "6132 (1920, 736, 4) 8"
    assert len(os.listdir(tmp_path / "textures")) == 8


def test_loader_raises_on_unreadable_texture(tmp_path):
    """A texture file that is present but cannot be decoded raises in the
    port (the JAX loader drops it silently and renders untextured); a
    missing one is skipped by both; a file other than PNG raises naming
    ROADMAP.md A.27; auto_pair and a texture wider than max_tex (halved
    with Pillow in the JAX loader, scene/resize.py in the port) give the
    JAX loader's materials and atlas."""
    (tmp_path / "t.obj").write_text(
        "mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl a\nf 1 2 3\n")
    (tmp_path / "t.mtl").write_text(
        "newmtl a\nKd 1 1 1\nmap_Kd bad.png\nmap_Ke gone.png\n")
    (tmp_path / "bad.png").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    jm = jload(str(tmp_path / "t.obj"))
    assert jm[1][0].tex_albedo == -1 and jm[2] is None
    with pytest.raises(ValueError):
        tload(str(tmp_path / "t.obj"))
    os.remove(tmp_path / "bad.png")
    tm = tload(str(tmp_path / "t.obj"))
    assert tm[1][0].tex_albedo == tm[1][0].tex_emission == -1
    assert tm[2] is None
    (tmp_path / "t.mtl").write_text(
        "newmtl a\nKd 1 1 1\nmap_Kd bad.jpg\n")
    (tmp_path / "bad.jpg").write_bytes(b"\xff\xd8\xff\xe0" + bytes(16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.27"):
        tload(str(tmp_path / "t.obj"))
    (tmp_path / "t.mtl").write_text(
        "newmtl a\nKd 1 1 1\nmap_Kd bad.png\nmap_Ke gone.png\n")
    img = np.random.default_rng(0).integers(0, 256, (8, 32, 3), np.uint8)
    write_png(str(tmp_path / "bad.png"), img)
    assert tload(str(tmp_path / "t.obj"))[3].tolist() == [[0, 0, 32, 16]]
    for kw in (dict(auto_pair=True), dict(max_tex=16)):
        jm, tm = jload(str(tmp_path / "t.obj"), **kw), tload(
            str(tmp_path / "t.obj"), **kw)
        assert [dataclasses.asdict(m) for m in jm[1]] == [
            dataclasses.asdict(m) for m in tm[1]]
        for a, b in zip(jm[2:], tm[2:]):
            assert np.array_equal(np.asarray(a), b)
    assert tm[3][0, 2] == 16
