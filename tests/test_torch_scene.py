"""Torch port, scene building: the port's own compile_scene (jax-free
copies of the builders and scene generators) against the JAX package's,
table for table and bit for bit; the traversal table (expand_nodes,
pack_table); the carry-across constructors; and the options the slice
does not port, which must raise; and the entry points' device defaults."""
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import truetrace_tpu.kernels.cwbvh_wavefront as jwf
from truetrace_tpu.scene import atrium as jatrium
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.build import env_cdf as tenv_cdf
from truetrace_tpu_torch.kernels import cwbvh_wavefront as twf
from truetrace_tpu_torch.post import neural as tneural
from truetrace_tpu_torch.post import pipeline as tpipe
from truetrace_tpu_torch.post import svgf as tsvgf
from truetrace_tpu_torch.scene import atmosphere as tatmosphere
from truetrace_tpu_torch.scene import asset_manager as tasset_manager
from truetrace_tpu_torch.scene import atrium as tatrium
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene import dynamic as tdynamic
from truetrace_tpu_torch.scene import ir as tir
from truetrace_tpu_torch.scene import instances as tinstances
from truetrace_tpu_torch.scene import sponza_like as tsponza
from truetrace_tpu_torch.scene import terrain as tterrain
from truetrace_tpu_torch.scene import video as tvideo
from truetrace_tpu_torch.scene.ir import Scene
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from torch_parity import leaves

# (scene, detail, leaf_k); atrium 0.5 has 27608 triangles, above the
# 20000 at which both packages switch to the native C++ builders
CASES = [("cornell", None, 3), ("cornell", None, 6), ("atrium", 0.2, 3),
         ("atrium", 0.2, 6), ("atrium", 0.5, 6)]
_cache = {}


def _pair(name, detail, k):
    key = (name, detail, k)
    if key not in _cache:
        if name == "cornell":
            jm, jmat, _ = jcornell.make()
            tm, tmat, _ = tcornell.make(device="cpu")
            jenv = tenv = None
        else:
            jm, jmat, _, jenv = jatrium.make(detail=detail)
            tm, tmat, _, tenv = tatrium.make(detail=detail, device="cpu")
        js = jcompile(jm, jmat, env=jenv, with_cwbvh=True,
                      with_light_bvh=True, leaf_k=k)
        ts = tcompile(tm, tmat, env=tenv, with_cwbvh=True,
                      with_light_bvh=True, leaf_k=k, device="cpu")
        _cache[key] = (js, ts)
    return _cache[key]


def _np(x):
    """Port tensor -> numpy with uint32 tables compared as their bits."""
    return x.cpu().numpy()


def _same_bits(a, b, what):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32),
                                      err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64) & 0xFFFFFFFF,
                                      b.astype(np.int64) & 0xFFFFFFFF,
                                      err_msg=what)


TABLES = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
          "tri_mat", "bvh2_box", "bvh2_left", "bvh2_count", "cw_nodes",
          "cw_tri_index", "cw_leaf_rows", "lbvh_nodes", "lbvh_info",
          "lbvh_prim", "lbvh_trail", "lbvh_pairs", "lbvh_pair_children",
          "lcut_bounds", "lcut_link", "lcut_node_ids", "lcut_of_light",
          "lcut_skip")


@pytest.mark.parametrize("name,detail,k", CASES)
def test_compile_scene_bitwise(name, detail, k):
    js, ts = _pair(name, detail, k)
    for f in TABLES:
        a, b = getattr(js, f), getattr(ts, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same_bits(a, _np(b), f)
    for f in ("tri_index", "power", "cdf", "pmf", "tri_to_light", "rows"):
        _same_bits(getattr(js.light_tris, f), _np(getattr(ts.light_tris, f)),
                   f"light_tris.{f}")
    for f in ("base_color", "emission", "roughness", "metallic", "ior",
              "rough_remap", "metal_remap"):
        _same_bits(getattr(js.materials, f), _np(getattr(ts.materials, f)),
                   f"materials.{f}")
    assert ts.cw_stack == js.cw_stack
    assert ts.has_media == js.has_media
    assert ts.tri_shadow is None and js.tri_shadow is None
    assert int(ts.lcut_bounds.shape[0]) > 0


@pytest.mark.parametrize("name,detail,k", CASES[:4])
def test_pack_table_bitwise(name, detail, k):
    """expand_nodes and the unified [C+L, 10K] table are the JAX bits."""
    js, ts = _pair(name, detail, k)
    exp_j = np.asarray(jwf.expand_nodes(js.cw_nodes))
    exp_t = _np(twf.expand_nodes(ts.cw_nodes))
    _same_bits(exp_j, exp_t, "expand_nodes")
    tab_j = np.asarray(jwf._pack_table(js.cw_nodes, js.cw_leaf_rows))
    _same_bits(tab_j, _np(ts.cw_table()), "pack_table")
    assert ts.cw_table().shape[1] == 10 * k


def test_scene_from_numpy_carries_across():
    """Scene.from_numpy on the JAX scene's leaves gives the port's own
    build (the carry-across the frame tests rely on)."""
    js, ts = _pair("cornell", None, 6)
    cs = Scene.from_numpy(leaves(js), "cpu")
    for f in TABLES:
        a, b = getattr(cs, f), getattr(ts, f)
        assert a.dtype == b.dtype, f
        if a.dtype == torch.float32:   # leaf-row id columns are NaN bits
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert torch.equal(cs.materials.base_color, ts.materials.base_color)
    assert torch.equal(cs.light_tris.rows, ts.light_tris.rows)
    assert cs.cw_stack == ts.cw_stack and cs.has_media == ts.has_media
    assert torch.equal(cs.cw_table(), ts.cw_table())


@pytest.mark.parametrize("name,detail,k", [CASES[2], CASES[0]])
def test_lbvh_depth_fixed_at_build(name, detail, k):
    """Scene.lbvh_depth, the bound of the light-tree descent loops, is a
    plain int field set when the scene is built (reading it copies
    nothing from the device), equal to a walk over the light BVH's node
    rows, and Scene.from_numpy gives the same."""
    js, ts = _pair(name, detail, k)
    assert "lbvh_depth" in {f.name for f in dataclasses.fields(Scene)}
    assert type(ts.lbvh_depth) is int
    info = ts.lbvh_info.numpy()
    depth, frontier = 0, [0]
    while frontier:
        frontier = [c for n in frontier if info[n, 1] < 0
                    for c in (info[n, 0], -info[n, 1])]
        depth += 1
    assert ts.lbvh_depth == min(depth, 32) > 1
    assert Scene.from_numpy(leaves(js), "cpu").lbvh_depth == ts.lbvh_depth


def test_pack_leaf_rows_layout():
    """Leaf rows: 3 packed tris per row, ids -1 for padding, node word 5
    rewritten to the node's first leaf row."""
    _, ts = _pair("atrium", 0.2, 3)
    rows = ts.cw_leaf_rows
    ids = rows[:, 27:30].contiguous().view(torch.int32)
    assert int(ids.max()) == ts.n_tris() - 1
    pad = ids < 0
    assert bool((rows[:, 0:27].reshape(-1, 3, 9)[pad] == 0).all())
    # every triangle appears in exactly one leaf row
    real = ids[~pad].to(torch.int64)
    assert torch.equal(torch.sort(real).values, torch.arange(ts.n_tris()))


def _raises(fn):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fn()


@pytest.mark.parametrize("opt", ["presplit", "hot_order", "bvh2_only",
                                 "cache_dir"])
def test_unported_build_options_raise(opt):
    m, mats, _ = tcornell.make(device="cpu")
    kw = dict(with_cwbvh=True, device="cpu")
    kw.update(dict(presplit=dict(presplit=0.5),
                   hot_order=dict(hot_order=True),
                   bvh2_only=dict(with_cwbvh=False),
                   cache_dir=dict(cache_dir="x"))[opt])
    _raises(lambda: tcompile(m, mats, **kw))


@pytest.mark.parametrize("opt", ["lights", "terrain"])
def test_build_options_match_jax(opt):
    """compile_scene options the port once refused, against the JAX
    package's build of the Cornell box: `lights` (16 analytic lights of
    the five kinds) gives equal light tables, `terrain` (a 33^2 hills
    heightfield with a random 8x8 alphamap and two layers) equal terrain
    tables and placement, exactly, and the same CWBVH."""
    jm, jmat, _ = jcornell.make()
    tm, tmat, _ = tcornell.make(device="cpu")
    if opt == "lights":
        from chip_smoke import analytic_lights_host
        from truetrace_tpu.scene.ir import AnalyticLights as JAnalyticLights
        d = analytic_lights_host((0.05, 0.25, 0.05), (0.5, 0.5, 0.5))
        jkw = dict(lights=JAnalyticLights(**d))
        tkw = dict(lights=tir.AnalyticLights.from_numpy(d, "cpu"))
        part = "lights"
    else:
        from truetrace_tpu.scene.terrain import demo_hills
        from truetrace_tpu.scene.terrain import make_terrain as jterrain
        from truetrace_tpu_torch.scene.terrain import make_terrain as tterrain
        hm = demo_hills(33, seed=1)
        kw = dict(origin=(-1.0, -0.5, -2.0), size_xz=(3.0, 4.0),
                  mat_ids=[0, 2], height_scale=0.7,
                  alphamap=np.random.default_rng(0).uniform(
                      0, 1, (8, 8, 4)).astype(np.float32))
        jkw = dict(terrain=jterrain(hm, **kw))
        tkw = dict(terrain=tterrain(hm, device="cpu", **kw))
        part = "terrain"
    js = jcompile(jm, jmat, with_cwbvh=True, with_light_bvh=True, **jkw)
    ts = tcompile(tm, tmat, with_cwbvh=True, with_light_bvh=True,
                  device="cpu", **tkw)
    for f in dataclasses.fields(getattr(ts, part)):
        if f.name == "consts":
            continue
        want = np.asarray(getattr(getattr(js, part), f.name))
        got = getattr(getattr(ts, part), f.name)
        got = np.asarray(got) if f.name == "hm_shape" else got.numpy()
        assert got.shape == want.shape and (got == want).all(), f.name
    if opt == "terrain":
        ter = js.terrain
        assert ts.terrain.consts == tuple(float(v) for v in np.concatenate(
            [np.asarray(ter.origin), np.asarray(ter.size),
             np.asarray(ter.h_max).reshape(1)]))
    assert (ts.cw_nodes.numpy().view(np.uint32)
            == np.asarray(js.cw_nodes).view(np.uint32)).all()


@pytest.mark.parametrize("fn", [tcompile, tir.Camera.look_at, tatrium.make,
                                tcornell.make, tsvgf.SVGFState.create,
                                tpipe.Accumulator.create,
                                tir.EnvMap.constant, tir.AnalyticLights.none,
                                tenv_cdf.build_env_cdf, tsponza.make,
                                tpipe.bake_tonemap_lut,
                                tneural.load_denoiser,
                                tinstances.compile_scene_instanced,
                                tterrain.make_terrain,
                                tatmosphere.bake_sky_env,
                                tdynamic.compile_dynamic_scene,
                                tasset_manager.AssetManager,
                                tvideo.register_video],
                         ids=["compile_scene", "Camera.look_at",
                              "atrium.make", "cornell.make",
                              "SVGFState.create", "Accumulator.create",
                              "EnvMap.constant", "AnalyticLights.none",
                              "build_env_cdf", "sponza_like.make",
                              "bake_tonemap_lut", "load_denoiser",
                              "compile_scene_instanced", "make_terrain",
                              "bake_sky_env", "compile_dynamic_scene",
                              "AssetManager", "register_video"])
def test_entry_points_default_to_the_card(fn):
    """The port's scene entry points build on the card unless the caller
    asks for the CPU (every CPU test passes device="cpu")."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_native_sources_are_the_jax_copies():
    """The port compiles its own copies of the JAX package's C++ builders
    (build/native/), byte for byte the JAX sources, and nothing of the
    JAX package's directory."""
    import os

    from truetrace_tpu_torch.build import native as tnative
    jdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(jcompile.__code__.co_filename))), "build", "native")
    assert os.path.dirname(tnative.SRC_DIR) == os.path.dirname(
        os.path.abspath(tnative.__file__))
    assert "truetrace_tpu_torch" in tnative.SRC_DIR.split(os.sep)
    for name in tnative.SOURCES:
        with open(os.path.join(tnative.SRC_DIR, name), "rb") as f:
            mine = f.read()
        with open(os.path.join(jdir, name), "rb") as f:
            assert mine == f.read(), name


def test_native_build_matches_jax():
    """The port's native BVH2 and CWBVH builds (its own library) give the
    JAX package's node words, leaf order and refit metadata for the same
    3000 boxes (the JAX package's Python builders, the same algorithm)."""
    from truetrace_tpu.build.bvh2 import build_bvh2 as jbvh2
    from truetrace_tpu.build.cwbvh import build_cwbvh as jcwbvh
    from truetrace_tpu_torch.build import native as tnative
    rng = np.random.default_rng(4)
    lo = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    box = np.stack([lo, lo + rng.uniform(0.01, 1.0, (3000, 3)).astype(
        np.float32)], 1)
    tb = tnative.build_bvh2_native(box, 3, 3)
    assert tb is not None, "the port's native library did not build"
    jb = jbvh2(box, max_leaf=3, sah_leaf_cap=3, use_native=False)
    for a, b in zip((jb.box, jb.left, jb.count, jb.order), tb[:4]):
        _same_bits(a, b, "bvh2")
    tc = tnative.build_cwbvh_native(*tb[:3], p_max=3)
    jc = jcwbvh(jb, box[jb.order], use_native=False)
    for f, b in zip(("nodes", "tri_index", "leaf_start"), tc[:3]):
        _same_bits(getattr(jc, f), b, f)
    for f, b in zip(("node_depth", "slot_child", "slot_tri_base",
                     "slot_tri_count"), tc[4:]):
        _same_bits(getattr(jc, f), b, f)
