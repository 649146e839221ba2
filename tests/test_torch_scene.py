"""Torch port, scene building: the port's own compile_scene (jax-free
copies of the builders and scene generators) against the JAX package's,
table for table and bit for bit; the traversal table (expand_nodes,
pack_table); the carry-across constructors; and the options the slice
does not port, which must raise."""
import numpy as np
import pytest
import torch

import truetrace_tpu.kernels.cwbvh_wavefront as jwf
from truetrace_tpu.scene import atrium as jatrium
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.kernels import cwbvh_wavefront as twf
from truetrace_tpu_torch.scene import atrium as tatrium
from truetrace_tpu_torch.scene import cornell as tcornell
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
            tm, tmat, _ = tcornell.make()
            jenv = tenv = None
        else:
            jm, jmat, _, jenv = jatrium.make(detail=detail)
            tm, tmat, _, tenv = tatrium.make(detail=detail)
        js = jcompile(jm, jmat, env=jenv, with_cwbvh=True,
                      with_light_bvh=True, leaf_k=k)
        ts = tcompile(tm, tmat, env=tenv, with_cwbvh=True,
                      with_light_bvh=True, leaf_k=k)
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
                                 "cache_dir", "atlas"])
def test_unported_build_options_raise(opt):
    m, mats, _ = tcornell.make()
    kw = dict(with_cwbvh=True)
    kw.update(dict(presplit=dict(presplit=0.5),
                   hot_order=dict(hot_order=True),
                   bvh2_only=dict(with_cwbvh=False),
                   cache_dir=dict(cache_dir="x"),
                   atlas=dict(atlas=np.zeros((4, 4, 4), np.float32)))[opt])
    _raises(lambda: tcompile(m, mats, **kw))
