"""Torch port, the JAX package's default build and BVH2 traversal:
`compile_scene(meshes, mats)` (no CWBVH) against the JAX build, table for
table and bit for bit, on the Cornell box and a small atrium; the plain
BVH2 traversal (the CPU path of closest_hit_bvh2 / any_hit_bvh2 and the
kernel's reference on the card) against the JAX `closest_hit_bvh2` /
`any_hit_bvh2` on rays made from a seed with numpy (primary,
cosine-bounce and shadow rays with per-ray t_max, dead lanes, rays with
+-0.0 components), with the default stack and a 2-entry one that
overflows, on the default build (leaves of max_leaf = 4) and on a CWBVH
build's BVH2 (max_leaf = 6); lanes whose t_max admits no hit miss as in
the JAX loop (the rule by which the kernel retires them unwalked); the
kernel's packed table (pack_bvh2_table, Scene.bvh2_table) word for word
what the JAX build's tables and the loop's clamps give; one Cornell frame
with RenderConfig()'s defaults against the JAX one, and one of a tinted
Cornell box (glass, metal and a cut-out pane: its shadow rays take
transmit_brute), whose chunks keep each ray's bits; and the options the
port renders."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.integrate.pathtrace import render_sample as jrender_sample
from truetrace_tpu.kernels.traverse_ref import any_hit_bvh2 as jany
from truetrace_tpu.kernels.traverse_ref import closest_hit_bvh2 as jclosest
from truetrace_tpu.scene import atrium as jatrium
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene import primitives as jprim
from truetrace_tpu.scene.mesh import HostMaterial as JMaterial
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.core.math import ray_tri
from truetrace_tpu_torch.integrate import pathtrace as tpt
from truetrace_tpu_torch.kernels import traverse_ref as tr
from truetrace_tpu_torch.renderer import (Renderer, RendererConfig,
                                          _scene_parts)
from truetrace_tpu_torch.scene import atrium as tatrium
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene import primitives as tprim
from truetrace_tpu_torch.scene.ir import Camera, Scene
from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from chip_smoke import glass_cornell_host
from torch_parity import close_share, leaves

# the default build's tables: every triangle column, the BVH2, the empty
# CWBVH tables, the light list and the light BVH (empty too)
TABLES = ("tri_p0", "tri_e1", "tri_e2", "tri_n", "tri_uv", "tri_tan",
          "tri_mat", "tri_lod", "tri_shadow", "bvh2_box", "bvh2_left",
          "bvh2_count", "cw_nodes", "cw_tri_index", "cw_leaf_rows",
          "lbvh_nodes", "lbvh_info", "lbvh_prim", "lbvh_trail",
          "lbvh_pairs", "lbvh_pair_children")
ATRIUM_DETAIL = 0.2


def _bits(x):
    """Any array as comparable bits: float32 as int32, ints as int64."""
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.astype(np.float32).view(np.int32)
    return x.astype(np.int64) & 0xFFFFFFFF


def _same(a, b, what):
    assert (a is None) == (b is None), what
    if a is None:
        return
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    assert np.shape(a) == np.shape(b), (what, np.shape(a), np.shape(b))
    np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)


_builds = {}


def _build(name):
    """(JAX scene, port scene, JAX camera) of compile_scene(meshes, mats)
    with its defaults in both packages."""
    if name not in _builds:
        if name == "cornell":
            jm, jmat, jcam = jcornell.make()
            tm, tmat, _ = tcornell.make(device="cpu")
            jkw = tkw = {}
        elif name == "tinted":
            jm, jmat, jcam = glass_cornell_host(JMesh, JMaterial,
                                                jcornell.make, jprim)
            tm, tmat, _ = glass_cornell_host(
                HostMesh, HostMaterial,
                lambda: tcornell.make(device="cpu"), tprim)
            jkw = tkw = {}
        else:
            jm, jmat, jcam, jenv = jatrium.make(detail=ATRIUM_DETAIL)
            tm, tmat, _, tenv = tatrium.make(detail=ATRIUM_DETAIL,
                                             device="cpu")
            jkw, tkw = dict(env=jenv), dict(env=tenv)
        _builds[name] = (jcompile(jm, jmat, **jkw),
                         tcompile(tm, tmat, device="cpu", **tkw), jcam)
    return _builds[name]


@pytest.mark.parametrize("name", ["cornell", "atrium"])
def test_default_build_matches_jax(name):
    """compile_scene(meshes, mats) without the CWBVH: every table bit for
    bit the JAX build's (triangles in BVH2 leaf order; CWBVH tables of
    shapes (0, 20), (0,) and (0, 30); cw_stack 16), the light list (the
    power CDF's) and the material table. Some of its leaves hold more
    triangles than max_leaf (the SAH may stop at up to 24)."""
    js, ts, _ = _build(name)
    for f in TABLES:
        _same(getattr(js, f), getattr(ts, f), f)
    for part in ("light_tris", "materials"):
        for f in dataclasses.fields(getattr(ts, part)):
            _same(getattr(getattr(js, part), f.name),
                  getattr(getattr(ts, part), f.name), f"{part}.{f.name}")
    assert ts.cw_nodes.shape == (0, 20) and ts.cw_leaf_rows.shape == (0, 30)
    assert ts.cw_tri_index.shape == (0,)
    assert ts.cw_stack == js.cw_stack == 16
    assert ts.has_media == js.has_media
    assert tpt._scene_max_leaf(ts, tpt.RenderConfig()) == 4
    if name == "cornell":
        assert ts.n_tris() == 36 and ts.light_tris.tri_index.shape[0] == 2
    else:
        assert int(ts.bvh2_count.max()) > 4


# ---------------------------------------------------------------------------
# the traversal
# ---------------------------------------------------------------------------

N_RAYS = 600        # rays of each kind
N_DEAD = 64


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def atrium_rays():
    """Rays made from a seed with numpy on the atrium's default build:
    primary rays from around the camera's eye into the scene, cosine
    bounce rays off their first hits (the JAX closest hit) and shadow rays
    from those hits to random points of the emissive triangles (t_max
    just short of each), dead lanes (t_max = 0) and axis-parallel rays
    whose other components are +0.0 or -0.0. Returns (ro, rd, t_max) and
    the kind of each ray."""
    js, _, jcam = _build("atrium")
    r = np.random.default_rng(11)
    c2w = np.asarray(jcam.c2w)
    eye = c2w[3, :3]
    p0, e1, e2 = (np.asarray(x) for x in (js.tri_p0, js.tri_e1, js.tri_e2))
    T = p0.shape[0]
    tid = r.integers(0, T, N_RAYS)
    b = r.uniform(0, 1, (N_RAYS, 2)).astype(np.float32)
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    target = p0[tid] + e1[tid] * b[:, :1] + e2[tid] * b[:, 1:]
    ro_p = (eye + r.normal(0, 0.05, (N_RAYS, 3))).astype(np.float32)
    rd_p = target - ro_p
    rd_p = (rd_p / np.linalg.norm(rd_p, axis=-1, keepdims=True)).astype(
        np.float32)
    h = jclosest(js.bvh2_box, js.bvh2_left, js.bvh2_count, js.tri_p0,
                 js.tri_e1, js.tri_e2, jnp.asarray(ro_p), jnp.asarray(rd_p),
                 1e30)
    hit = np.asarray(h.tri) >= 0
    t = np.where(hit, np.asarray(h.t), 1.0).astype(np.float32)
    tri = np.maximum(np.asarray(h.tri), 0)
    n = np.cross(e1[tri], e2[tri])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    n = np.where((n * rd_p).sum(-1, keepdims=True) > 0, -n, n)
    p = ro_p + rd_p * t[:, None] + n * 1e-3
    # cosine-distributed directions about the hit normal
    u1, u2 = r.uniform(0, 1, (2, N_RAYS))
    loc = np.stack([np.sqrt(u1) * np.cos(2 * np.pi * u2),
                    np.sqrt(u1) * np.sin(2 * np.pi * u2),
                    np.sqrt(1 - u1)], -1)
    a = np.where(np.abs(n[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0, 0]])
    tx = np.cross(a, n)
    tx /= np.linalg.norm(tx, axis=-1, keepdims=True)
    ty = np.cross(n, tx)
    rd_b = (loc[:, :1] * tx + loc[:, 1:2] * ty + loc[:, 2:] * n).astype(
        np.float32)
    # shadow rays to the emissive triangles
    lt = np.asarray(js.light_tris.tri_index)
    li = lt[r.integers(0, lt.shape[0], N_RAYS)]
    b = r.uniform(0, 1, (N_RAYS, 2)).astype(np.float32)
    b = np.where(b.sum(1, keepdims=True) > 1, 1 - b, b)
    lp = p0[li] + e1[li] * b[:, :1] + e2[li] * b[:, 1:]
    to_l = lp - p
    dist = np.linalg.norm(to_l, axis=-1)
    rd_s = (to_l / dist[:, None]).astype(np.float32)
    tm_s = (dist * (1 - 1e-4)).astype(np.float32)
    # dead lanes and axis-parallel rays with signed zeros
    ro_d, rd_d = ro_p[:N_DEAD], rd_p[:N_DEAD]
    k = 96
    ro_a = (eye + r.normal(0, 0.3, (k, 3))).astype(np.float32)
    rd_a = np.zeros((k, 3), np.float32)
    axis = np.arange(k) % 3
    rd_a[np.arange(k), axis] = np.where(np.arange(k) % 2, 1.0, -1.0)
    zero = np.where(r.uniform(size=(k, 3)) < 0.5, -0.0, 0.0)
    rd_a = np.where(rd_a == 0, zero, rd_a).astype(np.float32)
    assert np.signbit(rd_a[rd_a == 0]).any()
    ro = np.concatenate([ro_p, p.astype(np.float32), p.astype(np.float32),
                         ro_d, ro_a])
    rd = np.concatenate([rd_p, rd_b, rd_s, rd_d, rd_a])
    tm = np.concatenate([np.full(N_RAYS, 1e30, np.float32),
                         np.full(N_RAYS, 1e30, np.float32), tm_s,
                         np.zeros(N_DEAD, np.float32),
                         np.full(k, 1e30, np.float32)])
    kind = np.repeat(["primary", "bounce", "shadow", "dead", "axis"],
                     [N_RAYS, N_RAYS, N_RAYS, N_DEAD, k])
    return ro, rd, tm, kind


_cw = {}


def _tables(build):
    """(numpy BVH2 tables, max_leaf) of the atrium's default build or of
    its CWBVH build's BVH2 (leaves of up to leaf_k = 6, left remapped to
    the CWBVH leaf starts)."""
    if build == "default":
        js = _build("atrium")[0]
        ml = 4
    else:
        if "cw" not in _cw:
            jm, jmat, _, jenv = jatrium.make(detail=ATRIUM_DETAIL)
            _cw["cw"] = jcompile(jm, jmat, env=jenv, with_cwbvh=True)
        js = _cw["cw"]
        ml = js.cw_leaf_rows.shape[1] // 10
        assert ml == 6
    return tuple(np.asarray(x) for x in (
        js.bvh2_box, js.bvh2_left, js.bvh2_count, js.tri_p0, js.tri_e1,
        js.tri_e2)), ml


def _port_args(tabs, ro, rd, tm):
    box, left, count, p0, e1, e2 = (torch.from_numpy(np.array(x))
                                    for x in tabs)
    return (box, left.long(), count.long(), p0, e1, e2,
            torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tm))


@pytest.mark.parametrize("build", ["default", "cwbvh"])
@pytest.mark.parametrize("stack", [64, 2])
def test_bvh2_plain_matches_jax(atrium_rays, build, stack):
    """closest_hit_bvh2 / any_hit_bvh2 on CPU tensors (the plain version)
    against the JAX functions: t, u and v bit for bit on every ray, tri
    wherever t is unique among the hits, occlusion equal. A 2-entry stack
    overflows, and both lose the same subtrees (fewer hits than with 64).
    The per-ray work counters count every lane, dead ones too, and mark
    the live ones (t_max > 1e-4)."""
    ro, rd, tm, kind = atrium_rays
    tabs, ml = _tables(build)
    ja = [jnp.asarray(x) for x in tabs]
    jh = jclosest(*ja, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm),
                  max_leaf=ml, max_stack=stack)
    counts = {}
    th = tr.closest_hit_bvh2_plain(*_port_args(tabs, ro, rd, tm),
                                   max_leaf=ml, max_stack=stack,
                                   counts=counts)
    for f in ("t", "u", "v"):
        np.testing.assert_array_equal(_bits(getattr(jh, f)),
                                      _bits(getattr(th, f)), err_msg=f)
    jt, tt = np.asarray(jh.tri), th.tri.numpy()
    t = np.asarray(jh.t)
    unique = np.unique(t, return_counts=True)
    once = np.isin(t, unique[0][unique[1] == 1])
    np.testing.assert_array_equal(jt[once], tt[once])
    assert ((jt >= 0) == (tt >= 0)).all()
    assert (tt[kind == "dead"] == -1).all()
    for k in ("primary", "bounce"):
        assert (tt[kind == k] >= 0).mean() > (0.5 if stack == 64 else 0.2)
    jo = np.asarray(jany(*ja, jnp.asarray(ro), jnp.asarray(rd),
                         jnp.asarray(tm), max_leaf=ml, max_stack=stack))
    to = tr.any_hit_bvh2_plain(*_port_args(tabs, ro, rd, tm), max_leaf=ml,
                               max_stack=stack).numpy()
    np.testing.assert_array_equal(jo, to)
    assert 0.02 < to[kind == "shadow"].mean() < 0.98
    assert not to[kind == "dead"].any()
    assert (counts["pops"] >= 1).all()
    dead = torch.from_numpy(kind == "dead")
    assert counts["pops"][dead].sum() > N_DEAD
    assert torch.equal(counts["live"], torch.from_numpy(tm > 1e-4))
    assert 0 < counts["tris_touched"] <= tabs[3].shape[0]
    if stack == 2:
        full = jclosest(*ja, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(tm), max_leaf=ml)
        assert (np.asarray(full.tri) != jt).any()


def test_bvh2_wrappers_on_the_cpu():
    """On CPU tensors the wrappers run the plain version and launch
    nothing; a tensor that requires grad raises ValueError, as every
    kernel wrapper's does."""
    js, ts, _ = _build("cornell")
    r = np.random.default_rng(5)
    ro = torch.from_numpy(r.uniform(0.1, 0.4, (64, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, 64))
    args = (ts.bvh2_box, ts.bvh2_left, ts.bvh2_count, ts.tri_p0, ts.tri_e1,
            ts.tri_e2, ro, rd, 1e30)
    n0 = (tr.closest_hit_bvh2.launches, tr.any_hit_bvh2.launches)
    a = tr.closest_hit_bvh2(*args)
    b = tr.closest_hit_bvh2_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert (a.tri >= 0).float().mean() > 0.7
    assert torch.equal(tr.any_hit_bvh2(*args), tr.any_hit_bvh2_plain(*args))
    assert (tr.closest_hit_bvh2.launches, tr.any_hit_bvh2.launches) == n0
    for fn in (tr.closest_hit_bvh2, tr.any_hit_bvh2):
        with pytest.raises(ValueError, match="requires grad"):
            fn(*args[:6], ro.clone().requires_grad_(), rd, 1e30)


# t_max values that admit no hit (ray_tri takes t > 1e-4 and t < t_max):
# zero, minus zero, negative, 1e-4 itself, the float just below it, NaN
# and minus infinity
NO_HIT_T_MAX = np.array([0.0, -0.0, -1.0, 1e-4,
                         np.nextafter(np.float32(1e-4), np.float32(0)),
                         np.nan, -np.inf], np.float32)


def test_dead_lanes_miss_as_in_jax():
    """Rays that hit the Cornell box with t_max = 1e30 miss with every
    t_max in NO_HIT_T_MAX, through the JAX closest_hit_bvh2 /
    any_hit_bvh2 and the port's plain version: t keeps t_max's bits (NaN
    and -0.0 included), tri is -1, u = v = +0.0, nothing is blocked. The
    kernel writes this answer for such a lane without walking it."""
    js, _, _ = _build("cornell")
    tabs = tuple(np.asarray(getattr(js, f)) for f in (
        "bvh2_box", "bvh2_left", "bvh2_count", "tri_p0", "tri_e1",
        "tri_e2"))
    r = np.random.default_rng(13)
    n = 48
    ro = np.tile(r.uniform(0.1, 0.4, (n, 3)).astype(np.float32),
                 (len(NO_HIT_T_MAX), 1))
    rd = np.tile(_unit(r, n), (len(NO_HIT_T_MAX), 1))
    tm = np.repeat(NO_HIT_T_MAX, n)
    far = np.full_like(tm, 1e30)
    assert (tr.closest_hit_bvh2_plain(*_port_args(tabs, ro, rd, far)).tri
            >= 0).float().mean() > 0.7
    ja = [jnp.asarray(x) for x in tabs]
    jargs = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm))
    for h in (jclosest(*ja, *jargs),
              tr.closest_hit_bvh2_plain(*_port_args(tabs, ro, rd, tm))):
        np.testing.assert_array_equal(_bits(h.t), _bits(tm))
        assert (np.asarray(h.tri) == -1).all()
        assert (_bits(h.u) == 0).all() and (_bits(h.v) == 0).all()
    assert not np.asarray(jany(*ja, *jargs)).any()
    assert not tr.any_hit_bvh2_plain(*_port_args(tabs, ro, rd, tm)).any()


def _check_table(table, box, left, count, p0, e1, e2, max_leaf):
    """The packed table against the BVH2 (numpy arrays): the triangle
    rows hold p0, e1, e2 and zeros; row i < N starts with node i's box
    and its entry; a leaf's entry gives every triangle id the loop takes
    (clamp(left + j, 0, T - 1), j < min(max_leaf, count)); an internal
    node's names the row that holds the boxes and entries of the
    children the loop slab-tests, clamp(left) and clamp(left + 1) into
    0..N - 1; row 0's first entry is the root's."""
    N, T = box.shape[0], p0.shape[0]
    w = table.numpy()
    assert table.dtype == torch.int32 and w.shape == (16 * (N + 1)
                                                       + 12 * T,)
    pairs = w[:16 * (N + 1)].reshape(N + 1, 16)
    tris = w[16 * (N + 1):].reshape(T, 12)
    np.testing.assert_array_equal(tris[:, :9], _bits(np.concatenate(
        [p0, e1, e2], 1)))
    assert (tris[:, 9:] == 0).all()
    bx = _bits(box.reshape(N, 6))
    np.testing.assert_array_equal(pairs[:N, :6], bx)
    ent = pairs[:N, 12:14].astype(np.int64)
    left, count = left.astype(np.int64), count.astype(np.int64)
    leaf = count > 0
    np.testing.assert_array_equal(ent[leaf, 1], np.minimum(count[leaf],
                                                           2 ** 31 - 1))
    js = np.arange(max_leaf)
    np.testing.assert_array_equal(
        np.clip(ent[leaf, :1] + js, 0, T - 1),
        np.clip(left[leaf, None] + js, 0, T - 1))
    assert (ent[~leaf, 1] == 0).all()
    rows = pairs[ent[~leaf, 0]]
    c0 = np.clip(left[~leaf], 0, N - 1)
    c1 = np.clip(left[~leaf] + 1, 0, N - 1)
    np.testing.assert_array_equal(rows[:, :6], bx[c0])
    np.testing.assert_array_equal(rows[:, 6:12], bx[c1])
    np.testing.assert_array_equal(rows[:, 12:14], ent[c0])
    np.testing.assert_array_equal(rows[:, 14:16], ent[c1])


@pytest.mark.parametrize("build", ["default", "cwbvh"])
def test_bvh2_table_matches_jax_build(build):
    """pack_bvh2_table of the JAX build's BVH2 (the default build, and a
    CWBVH build's, whose leaves start at the CWBVH leaf rows): every word
    the kernel reads, against the JAX tables (_check_table)."""
    tabs, ml = _tables(build)
    table = tr.pack_bvh2_table(*(torch.from_numpy(np.array(x))
                                 for x in tabs))
    _check_table(table, *tabs, ml)


def test_bvh2_table_clamps():
    """A hand-made BVH2 whose lefts leave the table: internal nodes
    pointing before node 0, at the last node and past it; leaves starting
    before triangle 0 and past the last one, and a count beyond int32
    (and a negative count: an internal node). Every word the kernel
    reads gives what the loop's clamps give (_check_table), at leaves of
    1 to 6."""
    r = np.random.default_rng(3)
    N, T = 10, 5
    lo = r.normal(size=(N, 3)).astype(np.float32)
    box = np.stack([lo, lo + r.uniform(0.1, 1, (N, 3))], 1).astype(
        np.float32)
    left = np.array([1, -1, -7, 9, 12, -3, 2 ** 40, 3, 4, 2], np.int64)
    count = np.array([0, 0, 0, 0, 0, 2, 3, 2 ** 35, -2, 4], np.int64)
    p0, e1, e2 = (r.normal(size=(T, 3)).astype(np.float32)
                  for _ in range(3))
    tabs = (box, left, count, p0, e1, e2)
    table = tr.pack_bvh2_table(*(torch.from_numpy(x) for x in tabs))
    for ml in range(1, 7):
        _check_table(table, *tabs, ml)
    pairs = table[:16 * (N + 1)].view(N + 1, 16)
    assert pairs[N, :6].equal(pairs[N, 6:12]) and int(pairs[1, 12]) == N
    assert tr.pack_bvh2_table(*(torch.from_numpy(x[:0]) for x in tabs)
                              ).shape == (0,)


def test_scene_caches_bvh2_table():
    """Scene.bvh2_table packs once and keeps it (the graph's scene copy
    carries it: it is among _scene_parts' tensors); the CPU wrappers take
    it and still run the plain version."""
    _, ts, _ = _build("cornell")
    ts = dataclasses.replace(ts, _bvh2_table=None)
    table = ts.bvh2_table()
    assert ts.bvh2_table() is table
    assert torch.equal(table, tr.pack_bvh2_table(*tpt._bvh2(ts)))
    assert "_bvh2_table" in [n for n, _ in _scene_parts(ts)[0]]
    r = np.random.default_rng(5)
    ro = torch.from_numpy(r.uniform(0.1, 0.4, (64, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, 64))
    args = (*tpt._bvh2(ts), ro, rd, 1e30)
    a = tr.closest_hit_bvh2(*args, table=table)
    assert all(torch.equal(x, y) for x, y in zip(
        a, tr.closest_hit_bvh2_plain(*args)))
    assert torch.equal(tr.any_hit_bvh2(*args, table=table),
                       tr.any_hit_bvh2_plain(*args))


# ---------------------------------------------------------------------------
# the frame with RenderConfig()'s defaults
# ---------------------------------------------------------------------------

def test_cornell_default_frame_matches_jax():
    """render_sample on compile_scene(meshes, mats) with RenderConfig()'s
    defaults (bvh2, Lambert, power-CDF NEE, 4 bounces) at 16x16, one
    sample, against the JAX package's: as the Cornell frames of
    tests/test_torch_frame.py, >= 99% of pixels within rtol 1e-4 / atol
    1e-5 and the image means within rtol 1e-4 (the traversal is bitwise;
    transcendentals and contracted mul-adds differ in the last ulps). The
    Renderer takes traversal="bvh2" too."""
    js, ts, jcam = _build("cornell")
    tcam = Camera.from_numpy(leaves(jcam), "cpu")
    W = H = 16
    jr = np.asarray(jrender_sample(js, jcam, JRenderConfig(width=W,
                                                           height=H), 0))
    cfg = tpt.RenderConfig(width=W, height=H)
    assert cfg.traversal == "bvh2" and cfg.bsdf == "lambert"
    trr = tpt.render_sample(ts, tcam, cfg, 0).numpy()
    assert np.isfinite(trr).all() and trr.mean() > 0.01
    assert close_share(jr, trr, 1e-4, 1e-5) >= 0.99
    np.testing.assert_allclose(jr.mean(0), trr.mean(0), rtol=1e-4)
    rend = Renderer(ts, tcam, RendererConfig(
        width=8, height=8, bounces=2, traversal="bvh2",
        light_sampling="cdf", denoiser="svgf"))
    disp, _, st = rend.step(rend.init_state())
    assert bool(torch.isfinite(disp).all()) and st.sample == 1


def test_tinted_default_frame_matches_jax(monkeypatch):
    """A tinted scene with compile_scene's and RenderConfig()'s defaults:
    chip_smoke's glass Cornell box (a glass and a metal sphere, a cut-out
    pane) builds a tri_shadow table, so with traversal="bvh2" its NEE
    shadow rays take transmit_brute, as the JAX package's do. render_sample
    at 16x16, one sample, against the JAX package's at the Cornell
    frame's tolerance: >= 99% of pixels within rtol 1e-4 / atol 1e-5, the
    image means within rtol 1e-4."""
    js, ts, jcam = _build("tinted")
    assert ts.tri_shadow is not None and js.tri_shadow is not None
    _same(js.tri_shadow, ts.tri_shadow, "tri_shadow")
    tcam = Camera.from_numpy(leaves(jcam), "cpu")
    W = H = 16
    jr = np.asarray(jrender_sample(js, jcam, JRenderConfig(width=W,
                                                           height=H), 0))
    calls = []

    def recorded(*a, **k):
        calls.append(tr.transmit_brute(*a, **k))
        return calls[-1]

    monkeypatch.setattr(tpt, "transmit_brute", recorded)
    trr = tpt.render_sample(ts, tcam, tpt.RenderConfig(width=W, height=H),
                            0).numpy()
    tp = torch.cat(calls)
    assert ((tp.amax(-1) > 1e-3) & (tp.amax(-1) < 0.999)).any()
    assert np.isfinite(trr).all() and trr.mean() > 0.01
    assert close_share(jr, trr, 1e-4, 1e-5) >= 0.99
    np.testing.assert_allclose(jr.mean(0), trr.mean(0), rtol=1e-4)


def test_transmit_brute_chunks_keep_bits(monkeypatch):
    """transmit_brute with BRUTE_CHUNK lowered, so that the rays go in
    chunks of 4 and of 37 rows, against one unchunked call: bit for bit.
    The rays rise from the floor through the spheres and the cut-out
    pane, so many cross three or more tinted triangles, where the order
    of a sum of logs shows in its bits."""
    _, ts, _ = _build("tinted")
    r = np.random.default_rng(3)
    R = 2000
    ro = np.stack([r.uniform(0.05, 0.5, R), np.full(R, 0.005),
                   r.uniform(0.05, 0.5, R)], -1).astype(np.float32)
    rd = np.array([0.0, 1.0, 0.0]) + r.normal(0, 0.15, (R, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tm = r.uniform(0.35, 0.5, R).astype(np.float32)   # below the ceiling
    args = (ts.tri_p0, ts.tri_e1, ts.tri_e2, ts.tri_shadow,
            *(torch.from_numpy(x) for x in (ro, rd, tm)))
    T = ts.n_tris()
    assert R * T < tr.BRUTE_CHUNK
    h, t, _, _ = ray_tri(args[4][:, None], args[5][:, None], ts.tri_p0[None],
                         ts.tri_e1[None], ts.tri_e2[None], args[6][:, None])
    tinted = (ts.tri_shadow < 1).any(-1)
    crossed = (h & (t < args[6][:, None]) & tinted[None]).sum(1)
    assert int((crossed >= 3).sum()) > 100
    whole = tr.transmit_brute(*args)
    assert int(((whole > 0) & (whole < 0.999)).all(-1).sum()) > 50
    for rows in (4, 37):
        monkeypatch.setattr(tr, "BRUTE_CHUNK", rows * T)
        got = tr.transmit_brute(*args)
        assert torch.equal(got.view(torch.int32), whole.view(torch.int32))


@pytest.mark.parametrize("traversal,raises", [
    ("bvh2", None), ("wavefront", None), ("brute", NotImplementedError),
    ("cwbvh", NotImplementedError)])
def test_check_supported_takes_bvh2(traversal, raises):
    """check_supported accepts "bvh2" on the default build (and on a
    CWBVH build); "brute" and "cwbvh" still raise naming ROADMAP.md A.19;
    "wavefront" needs a CWBVH build."""
    _, ts, _ = _build("cornell")
    cfg = tpt.RenderConfig(traversal=traversal)
    if raises is not None:
        with pytest.raises(raises, match="ROADMAP.md A.19"):
            tpt.check_supported(ts, cfg)
        return
    cw = Scene.from_numpy(leaves(jcompile(*jcornell.make()[:2],
                                          with_cwbvh=True)), "cpu")
    tpt.check_supported(cw, cfg)
    if traversal == "bvh2":
        tpt.check_supported(ts, cfg)
        assert tpt._scene_max_leaf(cw, cfg) == 6
    else:
        with pytest.raises(ValueError, match="with_cwbvh=True"):
            tpt.check_supported(ts, cfg)
