"""Torch port, animated scenes: skinning, the CWBVH and light-BVH refit,
the device leaf-row / pair-row / light-row rebuilds, pose_scene and the
light-tree descent without a cut, against the JAX package.

Bit for bit: skin_vertices (XLA:CPU's contracted mul-adds written as
fma), XLA's log2 / exp2 that decide the refit's exponent bytes, the
refit's node words, pack_leaf_rows_torch, build_pairs_torch and every
table pose_scene writes. Within a tolerance: bone_matrix (3e-7: cos
and sin), refit_light_bvh (its cones go through arccos / cos / sin:
3e-7) and the descent and its pdf from the root (rtol 4e-6, every pick
equal); the integrator's light sampling and MIS pdf with the light
cut or the light rows taken out. The first frame's sample, and three
posed frames through the
Renderer with SVGF, the pose and the camera moving every frame, against
one eager JAX Renderer (its render_sample_with_stats jitted where the
renderer looks it up, by pytest's monkeypatch): the display within 1e-3
on every pixel, every FrameState tensor to rtol 1e-4 / atol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.build import lightbvh as jlbvh
from truetrace_tpu.build import refit as jrefit
from truetrace_tpu.integrate import pathtrace as jpathtrace
from truetrace_tpu.kernels import lighttree as jlt
from truetrace_tpu.scene import dynamic as jdyn
from truetrace_tpu.scene import skinning as jskin
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import HostMaterial as JMat
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu_torch.build import lightbvh as tlbvh
from truetrace_tpu_torch.build import refit as trefit
from truetrace_tpu_torch.core.math import exp2_xla, log2_xla
from truetrace_tpu_torch.integrate import pathtrace as tpathtrace
from truetrace_tpu_torch.integrate.pathtrace import render_sample_with_stats
from truetrace_tpu_torch.kernels import cwbvh_wavefront as twf
from truetrace_tpu_torch.kernels import lighttree as tlt
from truetrace_tpu_torch.renderer import (Renderer, RendererConfig,
                                          _scene_parts, _tensors)
from truetrace_tpu_torch.scene import dynamic as tdyn
from truetrace_tpu_torch.scene import skinning as tskin
from truetrace_tpu_torch.scene.ir import Camera, light_bvh_depth
from truetrace_tpu_torch.scene.mesh import HostMaterial as TMat
from truetrace_tpu_torch.scene.mesh import HostMesh as TMesh

from torch_parity import check_sample, close_share, leaves

TOL = dict(rtol=1e-4, atol=1e-5)
# (rot axis, angle) of bone 0 and bone 1 per pose; bone 1 sits at half
# height, as the cylinder's inverse bind expects
POSES = (((0, 0, 1), 0.0, (1, 0, 0), 0.0),
         ((0, 0, 1), 0.15, (1, 0, 0), 0.8),
         ((0, 1, 0), -0.1, (0, 0, 1), 1.3))
# the JAX package's dynamic-scene frames take the Lambert BSDF
# (tests/test_dynamic_scene.py); light-tree NEE through the cut
FRAME = dict(width=16, height=16, bounces=2, bsdf="lambert",
             traversal="wavefront", light_sampling="tree", denoiser="svgf")
# the frames' poses: bent first, so the recorded first sample is posed
FRAME_POSES = (POSES[1], POSES[2], POSES[0])
MOVES = ((0.0, 0.0), (0.2, 0.1), (0.4, 0.15))   # the eye's x and y offset


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.itemsize == 4 else a


def _same(want, got, what):
    want, got = np.asarray(want), got.cpu().numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype.kind == "f":
        assert (_bits(want) == _bits(got)).all(), (
            what, int((_bits(want) != _bits(got)).sum()))
    else:
        assert ((want.astype(np.int64) & 0xFFFFFFFF)
                == (got.astype(np.int64) & 0xFFFFFFFF)).all(), what


def _bones(pkg, pose):
    (a0, t0, a1, t1) = pose
    if pkg == "jax":
        return jnp.stack([jskin.bone_matrix(a0, t0, (0, 0, 0)),
                          jskin.bone_matrix(a1, t1, (0, 1.0, 0))])
    return torch.stack([tskin.bone_matrix(a0, t0, (0, 0, 0), device="cpu"),
                        tskin.bone_matrix(a1, t1, (0, 1.0, 0),
                                          device="cpu")])


def _setup(pkg):
    """tests/test_dynamic_scene.py's scene by one package: a floor, a
    downward emissive quad and the two-bone cylinder, with the light BVH
    and its cut."""
    mesh_cls, mat_cls = (JMesh, JMat) if pkg == "jax" else (TMesh, TMat)
    mats = [mat_cls(base_color=(0.7, 0.7, 0.7)),
            mat_cls(base_color=(0.6, 0.3, 0.2), roughness=0.4),
            mat_cls(emission=(10.0, 10.0, 10.0))]
    floor = mesh_cls(np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4],
                               [-4, 0, 4]], np.float32),
                     np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     np.zeros(2, np.int32))
    light = mesh_cls(np.array([[-1, 3.2, -1], [1, 3.2, -1], [1, 3.2, 1],
                               [-1, 3.2, 1], [2, 2.6, 0], [3, 2.6, 0],
                               [3, 2.6, 1]], np.float32),
                     np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6]], np.int32),
                     np.full(3, 2, np.int32))
    if pkg == "jax":
        mesh = jskin.make_two_bone_cylinder(n_radial=10, n_height=12)
        dyn = jdyn.compile_dynamic_scene(mesh, 1, mats,
                                         static_meshes=[floor, light],
                                         with_light_bvh=True)
        cam = JCamera.look_at(eye=(0, 2.5, 5.5), target=(0, 1.0, 0),
                              fov_y_deg=45)
    else:
        mesh = tskin.make_two_bone_cylinder(n_radial=10, n_height=12,
                                            device="cpu")
        dyn = tdyn.compile_dynamic_scene(mesh, 1, mats,
                                         static_meshes=[floor, light],
                                         with_light_bvh=True, device="cpu")
        cam = Camera.look_at(eye=(0, 2.5, 5.5), target=(0, 1.0, 0),
                             fov_y_deg=45, device="cpu")
    return dyn, cam


@pytest.fixture(scope="module")
def dyns():
    return _setup("jax"), _setup("torch")


_JPOSE = {}


def _jpose(jd, pose):
    """JAX pose_scene under one jit (its eager op-by-op run gives the same
    bits; jit saves compiling every refit level's ops for each shape)."""
    if id(jd) not in _JPOSE:
        _JPOSE[id(jd)] = jax.jit(lambda b: jdyn.pose_scene(jd, b))
    return _JPOSE[id(jd)](_bones("jax", pose))


def _moved(cam, k, cls, arr):
    c2w = np.asarray(cam.c2w).copy()
    c2w[3, 0] += MOVES[k][0]
    c2w[3, 1] += MOVES[k][1]
    return cls(c2w=arr(c2w), fov_y=cam.fov_y, aperture=cam.aperture,
               focus_dist=cam.focus_dist)


@pytest.fixture(scope="module")
def run(dyns):
    """Three posed frames of a fresh eager JAX Renderer (the pose and the
    camera moving every frame): [(display, radiance, state leaves)]."""
    (jd, jcam), _ = dyns
    scenes = [_jpose(jd, p) for p in FRAME_POSES]
    jr = jrenderer.Renderer(scenes[0], jcam,
                            jrenderer.RendererConfig(**FRAME))
    traced = jax.jit(jpathtrace.render_sample_with_stats,
                     static_argnames=("cfg",))

    calls = []

    def render(scene, cam, cfg, pixel, sample_id, **k):
        out = traced(scene, cam, cfg=cfg, pixel=pixel,
                     sample_id=jnp.asarray(sample_id, jnp.uint32), **k)
        calls.append((pixel, sample_id, out))
        return out

    frames = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_sample_with_stats", render)
        st = jr.init_state()
        for i in range(3):
            kw = dict(cam=_moved(jcam, i, JCamera, jnp.asarray),
                      cam_moved=True, scene=scenes[i]) if i else {}
            disp, acc, st = jr.step(st, **kw)
            frames.append((np.asarray(disp), np.asarray(acc), leaves(st)))
    return dict(frames=frames, first_call=calls[0])


def test_xla_log2_exp2_are_bitwise():
    """log2_xla / exp2_xla give jnp.log2 / jnp.exp2's bits near every
    power of two and at random, where torch.log2 moves ceil(log2) on
    ~1% of the values near powers of two."""
    rng = np.random.default_rng(5)
    k = rng.integers(-100, 100, 40_000)
    x = (np.ldexp(np.float32(1), k).astype(np.float32).view(np.int32)
         + rng.integers(-64, 64, k.size).astype(np.int32)).view(np.float32)
    x = np.concatenate([x, rng.uniform(1e-6, 1e3, 20_000).astype(
        np.float32)])
    want = np.asarray(jnp.log2(jnp.asarray(x)))
    assert (_bits(want) == _bits(log2_xla(torch.from_numpy(x)))).all()
    ceil_t = torch.ceil(torch.log2(torch.from_numpy(x))).numpy()
    assert (ceil_t != np.ceil(want)).any()
    n = np.concatenate([np.arange(-140, 140), rng.uniform(
        -120, 120, 20_000)]).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(n)))
    assert (_bits(want) == _bits(exp2_xla(torch.from_numpy(n)))).all()


def test_skinning_matches_jax():
    """make_two_bone_cylinder's tables exactly; bone_matrix to atol 3e-7
    (its cos and sin); skin_vertices bit for bit on the same bones, with
    random inverse binds, and the
    cylinder's bone indices 2 and 3 clamped to the last bone (a negative
    index counts from the end)."""
    jm = jskin.make_two_bone_cylinder(12, 16)
    tm = tskin.make_two_bone_cylinder(12, 16, device="cpu")
    for f in jm._fields:
        assert (np.asarray(getattr(jm, f)) == getattr(tm, f).numpy()).all(), f
    rng = np.random.default_rng(0)
    inv = np.asarray(jm.inv_bind) + rng.normal(
        size=(2, 3, 4)).astype(np.float32) * 0.3
    idx = np.asarray(jm.bone_idx).copy()
    idx[::7, 3] = -1
    jm = jm._replace(inv_bind=jnp.asarray(inv), bone_idx=jnp.asarray(idx))
    tm = tm._replace(inv_bind=torch.from_numpy(inv),
                     bone_idx=torch.from_numpy(idx).long())
    for s in range(3):
        args = (rng.normal(size=3), rng.uniform(-2, 2), rng.normal(size=3))
        a2 = (rng.normal(size=3), rng.uniform(-2, 2), rng.normal(size=3))
        jb = jnp.stack([jskin.bone_matrix(*args), jskin.bone_matrix(*a2)])
        tb = torch.stack([tskin.bone_matrix(*args, device="cpu"),
                          tskin.bone_matrix(*a2, device="cpu")])
        # cos and sin differ from XLA's in their last bits
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=3e-7)
        tb = torch.from_numpy(np.asarray(jb))
        _same(jskin.skin_vertices(jm, jb), tskin.skin_vertices(tm, tb),
              f"skin_vertices {s}")
        for a, b in zip(jskin.skinned_tris(jm, jb),
                        tskin.skinned_tris(tm, tb)):
            _same(a, b, "skinned_tris")


@pytest.mark.parametrize("pose", [0, 1], ids=["identity", "deformed"])
def test_refit_cwbvh_matches_jax(dyns, pose):
    """refit_cwbvh's node words on the cylinder among the static meshes,
    at the rest pose and bent, against the JAX refit's (the nodes of the
    JAX pose_scene, which refits the rest nodes for the posed triangles),
    its root box the exact bounds of every triangle, and
    pack_leaf_rows_torch's rows (and the numpy pack_leaf_rows') against
    pack_leaf_rows_jax's (the JAX pose's leaf rows), bit for bit."""
    (jd, _), (td, _) = dyns
    js = _jpose(jd, POSES[pose])
    t = lambda a: torch.from_numpy(np.asarray(a))
    p0, e1, e2 = (t(getattr(js, f)) for f in ("tri_p0", "tri_e1", "tri_e2"))
    tn, troot = trefit.refit_cwbvh(
        td.scene.cw_nodes, p0, e1, e2, td.slot_child, td.slot_tri_base,
        td.slot_tri_count, td.levels)
    _same(js.cw_nodes, tn, "nodes")
    v = torch.cat([p0, p0 + e1, p0 + e2])
    assert torch.equal(troot, torch.stack([v.amin(0), v.amax(0)]))
    assert len(td.levels) == len(jd.levels)
    _same(js.cw_leaf_rows, twf.pack_leaf_rows_torch(
        td.flat_base, td.flat_count, p0, e1, e2), "rows")
    _, rows_np = twf.pack_leaf_rows(
        np.asarray(jd.scene.cw_nodes), np.asarray(jd.slot_tri_base),
        np.asarray(jd.slot_tri_count), p0.numpy(), e1.numpy(), e2.numpy())
    _same(js.cw_leaf_rows, t(rows_np), "numpy rows")
    if pose == 0:
        # at the rest pose the refit keeps the builder's bounds
        _same(jd.scene.cw_leaf_rows, t(rows_np), "rest rows")


def test_pose_scene_tables_match_jax(dyns):
    """Every table pose_scene writes (nodes, leaf rows, tri_p0/e1/e2,
    tri_n, the light rows) bit for bit over three poses; the result is a
    new scene of the same shapes with its traversal table unpacked, and
    the rest scene is unchanged."""
    (jd, _), (td, _) = dyns
    rest = {k: v.clone() for k, v in _scene_parts(td.scene)[0]}
    td.scene.cw_table()
    for p in POSES:
        js = _jpose(jd, p)
        ts = tdyn.pose_scene(td, _bones("torch", p))
        assert ts is not td.scene and ts._cw_table is None
        for f in ("cw_nodes", "cw_leaf_rows", "tri_p0", "tri_e1", "tri_e2",
                  "tri_n"):
            _same(getattr(js, f), getattr(ts, f), f)
            assert getattr(ts, f).shape == getattr(td.scene, f).shape
        _same(js.light_tris.rows, ts.light_tris.rows, "light rows")
    for k, v in _scene_parts(td.scene)[0]:
        assert torch.equal(v.view(torch.int32) if v.dtype == torch.float32
                           else v, rest[k].view(torch.int32)
                           if v.dtype == torch.float32 else rest[k]), k


def _light_scene(n_lights=24, seed=3):
    """tests/test_light_refit.py's lights, moved and turned after the
    build."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-5, 5, (n_lights, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, (n_lights, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, (n_lights, 3)).astype(np.float32)
    ids = np.arange(n_lights, dtype=np.int32)
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    power = (area * rng.uniform(1, 5, n_lights)).astype(np.float32)
    lb = jlbvh.build_light_bvh(dict(p0=p0, e1=e1, e2=e2), ids, power)
    ang = 0.5
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    moved = dict(p0=p0 @ R.T + np.array([1.0, 0.5, -2.0], np.float32),
                 e1=e1 @ R.T, e2=e2 @ R.T)
    return lb, moved, ids, power


@pytest.fixture(scope="module")
def light_refit():
    lb, moved, ids, power = _light_scene()
    levels = jrefit.light_level_worklists(lb.info)
    jn = np.asarray(jax.jit(lambda *a: jrefit.refit_light_bvh(
        a[0], lb.info, lb.prim, *a[1:4], ids, a[4], levels))(
            jnp.asarray(lb.nodes), jnp.asarray(moved["p0"]),
            jnp.asarray(moved["e1"]), jnp.asarray(moved["e2"]),
            jnp.asarray(power)))
    t = lambda a: torch.from_numpy(np.asarray(a))
    tn = trefit.refit_light_bvh(
        t(lb.nodes), t(lb.info).long(), t(lb.prim).long(), t(moved["p0"]),
        t(moved["e1"]), t(moved["e2"]), t(ids).long(), t(power),
        trefit.light_level_worklists(lb.info, "cpu"))
    return lb, moved, ids, power, jn, tn


def test_refit_light_bvh_matches_jax(light_refit):
    """The refit light nodes against JAX's (bounds and power exactly,
    cones to rtol 1e-5 / atol 2e-6), conservative over every light (the
    JAX test's check run on the port's nodes), and build_pairs_torch bit
    for bit build_pairs_jax."""
    from tests.test_light_refit import _check_conservative
    lb, moved, ids, power, jn, tn = light_refit
    got = tn.numpy()
    assert (_bits(got[:, [0, 1, 2, 3, 4, 5, 10, 11]])
            == _bits(jn[:, [0, 1, 2, 3, 4, 5, 10, 11]])).all()
    np.testing.assert_allclose(got[:, 6:10], jn[:, 6:10], rtol=0,
                               atol=3e-7)
    _check_conservative(got, lb.info, lb.prim, moved, ids)
    pairs0, children = jlbvh.build_pairs(lb.nodes, lb.info)
    t = lambda a: torch.from_numpy(np.asarray(a))
    _same(jlbvh.build_pairs_jax(jnp.asarray(jn), jnp.asarray(pairs0),
                                jnp.asarray(children)),
          tlbvh.build_pairs_torch(t(jn), t(pairs0), t(children).long()),
          "pairs")
    p, n = np.array([[0.5, 1.0, -0.5]], np.float32), np.array(
        [[0, 1, 0]], np.float32)
    np.testing.assert_allclose(
        tlt.node_importance(t(jn), torch.arange(jn.shape[0]), t(p), t(n)),
        np.asarray(jlt.node_importance(jnp.asarray(jn), jnp.arange(
            jn.shape[0]), jnp.asarray(p), jnp.asarray(n))), rtol=1e-5)


def test_light_tree_descent_matches_jax(light_refit):
    """sample_light_tree and light_tree_pdf from the root over the refit
    tree's pair rows, against JAX's: the pick equal on every lane, pmf
    and pdf to rtol 4e-6, and the
    port's pmf equal to its own pdf (the sampler / pdf pair MIS needs)."""
    lb, _, _, _, jn, _ = light_refit
    pairs0, children = jlbvh.build_pairs(lb.nodes, lb.info)
    jp = jlbvh.build_pairs_jax(jnp.asarray(jn), jnp.asarray(pairs0),
                               jnp.asarray(children))
    rng = np.random.default_rng(1)
    K = 512
    p = rng.uniform(-6, 6, (K, 3)).astype(np.float32)
    n = rng.normal(size=(K, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u = rng.uniform(0, 1, K).astype(np.float32)
    j_idx, j_pmf, _ = jlt.sample_light_tree(jp, jnp.asarray(lb.prim),
                                            jnp.asarray(p), jnp.asarray(n),
                                            jnp.asarray(u))
    j_pdf = jlt.light_tree_pdf(jp, jnp.asarray(lb.trail), j_idx,
                               jnp.asarray(p), jnp.asarray(n))
    t = lambda a: torch.from_numpy(np.asarray(a))
    depth = light_bvh_depth(lb.info)
    trail = t(np.asarray(lb.trail).view(np.int32))
    t_idx, t_pmf, _ = tlt.sample_light_tree(t(jp), t(lb.prim).long(), t(p),
                                            t(n), t(u), depth=depth)
    assert (t_idx.numpy() == np.asarray(j_idx)).all()
    np.testing.assert_allclose(t_pmf.numpy(), np.asarray(j_pmf), rtol=4e-6)
    t_pdf = tlt.light_tree_pdf(t(jp), trail, t(np.asarray(j_idx)).long(),
                               t(p), t(n), depth=depth)
    np.testing.assert_allclose(t_pdf.numpy(), np.asarray(j_pdf), rtol=4e-6)
    own = tlt.light_tree_pdf(t(jp), trail, t_idx, t(p), t(n), depth=depth)
    np.testing.assert_allclose(t_pmf.numpy(), own.numpy(), rtol=1e-6)
    assert (t_pmf.numpy() > 0).all()


def test_posed_sample_matches_jax(dyns, run):
    """The first frame's sample of a bent pose (sample id 0, every
    pixel; light-tree NEE through the cut and the light rows) against
    the one the JAX Renderer traced, recorded on the way."""
    _, (td, tcam) = dyns
    pixel, sid, (jr, jst) = run["first_call"]
    assert int(sid) == 0
    ts = tdyn.pose_scene(td, _bones("torch", FRAME_POSES[0]))
    rcfg = Renderer(ts, tcam, RendererConfig(**FRAME)).rcfg
    tr, tst = render_sample_with_stats(ts, tcam, rcfg, torch.from_numpy(
        np.asarray(pixel)).long(), 0)
    check_sample(jr, jst, tr, tst, 0.99)
    assert float(tst["n_shadow"]) > 0


_NO_CUT = dict(lcut_bounds=None, lcut_link=None, lcut_node_ids=None,
               lcut_of_light=None, lcut_skip=None)


@pytest.mark.parametrize("drop", ["cut", "rows", "both"])
def test_light_sampling_without_cut_or_rows_matches_jax(dyns, drop):
    """The integrator's light sampling and its MIS pdf on a bent pose
    with the light cut, the packed light rows or both taken out of both
    packages' scenes (the descent from the root; the light's triangle
    from the triangle tables): picks, points, normals, radiance and
    validity equal, the pdfs to rtol 1e-5."""
    (jd, _), (td, _) = dyns
    js = _jpose(jd, POSES[1])
    ts = tdyn.pose_scene(td, _bones("torch", POSES[1]))
    if drop in ("cut", "both"):
        js, ts = js.replace(**_NO_CUT), dataclasses.replace(ts, **_NO_CUT)
    if drop in ("rows", "both"):
        js = js.replace(light_tris=js.light_tris.replace(rows=None))
        ts = dataclasses.replace(ts, light_tris=dataclasses.replace(
            ts.light_tris, rows=None))
    rng = np.random.default_rng(7)
    R = 512
    p = rng.uniform([-3, 0, -3], [3, 2.5, 3], (R, 3)).astype(np.float32)
    sn = np.tile(np.float32([0, 1, 0]), (R, 1))
    u_sel = rng.uniform(0, 1, R).astype(np.float32)
    u2 = rng.uniform(0, 1, (R, 2)).astype(np.float32)

    def jfn(scene, p, sn, u_sel, u2):
        ls = jpathtrace.sample_light_tris(scene, p, u_sel, u2, sn=sn,
                                          use_tree=True)
        pdf = jpathtrace.light_pdf_sa(
            scene, scene.light_tris.tri_index[jnp.arange(R) % 3], p,
            ls.pos, jnp.abs(ls.pdf_sa) * 0 + 0.5, sn_prev=sn, use_tree=True)
        return ls, pdf
    jls, jpdf = jax.jit(jfn)(js, *map(jnp.asarray, (p, sn, u_sel, u2)))
    t = torch.from_numpy
    tls = tpathtrace.sample_light_tris(ts, t(p), t(u_sel), t(u2), sn=t(sn),
                                       use_tree=True)
    tpdf = tpathtrace.light_pdf_sa(
        ts, ts.light_tris.tri_index[torch.arange(R) % 3], t(p), tls.pos,
        torch.full((R,), 0.5), sn_prev=t(sn), use_tree=True)
    # the point's mul-adds are contracted on XLA's side: an ulp
    np.testing.assert_allclose(tls.pos.numpy(), np.asarray(jls.pos), rtol=0,
                               atol=2e-7)
    for f in ("normal", "radiance", "valid"):
        _same(getattr(jls, f), getattr(tls, f), f)
    np.testing.assert_allclose(tls.pdf_sa.numpy(), np.asarray(jls.pdf_sa),
                               rtol=5e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=5e-6)
    assert bool(tls.valid.any()) and bool((tpdf > 0).any())


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def test_posed_frames_match_jax(dyns, run):
    """Three frames through the port's Renderer, each handed its posed
    scene and moved camera: the display within 1e-3 on every pixel, the
    accumulation and every FrameState tensor to rtol 1e-4 / atol 1e-5,
    integers exactly."""
    _, (td, tcam) = dyns
    scenes = [tdyn.pose_scene(td, _bones("torch", p)) for p in FRAME_POSES]
    r = Renderer(scenes[0], tcam, RendererConfig(**FRAME))
    st = r.init_state()
    for i in range(3):
        kw = dict(cam=_moved(tcam, i, Camera, torch.from_numpy),
                  cam_moved=True, scene=scenes[i]) if i else {}
        disp, acc, st = r.step(st, **kw)
        jd_, ja, jl = run["frames"][i]
        assert close_share(jd_, disp.numpy(), 0.0, 1e-3) == 1.0, i
        np.testing.assert_allclose(acc.numpy(), ja, err_msg=f"{i}", **TOL)
        want = _flat(jl)
        names = dict(_tensors(st))
        for k, v in names.items():
            w = np.asarray(want[k])
            if w.dtype.kind in "biu":
                assert (v.numpy() == w).all(), (i, k)
            else:
                np.testing.assert_allclose(v.numpy(), w,
                                           err_msg=f"{i}: {k}", **TOL)
        rest = {k for k in want if not k.startswith(("prev_cam.", "sample"))}
        assert rest == set(names), rest ^ set(names)
    assert float(acc.mean()) > 1e-3
