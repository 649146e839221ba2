"""Torch port, the forest frame against one eager run of a fresh JAX
Renderer: an instanced scene (chip_smoke.forest_host at 16x16: 24 trees
and 4 emissive lanterns scattered on a 33^2 hills terrain, the baked
sky) through the two-level traversal, the terrain's march, NEE by the
light tree over the lanterns' world light rows (compile_scene_instanced
with_light_bvh, rebuilt by every update; each light BVH is built once,
by the port's builder, for both packages' scenes), per-object motion
vectors,
partial rendering
(its instance G-buffer) and SVGF; three frames, the camera and the
lanterns moving on the second and third (update_instance_transforms, the
new scene handed to Renderer.step).

The JAX Renderer runs as it is; only its traced sample,
render_sample_with_stats, is jitted where the renderer looks it up
(pytest's monkeypatch; no JAX file changes).

Tolerance: the display within 1e-3 on every pixel, every FrameState
tensor to rtol 1e-4 / atol 1e-5 (the traces agree to the last few ulps:
the few closest hits of the TLAS that differ in their last bits,
ROADMAP.md §C, and the filters' exp and pow), the integer buffers (the instance G-buffer among
them) and the previous instance transforms exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.build.env_cdf import build_env_cdf as jbuild_env_cdf
from truetrace_tpu.integrate import pathtrace as jpathtrace
from truetrace_tpu.post import motion as jmotion
from truetrace_tpu.scene import instances as jinst
from truetrace_tpu.scene import primitives as jprim
from truetrace_tpu.scene import terrain as jterrain
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import HostMaterial as JMat
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.kernels.cwbvh_tlas import closest_hit_tlas
from truetrace_tpu_torch.kernels.heightmap import heightmap_closest
from truetrace_tpu_torch.post import motion as tmotion
from truetrace_tpu_torch.renderer import (FrameState, Renderer,
                                          RendererConfig, _tensors)
from truetrace_tpu_torch.scene import instances as tinst
from truetrace_tpu_torch.scene import primitives as tprim
from truetrace_tpu_torch.scene import terrain as tterrain
from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
from truetrace_tpu_torch.scene.ir import Camera
from truetrace_tpu_torch.scene.mesh import HostMaterial as TMat
from truetrace_tpu_torch.scene.mesh import HostMesh as TMesh

from torch_parity import close_share, leaves

TOL = dict(rtol=1e-4, atol=1e-5)
SIZE = dict(n_hm=33, n_trees=24, n_lanterns=4)
CFG = dict(cs.FOREST_TREE, width=16, height=16, bounces=3,
           partial_rendering=2)
MOVES = (0.0, 0.3, 0.6)         # the eye's offset along x a frame


def _moved(cam, dx, cls, arr):
    c2w = np.asarray(cam.c2w).copy()
    c2w[3, 0] += dx
    return cls(c2w=arr(c2w), fov_y=cam.fov_y, aperture=cam.aperture,
               focus_dist=cam.focus_dist)


_SKY = []


def _sky():
    """The baked sky, once a module."""
    if not _SKY:
        _SKY.append(bake_sky_env(**cs.FOREST_SKY, device="cpu"))
    return _SKY[0]


def _forest(pkg):
    """(scene, InstancedScene, materials, instances, camera) of the small
    forest by one package, under the same sky (the port's bake, whose
    CDF tables the JAX package builds for itself)."""
    sky = _sky()
    img = sky.image.numpy()
    if pkg == "jax":
        sources, mats, inst, (hm, ter), (eye, target, fov) = cs.forest_host(
            JMesh, JMat, jprim, jterrain, **SIZE)
        sc, isc = jinst.compile_scene_instanced(
            sources, mats, inst, env=jbuild_env_cdf(img),
            with_light_bvh=True)
        sc = sc.replace(terrain=jterrain.make_terrain(hm, **ter))
        return sc, isc, mats, inst, JCamera.look_at(eye, target,
                                                    fov_y_deg=fov)
    sources, mats, inst, (hm, ter), (eye, target, fov) = cs.forest_host(
        TMesh, TMat, tprim, tterrain, **SIZE)
    sc, isc = tinst.compile_scene_instanced(sources, mats, inst, env=sky,
                                            with_light_bvh=True, device="cpu")
    sc = dataclasses.replace(sc, terrain=tterrain.make_terrain(
        hm, device="cpu", **ter))
    return sc, isc, mats, inst, Camera.look_at(eye, target, fov_y_deg=fov,
                                               device="cpu")


def _scenes(pkg, forest):
    """The three frames' scenes: as built, then the lanterns bobbed."""
    sc, isc, mats, inst, _ = forest
    upd = (jinst if pkg == "jax" else tinst).update_instance_transforms
    return [sc] + [upd(sc, isc, mats, cs.forest_bob(inst, k))[0]
                   for k in (1, 2)]


def _light_bvh_once():
    """The port's light-BVH build, memoised on its inputs: both packages'
    forests take it, so each of the three light BVHs is built once. The
    JAX package's build is the same SAOH algorithm in slower Python, held
    bit for bit to the port's on instanced scenes and their updates by
    tests/test_torch_tlas.py."""
    from truetrace_tpu_torch.build.lightbvh import build_light_bvh
    memo = {}

    def build(tris, ids, power):
        ids = np.asarray(ids)
        key = (ids.astype(np.int64).tobytes(),
               np.asarray(power).tobytes()) + tuple(
            np.asarray(tris[k])[ids].tobytes() for k in ("p0", "e1", "e2"))
        if key not in memo:
            memo[key] = build_light_bvh(tris, ids, power)
        return memo[key]
    return build


@pytest.fixture(scope="module")
def run():
    """Three frames of the JAX Renderer: [(display, radiance, state
    leaves)], the port's scenes and cameras beside them."""
    import truetrace_tpu.build.lightbvh as jlbvh
    import truetrace_tpu_torch.build.lightbvh as tlbvh
    build = _light_bvh_once()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlbvh, "build_light_bvh", build)
        mp.setattr(tlbvh, "build_light_bvh", build)
        jf = _forest("jax")
        jscenes = _scenes("jax", jf)
        tf = _forest("torch")
        tscenes = _scenes("torch", tf)
    jcam = jf[4]
    jr = jrenderer.Renderer(jscenes[0], jcam,
                            jrenderer.RendererConfig(**CFG))
    traced = jax.jit(jpathtrace.render_sample_with_stats,
                     static_argnames=("cfg",))

    def render(scene, cam, cfg, pixel, sample_id, **k):
        return traced(scene, cam, cfg=cfg, pixel=pixel,
                      sample_id=jnp.asarray(sample_id, jnp.uint32), **k)

    cams = [None] + [_moved(jcam, dx, JCamera, jnp.asarray)
                     for dx in MOVES[1:]]
    frames = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_sample_with_stats", render)
        st = jr.init_state()
        for i, cam in enumerate(cams):
            kw = dict(cam=cam, cam_moved=True, scene=jscenes[i]) if i else {}
            disp, acc, st = jr.step(st, **kw)
            frames.append((np.asarray(disp), np.asarray(acc), leaves(st)))
    tcam = tf[4]
    return dict(frames=frames, scenes=tscenes, cam=tcam,
                jscenes=jscenes, cams=[None] + [
                    _moved(tcam, dx, Camera, torch.from_numpy)
                    for dx in MOVES[1:]])


def _flat_leaves(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _check_frame(i, td, ta, tst, want):
    jd, ja, jl = want
    assert close_share(jd, td.numpy(), 0.0, 1e-3) == 1.0, f"frame {i}"
    np.testing.assert_allclose(ta.numpy(), ja, err_msg=f"frame {i}", **TOL)
    j = _flat_leaves(jl)
    names = dict(_tensors(tst))
    for k, t in names.items():
        w = np.asarray(j[k])
        if w.dtype.kind in "biu" or k == "prev_inst_l2w":
            assert (t.numpy() == w).all(), f"frame {i}: {k}"
        else:
            np.testing.assert_allclose(t.numpy(), w,
                                       err_msg=f"frame {i}: {k}", **TOL)
    rest = {k for k in j if not k.startswith(("prev_cam.", "sample"))}
    assert rest == set(names), rest ^ set(names)


def _step(r, st, run, i):
    if i == 0:
        return r.step(st)
    return r.step(st, cam=run["cams"][i], cam_moved=True,
                  scene=run["scenes"][i])


def test_forest_frames_match_jax(run):
    """The three frames: the display, the accumulation and every
    FrameState tensor (SVGF's histories, partial rendering's buffers and
    their instance G-buffer, reprojected by per-object motion, the TAA
    history and the previous instance transforms)."""
    # NEE takes the light tree: the scenes carry its pair rows
    assert all(s.lbvh_pairs.shape[0] > 0 for s in run["scenes"])
    r = Renderer(run["scenes"][0], run["cam"], RendererConfig(**CFG))
    st = r.init_state()
    for i in range(3):
        td, ta, st = _step(r, st, run, i)
        _check_frame(i, td, ta, st, run["frames"][i])
    inst = st.partial["inst"]
    assert bool((inst >= 0).any()) and bool((inst == -1).any())
    assert torch.equal(st.prev_inst_l2w, run["scenes"][2].inst_l2w)


def test_forest_resumes_from_the_jax_state(run):
    """Frame 2 resumed from the JAX state after frame 1 (FrameState.
    from_numpy: prev_inst_l2w and the partial instance buffer carried
    across) matches the JAX frame 2, as does the third after it."""
    r = Renderer(run["scenes"][0], run["cam"], RendererConfig(**CFG))
    st = FrameState.from_numpy(run["frames"][0][2], "cpu")
    assert st.prev_inst_l2w is not None and "inst" in st.partial
    for i in (1, 2):
        td, ta, st = _step(r, st, run, i)
        _check_frame(i, td, ta, st, run["frames"][i])


def test_motion_vectors_objects_match_jax(run):
    """Per-object motion vectors of the third frame's depth and instance
    G-buffer between the second and third transforms, against JAX's
    (the port inverts the 3x3 rotations by their adjugate, JAX by LU:
    within 2e-3 pixels), and the pixels off instances take the camera's
    vectors."""
    rng = np.random.default_rng(0)
    H = W = 16
    depth = rng.uniform(5.0, 40.0, (H, W)).astype(np.float32)
    depth[0, :4] = 0.0
    inst = rng.integers(-1, 28, (H, W)).astype(np.int32)
    l2w = [np.asarray(s.inst_l2w) for s in run["jscenes"][1:]]
    jc = [_moved(JCamera.look_at((0.0, 14.0, 30.0), (0.0, 3.0, 0.0),
                                 fov_y_deg=50.0), dx, JCamera, jnp.asarray)
          for dx in MOVES[1:]]
    tc = [Camera.from_numpy(leaves(c), "cpu") for c in jc]
    want = np.asarray(jmotion.motion_vectors_objects(
        jc[0], jc[1], jnp.asarray(depth), jnp.asarray(inst),
        jnp.asarray(l2w[0]), jnp.asarray(l2w[1])))
    got = tmotion.motion_vectors_objects(
        tc[0], tc[1], torch.from_numpy(depth), torch.from_numpy(inst).long(),
        torch.from_numpy(l2w[0]), torch.from_numpy(l2w[1])).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-4)
    cam_only = tmotion.motion_vectors(tc[0], tc[1],
                                      torch.from_numpy(depth)).numpy()
    off = inst < 0
    assert (got[off] == cam_only[off]).all()
    M = tmotion.object_motion_transforms(torch.from_numpy(l2w[0]),
                                         torch.from_numpy(l2w[1])).numpy()
    Mj = np.asarray(jmotion.object_motion_transforms(jnp.asarray(l2w[0]),
                                                     jnp.asarray(l2w[1])))
    np.testing.assert_allclose(M, Mj, atol=2e-5)


def test_terrain_lane_keeps_the_instance_behind(run):
    """The reference's fact the port keeps (ROADMAP.md §C): where the
    terrain is nearer than a TLAS hit, the primary-hit instance G-buffer
    holds the instance behind the terrain, not -1 (so per-object motion
    moves that terrain pixel with it). A camera low over the hills sees
    trees behind them."""
    sc = run["scenes"][0]
    cam = Camera.look_at((-20.0, 4.0, 20.0), (10.0, 2.0, -10.0),
                         fov_y_deg=60.0, device="cpu")
    W, H = 48, 32
    cfg = RenderConfig(width=W, height=H, bounces=1, bsdf="disney",
                       traversal="tlas", light_sampling="cdf",
                       use_nee=False)
    pix = torch.arange(W * H)
    _, st = render_sample_with_stats(sc, cam, cfg, pix, 0)
    from truetrace_tpu_torch.core import rng
    from truetrace_tpu_torch.scene.ir import camera_rays
    ro, rd = camera_rays(cam, W, H, pix, rng.uniform2(
        pix, 0, rng.DIM_CAMERA_JITTER), lens_u=rng.uniform2(
            pix, rng.u32(0) + 0x9E3779B9, rng.DIM_CAMERA_JITTER))
    ro, rd = ro.contiguous(), rd.contiguous()
    hit, inst = closest_hit_tlas(sc.cw_table(), sc.cw_nodes.shape[0],
                                 sc.cw_leaf_rows.shape[0], ro, rd, 1e30)
    th = heightmap_closest(sc.terrain, ro, rd, hit.t)
    ter = th.valid & (th.t < hit.t)
    behind = ter & (inst >= 0)
    assert int(behind.sum()) > 0
    assert torch.equal(st["inst"][behind], inst[behind].long())
    assert torch.equal(st["depth"][behind], th.t[behind])
