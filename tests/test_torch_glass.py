"""Torch port, glass and cutout scenes with ASVGF: shadow transmittance
(transmit_wavefront), the stochastic cutout pass-through, the nested-
dielectric medium stack, and ASVGF's stratum replay and LF/HF filter in
Renderer.step, against one eager run of a fresh JAX Renderer (two frames
of the Cornell box with a glass and a metal sphere and a cutout pane, the
second moving the camera). The run records its module calls on the way
(pytest's monkeypatch; no JAX file changes); the shadow rays of the
traced bounce loop come out through jax.debug.callback. Each module of
the port runs on the JAX package's own inputs: the transmittance on
every recorded shadow ray, the traces, the replay, ASVGF's gradient and
filter, ReCur on the recorded G-buffers, and the two whole frames."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.kernels import cwbvh_wavefront as jcw
from truetrace_tpu.post import asvgf as jasvgf
from truetrace_tpu.post.recur import ReCurState as JReCurState
from truetrace_tpu.post.recur import recur_denoise as jrecur
from truetrace_tpu.renderer import Renderer as JRenderer
from truetrace_tpu.renderer import RendererConfig as JRendererConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene import primitives as jprim
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import HostMaterial as JMaterial
from truetrace_tpu.scene.mesh import HostMesh as JMesh
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.kernels.cwbvh_wavefront import transmit_plain
from truetrace_tpu_torch.kernels.traverse_ref import transmit_brute
from truetrace_tpu_torch.post import asvgf
from truetrace_tpu_torch.post.recur import ReCurState, recur_denoise
from truetrace_tpu_torch.renderer import Renderer, RendererConfig
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene import primitives as tprim
from truetrace_tpu_torch.scene.ir import Camera, Scene
from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from chip_smoke import GLASS_MAT as GLASS
from chip_smoke import METAL_MAT as METAL
from chip_smoke import PANE_MAT as PANE
from chip_smoke import glass_cornell_host
from torch_parity import check_sample, close_share, leaves

SHARE = 0.99            # check_sample's share of pixels
CFG = dict(width=16, height=16, bounces=3, bsdf="disney",
           traversal="wavefront", light_sampling="tree", denoiser="asvgf")
RECORDED = ((jrenderer, "render_sample_with_stats"),
            (jasvgf, "render_sample_with_stats"),
            (jasvgf, "asvgf_gradient"), (jasvgf, "asvgf_filter"))


def _glass_cornell(mesh_cls, mat_cls, cornell, prim, extra=(GLASS, METAL,
                                                            PANE)):
    """chip_smoke's glass Cornell box from one package's classes."""
    make = (cornell.make if cornell is jcornell
            else lambda: cornell.make(device="cpu"))
    return glass_cornell_host(mesh_cls, mat_cls, make, prim, extra)


@pytest.fixture(scope="module")
def run():
    """Two frames of a fresh, eager JAX Renderer with every module call
    recorded: {name: [(args, kwargs, result)] in call order}, and every
    transmit_wavefront call's (ro, rd, t_max, transmittance)."""
    meshes, mats, jcam = _glass_cornell(JMesh, JMaterial, jcornell, jprim)
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True)
    c2w = np.asarray(jcam.c2w).copy()
    c2w[3, 0] += 0.05                                   # the eye moves
    jmoved = JCamera(c2w=jnp.asarray(c2w), fov_y=jcam.fov_y,
                     aperture=jcam.aperture, focus_dist=jcam.focus_dist)
    calls = {f"{mod.__name__.split('.')[-1]}.{name}": []
             for mod, name in RECORDED}
    shadow = []

    def recorder(fn, key):
        def call(*a, **k):
            out = fn(*a, **k)
            calls[key].append((a, k, out))
            return out
        return call

    orig_transmit = jcw.transmit_wavefront

    def transmit(nodes, leaf_rows, tint, ro, rd, t_max, **k):
        tp = orig_transmit(nodes, leaf_rows, tint, ro, rd, t_max, **k)
        jax.debug.callback(lambda *x: shadow.append(
            tuple(np.array(v) for v in x)), ro, rd, t_max, tp)
        return tp

    jr = JRenderer(js, jcam, JRendererConfig(**CFG))
    st = jr.init_state()
    frames, states = [], []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in RECORDED:
            key = f"{mod.__name__.split('.')[-1]}.{name}"
            mp.setattr(mod, name, recorder(getattr(mod, name), key))
        mp.setattr(jcw, "transmit_wavefront", transmit)
        for cam, moved in ((None, None), (jmoved, True)):
            disp, acc, st = jr.step(st, cam=cam, cam_moved=moved)
            frames.append((np.asarray(disp), np.asarray(acc)))
            states.append(leaves(st))
    jax.effects_barrier()
    return dict(calls=calls, shadow=shadow, frames=frames, states=states,
                scene=Scene.from_numpy(leaves(js), "cpu"),
                cam=_cam(jcam), moved=_cam(jmoved))


def _t(x):
    """A JAX array (or None) as a torch tensor; uint32 and int32 words as
    int64."""
    if x is None:
        return None
    a = np.array(x)
    if a.dtype in (np.uint32, np.int32):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _cam(jcam):
    return None if jcam is None else Camera.from_numpy(leaves(jcam), "cpu")


def _cfg(jcfg) -> RenderConfig:
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)})


def _ast(jstate) -> asvgf.ASVGFState:
    return asvgf.ASVGFState.from_numpy(leaves(jstate), "cpu")


def test_scene_has_glass_and_media(run):
    """The recorded run exercises what the slice adds: a tint table with
    opaque, tinted and half-passing rows, media, and shadow rays whose
    transmittance lies strictly between 0 and 1 (stained glass and the
    pane), on the main trace and the replay (16x16 and 5x5 lanes) of
    both frames, 3 bounces each."""
    sc = run["scene"]
    assert sc.has_media and sc.tri_shadow is not None
    tint = sc.tri_shadow.numpy()
    assert (tint.max(-1) == 0).any() and (tint.max(-1) > 0.5).any()
    assert [s[0].shape[0] for s in run["shadow"]] == [256] * 3 + [25] * 3 \
        + [256] * 3 + [25] * 3
    tp = np.concatenate([s[3] for s in run["shadow"]])
    assert ((tp.max(-1) > 1e-3) & (tp.max(-1) < 0.999)).sum() >= 5


@pytest.mark.parametrize("frame", [0, 1])
def test_transmit_matches_jax(run, frame):
    """transmit_plain on every shadow ray the JAX frame traced (its main
    trace's and its replay's bounces): bit for bit the JAX
    transmit_wavefront, and within rtol 1e-4 / atol 1e-5 of the brute
    force oracle transmit_brute (a product taken as exp of a sum of
    logs)."""
    sc = run["scene"]
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    for ro, rd, tm, jtp in run["shadow"][6 * frame: 6 * frame + 6]:
        args = [torch.from_numpy(x) for x in (ro, rd, tm)]
        tp = transmit_plain(table, C, sc.tri_shadow, *args, sc.cw_stack)
        np.testing.assert_array_equal(tp.numpy().view(np.int32),
                                      jtp.view(np.int32))
        br = transmit_brute(sc.tri_p0, sc.tri_e1, sc.tri_e2, sc.tri_shadow,
                            *args)
        np.testing.assert_allclose(tp.numpy(), br.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("frame", [0, 1])
def test_trace_matches_jax(run, frame):
    """The frame's trace (16x16) with glass, the cutout pass-through and
    the medium stack, on the JAX run's inputs: radiance, G-buffer and ray
    counts as check_sample holds them."""
    a, k, (jrad, jst) = run["calls"]["renderer.render_sample_with_stats"][
        frame]
    trad, tst = render_sample_with_stats(
        run["scene"], _cam(a[1]), _cfg(a[2]), _t(a[3]), int(a[4]))
    check_sample(jrad, jst, trad, tst, SHARE)
    assert int(np.asarray(a[4])) == frame


@pytest.mark.parametrize("frame", [0, 1])
def test_replay_matches_jax(run, frame):
    """ASVGF's stratum replay (5x5 lanes, the previous sample id) on the
    JAX run's inputs. Torch's CPU kernels round some operations by the
    batch's shape (a vectorised body and a scalar remainder), and the
    glass sphere's facets turn such a last-ulp change of a direction into
    another path: the port's own trace of a pixel can differ between the
    25-lane replay and the 256-lane frame. So: the port's frame-sized
    trace at the stratum pixels against the JAX replay as check_sample
    holds a trace; the replay itself equal to it but on at most 2 of the
    25 lanes, and within rtol 1e-4 / atol 1e-5 of the JAX replay on every
    other lane; its G-buffer within rtol 1e-5 / atol 1e-6 and its ray
    counts equal."""
    a, k, (jrad, jst) = run["calls"]["asvgf.render_sample_with_stats"][frame]
    sc, cam, cfg, sid = run["scene"], _cam(a[1]), _cfg(a[2]), int(a[4])
    strat = _t(a[3])
    assert sid == max(frame - 1, 0) and strat.shape == (25,)
    trad, tst = render_sample_with_stats(sc, cam, cfg, strat, sid)
    frad, fst = render_sample_with_stats(sc, cam, cfg,
                                         torch.arange(16 * 16), sid)
    sub = {key: fst[key][strat] for key in ("albedo", "normal", "depth",
                                            "emitted0")}
    check_sample(jrad, jst, frad[strat], dict(
        sub, n_trace=tst["n_trace"], n_shadow=tst["n_shadow"]), SHARE)
    for key in ("albedo", "normal", "depth", "emitted0"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]),
                                   rtol=1e-5, atol=1e-6)
    assert float(jst["n_trace"]) == float(tst["n_trace"])
    assert float(jst["n_shadow"]) == float(tst["n_shadow"])
    batch = (trad != frad[strat]).any(-1)
    assert int(batch.sum()) <= 2
    keep = ~batch.numpy()
    np.testing.assert_allclose(trad.numpy()[keep], np.asarray(jrad)[keep],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("frame", [0, 1])
def test_asvgf_gradient_matches_jax(run, frame):
    """asvgf_gradient on the JAX run's inputs (state, sample id, the
    frame's radiance, the replay's radiance): the stratum luminance, the
    diffused gradient and the alpha map within rtol 1e-5 / atol 1e-6,
    the sample id exact."""
    a, k, (jalpha, jgrad, jlum, jsid) = \
        run["calls"]["asvgf.asvgf_gradient"][frame]
    _, _, (jrep, _) = run["calls"]["asvgf.render_sample_with_stats"][frame]
    with pytest.MonkeyPatch.context() as mp:
        # the replay's radiance is the JAX one (test_replay_matches_jax
        # holds the port's trace of it)
        mp.setattr(asvgf, "render_sample_with_stats",
                   lambda *a, **k: (_t(jrep), None))
        alpha, grad, lum, sid = asvgf.asvgf_gradient(
            run["scene"], _cam(a[1]), _cfg(a[2]), _ast(a[3]), int(a[4]),
            _t(a[5]))
    for j, t in ((jlum, lum), (jgrad, grad), (jalpha, alpha)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
    assert int(sid) == int(jsid) == frame
    assert float(np.asarray(jalpha).max()) > asvgf.ALPHA_MIN


@pytest.mark.parametrize("frame", [0, 1])
def test_asvgf_filter_matches_jax(run, frame):
    """asvgf_filter on the JAX run's inputs (the second frame with its
    motion vectors): the output, the SVGF state and the LF history within
    rtol 1e-4 / atol 1e-5 on >= 99% of pixels."""
    a, k, (jout, jsvgf, jlf, jlen) = run["calls"]["asvgf.asvgf_filter"][frame]
    assert (k.get("motion") is None) == (frame == 0)
    out, svgf_st, lf, lf_len = asvgf.asvgf_filter(
        *(_t(x) for x in a[:4]), _ast(a[4]), _t(a[5]),
        motion=_t(k.get("motion")), emissive=_t(k.get("emissive")))
    pairs = [(jout, out), (jlf, lf), (jlen, lf_len)] + [
        (getattr(jsvgf, f.name), getattr(svgf_st, f.name))
        for f in dataclasses.fields(svgf_st)]
    for j, t in pairs:
        j, t = np.asarray(j), t.numpy()
        rows = j.shape[0] * j.shape[1]
        assert close_share(j.reshape(rows, -1), t.reshape(rows, -1), 1e-4,
                           1e-5) >= SHARE


def test_recur_on_recorded_gbuffers(run):
    """ReCur over the two recorded frames' radiance and G-buffers (the
    second with the recorded motion vectors and emissive pass-through),
    the JAX recur_denoise against the port's: every output and state
    tensor within rtol 1e-4 / atol 1e-5 on >= 99% of pixels (pow(x, 64)
    and exp round differently in the two frameworks)."""
    H, W = CFG["height"], CFG["width"]
    jst, tst = JReCurState.create(H, W), ReCurState.create(H, W, "cpu")
    for frame in (0, 1):
        _, _, (jrad, st) = run["calls"][
            "renderer.render_sample_with_stats"][frame]
        motion = run["calls"]["asvgf.asvgf_filter"][frame][1].get("motion")
        ins = [np.array(x).reshape((H, W) + np.shape(x)[1:])
               for x in (jrad, st["albedo"], st["normal"], st["depth"],
                         st["emitted0"])]
        jout, jst = jrecur(*(jnp.asarray(x) for x in ins[:4]), jst,
                           motion=None if motion is None
                           else jnp.asarray(motion),
                           emissive=jnp.asarray(ins[4]))
        tout, tst = recur_denoise(*(torch.from_numpy(x) for x in ins[:4]),
                                  tst, motion=_t(motion),
                                  emissive=torch.from_numpy(ins[4]))
        pairs = [(jout, tout)] + [(getattr(jst, f.name), getattr(
            tst, f.name)) for f in dataclasses.fields(tst)]
        for j, t in pairs:
            j, t = np.asarray(j), t.numpy()
            assert close_share(j.reshape(H * W, -1), t.reshape(H * W, -1),
                               1e-4, 1e-5) >= SHARE
    assert float(tst.hist_len.max()) == 2.0


def _state_fields(d: dict) -> dict:
    """name -> numpy array of every tensor field of a FrameState's numpy
    leaves other than the cameras and the sample id."""
    a = d["asvgf"]
    out = {"accum.image": d["accum"]["image"], "taa": d["taa_history"],
           **{f"asvgf.{k}": a[k] for k in ("prev_lum", "lf_hist", "lf_len")},
           **{f"asvgf.svgf.{k}": v for k, v in a["svgf"].items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_leaves(st) -> dict:
    t = lambda o: {f.name: getattr(o, f.name).numpy()
                   for f in dataclasses.fields(o)}
    a = st.asvgf
    return {"accum": t(st.accum), "taa_history": st.taa_history.numpy(),
            "asvgf": dict(svgf=t(a.svgf), prev_lum=a.prev_lum.numpy(),
                          lf_hist=a.lf_hist.numpy(), lf_len=a.lf_len.numpy(),
                          prev_sid=a.prev_sid.numpy())}


def test_frames_match_jax(run):
    """Two Renderer.step frames of a fresh port Renderer (the second
    moving the camera with cam_moved=True) against the JAX run's: the
    display within 1e-3 and every state field (accumulation, TAA, and
    ASVGF's stratum luminance, LF history and SVGF state) within rtol
    1e-4 / atol 1e-5 on >= 99% of rows, the means to rtol 1e-4, the
    previous sample id exact. The second frame's ASVGF histories are held
    within rtol 1e-3 / atol 1e-4 instead: their alpha map reads the
    replay, whose few lanes of another path (test_replay_matches_jax)
    move the diffused gradient by ~1e-4."""
    r = Renderer(run["scene"], run["cam"], RendererConfig(**CFG))
    st = r.init_state()
    for i, (cam, moved) in enumerate(((None, None), (run["moved"], True))):
        disp, rad, st = r.step(st, cam=cam, cam_moved=moved)
        jd, ja = run["frames"][i]
        d = disp.numpy()
        assert np.isfinite(d).all() and d.min() >= 0 and d.max() <= 1
        assert close_share(jd, d, 0.0, 1e-3) >= SHARE
        np.testing.assert_allclose(jd.mean(), d.mean(), rtol=1e-4)
        np.testing.assert_allclose(ja.mean(), rad.numpy().mean(), rtol=1e-4)
        tl = _torch_leaves(st)
        tf = _state_fields(tl)
        for k, j in _state_fields(run["states"][i]).items():
            rows = j.shape[0] * j.shape[1]
            tol = (1e-3, 1e-4) if i and k.startswith("asvgf.") else (1e-4,
                                                                     1e-5)
            assert close_share(j.reshape(rows, -1), tf[k].reshape(rows, -1),
                               *tol) >= SHARE, k
        assert int(tl["asvgf"]["prev_sid"]) == int(
            run["states"][i]["asvgf"]["prev_sid"]) == i
    assert st.sample == 2


@pytest.mark.parametrize("extra,media", [((GLASS, METAL, PANE), True),
                                         ((PANE, METAL, PANE), False)])
def test_scene_tables_match_jax(extra, media):
    """The port's own compile_scene on a glass scene and on a cutout-only
    scene: the shadow tint table bit for bit the JAX one, on the scene's
    device, and has_media as JAX sets it (a non-thin transmissive
    material)."""
    jm, jmat, _ = _glass_cornell(JMesh, JMaterial, jcornell, jprim, extra)
    tm, tmat, _ = _glass_cornell(HostMesh, HostMaterial, tcornell, tprim,
                                 extra)
    js = jcompile(jm, jmat, with_cwbvh=True)
    ts = tcompile(tm, tmat, with_cwbvh=True, device="cpu")
    assert ts.has_media == js.has_media == media
    assert ts.tri_shadow.device == ts.device
    np.testing.assert_array_equal(ts.tri_shadow.numpy().view(np.int32),
                                  np.asarray(js.tri_shadow).view(np.int32))
    assert (ts.tri_shadow.numpy() == 0.5).all(-1).any()
