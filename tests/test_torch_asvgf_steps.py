"""Torch port, the two ASVGF frame functions, asvgf_step (a traced sample,
the replay of its 1-in-9 stratum with the previous sample id, the LF/HF
filter) and restir_asvgf_step (ReSTIR GI's frame, whose validation
gradients drive the same filter), and the Renderer's ReSTIR-ASVGF
branch (use_restir with denoiser="asvgf"), against the JAX package's on
the Cornell box at 9x9, three chained frames from the empty state.

The JAX functions run as they are; only their traced sample,
render_sample_with_stats, is jitted once per shape where they look it up
(pytest's monkeypatch; no JAX file changes), so the nine frames compile
two traces (81 lanes and the 9-lane replay) rather than one a call.

Tolerance: rtol 1e-4 / atol 1e-5 on every element of the output, the
gradient, the alpha map and every state tensor (the traces agree to the
last few ulps, and the filters' exp / pow round differently in the two
frameworks, as tests/test_torch_denoisers.py states); the sample ids
exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.integrate import pathtrace as jpathtrace
from truetrace_tpu.integrate import restir as jrestir
from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.post import asvgf as jasvgf
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate import restir as trestir
from truetrace_tpu_torch.integrate.pathtrace import RenderConfig
from truetrace_tpu_torch.post import asvgf as tasvgf
from truetrace_tpu_torch.renderer import Renderer, RendererConfig
from truetrace_tpu_torch.scene.ir import Camera, Scene

from torch_parity import close_share, leaves

N = 9
TOL = dict(rtol=1e-4, atol=1e-5)
# the Renderer's ReSTIR-ASVGF frame; its render config is the steps' one
CFG = dict(width=N, height=N, bounces=2, bsdf="disney",
           traversal="wavefront", light_sampling="tree", denoiser="asvgf",
           use_restir=True)


def _state_pairs(js, ts):
    """(name, JAX array, torch tensor) of every tensor of two
    ASVGFStates but the sample id."""
    out = [(k, getattr(js, k), getattr(ts, k))
           for k in ("prev_lum", "lf_hist", "lf_len")]
    return out + [(f"svgf.{f.name}", getattr(js.svgf, f.name),
                   getattr(ts.svgf, f.name))
                  for f in dataclasses.fields(ts.svgf)]


def _close(pairs, what):
    for k, j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"{what}: {k}", **TOL)


@pytest.fixture(scope="module")
def steps():
    """Three frames of each JAX function, with their inputs: {"asvgf":
    [(out, state, aux)], "restir": [(out, restir state, state, aux)],
    "frames": [(display, radiance, state leaves)] of a JAX Renderer (the
    second and third frames moving the camera on)} and the scene, cameras
    and configs."""
    meshes, mats, jcam = jcornell.make()
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True)
    jcfg = JRenderConfig(width=N, height=N, bounces=2, bsdf="disney",
                         traversal="wavefront", light_sampling="tree",
                         restir_capture=True)
    jr = jrenderer.Renderer(js, jcam, jrenderer.RendererConfig(**CFG))
    assert jr.rcfg == jcfg
    traced = jax.jit(jpathtrace.render_sample_with_stats,
                     static_argnames=("cfg",))

    def render(scene, cam, cfg, pixel, sample_id, **k):
        return traced(scene, cam, cfg=cfg, pixel=pixel,
                      sample_id=jnp.uint32(sample_id), **k)

    jmoved = []
    for dx in (0.05, 0.1):                      # the eye moves on, in x and y
        c2w = np.asarray(jcam.c2w).copy()
        c2w[3, :2] += dx
        jmoved.append(JCamera(c2w=jnp.asarray(c2w), fov_y=jcam.fov_y,
                              aperture=jcam.aperture,
                              focus_dist=jcam.focus_dist))
    out = {"asvgf": [], "restir": [], "frames": []}
    a = b = jasvgf.ASVGFState.create(N, N)
    r = jrestir.ReSTIRState.create(N, N)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jasvgf, "render_sample_with_stats", render)
        mp.setattr(jrestir, "render_sample_with_stats", render)
        mp.setattr(jrenderer, "render_sample_with_stats", render)
        fs = jr.init_state()
        for cam, moved in ((None, None), (jmoved[0], True),
                           (jmoved[1], True)):
            disp, acc, fs = jr.step(fs, cam=cam, cam_moved=moved)
            out["frames"].append((np.asarray(disp), np.asarray(acc),
                                  leaves(fs)))
        for sid in range(3):
            o, a, aux = jasvgf.asvgf_step(js, jcam, jcfg, a, sid)
            out["asvgf"].append((o, a, aux))
            o, r, b, aux = jasvgf.restir_asvgf_step(js, jcam, jcfg, r, b,
                                                    sid)
            out["restir"].append((o, r, b, aux))
    cfg = RenderConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(RenderConfig)})
    return dict(out, scene=Scene.from_numpy(leaves(js), "cpu"),
                cam=Camera.from_numpy(leaves(jcam), "cpu"),
                moved=[Camera.from_numpy(leaves(c), "cpu") for c in jmoved],
                cfg=cfg)


def test_asvgf_step_matches_jax(steps):
    """asvgf_step over three frames: the denoised frame, the gradient,
    the alpha map and the new state; the replay's gradient is live from
    the second frame on."""
    sc, cam, cfg = steps["scene"], steps["cam"], steps["cfg"]
    st = tasvgf.ASVGFState.create(N, N, "cpu")
    for sid, (jo, js, jaux) in enumerate(steps["asvgf"]):
        out, st, aux = tasvgf.asvgf_step(sc, cam, cfg, st, sid)
        _close([("out", jo, out), ("gradient", jaux["gradient"],
                                   aux["gradient"]),
                ("alpha", jaux["alpha"], aux["alpha"])]
               + _state_pairs(js, st), f"frame {sid}")
        assert int(st.prev_sid) == int(js.prev_sid) == sid
    assert float(np.asarray(jaux["gradient"]).max()) > 0.0
    assert float(st.svgf.hist_len.max()) == 3.0


def test_restir_asvgf_step_matches_jax(steps):
    """restir_asvgf_step over three frames: the denoised frame, the
    gradient, the alpha map, the ASVGF state (its stratum luminance
    kept, the sample id the frame's) and ReSTIR GI's state; the second
    frame's GI gradient is live."""
    sc, cam, cfg = steps["scene"], steps["cam"], steps["cfg"]
    st = tasvgf.ASVGFState.create(N, N, "cpu")
    rs = trestir.ReSTIRState.create(N, N, "cpu")
    live = 0.0
    for sid, (jo, jr, js, jaux) in enumerate(steps["restir"]):
        out, rs, st, aux = tasvgf.restir_asvgf_step(sc, cam, cfg, rs, st,
                                                    sid)
        _close([("out", jo, out), ("gradient", jaux["gradient"],
                                   aux["gradient"]),
                ("alpha", jaux["alpha"], aux["alpha"])]
               + _state_pairs(js, st)
               + [(f"restir.{f.name}", getattr(jr, f.name),
                   getattr(rs, f.name)) for f in dataclasses.fields(rs)],
               f"frame {sid}")
        assert int(st.prev_sid) == int(js.prev_sid) == sid
        live = max(live, float(np.asarray(jaux["gradient"]).max()))
    assert live > 0.0


def test_renderer_restir_asvgf_matches_jax(steps):
    """Renderer.step with use_restir and denoiser="asvgf" (the GI
    gradients drive the filter; no replay) over three frames, the second
    and third moving the camera on with cam_moved=True: the display
    within 1e-3 on every pixel, the radiance's mean to rtol 1e-4, every
    ASVGF and ReSTIR GI state tensor and the accumulation within the
    tolerance, the stratum luminance kept at its empty start and the
    sample id the frame's. The camera moves along x and y because a
    still camera's motion vectors, and a moving one's along an axis it
    does not move on, are rounding noise (~1e-7): at the frame's left
    and top edges the in-frame test of a reservoir's history position
    then follows the last ulp of the depth, and the history is kept in
    one framework and dropped in the other."""
    r = Renderer(steps["scene"], steps["cam"], RendererConfig(**CFG))
    st = r.init_state()
    frames = ((None, None), (steps["moved"][0], True),
              (steps["moved"][1], True))
    for i, ((cam, moved), (jd, ja, jl)) in enumerate(zip(frames,
                                                         steps["frames"])):
        disp, rad, st = r.step(st, cam=cam, cam_moved=moved)
        assert close_share(jd, disp.numpy(), 0.0, 1e-3) == 1.0
        np.testing.assert_allclose(ja.mean(), rad.numpy().mean(), rtol=1e-4)
        a, ja_ = st.asvgf, jl["asvgf"]
        pairs = [(k, ja_[k], getattr(a, k))
                 for k in ("prev_lum", "lf_hist", "lf_len")]
        pairs += [(f"svgf.{k}", v, getattr(a.svgf, k))
                  for k, v in ja_["svgf"].items()]
        pairs += [(f"restir.{k}", v, getattr(st.restir, k))
                  for k, v in jl["restir"].items()]
        pairs += [("accum.image", jl["accum"]["image"], st.accum.image)]
        _close(pairs, f"frame {i}")
        assert int(a.prev_sid) == int(ja_["prev_sid"]) == i
        assert not bool(a.prev_lum.any())
    assert st.sample == 3
