"""Torch port, the frame: one path-traced sample per pixel and three
Renderer.step frames with SVGF against the JAX package on the same
(carried-across) Cornell scene, camera and sample ids, and the port's
own twin of scripts/verify_drive.py's physics checks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.integrate.pathtrace import (
    render_sample_with_stats as jrender_sample_with_stats)
from truetrace_tpu.renderer import Renderer as JRenderer
from truetrace_tpu.renderer import RendererConfig as JRendererConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.renderer import FrameState, Renderer, RendererConfig
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene.ir import Camera, Scene
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from torch_parity import leaves

FRAME = dict(bounces=3, bsdf="disney", traversal="wavefront",
             light_sampling="tree")


@pytest.fixture(scope="module")
def cornell_pair():
    meshes, mats, cam = jcornell.make()
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True)
    return (js, cam, Scene.from_numpy(leaves(js), "cpu"),
            Camera.from_numpy(leaves(cam), "cpu"))


def _close_share(a, b, rtol, atol):
    """Share of pixels whose every channel agrees within rtol/atol."""
    return np.isclose(a, b, rtol=rtol, atol=atol).all(-1).mean()


def test_render_sample_matches_jax(cornell_pair):
    """One sample of a 32x32 Cornell frame, 3 bounces, Disney, tree NEE.
    The RNG and camera rays are bitwise and the traversal is bitwise, so
    pixels differ only by the ulps of transcendentals and contracted
    mul-adds (and, rarely, a branch flip: RR, lobe choice, bf16 light
    pick): >= 99% of pixels agree to rtol 1e-4 / atol 1e-5, the image
    means to rtol 1e-4, and both packages traced the same rays."""
    js, jcam, ts, tcam = cornell_pair
    W = H = 32
    jcfg = JRenderConfig(width=W, height=H, **FRAME)
    f = jax.jit(lambda s, c, p: jrender_sample_with_stats(s, c, jcfg, p, 0))
    jr, jst = f(js, jcam, jnp.arange(W * H, dtype=jnp.uint32))
    tr, tst = render_sample_with_stats(ts, tcam, RenderConfig(
        width=W, height=H, **FRAME), torch.arange(W * H), 0)
    jr, tr = np.asarray(jr), tr.numpy()
    assert np.isfinite(tr).all()
    assert _close_share(jr, tr, 1e-4, 1e-5) >= 0.99
    np.testing.assert_allclose(jr.mean(0), tr.mean(0), rtol=1e-4)
    for k in ("albedo", "normal", "depth", "emitted0"):
        assert _close_share(np.asarray(jst[k]).reshape(W * H, -1),
                            tst[k].numpy().reshape(W * H, -1), 1e-5,
                            1e-6) >= 0.99, k
    assert float(jst["n_trace"]) == float(tst["n_trace"])
    assert float(jst["n_shadow"]) == float(tst["n_shadow"])


def test_renderer_three_svgf_frames_match_jax(cornell_pair):
    """Three Renderer.step frames with SVGF (ACES, TAA from frame 2,
    firefly clamp) against a fresh, eager JAX Renderer: the displays
    agree to 1e-3 on >= 99% of pixels and their means to rtol 1e-4; the
    port's state carries back in from the JAX state's leaves."""
    js, jcam, ts, tcam = cornell_pair
    kw = dict(width=32, height=32, denoiser="svgf", **FRAME)
    jr = JRenderer(js, jcam, JRendererConfig(**kw))
    tr = Renderer(ts, tcam, RendererConfig(**kw))
    jst, tst = jr.init_state(), tr.init_state()
    for _ in range(3):
        jd, ja, jst = jr.step(jst)
        td, ta, tst = tr.step(tst)
        jd, td = np.asarray(jd), td.numpy()
        assert td.shape == (32, 32, 3)
        assert np.isfinite(td).all() and td.min() >= 0 and td.max() <= 1
        assert _close_share(jd, td, 0.0, 1e-3) >= 0.99
        np.testing.assert_allclose(jd.mean(), td.mean(), rtol=1e-4)
        np.testing.assert_allclose(np.asarray(ja).mean(), ta.numpy().mean(),
                                   rtol=1e-4)
    back = FrameState.from_numpy(leaves(jst), "cpu")
    assert back.sample == tst.sample == 3
    np.testing.assert_allclose(back.accum.image.numpy(),
                               tst.accum.image.numpy(), atol=1e-3)
    assert torch.equal(back.svgf.hist_len, tst.svgf.hist_len)


def test_step_cam_moved_resets_accumulation(cornell_pair):
    """Renderer.step takes cam_moved as the JAX step does: with a camera
    passed, True restarts accumulation and False keeps it although the
    camera moved; None compares the cameras by value (the same one keeps
    it, a moved one restarts); with no camera passed it does nothing. A
    restart makes the accumulation that frame alone. graph_step, the CUDA
    graph path, refuses a scene on the CPU."""
    _, _, ts, tcam = cornell_pair
    # one bounce without shadow rays: the frames' contents do not matter
    # here, only which of them accumulate
    r = Renderer(ts, tcam, RendererConfig(width=8, height=8, bounces=1,
                                          use_nee=False,
                                          **{k: v for k, v in FRAME.items()
                                             if k != "bounces"}))
    c2w = tcam.c2w.clone()
    c2w[3, 0] += 0.1                                    # the eye moves
    moved = Camera(c2w=c2w, fov_y=tcam.fov_y, aperture=tcam.aperture,
                   focus_dist=tcam.focus_dist)
    st = r.init_state()
    counts = []
    for cam, cam_moved in ((None, None), (None, True), (tcam, None),
                           (moved, False), (moved, True), (tcam, None),
                           (tcam, None)):
        _, _, st = r.step(st, cam=cam, cam_moved=cam_moved)
        counts.append(float(st.accum.count))
    assert counts == [1, 2, 3, 4, 1, 1, 2]
    assert st.sample == 7 and torch.equal(r.cam.c2w, tcam.c2w)
    with pytest.raises(ValueError, match="CUDA"):
        r.graph_step(cam_moved=True)(st)


def _flat(out):
    """The tensors of a nested tuple / dict, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    items = out.values() if isinstance(out, dict) else out
    return [t for x in items for t in _flat(x)]


def test_graph_step_state_flow_matches_step(cornell_pair, monkeypatch):
    """graph_step's bookkeeping on the CPU, with the CUDA capture replaced
    by what a replay amounts to (run the captured function again and
    copy its results into the tensors the capture returned): four
    composed frames (SVGF, ReSTIR DI and GI, the radiance cache), the
    first eager, then the graphs of both cam_moved values, the first
    moving the camera, each fed the other's state, and a replay fed its
    own state; equal bit for bit to Renderer.step's display, radiance and
    state, the reservoirs and the cache tables included."""
    import truetrace_tpu_torch.renderer as rmod

    def capture(fn, device):
        out = fn()

        class Replay:
            def replay(self):
                for a, b in zip(_flat(out), _flat(fn())):
                    a.copy_(b)
        return Replay(), out

    monkeypatch.setattr(rmod, "_capture", capture)
    monkeypatch.setattr(rmod, "_check_device", lambda device: None)
    _, _, ts, tcam = cornell_pair
    cfg = RendererConfig(width=8, height=8, denoiser="svgf", bounces=2,
                         use_restir=True, use_restir_di=True,
                         use_radiance_cache=True, cache_query_bounce=1,
                         cache_capacity=1 << 10,
                         **{k: v for k, v in FRAME.items()
                            if k != "bounces"})
    c2w = tcam.c2w.clone()
    c2w[3, 0] += 0.1                                    # the eye moves
    moved = Camera(c2w=c2w, fov_y=tcam.fov_y, aperture=tcam.aperture,
                   focus_dist=tcam.focus_dist)
    re, rg = Renderer(ts, tcam, cfg), Renderer(ts, tcam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for cam, moved_now, frame in ((None, None, gs), (moved, True, gm),
                                  (moved, False, gs), (None, None, gs)):
        de, ae, se = re.step(se, cam=cam, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=cam)
        got = _flat((dg, ag, sg.accum.image, sg.accum.count,
                     sg.svgf.__dict__, sg.taa_history, sg.prev_cam.__dict__,
                     sg.restir.__dict__, sg.restir_di.__dict__,
                     sg.cache.__dict__))
        want = _flat((de, ae, se.accum.image, se.accum.count,
                      se.svgf.__dict__, se.taa_history,
                      se.prev_cam.__dict__, se.restir.__dict__,
                      se.restir_di.__dict__, se.cache.__dict__))
        assert len(got) == len(want) == 34
        assert all(torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b)
                   for a, b in zip(got, want))
        assert sg.sample == se.sample
    assert float(sg.accum.count) == 3.0
    assert (gs.captures, gm.captures) == (1, 1)


def _render(scene, cam, W, spp, **cfg):
    """[H,W,3] mean of spp samples, all traced as one batch (sample ids
    are per-lane counters, so this equals spp separate samples)."""
    c = RenderConfig(width=W, height=W, traversal="wavefront", **cfg)
    pix = torch.arange(W * W).repeat(spp)
    sid = torch.arange(spp).repeat_interleave(W * W)
    rad, _ = render_sample_with_stats(scene, cam, c, pix, sid)
    return rad.reshape(spp, W, W, 3).mean(0).numpy()


def test_cornell_physics():
    """The port's twin of scripts/verify_drive.py on its own build of the
    Cornell box: red wall left, green wall right, a bright light, a
    finite image; NEE + MIS and BSDF-only sampling converge to the same
    channel means (rtol 0.12, as tests/test_cornell.py)."""
    meshes, mats, cam = tcornell.make(device="cpu")
    scene = tcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True,
                     device="cpu")
    img = _render(scene, cam, 32, 16, bounces=3)
    assert np.isfinite(img).all()
    mid = img[12:20]
    left = mid[:, 1:7].mean(axis=(0, 1))
    right = mid[:, 25:31].mean(axis=(0, 1))
    assert left[0] > left[1] and right[1] > right[0]
    assert img[:6].max() > 1.0 and img.mean() > 0.01
    m_nee = _render(scene, cam, 16, 64, bounces=4).mean(axis=(0, 1))
    m_pt = _render(scene, cam, 16, 256, bounces=4,
                   use_nee=False).mean(axis=(0, 1))
    np.testing.assert_allclose(m_nee, m_pt, rtol=0.12)


@pytest.mark.parametrize("opt,value", [
    ("denoiser", "asvgf"), ("denoiser", "recur"), ("denoiser", "neural"),
    ("upscale", 2), ("partial_rendering", 2), ("traversal", "bvh2")])
def test_unported_renderer_options_raise(cornell_pair, opt, value):
    _, _, ts, tcam = cornell_pair
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        r = Renderer(ts, tcam, RendererConfig(width=8, height=8,
                                              **{opt: value}))
        r.step(r.init_state())
