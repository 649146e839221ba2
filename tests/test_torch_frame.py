"""Torch port, the frame: one path-traced sample per pixel and three
Renderer.step frames with SVGF against the JAX package on the same
(carried-across) Cornell scene, camera and sample ids (one eager JAX
Renderer run, its first frame's sample recorded on the way), and the
port's own twin of scripts/verify_drive.py's physics checks."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.renderer import Renderer as JRenderer
from truetrace_tpu.renderer import RendererConfig as JRendererConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.post.pipeline import PostConfig
from truetrace_tpu_torch.renderer import (FrameState, Renderer,
                                          RendererConfig, _tensors)
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


SVGF_FRAME = dict(width=32, height=32, denoiser="svgf", **FRAME)


@pytest.fixture(scope="module")
def jax_frames(cornell_pair):
    """Three frames of a fresh, eager JAX Renderer at SVGF_FRAME, each
    frame's render_sample_with_stats call recorded on the way (its
    arguments and results pass unchanged): the frames, the calls and the
    last state."""
    js, jcam, _, _ = cornell_pair
    calls, orig = [], jrenderer.render_sample_with_stats

    def record(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out
    jr = JRenderer(js, jcam, JRendererConfig(**SVGF_FRAME))
    st, frames = jr.init_state(), []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_sample_with_stats", record)
        for _ in range(3):
            jd, ja, st = jr.step(st)
            frames.append((np.asarray(jd), np.asarray(ja)))
    return dict(frames=frames, calls=calls, state=st)


def test_render_sample_matches_jax(cornell_pair, jax_frames):
    """One sample of a 32x32 Cornell frame, 3 bounces, Disney, tree NEE
    (the JAX Renderer's first-frame sample, recorded). The RNG and
    camera rays are bitwise and the traversal is bitwise, so pixels
    differ only by the ulps of transcendentals and contracted mul-adds
    (and, rarely, a branch flip: RR, lobe choice, bf16 light pick): >=
    99% of pixels agree to rtol 1e-4 / atol 1e-5, the image means to
    rtol 1e-4, and both packages traced the same rays."""
    _, _, ts, tcam = cornell_pair
    W = H = 32
    args, kw, (jr, jst) = jax_frames["calls"][0]
    assert int(args[4]) == 0 and kw.get("di_sample") is None \
        and kw.get("jitter") is None
    np.testing.assert_array_equal(np.asarray(args[3]), np.arange(W * H))
    rcfg = Renderer(ts, tcam, RendererConfig(**SVGF_FRAME)).rcfg
    assert (rcfg.width, rcfg.height, rcfg.bounces) == (W, H, 3)
    tr, tst = render_sample_with_stats(ts, tcam, rcfg, torch.arange(W * H), 0)
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


def test_renderer_three_svgf_frames_match_jax(cornell_pair, jax_frames):
    """Three Renderer.step frames with SVGF (ACES, TAA from frame 2,
    firefly clamp) against a fresh, eager JAX Renderer's (jax_frames):
    the displays agree to 1e-3 on >= 99% of pixels and their means to
    rtol 1e-4; the port's state carries back in from the JAX state's
    leaves."""
    _, _, ts, tcam = cornell_pair
    tr = Renderer(ts, tcam, RendererConfig(**SVGF_FRAME))
    tst = tr.init_state()
    for jd, ja in jax_frames["frames"]:
        td, ta, tst = tr.step(tst)
        td = td.numpy()
        assert td.shape == (32, 32, 3)
        assert np.isfinite(td).all() and td.min() >= 0 and td.max() <= 1
        assert _close_share(jd, td, 0.0, 1e-3) >= 0.99
        np.testing.assert_allclose(jd.mean(), td.mean(), rtol=1e-4)
        np.testing.assert_allclose(ja.mean(), ta.numpy().mean(), rtol=1e-4)
    back = FrameState.from_numpy(leaves(jax_frames["state"]), "cpu")
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
    frames of two configurations, the first eager, then the graphs of
    both cam_moved values, the first moving the camera, each fed the
    other's state, and a replay fed its own state; equal bit for bit to
    Renderer.step's display, radiance and every state tensor. The
    composed frame (SVGF, ReSTIR DI and GI, the radiance cache) under
    TAAU and partial rendering with temporal auto exposure, bloom and
    CAS: the reservoirs, the cache tables, the TAA and TAAU histories,
    partial rendering's buffers and the exposure; and the neural_taa
    frame: its history."""
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
    base = {k: v for k, v in FRAME.items() if k != "bounces"}
    composed = RendererConfig(
        width=8, height=8, denoiser="svgf", bounces=2, use_restir=True,
        use_restir_di=True, use_radiance_cache=True, cache_query_bounce=1,
        cache_capacity=1 << 10, upscale=2, partial_rendering=2,
        post=PostConfig(auto_expose=True, bloom_strength=0.08, sharpen=0.3),
        **base)
    neural = RendererConfig(
        width=8, height=8, bounces=2, denoiser="neural_taa",
        neural_weights=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples", "denoiser.msgpack"),
        **base)
    c2w = tcam.c2w.clone()
    c2w[3, 0] += 0.1                                    # the eye moves
    moved = Camera(c2w=c2w, fov_y=tcam.fov_y, aperture=tcam.aperture,
                   focus_dist=tcam.focus_dist)
    # 42: partial rendering's buffers include the instance G-buffer
    for cfg, n_state in ((composed, 42), (neural, 4)):
        re, rg = Renderer(ts, tcam, cfg), Renderer(ts, tcam, cfg)
        gs = rg.graph_step(cam_moved=False)
        gm = rg.graph_step(cam_moved=True)
        se, sg = re.init_state(), rg.init_state()
        for cam, moved_now, frame in ((None, None, gs), (moved, True, gm),
                                      (moved, False, gs), (None, None, gs)):
            de, ae, se = re.step(se, cam=cam, cam_moved=moved_now)
            dg, ag, sg = frame(sg, cam=cam)
            te, tg = _tensors(se), _tensors(sg)
            assert [k for k, _ in te] == [k for k, _ in tg]
            assert len(te) == n_state
            got = _flat((dg, ag, [t for _, t in tg], sg.prev_cam.__dict__))
            want = _flat((de, ae, [t for _, t in te], se.prev_cam.__dict__))
            assert all(torch.equal(
                a.view(torch.int32) if a.is_floating_point() else a,
                b.view(torch.int32) if b.is_floating_point() else b)
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
    ("traversal", "cwbvh"), ("sampler", "bluenoise"), ("traversal", "brute"),
    ("traversal", "woop"), ("nee_sort", True), ("debug_nee", "noshadow")])
def test_unported_renderer_options_raise(cornell_pair, opt, value):
    """Options outside the port raise naming their item: the other
    traversals (the CWBVH oracle, the MXU brute force, and a name the
    JAX package would take as BVH2), and the blue-noise sampler, NEE
    sorting and the NEE debug views, which the RendererConfig has no
    field for and the render config checks. (The TLAS traversal, terrain
    scenes and the BVH2 traversal of this list run now:
    tests/test_torch_tlas.py, test_torch_terrain.py, test_torch_forest.py
    and test_torch_bvh2.py hold them against the JAX package.)"""
    _, _, ts, tcam = cornell_pair
    renderer_opt = opt == "traversal"
    kw = {opt: value} if renderer_opt else {}
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        r = Renderer(ts, tcam, RendererConfig(width=8, height=8, **kw))
        if not renderer_opt:
            r.rcfg = dataclasses.replace(r.rcfg, **{opt: value})
        r.step(r.init_state())
