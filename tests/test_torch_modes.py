"""Torch port, the frame modes of the Renderer against one eager run of a
fresh JAX Renderer: TAAU (upscale=2: the Halton jitter, the trace at
the internal size, the upscaler and the output-size TAA), partial
rendering (partial_rendering=2: the rolling half of the pixels, the
compose buffers and their reprojection on a camera move, the ReSTIR DI
prepass and ReSTIR GI channels composed, the warm-up restart of the
running mean) and temporal auto exposure, on the Cornell box lit by its
mesh light and 12 analytic lights (RIS), with SVGF, ReSTIR GI and DI,
and the post chain AgX + bloom 0.08 + CAS 0.3: a 16x16 output, three
frames, the camera moving along x and y on the second and third (a
still camera's motion vectors are rounding noise, ROADMAP.md §C).

The JAX Renderer runs as it is; only its traced sample,
render_sample_with_stats, is jitted once per shape where the renderer
looks it up (pytest's monkeypatch; no JAX file changes), so its six
samples compile two traces (the prepass and the main trace).

Tolerance: the display within 1e-3 on every pixel, the accumulation,
the exposure and every other FrameState tensor to rtol 1e-4 / atol 1e-5
on every element (the traces agree to the last few ulps; the filters'
exp and pow round differently in the two frameworks), the integer
buffers exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import analytic_lights_host
from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.integrate import pathtrace as jpathtrace
from truetrace_tpu.post.pipeline import PostConfig as JPostConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import AnalyticLights as JAnalyticLights
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.post.pipeline import PostConfig
from truetrace_tpu_torch.renderer import (FrameState, Renderer,
                                          RendererConfig, _tensors)
from truetrace_tpu_torch.scene.ir import Camera, Scene

from torch_parity import close_share, leaves

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(width=16, height=16, bounces=2, bsdf="disney",
           traversal="wavefront", light_sampling="tree", denoiser="svgf",
           upscale=2, partial_rendering=2, use_restir=True,
           use_restir_di=True)
# the exposure scale keeps the display off white: the first frame's
# temporal exposure starts at its cap (half its traced pixels are cold
# zeros, so the median bin is the lowest) and adapts a few percent a
# frame
POST = dict(tonemap="agx", bloom_strength=0.08, sharpen=0.3,
            auto_expose=True, exposure=1e-3)
MOVES = (0.0, 0.03, 0.06)      # the eye's offset along x and y a frame


def _moved(cam, dx, cls, arr):
    c2w = np.asarray(cam.c2w).copy()
    c2w[3, :2] += dx
    return cls(c2w=arr(c2w), fov_y=cam.fov_y, aperture=cam.aperture,
               focus_dist=cam.focus_dist)


@pytest.fixture(scope="module")
def run():
    """Three frames of the JAX Renderer: [(display, radiance, state
    leaves)], with the scene and cameras carried across."""
    meshes, mats, jcam = jcornell.make()
    d = analytic_lights_host((0.05, 0.25, 0.05), (0.5, 0.5, 0.5),
                             counts=(3, 3, 3, 2, 1), seed=12)
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True,
                  lights=JAnalyticLights(**{k: jnp.asarray(v)
                                            for k, v in d.items()}))
    jr = jrenderer.Renderer(js, jcam, jrenderer.RendererConfig(
        post=JPostConfig(**POST), **CFG))
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
            disp, acc, st = jr.step(st, cam=cam, cam_moved=i > 0 or None)
            frames.append((np.asarray(disp), np.asarray(acc), leaves(st)))
    tcam = Camera.from_numpy(leaves(jcam), "cpu")
    return dict(frames=frames, scene=Scene.from_numpy(leaves(js), "cpu"),
                cam=tcam, cams=[None] + [
                    _moved(tcam, dx, Camera, torch.from_numpy)
                    for dx in MOVES[1:]])


def _renderer(run):
    return Renderer(run["scene"], run["cam"], RendererConfig(
        post=PostConfig(**POST), **CFG))


def _flat_leaves(d, prefix=""):
    """The JAX state's leaves by the port's dotted names (_tensors)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}."))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


def _check_frame(i, td, ta, tst, want):
    jd, ja, jl = want
    assert td.shape == (16, 16, 3)
    assert close_share(jd, td.numpy(), 0.0, 1e-3) == 1.0, f"frame {i}"
    np.testing.assert_allclose(ta.numpy(), ja, err_msg=f"frame {i}", **TOL)
    j = _flat_leaves(jl)
    names = dict(_tensors(tst))
    # the partial instance G-buffer is -1 on a single-BLAS scene
    assert (np.asarray(j["partial.inst"]) == -1).all()
    for k, t in names.items():
        w = np.asarray(j[k])
        if w.dtype.kind in "biu":
            assert (t.numpy() == w).all(), f"frame {i}: {k}"
        else:
            np.testing.assert_allclose(t.numpy(), w,
                                       err_msg=f"frame {i}: {k}", **TOL)
    # every JAX tensor but the cameras and sample id has its port twin
    rest = {k for k in j if not k.startswith(("prev_cam.", "sample",
                                              "prev_inst_l2w"))}
    assert rest == set(names), rest ^ set(names)
    assert tst.sample == int(jl["sample"]) == i + 1


def test_frames_match_jax(run):
    """The three frames from init_state: the display, the accumulation
    and every FrameState tensor (the TAA and TAAU histories, the
    exposure, partial rendering's buffers, SVGF and both reservoirs'
    states). Partial rendering's warm-up restarts the running mean in
    the first frame (k - 1 = 1) and the camera moves restart it in the
    others; the exposure starts cold."""
    r = _renderer(run)
    st = r.init_state()
    assert float(st.exposure) == -1.0
    for i, cam in enumerate(run["cams"]):
        td, ta, st = r.step(st, cam=cam, cam_moved=i > 0 or None)
        _check_frame(i, td, ta, st, run["frames"][i])
        assert 0.1 < float(td.mean()) < 0.9        # not blown out
    assert st.taau_history.shape == (16, 16, 3)
    assert st.partial["rad"].shape == (64, 3)


def test_resumes_from_the_jax_state(run):
    """Frame 2 resumed from the JAX state after frame 1 (carried across
    with FrameState.from_numpy, prev_cam and all) matches the JAX frame
    2, as does the third frame after it."""
    r = _renderer(run)
    st = FrameState.from_numpy(run["frames"][0][2], "cpu")
    assert st.partial is not None and "inst" in st.partial
    for i in (1, 2):
        td, ta, st = r.step(st, cam=run["cams"][i], cam_moved=True)
        _check_frame(i, td, ta, st, run["frames"][i])


def test_config_errors():
    """A partial interleave that does not divide the traced pixels, and a
    traced size the U-Net cannot halve twice, are ValueErrors."""
    with pytest.raises(ValueError, match="partial_rendering"):
        RendererConfig(width=10, height=10, upscale=2,
                       partial_rendering=3).check_supported()
    with pytest.raises(ValueError, match="multiples of 4"):
        RendererConfig(width=12, height=12, upscale=2,
                       denoiser="neural").check_supported()
    assert RendererConfig(width=12, height=8, upscale=2).internal_size \
        == (4, 6)
    assert dataclasses.replace(RendererConfig(), upscale=4).render_config(
    ).width == 128
