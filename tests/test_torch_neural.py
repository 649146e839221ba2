"""Torch port, the neural denoiser (post/neural.py and the Renderer's
`neural` / `neural_taa` denoisers) against the JAX package: the msgpack
reader against flax's on the in-repo checkpoint examples/denoiser.msgpack,
every leaf bit for bit; the U-Net's denoise with those weights and with
the JAX package's own random initialisation carried across; and two
neural_taa Renderer frames of the 8x8 Cornell box (the second moving
the camera along x and y, ROADMAP.md §C) against a fresh JAX Renderer.

Tolerance: denoise to rtol 1e-4 / atol 1e-5 on every element (XLA's and
torch's convolutions sum their 3x3xC products in other orders); the
Renderer's display within 1e-3 on every pixel, its accumulation and
neural_taa history to rtol 1e-4 / atol 1e-5."""
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.integrate import pathtrace as jpathtrace
from truetrace_tpu.post import neural as jneural
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.post import neural as tneural
from truetrace_tpu_torch.renderer import Renderer, RendererConfig
from truetrace_tpu_torch.scene.ir import Camera, Scene

from torch_parity import close_share, leaves

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "denoiser.msgpack")
TOL = dict(rtol=1e-4, atol=1e-5)


def _walk(a, b, path=""):
    assert isinstance(b, dict) and a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), f"{path}/{k}"


def test_msgpack_reader_matches_flax():
    """The checkpoint, and a tree of the other leaves flax writes
    (integer arrays, numpy scalars, an empty float16 array, nested lists
    of ints, floats, strings, None and booleans), read as flax reads
    them."""
    data = open(WEIGHTS, "rb").read()
    ref = flax.serialization.msgpack_restore(data)
    _walk(ref, tneural.read_msgpack(data))
    assert ref["ConvBlock_3"]["Conv_0"]["kernel"].shape == (3, 3, 144, 48)
    tree = {"a": np.arange(5, dtype=np.int64), "s": np.float32(3.5),
            "z": np.zeros((0, 3), np.float16),
            "l": [1, -3, 300, -70000, 2 ** 40, 1.5, "x" * 40, None, True]}
    enc = flax.serialization.msgpack_serialize(tree)
    got = tneural.read_msgpack(enc)
    assert got["l"] == tree["l"] and got["s"] == tree["s"]
    assert got["s"].dtype == np.float32
    assert got["a"].tobytes() == tree["a"].tobytes()
    assert got["z"].shape == (0, 3) and got["z"].dtype == np.float16
    with pytest.raises(ValueError, match="trailing"):
        tneural.read_msgpack(enc + b"\x00")


def _inputs(seed, h=16, w=20):
    r = np.random.default_rng(seed)
    n = r.normal(size=(h, w, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((r.exponential(size=(h, w, 3)) * 2.0).astype(np.float32),
            r.uniform(size=(h, w, 3)).astype(np.float32), n)


@pytest.mark.parametrize("weights", ["file", "random_init"])
def test_denoise_matches_jax(weights):
    """denoise on a 16x20 frame with the checkpoint's weights, and with
    the JAX package's init_params(PRNGKey(0)) carried across by
    params_from_numpy (HWIO kernels to OIHW)."""
    if weights == "file":
        tree = flax.serialization.msgpack_restore(open(WEIGHTS, "rb").read())
        model = tneural.load_denoiser(WEIGHTS, "cpu")
    else:
        tree = jax.tree_util.tree_map(
            np.asarray, jneural.init_params(jax.random.PRNGKey(0), 16, 16))
        model = tneural.DenoiserUNet().requires_grad_(False)
        model.load_state_dict(tneural.params_from_numpy(tree))
    noisy, alb, nrm = _inputs(3)
    want = jneural.denoise(tree, *map(jnp.asarray, (noisy, alb, nrm)))
    got = tneural.denoise(model, *map(torch.from_numpy, (noisy, alb, nrm)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy() >= 0).all()
    assert not any(p.requires_grad for p in
                   tneural.load_denoiser(WEIGHTS, "cpu").parameters())


def test_missing_weights_raise(tmp_path):
    """No weights file is a ValueError naming the JAX package's random
    init, which the port cannot reproduce; a path with no file raises."""
    with pytest.raises(ValueError, match="PRNGKey"):
        tneural.load_denoiser("", "cpu")
    with pytest.raises(FileNotFoundError):
        tneural.load_denoiser(str(tmp_path / "none.msgpack"), "cpu")


def test_renderer_neural_taa_matches_jax():
    """Two Renderer frames with denoiser="neural_taa" and the checkpoint
    (the U-Net, then the alpha-0.2 reprojected, clamped blend of its
    output): the display, the accumulation and the neural history."""
    meshes, mats, jcam = jcornell.make()
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True)
    kw = dict(width=8, height=8, bounces=2, bsdf="disney",
              traversal="wavefront", light_sampling="tree",
              denoiser="neural_taa", neural_weights=WEIGHTS)
    jr = jrenderer.Renderer(js, jcam, jrenderer.RendererConfig(**kw))
    traced = jax.jit(jpathtrace.render_sample_with_stats,
                     static_argnames=("cfg",))

    def render(scene, cam, cfg, pixel, sample_id, **k):
        return traced(scene, cam, cfg=cfg, pixel=pixel,
                      sample_id=jnp.asarray(sample_id, jnp.uint32), **k)

    c2w = np.asarray(jcam.c2w).copy()
    c2w[3, :2] += 0.04
    jmoved = JCamera(c2w=jnp.asarray(c2w), fov_y=jcam.fov_y,
                     aperture=jcam.aperture, focus_dist=jcam.focus_dist)
    tr = Renderer(Scene.from_numpy(leaves(js), "cpu"),
                  Camera.from_numpy(leaves(jcam), "cpu"),
                  RendererConfig(**kw))
    jst, tst = jr.init_state(), tr.init_state()
    assert torch.equal(tst.neural_hist, torch.zeros((8, 8, 3)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrenderer, "render_sample_with_stats", render)
        for cam in (None, jmoved):
            jd, ja, jst = jr.step(jst, cam=cam, cam_moved=cam is not None
                                  or None)
            td, ta, tst = tr.step(
                tst, cam=None if cam is None else Camera.from_numpy(
                    leaves(cam), "cpu"), cam_moved=cam is not None or None)
            assert close_share(np.asarray(jd), td.numpy(), 0.0, 1e-3) == 1.0
            for j, t in ((ja, ta), (jst.neural_hist, tst.neural_hist),
                         (jst.taa_history, tst.taa_history)):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    assert float(tst.neural_hist.abs().sum()) > 0
