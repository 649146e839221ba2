"""Torch port, differentiable rendering (diff/render_grad.py and the
integrator's autograd graph) against the JAX package, and the JAX
package's gradient gates (tests/test_diff.py) on the port.

Parity: one JAX `render_loss_and_grad` of the 16x16 Cornell box, 3
bounces, Disney, 2 spp, traversal="wavefront" over compile_scene(
with_cwbvh=True), lit by its mesh light, a constant env and one analytic
light (so every key of get_scene_params has a gradient), against a
seeded target, is held against the port's with and without remat: the
loss to rtol 2e-5 (measured 6.2e-6), the image on every pixel to rtol
1e-4 / atol 1e-5 (measured 8.7e-4 at most relative, all pixels within
the tolerance) and its means to 1e-5, every gradient to rtol 2e-4 with
an atol of 1e-6 times the key's largest gradient (measured 6.3e-5 at
most relative). Both packages round the same float32 operations, but
XLA contracts mul-adds inside the fused jit, which the port's eager ops
do not.

The JAX package's estimator is detached sampling, and where a parameter
sits on a clip bound (metallic 0, roughness 1) jnp.clip passes half the
cotangent, as lax.max and lax.min split a tie; the port's
`core.math.clip` does the same (torch.clamp passes all of it, which
doubled those two gradients).
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.diff.render_grad import (
    render_loss_and_grad as jrender_loss_and_grad)
from truetrace_tpu.integrate.lights import AnalyticLights as JAnalyticLights
from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import EnvMap as JEnvMap
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.diff import render_grad as rg
from truetrace_tpu_torch.integrate import pathtrace
from truetrace_tpu_torch.integrate.pathtrace import RenderConfig, render
from truetrace_tpu_torch.scene import cornell as tcornell
from truetrace_tpu_torch.scene.ir import AnalyticLights, Camera, EnvMap, Scene
from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile

from torch_parity import leaves

W = H = 16
# remat's saved bytes against no remat's at least (test_remat_bounds_...)
MIN_RATIO = 20
KW = dict(width=W, height=H, bounces=3, bsdf="disney", traversal="wavefront")
LIGHT = dict(position=[[0.0, 0.45, 0.3]], direction=[[0.0, -1.0, 0.0]],
             radiance=[[3.0, 2.0, 1.0]], ltype=[0], spot_cos=[[0.9, 0.8]],
             extent=[[0.3, 0.3]], softness=[0.0])


def _light_numpy():
    return {k: np.asarray(v, np.int32 if k == "ltype" else np.float32)
            for k, v in LIGHT.items()}


@pytest.fixture(scope="module")
def ref():
    """The JAX render_loss_and_grad once, and the port's scene (the JAX
    scene's tables) and camera."""
    meshes, mats, cam = jcornell.make()
    lights = JAnalyticLights(**{k: jnp.asarray(v)
                                for k, v in _light_numpy().items()})
    js = jcompile(meshes, mats, env=JEnvMap.constant((0.4, 0.5, 0.7)),
                  lights=lights, with_cwbvh=True)
    target = np.random.default_rng(0).uniform(
        0.0, 0.5, (H, W, 3)).astype(np.float32)
    loss, grads, img = jrender_loss_and_grad(js, cam, JRenderConfig(**KW),
                                             jnp.asarray(target), spp=2)
    return dict(loss=float(loss), img=np.asarray(img), target=target,
                grads={k: np.asarray(v) for k, v in grads.items()},
                scene=Scene.from_numpy(leaves(js), "cpu"),
                cam=Camera.from_numpy(leaves(cam), "cpu"))


def _port(ref, **cfg):
    return rg.render_loss_and_grad(
        ref["scene"], ref["cam"], RenderConfig(**KW, **cfg),
        torch.from_numpy(ref["target"]), spp=2, device="cpu")


def _run(ref, remat: bool):
    """The port's render_loss_and_grad (loss, grads, image) with, beside
    it, the bytes autograd keeps for backward (the tensors saved outside
    any checkpoint, through saved_tensors_hooks, and the bounce
    checkpoints' own inputs, each storage once) and the closest-hit
    traversals it ran, forward and backward."""
    seen, calls = {}, []

    def note(t):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    def counting(fn, *a, **kw):
        if isinstance(a[1], dict):          # a bounce: (b, st)
            for v in a[1].values():
                note(v)
        return real_checkpoint(fn, *a, **kw)

    real_checkpoint, real_trace = pathtrace.checkpoint, pathtrace._trace
    pathtrace.checkpoint = counting
    pathtrace._trace = lambda *a: calls.append(1) or real_trace(*a)
    try:
        with torch.autograd.graph.saved_tensors_hooks(note, lambda t: t):
            out = _port(ref, remat=remat)
    finally:
        pathtrace.checkpoint, pathtrace._trace = real_checkpoint, real_trace
    return dict(loss=out[0], grads=out[1], img=out[2],
                saved=sum(seen.values()), traces=len(calls))


@pytest.fixture(scope="module")
def runs(ref):
    """The port without remat and with remat."""
    return {"base": _run(ref, False), "remat": _run(ref, True)}


@pytest.mark.parametrize("remat", [False, True])
def test_render_loss_and_grad_matches_jax(ref, runs, remat):
    """The loss, the image and the gradient of every key of
    get_scene_params against the JAX function (tolerances above)."""
    run = runs["remat" if remat else "base"]
    loss, grads, img = run["loss"], run["grads"], run["img"]
    assert loss.dim() == 0
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(img.numpy(), ref["img"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(img.numpy().mean((0, 1)),
                               ref["img"].mean((0, 1)), rtol=1e-5)
    assert sorted(grads) == sorted(ref["grads"]) == sorted(
        rg.DEFAULT_PARAM_KEYS + rg.SCENE_KEYS)
    for k, jg in ref["grads"].items():
        # the port holds the JAX scene's 0-d leaves as [1]
        g = grads[k].numpy().reshape(jg.shape)
        assert np.isfinite(g).all(), k
        assert np.abs(jg).max() > 0, k
        np.testing.assert_allclose(g, jg, rtol=2e-4,
                                   atol=1e-6 * np.abs(jg).max(), err_msg=k)


def test_remat_gives_the_same_gradients(runs):
    """remat=True gives remat=False's loss, image and gradients bit for
    bit on the CPU (the backward's sums run in the same order). The
    forward traces once a bounce (render_sum traces the 2 spp together);
    the recompute in backward traces every closest hit again (as
    jax.checkpoint does)."""
    base, remat = runs["base"], runs["remat"]
    n = KW["bounces"]
    assert base["traces"] == n
    assert remat["traces"] == 2 * n
    assert torch.equal(remat["loss"], base["loss"])
    assert torch.equal(remat["img"], base["img"])
    for k, g in remat["grads"].items():
        assert torch.equal(g, base["grads"][k]), k


def test_remat_bounds_the_saved_bytes(ref, runs):
    """SURVEY M3, the JAX package's memory gate, on the port: with remat
    the bytes kept for backward stay within the loop-carried state's
    bytes times (bounces + 1) per sample, plus the parameters; without,
    every bounce's shading residuals are kept, over MIN_RATIO times as
    many here (measured 25.5 times at 16x16, 3 bounces, 2 spp; with
    remat 154 kB against the bound's 248 kB)."""
    R = W * H
    # the carried state a lane: ro rd radiance throughput prev_n g_albedo
    # g_normal r_emit0 (3 floats each), prev_pdf g_depth cone_w cone_s (1
    # float), alive (1 byte), g_inst (8 bytes)
    state = R * (8 * 3 * 4 + 4 * 4 + 1 + 8)
    params = sum(v.numel() * v.element_size()
                 for v in rg.get_scene_params(ref["scene"]).values())
    spp = 2
    with_remat, without = runs["remat"]["saved"], runs["base"]["saved"]
    assert with_remat <= spp * state * (KW["bounces"] + 1) + params, (
        with_remat, state)
    assert without > MIN_RATIO * with_remat, (without, with_remat)


def test_capture_with_remat_records_each_bounce_once(ref):
    """The cache capture is returned by the pure bounce body, so a
    checkpoint's recompute in backward appends nothing: the [R, B] records
    of remat=True equal remat=False's after a backward pass."""
    sc = ref["scene"]
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in rg.get_scene_params(sc).items()}
    out = {}
    for remat in (False, True):
        cfg = RenderConfig(**KW, cache_capture=True, remat=remat)
        rad, st = pathtrace.render_sample_with_stats(
            rg.set_scene_params(sc, p), ref["cam"], cfg, torch.arange(W * H),
            5)
        rad.sum().backward()
        out[remat] = st
    for k in ("cache_w0", "cache_w1", "cache_prefix", "cache_tp",
              "cache_live"):
        assert out[True][k].shape[:2] == (W * H, KW["bounces"]), k
        assert torch.equal(out[True][k].detach(), out[False][k].detach()), k


def _wrappers():
    """(name, call with a tensor that requires grad) for every kernel
    wrapper; the refusal comes before any shape check."""
    from truetrace_tpu_torch.kernels import (atrous_pallas, cwbvh_tlas,
                                             cwbvh_wavefront, heightmap,
                                             step_pallas)
    ro = torch.zeros((4, 3), requires_grad=True)
    rd = torch.ones((4, 3))
    tab = torch.zeros((8, 60))
    tm = torch.ones(4)
    cw, tl = cwbvh_wavefront, cwbvh_tlas
    return {
        "closest_hit_wavefront": lambda: cw.closest_hit_wavefront(
            tab, 4, ro, rd, tm, max_stack=16),
        "any_hit_wavefront": lambda: cw.any_hit_wavefront(
            tab, 4, ro, rd, tm, max_stack=16),
        "transmit_wavefront": lambda: cw.transmit_wavefront(
            tab, 4, torch.ones((2, 3)), ro, rd, tm, max_stack=16),
        "closest_hit_tlas": lambda: tl.closest_hit_tlas(tab, 2, 2, ro, rd,
                                                        tm),
        "any_hit_tlas": lambda: tl.any_hit_tlas(tab, 2, 2, ro, rd, tm),
        "transmit_tlas": lambda: tl.transmit_tlas(
            tab, 2, 2, torch.ones((2, 3)), ro, rd, tm),
        "heightmap_closest": lambda: heightmap.heightmap_closest(
            None, ro, rd, tm),
        "heightmap_any": lambda: heightmap.heightmap_any(None, ro, rd, tm),
        "atrous_pass_packed": lambda: atrous_pallas.atrous_pass_packed(
            torch.zeros((4, 4, 4), requires_grad=True),
            torch.zeros((4, 4, 4)), 1),
        "step_core": lambda: step_pallas.step_core(
            torch.zeros((32, 4), dtype=torch.int32),
            torch.zeros((9, 4), requires_grad=True),
            torch.zeros((5, 4), dtype=torch.int32)),
    }


@pytest.mark.parametrize("name", sorted(_wrappers()))
def test_kernel_wrappers_refuse_grad(name):
    """Every kernel wrapper raises ValueError, naming where to detach, on
    a tensor that requires grad (a launch on data_ptr() would cut the
    graph without a word), on the CPU as on the card."""
    with pytest.raises(ValueError, match="requires grad.*detach"):
        _wrappers()[name]()


# ---------------------------------------------------------------------------
# the JAX package's gates (tests/test_diff.py) on the port
# ---------------------------------------------------------------------------

# tests/test_diff.py's gates at 16x16 and 4 spp (24x24 and 8 spp there;
# chip_smoke.py runs them at those sizes on the card): the detached
# estimator with common random numbers differentiates the same function
# as the central differences at any size, so the gates keep their
# tolerances
GATE_RES, GATE_SPP = 16, 4


@pytest.fixture(scope="module")
def setup():
    meshes, mats, cam = tcornell.make(device="cpu")
    scene = tcompile(meshes, mats, with_cwbvh=True, device="cpu")
    cfg = RenderConfig(width=GATE_RES, height=GATE_RES, bounces=3,
                       bsdf="disney", traversal="wavefront")
    return scene, cam, cfg


def _loss(scene, cam, cfg, spp=GATE_SPP):
    return torch.mean(render(scene, cam, cfg, spp=spp))


def _fd_check(setup, key, eps, rtol, atol=1e-6, direction=None):
    """AD directional derivative of the mean image against central
    differences, for a material column the sampler does not read."""
    scene, cam, cfg = setup
    v0 = getattr(scene.materials, key)

    def loss_of(v):
        return _loss(rg.set_material_params(scene, {key: v}), cam, cfg)

    v = v0.detach().clone().requires_grad_(True)
    g_ad, = torch.autograd.grad(loss_of(v), v)
    if direction is None:
        direction = torch.from_numpy(np.random.default_rng(0).normal(
            size=tuple(v0.shape)).astype(np.float32))
    with torch.no_grad():
        fd = (loss_of(v0 + eps * direction) - loss_of(v0 - eps * direction)
              ) / (2 * eps)
    ad = torch.sum(g_ad * direction)
    np.testing.assert_allclose(float(ad), float(fd), rtol=rtol, atol=atol)


def test_grad_albedo(setup):
    _fd_check(setup, "base_color", eps=1e-3, rtol=0.05)


def test_grad_emission(setup):
    """Only the light's row: a non-light's emission is a
    non-differentiable point (the light list gates it)."""
    scene = setup[0]
    d = np.zeros(tuple(scene.materials.emission.shape), np.float32)
    d[3] = (1.0, 0.8, 0.6)          # the light's material row
    _fd_check(setup, "emission", eps=1e-2, rtol=0.05,
              direction=torch.from_numpy(d))


def test_grad_roughness_bsdf_level():
    """Roughness changes the sampler, so the check is a fixed-direction
    BSDF integral, where detached AD and central differences agree."""
    from truetrace_tpu_torch.core import rng as trng
    from truetrace_tpu_torch.core.math import dot
    from truetrace_tpu_torch.kernels.disney import disney_eval
    from truetrace_tpu_torch.scene.mesh import HostMaterial, material_table

    R = 1 << 14
    wo = torch.tensor([0.4, 0.0, 0.9165151]).expand(R, 3)
    n = torch.tensor([0.0, 0.0, 1.0]).expand(R, 3)
    u = trng.uniform2(torch.arange(R), 5, 9)
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u[..., 1]
    wi = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    table = material_table([HostMaterial(base_color=(0.7, 0.6, 0.5),
                                         metallic=0.5)], "cpu")

    def integral(rough):
        mat = table.gather(torch.zeros((R,), dtype=torch.int64))
        mat.roughness = rough.expand(R)
        f, _ = disney_eval(mat, n, wo, wi)
        return torch.mean(torch.sum(f, -1) * dot(wi, n).abs()) * 4 * math.pi

    r0 = torch.tensor(0.4, requires_grad=True)
    ad, = torch.autograd.grad(integral(r0), r0)
    eps = 1e-3
    with torch.no_grad():
        fd = (integral(r0 + eps) - integral(r0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(ad), float(fd), rtol=0.02, atol=1e-4)


def test_grad_nonzero_and_finite(setup):
    scene, cam, cfg = setup
    target = torch.zeros((cfg.height, cfg.width, 3))
    loss, grads, img = rg.render_loss_and_grad(scene, cam, cfg, target,
                                               spp=GATE_SPP, device="cpu")
    assert math.isfinite(float(loss))
    for k in ("base_color", "roughness", "emission", "metallic",
              "env_intensity"):
        assert torch.isfinite(grads[k]).all(), k
    assert float(grads["base_color"].abs().max()) > 0.0
    assert float(grads["emission"].abs().max()) > 0.0


def test_optimization_recovers_albedo(setup):
    """Gradient steps move a perturbed wall colour towards the target
    image's (inverse rendering end to end); 2 spp a step (4 in
    tests/test_diff.py)."""
    scene, cam, cfg = setup
    with torch.no_grad():
        target = render(scene, cam, cfg, spp=2 * GATE_SPP)
    bc = scene.materials.base_color.clone()
    bc[1] = torch.tensor([0.2, 0.6, 0.7])
    cur = rg.set_material_params(scene, {"base_color": bc})
    losses = []
    for i in range(10):
        loss, grads, _ = rg.render_loss_and_grad(
            cur, cam, cfg, target, spp=GATE_SPP // 2,
            base_sample=100 + i * 7, device="cpu")
        p = rg.get_material_params(cur)
        g = grads["base_color"]
        step = 0.05 / torch.clamp(g.abs().max(), min=1e-6)
        p["base_color"] = torch.clamp(p["base_color"] - step * g, 0.0, 1.0)
        cur = rg.set_material_params(cur, p)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses


def _cornell_with(env=None, lights=None):
    meshes, mats, cam = tcornell.make(device="cpu")
    scene = tcompile(meshes, mats, env=env, lights=lights, with_cwbvh=True,
                     device="cpu")
    cfg = RenderConfig(width=16, height=16, bounces=2, bsdf="lambert",
                       traversal="wavefront")
    return scene, cam, cfg


def test_grad_env_intensity_fd():
    """A linear parameter: AD and central differences agree to 2%."""
    scene, cam, cfg = _cornell_with(env=EnvMap.constant((0.4, 0.5, 0.7),
                                                        device="cpu"))

    def loss_of(inten):
        sc = rg.set_scene_params(scene, {"env_intensity": inten})
        return _loss(sc, cam, cfg, spp=4)

    x = torch.tensor(1.0, requires_grad=True)
    g_ad = float(torch.autograd.grad(loss_of(x), x)[0])
    eps = 1e-2
    with torch.no_grad():
        g_fd = (float(loss_of(torch.tensor(1.0 + eps)))
                - float(loss_of(torch.tensor(1.0 - eps)))) / (2 * eps)
    assert abs(g_ad - g_fd) <= 0.02 * max(abs(g_fd), 1e-6), (g_ad, g_fd)
    assert abs(g_ad) > 1e-6


def test_grad_light_radiance_fd():
    """Analytic-light radiance: AD against central differences to 5%."""
    scene, cam, cfg = _cornell_with(
        lights=AnalyticLights.from_numpy(_light_numpy(), "cpu"))

    def loss_of(rad):
        sc = rg.set_scene_params(scene, {"light_radiance": rad})
        return _loss(sc, cam, cfg, spp=4)

    r0 = scene.lights.radiance
    r = r0.clone().requires_grad_(True)
    g_ad = torch.autograd.grad(loss_of(r), r)[0].numpy()
    d = np.asarray([[0.7, -0.3, 0.5]], np.float32)
    eps = 1e-2
    with torch.no_grad():
        lp = float(loss_of(r0 + eps * torch.from_numpy(d)))
        lm = float(loss_of(r0 - eps * torch.from_numpy(d)))
    fd_dir = (lp - lm) / (2 * eps)
    ad_dir = float((g_ad * d).sum())
    assert abs(ad_dir - fd_dir) <= 0.05 * max(abs(fd_dir), 1e-7), (
        ad_dir, fd_dir)
    assert abs(ad_dir) > 1e-8


def test_scene_params_roundtrip(setup):
    """get / set_scene_params swap columns without touching the rest:
    the traversal table is shared, not packed again."""
    scene = setup[0]
    table = scene.cw_table()
    p = rg.get_scene_params(scene)
    assert "env_intensity" in p and "light_radiance" not in p
    p2 = {k: v * 2.0 for k, v in p.items()}
    sc = rg.set_scene_params(scene, p2)
    assert float(sc.env.intensity) == 2.0 * float(scene.env.intensity)
    np.testing.assert_allclose(sc.materials.base_color.numpy(),
                               2.0 * scene.materials.base_color.numpy())
    assert sc.cw_table() is table
    assert sc.materials.ior is scene.materials.ior
    with pytest.raises(ValueError, match="not cuda"):
        rg.render_loss_and_grad(scene, setup[1], setup[2],
                                torch.zeros((GATE_RES, GATE_RES, 3)))
    assert dataclasses.fields(sc) == dataclasses.fields(scene)
