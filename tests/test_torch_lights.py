"""Torch port, analytic lights (integrate/lights.py and the integrator's
third NEE group) against the JAX package, on the same numpy inputs:
the five light types with softness and z_rot (sample_analytic and
sample_analytic_idx), the RIS target weight, streaming RIS, and one
path-traced sample of the 16x16 Cornell box lit by 4 analytic lights
(uniform selection) and by 12 (RIS over 8 candidates) beside its mesh
light.

Tolerance: the light functions to rtol 1e-4 / atol 1e-6 on every
element, their boolean outputs exactly. Both packages round the same
float32 operations, but sin and cos (the quad's z_rot, the disk's and
the soft lights' angles) differ in the last ulp between the two
frameworks, and an area light's pdf d^2 / (cos A) multiplies that by
1/cos near grazing (1e-5 relative seen on one lane in 512). The samples
by check_sample's rule (>= 99% of pixels to rtol 1e-4 / atol 1e-5, the
same ray counts).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import analytic_lights_host
from truetrace_tpu.integrate import lights as jlights
from truetrace_tpu.integrate.pathtrace import RenderConfig as JRenderConfig
from truetrace_tpu.integrate.pathtrace import (
    render_sample_with_stats as jrender_sample_with_stats)
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import AnalyticLights as JAnalyticLights
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate import lights as tlights
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.scene.ir import AnalyticLights, Camera, Scene

from torch_parity import check_sample, leaves

TOL = dict(rtol=1e-4, atol=1e-6)
R = 512
# the Cornell box's inside, below its ceiling
BOX = ((0.05, 0.25, 0.05), (0.5, 0.5, 0.5))


def _pair(counts, seed=0):
    d = analytic_lights_host(*BOX, counts=counts, seed=seed)
    return (JAnalyticLights(**{k: jnp.asarray(v) for k, v in d.items()}),
            AnalyticLights.from_numpy(d, "cpu"))


def _inputs(n_cand=8, seed=1):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.uniform(size=s).astype(np.float32)
    p = (np.asarray(BOX[0]) + (np.asarray(BOX[1]) - np.asarray(BOX[0]))
         * f(R, 3)).astype(np.float32)
    p[:, 1] *= 0.5                      # below the lights, mostly
    return dict(p=p, u_sel=f(R), u2=f(R, 2), u_cands=f(R, n_cand),
                u_keep=f(R, n_cand))


def _same(js, ts):
    """Two AnalyticSamples: floats within TOL, booleans equal."""
    for k in js._fields:
        j, t = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        if j.dtype == bool:
            assert (j == t).all(), k
        else:
            np.testing.assert_allclose(t, j, err_msg=k, **TOL)


@pytest.mark.parametrize("kind", ["point", "spot", "quad", "disk",
                                  "directional", "mixed"])
def test_sample_analytic_matches_jax(kind):
    """sample_analytic (uniform pick) on 6 lights of one kind, or 16 of
    every kind, with softness and z_rot set, from random points."""
    counts = {"point": (6, 0, 0, 0, 0), "spot": (0, 6, 0, 0, 0),
              "quad": (0, 0, 6, 0, 0), "disk": (0, 0, 0, 6, 0),
              "directional": (0, 0, 0, 0, 6),
              "mixed": (4, 4, 4, 3, 1)}[kind]
    jl, tl = _pair(counts)
    x = _inputs()
    js = jlights.sample_analytic(jl, jnp.asarray(x["p"]),
                                 jnp.asarray(x["u_sel"]),
                                 jnp.asarray(x["u2"]))
    ts = tlights.sample_analytic(tl, torch.from_numpy(x["p"]),
                                 torch.from_numpy(x["u_sel"]),
                                 torch.from_numpy(x["u2"]))
    _same(js, ts)
    assert np.asarray(js.valid).any()
    if kind == "directional":
        assert (ts.dist.numpy() == 1e30).all()


def test_target_weight_and_ris_match_jax():
    """analytic_target_weight over every light from every point, and
    sample_analytic_ris's pick, effective pmf and sample over 8
    candidates among 16 lights; and the port's own empty (K = 0) path."""
    jl, tl = _pair((4, 4, 4, 3, 1))
    x = _inputs()
    idx = np.arange(R) % 16
    jw = jlights.analytic_target_weight(jl, jnp.asarray(idx, jnp.int32),
                                        jnp.asarray(x["p"]))
    tw = tlights.analytic_target_weight(tl, torch.from_numpy(idx),
                                        torch.from_numpy(x["p"]))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
    assert (tw.numpy() > 0).all()
    args = [x[k] for k in ("p", "u_cands", "u_keep", "u2")]
    js = jlights.sample_analytic_ris(jl, *map(jnp.asarray, args))
    ts = tlights.sample_analytic_ris(tl, *map(torch.from_numpy, args))
    _same(js, ts)
    empty = tlights.sample_analytic(AnalyticLights.none("cpu"),
                                    torch.from_numpy(x["p"]),
                                    torch.from_numpy(x["u_sel"]),
                                    torch.from_numpy(x["u2"]))
    assert not empty.valid.any() and empty.wi.shape == (R, 3)


@pytest.fixture(scope="module")
def cornell():
    meshes, mats, cam = jcornell.make()
    return meshes, mats, cam, Camera.from_numpy(leaves(cam), "cpu")


@pytest.mark.parametrize("n_lights", [4, 12])
def test_render_sample_with_analytic_lights_matches_jax(cornell, n_lights):
    """One sample of the 16x16 Cornell box, 3 bounces, Disney, light
    tree, with 4 analytic lights (a point, a spot, a quad, a directional
    one; uniform selection, since analytic_ris = 8 >= 4) or 12 (RIS):
    three NEE groups, the directional light's shadow rays at t_max
    ~1e30; check_sample's rule."""
    meshes, mats, jcam, tcam = cornell
    counts = (1, 1, 1, 0, 1) if n_lights == 4 else (3, 3, 3, 2, 1)
    jl, _ = _pair(counts, seed=n_lights)
    js = jcompile(meshes, mats, lights=jl, with_cwbvh=True,
                  with_light_bvh=True)
    ts = Scene.from_numpy(leaves(js), "cpu")
    assert ts.lights.position.shape[0] == n_lights
    W = H = 16
    kw = dict(width=W, height=H, bounces=3, bsdf="disney",
              traversal="wavefront", light_sampling="tree")
    jcfg = JRenderConfig(**kw)
    f = jax.jit(lambda s, c, p: jrender_sample_with_stats(s, c, jcfg, p, 3))
    jr, jst = f(js, jcam, jnp.arange(W * H, dtype=jnp.uint32))
    tr, tst = render_sample_with_stats(ts, tcam, RenderConfig(**kw),
                                       torch.arange(W * H), 3)
    check_sample(jr, jst, tr, tst, 0.99)
    assert float(tst["n_shadow"]) > 0
