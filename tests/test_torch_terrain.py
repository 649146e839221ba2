"""Torch port, terrain: the heightfield build (make_terrain, demo_hills,
scatter_on_terrain) exactly the JAX package's; the plain march (the CPU
path of heightmap_closest / heightmap_any, and the CUDA kernel's
reference on the card) against the JAX march; the layer weights; a
terrain scene through the path tracer's bounce; the atmosphere LUTs and
the baked sky."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.kernels import heightmap as jhm
from truetrace_tpu.scene import atmosphere as jatm
from truetrace_tpu.scene import terrain as jter
from truetrace_tpu_torch.kernels import heightmap as thm
from truetrace_tpu_torch.scene import atmosphere as tatm
from truetrace_tpu_torch.scene import terrain as tter

from torch_parity import check_sample

KW = dict(origin=(-3.0, 0.5, -2.0), size_xz=(10.0, 12.0), mat_ids=[0, 1],
          height_scale=2.0)


@pytest.fixture(scope="module")
def terrains():
    hm = jter.demo_hills(65, seed=2)
    am = np.random.default_rng(3).uniform(0, 1, (9, 9, 4)).astype(np.float32)
    return (jter.make_terrain(hm, alphamap=am, **KW),
            tter.make_terrain(hm, alphamap=am, device="cpu", **KW))


@pytest.fixture(scope="module")
def rays():
    """Rays from above and inside the box, looking down and sideways,
    some starting outside it, some missing it; dead lanes (t_max 0)."""
    rng = np.random.default_rng(1)
    R = 3000
    ro = np.stack([rng.uniform(-5, 9, R), rng.uniform(0, 6, R),
                   rng.uniform(-4, 12, R)], -1).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d[:, 1] -= 0.5
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.0, 30.0, R).astype(np.float32)
    tm[:100] = 0.0
    return ro, rd, tm


@pytest.mark.parametrize("n,seed", [(33, 0), (65, 4), (129, 7)])
def test_terrain_build_matches_jax(n, seed):
    """demo_hills, make_terrain's tables and scatter_on_terrain's
    transforms, exactly; the port's placement constants are the JAX
    terrain's float32 values."""
    hm = jter.demo_hills(n, seed=seed)
    assert (tter.demo_hills(n, seed=seed) == hm).all()
    jt = jter.make_terrain(hm, **KW)
    tt = tter.make_terrain(hm, device="cpu", **KW)
    for f in ("height", "origin", "size", "h_max", "alphamap", "mat_ids"):
        want, got = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert got.shape == want.shape and (got == want).all(), f
    assert tt.hm_shape == jt.hm_shape
    assert tt.consts == tuple(float(v) for v in np.concatenate(
        [np.asarray(jt.origin), np.asarray(jt.size),
         np.asarray(jt.h_max).reshape(1)]))
    kw = dict(origin=KW["origin"], size_xz=KW["size_xz"],
              height_scale=KW["height_scale"], n=40, seed=seed,
              max_slope=0.8)
    a, b = jter.scatter_on_terrain(hm, **kw), tter.scatter_on_terrain(hm, **kw)
    assert len(a) == len(b) and all(
        sa == sb and (ma == mb).all() for (sa, ma), (sb, mb) in zip(a, b))


def _bits(a):
    return np.asarray(a).view(np.int32)


def test_heightmap_closest_plain_matches_jax(terrains, rays):
    """valid, t and uv bit for bit; the normal within rtol 1e-5 / atol
    1e-5 on the hit lanes (XLA:CPU contracts the central difference's
    samples inside the fused march at other products than anywhere the
    port can follow, ROADMAP.md §C)."""
    jt, tt = terrains
    ro, rd, tm = rays
    jh = jhm.heightmap_closest(jt, jnp.asarray(ro), jnp.asarray(rd),
                               jnp.asarray(tm))
    th = thm.heightmap_closest(tt, torch.from_numpy(ro), torch.from_numpy(rd),
                               torch.from_numpy(tm))
    valid = np.asarray(jh.valid)
    assert (th.valid.numpy() == valid).all()
    assert 0.1 < valid.mean() < 0.9 and not valid[:100].any()
    assert (_bits(jh.t) == _bits(th.t.numpy())).all()
    assert (_bits(jh.uv) == _bits(th.uv.numpy())).all()
    np.testing.assert_allclose(th.normal.numpy()[valid],
                               np.asarray(jh.normal)[valid], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("steps", [96, 24])
def test_heightmap_any_plain_matches_jax(terrains, rays, steps):
    """The any hit (the march to its first crossing, no bisection)
    exactly JAX's heightmap_any, and its closest hit's valid."""
    jt, tt = terrains
    ro, rd, tm = rays
    want = np.asarray(jhm.heightmap_any(jt, jnp.asarray(ro), jnp.asarray(rd),
                                        jnp.asarray(tm), steps=steps))
    counts = {}
    got = thm.heightmap_any_plain(tt, torch.from_numpy(ro),
                                  torch.from_numpy(rd), torch.from_numpy(tm),
                                  steps=steps, counts=counts).numpy()
    assert (got == want).all() and 0.1 < got.mean() < 0.9
    c_counts = {}
    closest = thm.heightmap_closest_plain(
        tt, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tm),
        steps=steps, counts=c_counts)
    assert (closest.valid.numpy() == got).all()
    # the samples the function needs: the start where the clip is not
    # empty, the march to the first crossing where the clip has length
    # (none on a dead lane), then the closest hit's bisection and normal
    hit, dead = torch.from_numpy(got), torch.from_numpy(tm == 0)
    assert int(counts["samples"].max()) == steps + 1
    assert int(counts["march_steps"][dead].max()) == 0
    assert int(counts["samples"][dead].max()) <= 1
    assert bool((counts["march_steps"][hit] >= 1).all())
    assert torch.equal(counts["samples"][hit], counts["march_steps"][hit] + 1)
    assert torch.equal(c_counts["march_steps"], counts["march_steps"])
    assert torch.equal(c_counts["samples"],
                       1 + c_counts["march_steps"] + 1 + thm.BISECT_STEPS + 4)


def test_sample_layers_matches_jax(terrains, rays):
    """Layer weights at the march's uv within 1e-6 (XLA:CPU's contraction
    of the bilinear blend depends on the fusion it lands in), the layers
    without a material masked off, the weights normalised."""
    jt, tt = terrains
    ro, rd, tm = rays
    uv = np.asarray(jhm.heightmap_closest(
        jt, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tm)).uv)
    want = np.asarray(jax.jit(jhm.sample_layers)(jt, jnp.asarray(uv)))
    got = thm.sample_layers(tt, torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[:, 2:] == 0).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def luts():
    return jatm.build_luts(), tatm.build_luts()


# The atmosphere against the JAX package: every LUT is its bits. The port
# writes every mul-add XLA:CPU contracts in each jitted LUT builder as an
# fma (the sites read from the optimised IR and the machine code), XLA's
# exp, the C library's pow, sin and cos, the reciprocal products for the
# divisions by constants, and square roots rounded to nearest (ROADMAP.md
# §C.3). The sky bake (eager in the JAX package) is the JAX bits from
# either package's LUTs; its CDF rows within atol 1e-6.
LUT_RTOL = dict(transmittance=0.0, multiscatter=0.0, irradiance=0.0)
SKY_RTOL = {(0.4, 0.5, 0.3): 0.0, (0.1, 0.05, -0.6): 0.0}


@pytest.mark.parametrize("lut", ["transmittance", "multiscatter",
                                 "irradiance"])
def test_atmosphere_luts_match_jax(luts, lut):
    want, got = np.asarray(getattr(luts[0], lut)), getattr(luts[1], lut)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    if LUT_RTOL[lut] == 0.0:
        assert (got.numpy().view(np.uint32) == want.view(np.uint32)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=LUT_RTOL[lut],
                               atol=1e-9)


def test_atmosphere_mu_is_the_contraction():
    """The transmittance LUT's mu, written with XLA:CPU's two fmas (and
    d = fma(u, d_max - d_min, d_min)), is the JAX package's on every
    texel, and so is the port's; plain products miss it on many."""
    from truetrace_tpu_torch.core.math import fma

    def jax_rmu():
        vs, us = jnp.meshgrid((jnp.arange(jatm.T_H) + 0.5) / jatm.T_H,
                              (jnp.arange(jatm.T_W) + 0.5) / jatm.T_W,
                              indexing="ij")
        return jatm._uv_to_rmu(us, vs)

    jr, jmu = (np.asarray(x) for x in jax.jit(jax_rmu)())
    vs, us = torch.meshgrid(
        (torch.arange(tatm.T_H, dtype=torch.float32) + 0.5) / tatm.T_H,
        (torch.arange(tatm.T_W, dtype=torch.float32) + 0.5) / tatm.T_W,
        indexing="ij")
    r, mu = tatm._uv_to_rmu(us, vs)
    assert (r.numpy() == jr).all() and (mu.numpy() == jmu).all()
    h = tatm._H_ATM
    rho = vs * h
    d_plain = (tatm.R_TOP - r) + us * ((rho + h) - (tatm.R_TOP - r))
    mu_plain = torch.clamp(torch.where(
        d_plain > 1e-6, (h * h - rho * rho - d_plain * d_plain)
        / torch.clamp(2.0 * r * d_plain, min=1e-9), 1.0), -1.0, 1.0)
    assert 0.3 < (mu_plain.numpy() == jmu).mean() < 0.9
    d = fma(us, (rho + h) - (tatm.R_TOP - r), tatm.R_TOP - r)
    num = fma(-d, d, fma(-rho, rho, torch.full_like(rho, h * h)))
    mu_c = torch.clamp(torch.where(
        d > 1e-6, num / torch.clamp(2.0 * r * d, min=1e-9), 1.0), -1.0, 1.0)
    assert (mu_c.numpy() == jmu).all()


def test_powf_libm_is_jax_power_on_the_host_only():
    """powf_libm gives jnp.power's float32 bits on XLA:CPU over the Mie
    phase's base range, and refuses a tensor that is not on the CPU
    rather than moving it there."""
    from truetrace_tpu_torch.core.math import powf_libm
    x = np.random.default_rng(3).uniform(0.0, 2.0, 4096).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.power(v, 1.5))(x))
    got = powf_libm(torch.from_numpy(x).reshape(64, 64), 1.5)
    assert got.shape == (64, 64) and got.device.type == "cpu"
    assert (got.numpy().reshape(-1).view(np.uint32)
            == want.view(np.uint32)).all()
    with pytest.raises(ValueError, match="not the CPU"):
        powf_libm(torch.empty(4, device="meta"), 1.5)


def test_libm_sin_cos_are_jax_sin_cos_on_the_host_only():
    """sinf_libm / cosf_libm give jnp.sin's and jnp.cos's float32 bits on
    XLA:CPU, jitted and eager (the irradiance builder's directions and
    the sky bake's), where torch's float32 kernels and float64 rounded
    once miss them on many values; a tensor not on the CPU raises."""
    from truetrace_tpu_torch.core.math import cosf_libm, sinf_libm
    x = np.random.default_rng(4).uniform(-7.0, 7.0, 4096).astype(np.float32)
    t = torch.from_numpy(x)
    for ours, theirs, tfn in ((sinf_libm, jnp.sin, torch.sin),
                              (cosf_libm, jnp.cos, torch.cos)):
        want = np.asarray(jax.jit(theirs)(x))
        assert (np.asarray(theirs(x)) == want).all()
        got = ours(t).numpy()
        assert (got.view(np.uint32) == want.view(np.uint32)).all()
        assert (tfn(t.double()).float().numpy() != want).sum() > 10
        with pytest.raises(ValueError, match="not the CPU"):
            ours(torch.empty(4, device="meta"))


@pytest.mark.parametrize("sun", [(0.4, 0.5, 0.3), (0.1, 0.05, -0.6)])
def test_bake_sky_env_matches_jax(luts, sun):
    """The baked equirect sky (the forest's sun, and a low one with the
    star field) from each package's LUTs, and its CDF tables; from the
    JAX package's own LUTs, the JAX sky's bits."""
    kw = dict(sun_dir=sun, sun_irradiance=25.0, h=32, w=64,
              stars=0.0 if sun[1] > 0.3 else 0.5)
    je = jatm.bake_sky_env(luts=luts[0], **kw)
    te = tatm.bake_sky_env(luts=luts[1], device="cpu", **kw)
    np.testing.assert_allclose(te.image.numpy(), np.asarray(je.image),
                               rtol=SKY_RTOL[sun], atol=1e-6)
    if SKY_RTOL[sun] == 0.0:
        assert (te.image.numpy().view(np.uint32)
                == np.asarray(je.image).view(np.uint32)).all()
    same = tatm.bake_sky_env(luts=tatm.AtmosphereLUTs(*(
        torch.from_numpy(np.asarray(x)) for x in luts[0])), device="cpu",
        **kw)
    assert (same.image.numpy().view(np.uint32)
            == np.asarray(je.image).view(np.uint32)).all()
    np.testing.assert_allclose(te.cdf_y.numpy(), np.asarray(je.cdf_y),
                               rtol=1e-5, atol=1e-6)


def test_terrain_scene_sample_matches_jax():
    """One path-traced sample of a terrain scene (scripts/demo.py scene
    4's hills with two floating quads, a constant sky, Disney, 3 bounces)
    through render_sample_with_stats, against the JAX package's jitted
    trace: the terrain's march after the mesh trace, its normal, the
    dominant layer's material and the layer blend, its shadows."""
    from truetrace_tpu.integrate import pathtrace as jpt
    from truetrace_tpu.scene import ir as jir
    from truetrace_tpu.scene.mesh import HostMaterial as JMat
    from truetrace_tpu.scene.mesh import HostMesh as JMesh
    from truetrace_tpu.scene.mesh import compile_scene as jcompile
    from truetrace_tpu_torch.integrate import pathtrace as tpt
    from truetrace_tpu_torch.scene import ir as tir
    from truetrace_tpu_torch.scene.mesh import HostMaterial as TMat
    from truetrace_tpu_torch.scene.mesh import HostMesh as TMesh
    from truetrace_tpu_torch.scene.mesh import compile_scene as tcompile
    hm = jter.demo_hills(33, seed=4)
    am = np.zeros((8, 8, 4), np.float32)
    am[..., 0] = np.linspace(0, 1, 8)[None, :]
    am[..., 1] = 1.0 - am[..., 0]
    tkw = dict(origin=(-4.0, 0.0, -4.0), size_xz=(8.0, 8.0), mat_ids=[0, 1],
               alphamap=am, height_scale=1.5)
    quad = np.array([[-1, 2.2, -1], [1, 2.2, -1], [1, 2.2, 1], [-1, 2.2, 1]],
                    np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    W = H = 16
    out = []
    for mesh, mat, compile_, ir, terr, kw in (
            (JMesh, JMat, jcompile, jir, jter, {}),
            (TMesh, TMat, tcompile, tir, tter, dict(device="cpu"))):
        mats = [mat(base_color=(0.35, 0.45, 0.2), roughness=0.9),
                mat(base_color=(0.45, 0.38, 0.3), roughness=0.5,
                    metallic=0.3),
                mat(base_color=(0.8, 0.3, 0.2)),
                mat(emission=(5.0, 5.0, 4.0))]
        meshes = [mesh(quad, idx, np.full(2, 2, np.int32)),
                  mesh(quad + np.float32([1.5, 1.0, 0.5]), idx[:, ::-1].copy(),
                       np.full(2, 3, np.int32))]
        env = ir.EnvMap.constant((0.4, 0.5, 0.7), **kw)
        sc = compile_(meshes, mats, env=env, with_cwbvh=True,
                      terrain=terr.make_terrain(hm, **tkw, **kw), **kw)
        cam = ir.Camera.look_at((0.0, 5.0, 7.0), (0, 0.5, 0), fov_y_deg=50,
                                **kw)
        out.append((sc, cam))
    (js, jcam), (ts, tcam) = out
    cfg = dict(width=W, height=H, bounces=3, bsdf="disney",
               light_sampling="cdf", traversal="wavefront")
    f = jax.jit(jpt.render_sample_with_stats, static_argnums=2)
    jr, jst = f(js, jcam, jpt.RenderConfig(**cfg),
                jnp.arange(W * H, dtype=jnp.uint32), jnp.uint32(0))
    tr, tst = tpt.render_sample_with_stats(
        ts, tcam, tpt.RenderConfig(**cfg), torch.arange(W * H), 0)
    check_sample(jr, jst, tr, tst, 0.98)
    assert (np.asarray(jst["inst"]) == tst["inst"].numpy()).all()
