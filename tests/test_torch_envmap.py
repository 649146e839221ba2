"""Torch port, the textured environment: the importance tables
(build/env_cdf.py) bitwise against the JAX package's, env_eval /
env_sample / env_pdf (kernels/envmap.py) against the JAX functions on the
same seeded inputs, and the port's twin of tests/test_env_nee.py: NEE +
MIS with the env strategy converges to the BSDF-only estimator.

Tolerances: XLA's and torch's f32 arccos, atan2, sin and cos differ by an
ulp on some inputs, and XLA:CPU contracts the bilinear mul-adds, so
directions, radiance and pdfs are held to rtol 1e-5 (atol 1e-6 on
directions). The texel an input lands in is held exactly on every lane
whose position lies more than 1e-3 of a texel from a texel edge (an ulp
of the angle can move a lane across an edge)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.build import env_cdf as jenv
from truetrace_tpu.kernels import envmap as jem
from truetrace_tpu_torch.build import env_cdf as tenv
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.kernels import envmap as tem
from truetrace_tpu_torch.scene.ir import Camera, EnvMap
from truetrace_tpu_torch.scene.mesh import (
    HostMaterial, HostMesh, compile_scene)

import torch_parity  # noqa: F401  (one torch thread per worker)

SKY = dict(sun_dir=(0.3, 0.85, 0.44), sun_intensity=900.0)
RTOL, DIR_ATOL = 1e-5, 1e-6


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.fixture(scope="module")
def envs():
    """The same sky as both packages' EnvMap, rotated and scaled."""
    img = tenv.procedural_sky(h=32, w=64, sun_angle_deg=8.0, **SKY)
    j = jenv.build_env_cdf(img, rotation=0.4, intensity=1.7)
    t = tenv.build_env_cdf(img, rotation=0.4, intensity=1.7, device="cpu")
    return j, t


def _dirs(n, seed):
    """Seeded unit directions plus the axes and poles (atan2's branch
    cut, the clamped poles)."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    axes = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                     [0, 0, 1], [0, 0, -1], [-1, 0, -0.0]], np.float32)
    d = np.concatenate([d, axes])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _texel(env, d):
    """(y, x) texel of directions d and whether each lies more than 1e-3
    of a texel from every edge, in float64 (the reference geometry)."""
    H, W = env.image.shape[:2]
    d = np.asarray(d, np.float64)
    theta = np.arccos(np.clip(d[:, 1], -1, 1))
    phi = np.arctan2(d[:, 2], d[:, 0]) - float(env.rotation)
    fx = np.mod(phi / (2 * np.pi), 1.0) * W
    fy = np.clip(theta / np.pi, 0, 1 - 1e-6) * H
    away = ((np.abs(fx - np.round(fx)) > 1e-3)
            & (np.abs(fy - np.round(fy)) > 1e-3))
    return np.floor(fy).astype(int), np.floor(fx).astype(int) % W, away


@pytest.mark.parametrize("h,w", [(128, 256), (32, 64)])
def test_env_tables_bitwise(h, w):
    """procedural_sky and star_field images and every EnvMap table."""
    for kw in (SKY, dict(sun_dir=(-0.5, 0.2, 0.1), sun_angle_deg=4.0)):
        a = jenv.procedural_sky(h=h, w=w, **kw)
        b = tenv.procedural_sky(h=h, w=w, **kw)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(_bits(a), _bits(b))
        j = jenv.build_env_cdf(a + jenv.star_field(h=h, w=w), 0.25, 2.0)
        t = tenv.build_env_cdf(b + tenv.star_field(h=h, w=w), 0.25, 2.0,
                               device="cpu")
        for f in ("image", "cdf_x", "cdf_y", "total", "rotation",
                  "intensity"):
            x, y = np.asarray(getattr(j, f)), getattr(t, f).numpy()
            assert x.shape == y.shape and x.dtype == y.dtype, f
            np.testing.assert_array_equal(_bits(x), _bits(y), err_msg=f)


def test_env_eval_and_pdf_match_jax(envs):
    j, t = envs
    d = _dirs(4000, 1)
    for jf, tf in ((jem.env_eval, tem.env_eval), (jem.env_pdf, tem.env_pdf)):
        a = np.asarray(jf(j, jnp.asarray(d)))
        b = tf(t, torch.from_numpy(d)).numpy()
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-30)
    # the constant env: eval broadcasts its colour, pdf is 0
    c = EnvMap.constant((0.2, 0.3, 0.4), device="cpu")
    np.testing.assert_array_equal(
        tem.env_eval(c, torch.from_numpy(d)).numpy(),
        np.broadcast_to(np.float32([0.2, 0.3, 0.4]), d.shape))
    assert not tem.env_pdf(c, torch.from_numpy(d)).any()


def test_env_pdf_texels_exact(envs):
    """env_pdf is piecewise constant per texel: away from texel edges the
    port reads the JAX texel, so the pdf differs only by sin's ulps."""
    j, t = envs
    d = _dirs(4000, 2)
    y, x, away = _texel(j, d)
    assert away.mean() > 0.99
    img = np.asarray(j.image)
    lum = img[..., 0] * 0.2126 + img[..., 1] * 0.7152 + img[..., 2] * 0.0722
    b = tem.env_pdf(t, torch.from_numpy(d)).numpy()
    sin_c = np.sin(np.pi * (y + 0.5) / img.shape[0])
    sin_t = np.maximum(np.sqrt(1 - d[:, 1].astype(np.float64) ** 2), 1e-6)
    want = lum[y, x] / float(j.total) * sin_c / sin_t
    np.testing.assert_allclose(b[away], want[away], rtol=1e-5)


def test_env_sample_matches_jax(envs):
    """Directions, pdfs and radiance of env_sample on seeded uniforms, and
    the texel each sample lands in."""
    j, t = envs
    u = np.random.default_rng(3).random((4000, 2)).astype(np.float32)
    u[:3] = [[0.0, 0.0], [1 - 2 ** -24, 1 - 2 ** -24], [0.5, 0.0]]
    ja = [np.asarray(x) for x in jem.env_sample(j, jnp.asarray(u))]
    ta = [x.numpy() for x in tem.env_sample(t, torch.from_numpy(u))]
    np.testing.assert_allclose(ta[0], ja[0], rtol=RTOL, atol=DIR_ATOL)
    np.testing.assert_allclose(ta[1], ja[1], rtol=RTOL)
    np.testing.assert_allclose(ta[2], ja[2], rtol=RTOL, atol=1e-30)
    yj, xj, away = _texel(j, ja[0])
    yt, xt, _ = _texel(j, ta[0])
    assert away.mean() > 0.99
    np.testing.assert_array_equal(yt[away], yj[away])
    np.testing.assert_array_equal(xt[away], xj[away])
    # the sampler concentrates on the sun: most samples carry it
    assert (ta[2].max(-1) > 100).mean() > 0.5


def _plane_under_sky():
    """tests/test_env_nee.py's scene: a diffuse ground plane under the
    procedural sun + sky."""
    verts = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    mesh = HostMesh(positions=verts, indices=idx,
                    mat_id=np.zeros(2, np.int32))
    mats = [HostMaterial(base_color=(0.6, 0.6, 0.6), roughness=0.8)]
    env = tenv.build_env_cdf(tenv.procedural_sky(
        h=32, w=64, sun_intensity=200.0, sun_angle_deg=5.0), device="cpu")
    cam = Camera.look_at(eye=(0, 2.0, -6), target=(0, 0, 0), fov_y_deg=50,
                         device="cpu")
    return compile_scene([mesh], mats, env=env, with_cwbvh=True,
                         device="cpu"), cam


def _render(scene, cam, W, spp, base=0, **cfg):
    """[W,W,3] mean of samples base .. base + spp - 1, traced as one
    batch (sample ids are per-lane counters)."""
    c = RenderConfig(width=W, height=W, traversal="wavefront", **cfg)
    pix = torch.arange(W * W).repeat(spp)
    sid = torch.arange(base, base + spp).repeat_interleave(W * W)
    rad, _ = render_sample_with_stats(scene, cam, c, pix, sid)
    return rad.reshape(spp, W, W, 3).mean(0).numpy()


def test_env_nee_unbiased():
    """NEE + MIS over {env} against BSDF-only sampling on the plane: the
    ground rows' means agree to rtol 0.15 (tests/test_env_nee.py), and
    NEE is the less noisy estimator at equal spp."""
    scene, cam = _plane_under_sky()
    img_nee = _render(scene, cam, 24, 96, bounces=2)
    img_pt = _render(scene, cam, 24, 768, bounces=2, use_nee=False)
    assert np.isfinite(img_nee).all() and np.isfinite(img_pt).all()
    np.testing.assert_allclose(img_nee[16:].mean((0, 1)),
                               img_pt[16:].mean((0, 1)), rtol=0.15)
    a, b = (_render(scene, cam, 24, 8, base, bounces=2) for base in (0, 8))
    c, d = (_render(scene, cam, 24, 8, base, bounces=2, use_nee=False)
            for base in (0, 8))
    assert np.mean((a[16:] - b[16:]) ** 2) < np.mean((c[16:] - d[16:]) ** 2)
