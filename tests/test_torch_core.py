"""Torch port, core: the counter RNG, camera rays and the math helpers
against the JAX package on the same inputs, and the port's import
boundary (no JAX anywhere in it)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.core import math as jmath
from truetrace_tpu.core import rng as jrng
from truetrace_tpu.scene import ir as jir
from truetrace_tpu_torch.core import math as tmath
from truetrace_tpu_torch.core import rng as trng
from truetrace_tpu_torch.scene import ir as tir

from torch_parity import leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_pcg3d_bitwise():
    """uint32 arithmetic held in int64 and masked gives the JAX bits."""
    r = np.random.default_rng(0)
    v = [r.integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)
         for _ in range(3)]
    v[0][:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    jx = jrng.pcg3d(*(jnp.asarray(a) for a in v))
    tx = trng.pcg3d(*(_t(a.astype(np.int64)) for a in v))
    for a, b in zip(jx, tx):
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                      b.numpy())


@pytest.mark.parametrize("fn", ["uniform1", "uniform2", "uniform3"])
def test_uniform_bitwise(fn):
    pix = np.arange(3000, dtype=np.int32)
    for sample, dim in ((0, 0), (7, rng_dim(3, 4)), (123456, 0x7FFFFFFF)):
        a = getattr(jrng, fn)(jnp.asarray(pix), jnp.uint32(sample),
                              jnp.uint32(dim))
        b = getattr(trng, fn)(_t(pix.astype(np.int64)), sample, dim)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def rng_dim(bounce, slot):
    assert trng.path_dim(bounce, slot) == int(jrng.path_dim(bounce, slot))
    return trng.path_dim(bounce, slot)


@pytest.mark.parametrize("aperture", [0.0, 0.05])
def test_camera_rays_bitwise(aperture):
    """Pinhole primary rays (the frame's cameras) are bitwise the JAX
    ones. A thin lens rotates its disk sample with sin/cos, where XLA's
    and torch's f32 results differ by an ulp on ~5% of inputs, so there
    the rays agree to 2 ulp (rtol 2.5e-7) instead."""
    jcam = jir.Camera.look_at((0.3, 1.2, 3.5), (0.0, 0.9, 0.0),
                              fov_y_deg=47.0, aperture=aperture,
                              focus_dist=3.0)
    tcam = tir.Camera.from_numpy(leaves(jcam), "cpu")
    W, H = 40, 24
    r = np.random.default_rng(1)
    pix = np.arange(W * H, dtype=np.int32)
    jit = r.random((W * H, 2), dtype=np.float32)
    lens = r.random((W * H, 2), dtype=np.float32)
    jo, jd = jir.camera_rays(jcam, W, H, jnp.asarray(pix), jnp.asarray(jit),
                             lens_u=jnp.asarray(lens))
    to, td = tir.camera_rays(tcam, W, H, _t(pix.astype(np.int64)), _t(jit),
                             lens_u=_t(lens))
    if aperture == 0.0:
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    else:
        np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=2.5e-7)
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=2.5e-7,
                                   atol=1e-7)


def test_math_helpers_match():
    """luminance, onb/to_world, the cosine hemisphere and the power
    heuristic on shared inputs. rtol 1e-6 / atol 1e-6: XLA's and torch's
    sin/cos/sqrt may differ in the last ulp; everything else is the same
    sequence of f32 operations."""
    r = np.random.default_rng(2)
    n = r.normal(size=(2000, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    u = r.random((2000, 2), dtype=np.float32)
    c = r.uniform(0, 4, (2000, 3)).astype(np.float32)
    pa, pb = (r.uniform(0, 50, 2000).astype(np.float32) for _ in range(2))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jmath.luminance(jnp.asarray(c))),
                               tmath.luminance(_t(c)).numpy(), **tol)
    v = np.asarray(jmath.sample_cosine_hemisphere(jnp.asarray(u)))
    np.testing.assert_allclose(
        v, tmath.sample_cosine_hemisphere(_t(u)).numpy(), **tol)
    np.testing.assert_allclose(
        np.asarray(jmath.to_world(jnp.asarray(n), jnp.asarray(v))),
        tmath.to_world(_t(n), _t(v)).numpy(), **tol)
    np.testing.assert_allclose(
        np.asarray(jmath.power_heuristic(jnp.asarray(pa), jnp.asarray(pb))),
        tmath.power_heuristic(_t(pa), _t(pb)).numpy(), **tol)


def test_fma_rounds_once():
    """core.math.fma is a*b+c rounded once to f32: it equals the exact
    rational result rounded to nearest-even (checked with fractions on
    cases where a plain f64 sum would double-round)."""
    from fractions import Fraction
    r = np.random.default_rng(3)
    a = r.normal(size=300).astype(np.float32)
    b = r.normal(size=300).astype(np.float32)
    c = (-(a * b) + r.normal(size=300).astype(np.float32) * 1e-7
         ).astype(np.float32)
    got = tmath.fma(_t(a), _t(b), _t(c)).numpy()
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda q: (abs(Fraction(float(q)) - exact),
                                         int(q.view(np.int32)) & 1))
        assert g == best


def test_port_imports_without_jax():
    """No module of the port reaches jax, flax or the JAX package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'flax', 'truetrace_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "for k in [k for k in sys.modules\n"
        "          if k.split('.')[0] in ('jax', 'jaxlib', 'flax')]:\n"
        "    del sys.modules[k]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import pkgutil, importlib, truetrace_tpu_torch\n"
        "for m in pkgutil.walk_packages(truetrace_tpu_torch.__path__,\n"
        "                               'truetrace_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import truetrace_tpu_torch.renderer\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
