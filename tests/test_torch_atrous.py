"""Torch port, the a-trous kernel's module on the CPU: the packed route
that svgf_denoise takes (planes packed once a frame, one packed pass a
step) against the JAX package's passes and the port's plain pass, and
the per-source nvcc flags the kernels are built with. The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.post import svgf as jsvgf
from truetrace_tpu_torch.kernels import _cuda
from truetrace_tpu_torch.kernels import atrous_pallas as ta

import torch_parity  # noqa: F401  (one torch thread per worker)


def _gbuffer(seed, h=24, w=32):
    r = np.random.default_rng(seed)
    n = r.normal(size=(h, w, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 2.0       # mostly facing one way
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    var = r.uniform(0, 0.5, (h, w)).astype(np.float32)
    var[:8, :10] = 0.0
    return (r.uniform(0, 3, (h, w, 3)).astype(np.float32), var, n,
            r.uniform(0.5, 10, (h, w)).astype(np.float32))


@pytest.mark.parametrize("n_passes", [0, 5])
def test_atrous_filter_matches_jax_passes(n_passes):
    """atrous_filter on CPU tensors is the plain pass at steps 1, 2, 4, ...
    bit for bit, and agrees with the JAX package's passes to the rtol
    1e-5 / atol 1e-6 of test_torch_svgf.py (exp/pow ulps)."""
    g = _gbuffer(41)
    t = [torch.from_numpy(a) for a in g]
    first, c, v = ta.atrous_filter(*t, n_passes)
    jc, jv = (jnp.asarray(a) for a in g[:2])
    pc, pv = t[:2]
    jfirst, pfirst = jc, pc
    for i in range(n_passes):
        jc, jv = jsvgf._atrous_pass(jc, jv, *map(jnp.asarray, g[2:]), 1 << i)
        pc, pv = ta.atrous_pass_plain(pc, pv, *t[2:], 1 << i)
        if i == 0:
            jfirst, pfirst = jc, pc
    for a, p, j in ((first, pfirst, jfirst), (c, pc, jc), (v, pv, jv)):
        assert torch.equal(a, p)
        np.testing.assert_allclose(np.asarray(j), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("step", [1, 16])
def test_packed_pass_on_cpu_is_the_plain_pass(step):
    """The packed wrapper takes the plain pass for CPU tensors, and its
    planes carry (colour, variance) and (normal, depth) unchanged."""
    t = [torch.from_numpy(a) for a in _gbuffer(42)]
    cv, nz = ta.pack(*t[:2]), ta.pack(*t[2:])
    assert cv.shape == (24, 32, 4) and cv.is_contiguous()
    assert all(torch.equal(a, b) for a, b in zip(ta.unpack(nz), t[2:]))
    n0 = ta.atrous_pass_packed.launches
    c, v = ta.unpack(ta.atrous_pass_packed(cv, nz, step))
    pc, pv = ta.atrous_pass_plain(*t, step)
    assert torch.equal(c, pc) and torch.equal(v, pv)
    assert ta.atrous_pass_packed.launches == n0      # no kernel launched


def test_nvcc_flags_per_source():
    """The bitwise kernels keep --fmad=false, the a-trous kernel (held
    to a tolerance) contracts mul-adds; each library's name covers its
    own flags."""
    assert set(_cuda.NVCC_FLAGS) == set(_cuda.SOURCES)
    for src in ("traverse.cu", "step_core.cu", "traverse_tlas.cu",
                "heightmap.cu", "traverse_bvh2.cu"):
        assert "--fmad=false" in _cuda.NVCC_FLAGS[src]
    assert "--fmad=false" not in _cuda.NVCC_FLAGS["atrous.cu"]
    common = set(_cuda.NVCC_FLAGS["atrous.cu"])
    assert all(common <= set(f) for f in _cuda.NVCC_FLAGS.values())
    so = lambda flags: _cuda._so_path("atrous.cu", _cuda.CSRC, flags)
    assert so(_cuda.NVCC_FLAGS["atrous.cu"]) != so(_cuda.BITWISE_FLAGS)
