"""Torch port, denoise and post: the a-trous pass (the CUDA kernel's
plain twin), SVGF over two frames, and the post chain the frame runs,
against the JAX package on shared inputs made from a numpy seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.kernels.atrous_pallas import atrous_pass_pallas
from truetrace_tpu.post import pipeline as jpipe
from truetrace_tpu.post import svgf as jsvgf
from truetrace_tpu_torch.kernels.atrous_pallas import (atrous_pass,
                                                        atrous_pass_plain)
from truetrace_tpu_torch.post import pipeline as tpipe
from truetrace_tpu_torch.post import svgf as tsvgf

from torch_parity import leaves

H, W = 24, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _gbuffer(seed, h=H, w=W):
    r = np.random.default_rng(seed)
    n = r.normal(size=(h, w, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 2.0       # mostly facing one way
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(
        color=r.uniform(0, 3, (h, w, 3)).astype(np.float32),
        var=r.uniform(0, 0.5, (h, w)).astype(np.float32),
        normal=n,
        depth=r.uniform(0.5, 10, (h, w)).astype(np.float32),
        albedo=r.uniform(0.02, 0.9, (h, w, 3)).astype(np.float32))


# The pass is the same f32 expression in both packages; XLA and torch
# round exp/pow (128th power) differently in the last ulp and XLA may
# contract the weighted sums, which the normalisation carries into the
# outputs: rtol 1e-5, atol 1e-6 (the JAX package holds its Pallas pass
# to its XLA pass at rtol 1e-4, tests/test_svgf.py).
RTOL, ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_pass_matches_pallas_and_xla(step):
    g = _gbuffer(step)
    args_j = [jnp.asarray(g[k]) for k in ("color", "var", "normal", "depth")]
    args_t = [_t(g[k]) for k in ("color", "var", "normal", "depth")]
    pc, pv = atrous_pass_pallas(*args_j, step)        # interpret mode
    xc, xv = jsvgf._atrous_pass(*args_j, step)
    tc, tv = atrous_pass_plain(*args_t, step)
    # the wrapper takes the plain version for CPU tensors
    wc, wv = atrous_pass(*args_t, step)
    assert torch.equal(wc, tc) and torch.equal(wv, tv)
    for ref_c, ref_v in ((pc, pv), (xc, xv)):
        np.testing.assert_allclose(np.asarray(ref_c), tc.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np.asarray(ref_v), tv.numpy(), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("emissive", [False, True])
def test_svgf_two_frames(emissive):
    """Two frames of svgf_denoise from the empty state: the outputs and
    every state field agree (the second frame runs the temporal path)."""
    g1, g2 = _gbuffer(21), _gbuffer(22)
    g2["normal"], g2["depth"] = g1["normal"], g1["depth"] * 1.01
    em = np.zeros((H, W, 3), np.float32)
    em[3:6, 4:9] = 5.0
    js = jsvgf.SVGFState.create(H, W)
    ts = tsvgf.SVGFState.create(H, W, device="cpu")
    for g in (g1, g2):
        kw_j = dict(emissive=jnp.asarray(em)) if emissive else {}
        kw_t = dict(emissive=_t(em)) if emissive else {}
        jo, js = jsvgf.svgf_denoise(
            jnp.asarray(g["color"]), jnp.asarray(g["albedo"]),
            jnp.asarray(g["normal"]), jnp.asarray(g["depth"]), js, **kw_j)
        to, ts = tsvgf.svgf_denoise(_t(g["color"]), _t(g["albedo"]),
                                    _t(g["normal"]), _t(g["depth"]), ts,
                                    **kw_t)
        np.testing.assert_allclose(np.asarray(jo), to.numpy(), rtol=1e-4,
                                   atol=1e-5)
        for k, v in leaves(js).items():
            np.testing.assert_allclose(v, getattr(ts, k).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
    assert float(ts.hist_len.max()) == 2.0


def test_svgf_state_from_numpy():
    g = _gbuffer(23)
    _, js = jsvgf.svgf_denoise(*(jnp.asarray(g[k]) for k in
                                 ("color", "albedo", "normal", "depth")),
                               jsvgf.SVGFState.create(H, W))
    ts = tsvgf.SVGFState.from_numpy(leaves(js), "cpu")
    for k, v in leaves(js).items():
        np.testing.assert_array_equal(v, getattr(ts, k).numpy())


def test_post_chain_matches():
    """ACES tonemap, TAA (static and with motion), gamma, the firefly
    clamp and the accumulator: the same f32 expressions, rtol 1e-6."""
    r = np.random.default_rng(31)
    img = r.uniform(0, 4, (H, W, 3)).astype(np.float32)
    hist = r.uniform(0, 1, (H, W, 3)).astype(np.float32)
    motion = r.uniform(-3, 3, (H, W, 2)).astype(np.float32)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(jpipe.firefly_clamp(
        jnp.asarray(img), 3.0)), tpipe.firefly_clamp(_t(img), 3.0).numpy(),
        **tol)
    for m in (None, motion):
        jd, jh = jpipe.postprocess(
            jnp.asarray(img), jpipe.PostConfig(), jnp.asarray(hist),
            motion=None if m is None else jnp.asarray(m))
        td, th = tpipe.postprocess(_t(img), tpipe.PostConfig(), _t(hist),
                                   motion=None if m is None else _t(m))
        np.testing.assert_allclose(np.asarray(jd), td.numpy(), **tol)
        np.testing.assert_allclose(np.asarray(jh), th.numpy(), **tol)
    ja = jpipe.Accumulator.create(H, W).add(jnp.asarray(img)).add(
        jnp.asarray(hist))
    ta = tpipe.Accumulator.create(H, W, device="cpu").add(_t(img)).add(
        _t(hist))
    np.testing.assert_allclose(np.asarray(ja.image), ta.image.numpy(), **tol)
    assert float(ta.count) == float(ja.count) == 2.0


@pytest.mark.parametrize("opt", ["tonemap", "auto_expose", "bloom_strength",
                                 "sharpen"])
def test_post_options_match_jax(opt):
    """postprocess with each option the port once refused (AgX, temporal
    auto exposure from a warm state, bloom, CAS sharpening) against the
    JAX package's, with a TAA history and motion: the display and the
    new history to rtol 1e-5 / atol 1e-6, the new exposure likewise."""
    kw = dict(tonemap=dict(tonemap="agx"), auto_expose=dict(auto_expose=True),
              bloom_strength=dict(bloom_strength=0.1),
              sharpen=dict(sharpen=0.3))[opt]
    r = np.random.default_rng(11)
    img = (r.exponential(size=(H, W, 3)) * 1.5).astype(np.float32)
    hist = r.uniform(size=(H, W, 3)).astype(np.float32)
    mo = r.normal(scale=2.0, size=(H, W, 2)).astype(np.float32)
    jargs = (jnp.asarray(img), jpipe.PostConfig(**kw), jnp.asarray(hist),
             jnp.asarray(mo))
    targs = (_t(img), tpipe.PostConfig(**kw), _t(hist), _t(mo))
    if opt == "auto_expose":
        jout = jpipe.postprocess(*jargs, exposure_state=jnp.float32(0.7))
        tout = tpipe.postprocess(*targs, exposure_state=torch.tensor(0.7))
        assert len(tout) == 3
    else:
        jout, tout = jpipe.postprocess(*jargs), tpipe.postprocess(*targs)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-6)
