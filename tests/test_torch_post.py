"""Torch port, the post chain (post/pipeline.py) against the JAX
package's, function by function, on inputs made from a numpy seed: the
tonemaps, the 3-D LUT's .cube reader and writer, baker and trilinear
apply, both auto exposures, bloom and its pyramid steps, CAS, the whole
postprocess with its exposure state, the Halton sequence, the TAAU
jitter and upscaler; and two of the JAX package's own checks rerun with
the port (tests/test_post.py's TAAU detail, tests/test_partial_exposure.py's
exposure adaptation).

Tolerance: rtol 1e-5 / atol 1e-6 on every element of the elementwise
and stencil ops (the two frameworks' log2, pow, exp and 3x3 colour
products differ in the last ulps), and atol 1e-5 for the whole chain,
where an AgX look's pow and its outset matrix, which cancels, carry
those ulps into a dark channel (1.6e-6 on one element of 1380); bit
for bit: halton for ids 0-1023,
the exposure histogram's bins and median, and the .cube round trip
through both packages' readers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.post import pipeline as J
from truetrace_tpu_torch.post import pipeline as T

TOL = dict(rtol=1e-5, atol=1e-6)


def _img(seed, h=20, w=23, scale=1.5):
    r = np.random.default_rng(seed)
    return (r.exponential(size=(h, w, 3)) * scale).astype(np.float32)


def _close(t, j, atol=TOL["atol"]):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL["rtol"],
                               atol=atol)


def _bits(t, j):
    j = np.asarray(j)
    assert t.numpy().astype(j.dtype).tobytes() == j.tobytes()


@pytest.mark.parametrize("name", ["aces", "reinhard", "agx", "agx_punchy",
                                  "agx_golden", "none"])
def test_tonemaps_match_jax(name):
    x = _img(0)
    x[0, 0] = 0.0                       # the floor of AgX's log
    x[0, 1] = 1e4
    _close(T._TONEMAPS[name](torch.from_numpy(x)),
           J._TONEMAPS[name](jnp.asarray(x)))


def test_cube_lut_round_trip(tmp_path):
    """A LUT baked by each package, written by each package's
    save_cube_lut and read by each package's load_cube_lut: the four
    reads equal bit for bit, with their domains; the bakes agree to the
    tolerance."""
    jl = np.asarray(J.bake_tonemap_lut("agx", 9))
    tl = T.bake_tonemap_lut("agx", 9, device="cpu")
    _close(tl, jl)
    dom = ((0.0, -0.5, 0.0), (1.0, 1.5, 2.0))
    J.save_cube_lut(str(tmp_path / "j.cube"), jl, domain=dom)
    T.save_cube_lut(str(tmp_path / "t.cube"), torch.from_numpy(jl.copy()),
                    domain=dom)
    assert (tmp_path / "j.cube").read_text().split("\n", 1)[1] == \
        (tmp_path / "t.cube").read_text().split("\n", 1)[1]
    reads = [load(str(tmp_path / f)) for load in (J.load_cube_lut,
                                                  T.load_cube_lut)
             for f in ("j.cube", "t.cube")]
    for lut, d in reads:
        assert lut.tobytes() == reads[0][0].tobytes() and d == dom
    np.testing.assert_allclose(reads[0][0], jl, atol=1e-6)
    (tmp_path / "bad.cube").write_text("LUT_3D_SIZE 2\n0 0 0\n")
    with pytest.raises(ValueError, match="bad .cube"):
        T.load_cube_lut(str(tmp_path / "bad.cube"))


@pytest.mark.parametrize("shaper", [True, False])
def test_apply_lut3d_matches_jax(shaper):
    lut = np.asarray(J.bake_tonemap_lut("aces", 17))
    dom = ((0.0, 0.0, 0.0), (1.0, 2.0, 4.0))
    x = _img(1, scale=1.0 if shaper else 0.8)
    x[0, 0] = -0.5                      # clamped below the domain
    j = J.apply_lut3d(jnp.asarray(x), jnp.asarray(lut), shaper=shaper,
                      domain=dom)
    t = T.apply_lut3d(torch.from_numpy(x), torch.from_numpy(lut.copy()),
                      shaper=shaper, domain=dom)
    _close(t, j)


def test_auto_exposure_matches_jax():
    x = _img(2)
    _close(T.auto_exposure(torch.from_numpy(x)),
           J.auto_exposure(jnp.asarray(x)))


@pytest.mark.parametrize("prev", [-1.0, 0.0, 0.05, 0.9, 40.0])
def test_auto_exposure_temporal_matches_jax(prev):
    """Cold starts (prev <= 0) and adaptation from below and above: the
    bins, and so the median, bit for bit; the image and the exposure to
    the tolerance."""
    x = _img(3, scale=0.7)
    x[:4] = 0.0                         # a dark band: the lowest bins
    j, je = J.auto_exposure_temporal(jnp.asarray(x), jnp.float32(prev))
    t, te = T.auto_exposure_temporal(torch.from_numpy(x), torch.tensor(prev))
    L = jnp.maximum(J.luminance(jnp.asarray(x)), 1e-8)
    jbins = jnp.clip((jnp.log(L * 12.0) * 12.0 + 220.0).astype(jnp.int32),
                     0, 255).reshape(-1)
    assert (T.exposure_bins(torch.from_numpy(x)).numpy()
            == np.asarray(jbins)).all()
    _close(te, je)
    _close(t, j)


def test_exposure_median_takes_the_first_bin_on_ties():
    """Two halves in two bins: the CDF reaches half the pixels exactly at
    the lower bin, which both packages pick (argmax of the first True)."""
    x = np.ones((4, 4, 3), np.float32) * 0.01
    x[2:] = 5.0
    j, je = J.auto_exposure_temporal(jnp.asarray(x), jnp.float32(-1.0))
    t, te = T.auto_exposure_temporal(torch.from_numpy(x), torch.tensor(-1.0))
    _bits(te, je)
    lo = int(T.exposure_bins(torch.from_numpy(x)).min())
    l_med = np.exp(np.float32((lo - 220.0) / 12.0)) / 12.0
    assert abs(float(te) * l_med / (1.5 - 2.0 / (2.0 + np.log10(l_med + 1)))
               - 2.15) < 1e-3


@pytest.mark.parametrize("hw", [(20, 23), (16, 16), (9, 7)])
def test_bloom_matches_jax(hw):
    """Bloom at odd sizes (the pyramid crops odd rows and columns and
    upsamples by a ceiling factor) and at one that stops below 4 px;
    its blur, downsample and upsample steps alone."""
    x = _img(4, *hw, scale=2.0)
    _close(T.bloom(torch.from_numpy(x), 0.08), J.bloom(jnp.asarray(x), 0.08))
    for axis in (0, 1):
        _close(T._blur1d(torch.from_numpy(x), axis, 2),
               J._blur1d(jnp.asarray(x), axis, 2))
    d = T._downsample2(torch.from_numpy(x))
    _close(d, J._downsample2(jnp.asarray(x)))
    _close(T._upsample_to(d, *hw),
           J._upsample_to(jnp.asarray(d.numpy()), *hw))


def test_sharpen_cas_matches_jax():
    for scale in (0.3, 3.0):            # the clip's top at 1 and at max
        x = _img(5, scale=scale)
        _close(T.sharpen_cas(torch.from_numpy(x), 0.3),
               J.sharpen_cas(jnp.asarray(x), 0.3))


@pytest.mark.parametrize("tonemap", ["agx_golden", "lut", "none"])
def test_postprocess_chain_matches_jax(tonemap):
    """The recorded JAX frame's chain plus temporal exposure (bloom 0.08,
    CAS 0.3, auto_expose), TAA with motion, with three tonemaps (a baked
    LUT among them): display, history and the new exposure; the
    two-element return without an exposure state; a LUT tonemap without
    a LUT is a ValueError (the JAX package fails inside apply_lut3d)."""
    lut = J.bake_tonemap_lut("reinhard", 17) if tonemap == "lut" else None
    kw = dict(tonemap=tonemap, bloom_strength=0.08, sharpen=0.3,
              auto_expose=True, exposure=1.3)
    x, h = _img(6), np.random.default_rng(7).uniform(
        size=(20, 23, 3)).astype(np.float32)
    mo = np.random.default_rng(8).normal(scale=3.0, size=(20, 23, 2)
                                         ).astype(np.float32)
    jc = J.PostConfig(lut3d=lut, **kw)
    tc = T.PostConfig(lut3d=None if lut is None else torch.from_numpy(
        np.array(lut)), **kw)
    jo = J.postprocess(jnp.asarray(x), jc, jnp.asarray(h), jnp.asarray(mo),
                       exposure_state=jnp.float32(2.0))
    to = T.postprocess(torch.from_numpy(x), tc, torch.from_numpy(h),
                       torch.from_numpy(mo),
                       exposure_state=torch.tensor(2.0))
    assert len(to) == 3
    for t, j in zip(to, jo):
        _close(t, j, atol=1e-5)
    two = T.postprocess(torch.from_numpy(x), tc)
    assert len(two) == 2
    _close(two[0], J.postprocess(jnp.asarray(x), jc)[0], atol=1e-5)
    with pytest.raises(ValueError, match="lut3d"):
        T.postprocess(torch.from_numpy(x), T.PostConfig(tonemap="lut"))


def test_halton_bitwise():
    """halton(i, 2) and (i, 3) for ids 0-1023 bit for bit (float32 digits
    times Python-float weights), as 0-d tensors and as Python ints."""
    ids = torch.arange(1024)
    for base in (2, 3):
        j = np.array([np.asarray(J.halton(i, base)) for i in range(1024)])
        t = torch.stack([T.halton(i, base) for i in ids]).numpy()
        assert t.tobytes() == j.tobytes()
        assert T.halton(777, base).numpy().tobytes() == j[777].tobytes()
    _bits(T.taau_jitter(torch.tensor(37)), J.taau_jitter(37))


@pytest.mark.parametrize("case", ["first", "still", "motion", "centre"])
def test_taau_upscale_matches_jax(case):
    """taau_upscale at scale 2 (and 3 for the still case): the first
    frame (no history), a still frame, a moving one whose motion has
    1e4 entries (no history there, the |motion| < frame test) and
    sub-pixel values (truncated, not rounded), and the pixel-centre
    jitter (None)."""
    s = 3 if case == "still" else 2
    r = np.random.default_rng(9)
    low = r.uniform(size=(7, 9, 3)).astype(np.float32)
    hist = r.uniform(size=(7 * s, 9 * s, 3)).astype(np.float32)
    mo = r.normal(scale=1.5, size=(7, 9, 2)).astype(np.float32)
    mo[0, :3] = 1e4
    jargs = dict(history=None if case == "first" else jnp.asarray(hist),
                 scale=s, jitter=None if case == "centre"
                 else J.taau_jitter(5),
                 motion=jnp.asarray(mo) if case == "motion" else None)
    targs = dict(history=None if case == "first" else torch.from_numpy(hist),
                 scale=s, jitter=None if case == "centre"
                 else T.taau_jitter(torch.tensor(5)),
                 motion=torch.from_numpy(mo) if case == "motion" else None)
    jo = J.taau_upscale(jnp.asarray(low), **jargs)
    to = T.taau_upscale(torch.from_numpy(low), **targs)
    for t, j in zip(to, jo):
        _close(t, j)


def test_taau_reconstructs_subpixel_detail():
    """tests/test_post.py's check, run with the port: a full Halton
    cycle of jittered low-res samplings of a stripe pattern reconstructs
    it to under half the error of a box upscale."""
    scale, h, w = 2, 24, 24
    H, W = h * scale, w * scale

    def f(py, px):
        v = 0.5 + 0.5 * np.sin((px + 2.0 * py) * (2 * np.pi / 6.0))
        return np.repeat(v[..., None], 3, axis=-1).astype(np.float32)

    yy, xx = np.mgrid[0:H, 0:W]
    truth = f(yy + 0.5, xx + 0.5)
    hist = None
    ly, lx = np.mgrid[0:h, 0:w]
    for i in range(48):
        j = T.taau_jitter(torch.tensor(i))
        low = f((ly + float(j[1])) * scale, (lx + float(j[0])) * scale)
        out, hist = T.taau_upscale(torch.from_numpy(low), hist, scale=scale,
                                   jitter=j, alpha=0.35)
    err = np.abs(out.numpy() - truth).mean()
    box = np.repeat(np.repeat(f((ly + 0.5) * scale, (lx + 0.5) * scale),
                              scale, 0), scale, 1)
    assert err < 0.5 * np.abs(box - truth).mean()


def test_temporal_exposure_adapts_smoothly():
    """tests/test_partial_exposure.py's check, run with the port: a cold
    start jumps to the target, a constant input holds steady, a step
    moves a fraction a frame and converges."""
    bright = torch.ones((16, 16, 3)) * 4.0
    dim = torch.ones((16, 16, 3)) * 0.05
    cold = torch.tensor(-1.0)
    _, e0 = T.auto_exposure_temporal(bright, cold)
    assert float(e0) > 0
    _, e1 = T.auto_exposure_temporal(bright, e0)
    assert abs(float(e1) - float(e0)) < 0.02 * abs(float(e0))
    _, e_target = T.auto_exposure_temporal(dim, cold)
    _, e_step = T.auto_exposure_temporal(dim, e0)
    move = abs(float(e_step) - float(e0))
    assert 0.0 < move < 0.1 * abs(float(e_target) - float(e0)) + 1e-6
    e = e0
    for _ in range(400):
        _, e = T.auto_exposure_temporal(dim, e)
    assert abs(float(e) - float(e_target)) < 0.1 * abs(float(e_target))
