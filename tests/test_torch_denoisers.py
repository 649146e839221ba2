"""Torch port, the temporal denoisers ReCur and ASVGF (post/recur.py,
post/asvgf.py) and SVGF's alpha_map, against the JAX package's functions
called directly on shared inputs made from a numpy seed (no renderer).

Tolerances: the stencils are the same f32 expressions in both packages,
but XLA and torch round exp and pow (ReCur's 64th and 8th powers,
SVGF's 128th) differently in the last ulp, XLA may contract the weighted
sums, and the box means of _down3 add their nine taps in another order;
the normalised sums and the recurrent histories carry that into the
outputs: rtol 1e-5 / atol 1e-6 for one stencil, rtol 1e-4 / atol 1e-5
over chained frames and whole filters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu.post import asvgf as jasvgf
from truetrace_tpu.post import recur as jrecur
from truetrace_tpu.post import svgf as jsvgf
from truetrace_tpu_torch.post import asvgf as tasvgf
from truetrace_tpu_torch.post import recur as trecur
from truetrace_tpu_torch.post import svgf as tsvgf

from torch_parity import leaves

H, W = 20, 23           # neither a multiple of 3 (the stratum)
STEP = dict(rtol=1e-5, atol=1e-6)
CHAIN = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _frame(seed, h=H, w=W):
    """Radiance, albedo, normals (mostly facing one way, some flipped
    edges), depths with a step, emissive pixels and motion vectors."""
    r = np.random.default_rng(seed)
    n = r.normal(size=(h, w, 3)).astype(np.float32)
    n[..., 2] = np.abs(n[..., 2]) + 2.0
    n[:, : w // 3] = (1.0, 0.0, 0.0)              # a hard normal edge
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    depth = r.uniform(4.0, 4.2, (h, w)).astype(np.float32)
    depth[h // 2:] -= 1.0                         # a depth step
    em = np.zeros((h, w, 3), np.float32)
    em[2:4, 5:9] = 6.0
    return dict(
        color=(r.exponential(0.5, (h, w, 3)) + em).astype(np.float32),
        albedo=r.uniform(0.02, 0.9, (h, w, 3)).astype(np.float32),
        normal=n.astype(np.float32), depth=depth, emissive=em,
        motion=r.uniform(-1.5, 1.5, (h, w, 2)).astype(np.float32),
        grad=(r.uniform(0, 1, (h, w)) * (r.uniform(0, 1, (h, w)) < 0.2)
              ).astype(np.float32))


def _close(j, t, tol, what=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=what, **tol)


def _close_state(js, ts, tol):
    for k, v in leaves(js).items():
        if isinstance(v, dict):
            _close_state(getattr(js, k), getattr(ts, k), tol)
        else:
            _close(v, getattr(ts, k), tol, k)


@pytest.mark.parametrize("motion", [False, True])
def test_recur_two_frames(motion):
    """Two chained ReCur frames from the empty state, with the emissive
    pass-through, the second with motion reprojection (or static): the
    outputs and every state field."""
    js = jrecur.ReCurState.create(H, W)
    ts = trecur.ReCurState.create(H, W, "cpu")
    for seed in (1, 2):
        g = _frame(seed)
        g["normal"], g["depth"] = _frame(1)["normal"], _frame(1)["depth"]
        mo = g["motion"] if motion and seed == 2 else None
        jo, js = jrecur.recur_denoise(
            *(jnp.asarray(g[k]) for k in ("color", "albedo", "normal",
                                          "depth")), js,
            motion=None if mo is None else jnp.asarray(mo),
            emissive=jnp.asarray(g["emissive"]))
        to, ts = trecur.recur_denoise(
            *(_t(g[k]) for k in ("color", "albedo", "normal", "depth")), ts,
            motion=_t(mo), emissive=_t(g["emissive"]))
        _close(jo, to, CHAIN, "out")
        _close_state(js, ts, CHAIN)
    assert float(ts.hist_len.max()) == 2.0
    # the emissive pixels pass through unfiltered
    assert (to.numpy()[2:4, 5:9] >= 6.0).all()


def test_recur_stencils():
    """ReCur's passes one by one: SSAO, its edge-aware blur, the
    neighbourhood clamp and the edge-stopping blur at steps 1, 2, 4."""
    g, h = _frame(3), _frame(4)
    n, d = g["normal"], g["depth"]
    ja = jrecur._ssao(jnp.asarray(n), jnp.asarray(d))
    ta = trecur._ssao(_t(n), _t(d))
    _close(ja, ta, STEP, "ssao")
    assert float(ta.min()) < 1.0
    _close(jrecur._ssao_filter(ja, jnp.asarray(n), jnp.asarray(d)),
           trecur._ssao_filter(ta, _t(n), _t(d)), STEP, "ssao_filter")
    _close(jrecur._neighborhood_clamp(jnp.asarray(h["color"]),
                                      jnp.asarray(g["color"])),
           trecur._neighborhood_clamp(_t(h["color"]), _t(g["color"])),
           dict(rtol=0, atol=0), "clamp")
    hl = np.random.default_rng(5).uniform(0, 40, (H, W)).astype(np.float32)
    for step in (1, 2, 4):
        _close(jrecur._edge_blur(*(jnp.asarray(x) for x in (
            g["color"], n, d, hl)), step),
            trecur._edge_blur(*(_t(x) for x in (g["color"], n, d, hl)),
                              step), STEP, f"edge_blur {step}")


def test_down3_up3_edge_pad():
    """_down3's edge padding at 20x23 (neither a multiple of 3), for
    [H,W] and [H,W,3] images, and _up3 back to 20x23: the nine-tap box
    means to rtol 1e-6, _up3 exact."""
    r = np.random.default_rng(6)
    for shape in ((H, W), (H, W, 3)):
        x = r.uniform(0, 2, shape).astype(np.float32)
        jd, td = jasvgf._down3(jnp.asarray(x)), tasvgf._down3(_t(x))
        assert td.shape == (7, 8) + shape[2:]
        _close(jd, td, dict(rtol=1e-6, atol=0), "down3")
        ju, tu = jasvgf._up3(jd, H, W), tasvgf._up3(_t(np.asarray(jd)), H, W)
        assert tu.shape == shape
        _close(ju, tu, dict(rtol=0, atol=0), "up3")


def test_gradient_chain():
    """gradient_atrous on a sparse stratum gradient, and gradient_alpha
    on a full-resolution sparse gradient image at 20x23: the diffused
    field and the alpha map."""
    g = _frame(7)["grad"]
    s = g[:H // 3, :W // 3]
    _close(jasvgf.gradient_atrous(jnp.asarray(s)),
           tasvgf.gradient_atrous(_t(s)), STEP, "gradient_atrous")
    ja, jg = jasvgf.gradient_alpha(jnp.asarray(g), H, W)
    ta, tg = tasvgf.gradient_alpha(_t(g), H, W)
    _close(ja, ta, STEP, "alpha")
    _close(jg, tg, STEP, "gradient")
    assert ta.shape == (H, W) and float(ta.max()) > tasvgf.ALPHA_MIN
    assert float(ta.min()) >= tasvgf.ALPHA_MIN


def test_lf_atrous():
    """The wide depth-stopped passes at stratum resolution."""
    g = _frame(8)
    lf = tasvgf._down3(_t(g["color"]))
    dl = tasvgf._down3(_t(g["depth"]))
    _close(jasvgf._lf_atrous(jnp.asarray(lf.numpy()),
                             jnp.asarray(dl.numpy())),
           tasvgf._lf_atrous(lf, dl), STEP, "lf_atrous")


def test_asvgf_filter_two_frames():
    """Two chained asvgf_filter frames (LF/HF split, the HF chain through
    SVGF with the alpha map; the second with motion) from the empty
    state, with the emissive pass-through: the outputs, the SVGF state
    and the LF history."""
    js = jasvgf.ASVGFState.create(H, W)
    ts = tasvgf.ASVGFState.create(H, W, "cpu")
    for seed in (9, 10):
        g = _frame(seed)
        g["normal"], g["depth"] = _frame(9)["normal"], _frame(9)["depth"]
        alpha, _ = jasvgf.gradient_alpha(jnp.asarray(g["grad"]), H, W)
        mo = g["motion"] if seed == 10 else None
        jo, jsv, jlf, jlen = jasvgf.asvgf_filter(
            *(jnp.asarray(g[k]) for k in ("color", "albedo", "normal",
                                          "depth")), js, alpha,
            motion=None if mo is None else jnp.asarray(mo),
            emissive=jnp.asarray(g["emissive"]))
        to, tsv, tlf, tlen = tasvgf.asvgf_filter(
            *(_t(g[k]) for k in ("color", "albedo", "normal", "depth")), ts,
            _t(np.asarray(alpha)), motion=_t(mo),
            emissive=_t(g["emissive"]))
        _close(jo, to, CHAIN, "out")
        _close(jlf, tlf, CHAIN, "lf_hist")
        _close(jlen, tlen, CHAIN, "lf_len")
        _close_state(jsv, tsv, CHAIN)
        js = js._replace(svgf=jsv, lf_hist=jlf, lf_len=jlen)
        ts = tasvgf.ASVGFState(svgf=tsv, prev_lum=ts.prev_lum,
                               prev_sid=ts.prev_sid, lf_hist=tlf,
                               lf_len=tlen)
    assert float(tlen.max()) > 1.0          # the LF history grew


@pytest.mark.parametrize("alpha", [False, True])
def test_svgf_alpha_map(alpha):
    """svgf_denoise over three frames with and without alpha_map (the
    third with motion): outputs and every state field against JAX."""
    js = jsvgf.SVGFState.create(H, W)
    ts = tsvgf.SVGFState.create(H, W, "cpu")
    for seed in (11, 12, 13):
        g = _frame(seed)
        g["normal"], g["depth"] = _frame(11)["normal"], _frame(11)["depth"]
        a = g["grad"] + 0.05 if alpha else None
        mo = g["motion"] if seed == 13 else None
        jo, js = jsvgf.svgf_denoise(
            *(jnp.asarray(g[k]) for k in ("color", "albedo", "normal",
                                          "depth")), js,
            motion=None if mo is None else jnp.asarray(mo),
            alpha_map=None if a is None else jnp.asarray(a))
        to, ts = tsvgf.svgf_denoise(
            *(_t(g[k]) for k in ("color", "albedo", "normal", "depth")), ts,
            motion=_t(mo), alpha_map=_t(a))
        _close(jo, to, CHAIN, "out")
        _close_state(js, ts, CHAIN)


def test_svgf_constant_alpha_map_is_the_fixed_blend():
    """alpha_map leaves svgf_denoise's fixed-alpha path as it was: with a
    constant map at the fixed alphas (0.2, a history cap of 5 frames) the
    first four frames, whose history is at most 4, are bit for bit those
    of alpha_map=None."""
    assert tsvgf.ALPHA_COLOR == tsvgf.ALPHA_MOMENTS == 0.2
    st = {k: tsvgf.SVGFState.create(H, W, "cpu") for k in ("none", "map")}
    for seed in (14, 15, 16, 17):
        g = _frame(seed)
        g["normal"], g["depth"] = _frame(14)["normal"], _frame(14)["depth"]
        args = [_t(g[k]) for k in ("color", "albedo", "normal", "depth")]
        o1, st["none"] = tsvgf.svgf_denoise(*args, st["none"])
        o2, st["map"] = tsvgf.svgf_denoise(
            *args, st["map"], alpha_map=torch.full((H, W), 0.2))
        assert torch.equal(o1, o2)
        for k in ("color", "moments", "hist_len"):
            assert torch.equal(getattr(st["none"], k), getattr(st["map"], k))
    assert float(st["map"].hist_len.max()) == 4.0


def test_asvgf_steps_are_their_parts():
    """asvgf_step (a traced sample, then asvgf_gradient and asvgf_filter)
    and restir_asvgf_step (restir_gi_step, then gradient_alpha and
    asvgf_filter) on the port's Cornell box at 9x9: bit for bit the same
    calls made by hand, over three frames, the sample id kept."""
    from truetrace_tpu_torch.integrate import restir
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample_with_stats)
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam = cornell.make(device="cpu")
    sc = compile_scene(meshes, mats, with_cwbvh=True, with_light_bvh=True,
                       device="cpu")
    n = 9
    cfg = RenderConfig(width=n, height=n, bounces=2, bsdf="disney",
                       traversal="wavefront", light_sampling="tree",
                       restir_capture=True)
    pix = torch.arange(n * n)
    a = b = tasvgf.ASVGFState.create(n, n, "cpu")
    ra = rb = restir.ReSTIRState.create(n, n, "cpu")
    for sid in range(3):
        out, a, aux = tasvgf.asvgf_step(sc, cam, cfg, a, sid)
        rad, st = render_sample_with_stats(sc, cam, cfg, pix, sid)
        alpha, grad, lum, s = tasvgf.asvgf_gradient(sc, cam, cfg, b, sid,
                                                    rad)
        img = lambda k, c=3: st[k].reshape(n, n, c) if c else st[k].reshape(
            n, n)
        ref, sv, lf, ln = tasvgf.asvgf_filter(
            rad.reshape(n, n, 3), img("albedo"), img("normal"),
            img("depth", 0), b, alpha, emissive=img("emitted0"))
        b = tasvgf.ASVGFState(svgf=sv, prev_lum=lum, prev_sid=s,
                              lf_hist=lf, lf_len=ln)
        assert torch.equal(out, ref) and torch.equal(aux["alpha"], alpha)
        assert torch.equal(a.lf_hist, b.lf_hist) and int(a.prev_sid) == sid
        out, ra, a2, aux = tasvgf.restir_asvgf_step(sc, cam, cfg, ra, a, sid)
        gi, rb, gaux = restir.restir_gi_step(sc, cam, cfg, rb, sid)
        alpha, _ = tasvgf.gradient_alpha(gaux["gradient"], n, n)
        ref, sv, lf, ln = tasvgf.asvgf_filter(
            gi, gaux["albedo"], gaux["normal"], gaux["depth"], a, alpha,
            emissive=gaux["emitted0"])
        assert torch.equal(out, ref) and torch.equal(a2.svgf.color, sv.color)
        assert torch.equal(a2.prev_lum, a.prev_lum) and int(a2.prev_sid) == sid
    assert float(a.svgf.hist_len.max()) > 1.0
