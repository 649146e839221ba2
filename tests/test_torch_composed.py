"""Torch port, the composed production frame: the ReSTIR DI prepass, one
trace through the radiance cache, the cache's resolve, ReSTIR GI and
SVGF in Renderer.step, against one eager run of a fresh JAX Renderer
(two frames of the Cornell box, the second moving the camera). The run
records its module calls on the way (pytest's monkeypatch; no JAX file
changes), so each module of the port runs on the JAX package's own
inputs: the traces and their captures, the cache's update and resolve,
the DI and GI reservoirs, the two whole frames, and the second frame
resumed in the port from the JAX state. Then the cache on its own: hash
and cell packing bit for bit, the contended-slot rule, and probing under
contention.

Two discontinuities turn last-ulp differences (rsqrt, sin/cos,
contracted mul-adds) into different discrete results, and each is held
by its own rule:

* Reservoirs keep a candidate where u * wsum < w. A lane may pick
  another sample than the JAX one only near a decision of the port's
  within FLIP_MARGIN * wsum (or downstream of one, through the spatial
  taps), and on at most 1% of the lanes.
* A cache cell is floor(position / cell size), and the Cornell box's
  walls lie on cell boundaries (x = -1, z = 0, ...), where a vertex an
  ulp apart falls in the next cell. A record's cell may differ from the
  JAX one only by such a step: the same level and normal octant, each
  coordinate within 1. Whole cache tables are compared entry by entry
  for the cells both hold, their totals, and the cells one of them holds
  alone, each of which has a neighbouring cell in the other."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from truetrace_tpu import renderer as jrenderer
from truetrace_tpu.integrate import radiance_cache as jrc
from truetrace_tpu.integrate import restir as jrestir
from truetrace_tpu.integrate import restir_di as jrestir_di
from truetrace_tpu.renderer import Renderer as JRenderer
from truetrace_tpu.renderer import RendererConfig as JRendererConfig
from truetrace_tpu.scene import cornell as jcornell
from truetrace_tpu.scene.ir import Camera as JCamera
from truetrace_tpu.scene.mesh import compile_scene as jcompile
from truetrace_tpu_torch.integrate import radiance_cache as rc
from truetrace_tpu_torch.integrate import restir, restir_di
from truetrace_tpu_torch.integrate.pathtrace import (
    RenderConfig, render_sample_with_stats)
from truetrace_tpu_torch.renderer import FrameState, Renderer, RendererConfig
from truetrace_tpu_torch.scene.ir import Camera, Scene

from torch_parity import check_sample, close_share, leaves

SHARE = 0.99            # check_sample's share of pixels
FLIP_MARGIN = 1e-5      # |u * wsum - w| below this share of wsum
CFG = dict(width=16, height=16, bounces=2, bsdf="disney",
           traversal="wavefront", light_sampling="tree", denoiser="svgf",
           use_restir=True, use_restir_di=True, use_radiance_cache=True,
           cache_query_bounce=1, cache_capacity=1 << 12)
RECORDED = ((jrenderer, "render_sample_with_stats"),
            (jrenderer, "render_sample_cached"),
            (jrenderer, "cache_resolve"), (jrc, "cache_update"),
            (jrestir_di, "restir_di_reservoirs"),
            (jrestir, "restir_gi_from_stats"))


@pytest.fixture(scope="module")
def run():
    """Two frames of a fresh, eager JAX Renderer with every module call
    recorded: {name: [(args, kwargs, result)] in call order}."""
    meshes, mats, jcam = jcornell.make()
    js = jcompile(meshes, mats, with_cwbvh=True, with_light_bvh=True)
    c2w = np.asarray(jcam.c2w).copy()
    c2w[3, 0] += 0.05                                   # the eye moves
    jmoved = JCamera(c2w=jnp.asarray(c2w), fov_y=jcam.fov_y,
                     aperture=jcam.aperture, focus_dist=jcam.focus_dist)
    calls = {name: [] for _, name in RECORDED}

    def recorder(fn, name):
        def call(*a, **k):
            out = fn(*a, **k)
            calls[name].append((a, k, out))
            return out
        return call

    jr = JRenderer(js, jcam, JRendererConfig(**CFG))
    st = jr.init_state()
    frames, states = [], []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in RECORDED:
            mp.setattr(mod, name, recorder(getattr(mod, name), name))
        for cam, moved in ((None, None), (jmoved, True)):
            disp, acc, st = jr.step(st, cam=cam, cam_moved=moved)
            frames.append((np.asarray(disp), np.asarray(acc)))
            states.append(leaves(st))
    return dict(calls=calls, frames=frames, states=states,
                scene=Scene.from_numpy(leaves(js), "cpu"),
                cam=_cam(jcam), moved=_cam(jmoved))


def _t(x):
    """A JAX array (or None) as a torch tensor; uint32 and int32 words as
    int64."""
    if x is None:
        return None
    a = np.array(x)                     # a writable copy
    if a.dtype in (np.uint32, np.int32):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def _cam(jcam):
    return None if jcam is None else Camera.from_numpy(leaves(jcam), "cpu")


def _cfg(jcfg) -> RenderConfig:
    return RenderConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(RenderConfig)})


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


CAPTURE_EXACT = ("cand_valid", "mat1", "cache_live")


def _cell_step(jw0, jw1, tw0, tw1):
    """Per record: the packed cells are equal, or neighbours (same level
    and octant, each coordinate within 1): a boundary flip."""
    jc, jl, jo = rc._unpack_cell(*(_t(w) for w in (jw0, jw1)))
    tc, tl, to = rc._unpack_cell(tw0, tw1)
    return ((jl == tl) & (jo == to)
            & ((jc - tc).abs() <= 1).all(-1)).numpy()


def _check_captures(jst, tst, share):
    """Every capture key of the trace against the JAX one: floats within
    check_sample's pixel tolerance (rtol 1e-4 / atol 1e-5), words and
    flags equal, each on >= `share` of pixels."""
    n = np.asarray(jst["depth"]).shape[0]
    keys = [k for k in ("direct", "indirect", "x1", "x2", "n2", "tp1",
                        "pdf1", "cand_valid", "mat1", "cache_prefix",
                        "cache_tp", "cache_live") if k in jst]
    assert keys and all(k in tst for k in keys)
    if "cache_w0" in jst:
        jw0, jw1 = (np.asarray(jst[k]) for k in ("cache_w0", "cache_w1"))
        tw0, tw1 = tst["cache_w0"], tst["cache_w1"]
        same = (jw0 == tw0.numpy()) & (jw1 == tw1.numpy())
        assert _cell_step(jw0, jw1, tw0, tw1).all()
        assert same.mean() >= 0.75
    for k in keys:
        a = np.asarray(jst[k]).reshape(n, -1)
        b = tst[k].numpy().reshape(n, -1)
        if k in CAPTURE_EXACT:
            same = (a.astype(np.int64) == b.astype(np.int64)).all(-1)
            assert same.mean() >= share, k
        else:
            assert close_share(a, b, 1e-4, 1e-5) >= share, k
    if "cache_hit_rate" in tst:
        np.testing.assert_allclose(float(jst["cache_hit_rate"]),
                                   float(tst["cache_hit_rate"]), atol=1e-6)


@pytest.mark.parametrize("frame", [0, 1])
@pytest.mark.parametrize("trace", ["prepass", "cached"])
def test_trace_matches_jax(run, trace, frame):
    """The DI prepass (1 bounce, restir capture) and the main trace
    through the cache (DI samples at bounce-0 NEE, cache records and
    query, GI captures) on the JAX run's inputs: radiance, G-buffer and
    ray counts as check_sample holds them, and every capture key."""
    if trace == "prepass":
        a, k, (jrad, jst) = run["calls"]["render_sample_with_stats"][frame]
        trad, tst = render_sample_with_stats(
            run["scene"], _cam(a[1]), _cfg(a[2]), _t(a[3]), int(a[4]))
        assert "direct" in tst and "cache_w0" not in tst
    else:
        a, k, (jrad, jst, _) = run["calls"]["render_sample_cached"][frame]
        di = {key: _t(v) for key, v in k["di_sample"].items()}
        trad, tst, _ = rc.render_sample_cached(
            run["scene"], _cam(a[1]), _cfg(a[2]),
            rc.RadianceCache.from_numpy(leaves(a[3]), "cpu"), _t(a[4]),
            int(a[5]), di_sample=di)
        assert tst["cache_w0"].shape == (256, CFG["bounces"])
    check_sample(jrad, jst, trad, tst, SHARE)
    _check_captures(jst, tst, SHARE)


def _contended(h, weight, C):
    """Slots that two or more live records probe."""
    h, live = np.asarray(h).astype(np.int64), np.asarray(weight) > 0
    probes = ((h[live, None] % C + np.arange(rc.N_PROBES)) % C).ravel()
    seen = np.bincount(probes, minlength=C)
    return seen > 1


def _port_cache(jcache):
    return rc.RadianceCache.from_numpy(leaves(jcache), "cpu")


@pytest.mark.parametrize("frame", [0, 1])
def test_cache_update_matches_jax(run, frame):
    """cache_update on the JAX run's records: keys, packed cells and ages
    bit for bit; radiance and counts bit for bit in every slot no two
    records probe, and within rtol 1e-6 in the others."""
    a, k, jout = run["calls"]["cache_update"][frame]
    out = rc.cache_update(_port_cache(a[0]), *(_t(x) for x in a[1:]),
                          w0=_t(k["w0"]), w1=_t(k["w1"]))
    busy = _contended(a[1], a[4], out.capacity)
    assert float(np.asarray(a[4]).sum()) > 50          # records inserted
    for f in ("key", "cellw0", "cellw1", "age"):
        np.testing.assert_array_equal(_bits(getattr(jout, f)),
                                      _bits(getattr(out, f)), f)
    for f in ("rad", "count"):
        j, t = np.asarray(getattr(jout, f)), getattr(out, f).numpy()
        np.testing.assert_array_equal(_bits(j[~busy]), _bits(t[~busy]), f)
        np.testing.assert_allclose(t[busy], j[busy], rtol=1e-6, atol=0)


@pytest.mark.parametrize("frame", [0, 1])
def test_cache_resolve_matches_jax(run, frame):
    """cache_resolve on the JAX run's cache: decay and caps, and in the
    second frame (a camera move) the reprojection merge; bit for bit."""
    a, k, jout = run["calls"]["cache_resolve"][frame]
    assert ("prev_cam_pos" in k) == (frame == 1)
    out = rc.cache_resolve(_port_cache(a[0]), **{
        key: _t(v) for key, v in k.items()})
    for f in ("key", "rad", "count", "age", "cellw0", "cellw1"):
        np.testing.assert_array_equal(_bits(getattr(jout, f)),
                                      _bits(getattr(out, f)), f)


class _Decisions:
    """Records the port's reservoir picks (`keep`): the lanes where one
    was within FLIP_MARGIN of its threshold."""

    def __init__(self, mp, mod):
        self.near = None
        orig = mod.keep

        def keep(u, wsum, w):
            ws = torch.clamp(wsum, min=1e-20)
            near = (u * ws - w).abs() < FLIP_MARGIN * ws
            self.near = near if self.near is None else self.near | near
            return orig(u, wsum, w)
        mp.setattr(mod, "keep", keep)


def _reach(mask, passes):
    """Pixels a spatial reuse can carry a change at `mask` to: for each
    pass (a tuple of tap offsets, each applied to the reservoirs as the
    pass found them, or in sequence), every pixel reading a changed one."""
    m = mask.copy()
    for taps, sequential in passes:
        if sequential:
            for dy, dx in taps:
                m = m | np.roll(m, (dy, dx), (0, 1))
        else:
            m = m | np.any([np.roll(m, t, (0, 1)) for t in taps], axis=0)
    return m


def _check_reservoirs(pick_j, pick_t, near, passes, pairs):
    """Lanes whose reservoir holds another sample than the JAX one (not
    within rtol 1e-5 / atol 1e-6): at most 1% of the lanes, each within
    reach of a near-threshold pick; elsewhere every
    (JAX, port, exact) pair in `pairs` agrees (exact, or within rtol
    1e-4 / atol 1e-5). Returns the number of flipped lanes."""
    flip = ~np.isclose(pick_j, pick_t, rtol=1e-5, atol=1e-6).all(-1)
    assert flip.mean() <= 0.01, flip.sum()
    assert not (flip & ~_reach(near, passes)).any()
    for j, t, exact in pairs:
        if exact:
            np.testing.assert_array_equal(j[~flip], t[~flip])
        else:
            np.testing.assert_allclose(t[~flip], j[~flip], rtol=1e-4,
                                       atol=1e-5)
    return int(flip.sum())


@pytest.mark.parametrize("frame", [0, 1])
def test_di_reservoirs_match_jax(run, frame):
    """restir_di_reservoirs on the JAX run's G-buffer, state and motion:
    the picked light samples (pos, ln, rad) equal but for threshold
    flips, M exact, W and the DI sample weights within rtol 1e-4 /
    atol 1e-5."""
    a, k, (jdi, jstate) = run["calls"]["restir_di_reservoirs"][frame]
    with pytest.MonkeyPatch.context() as mp:
        dec = _Decisions(mp, restir_di)
        tdi, tstate = restir_di.restir_di_reservoirs(
            run["scene"], _cam(a[1]), _cfg(a[2]),
            restir_di.ReSTIRDIState.from_numpy(leaves(a[3]), "cpu"),
            int(a[4]), *(_t(x) for x in a[5:8]),
            prev_cam=_cam(k["prev_cam"]), motion=_t(k["motion"]))
    assert (k["motion"] is None) == (frame == 0)
    H, W = CFG["height"], CFG["width"]
    taps = [tuple(t) for t in restir_di.SPATIAL_TAPS]
    js = {f: np.asarray(getattr(jstate, f)) for f in jstate._fields}
    ts = {f: getattr(tstate, f).numpy() for f in js}
    pick = lambda s: np.concatenate([s["pos"], s["ln"], s["rad"]], -1)
    _check_reservoirs(
        pick(js), pick(ts), dec.near.numpy(), [(taps, True)],
        [(js["M"], ts["M"], True), (js["W"], ts["W"], False),
         (np.asarray(jdi["W"]).reshape(H, W), tdi["W"].numpy().reshape(
             H, W), False)]
        + [(js[f], ts[f], True) for f in ("normal", "depth")])
    assert (ts["M"] > 0).mean() > 0.5


@pytest.mark.parametrize("frame", [0, 1])
def test_gi_matches_jax(run, frame):
    """restir_gi_from_stats on the JAX run's trace captures, state and
    motion: the picked samples (x2, n2, rad) equal but for threshold
    flips, M exact, W, the image and the temporal-validation gradient
    within rtol 1e-4 / atol 1e-5."""
    a, k, (jimg, jstate, jaux) = run["calls"]["restir_gi_from_stats"][frame]
    st = {key: _t(v) for key, v in a[5].items()}
    with pytest.MonkeyPatch.context() as mp:
        dec = _Decisions(mp, restir)
        timg, tstate, taux = restir.restir_gi_from_stats(
            run["scene"], _cam(a[1]), _cfg(a[2]),
            restir.ReSTIRState.from_numpy(leaves(a[3]), "cpu"), int(a[4]),
            st, prev_cam=_cam(k["prev_cam"]), motion=_t(k["motion"]))
    js = {f: np.asarray(getattr(jstate, f)) for f in jstate._fields}
    ts = {f: getattr(tstate, f).numpy() for f in js}
    pick = lambda s: np.concatenate([s["x2"], s["n2"], s["rad"]], -1)
    taps = [tuple(t) for t in restir.SPATIAL_TAPS]
    passes = [([(dy * s, dx * s) for dy, dx in taps], False)
              for s in (1, 2)]
    _check_reservoirs(
        pick(js), pick(ts), dec.near.numpy(), passes,
        [(js["M"], ts["M"], True), (js["W"], ts["W"], False),
         (np.asarray(jimg), timg.numpy(), False),
         (np.asarray(jaux["gradient"]), taux["gradient"].numpy(), False)])
    assert (ts["M"] > 1).any() and np.abs(timg.numpy()).max() > 0


def test_gi_step_is_trace_then_reservoirs(run):
    """restir_gi_step, the standalone GI frame, is one traced sample with
    the GI captures followed by restir_gi_from_stats: bit for bit the
    two calls made by hand, over two frames with a camera move."""
    cfg = RenderConfig(width=8, height=8, bounces=2, bsdf="disney",
                       traversal="wavefront", light_sampling="tree",
                       restir_capture=True)
    sc, pix = run["scene"], torch.arange(64)
    st = {k: restir.ReSTIRState.create(8, 8, "cpu") for k in ("step", "hand")}
    prev = None
    for sid, cam in enumerate((run["cam"], run["moved"])):
        a = restir.restir_gi_step(sc, cam, cfg, st["step"], sid,
                                  prev_cam=prev)
        _, tr = render_sample_with_stats(sc, cam, cfg, pix, sid)
        b = restir.restir_gi_from_stats(sc, cam, cfg, st["hand"], sid, tr,
                                        prev_cam=prev)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1].W, b[1].W)
        st = {"step": a[1], "hand": b[1]}
        prev = cam
    assert float(st["step"].M.max()) > 1


def _state_fields(d: dict) -> dict:
    """name -> numpy array of every tensor field of a FrameState's numpy
    leaves (as `leaves` gives them) other than the cameras."""
    out = {"accum.image": d["accum"]["image"], "taa": d["taa_history"]}
    for part in ("svgf", "restir", "restir_di"):
        out.update({f"{part}.{f}": v for f, v in d[part].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_leaves(st: FrameState) -> dict:
    t = lambda o: {f.name: getattr(o, f.name).numpy()
                   for f in dataclasses.fields(o)}
    return {"accum": t(st.accum), "taa_history": st.taa_history.numpy(),
            **{p: t(getattr(st, p)) for p in ("svgf", "restir", "restir_di",
                                              "cache")}}


def _entries(cache: dict) -> dict:
    """(cellw0, cellw1) -> (count, rad, age) of a cache's occupied slots."""
    c = {k: np.asarray(v) for k, v in cache.items()}
    return {(int(c["cellw0"][i]), int(c["cellw1"][i])):
            (c["count"][i], c["rad"][i], c["age"][i])
            for i in np.nonzero(c["key"])[0]}


def _check_cache(jc: dict, tc: dict):
    """The port's cache table against the JAX one, entry by entry (the
    same cell can sit in another slot): the cells both hold agree in
    count and radiance (rtol 1e-4 / atol 1e-5) and age, on >= SHARE of
    them; of the cells one table holds alone, all but 1 - SHARE of its
    entries (a path that went another way) are boundary flips, each a
    neighbour of a cell the other holds; the totals of count and
    radiance agree to rtol 1e-5."""
    je, te = _entries(jc), _entries(tc)
    both = set(je) & set(te)
    assert len(both) >= 0.75 * len(je) > 0
    ok = [np.allclose(je[c][0], te[c][0], rtol=1e-4, atol=1e-5)
          and np.allclose(je[c][1], te[c][1], rtol=1e-4, atol=1e-5)
          and je[c][2] == te[c][2] for c in both]
    assert np.mean(ok) >= SHARE
    w = lambda cells, i: torch.tensor([c[i] for c in cells])
    for mine, other in ((je, te), (te, je)):
        other = sorted(other)
        odd = [c for c in sorted(set(mine) - both)
               if not _cell_step(w([c], 0).repeat(len(other)),
                                 w([c], 1).repeat(len(other)),
                                 w(other, 0), w(other, 1)).any()]
        assert len(odd) <= (1 - SHARE) * len(mine)
    for f in ("count", "rad"):
        np.testing.assert_allclose(np.asarray(tc[f]).sum(0),
                                   np.asarray(jc[f]).sum(0), rtol=1e-5)


def _check_frame(jframe, jstate, display, radiance, state):
    """A port frame against the JAX one: the display within 1e-3 and
    every state field (the accumulation, TAA and SVGF histories, both
    reservoir images; rows by pixel) within rtol 1e-4 / atol 1e-5, each
    on >= SHARE of its rows; the cache by _check_cache; the display and
    radiance means to rtol 1e-4."""
    jd, ja = jframe
    d = display.numpy()
    assert np.isfinite(d).all() and d.min() >= 0 and d.max() <= 1
    assert close_share(jd, d, 0.0, 1e-3) >= SHARE
    np.testing.assert_allclose(jd.mean(), d.mean(), rtol=1e-4)
    np.testing.assert_allclose(ja.mean(), radiance.numpy().mean(), rtol=1e-4)
    tl = _torch_leaves(state)
    tf = _state_fields(tl)
    for k, j in _state_fields(jstate).items():
        rows = j.shape[0] * j.shape[1]
        assert close_share(j.reshape(rows, -1), tf[k].reshape(rows, -1),
                           1e-4, 1e-5) >= SHARE, k
    _check_cache(jstate["cache"], tl["cache"])


def test_frames_match_jax(run):
    """Two Renderer.step frames of a fresh port Renderer (the second
    moving the camera with cam_moved=True: motion reprojection and the
    cache's merge) against the JAX run's."""
    r = Renderer(run["scene"], run["cam"], RendererConfig(**CFG))
    st = r.init_state()
    for i, (cam, moved) in enumerate(((None, None), (run["moved"], True))):
        disp, rad, st = r.step(st, cam=cam, cam_moved=moved)
        _check_frame(run["frames"][i], run["states"][i], disp, rad, st)
    assert st.sample == 2 and float(st.accum.count) == 1.0


def test_frame_resumes_jax_state(run):
    """The second frame in the port, from the JAX state after the first
    (FrameState.from_numpy: accumulation, SVGF, both reservoirs and the
    cache), against the JAX second frame."""
    st = FrameState.from_numpy(run["states"][0], "cpu")
    assert st.sample == 1 and st.cache.capacity == CFG["cache_capacity"]
    r = Renderer(run["scene"], run["cam"], RendererConfig(**CFG))
    disp, rad, st = r.step(st, cam=run["moved"], cam_moved=True)
    _check_frame(run["frames"][1], run["states"][1], disp, rad, st)


# ---------------------------------------------------------------------------
# the cache on its own
# ---------------------------------------------------------------------------

def _cells(seed, n=4096):
    """Random grid cells: coords across the 17-bit range and at its
    edges (+-2^16, 2^16 - 1, -1, 0), levels 0-12, octants 0-7."""
    r = np.random.default_rng(seed)
    c = r.integers(-(1 << 16), 1 << 16, (n, 3)).astype(np.int32)
    edge = np.array([-(1 << 16), (1 << 16) - 1, 1 << 16, -1, 0], np.int32)
    c[:64] = edge[r.integers(0, len(edge), (64, 3))]
    return (c, r.integers(0, 13, n).astype(np.int32),
            r.integers(0, 8, n).astype(np.int32))


@pytest.mark.parametrize("what", ["hash", "pack", "cell"])
def test_cache_bits_match_jax(what):
    """_hash_u32 and _cell_hash, _pack_cell and _unpack_cell, and
    cache_cell_packed on positions, bit for bit against the JAX
    functions (uint32 words held as int64)."""
    c, lev, octn = _cells(3)
    if what == "hash":
        x = np.random.default_rng(4).integers(0, 1 << 32, 4096,
                                              dtype=np.uint64)
        x[:4] = [0, 1, (1 << 32) - 1, 1 << 31]
        pairs = [(jrc._hash_u32(jnp.asarray(x.astype(np.uint32))),
                  rc._hash_u32(torch.from_numpy(x.astype(np.int64))))]
        pairs += zip(jrc._cell_hash(*map(jnp.asarray, (c, lev, octn))),
                     rc._cell_hash(*map(_t, (c, lev, octn))))
    elif what == "pack":
        jw = jrc._pack_cell(*map(jnp.asarray, (c, lev, octn)))
        tw = rc._pack_cell(*map(_t, (c, lev, octn)))
        pairs = list(zip(jw, tw))
        # 17-bit coords come back sign-extended (2^16 wraps to -2^16)
        pairs += zip(jrc._unpack_cell(*jw), rc._unpack_cell(*tw))
    else:
        r = np.random.default_rng(5)
        pos = r.uniform(-30, 30, (4096, 3)).astype(np.float32)
        nrm = r.normal(size=(4096, 3)).astype(np.float32)
        cam = np.array([0.5, 1.0, -2.0], np.float32)
        pairs = zip(jrc.cache_cell_packed(*map(jnp.asarray,
                                               (pos, nrm, cam))),
                    rc.cache_cell_packed(*map(torch.from_numpy,
                                              (pos, nrm, cam))))
    for j, t in pairs:
        np.testing.assert_array_equal(np.asarray(j).astype(np.int64),
                                      t.numpy())


def test_contended_slot_rule():
    """Records that claim one empty slot in the same update: the slot
    takes the key and cell of the record with the highest index, and
    the radiance and weight of all of them; a second update matches the
    key and accumulates. The same inputs give the same bits twice."""
    C, N = 64, 40
    r = np.random.default_rng(9)
    h = torch.full((N,), 7, dtype=torch.int64)          # one probe chain
    key = torch.from_numpy(r.integers(1, 1 << 32, N)) | 1
    w0 = torch.from_numpy(r.integers(0, 1 << 32, N))
    w1 = torch.from_numpy(r.integers(0, 1 << 32, N))
    rad = torch.from_numpy(r.uniform(0, 2, (N, 3)).astype(np.float32))
    wt = torch.from_numpy(r.uniform(0.5, 1, N).astype(np.float32))
    wt[::5] = 0.0                                        # skipped records
    live = torch.nonzero(wt > 0)[:, 0]
    last = int(live[-1])
    outs = [rc.cache_update(rc.RadianceCache.create(C, "cpu"), h, key, rad,
                            wt, w0=w0, w1=w1) for _ in range(2)]
    for f in dataclasses.fields(rc.RadianceCache):
        a, b = getattr(outs[0], f.name), getattr(outs[1], f.name)
        assert torch.equal(a, b), f.name
    c = outs[0]
    assert int((c.key != 0).sum()) == 1
    assert (int(c.key[7]), int(c.cellw0[7]), int(c.cellw1[7])) == (
        int(key[last]), int(w0[last]), int(w1[last]))
    torch.testing.assert_close(c.count[7], wt.sum(), rtol=1e-6, atol=0)
    torch.testing.assert_close(c.rad[7], (rad * wt[:, None]).sum(0),
                               rtol=1e-6, atol=0)
    # the next frame's records of that key find it (probe 0) and add
    again = rc.cache_update(c, h[:3], key[last].repeat(3), rad[:3],
                            torch.ones(3))
    assert float(again.count[7]) == pytest.approx(float(wt.sum()) + 3)
    assert int((again.key != 0).sum()) == 1


def test_probing_survives_contention():
    """The port's twin of tests/test_radiance_cache.py's contention
    check: at ~50% occupancy with colliding inserts, two frames of
    inserts, queries find > 90% of the entries."""
    r = np.random.default_rng(11)
    C = 1 << 12
    N = C // 2
    pos = torch.from_numpy(r.uniform(-50, 50, (N, 3)).astype(np.float32))
    nrm = torch.zeros((N, 3))
    nrm[:, 1] = 1.0
    cam = torch.zeros(3)
    h, key = rc.cache_cell(pos, nrm, cam)
    cache = rc.RadianceCache.create(C, "cpu")
    for _ in range(2):
        cache = rc.cache_update(cache, h, key, torch.ones((N, 3)),
                                torch.full((N,), rc.CONFIDENT_COUNT))
    _, hit = rc.cache_query(cache, pos, nrm, cam)
    assert float(hit.float().mean()) > 0.9
