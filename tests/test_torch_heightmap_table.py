"""Torch port, the march kernel's table of block maxima
(kernels/heightmap.py `height_top`) and its skip test on the CPU: the table
is the grid's block maxima with their margin, +inf where a block holds a
NaN or infinite height; Terrain.from_numpy, Terrain.to and the renderer's
scene walk carry it; and a torch copy of csrc/heightmap.cu's test
(`above`), run on the plain march's own steps, finds f > 0 at every step
of every span it would skip, and at every later bisection midpoint where
it collapses a bisection."""
import math

import numpy as np
import pytest
import torch

from truetrace_tpu_torch.core.math import fma
from truetrace_tpu_torch.kernels import heightmap as hm
from truetrace_tpu_torch.scene import terrain as tter

KW = dict(origin=(-3.0, 0.5, -2.0), size_xz=(10.0, 12.0), mat_ids=[0, 1],
          height_scale=2.0)


def _grid(kind: str, Hm: int, Wm: int) -> np.ndarray:
    h = np.random.default_rng(Hm * Wm).uniform(-3, 5, (Hm, Wm))
    h = h.astype(np.float32)
    if kind == "bad":
        h[Hm // 2, Wm // 3] = np.nan
        h[-1, -1] = np.inf
        h[0, Wm - 2] = -np.inf
    return h


@pytest.mark.parametrize("kind,Hm,Wm", [("plain", 2, 2), ("plain", 9, 13),
                                        ("bad", 17, 6), ("bad", 33, 33)])
def test_height_top_is_the_block_maxima(kind, Hm, Wm):
    """Level l, entry (bz, bx): the maximum M of the grid points z in
    [bz 2^l, bz 2^l + 2^(l+1)), x in [bx 2^l, bx 2^l + 2^(l+1)), plus 2^-16
    of their largest |height| plus 2^-120, rounded up to float32; +inf
    where a point is NaN or infinite; the header holds each level's
    offset, and one window of the last level holds the whole grid."""
    h = _grid(kind, Hm, Wm)
    top = hm.height_top(torch.from_numpy(h.reshape(-1)), Hm, Wm).numpy()
    levels = hm.top_levels(Hm, Wm)
    assert levels[-1] == (1, 1) or (1 << (len(levels) - 1)) >= max(
        Hm, Wm) - 1
    offs = top[:hm.TOP_HEADER].view(np.int32)
    at = hm.TOP_HEADER
    for lv, (nz, nx) in enumerate(levels):
        assert offs[lv] == at
        c = 1 << lv
        for bz in range(nz):
            for bx in range(nx):
                w = h[bz * c:bz * c + 2 * c, bx * c:bx * c + 2 * c].astype(
                    np.float64)
                got = top[at + bz * nx + bx]
                if not np.isfinite(w).all():
                    assert got == np.inf
                    continue
                want = w.max() + np.abs(w).max() * 2.0 ** -16 + 2.0 ** -120
                assert np.float64(got) >= want
                assert np.float64(np.nextafter(got, -np.inf)) < want
        at += nz * nx
    assert top.shape == (at,)
    assert (offs[len(levels):] == 0).all()


def test_terrain_carries_height_top():
    """Terrain.from_numpy (make_terrain) builds the table, Terrain.to
    keeps its bits, and the renderer's scene walk and clone take it with
    the terrain's other tensors, so a captured frame holds it."""
    import dataclasses
    from truetrace_tpu_torch.renderer import _clone_scene, _scene_parts
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    ter = tter.make_terrain(tter.demo_hills(33, seed=1), device="cpu", **KW)
    want = hm.height_top(ter.height, *ter.hm_shape)
    assert torch.equal(ter.height_top.view(torch.int32),
                       want.view(torch.int32))
    moved = ter.to("cpu")
    assert torch.equal(moved.height_top.view(torch.int32),
                       want.view(torch.int32))
    meshes, mats, _ = cornell.make(device="cpu")
    scene = dataclasses.replace(compile_scene(meshes, mats, device="cpu"),
                                terrain=ter)
    tensors, fixed = _scene_parts(scene)
    names = dict(tensors)
    assert names["terrain.height_top"] is ter.height_top
    assert ("terrain.height_top", tuple(want.shape), torch.float32) in fixed
    clone = _clone_scene(scene).terrain.height_top
    assert clone.data_ptr() != ter.height_top.data_ptr()
    assert torch.equal(clone.view(torch.int32), want.view(torch.int32))


def _cell(ter, x, z):
    """csrc/heightmap.cu `cell`: the corner (ix, iz) and whether the grid
    coordinates are numbers."""
    Hm, Wm = ter.hm_shape
    ox, _, oz, sx, sz, _ = ter.consts
    fx = (x - ox) / sx * float(Wm - 1)
    fz = (z - oz) / sz * float(Hm - 1)
    ok = ~(fx.isnan() | fz.isnan())
    fx = torch.clamp(fx, 0.0, hm._f32(Wm - 1.001))
    fz = torch.clamp(fz, 0.0, hm._f32(Hm - 1.001))
    return (torch.nan_to_num(fx).to(torch.int64),
            torch.nan_to_num(fz).to(torch.int64), ok)


def _above(ter, ro, rd, ta, tb):
    """csrc/heightmap.cu `above` for the points of the rays at ta and tb:
    both ends' y above the table's window over their cells' rectangle."""
    Hm, Wm = ter.hm_shape
    pts = []
    for t in (ta, tb):
        pts.append(_cell(ter, fma(rd[:, 0], t, ro[:, 0]),
                         fma(rd[:, 2], t, ro[:, 2]))
                   + (fma(rd[:, 1], t, ro[:, 1]),))
    (ixa, iza, oka, ya), (ixb, izb, okb, yb) = pts
    xl, zl = torch.minimum(ixa, ixb), torch.minimum(iza, izb)
    ext = torch.maximum(torch.maximum(ixa, ixb) + 1 - xl,
                        torch.maximum(iza, izb) + 1 - zl)
    # the bit length of ext - 1: the smallest lv with 2^lv >= ext
    lv = sum(((ext - 1) >> k > 0).long() for k in range(31))
    top = ter.height_top
    off = top[:hm.TOP_HEADER].view(torch.int32).long()[lv]
    nbx = ((Wm - 2) >> lv) + 1
    m = top[off + (zl >> lv) * nbx + (xl >> lv)]
    return oka & okb & (ya > m) & (yb > m)


def _terrain(kind: str):
    hills = tter.demo_hills(65, seed=2)
    if kind == "spike":
        hills[30, 41] = 3.0
    ter = tter.make_terrain(hills, device="cpu", **KW)
    if kind != "nan":
        return ter
    h = ter.height.numpy().copy()
    h[31 * 65 + 20] = np.nan
    return tter.Terrain.from_numpy(dict(
        height=h, hm_shape=ter.hm_shape, origin=ter.origin.numpy(),
        size=ter.size.numpy(), h_max=ter.h_max.numpy(),
        alphamap=ter.alphamap.numpy(), mat_ids=ter.mat_ids.numpy()), "cpu")


def _rays(R: int = 3000):
    """tests/test_torch_terrain.py's rays (above and inside the box,
    down and sideways, some outside it, dead lanes), and as many from the
    box's top corner sweeping over it."""
    rng = np.random.default_rng(1)
    ro = np.stack([rng.uniform(-5, 9, R), rng.uniform(0, 6, R),
                   rng.uniform(-4, 12, R)], -1).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d[:, 1] -= 0.5
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = rng.uniform(0.0, 30.0, R).astype(np.float32)
    tm[:100] = 0.0
    sweep = rng.normal(size=(R, 3))
    sweep[:, 0], sweep[:, 2] = np.abs(sweep[:, 0]), np.abs(sweep[:, 2])
    sweep[:, 1] = -0.05 - 0.2 * np.abs(sweep[:, 1])
    sweep /= np.linalg.norm(sweep, axis=-1, keepdims=True)
    ro = np.concatenate([ro, np.tile(np.float32([-3.5, 3.0, -2.5]),
                                     (R, 1))])
    rd = np.concatenate([rd, sweep.astype(np.float32)])
    tm = np.concatenate([tm, np.full(R, 40.0, np.float32)])
    return tuple(torch.from_numpy(x) for x in (ro, rd, tm))


@pytest.mark.parametrize("kind", ["hills", "spike", "nan"])
def test_skip_test_holds_on_the_plain_march(kind):
    """Every span j..j+K-1 (K = 1, 2, 8, 64) of every ray's march whose
    ends pass the kernel's test has f > 0 (not NaN) at each of its steps,
    as _march_plain computes them (t_0 = tn, t_j = fma(dt, j, tn)); where
    the test passes between a miss's first bisection midpoint and tf,
    every later midpoint of the bisection that keeps the low side has
    f > 0 too. Many spans pass."""
    ter = _terrain(kind)
    ro, rd, tm = _rays()
    steps = hm.MARCH_STEPS
    tn, tf, inside = hm._aabb_clip(ter, ro, rd, tm)
    dt = torch.where(inside, (tf - tn) * hm._f32(1.0 / steps), 0.0)

    def f_at(t):
        x = fma(rd[:, 0], t, ro[:, 0])
        z = fma(rd[:, 2], t, ro[:, 2])
        return fma(rd[:, 1], t, ro[:, 1]) - hm._sample_height(ter, x, z, True)

    def t_at(j):
        return tn if j == 0 else fma(dt, torch.full_like(dt, float(j)), tn)

    pos = torch.stack([f_at(t_at(j)) > 0 for j in range(steps + 1)], 1)
    passed = 0
    for span in (1, 2, 8, 64):
        for j in range(0, steps + 1, max(1, span // 2)):
            jb = min(j + span - 1, steps)
            ok = _above(ter, ro, rd, t_at(j), t_at(jb))
            assert bool(pos[ok, j:jb + 1].all()), (span, j)
            passed += int(ok.sum())
    assert passed > 10000
    # the bisection of a miss from [tn, tf], every step keeping lo
    lo, hi = tn.clone(), tf.clone()
    mid = 0.5 * (lo + hi)
    ok = _above(ter, ro, rd, mid, hi) & (f_at(tn) > 0)
    assert int(ok.sum()) > 100
    for _ in range(hm.BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        assert bool((f_at(mid)[ok] > 0).all())
        lo = mid
    assert math.isinf(float(ter.height_top.max())) == (kind == "nan")


def test_march_bound_counts_the_kernels_samples():
    """chip_smoke.hm_work bounds the march by the samples the kernel
    takes where they are given (the plain version's otherwise): 37
    operations a sample against the grid read once and 53 bytes a ray
    (closest) or 29 (any), and keeps the plain samples' bound beside
    it."""
    import chip_smoke as cs
    R, grid = 1000, 33 * 33
    counts = dict(samples=torch.full((R,), 40), march_steps=torch.full(
        (R,), 24))
    for closest, nbytes in ((True, 4 * grid + 53 * R),
                            (False, 4 * grid + 29 * R)):
        plain = cs.hm_work(counts, R, grid, closest)
        got = cs.hm_work(counts, R, grid, closest, kernel_samples=14 * R)
        assert plain["bound_ms"] == plain["plain_bound_ms"] == \
            got["plain_bound_ms"]
        assert (got["samples_per_ray"], got["kernel_samples_per_ray"],
                got["march_steps_per_ray"]) == (40, 14, 24)
        t_ops, t_bytes = (37 * 14 * R / cs.PEAK_F32,
                          nbytes / cs.PEAK_BYTES)
        assert got["bound_ms"] == pytest.approx(1e3 * max(t_ops, t_bytes))
        assert got["bound_by"] == ("operations" if t_ops >= t_bytes
                                   else "bytes")
        assert got["bound_ms"] <= plain["bound_ms"]
