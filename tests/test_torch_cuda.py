"""Torch port, the CUDA kernels against their plain PyTorch twins on the
card, at small sizes and on the edges the main path does not reach:
frame sizes that are no multiple of the a-trous tiles, a-trous steps that
do not divide the frame or are wider than it, every a-trous path, a
frame's kind of G-buffer (sky, zero variance, far depths), every compiled
leaf width (K = 3, 4, 5, 6, 8, 12; rows of 3 and 5 are no multiple of 16
bytes), a stack so shallow that pushes drop entries, dead lanes, ray
counts that leave warps part empty or outnumber the resident lanes,
back-to-back launches (the ray counter starts anew), and the wrappers'
argument checks; and the textured, sky-lit sponza_like scene: the bench
mix's rays bitwise, a-trous on a frame with sky rows, and its SVGF frames
on the card against the CPU; and the frame itself on both scenes: no host
copy or sync inside Renderer.step, and Renderer.graph_step's replayed
CUDA graphs bit for bit the eager frames; and the same two for the
composed frame (ReSTIR DI and GI, the radiance cache), whose cache update
gives the same bits run after run; the transmittance query bit for bit
at every leaf width, and the same two frame checks for the ASVGF,
ReSTIR-ASVGF, ReCur and nested-glass frames, and for the post chain
with temporal auto exposure, TAAU with partial rendering and analytic
lights, and the neural_taa denoiser; the two-level traversal's three
queries bit for bit at every leaf width (a 2-entry stack among them),
the heightmap march bit for bit, and the two frame checks for the
forest (instances on a terrain, the lanterns moved between frames by
update_instance_transforms and replayed with no recapture); and the
animated atrium: pose_scene without a host sync and bit for bit the
CPU's, posed scenes replayed with no recapture, the two frame checks,
and the skinning's clamped bone indices.

Needs an NVIDIA card and nvcc; skips elsewhere. It imports no JAX, so it
runs on a machine without it (the JAX-side conftest is skipped):

    python -m pytest -q -p no:cacheprovider --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from truetrace_tpu_torch.kernels import _cuda, atrous_pallas
from truetrace_tpu_torch.kernels import cwbvh_wavefront as wf
from truetrace_tpu_torch.kernels import step_pallas
from truetrace_tpu_torch.scene import atrium
from truetrace_tpu_torch.scene.mesh import compile_scene

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _atrous_args(dev, h, w, inputs, seed):
    """Colour, variance, normal and depth for the a-trous kernel: random
    unit normals, or a frame's kind of G-buffer ("frame": normals that
    mostly face one way, a patch of zero variance, depths of 1e4 and
    above, and sky rows with zero normal and depth)."""
    r = np.random.default_rng(seed)
    color = r.uniform(0, 3, (h, w, 3)).astype(np.float32)
    var = r.uniform(0, 0.5, (h, w)).astype(np.float32)
    depth = r.uniform(0.5, 10, (h, w)).astype(np.float32)
    if inputs == "random":
        normal = _unit(r, h * w).reshape(h, w, 3)
    else:
        normal = r.normal(size=(h, w, 3)).astype(np.float32)
        normal[..., 2] = np.abs(normal[..., 2]) + 2.0
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        var[: h // 2, : w // 3] = 0.0
        depth[h // 2:, w // 2:] = r.uniform(1e4, 1e6, (h - h // 2,
                                                     w - w // 2))
        normal[-2:], depth[-2:] = 0.0, 0.0
    return [torch.from_numpy(a).to(dev) for a in (color, var, normal, depth)]


@pytest.mark.parametrize("inputs", ["random", "frame"])
@pytest.mark.parametrize("h,w,step", [(37, 53, 1), (37, 53, 4), (37, 53, 8),
                                      (24, 40, 16), (24, 40, 32), (5, 7, 2),
                                      (64, 96, 1), (64, 96, 2), (64, 96, 4),
                                      (64, 96, 8), (64, 96, 16)])
def test_atrous_kernel_matches_plain(dev, h, w, step, inputs):
    """Both paths of the kernel against the plain pass, rtol 1e-4 /
    atol 1e-5: the card's exp2 and seven squarings round differently from
    torch's exp and pow in the last ulps, which the normalised sums carry.
    The wrapper's launch, then each path on its own: the direct one (in
    32x8 and 128x2 blocks) at every shape, the staged one wherever step
    divides H and W (64x96 at every step)."""
    args = _atrous_args(dev, h, w, inputs, h * w + step)
    n0 = atrous_pallas.atrous_pass_packed.launches
    outs = [atrous_pallas.atrous_pass(*args, step)]
    assert atrous_pallas.atrous_pass_packed.launches == n0 + 1
    cv, nz = atrous_pallas.pack(*args[:2]), atrous_pallas.pack(*args[2:])
    staged_ok = _cuda.lib("atrous.cu").tt_atrous_staged_ok(h, w, step)
    assert staged_ok == (h == 64 or step == 1)
    paths = [atrous_pallas.DIRECT, atrous_pallas.DIRECT_WIDE]
    for path in paths + [atrous_pallas.STAGED] * staged_ok:
        outs.append(atrous_pallas.unpack(atrous_pallas._launch(cv, nz, step,
                                                               path)))
    pc, pv = atrous_pallas.atrous_pass_plain(*args, step)
    torch.cuda.synchronize()
    for c, v in outs:
        torch.testing.assert_close(c, pc, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(v, pv, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("h,w", [(64, 96), (37, 53)])
def test_atrous_filter_matches_five_plain_passes(dev, h, w):
    """The packed five-pass route svgf_denoise takes (steps 1-16, planes
    packed once) against five plain passes: the first pass's colour, and
    the last pass's colour and variance."""
    args = _atrous_args(dev, h, w, "frame", 5)
    n0 = atrous_pallas.atrous_pass_packed.launches
    fh, fc, fv = atrous_pallas.atrous_filter(*args, 5)
    pc, pv = args[:2]
    for i in range(5):
        pc, pv = atrous_pallas.atrous_pass_plain(pc, pv, *args[2:], 1 << i)
        ph = pc if i == 0 else ph
    torch.cuda.synchronize()
    assert atrous_pallas.atrous_pass_packed.launches == n0 + 5
    for a, b in ((fh, ph), (fc, pc), (fv, pv)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def scenes(dev):
    meshes, mats, cam, env = atrium.make(detail=0.2, device=dev)
    out = {k: compile_scene(meshes, mats, env=env, with_cwbvh=True,
                            leaf_k=k, device=dev)
           for k in (3, 4, 5, 6, 8, 12)}
    r = np.random.default_rng(3)
    R = 3000
    lo = out[3].tri_p0.amin(0).cpu().numpy()
    hi = out[3].tri_p0.amax(0).cpu().numpy()
    ro = torch.from_numpy(r.uniform(lo, hi, (R, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, R))
    tm = torch.from_numpy(r.uniform(0.05, 8.0, R).astype(np.float32))
    tm[:100] = 0.0                                   # dead lanes
    tm[100:1500] = 1e30
    return out, ro.to(dev), rd.to(dev), tm.to(dev)


def _check_both(sc, ro, rd, tm, S=None):
    """Kernel against plain: closest hit bitwise (t, tri, u, v) and
    occlusion equal. Returns the kernel's closest hit."""
    S = sc.cw_stack if S is None else S
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    hk = wf.closest_hit_wavefront(table, C, ro, rd, tm, S)
    hp = wf.closest_hit_plain(table, C, ro, rd, tm, S)
    for f in ("t", "tri", "u", "v"):
        a, b = getattr(hk, f), getattr(hp, f)
        assert torch.equal(a.view(torch.int32), b.to(a.dtype).view(
            torch.int32)), f
    assert torch.equal(wf.any_hit_wavefront(table, C, ro, rd, tm, S),
                       wf.any_hit_plain(table, C, ro, rd, tm, S))
    return hk


@pytest.mark.parametrize("k", [3, 4, 5, 6, 8, 12])
@pytest.mark.parametrize("stack", ["scene", 2])
def test_traversal_kernel_bitwise(scenes, k, stack):
    """Closest hit (t, tri, u, v) and occlusion are bitwise the plain
    lock-step traversal's for every compiled leaf width (rows of K = 3
    and 5, 30 and 50 words, are no multiple of 16 bytes and are read 8
    bytes at a time), also with a 2-entry stack whose pushes drop the
    deepest entry (the shift-register semantics the ring mirrors): some
    rays then lose subtrees, and the kernel loses the same ones. The
    kernel's stack entry drops the pushed group's leaf-row base (bleaf),
    which the plain traversal keeps as the JAX one does: equal bits pin
    that it is dead state."""
    out, ro, rd, tm = scenes
    sc = out[k]
    S = sc.cw_stack if stack == "scene" else stack
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    assert (table.shape[1] % 4 == 0) == (k % 2 == 0)
    hk = _check_both(sc, ro, rd, tm, S)
    assert bool((hk.tri[:100] == -1).all())
    if stack == 2:
        full = wf.closest_hit_plain(table, C, ro, rd, tm, sc.cw_stack)
        assert bool((hk.tri != full.tri).any())
    ok = wf.any_hit_wavefront(table, C, ro, rd, tm, S)
    assert 0.05 < float(ok.float().mean()) < 0.95


def _misaligned(x):
    """A contiguous copy of x whose data start 4 bytes past a 16-byte
    boundary."""
    y = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = y[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16 == 4
    return y


@pytest.mark.parametrize("R", [1000, 4096, 65539])
@pytest.mark.parametrize("layout", ["aligned", "misaligned"])
def test_step_core_kernel_bitwise(scenes, dev, R, layout):
    """The standalone step_core launch on random rows of the K = 3 table
    (leaf and node lanes) against step_core_plain, with write_uv true and
    false: at lane counts that are no multiple of 4 or of a tile (1000,
    65539) and one that is (4096), on inputs that start 16-byte aligned
    and on views that start 4 bytes past (every row segment misaligned
    for 16-byte copies)."""
    out = scenes[0]
    sc = out[3]
    table = sc.cw_table()
    r = np.random.default_rng(R)
    lo = sc.tri_p0.amin(0).cpu().numpy()
    hi = sc.tri_p0.amax(0).cpu().numpy()
    ro = torch.from_numpy(r.uniform(lo, hi, (R, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, R))
    ro, rd = ro.to(dev), rd.to(dev)
    g = torch.Generator().manual_seed(4)
    idx = torch.randint(0, table.shape[0], (R,), generator=g).to(dev)
    C = sc.cw_nodes.shape[0]
    rowt = torch.nn.functional.pad(table[idx], (0, 2)).t().contiguous()
    inv = wf._inv_dir(rd)
    ray9 = torch.cat([ro.t(), rd.t(), inv.t()]).contiguous()
    st5 = torch.stack([torch.full((R,), 1e30, device=dev).view(torch.int32),
                       torch.full((R,), -1, dtype=torch.int32, device=dev),
                       torch.zeros(R, dtype=torch.int32, device=dev),
                       torch.zeros(R, dtype=torch.int32, device=dev),
                       (idx >= C).to(torch.int32)]).contiguous()
    if layout == "misaligned":
        rowt, ray9, st5 = (_misaligned(x) for x in (rowt, ray9, st5))
    n0 = step_pallas.step_core.launches
    for write_uv in (True, False):
        a = step_pallas.step_core(rowt, ray9, st5, write_uv)
        b = step_pallas.step_core_plain(rowt, ray9, st5, write_uv)
        assert torch.equal(a, b)
    assert step_pallas.step_core.launches == n0 + 2


def test_wrappers_reject_bad_arguments(scenes, dev):
    out, ro, rd, tm = scenes
    sc = out[6]
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    with pytest.raises(ValueError):
        wf.closest_hit_wavefront(table, C, ro.double(), rd, tm, 8)
    with pytest.raises(ValueError):
        wf.closest_hit_wavefront(table, C, ro.t().contiguous().t(), rd, tm,
                                 8)
    with pytest.raises(ValueError):
        wf.any_hit_wavefront(table, C, ro, rd, tm, 64)
    # a table whose rows would be read misaligned, and a leaf width with
    # no compiled kernel
    t3 = out[3].cw_table()
    shifted = torch.empty(t3.numel() + 1, dtype=torch.int32, device=dev)
    shifted = shifted[1:].view(t3.shape)
    shifted.copy_(t3)
    with pytest.raises(ValueError, match="aligned"):
        wf.closest_hit_wavefront(shifted, out[3].cw_nodes.shape[0], ro, rd,
                                 tm, 8)
    with pytest.raises(ValueError, match="K = 7"):
        wf.closest_hit_wavefront(torch.zeros((64, 70), dtype=torch.int32,
                                             device=dev), 8, ro, rd, tm, 8)
    x = torch.zeros((8, 8), device=dev)
    with pytest.raises(ValueError):
        atrous_pallas.atrous_pass(torch.zeros((8, 8, 3), device=dev), x,
                                  torch.zeros((8, 8, 3), device=dev),
                                  x.double(), 1)
    # packed planes: not contiguous, not 16-byte aligned
    cv = torch.zeros((8, 8, 4), device=dev)
    with pytest.raises(ValueError):
        atrous_pallas.atrous_pass_packed(cv, cv.transpose(0, 1), 1)
    shifted = torch.zeros(8 * 8 * 4 + 1, device=dev)[1:].view(8, 8, 4)
    with pytest.raises(ValueError, match="aligned"):
        atrous_pallas.atrous_pass_packed(shifted, cv, 1)


@pytest.mark.parametrize("R", [1, 33, 262145])
def test_traversal_kernel_ray_counts(scenes, dev, R):
    """One ray, a warp and a lane over, and more rays than the persistent
    grid holds lanes at the main path's leaf width, so warps pull many
    batches from the counter."""
    out, _, _, _ = scenes
    sc = out[6]
    r = np.random.default_rng(R)
    lo = sc.tri_p0.amin(0).cpu().numpy()
    hi = sc.tri_p0.amax(0).cpu().numpy()
    ro = torch.from_numpy(r.uniform(lo, hi, (R, 3)).astype(np.float32))
    rd = torch.from_numpy(_unit(r, R))
    tm = torch.from_numpy(r.uniform(0.05, 8.0, R).astype(np.float32))
    hk = _check_both(sc, ro.to(dev), rd.to(dev), tm.to(dev))
    if R > 1:
        assert 0 < int((hk.tri >= 0).sum()) < R


@pytest.mark.parametrize("dead", ["all", "half"])
def test_traversal_kernel_dead_lanes(scenes, dead):
    """t_max = 0 lanes (the integrator's dead paths) miss without a walk:
    every lane, or every other lane."""
    out, ro, rd, tm = scenes
    tm = tm.clone()
    if dead == "all":
        tm.zero_()
    else:
        tm[::2] = 0.0
    hk = _check_both(out[6], ro, rd, tm)
    d = tm == 0
    assert bool((hk.tri[d] == -1).all()) and bool((hk.t[d] == 0).all())
    assert bool((hk.u[d] == 0).all()) and bool((hk.v[d] == 0).all())
    if dead == "half":
        assert bool((hk.tri[~d] >= 0).any())


def test_traversal_kernel_repeats_bitwise(scenes):
    """Two launches in a row give the same bits: each launch starts its
    ray counter at 0, so no ray is skipped or walked twice."""
    out, ro, rd, tm = scenes
    sc = out[6]
    table, C, S = sc.cw_table(), sc.cw_nodes.shape[0], sc.cw_stack
    a = wf.closest_hit_wavefront(table, C, ro, rd, tm, S)
    b = wf.closest_hit_wavefront(table, C, ro, rd, tm, S)
    for f in ("t", "tri", "u", "v"):
        assert torch.equal(getattr(a, f).view(torch.int32),
                           getattr(b, f).view(torch.int32)), f
    assert torch.equal(wf.any_hit_wavefront(table, C, ro, rd, tm, S),
                       wf.any_hit_wavefront(table, C, ro, rd, tm, S))


# ---------------------------------------------------------------------------
# sponza_like: the textured, sky-lit scene
# ---------------------------------------------------------------------------

_SPONZA = {}


def _sponza(dev, tmp_path_factory, detail):
    """sponza_like exported, loaded and built on the card (K = 6, light
    BVH) and on the CPU, once per detail."""
    if detail not in _SPONZA:
        from truetrace_tpu_torch.scene import sponza_like
        d = str(tmp_path_factory.mktemp(f"sponza_{detail:g}"))
        parts = sponza_like.make(detail, assets_dir=d, device=dev)
        m, mats, atlas, rects, level_y, cam, env = parts
        kw = dict(atlas=atlas, atlas_rects=rects, atlas_level_y=level_y,
                  with_cwbvh=True, with_light_bvh=True)
        _SPONZA[detail] = (
            compile_scene(m, mats, env=env, device=dev, **kw),
            compile_scene(m, mats, env=env.to("cpu"), device="cpu", **kw)
            if detail < 1 else None, cam)
    return _SPONZA[detail]


@pytest.mark.parametrize("detail", [0.5, 5.0])
def test_traversal_kernel_bitwise_on_sponza(dev, tmp_path_factory, detail):
    """bench.py's mix on sponza_like (primary camera rays, many of which
    leave through the open roof, cosine bounce rays from their hits, and
    shadow rays along those): closest hit bitwise and occlusion equal to
    the plain traversal."""
    import chip_smoke
    sc, _, cam = _sponza(dev, tmp_path_factory, detail)
    assert sc.cw_leaf_rows.shape[1] == 60
    ro_p, rd_p, ro_b, rd_b, tm_b = chip_smoke.bench_rays(sc, cam, 1 << 14)
    hk = _check_both(sc, ro_p, rd_p, torch.full_like(tm_b, 1e30))
    assert 0.05 < float((hk.tri >= 0).float().mean()) < 0.999
    _check_both(sc, ro_b, rd_b, tm_b)


def _svgf_inputs(sc, cam, w, h):
    """The colour, variance, normal and depth svgf_denoise hands its
    first a-trous pass in the second Renderer.step frame."""
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    r = Renderer(sc, cam, RendererConfig(
        width=w, height=h, bounces=3, denoiser="svgf"))
    seen, orig = [], atrous_pallas.atrous_filter

    def grab(*args):
        seen.append(args)
        return orig(*args)
    st = r.init_state()
    _, _, st = r.step(st)
    atrous_pallas.atrous_filter = grab
    try:
        r.step(st)
    finally:
        atrous_pallas.atrous_filter = orig
    return seen[0][:4]


def test_atrous_kernel_on_sponza_frame(dev, tmp_path_factory):
    """The a-trous kernel at every step and over the five-pass route on a
    sponza frame's own inputs, whose open roof leaves sky rows with zero
    normal and depth in the guide: rtol 1e-4 / atol 1e-5 against the
    plain pass."""
    sc, _, cam = _sponza(dev, tmp_path_factory, 0.5)
    color, var, normal, depth = _svgf_inputs(sc, cam, 96, 64)
    sky = (normal == 0).all(-1)
    assert 0.01 < float(sky.float().mean()) < 0.9
    for step in (1, 2, 4, 8, 16):
        c1, v1 = atrous_pallas.atrous_pass(color, var, normal, depth, step)
        c2, v2 = atrous_pallas.atrous_pass_plain(color, var, normal, depth,
                                                 step)
        torch.testing.assert_close(c1, c2, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(v1, v2, rtol=1e-4, atol=1e-5)
    fh, fc, fv = atrous_pallas.atrous_filter(color, var, normal, depth, 5)
    pc, pv = color, var
    for i in range(5):
        pc, pv = atrous_pallas.atrous_pass_plain(pc, pv, normal, depth,
                                                 1 << i)
    torch.testing.assert_close(fc, pc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fv, pv, rtol=1e-4, atol=1e-5)


def test_sponza_renderer_card_matches_cpu(dev, tmp_path_factory):
    """Two SVGF Renderer.step frames of sponza_like at 32x24 on the card
    and on the CPU from the same build: the same counters and traversal,
    so >= 98% of display pixels agree to 1e-3 and the means to 1e-3
    (the card rounds transcendentals differently)."""
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    sc, sc_cpu, cam = _sponza(dev, tmp_path_factory, 0.5)
    kw = dict(width=32, height=24, bounces=3, denoiser="svgf")
    rg = Renderer(sc, cam, RendererConfig(**kw))
    rc = Renderer(sc_cpu, cam.to("cpu"), RendererConfig(**kw))
    st_g, st_c = rg.init_state(), rc.init_state()
    for _ in range(2):
        dg, _, st_g = rg.step(st_g)
        dc, _, st_c = rc.step(st_c)
        dg = dg.cpu()
        assert bool(torch.isfinite(dg).all())
        close = ((dg - dc).abs() <= 1e-3).all(-1).float().mean()
        assert float(close) >= 0.98
        assert abs(float(dg.mean()) - float(dc.mean())) <= 1e-3 * float(
            dc.mean())


# ---------------------------------------------------------------------------
# the frame: no host copy or sync inside Renderer.step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scene", ["atrium", "sponza_like"])
def test_frame_makes_no_host_sync(dev, tmp_path_factory, scene):
    """Renderer.step (Disney, light-tree NEE, SVGF) after a warm-up frame:
    one more frame, then one that moves the camera with cam_moved=True,
    under torch.cuda.set_sync_debug_mode("error"), which raises at any
    blocking copy between host and card and at any stream or device
    sync. The moved frame restarts accumulation."""
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    from truetrace_tpu_torch.scene.ir import Camera
    if scene == "atrium":
        meshes, mats, cam, env = atrium.make(detail=0.2, device=dev)
        sc = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                           with_light_bvh=True, device=dev)
    else:
        sc, _, cam = _sponza(dev, tmp_path_factory, 0.5)
    assert sc.lbvh_pairs.shape[0] > 0
    r = Renderer(sc, cam, RendererConfig(
        width=64, height=48, bounces=4, bsdf="disney",
        traversal="wavefront", light_sampling="tree", denoiser="svgf"))
    st = r.init_state()
    _, _, st = r.step(st)
    c2w = cam.c2w.clone()
    c2w[3, :3] += 0.05                                  # the eye moves
    moved = Camera(c2w=c2w, fov_y=cam.fov_y, aperture=cam.aperture,
                   focus_dist=cam.focus_dist)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, st = r.step(st)
        disp, _, st = r.step(st, cam=moved, cam_moved=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(st.accum.count) == 1.0
    assert bool(torch.isfinite(disp).all())


@pytest.mark.parametrize("scene", ["atrium", "sponza_like"])
def test_graph_frames_match_eager(dev, tmp_path_factory, scene):
    """Renderer.graph_step against Renderer.step on fresh renderers, four
    SVGF frames each: as they are (the first runs eagerly on both paths,
    the second is captured and replayed), moving the camera
    (cam_moved=True, its own graph) and with the moved camera
    (cam_moved=False, the first graph fed the second's state). Display,
    radiance and every state tensor are bit for bit the eager ones; two
    more replays run under set_sync_debug_mode("error")."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    if scene == "atrium":
        meshes, mats, cam, env = atrium.make(detail=0.2, device=dev)
        sc = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                           with_light_bvh=True, device=dev)
    else:
        sc, _, cam = _sponza(dev, tmp_path_factory, 0.5)
    cfg = RendererConfig(width=64, height=48, bounces=4, bsdf="disney",
                         traversal="wavefront", light_sampling="tree",
                         denoiser="svgf")
    moved = chip_smoke.moved_camera(cam)
    re, rg = Renderer(sc, cam, cfg), Renderer(sc, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for c, moved_now, frame in ((None, None, gs), (None, None, gs),
                                (moved, True, gm), (moved, False, gs)):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        pairs = [(de, dg), (ae, ag), (se.accum.count, sg.accum.count),
                 (se.taa_history, sg.taa_history)] + [
            (getattr(se.svgf, k), getattr(sg.svgf, k))
            for k in ("color", "moments", "hist_len", "normal", "depth")]
        assert all(chip_smoke.torch_equal_bits(a, b) for a, b in pairs)
        assert sg.sample == se.sample
    assert (gs.captures, gm.captures) == (1, 1)
    assert float(sg.accum.count) == 2.0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, sg = gs(sg)
        dg, _, sg = gm(sg, cam=cam)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(dg).all()) and float(sg.accum.count) == 1.0


# ---------------------------------------------------------------------------
# the composed frame: ReSTIR DI and GI, the radiance cache, SVGF
# ---------------------------------------------------------------------------

COMPOSED = dict(width=64, height=48, bounces=4, bsdf="disney",
                traversal="wavefront", light_sampling="tree", denoiser="svgf",
                use_restir=True, use_restir_di=True, use_radiance_cache=True,
                cache_query_bounce=2, cache_capacity=1 << 16)


def _atrium_small(dev):
    meshes, mats, cam, env = atrium.make(detail=0.2, device=dev)
    return compile_scene(meshes, mats, env=env, with_cwbvh=True,
                         with_light_bvh=True, device=dev), cam


def test_composed_frame_makes_no_host_sync(dev):
    """The composed Renderer.step after a warm-up frame: one more frame,
    then one that moves the camera with cam_moved=True (motion
    reprojection of both reservoirs, the cache's merge), under
    torch.cuda.set_sync_debug_mode("error")."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    sc, cam = _atrium_small(dev)
    r = Renderer(sc, cam, RendererConfig(**COMPOSED))
    st = r.init_state()
    _, _, st = r.step(st)
    moved = chip_smoke.moved_camera(cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, st = r.step(st)
        disp, _, st = r.step(st, cam=moved, cam_moved=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(st.accum.count) == 1.0 and st.sample == 3
    assert bool(torch.isfinite(disp).all())
    assert int((st.cache.key != 0).sum()) > 0 and float(st.restir.M.max()) > 1


def test_composed_graph_frames_match_eager(dev):
    """Renderer.graph_step against Renderer.step on the composed frame,
    four frames as test_graph_frames_match_eager runs them (a camera move
    among them): display, radiance and every state tensor, the ReSTIR
    reservoirs and the cache tables included, bit for bit."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import (
        Renderer, RendererConfig, _tensors)
    sc, cam = _atrium_small(dev)
    cfg = RendererConfig(**COMPOSED)
    moved = chip_smoke.moved_camera(cam)
    re, rg = Renderer(sc, cam, cfg), Renderer(sc, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for c, moved_now, frame in ((None, None, gs), (None, None, gs),
                                (moved, True, gm), (moved, False, gs)):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        assert te.keys() == tg.keys() and "cache.key" in te
        assert all(chip_smoke.torch_equal_bits(a, b) for a, b in
                   [(de, dg), (ae, ag)] + [(te[k], tg[k]) for k in te])
        assert sg.sample == se.sample
    assert (gs.captures, gm.captures) == (1, 1)


def test_cache_update_repeats_bitwise(dev):
    """cache_update with many records on few slots (every record probes
    one of 64 chains of a 4096-slot table): twice, and replayed from a
    CUDA graph, the same bits (the sums go through index_put_'s sort
    path, which adds each slot's records in one order); the slot keeps
    the key of its highest-index record."""
    from truetrace_tpu_torch.integrate import radiance_cache as rc
    r = np.random.default_rng(5)
    N, C = 65536, 4096
    t = lambda a: torch.from_numpy(a).to(dev)
    h = t(r.integers(0, 64, N) * 61)
    key = t(r.integers(1, 1 << 32, N) | 1)
    rad = t(r.uniform(0, 4, (N, 3)).astype(np.float32))
    wt = t((r.uniform(0, 1, N) > 0.2).astype(np.float32))
    cache = rc.RadianceCache.create(C, dev)

    def run():
        return rc.cache_update(cache, h, key, rad, wt, w0=key, w1=h)

    outs = [run(), run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs.append(run())
    g.replay()
    torch.cuda.synchronize()
    for o in outs[1:]:
        for f in ("key", "rad", "count", "age", "cellw0", "cellw1"):
            a, b = getattr(outs[0], f), getattr(o, f)
            assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                               else a, b.view(torch.int32)
                               if b.is_floating_point() else b), f
    cpu = rc.cache_update(rc.RadianceCache.create(C, "cpu"), h.cpu(),
                          key.cpu(), rad.cpu(), wt.cpu(), w0=key.cpu(),
                          w1=h.cpu())
    for f in ("key", "age", "cellw0", "cellw1"):
        assert torch.equal(getattr(outs[0], f).cpu(), getattr(cpu, f)), f
    torch.testing.assert_close(outs[0].count.cpu(), cpu.count, rtol=1e-5,
                               atol=0)
    torch.testing.assert_close(outs[0].rad.cpu(), cpu.rad, rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------------------------
# the transmittance kernel, glass frames and the temporal denoisers
# ---------------------------------------------------------------------------

def _tints(T, dev):
    """A shadow tint table of three kinds by triangle id: opaque, grey
    0.8, and coloured glass."""
    i = torch.arange(T, device=dev) % 3
    return torch.stack([torch.where(i == 0, 0.0, torch.where(i == 1, 0.8, c))
                        for c in (0.9, 0.5, 0.2)], -1).contiguous()


@pytest.mark.parametrize("k", [3, 4, 5, 6, 8, 12])
@pytest.mark.parametrize("stack", ["scene", 2])
def test_transmit_kernel_bitwise(scenes, k, stack):
    """The transmittance query of traverse.cu bit for bit against
    transmit_plain for every compiled leaf width, through opaque, grey
    and coloured surfaces (lanes that pass some in part, lanes that
    retire below 1e-3, dead lanes that read 1), also with a 2-entry
    stack whose pushes drop the deepest entry: some rays then miss tinted
    surfaces, and the kernel misses the same ones."""
    out, ro, rd, tm = scenes
    sc = out[k]
    S = sc.cw_stack if stack == "scene" else stack
    table, C = sc.cw_table(), sc.cw_nodes.shape[0]
    tint = _tints(sc.n_tris(), ro.device)
    tk = wf.transmit_wavefront(table, C, tint, ro, rd, tm, S)
    tp = wf.transmit_plain(table, C, tint, ro, rd, tm, S)
    assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
    assert bool((tk[:100] == 1.0).all())
    m = tk.amax(-1)
    assert float(((m > 0) & (m < 1)).float().mean()) > 0.05
    assert float((m == 0).float().mean()) > 0.05
    if stack == 2:
        full = wf.transmit_plain(table, C, tint, ro, rd, tm, sc.cw_stack)
        assert bool((tk != full).any())
    # the opaque table is the any hit's occlusion
    zero = torch.zeros_like(tint)
    assert torch.equal(wf.transmit_wavefront(table, C, zero, ro, rd, tm,
                                             S).amax(-1) == 0,
                       wf.any_hit_wavefront(table, C, ro, rd, tm, S))


SLICE = dict(width=64, height=48, bounces=4, bsdf="disney",
             traversal="wavefront", light_sampling="tree")
# (scene, config) of each frame the slice adds
FRAMES = {"asvgf": ("atrium", dict(SLICE, denoiser="asvgf")),
          "recur": ("atrium", dict(SLICE, denoiser="recur")),
          "restir_asvgf": ("atrium", dict(SLICE, denoiser="asvgf",
                                          use_restir=True)),
          "glass": ("glass", dict(SLICE, bounces=10, rr_start=6,
                                  denoiser="svgf")),
          "forest": ("forest", dict(SLICE, traversal="tlas",
                                    light_sampling="tree", denoiser="svgf")),
          "animated": ("animated", dict(SLICE, denoiser="svgf"))}
FOREST_SMALL = dict(n_hm=65, n_trees=128, n_lanterns=8)


def _slice_frame(dev, name):
    import chip_smoke
    scene, cfg = FRAMES[name]
    if scene == "glass":
        sc, cam = chip_smoke.nested_glass_scene(dev)
    elif scene == "forest":
        sc, cam = _forest_small(dev)[0], _forest_small(dev)[4]
    elif scene == "animated":
        sc, cam = _animated_small(dev)[0].scene, _animated_small(dev)[1]
    else:
        sc, cam = _atrium_small(dev)
    return sc, cam, cfg


_forest_cache = {}


def _forest_small(dev):
    """chip_smoke's forest at FOREST_SMALL with its light BVH (the frame
    samples the lanterns by the light tree) and two lantern updates of it
    (their traversal tables packed): (scene, InstancedScene, materials,
    instances, camera, [updated scenes])."""
    if "f" not in _forest_cache:
        import chip_smoke
        from truetrace_tpu_torch.scene.instances import (
            update_instance_transforms)
        sc, isc, mats, inst, cam = chip_smoke.forest_scene(
            dev, with_light_bvh=True, **FOREST_SMALL)
        ups = [update_instance_transforms(sc, isc, mats,
                                          chip_smoke.forest_bob(inst, k))[0]
               for k in (1, 2)]
        for u in ups:
            u.cw_table()
        _forest_cache["f"] = (sc, isc, mats, inst, cam, ups)
    return _forest_cache["f"]


_animated_cache = {}


def _animated_small(dev):
    """chip_smoke's animated atrium small (detail 0.2, a 16 x 24
    cylinder): (DynamicScene, camera)."""
    if "a" not in _animated_cache:
        import chip_smoke
        _animated_cache["a"] = chip_smoke.animated_scene(
            dev, detail=0.2, n_radial=16, n_height=24)
    return _animated_cache["a"]


def _next_scene(dev, name, k=1):
    """A function making the scene a slice's later frame swaps in: the
    forest's lanterns moved, or the animated cylinder at pose k (its
    bones made here, pose_scene when it is called)."""
    if name == "forest":
        nxt = _forest_small(dev)[5][k - 1]
        return lambda: nxt
    if name == "animated":
        import chip_smoke
        from truetrace_tpu_torch.scene.dynamic import pose_scene
        dyn = _animated_small(dev)[0]
        bones = chip_smoke.animated_bones(k, dev)
        return lambda: pose_scene(dyn, bones)
    return lambda: None


@pytest.mark.parametrize("name", ["asvgf", "restir_asvgf", "glass",
                                  "forest", "animated"])
def test_slice_frame_makes_no_host_sync(dev, name):
    """The ASVGF frame (its stratum replay reads the previous sample id
    on the card), ReSTIR-ASVGF, the nested-glass frame (the
    transmittance kernel, the medium stack), the forest (the
    two-level traversal, the march, per-object motion; its second frame
    also swaps in a scene with the lanterns moved) and the animated
    atrium (its second frame swaps in a pose made by pose_scene inside
    the checked region): after a warm-up
    frame, one more and one moving the camera with cam_moved=True, under
    torch.cuda.set_sync_debug_mode("error")."""
    import chip_smoke
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        transmit_wavefront)
    sc, cam, cfg = _slice_frame(dev, name)
    r = chip_smoke.make_renderer(sc, cam, cfg)
    st = r.init_state()
    _, _, st = r.step(st)
    moved = chip_smoke.moved_camera(cam)
    launches = transmit_wavefront.launches
    nxt = _next_scene(dev, name)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, st = r.step(st)
        disp, _, st = r.step(st, cam=moved, cam_moved=True, scene=nxt())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(st.accum.count) == 1.0 and st.sample == 3
    assert bool(torch.isfinite(disp).all())
    assert (transmit_wavefront.launches > launches) == (name == "glass")


@pytest.mark.parametrize("name", ["asvgf", "recur", "glass", "forest",
                                  "animated"])
def test_slice_graph_frames_match_eager(dev, name):
    """Renderer.graph_step against Renderer.step on the ASVGF, ReCur,
    nested-glass, forest and animated frames, four frames as
    test_graph_frames_match_eager runs them (a camera move among them):
    display, radiance and every state tensor (ASVGF's nested SVGF state,
    its stratum luminance and previous sample id, ReCur's histories, the
    forest's previous instance transforms) bit for bit; the forest then
    two more frames with the lanterns moved by update_instance_transforms,
    and the animated atrium three more at new poses (pose_scene), the new
    scene handed to the cam_moved graph and copied into its captured
    scene on the device: bit for bit, with no recapture."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import _tensors
    sc, cam, cfg = _slice_frame(dev, name)
    moved = chip_smoke.moved_camera(cam)
    re = chip_smoke.make_renderer(sc, cam, cfg)
    rg = chip_smoke.make_renderer(sc, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for c, moved_now, frame in ((None, None, gs), (None, None, gs),
                                (moved, True, gm), (moved, False, gs)):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        assert te.keys() == tg.keys()
        assert all(chip_smoke.torch_equal_bits(a, b) for a, b in
                   [(de, dg), (ae, ag)] + [(te[k], tg[k]) for k in te])
    assert (gs.captures, gm.captures) == (1, 1)
    if name == "asvgf":
        assert "asvgf.svgf.color" in te and int(sg.asvgf.prev_sid) == 3
    if name in ("forest", "animated"):
        for k in (1, 2) if name == "forest" else (1, 2, 3):
            nxt = _next_scene(dev, name, k)()
            de, ae, se = re.step(se, cam=moved, cam_moved=True, scene=nxt)
            dg, ag, sg = gm(sg, cam=moved, scene=nxt)
            te, tg = dict(_tensors(se)), dict(_tensors(sg))
            assert all(chip_smoke.torch_equal_bits(a, b) for a, b in
                       [(de, dg), (ae, ag)] + [(te[k], tg[k]) for k in te])
        assert (gs.captures, gm.captures) == (1, 1)
    if name == "forest":
        assert "prev_inst_l2w" in te
        assert torch.equal(sg.prev_inst_l2w, nxt.inst_l2w)


def test_posed_scenes_replay_without_recapture(dev):
    """The animated atrium through Renderer.graph_step(cam_moved=True)
    over five poses (each pose_scene's new scene handed to the graph),
    against Renderer.step with the same scenes: the first frame eager,
    one capture, then three replays of posed scenes copied into the
    captured one; display, radiance and every state tensor bit for
    bit."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import _tensors
    from truetrace_tpu_torch.scene.dynamic import pose_scene
    dyn, cam = _animated_small(dev)
    cfg = dict(SLICE, denoiser="svgf")
    re = chip_smoke.make_renderer(dyn.scene, cam, cfg)
    rg = chip_smoke.make_renderer(dyn.scene, cam, cfg)
    gm = rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for k in range(5):
        sc = pose_scene(dyn, chip_smoke.animated_bones(k, dev))
        de, ae, se = re.step(se, cam_moved=True, scene=sc)
        dg, ag, sg = gm(sg, scene=sc)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        assert te.keys() == tg.keys()
        assert all(chip_smoke.torch_equal_bits(a, b) for a, b in
                   [(de, dg), (ae, ag)] + [(te[n], tg[n]) for n in te]), k
    assert gm.captures == 1


def test_pose_scene_makes_no_host_sync_and_matches_cpu(dev):
    """pose_scene on the card under torch.cuda.set_sync_debug_mode(
    "error") (a new scene, the rest scene unchanged), and its tables
    against the same pose on the CPU: the node words, leaf rows and
    triangles bit for bit (the refit's log2 / exp2 and the skinning's
    fmas are exact emulations), the normals and light rows to 1e-6."""
    import chip_smoke
    from truetrace_tpu_torch.scene.dynamic import pose_scene
    dyn, _ = _animated_small(dev)
    dyn_cpu, _ = chip_smoke.animated_scene("cpu", detail=0.2, n_radial=16,
                                           n_height=24)
    bones = chip_smoke.animated_bones(4, dev)
    rest = dyn.scene.cw_nodes.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        posed = pose_scene(dyn, bones)
        posed.cw_table()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert posed is not dyn.scene and torch.equal(dyn.scene.cw_nodes, rest)
    ref = pose_scene(dyn_cpu, bones.cpu())
    assert not torch.equal(ref.cw_nodes, dyn_cpu.scene.cw_nodes)
    for f in ("cw_nodes", "cw_leaf_rows", "tri_p0", "tri_e1", "tri_e2"):
        a, b = getattr(posed, f).cpu(), getattr(ref, f)
        assert chip_smoke.torch_equal_bits(a, b), f
    for a, b in ((posed.tri_n, ref.tri_n),
                 (posed.light_tris.rows, ref.light_tris.rows)):
        assert torch.allclose(a.cpu(), b, rtol=0, atol=1e-6)


def test_skinning_clamps_bone_indices(dev):
    """Bone indices outside [0, B) (the two-bone cylinder's 2 and 3, a
    9 and a -1) are clamped as XLA's gather clamps them, with no device
    assert, and the card's vertices are the CPU's bit for bit."""
    from truetrace_tpu_torch.scene.skinning import (
        bone_matrix, make_two_bone_cylinder, skin_vertices)
    mesh = make_two_bone_cylinder(device=dev)
    idx = mesh.bone_idx.clone()
    idx[::5, 2] = 9
    idx[::7, 3] = -1
    mesh = mesh._replace(bone_idx=idx)
    bones = torch.stack([bone_matrix((0, 0, 1), 0.2, (0, 0, 0), device=dev),
                         bone_matrix((1, 0, 0), 0.9, (0, 1.0, 0),
                                     device=dev)])
    v = skin_vertices(mesh, bones)
    torch.cuda.synchronize()
    cpu = skin_vertices(mesh._replace(**{f: getattr(mesh, f).cpu()
                                         for f in mesh._fields}),
                        bones.cpu())
    assert bool(torch.isfinite(v).all())
    assert torch.equal(v.cpu().view(torch.int32), cpu.view(torch.int32))


# (config) of each frame of the TAAU / partial rendering / neural slice,
# on the small atrium; "interactive" adds 16 analytic lights to it
MODES = {"post": dict(SLICE, denoiser="svgf", post=dict(
             tonemap="aces", bloom_strength=0.08, sharpen=0.3,
             auto_expose=True)),
         "interactive": dict(SLICE, denoiser="svgf", upscale=2,
                             partial_rendering=2),
         "neural": dict(SLICE, denoiser="neural_taa",
                        neural_weights="examples/denoiser.msgpack")}


def _modes_frame(dev, name):
    import dataclasses
    import os

    import chip_smoke
    from truetrace_tpu_torch.scene.ir import AnalyticLights
    sc, cam = _atrium_small(dev)
    cfg = dict(MODES[name])
    if name == "interactive":
        lo = sc.tri_p0.amin(0).cpu().numpy()
        hi = sc.tri_p0.amax(0).cpu().numpy()
        sc = dataclasses.replace(sc, lights=AnalyticLights.from_numpy(
            chip_smoke.analytic_lights_host(lo + 0.2 * (hi - lo),
                                            hi - 0.2 * (hi - lo)), dev))
    if name == "neural":
        cfg["neural_weights"] = os.path.join(chip_smoke.HERE,
                                             cfg["neural_weights"])
    return sc, cam, cfg


@pytest.mark.parametrize("name", ["post", "interactive", "neural"])
def test_modes_frame_makes_no_host_sync(dev, name):
    """The post chain with temporal auto exposure (its histogram is a
    fixed-size scatter-add, no bincount), TAAU with partial rendering
    and analytic lights (the subset, the jitter and the warm-up gate
    from the sample id) and the neural_taa frame (the U-Net's cuDNN
    convolutions): after a warm-up frame, one more and one moving the
    camera with cam_moved=True, under set_sync_debug_mode("error")."""
    import chip_smoke
    sc, cam, cfg = _modes_frame(dev, name)
    r = chip_smoke.make_renderer(sc, cam, cfg)
    st = r.init_state()
    _, _, st = r.step(st)
    moved = chip_smoke.moved_camera(cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, st = r.step(st)
        disp, _, st = r.step(st, cam=moved, cam_moved=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.sample == 3 and bool(torch.isfinite(disp).all())
    assert disp.shape == (SLICE["height"], SLICE["width"], 3)


@pytest.mark.parametrize("name", ["post", "interactive", "neural"])
def test_modes_graph_frames_match_eager(dev, name):
    """Renderer.graph_step against Renderer.step on the post,
    interactive and neural frames, four frames (a camera move among
    them): display, radiance and every state tensor (the exposure, the
    TAAU history, partial rendering's buffers, the neural_taa history)
    bit for bit."""
    import chip_smoke
    from truetrace_tpu_torch.renderer import _tensors
    sc, cam, cfg = _modes_frame(dev, name)
    moved = chip_smoke.moved_camera(cam)
    re = chip_smoke.make_renderer(sc, cam, cfg)
    rg = chip_smoke.make_renderer(sc, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for c, moved_now, frame in ((None, None, gs), (None, None, gs),
                                (moved, True, gm), (moved, False, gs)):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        assert te.keys() == tg.keys()
        assert all(chip_smoke.torch_equal_bits(a, b) for a, b in
                   [(de, dg), (ae, ag)] + [(te[k], tg[k]) for k in te])
    assert (gs.captures, gm.captures) == (1, 1)
    want = {"post": "exposure", "interactive": "partial.rad",
            "neural": "neural_hist"}[name]
    assert want in te


# ---------------------------------------------------------------------------
# the two-level traversal and the heightmap march
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tlas_scenes(dev):
    """The instanced scene of tests/test_torch_tlas.py's kind (a deep
    sphere, a grid and a box under 40 instances with rotations and
    non-uniform scales) at every compiled leaf width, and rays from
    inside and outside it with dead lanes: ({K: scene}, ro, rd, t_max)."""
    from truetrace_tpu_torch.scene.instances import compile_scene_instanced
    from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
    from truetrace_tpu_torch.scene.primitives import grid, uv_sphere
    r = np.random.default_rng(0)
    sv, si, _ = uv_sphere(16, 24, radius=0.5)
    gv, gi, _ = grid(3, 3, 2.0, 2.0)
    bv = np.array([[x, y, z] for x in (-.3, .3) for y in (0, .9)
                   for z in (-.3, .3)], np.float32)
    bf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                   [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int32)
    srcs = [HostMesh(v.astype(np.float32), i.astype(np.int32),
                     np.full(len(i), m, np.int32))
            for m, (v, i) in enumerate(((sv, si), (gv, gi), (bv, bf)))]
    inst = []
    for k in range(40):
        th, ph = r.uniform(0, 2 * np.pi), r.uniform(-0.5, 0.5)
        ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                       [-np.sin(th), 0, np.cos(th)]])
        rx = np.array([[1, 0, 0], [0, np.cos(ph), -np.sin(ph)],
                       [0, np.sin(ph), np.cos(ph)]])
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.diag(r.uniform(0.5, 1.8, 3)) @ rx @ ry
        m[3, :3] = r.uniform(-4, 4, 3)
        inst.append((k % 3, m))
    mats = [HostMaterial(), HostMaterial(), HostMaterial()]
    out = {k: compile_scene_instanced(srcs, mats, inst, leaf_k=k,
                                      device=dev)[0]
           for k in (3, 4, 5, 6, 8, 12)}
    R = 20000
    ro = torch.from_numpy(r.uniform(-6, 6, (R, 3)).astype(np.float32)).to(dev)
    rd = torch.from_numpy(_unit(r, R)).to(dev)
    tm = torch.from_numpy(r.uniform(0.5, 12, R).astype(np.float32)).to(dev)
    tm[:100] = 0.0
    tm[100:10000] = 1e30
    return out, ro, rd, tm


@pytest.mark.parametrize("k", [3, 4, 5, 6, 8, 12])
@pytest.mark.parametrize("query", ["closest", "any", "transmit"])
@pytest.mark.parametrize("stack", [16, 2])
def test_tlas_kernel_bitwise(tlas_scenes, k, query, stack):
    """closest_hit_tlas (t, tri, u, v, inst), any_hit_tlas and
    transmit_tlas (random tints) bit for bit their plain versions for
    every compiled leaf width, with the 16-entry ring and a 2-entry one
    whose pushes drop entries, TLAS ones among them (some rays then lose
    instances, the same ones); dead lanes miss."""
    import chip_smoke
    from truetrace_tpu_torch.kernels import cwbvh_tlas as tl
    out, ro, rd, tm = tlas_scenes
    sc = out[k]
    a = (sc.cw_table(), sc.cw_nodes.shape[0], sc.cw_leaf_rows.shape[0])
    if query == "closest":
        hk, ik = tl.closest_hit_tlas(*a, ro, rd, tm, stack)
        hp, ip = tl.closest_hit_tlas_plain(*a, ro, rd, tm, stack)
        for f in ("t", "tri", "u", "v"):
            assert chip_smoke.torch_equal_bits(getattr(hk, f),
                                               getattr(hp, f)), f
        assert torch.equal(ik, ip.to(ik.dtype))
        assert bool((hk.tri[:100] == -1).all() and (ik[:100] == -1).all())
        if stack == 2:
            full, _ = tl.closest_hit_tlas_plain(*a, ro, rd, tm, 16)
            assert bool((hk.tri != full.tri).any())
    elif query == "any":
        ok = tl.any_hit_tlas(*a, ro, rd, tm, stack)
        assert torch.equal(ok, tl.any_hit_tlas_plain(*a, ro, rd, tm, stack))
        assert 0.05 < float(ok.float().mean()) < 0.95
    else:
        g = torch.Generator(device="cpu").manual_seed(k)
        tint = torch.rand((sc.n_tris(), 3), generator=g).to(ro.device)
        tk = tl.transmit_tlas(*a, tint, ro, rd, tm, stack)
        tp = tl.transmit_tlas_plain(*a, tint, ro, rd, tm, stack)
        assert chip_smoke.torch_equal_bits(tk, tp)
        assert bool((tk[:100] == 1).all())


@pytest.mark.parametrize("R", [1, 33, 262145])
def test_heightmap_kernel_bitwise(dev, R):
    """heightmap_closest (t, valid, normal, uv) and heightmap_any bit for
    bit the plain march: rays from above and below the surface, outside
    its box, dead lanes; ray counts that leave blocks part empty."""
    import chip_smoke
    from truetrace_tpu_torch.kernels import heightmap as hm
    from truetrace_tpu_torch.scene.terrain import demo_hills, make_terrain
    ter = make_terrain(demo_hills(129, seed=4), origin=(-8, 0, -8),
                       size_xz=(16, 16), mat_ids=[0, 1], height_scale=2.2,
                       device=dev)
    r = np.random.default_rng(R)
    ro = np.stack([r.uniform(-10, 10, R), r.uniform(-0.5, 5, R),
                   r.uniform(-10, 10, R)], -1).astype(np.float32)
    d = r.normal(size=(R, 3))
    d[:, 1] -= 0.4
    rd = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tm = r.uniform(0, 30, R).astype(np.float32)
    tm[: R // 10] = 0.0
    ro, rd, tm = (torch.from_numpy(x).to(dev) for x in (ro, rd, tm))
    hk = hm.heightmap_closest(ter, ro, rd, tm)
    hp = hm.heightmap_closest_plain(ter, ro, rd, tm)
    assert torch.equal(hk.valid, hp.valid)
    for f in ("t", "normal", "uv"):
        assert chip_smoke.torch_equal_bits(getattr(hk, f), getattr(hp, f)), f
    assert torch.equal(hm.heightmap_any(ter, ro, rd, tm),
                       hm.heightmap_any_plain(ter, ro, rd, tm))
    if R > 1000:
        assert 0.1 < float(hk.valid.float().mean()) < 0.9
