#!/usr/bin/env python3
"""Drive the torch port (`truetrace_tpu_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. the card's name and power limit; build every CUDA kernel of the port
   from `truetrace_tpu_torch/kernels/csrc/` (one nvcc per source, each
   with its own flags);
2. every kernel against its plain PyTorch version on the same inputs, at
   the main path's shapes: the a-trous pass at 512x512 for steps 1-16
   and the packed five-pass route against five plain passes, timed per
   step on the device alone (no host launch gaps); the traversal step
   core at R = 65536 and at the frame's 262144 lanes (K = 3 rows of the
   atrium, write_uv both ways), timed on the device alone too; and
   closest / any hit on the 293k-triangle atrium at K = 6 and K = 3 with
   bench.py's ray mix (primary, cosine-bounce and shadow rays) at the
   frame's 262144 rays per class, and Mrays/s at that count and at
   bench.py's 131072. The plain traversal counts each ray's node decodes,
   leaf rows and triangle tests; from those counts (traversal) or the
   shapes (a-trous, step core) every kernel gets its bound: the larger of
   its f32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s;
3. the main path: `Renderer.step` on the atrium, 512x512, 4 bounces,
   Disney BSDF, light-tree NEE and SVGF; 1 warm-up and 4 timed frames,
   with every kernel's launch count read around exactly that run; two
   frames under torch.cuda.set_sync_debug_mode("error") (the second
   moving the camera with cam_moved=True), which raises at any blocking
   host copy or sync; one more frame under torch.profiler (device time
   by kernel, the traversal's and the a-trous kernel's, the device's
   busy share of the frame, and the frame's host copies and syncs, which
   must be none); the a-trous kernel against the plain pass again, on
   the inputs svgf_denoise hands its first pass in one more frame; then
   the frame as CUDA graphs (Renderer.graph_step): replayed frames bit
   for bit the eager ones over a camera move, eager and replayed frames
   timed in turns, replays under the sync debug mode and the profiler;
4. the sponza_like path (bench.py's headline scene): export it at detail
   5 (269,260 triangles) into a temporary directory, load the OBJ, MTL and
   PNG files with the port's loader (no Pillow), build it at K = 6 with the
   texture atlas and the textured sky; bench.py's ray mix at its 131072
   rays per class, every ray held bitwise against the plain traversal and
   timed; `Renderer.step` at 512x512x4 with SVGF as in phase 3 (counts
   set to 0 just before, read just after; the sync-free frames, the
   profile and the CUDA graphs as there), and the a-trous
   kernel on its own inputs (sky rows at zero normal); the golden
   ladder's unbiasedness check (NEE + MIS against BSDF-only: at 3
   bounces between BSDF-only at 3 and 4, at 6 converged means within
   rtol 0.06 / atol 5e-3); one sample at 32x24 on the card against the
   CPU;
5. correctness of the output: a Cornell box rendered on the card agrees
   with the same render on the CPU, and passes the physics checks of
   scripts/verify_drive.py at 256x256.

It prints the card line, one JSON line of kernel results (time, plain
time, bound and what sets it, launches per frame, ptxas registers,
spills and shared memory, for the traversal the work per ray, for
a-trous the time at each step and of packing; under "sponza" each
kernel's launches, time and bound on the sponza_like path; under
"frames" each scene's eager and replayed frame times, device busy,
kernel counts and host copies), and as its last line
{"ok": true, "device": {...}}. It exits non-zero, with
no result line, when there is no CUDA card or the port's package is
missing.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "truetrace_tpu_torch"
DEVICE = "cuda"
ATRIUM_DETAIL = 1.5

# bench.py's ray mix: 1 << 17 rays in each of its three classes
BENCH_RAYS = 1 << 17
FRAME = dict(width=512, height=512, bounces=4, bsdf="disney",
             traversal="wavefront", light_sampling="tree", denoiser="svgf")
# a-trous kernel vs plain: the card's exp2 and seven squarings round
# differently from torch's exp and pow in the last ulps, which the
# normalised sums carry
ATROUS_RTOL, ATROUS_ATOL = 1e-4, 1e-5
FRAMES = 5              # each frame phase: 1 warm-up + 4 timed frames
SPONZA_DETAIL = 5.0     # bench.py's BENCH_DETAIL: 269,260 triangles
SPONZA_TRIS = 269260
# the golden ladder's soft wide sun (tests/test_golden.py), under which
# the BSDF-only estimator converges at BSDF_SPP; its tolerance
GOLDEN_SKY = dict(sun_dir=(0.3, 0.85, 0.44), sun_intensity=25.0,
                  sun_angle_deg=18.0)
NEE_SPP, BSDF_SPP = 1024, 16384
NEE_RTOL, NEE_ATOL = 0.06, 5e-3
# the bracket check at 3 bounces allows each end this many standard
# errors of the difference of the two means (Monte Carlo noise only)
NEE_SIGMAS = 4.0

# Bounds: the least time the card could take for a kernel's work, the
# larger of its f32 operations over the H100 SXM's 67 TFLOP/s outside the
# tensor cores (an FMA counts 2, a min, max, compare or reciprocal 1) and
# its bytes (each input read once, each output written once) over
# 3.35 TB/s. Operation counts, read from the CUDA sources:
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
OPS_NODE = 216   # cwbvh_core decode_row: 8 slots x (3 axes x 8 + 3)
OPS_TRI = 53     # cwbvh_core tri_test: 6 msub/dot3 (27), 3 scalings,
                 # 3 subs, rcp + floor, 8 compares and sums
OPS_ATROUS_PX = 740   # the plain pass per pixel: 24 weighted taps x 29,
                      # centre tap, prefilter, sigmas, normalisation
ATROUS_STEPS = (1, 2, 4, 8, 16)   # svgf_denoise's five passes
# step_core's lanes: the Pallas contract's R, and the frame's 512 x 512
STEP_CORE_LANES = (65536, 262144)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the current stream (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def bound(ops: float, nbytes: float) -> dict:
    """bound_ms and bound_by of `ops` f32 operations moving `nbytes`."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def device_ms(fn, reps: int = 50) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls,
    free of the host's launch gaps: a device sleep holds the stream while
    the host queues every call, and the events bracket only the calls.
    The sleep grows until it outlasts the host's queueing."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24
    while True:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        ev[2].record()
        torch.cuda.synchronize()
        if host_ms < ev[0].elapsed_time(ev[1]):
            return ev[1].elapsed_time(ev[2]) / reps
        check(cycles < 1 << 32, f"device_ms: queueing {reps} calls took "
              f"{host_ms:.1f} ms")
        cycles *= 4


def atrous_inputs(H: int, W: int, seed: int = 7):
    """Random colour, variance, unit normals and depths on the card."""
    import torch
    r = np.random.default_rng(seed)
    n = r.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (
        r.uniform(0, 3, (H, W, 3)).astype(np.float32),
        r.uniform(0, 0.5, (H, W)).astype(np.float32), n,
        r.uniform(0.5, 10, (H, W)).astype(np.float32)))


def atrous_close(a, b, what: str) -> float:
    """Holds a against b to ATROUS_RTOL / ATROUS_ATOL; max |a - b|."""
    d = (a - b).abs()
    e = float(d.max())
    check(bool((d <= ATROUS_ATOL + ATROUS_RTOL * b.abs()).all()),
          f"{what}: max |diff| {e}")
    return e


def hold_atrous(label: str, color, var, normal, depth) -> float:
    """The kernel against the plain pass at every step, and the packed
    five-pass route (atrous_filter) against five plain passes, on the
    same inputs; logs the share of pixels each pass moves by more than
    1e-3 from their own colour (a pass that moves none checks no edge
    weight). Returns the largest |diff|."""
    import torch
    from truetrace_tpu_torch.kernels.atrous_pallas import (
        atrous_filter, atrous_pass, atrous_pass_plain)
    H, W = depth.shape
    err, moved = 0.0, []
    for step in ATROUS_STEPS:
        c1, v1 = atrous_pass(color, var, normal, depth, step)
        c2, v2 = atrous_pass_plain(color, var, normal, depth, step)
        torch.cuda.synchronize()
        err = max(err, atrous_close(c1, c2, f"{label} step {step} colour"),
                  atrous_close(v1, v2, f"{label} step {step} variance"))
        moved.append(float(((c2 - color).abs().amax(-1) > 1e-3).float()
                           .mean()))
    pc, pv = color, var
    for i, step in enumerate(ATROUS_STEPS):
        pc, pv = atrous_pass_plain(pc, pv, normal, depth, step)
        ph = pc if i == 0 else ph
    fh, fc, fv = atrous_filter(color, var, normal, depth, len(ATROUS_STEPS))
    for a, b, what in ((fh, ph, "first colour"), (fc, pc, "colour"),
                       (fv, pv, "variance")):
        err = max(err, atrous_close(a, b, f"{label} five passes, {what}"))
    log(f"atrous {label} {H}x{W}: kernel within rtol {ATROUS_RTOL} / atol "
        f"{ATROUS_ATOL} of plain at steps {ATROUS_STEPS} and over the "
        f"five-pass route, max |diff| {err:.3g}; pixels moved > 1e-3 by "
        f"each pass: {[round(m, 4) for m in moved]}")
    return err


def phase_atrous(results):
    """The a-trous kernel on random inputs of the frame's size: held
    against the plain pass, then timed per step (device time, no host
    gaps), with the frame's packing and its whole five-pass route."""
    from truetrace_tpu_torch.kernels.atrous_pallas import (
        atrous_filter, atrous_pass_packed, atrous_pass_plain, pack)
    H, W = FRAME["height"], FRAME["width"]
    color, var, normal, depth = atrous_inputs(H, W)
    err = hold_atrous("random", color, var, normal, depth)
    cv, nz = pack(color, var), pack(normal, depth)
    ms, plain_ms = {}, {}
    for step in ATROUS_STEPS:
        ms[step] = device_ms(lambda: atrous_pass_packed(cv, nz, step))
        plain_ms[step] = cuda_ms(lambda: atrous_pass_plain(
            color, var, normal, depth, step), 3)
        log(f"atrous {H}x{W} step {step}: kernel {ms[step]:.5f} ms, plain "
            f"{plain_ms[step]:.4f} ms")
    pack_ms = device_ms(lambda: (pack(normal, depth), pack(color, var)))
    filter_ms = device_ms(lambda: atrous_filter(color, var, normal, depth,
                                                len(ATROUS_STEPS)))
    log(f"atrous {H}x{W}: packing a frame's planes {pack_ms:.5f} ms; the "
        f"five-pass route (packing, 5 passes, unpacked views) "
        f"{filter_ms:.5f} ms")
    # in: colour, variance, normal, depth; out: colour, variance
    results["atrous_pass"] = dict(
        max_abs_err=err, ms=sum(ms.values()) / len(ms),
        plain_ms=sum(plain_ms.values()) / len(plain_ms),
        ms_by_step={str(k): v for k, v in ms.items()},
        plain_ms_by_step={str(k): v for k, v in plain_ms.items()},
        pack_ms=pack_ms, filter_ms=filter_ms,
        **bound(OPS_ATROUS_PX * H * W, (8 + 4) * 4 * H * W))


def phase_atrous_frame(results, r, state, label: str):
    """The kernel against the plain pass on a frame's own a-trous inputs:
    the colour, variance, normal and depth that svgf_denoise hands its
    first pass in one more frame (sky pixels with zero normal and depth,
    zero-variance pixels included). Returns the packed planes."""
    import torch
    from truetrace_tpu_torch.kernels import atrous_pallas
    seen = []
    orig = atrous_pallas.atrous_filter

    def grab(*args):
        seen.append(args)
        return orig(*args)

    atrous_pallas.atrous_filter = grab
    try:
        r.step(state)
    finally:
        atrous_pallas.atrous_filter = orig
    color, var, normal, depth, _ = seen[0]
    for name, x in (("colour", color), ("variance", var),
                    ("normal", normal), ("depth", depth)):
        check(bool(torch.isfinite(x).all()), f"frame a-trous {name} not "
              f"finite")
    sky = float((depth == 0).float().mean())
    zero_n = float((normal == 0).all(-1).float().mean())
    flat = float((var == 0).float().mean())
    log(f"{label} frame a-trous inputs: {sky:.4f} of pixels sky (depth 0), "
        f"{zero_n:.4f} at zero normal, {flat:.4f} zero variance, depth up to "
        f"{float(depth.max()):.1f}")
    err = hold_atrous(f"{label} frame", color, var, normal, depth)
    res = results["atrous_pass"]
    res[f"{label}_frame_max_abs_err"] = err
    res[f"{label}_frame_zero_normal_share"] = zero_n
    res["max_abs_err"] = max(res["max_abs_err"], err)
    return color, var, normal, depth


def bench_rays(scene, cam, R):
    """bench.py's mix: primary camera rays, cosine bounce rays from the
    primary hits (t_max 1e30) and shadow rays along them (t_max 25)."""
    import torch
    from truetrace_tpu_torch.core import rng
    from truetrace_tpu_torch.core.math import (
        sample_cosine_hemisphere, to_world)
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        closest_hit_wavefront)
    from truetrace_tpu_torch.scene.ir import camera_rays
    dev = scene.device
    pix = torch.arange(R, device=dev)
    jit2 = rng.uniform2(pix, 0, 0)
    ro_p, rd_p = camera_rays(cam, 1 << 10, R >> 10, pix, jit2)
    ro_p, rd_p = ro_p.contiguous(), rd_p.contiguous()
    h = closest_hit_wavefront(scene.cw_table(), scene.cw_nodes.shape[0],
                              ro_p, rd_p, 1e30, scene.cw_stack)
    p_hit = ro_p + rd_p * h.t[:, None]
    u2 = rng.uniform2(pix, 1, 3)
    gn = torch.zeros((R, 3), device=dev)
    gn[:, 1] = 1.0
    rd_b = to_world(gn, sample_cosine_hemisphere(u2)).contiguous()
    ro_b = (p_hit + gn * 1e-3).contiguous()
    tm_b = torch.full((R,), 25.0, device=dev)
    return ro_p, rd_p, ro_b, rd_b, tm_b


def max_abs_diff(a, b) -> float:
    """Largest |a - b| over elements (equal elements, infinities included,
    count 0)."""
    import torch
    d = (a.double() - b.double()).abs()
    d = torch.where(a == b, torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def torch_equal_bits(a, b) -> bool:
    """Bitwise equality of two tensors of the same 4-byte dtype."""
    import torch
    b = b.to(a.dtype)
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def traversal_work(counts: dict, R: int, W: int) -> dict:
    """Per-ray work of one ray class (the plain traversal's counts) and
    the bound it sets: decodes and triangle tests at OPS_NODE / OPS_TRI,
    the table rows it touches (10K words each) and 44 bytes per ray
    (origin, direction, t_max in; t, tri, u, v out)."""
    nd, lr, tt = (float(counts[f].sum()) for f in (
        "node_decodes", "leaf_rows", "tri_tests"))
    return dict(node_decodes_per_ray=nd / R, leaf_rows_per_ray=lr / R,
                tri_tests_per_ray=tt / R, rows_touched=counts["rows_touched"],
                **bound(OPS_NODE * nd + OPS_TRI * tt,
                        4 * W * counts["rows_touched"] + 44 * R))


def hold_closest(table, C, S, ro, rd, label: str):
    """Closest hit: kernel against the plain traversal, bitwise in t, tri,
    u and v; the plain run counts each ray's work. Returns (work, max
    |t diff|, share of rays that hit)."""
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        closest_hit_plain, closest_hit_wavefront)
    R = ro.shape[0]
    hk = closest_hit_wavefront(table, C, ro, rd, 1e30, S)
    counts = {}
    hp = closest_hit_plain(table, C, ro, rd, 1e30, S, counts)
    for f in ("t", "tri", "u", "v"):
        a, b = getattr(hk, f), getattr(hp, f)
        check(torch_equal_bits(a, b), f"closest hit {label}: {f} differs on "
              f"{int((a != b.to(a.dtype)).sum())} of {R} rays")
    hit_share = float((hk.tri >= 0).float().mean())
    work = traversal_work(counts, R, table.shape[1])
    log(f"closest hit {label}: bitwise equal to plain (t, tri, u, v) on {R} "
        f"rays; {hit_share:.3f} hit; {work_line(work)}")
    return work, max_abs_diff(hk.t, hp.t), hit_share


def hold_any(table, C, S, ro, rd, tm, label: str):
    """Any hit: kernel occlusion equal to the plain traversal's. Returns
    (work, max |diff|, share blocked)."""
    import torch
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_plain, any_hit_wavefront)
    R = ro.shape[0]
    ok = any_hit_wavefront(table, C, ro, rd, tm, S)
    counts = {}
    op = any_hit_plain(table, C, ro, rd, tm, S, counts)
    check(torch.equal(ok, op), f"any hit {label}: occlusion differs on "
          f"{int((ok != op).sum())} of {R} rays")
    blocked = float(ok.float().mean())
    work = traversal_work(counts, R, table.shape[1])
    log(f"any hit {label}: occlusion equal to plain on {R} rays; "
        f"{blocked:.3f} blocked; {work_line(work)}")
    return work, max_abs_diff(ok.float(), op.float()), blocked


def time_mix(table, C, S, rays, n: int, label: str):
    """Kernel ms per launch of each bench-mix class at n rays per class
    (CUDA events over 20 launches) and the mix's Mrays/s."""
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_wavefront, closest_hit_wavefront)
    ro_p, rd_p, ro_b, rd_b, tm_b = rays
    t_cp = cuda_ms(lambda: closest_hit_wavefront(
        table, C, ro_p[:n], rd_p[:n], 1e30, S), 20)
    t_cb = cuda_ms(lambda: closest_hit_wavefront(
        table, C, ro_b[:n], rd_b[:n], 1e30, S), 20)
    t_an = cuda_ms(lambda: any_hit_wavefront(
        table, C, ro_b[:n], rd_b[:n], tm_b[:n], S), 20)
    mrays = 3 * n / ((t_cp + t_cb + t_an) * 1e-3) / 1e6
    log(f"traversal {label} (bench mix, {n} rays per class): closest "
        f"primary {t_cp:.4f} ms, closest bounce {t_cb:.4f} ms, any hit "
        f"{t_an:.4f} ms -> {mrays:.2f} Mrays/s")
    return dict(primary=t_cp, bounce=t_cb, shadow=t_an, mrays=mrays)


def phase_traversal(results, scenes, cam):
    """Kernel against plain on the bench mix at the frame's lane count
    (512 x 512 rays per class, the shape Renderer.step hands the
    traversal); the plain run counts each ray's work, from which each
    class's bound follows; kernel times at that count and at bench.py's
    131072."""
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_plain, closest_hit_plain)
    R = FRAME["width"] * FRAME["height"]
    for k, scene in scenes.items():
        table, C, S = scene.cw_table(), scene.cw_nodes.shape[0], \
            scene.cw_stack
        rays = bench_rays(scene, cam, R)
        ro_p, rd_p, ro_b, rd_b, tm_b = rays
        plain, err, work = {}, {}, {}
        for name, ro, rd in (("primary", ro_p, rd_p),
                             ("bounce", ro_b, rd_b)):
            work[name], e, hit_share = hold_closest(
                table, C, S, ro, rd, f"K={k} {name}")
            err["closest"] = max(err.get("closest", 0.0), e)
            check(hit_share > 0.5, f"closest hit K={k} {name}: only "
                  f"{hit_share:.3f} of rays hit")
            plain[name] = cuda_ms(lambda: closest_hit_plain(
                table, C, ro, rd, 1e30, S), 1)
        work["shadow"], err["any"], _ = hold_any(table, C, S, ro_b, rd_b,
                                                 tm_b, f"K={k} shadow")
        plain["any"] = cuda_ms(lambda: any_hit_plain(
            table, C, ro_b, rd_b, tm_b, S), 1)

        for n in (BENCH_RAYS, R):
            t = time_mix(table, C, S, rays, n, f"K={k}")
            results[f"traversal_k{k}_{n}"] = dict(mrays=t["mrays"])
        for name in ("primary", "bounce", "shadow"):
            w = work[name]
            log(f"traversal K={k} {name} at {R} rays: bound "
                f"{w['bound_ms']:.4f} ms ({w['bound_by']}), kernel "
                f"{t[name]:.4f} ms = {w['bound_ms'] / t[name]:.3f} of the "
                f"bound")
        log(f"traversal K={k} plain at {R} rays: closest primary "
            f"{plain['primary']:.1f} ms, closest bounce "
            f"{plain['bounce']:.1f} ms, any hit {plain['any']:.1f} ms")
        if k == 6:
            pb = [work["primary"], work["bounce"]]
            results["closest_hit_wavefront"] = dict(
                max_abs_err=err["closest"],
                ms=(t["primary"] + t["bounce"]) / 2,
                plain_ms=(plain["primary"] + plain["bounce"]) / 2,
                bound_ms=(pb[0]["bound_ms"] + pb[1]["bound_ms"]) / 2,
                bound_by=max(pb, key=lambda b: b["bound_ms"])["bound_by"],
                work={n: work[n] for n in ("primary", "bounce")})
            results["any_hit_wavefront"] = dict(
                max_abs_err=err["any"], ms=t["shadow"], plain_ms=plain["any"],
                bound_ms=work["shadow"]["bound_ms"],
                bound_by=work["shadow"]["bound_by"],
                work={"shadow": work["shadow"]})


def work_line(w: dict) -> str:
    return (f"per ray {w['node_decodes_per_ray']:.2f} node decodes, "
            f"{w['leaf_rows_per_ray']:.2f} leaf rows, "
            f"{w['tri_tests_per_ray']:.2f} triangle tests; "
            f"{w['rows_touched']} table rows touched")


def step_core_inputs(scene3, cam, R: int):
    """step_core's rowt [32,R], ray9 [9,R] and st5 [5,R] on rows of the
    K = 3 atrium table: leaf lanes get the leaf row holding the triangle
    a traversal found for the same ray (so Moller tests hit), node lanes a
    random node row; bench.py's bounce rays."""
    import torch
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        closest_hit_wavefront)
    dev = scene3.device
    table, C = scene3.cw_table(), scene3.cw_nodes.shape[0]
    L = table.shape[0] - C
    _, _, ro, rd, _ = bench_rays(scene3, cam, R)
    hit = closest_hit_wavefront(table, C, ro, rd, 1e30, scene3.cw_stack)
    ids = table[C:, 27:30].to(torch.int64)               # [L,3] tri ids
    tri2row = torch.full((scene3.n_tris(),), 0, dtype=torch.int64,
                         device=dev)
    rows_l = torch.arange(L, device=dev)[:, None].expand(L, 3)
    valid = ids >= 0
    tri2row[ids[valid]] = rows_l[valid]
    g = torch.Generator(device="cpu").manual_seed(11)
    leaf_lane = (torch.rand(R, generator=g) < 0.5).to(dev) & (hit.tri >= 0)
    node_row = torch.randint(0, C, (R,), generator=g).to(dev)
    row_idx = torch.where(leaf_lane, C + tri2row[
        torch.clamp(hit.tri.to(torch.int64), min=0)], node_row)
    rowt = torch.nn.functional.pad(table[row_idx], (0, 2)).t().contiguous()
    inv = 1.0 / torch.where(rd.abs() < 1e-12,
                            torch.where(rd >= 0, 1e-12, -1e-12), rd)
    ray9 = torch.cat([ro.t(), rd.t(), inv.t()]).contiguous()
    t0 = torch.full((R,), 1e30, device=dev)
    st5 = torch.stack([t0.view(torch.int32),
                       torch.full((R,), -1, dtype=torch.int32, device=dev),
                       torch.zeros((R,), dtype=torch.int32, device=dev),
                       torch.zeros((R,), dtype=torch.int32, device=dev),
                       leaf_lane.to(torch.int32)]).contiguous()
    return rowt, ray9, st5


def step_core_bound(R: int) -> dict:
    """step_core's bound at R lanes: rows [32,R], rays [9,R] and state
    [5,R] in, [7,R] out; three triangle tests and one node decode a
    lane."""
    return bound((3 * OPS_TRI + OPS_NODE) * R, (32 + 9 + 5 + 7) * 4 * R)


def hold_step_core(fn, rowt, ray9, st5, what: str) -> float:
    """fn (a step_core launch) bitwise against step_core_plain with
    write_uv true and false; checks that Moller tests hit. Returns the
    largest |diff| (0 when bitwise)."""
    import torch
    from truetrace_tpu_torch.kernels.step_pallas import step_core_plain
    R = rowt.shape[1]
    err = 0.0
    for write_uv in (True, False):
        out_k = fn(rowt, ray9, st5, write_uv)
        out_p = step_core_plain(rowt, ray9, st5, write_uv)
        check(torch.equal(out_k, out_p),
              f"{what} R={R} write_uv={write_uv}: "
              f"{int((out_k != out_p).any(0).sum())} of {R} lanes differ")
        # t, u, v rows as float32; tri and the hits group as integers
        f_rows = [0, 2, 3]
        err = max(err, max_abs_diff(out_k[f_rows].view(torch.float32),
                                    out_p[f_rows].view(torch.float32)),
                  max_abs_diff(out_k, out_p))
    n_hit = int((out_p[1] >= 0).sum())
    check(n_hit > R // 8, f"{what} R={R}: only {n_hit} Moller hits")
    return err


def phase_step_core(results, scene3, cam):
    """step_core at the Pallas contract's R = 65536 and at the frame's
    262144 lanes (STEP_CORE_LANES): bitwise against the plain version
    with write_uv both ways, then timed on the device alone (device_ms:
    no host launch gaps) beside the plain version and the bound."""
    from truetrace_tpu_torch.kernels.step_pallas import (
        step_core, step_core_plain)
    by_lanes, err = {}, 0.0
    for R in STEP_CORE_LANES:
        rowt, ray9, st5 = step_core_inputs(scene3, cam, R)
        err = max(err, hold_step_core(step_core, rowt, ray9, st5,
                                      "step_core"))
        k = device_ms(lambda: step_core(rowt, ray9, st5))
        p = cuda_ms(lambda: step_core_plain(rowt, ray9, st5), 3)
        b = step_core_bound(R)
        by_lanes[str(R)] = dict(ms=k, plain_ms=p, **b,
                                share_of_bound=b["bound_ms"] / k)
        log(f"step_core R={R}: bitwise equal to plain (write_uv both "
            f"ways); kernel {k:.5f} ms = {b['bound_ms'] / k:.3f} of the "
            f"{b['bound_ms']:.5f} ms bound ({b['bound_by']}), plain "
            f"{p:.3f} ms")
    del rowt, ray9, st5
    results["step_core"] = dict(max_abs_err=err,
                                **by_lanes[str(STEP_CORE_LANES[0])],
                                by_lanes=by_lanes)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def launch_counters():
    from truetrace_tpu_torch.kernels import atrous_pallas, cwbvh_wavefront
    from truetrace_tpu_torch.kernels import step_pallas
    return {"closest_hit_wavefront": cwbvh_wavefront.closest_hit_wavefront,
            "any_hit_wavefront": cwbvh_wavefront.any_hit_wavefront,
            "step_core": step_pallas.step_core,
            "atrous_pass": atrous_pallas.atrous_pass_packed}


def phase_frame(results, scene, cam, label: str):
    """`Renderer.step` at FRAME: 1 warm-up and FRAMES - 1 timed frames,
    with every kernel's launch count set to 0 just before and read just
    after; the display must be finite and in [0, 1]. Results go under
    `results[label]`."""
    import torch
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    r = Renderer(scene, cam, RendererConfig(**FRAME))
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state = r.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    display, accum, state = r.step(state)              # warm-up frame
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times = []
    for _ in range(FRAMES - 1):
        t0 = time.perf_counter()
        display, accum, state = r.step(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    H, W = FRAME["height"], FRAME["width"]
    check(tuple(display.shape) == (H, W, 3), f"display {display.shape}")
    check(bool(torch.isfinite(display).all()), "display not finite")
    check(float(display.min()) >= 0.0 and float(display.max()) <= 1.0,
          "display outside [0, 1]")
    check(bool(torch.isfinite(accum).all()), "radiance not finite")
    mean = float(accum.mean())
    check(mean > 1e-3, f"radiance mean {mean}")
    ms = 1e3 * sum(times) / len(times)
    med = 1e3 * sorted(times)[len(times) // 2]
    log(f"frame {label} {H}x{W}x{FRAME['bounces']} svgf: warm-up "
        f"{warm * 1e3:.1f} ms, frames {[round(t * 1e3, 1) for t in times]}"
        f" ms -> mean {ms:.1f} ms/frame, median {med:.1f}; radiance mean "
        f"{mean:.4f}")
    log(f"launches over the {label} path's {FRAMES} frames: {launches}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the {label} "
              f"path")
    results[label] = dict(ms=ms, median_ms=med, warmup_ms=warm * 1e3,
                          mean=mean)
    return launches, r, state


def phase_profile(r, state, frame=None, label: str = "frame"):
    """One more frame under torch.profiler (`r.step(state)`, or `frame()`
    where given): device time by kernel, the number of kernels, the
    device's busy share of the frame's wall time (one stream, so kernel
    times do not overlap), and the frame's host copies and syncs: its
    `Memcpy HtoD` / `DtoH` device events and its cudaStreamSynchronize
    and blocking cudaMemcpy runtime calls (the final
    cudaDeviceSynchronize that ends the window is the profiler's, not the
    frame's); beside them its copies on the device (`Memcpy DtoD`, no
    sync: a replay's camera and state hand-over). The profiler's own
    overhead inflates the wall time; the busy time is the kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    frame = frame or (lambda: r.step(state))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    of = lambda name: sum(dev_us(e) for e in kernels if name in e.key) / 1e3
    trav, atr = of("traverse_kernel"), of("atrous_")
    count = lambda pred: sum(e.count for e in events if pred(e.key))
    copies = dict(
        memcpy_htod=count(lambda k: "Memcpy HtoD" in k),
        memcpy_dtoh=count(lambda k: "Memcpy DtoH" in k),
        stream_syncs=count(lambda k: k.startswith("cudaStreamSynchronize")),
        blocking_memcpy_calls=count(lambda k: k in ("cudaMemcpy",
                                                    "cudaMemcpy2D")),
        memcpy_dtod=count(lambda k: "Memcpy DtoD" in k))
    log(f"profiled {label}: wall {wall * 1e3:.1f} ms, {n} kernels, device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall), "
        f"traversal {trav:.3f} ms ({100 * trav / busy:.1f}% of busy), "
        f"a-trous {atr:.3f} ms ({100 * atr / busy:.2f}% of busy); host "
        f"copies and syncs: {copies}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:100]}")
    return dict(kernels=n, busy_ms=busy, wall_ms=wall * 1e3,
                traversal_ms=trav, atrous_ms=atr, **copies)


def moved_camera(cam):
    """cam with its eye 0.05 along x (made on the card)."""
    from truetrace_tpu_torch.scene.ir import Camera
    c2w = cam.c2w.clone()
    c2w[3, 0] += 0.05
    return Camera(c2w=c2w, fov_y=cam.fov_y, aperture=cam.aperture,
                  focus_dist=cam.focus_dist)


def phase_sync_free(r, state, cam, label: str):
    """Two more frames under torch.cuda.set_sync_debug_mode("error"),
    which raises at any blocking copy between host and card and any
    stream or device sync: one as it is, one moving the camera with
    cam_moved=True. Returns the state after them."""
    import torch
    moved = moved_camera(cam)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, state = r.step(state)
        _, _, state = r.step(state, cam=moved, cam_moved=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"{label}: two frames (the second moving the camera, cam_moved="
        f"True) under set_sync_debug_mode('error'): no host copy or sync")
    return state


def phase_graph(results, scene, cam, label: str):
    """The frame as CUDA graphs (Renderer.graph_step) against the eager
    Renderer.step on the same scene, at FRAME:

    1. parity: two fresh renderers, four frames each: as they are, as
       they are, moving the camera (cam_moved=True; its own graph) and
       with the moved camera (cam_moved=False; the first graph again, fed
       the second's state). The first frame runs eagerly on both paths,
       the other three replay; display, radiance and every state tensor
       bit for bit equal to the eager ones;
    2. time: FRAMES - 1 eager frames and as many replays, in turns, on
       the host clock around a synchronised frame, and each replay's
       device time (CUDA events around it: kernels and the gaps between
       them inside the graph);
    3. two replays under set_sync_debug_mode("error"), and one replay
       under the profiler.
    Results under results[label + "_graph"]."""
    import torch
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    cfg = RendererConfig(**FRAME)
    moved = moved_camera(cam)
    re, rg = Renderer(scene, cam, cfg), Renderer(scene, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    t0 = time.perf_counter()
    for i, (c, moved_now, frame) in enumerate((
            (None, None, gs), (None, None, gs), (moved, True, gm),
            (moved, False, gs))):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        pairs = [("display", de, dg), ("radiance", ae, ag),
                 ("accum count", se.accum.count, sg.accum.count),
                 ("taa history", se.taa_history, sg.taa_history)] + [
            (f"svgf {k}", getattr(se.svgf, k), getattr(sg.svgf, k))
            for k in ("color", "moments", "hist_len", "normal", "depth")]
        for what, a, b in pairs:
            check(torch_equal_bits(a, b), f"{label} frame {i + 1}: the "
                  f"replayed {what} differs from the eager one")
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t0
    check((gs.captures, gm.captures) == (1, 1),
          f"{label}: graph captures {gs.captures}, {gm.captures}")
    log(f"{label} graph: four frames (a camera move among them; the "
        f"first eager, three replayed from two graphs) bit for bit equal "
        f"to Renderer.step's display, radiance and state; {parity_s:.1f} s "
        f"with both captures")
    eager, replay, replay_dev = [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(FRAMES - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, se = re.step(se)
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ev[0].record()
        _, _, sg = gs(sg)
        ev[1].record()
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - t0)
        replay_dev.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, _, sg = gm(sg, cam=cam)
        _, _, sg = gs(sg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # a steady replay: the state is the graph's own, only the cameras
    # are copied in
    prof = phase_profile(None, None, lambda: gs(sg), f"{label} replay")
    ms = lambda xs: 1e3 * sum(xs) / len(xs)
    res = dict(eager_ms=ms(eager), replay_ms=ms(replay),
               replay_device_ms=sum(replay_dev) / len(replay_dev),
               eager_frames_ms=[1e3 * t for t in eager],
               replay_frames_ms=[1e3 * t for t in replay],
               profile=prof)
    log(f"{label} {FRAME['width']}x{FRAME['height']}x{FRAME['bounces']} "
        f"svgf, in turns: eager {res['eager_ms']:.1f} ms/frame, replayed "
        f"{res['replay_ms']:.1f} ms/frame (device "
        f"{res['replay_device_ms']:.1f} ms), "
        f"{res['eager_ms'] / res['replay_ms']:.2f} times; two "
        f"replays under set_sync_debug_mode('error')")
    results[f"{label}_graph"] = res


# ---------------------------------------------------------------------------
# phase 4: correctness of the output
# ---------------------------------------------------------------------------

def phase_cornell():
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render, render_sample)
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam = cornell.make(device="cpu")
    sc_gpu = compile_scene(meshes, mats, with_cwbvh=True,
                           with_light_bvh=True, device=DEVICE)
    sc_cpu = compile_scene(meshes, mats, with_cwbvh=True,
                           with_light_bvh=True, device="cpu")
    # card vs CPU on one sample of a small frame: the same counters, the
    # same traversal; the card only rounds transcendentals differently
    small = RenderConfig(width=32, height=32, bounces=3, bsdf="disney",
                         traversal="wavefront", light_sampling="tree")
    a = render_sample(sc_gpu, cam.to(DEVICE), small, 0).cpu()
    b = render_sample(sc_cpu, cam, small, 0)
    close = ((a - b).abs() <= 1e-3 + 1e-3 * b.abs()).all(-1)
    share = float(close.float().mean())
    rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"cornell 32x32 card vs CPU: {share:.4f} of pixels within 1e-3, "
        f"mean rel diff {rel:.2e}")
    check(share >= 0.98 and rel < 1e-3, "card and CPU renders disagree")

    S = 256
    cg = cam.to(DEVICE)
    img = render(sc_gpu, cg, RenderConfig(width=S, height=S, bounces=3,
                                          traversal="wavefront"), spp=8)
    # NEE + MIS converges to the BSDF-only estimator (tests/test_cornell.py
    # holds the channel means to rtol 0.12 at 4 bounces)
    img_n = render(sc_gpu, cg, RenderConfig(width=S, height=S, bounces=4,
                                            traversal="wavefront"), spp=8)
    img_b = render(sc_gpu, cg, RenderConfig(width=S, height=S, bounces=4,
                                            traversal="wavefront",
                                            use_nee=False), spp=32)
    img = img.cpu().numpy()
    m_nee = img_n.cpu().numpy().mean(axis=(0, 1))
    m_pt = img_b.cpu().numpy().mean(axis=(0, 1))
    nee_rel = float(np.max(np.abs(m_nee - m_pt) / m_pt))
    mid = img[96:160]
    left = mid[:, 11:53].mean(axis=(0, 1))
    right = mid[:, 203:245].mean(axis=(0, 1))
    top = float(img[:43].max())
    log(f"cornell {S}x{S} spp 8: left {np.round(left, 3)}, right "
        f"{np.round(right, 3)}, top max {top:.2f}, mean {img.mean():.4f}, "
        f"NEE {np.round(m_nee, 4)} vs BSDF-only {np.round(m_pt, 4)} "
        f"(max rel diff {nee_rel:.3f})")
    check(bool(np.isfinite(img).all()), "cornell image not finite")
    check(left[0] > left[1], "left wall is not red")
    check(right[1] > right[0], "right wall is not green")
    check(top > 1.0, "light not bright")
    check(img.mean() > 0.01, "image too dark")
    check(nee_rel < 0.12, "NEE and BSDF-only renders disagree")


# ---------------------------------------------------------------------------
# phase 5: the sponza_like frame (textured, sky-lit, OBJ ingestion)
# ---------------------------------------------------------------------------

def phase_sponza_build(tmp: str):
    """Export sponza_like at SPONZA_DETAIL into `tmp`, load it with the
    port's OBJ/MTL/PNG loader and build it at K = 6 with the light BVH.
    Returns (meshes, mats, atlas, rects, level_y, cam, env, scene)."""
    import torch
    from truetrace_tpu_torch.scene import sponza_like
    from truetrace_tpu_torch.scene.mesh import compile_scene
    t0 = time.perf_counter()
    sponza_like.export(tmp, SPONZA_DETAIL)
    t1 = time.perf_counter()
    parts = sponza_like.make(SPONZA_DETAIL, assets_dir=tmp, device=DEVICE)
    t2 = time.perf_counter()
    meshes, mats, atlas, rects, level_y, cam, env = parts
    scene = compile_scene(meshes, mats, env=env, atlas=atlas,
                          atlas_rects=rects, atlas_level_y=level_y,
                          with_cwbvh=True, with_light_bvh=True, device=DEVICE)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    k = scene.cw_leaf_rows.shape[1] // 10
    files = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(tmp) for f in fs)
    log(f"sponza_like detail {SPONZA_DETAIL:g}: {scene.n_tris()} triangles, "
        f"{scene.cw_nodes.shape[0]} nodes, {scene.cw_leaf_rows.shape[0]} "
        f"leaf rows (K = {k}), stack {scene.cw_stack}, "
        f"{scene.light_tris.tri_index.shape[0]} emissive triangles, "
        f"{rects.shape[0]} textures, atlas {tuple(atlas.shape)} "
        f"({atlas.nbytes / 2 ** 20:.1f} MiB, level_y {level_y.tolist()}), "
        f"sky {tuple(env.image.shape)}; export {t1 - t0:.2f} s "
        f"({files / 2 ** 20:.1f} MiB of files), load {t2 - t1:.2f} s, "
        f"build {t3 - t2:.2f} s")
    check(scene.n_tris() == SPONZA_TRIS, f"sponza_like has "
          f"{scene.n_tris()} triangles, not {SPONZA_TRIS}")
    check(k == 6, f"sponza_like built at K = {k}")
    check(rects.shape[0] == 8 and scene.env.image.shape[0] > 1,
          "sponza_like lost its textures or its sky")
    return parts + (scene,)


def phase_sponza_traversal(results, scene, cam):
    """Kernel against plain on sponza_like's bench mix, at the frame's
    lane count (512 x 512 rays per class, the shape Renderer.step hands
    the traversal, with sponza's own stack) and at bench.py's R = 1 << 17
    (its 1024 x 128 camera grid): every ray of both held bitwise; the
    plain run counts the work that sets each class's bound. The kernel
    row takes the frame's shape; Mrays/s at both."""
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_plain, closest_hit_plain)
    R = FRAME["width"] * FRAME["height"]
    table, C, S = scene.cw_table(), scene.cw_nodes.shape[0], scene.cw_stack
    for n in (R, BENCH_RAYS):
        rays = bench_rays(scene, cam, n)
        ro_p, rd_p, ro_b, rd_b, tm_b = rays
        work, err, plain = {}, {}, {}
        for name, ro, rd in (("primary", ro_p, rd_p),
                             ("bounce", ro_b, rd_b)):
            work[name], e, hit_share = hold_closest(
                table, C, S, ro, rd, f"sponza {name} ({n} rays)")
            err["closest"] = max(err.get("closest", 0.0), e)
            check(hit_share > 0.1, f"sponza {name}: only {hit_share:.3f} "
                  f"of rays hit")
            if n == R:
                plain[name] = cuda_ms(lambda: closest_hit_plain(
                    table, C, ro, rd, 1e30, S), 1)
        work["shadow"], err["any"], _ = hold_any(
            table, C, S, ro_b, rd_b, tm_b, f"sponza shadow ({n} rays)")
        if n == R:
            plain["shadow"] = cuda_ms(lambda: any_hit_plain(
                table, C, ro_b, rd_b, tm_b, S), 1)
        t = time_mix(table, C, S, rays, n, "sponza K=6")
        for name in ("primary", "bounce", "shadow"):
            w = work[name]
            log(f"traversal sponza {name} at {n} rays: bound "
                f"{w['bound_ms']:.4f} ms ({w['bound_by']}), kernel "
                f"{t[name]:.4f} ms = {w['bound_ms'] / t[name]:.3f} of the "
                f"bound" + (f"; plain {plain[name]:.1f} ms" if plain
                            else ""))
        key = "sponza_traversal" if n == R else "sponza_traversal_bench"
        results[key] = dict(mix=t, work=work, err=err, plain=plain, rays=n)


def phase_sponza_atrous(results, planes):
    """The a-trous kernel timed per step on the sponza frame's own packed
    planes (device time, no host gaps)."""
    from truetrace_tpu_torch.kernels.atrous_pallas import (
        atrous_pass_packed, atrous_pass_plain, pack)
    color, var, normal, depth = planes
    cv, nz = pack(color, var), pack(normal, depth)
    ms = {st: device_ms(lambda: atrous_pass_packed(cv, nz, st))
          for st in ATROUS_STEPS}
    plain = {st: cuda_ms(lambda: atrous_pass_plain(color, var, normal,
                                                   depth, st), 3)
             for st in ATROUS_STEPS}
    log("atrous sponza frame inputs, kernel ms by step: " + ", ".join(
        f"{k}: {v:.5f}" for k, v in ms.items()))
    res = results["atrous_pass"]
    res["sponza"] = dict(ms=sum(ms.values()) / len(ms),
                         plain_ms=sum(plain.values()) / len(plain),
                         ms_by_step={str(k): v for k, v in ms.items()},
                         max_abs_err=res["sponza_frame_max_abs_err"],
                         zero_normal_share=res[
                             "sponza_frame_zero_normal_share"])


def phase_sponza_slots(results, state, scene, cam):
    """The texture fetches the integrator skips: the sponza frame with
    every TEX_SLOTS slot fetched, as the JAX block fetches them (a slot
    no material sets selects the material's own value), gives the same
    sample bit for bit at the frame's size, and one frame of it is
    profiled beside the skipping frame's profile."""
    import dataclasses
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample)
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    from truetrace_tpu_torch.scene.ir import TEX_SLOTS
    every = dataclasses.replace(scene, tex_slots=TEX_SLOTS)
    cfg = RenderConfig(**{k: v for k, v in FRAME.items()
                          if k != "denoiser"})
    a = render_sample(scene, cam, cfg, 0)
    b = render_sample(every, cam, cfg, 0)
    check(torch_equal_bits(a, b), "sponza sample with every texture slot "
          "fetched differs from the skipping one")
    log(f"sponza texture slots some material sets: {scene.tex_slots}; "
        f"with all {len(TEX_SLOTS)} fetched the {FRAME['width']}x"
        f"{FRAME['height']} sample is bitwise the same; its frame:")
    r = Renderer(every, cam, RendererConfig(**FRAME))
    r.step(state)                                       # warm-up
    torch.cuda.synchronize()
    results["sponza_all_slots_profile"] = phase_profile(
        r, state, label="sponza frame, every slot")


def render_mean(scene, cam, W: int, H: int, spp: int, **cfg):
    """Mean RGB over a WxH image of `spp` samples per pixel, traced in
    batches of 256 samples (sample ids are per-lane counters), and its
    Monte Carlo standard error (from each pixel's sample variance); logs
    the running mean at each power-of-two sample count (the convergence).
    Returns (mean, standard error), each [3]."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample_with_stats)
    c = RenderConfig(width=W, height=H, **cfg)
    f64 = dict(dtype=torch.float64, device=scene.device)
    s1 = torch.zeros((W * H, 3), **f64)
    s2 = torch.zeros((W * H, 3), **f64)
    seen = []
    for s0 in range(0, spp, 256):
        b = min(256, spp - s0)
        pix = torch.arange(W * H, device=scene.device).repeat(b)
        sid = torch.arange(s0, s0 + b, device=scene.device
                           ).repeat_interleave(W * H)
        rad, _ = render_sample_with_stats(scene, cam, c, pix, sid)
        check(bool(torch.isfinite(rad).all()), "radiance not finite")
        rad = rad.double().view(b, W * H, 3)
        s1 += rad.sum(0)
        s2 += (rad * rad).sum(0)
        n = s0 + b
        if n & (n - 1) == 0 or n == spp:
            m = (s1.sum(0) / (W * H * n)).cpu().numpy()
            seen.append(f"{n}: {np.round(m, 5)}")
    var = (s2 - s1 * s1 / spp) / (spp - 1)
    se = (var.sum(0) / spp).sqrt() / (W * H)
    kind = "BSDF-only" if cfg.get("use_nee") is False else "NEE + MIS"
    log(f"  {kind} running means by spp: " + ", ".join(seen)
        + f"; standard error {np.round(se.cpu().numpy(), 6)}")
    return (s1.sum(0) / (W * H * spp)).cpu().numpy(), se.cpu().numpy()


def phase_sponza_unbiased(scene, cam):
    """The golden ladder's check on the card (tests/test_golden.py): the
    port's NEE + MIS (light tree over the lamps, env sampling over the
    sky) against its BSDF-only render of the same sponza_like scene, under
    the ladder's soft wide sun so that BSDF sampling converges.

    The integrator does NEE at every vertex, the last one included, while
    the BSDF-only estimator with the same bounce count never traces the
    segment after the last vertex: NEE(B) holds the NEE-weighted share of
    the light of paths with B + 1 segments on top of BSDF-only(B)
    (scripts/torch_nee_ladder.py measures the ladder). So at the ladder's
    3 bounces NEE(3) must lie between BSDF-only(3) and BSDF-only(4), and
    at the renderer's default 6 bounces, where that share is below the
    tolerance, the converged means agree within rtol 0.06 / atol 5e-3.
    The bracket's ends move out by NEE_SIGMAS standard errors of the
    difference of the means, and no more."""
    import dataclasses
    from truetrace_tpu_torch.build.env_cdf import (
        build_env_cdf, procedural_sky)
    soft = dataclasses.replace(scene, env=build_env_cdf(
        procedural_sky(**GOLDEN_SKY), device=DEVICE))
    W, H = 40, 30
    kw = dict(bsdf="disney", traversal="wavefront", light_sampling="tree")
    t0 = time.perf_counter()
    m, se = {}, {}
    for b, nee in ((3, True), (3, False), (4, False), (6, True),
                   (6, False)):
        m[b, nee], se[b, nee] = render_mean(
            soft, cam, W, H, NEE_SPP if nee else BSDF_SPP, bounces=b,
            use_nee=nee, **kw)
    slack = lambda e: NEE_SIGMAS * np.hypot(se[3, True], e)
    lo = m[3, False] - slack(se[3, False])
    hi = m[4, False] + slack(se[4, False])
    inside = bool(np.all(m[3, True] >= lo) and np.all(m[3, True] <= hi))
    agree = np.allclose(m[6, True], m[6, False], rtol=NEE_RTOL,
                        atol=NEE_ATOL)
    rel = lambda a, b: float(np.max(np.abs(a - b) / b))
    log(f"sponza {W}x{H}, NEE + MIS at {NEE_SPP} spp, BSDF-only at "
        f"{BSDF_SPP} spp: B=3 NEE {np.round(m[3, True], 5)} within "
        f"[BSDF-only(3) {np.round(m[3, False], 5)}, BSDF-only(4) "
        f"{np.round(m[4, False], 5)}] widened by {NEE_SIGMAS:g} standard "
        f"errors to [{np.round(lo, 5)}, {np.round(hi, 5)}]: {inside}; "
        f"B=6 NEE {np.round(m[6, True], 5)} vs BSDF-only "
        f"{np.round(m[6, False], 5)}: max rel diff "
        f"{rel(m[6, True], m[6, False]):.4f} (rtol {NEE_RTOL}, atol "
        f"{NEE_ATOL}); {time.perf_counter() - t0:.1f} s")
    check(inside, "sponza NEE + MIS at 3 bounces outside [BSDF-only(3), "
          "BSDF-only(4)]")
    check(agree, "sponza NEE + MIS and BSDF-only renders disagree at 6 "
          "bounces")


def phase_sponza_card_vs_cpu(parts, scene, cam):
    """One sample of a 32x24 sponza frame on the card and, from its own
    build, on the CPU: the same counters, the same traversal; the card
    only rounds transcendentals differently."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample)
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, atlas, rects, level_y, _, env = parts
    t0 = time.perf_counter()
    sc_cpu = compile_scene(meshes, mats, env=env.to("cpu"), atlas=atlas,
                           atlas_rects=rects, atlas_level_y=level_y,
                           with_cwbvh=True, with_light_bvh=True,
                           device="cpu")
    small = RenderConfig(width=32, height=24, bounces=3, bsdf="disney",
                         traversal="wavefront", light_sampling="tree")
    a = render_sample(scene, cam, small, 0).cpu()
    b = render_sample(sc_cpu, cam.to("cpu"), small, 0)
    close = ((a - b).abs() <= 1e-3 + 1e-3 * b.abs()).all(-1)
    share = float(close.float().mean())
    rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
    log(f"sponza 32x24 card vs CPU: {share:.4f} of pixels within 1e-3, "
        f"mean rel diff {rel:.2e}; {time.perf_counter() - t0:.1f} s with "
        f"the CPU build")
    check(bool(torch.isfinite(a).all()), "sponza card render not finite")
    check(share >= 0.98 and rel < 1e-3, "sponza card and CPU renders "
          "disagree")


# ---------------------------------------------------------------------------

# (name, source, TPU kernel replaced, the kernel instantiations of the
# source whose ptxas report goes into the row)
KERNELS = (
    ("closest_hit_wavefront", "truetrace_tpu_torch/kernels/csrc/traverse.cu",
     "truetrace_tpu/kernels/cwbvh_wavefront.py:861", "traverse_kernel<6,0>"),
    ("any_hit_wavefront", "truetrace_tpu_torch/kernels/csrc/traverse.cu",
     "truetrace_tpu/kernels/cwbvh_wavefront.py:927", "traverse_kernel<6,1>"),
    ("step_core", "truetrace_tpu_torch/kernels/csrc/step_core.cu",
     "truetrace_tpu/kernels/step_pallas.py:120", "step_core_kernel"),
    ("atrous_pass", "truetrace_tpu_torch/kernels/csrc/atrous.cu",
     "truetrace_tpu/kernels/atrous_pallas.py:110",
     "atrous_staged|atrous_direct"),
)


def ptxas_of(src: str, want: str) -> dict:
    """What ptxas reported in this run's build for the kernels of `src`
    named `want` ("traverse_kernel<6,0>" is one instantiation,
    "atrous_staged|atrous_direct" every instantiation of both kernels):
    {name<template args>: registers, spills, stack frame, static shared
    memory}."""
    from truetrace_tpu_torch.kernels import _cuda
    base = want.split("<")[0]
    out = {}
    for mangled, info in _cuda.ptxas_report(os.path.basename(src)).items():
        m = re.search(rf"({base})(I(?:L[a-z]\d+E)+E)?", mangled)
        if m:
            args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            if name == want or "<" not in want:
                out[name] = info
    return out


PATH_KERNELS = ("closest_hit_wavefront", "any_hit_wavefront", "atrous_pass")
# a profiled frame's host copies and syncs (phase_profile)
COPY_KEYS = ("memcpy_htod", "memcpy_dtoh", "stream_syncs",
             "blocking_memcpy_calls", "memcpy_dtod")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}")

    from truetrace_tpu_torch.kernels import _cuda
    t0 = time.perf_counter()
    _cuda.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for src, flags in _cuda.NVCC_FLAGS.items():
        log(f"  nvcc {src}: {' '.join(flags)}")
    ptxas = {name: ptxas_of(src, want) for name, src, _, want in KERNELS}
    for name, rep in ptxas.items():
        check(bool(rep), f"no ptxas report for {name}'s kernels")
        for kern, info in rep.items():
            log(f"  ptxas {kern}: {info}")

    results = {}
    phase_atrous(results)

    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam, env = atrium.make(detail=ATRIUM_DETAIL,
                                         device=DEVICE)
    scenes = {}
    for k in (6, 3):
        t0 = time.perf_counter()
        scenes[k] = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                                  with_light_bvh=(k == 6), leaf_k=k,
                                  device=DEVICE)
        log(f"atrium detail {ATRIUM_DETAIL} K={k}: "
            f"{scenes[k].n_tris()} triangles, "
            f"{scenes[k].cw_nodes.shape[0]} nodes, "
            f"{scenes[k].cw_leaf_rows.shape[0]} leaf rows, stack "
            f"{scenes[k].cw_stack}, built in "
            f"{time.perf_counter() - t0:.1f} s")
    phase_step_core(results, scenes[3], cam)
    phase_traversal(results, scenes, cam)
    del scenes[3]
    launches, renderer, state = phase_frame(results, scenes[6], cam,
                                            "atrium")
    state = phase_sync_free(renderer, state, cam, "atrium")
    results["profile"] = phase_profile(renderer, state, label="atrium frame")
    phase_atrous_frame(results, renderer, state, "atrium")
    phase_graph(results, scenes[6], cam, "atrium")
    smem = _cuda.lib("traverse.cu").tt_traverse_smem(scenes[6].cw_stack)
    del renderer, state, scenes

    with tempfile.TemporaryDirectory(prefix="sponza_like_") as tmp:
        parts = phase_sponza_build(tmp)
    sponza, s_cam = parts[-1], parts[5]
    phase_sponza_traversal(results, sponza, s_cam)
    s_launches, renderer, state = phase_frame(results, sponza, s_cam,
                                              "sponza")
    state = phase_sync_free(renderer, state, s_cam, "sponza")
    results["sponza_profile"] = phase_profile(renderer, state,
                                              label="sponza frame")
    phase_sponza_slots(results, state, sponza, s_cam)
    phase_sponza_atrous(results, phase_atrous_frame(results, renderer, state,
                                                    "sponza"))
    del renderer, state
    phase_graph(results, sponza, s_cam, "sponza")
    phase_sponza_unbiased(sponza, s_cam)
    phase_sponza_card_vs_cpu(parts[:-1], sponza, s_cam)
    del parts, sponza
    phase_cornell()

    for k in (6, 3):
        log(f"traversal Mrays/s (bench mix, atrium K={k}): " + ", ".join(
            f"{results[f'traversal_k{k}_{n}']['mrays']:.2f} at {n} rays"
            for n in (BENCH_RAYS, FRAME["width"] * FRAME["height"])))
    for key in ("sponza_traversal_bench", "sponza_traversal"):
        st = results[key]
        log(f"traversal Mrays/s (bench mix, sponza_like K=6): "
            f"{st['mix']['mrays']:.2f} at {st['rays']} rays; ms per launch "
            f"primary {st['mix']['primary']:.4f}, bounce "
            f"{st['mix']['bounce']:.4f}, shadow {st['mix']['shadow']:.4f}")
    for label, prof in (("atrium", "profile"), ("sponza", "sponza_profile")):
        f, p = results[label], results[prof]
        log(f"frame {label} {FRAME['width']}x{FRAME['height']}x"
            f"{FRAME['bounces']} svgf: {f['ms']:.1f} ms (median "
            f"{f['median_ms']:.1f}); device busy {p['busy_ms']:.1f} ms in "
            f"{p['kernels']} kernels, traversal {p['traversal_ms']:.3f} ms "
            f"and a-trous {p['atrous_ms']:.3f} ms of it")
    p = results["sponza_all_slots_profile"]
    log(f"frame sponza with every texture slot fetched: device busy "
        f"{p['busy_ms']:.1f} ms in {p['kernels']} kernels")
    frames = {}
    for label, prof in (("atrium", "profile"), ("sponza", "sponza_profile")):
        g, p = results[f"{label}_graph"], results[prof]
        gp = g["profile"]
        log(f"frame {label}: eager {g['eager_ms']:.1f} ms, replayed "
            f"{g['replay_ms']:.1f} ms (device {g['replay_device_ms']:.1f} ms,"
            f" busy {gp['busy_ms']:.1f} ms in {gp['kernels']} kernels); "
            f"eager frame's host copies and syncs "
            f"{ {k: p[k] for k in COPY_KEYS} }, replayed frame's "
            f"{ {k: gp[k] for k in COPY_KEYS} }")
        frames[label] = dict(
            eager_ms=g["eager_ms"], replay_ms=g["replay_ms"],
            replay_device_ms=g["replay_device_ms"],
            eager_busy_ms=p["busy_ms"], eager_kernels=p["kernels"],
            replay_busy_ms=gp["busy_ms"], replay_kernels=gp["kernels"],
            eager_copies={k: p[k] for k in COPY_KEYS},
            replay_copies={k: gp[k] for k in COPY_KEYS})
    a = results["atrous_pass"]
    log("a-trous kernel ms by step: " + ", ".join(
        f"{k}: {v:.5f}" for k, v in a["ms_by_step"].items())
        + f"; mean {a['ms']:.5f} = {a['bound_ms'] / a['ms']:.3f} of the "
        f"bound; packing {a['pack_ms']:.5f} ms a frame")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    # library_ms: no single PyTorch call computes any of these functions
    rows = {}
    for name, src, rep, _ in KERNELS:
        res = results[name]
        rows[name] = dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=res["max_abs_err"],
            ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=None, launches_per_frame=launches[name] / FRAMES,
            share_of_bound=res["bound_ms"] / res["ms"],
            ptxas=ptxas[name], **{k: res[k] for k in (
                "work", "ms_by_step", "plain_ms_by_step", "pack_ms",
                "filter_ms", "atrium_frame_max_abs_err", "by_lanes")
                if k in res})
        rows[name]["sponza"] = sponza_row(name, results, s_launches)
    for name in ("closest_hit_wavefront", "any_hit_wavefront"):
        # the ring stack's dynamic shared memory, as the launch sizes it
        rows[name]["smem_dynamic"] = smem
    # "kernels": the main path's kernels. step_core's code runs inside
    # the traversal kernel; its own launch is held against its plain
    # version above but is not on the main path ("off_path").
    print(json.dumps({"kernels": [rows[n] for n in PATH_KERNELS],
                      "off_path": [rows["step_core"]], "frames": frames}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sponza_row(name: str, results: dict, launches: dict) -> dict:
    """A kernel's numbers on the sponza_like path: its launches over that
    path's frames, and its time, plain time and bound on sponza's own
    inputs (the traversal at the frame's 512 x 512 lanes with the bound
    from this run's counted work per ray, and its time at bench.py's R;
    a-trous on the sponza frame's planes)."""
    row = dict(launches=launches[name],
               launches_per_frame=launches[name] / FRAMES)
    st = results["sponza_traversal"]
    if name in ("closest_hit_wavefront", "any_hit_wavefront"):
        cls = ("primary", "bounce") if name.startswith("closest") \
            else ("shadow",)
        ms = sum(st["mix"][c] for c in cls) / len(cls)
        bd = sum(st["work"][c]["bound_ms"] for c in cls) / len(cls)
        row.update(rays=st["rays"], ms=ms, bound_ms=bd,
                   bound_by=max((st["work"][c] for c in cls),
                                key=lambda w: w["bound_ms"])["bound_by"],
                   share_of_bound=bd / ms,
                   plain_ms=sum(st["plain"][c] for c in cls) / len(cls),
                   max_abs_err=max(results[k]["err"][
                       "closest" if len(cls) == 2 else "any"] for k in (
                           "sponza_traversal", "sponza_traversal_bench")),
                   work={c: st["work"][c] for c in cls})
        sb = results["sponza_traversal_bench"]
        row["bench_mix"] = dict(
            rays=sb["rays"], ms=sum(sb["mix"][c] for c in cls) / len(cls),
            bound_ms=sum(sb["work"][c]["bound_ms"] for c in cls) / len(cls),
            mrays=sb["mix"]["mrays"])
    elif name == "atrous_pass":
        a = results["atrous_pass"]
        row.update(a["sponza"], bound_ms=a["bound_ms"],
                   bound_by=a["bound_by"],
                   share_of_bound=a["bound_ms"] / a["sponza"]["ms"])
    return row


if __name__ == "__main__":
    sys.exit(main())
