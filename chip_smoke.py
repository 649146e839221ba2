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
3b. the composed production frame (COMPOSED: phase 3's frame with the
   ReSTIR DI prepass, the radiance cache with query bounce 2, ReSTIR GI)
   on the same atrium: its frames, sync-free frames, profile (host copies
   and syncs must be none; the cache's index_put sort and sums) and CUDA
   graphs as phase 3's, every state tensor (reservoirs and cache tables
   included) bit for bit; the cache update on a frame's own records, bit
   for bit twice and from a CUDA graph, and its device time; (bench.py's headline scene): export it at detail
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
   scripts/verify_drive.py at 256x256; the JAX package's statistical
   gates of the composed frame's parts on the card (ReSTIR DI unbiased,
   the composed frame's energy, cache probing under contention); two
   composed Cornell frames at 16x16 on the card against the CPU;
6. glass and the temporal denoisers: the transmittance query of the
   traversal kernel against its plain version, bit for bit, at the
   frame's 262144 lanes on the atrium (bench.py's shadow rays, with a
   tint table of zeros and with one passing every third triangle at 0.8;
   its time against the any hit's on the same rays) and on every NEE
   shadow ray of the JAX package's nested-glass scene (scripts/demo.py
   scene 6, built here from numpy); then as phase 3's frames (timed
   eager frames with their launch counts, sync-free frames, the profile,
   the CUDA graphs bit for bit) the atrium frame with ASVGF (its stratum
   replay), with ReCur, the composed frame with ASVGF (ReSTIR-ASVGF) and
   the nested-glass frame (10 bounces, roulette from 6, SVGF: the
   transmittance kernel and the medium stack); the JAX package's glass,
   transmit-shadow, ASVGF and ReCur gates on the card; and two glass +
   ASVGF Cornell frames at 16x16 on the card against the CPU;
7. the post chain, TAAU with partial rendering under analytic lights,
   and the neural denoiser, each as phase 3's frames (timed eager frames
   with their launch counts, sync-free frames, the profile, the CUDA
   graphs bit for bit): "post", FRAME's atrium with the JAX recorded
   frame's chain (ACES, bloom 0.08, CAS 0.3) and temporal auto exposure,
   whose HDR image also goes through every other tonemap and a baked
   33^3 LUT against the CPU; "interactive", sponza_like with 16 analytic
   lights (RIS over 8 candidates), traced at 512x512 over half its
   pixels a frame (partial_rendering 2) and upscaled by TAAU to
   1024x1024, SVGF; "neural", FRAME's atrium with the neural_taa
   denoiser and the in-repo checkpoint examples/denoiser.msgpack; the
   JAX package's checks of analytic lights (RIS, softness, z_rot), TAAU,
   partial rendering and temporal exposure on the card; and each of the
   three configurations at 16x16 on the Cornell box, card against CPU;
8. instanced scenes and terrain: the forest (FOREST: 2,048 trees and 64
   emissive lanterns scattered on a 257^2 hills terrain under the baked
   sky, 512x512x4, the two-level traversal, SVGF): the TLAS closest and
   any hits, the transmittance (tints of zeros and a third passing) and
   the march's closest and any hits, each bit for bit its plain version
   on the forest frame's own rays (bounce 0 timed and bounded from the
   plain version's counted work); the forest frames with the lanterns
   moved by update_instance_transforms and the camera along x between
   frames (update_s timed apart), sync-free, profiled, and as CUDA graphs
   over the updates with one capture, bit for bit; the instanced glass
   scene of tests/test_tlas_transmit.py as the transmittance's frame
   ("tinted"); the JAX package's instancing, object-motion, tinted-TLAS
   and terrain checks on the card; the forest, scripts/demo.py scene 4
   and the tinted scene at 16x16, card against CPU;
9. animated scenes: the atrium's meshes with a 128 x 256 two-bone
   cylinder (358,968 triangles in one K = 3 BLAS, compile_dynamic_scene),
   posed every frame by pose_scene (skinning, the level-by-level refit,
   the leaf rows, the normals and light rows rebuilt on the card):
   pose_scene's device time and kernels, with no host copy or sync; the
   K = 3 closest and any hits bit for bit their plain versions on a bent
   pose's own rays (bounce 0 timed and bounded); phase 3's frames at a
   new pose each (timed eager frames with their launch counts, sync-free
   frames, the profile) and the CUDA graphs over 10 poses with one
   capture, bit for bit; a from-scratch compile_scene at one pose for
   scale; the JAX package's refit, light-refit, skinning, dynamic-scene,
   AssetManager and video checks on the card; and the small animated
   frame at 16x16, card against CPU.

It prints the card line, one JSON line of kernel results (time, plain
time, bound and what sets it, launches per frame, ptxas registers,
spills and shared memory, for the traversal the work per ray, for
a-trous the time at each step and of packing; under "sponza" each
kernel's launches, time and bound on the sponza_like path, under
"composed" its launches on the composed frame, and so under "asvgf",
"recur", "composed_asvgf", "glass", "post", "interactive", "neural",
"forest", "tinted" and "animated" (where the traversal rows also hold
the K = 3 kernels' times and bounds on the animated frame's rays); under
"frames" each
path's eager and replayed frame times, device busy, kernel counts and
host copies, and the composed frame's cache numbers and gates), and as
its last line
{"ok": true, "device": {...}}. It exits non-zero, with
no result line, when there is no CUDA card or the port's package is
missing.
"""
from __future__ import annotations

import json
import math
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
# the JAX package's composed production frame (scripts/profile_composed.py
# full_composed): FRAME with the radiance cache (query bounce 2), ReSTIR
# GI and ReSTIR DI
COMPOSED = dict(FRAME, use_radiance_cache=True, cache_query_bounce=2,
                cache_capacity=1 << 20, use_restir=True, use_restir_di=True)
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
OPS_TINT = 3     # the three products of a tinted triangle (transmittance)
OPS_ATROUS_PX = 740   # the plain pass per pixel: 24 weighted taps x 29,
                      # centre tap, prefilter, sigmas, normalisation
ATROUS_STEPS = (1, 2, 4, 8, 16)   # svgf_denoise's five passes
# step_core's lanes: the Pallas contract's R, and the frame's 512 x 512
STEP_CORE_LANES = (65536, 262144)


_T0 = time.perf_counter()


def log(*a):
    """Print a line, stamped with the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:6.1f} s]", *a, flush=True)


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


def timed_once(fn):
    """(fn(), its milliseconds on the current stream by CUDA events): one
    call, no warm-up, for the plain versions, which are checked against
    a kernel once a ray set."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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
    the table rows it touches (10K words each) once, and 44 bytes a ray
    it walks (origin, direction, t_max in; t, tri, u, v out) and 20 a
    dead one (t_max <= 1e-4: t_max in, its miss out). The
    transmittance's counts add "accepted": OPS_TINT operations a tinted
    triangle, and 12 bytes a distinct tint row read; its output is 12
    bytes a ray (40 a walked ray, 16 a dead one)."""
    nd, lr, tt = (float(counts[f].sum()) for f in (
        "node_decodes", "leaf_rows", "tri_tests"))
    live = counts["live_rays"]
    out = dict(node_decodes_per_ray=nd / R, leaf_rows_per_ray=lr / R,
               tri_tests_per_ray=tt / R, rows_touched=counts["rows_touched"],
               live_share=live / R)
    table_bytes = 4 * W * counts["rows_touched"]
    if "accepted" not in counts:
        return dict(out, **bound(OPS_NODE * nd + OPS_TRI * tt,
                                 table_bytes + 44 * live + 20 * (R - live)))
    acc = float(counts["accepted"].sum())
    return dict(out, tinted_per_ray=acc / R, tint_rows=counts["tint_rows"],
                **bound(OPS_NODE * nd + OPS_TRI * tt + OPS_TINT * acc,
                        table_bytes + 40 * live + 16 * (R - live)
                        + 12 * counts["tint_rows"]))


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
            f"{w['rows_touched']} table rows touched, "
            f"{w['live_share']:.3f} of the rays walked"
            + (f", {w['tint_rows']} tint rows read" if "tint_rows" in w
               else ""))


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

def make_renderer(scene, cam, cfg: dict):
    """Renderer at `cfg`; an "rr_start" key (RendererConfig has none, as
    in the JAX package) sets its integrator's roulette start, and a
    "post" key holds PostConfig's fields."""
    from dataclasses import replace
    from truetrace_tpu_torch.post.pipeline import PostConfig
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    cfg = dict(cfg)
    rr_start = cfg.pop("rr_start", None)
    cfg["post"] = PostConfig(**cfg.get("post", {}))
    r = Renderer(scene, cam, RendererConfig(**cfg))
    if rr_start is not None:
        r.rcfg = replace(r.rcfg, rr_start=rr_start)
    return r


def launch_counters():
    from truetrace_tpu_torch.kernels import atrous_pallas, cwbvh_wavefront
    from truetrace_tpu_torch.kernels import cwbvh_tlas, heightmap
    from truetrace_tpu_torch.kernels import step_pallas
    return {"closest_hit_wavefront": cwbvh_wavefront.closest_hit_wavefront,
            "any_hit_wavefront": cwbvh_wavefront.any_hit_wavefront,
            "transmit_wavefront": cwbvh_wavefront.transmit_wavefront,
            "step_core": step_pallas.step_core,
            "atrous_pass": atrous_pallas.atrous_pass_packed,
            "closest_hit_tlas": cwbvh_tlas.closest_hit_tlas,
            "any_hit_tlas": cwbvh_tlas.any_hit_tlas,
            "transmit_tlas": cwbvh_tlas.transmit_tlas,
            "heightmap_closest": heightmap.heightmap_closest,
            "heightmap_any": heightmap.heightmap_any}


def phase_frame(results, scene, cam, label: str, cfg: dict = FRAME):
    """`Renderer.step` at `cfg`: 1 warm-up and FRAMES - 1 timed frames,
    with every kernel's launch count set to 0 just before and read just
    after; the display must be finite and in [0, 1]. Results go under
    `results[label]`."""
    import torch
    r = make_renderer(scene, cam, cfg)
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
    H, W = cfg["height"], cfg["width"]
    check(tuple(display.shape) == (H, W, 3), f"display {display.shape}")
    check(bool(torch.isfinite(display).all()), "display not finite")
    check(float(display.min()) >= 0.0 and float(display.max()) <= 1.0,
          "display outside [0, 1]")
    check(bool(torch.isfinite(accum).all()), "radiance not finite")
    mean = float(accum.mean())
    check(mean > 1e-3, f"radiance mean {mean}")
    ms = 1e3 * sum(times) / len(times)
    med = 1e3 * sorted(times)[len(times) // 2]
    log(f"frame {label} {H}x{W}x{cfg['bounces']} {cfg.get('denoiser')}: "
        f"warm-up "
        f"{warm * 1e3:.1f} ms, frames {[round(t * 1e3, 1) for t in times]}"
        f" ms -> mean {ms:.1f} ms/frame, median {med:.1f}; radiance mean "
        f"{mean:.4f}")
    log(f"launches over the {label} path's {FRAMES} frames: {launches}")
    for name in PATHS.get(label, PATHS["atrium"]):
        check(launches[name] > 0, f"{name} never launched on the {label} "
              f"path")
    results[label] = dict(ms=ms, median_ms=med, warmup_ms=warm * 1e3,
                          mean=mean)
    return launches, r, state


def dev_us(e) -> float:
    """A profiler event's own device microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profiled(fn):
    """(torch.profiler's key_averages of fn(), its wall seconds). The
    CUDA activity alone records the kernels, the device copies and the
    CUDA runtime calls (launches, syncs, blocking copies), which is all
    phase_profile reads; the CPU activity's operator events would only
    slow the trace's processing (phase_profile_sees_syncs shows the syncs
    and copies are seen)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof.key_averages(), wall


def copies_of(events) -> dict:
    """The host copies and syncs among profiler events (COPY_KEYS)."""
    count = lambda pred: sum(e.count for e in events if pred(e.key))
    return dict(
        memcpy_htod=count(lambda k: "Memcpy HtoD" in k),
        memcpy_dtoh=count(lambda k: "Memcpy DtoH" in k),
        stream_syncs=count(lambda k: k.startswith("cudaStreamSynchronize")),
        blocking_memcpy_calls=count(lambda k: k in ("cudaMemcpy",
                                                    "cudaMemcpy2D")),
        memcpy_dtod=count(lambda k: "Memcpy DtoD" in k))


def phase_profile_sees_syncs():
    """The host-copy and sync gate is not blind: a function that copies
    to the card, reads a value back (a device-to-host copy and a stream
    sync) and copies a pinned tensor back synchronously shows each under
    `profiled`."""
    import torch

    def syncing():
        x = torch.tensor([1.0, 2.0], device=DEVICE)
        float(x.sum())
        torch.empty(2, pin_memory=True).copy_(x)

    copies = copies_of(profiled(syncing)[0])
    log(f"profiler sees a syncing function's host copies and syncs: "
        f"{copies}")
    for k in ("memcpy_htod", "memcpy_dtoh", "stream_syncs"):
        check(copies[k] > 0, f"the profiler missed {k}: {copies}")


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
    frame = frame or (lambda: r.step(state))
    events, wall = profiled(frame)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    of = lambda name: sum(dev_us(e) for e in kernels if name in e.key) / 1e3
    trav, atr = of("traverse_kernel") + of("tlas_kernel"), of("atrous_")
    march = of("heightmap_kernel")
    # the radiance cache's sums: index_put_'s sort path (a radix sort of
    # the slots, then one segmented sum a slot)
    scatter = of("indexing_backward") + of("RadixSort")
    copies = copies_of(events)
    log(f"profiled {label}: wall {wall * 1e3:.1f} ms, {n} kernels, device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall), "
        f"traversal {trav:.3f} ms ({100 * trav / busy:.1f}% of busy), "
        f"a-trous {atr:.3f} ms ({100 * atr / busy:.2f}% of busy), "
        f"heightmap march {march:.3f} ms, "
        f"index_put sort and sums {scatter:.3f} ms; host copies and syncs: "
        f"{copies}")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:100]}")
    for k in COPY_KEYS[:4]:
        check(copies[k] == 0, f"profiled {label}: {copies[k]} {k}")
    return dict(kernels=n, busy_ms=busy, wall_ms=wall * 1e3,
                traversal_ms=trav, atrous_ms=atr, scatter_ms=scatter,
                heightmap_ms=march,
                **copies)


def moved_camera(cam, dx: float = 0.05):
    """cam with its eye dx along x (made on the card)."""
    from truetrace_tpu_torch.scene.ir import Camera
    c2w = cam.c2w.clone()
    c2w[3, 0] += dx
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


def phase_graph(results, scene, cam, label: str, cfg: dict = FRAME):
    """The frame as CUDA graphs (Renderer.graph_step) against the eager
    Renderer.step on the same scene, at `cfg`:

    1. parity: two fresh renderers, four frames each: as they are, as
       they are, moving the camera (cam_moved=True; its own graph) and
       with the moved camera (cam_moved=False; the first graph again, fed
       the second's state). The first frame runs eagerly on both paths,
       the other three replay; display, radiance and every state tensor
       (accumulation, TAA and SVGF histories, and the reservoirs and
       cache tables where `cfg` has them) bit for bit equal to the eager
       ones;
    2. time: FRAMES - 1 eager frames and as many replays, in turns, on
       the host clock around a synchronised frame, and each replay's
       device time (CUDA events around it: kernels and the gaps between
       them inside the graph);
    3. two replays under set_sync_debug_mode("error"), and one replay
       under the profiler.
    Results under results[label + "_graph"]."""
    import torch
    from truetrace_tpu_torch.renderer import _tensors
    shape = f"{cfg['width']}x{cfg['height']}x{cfg['bounces']}"
    moved = moved_camera(cam)
    re, rg = make_renderer(scene, cam, cfg), make_renderer(scene, cam, cfg)
    gs, gm = rg.graph_step(cam_moved=False), rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    t0 = time.perf_counter()
    for i, (c, moved_now, frame) in enumerate((
            (None, None, gs), (None, None, gs), (moved, True, gm),
            (moved, False, gs))):
        de, ae, se = re.step(se, cam=c, cam_moved=moved_now)
        dg, ag, sg = frame(sg, cam=c)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        check(te.keys() == tg.keys(), f"{label}: state fields differ")
        pairs = [("display", de, dg), ("radiance", ae, ag)] + [
            (k, te[k], tg[k]) for k in te]
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
    log(f"{label} {shape}, in turns: eager {res['eager_ms']:.1f} ms/frame, replayed "
        f"{res['replay_ms']:.1f} ms/frame (device "
        f"{res['replay_device_ms']:.1f} ms), "
        f"{res['eager_ms'] / res['replay_ms']:.2f} times; two "
        f"replays under set_sync_debug_mode('error')")
    results[f"{label}_graph"] = res


# ---------------------------------------------------------------------------
# phase 3b: the composed production frame
# ---------------------------------------------------------------------------

def phase_composed_cache(results, r, state):
    """The radiance cache's update on the records one composed frame
    hands it (its inputs grabbed on the way): twice on the same inputs
    and once replayed from a CUDA graph, all bit for bit equal (the sums
    go through index_put_'s sort path, not atomics), and its device time
    (device_ms: no host gaps)."""
    import torch
    from truetrace_tpu_torch.integrate import radiance_cache as rc
    seen = []
    orig = rc.cache_update

    def grab(*a, **k):
        seen.append((a, k))
        return orig(*a, **k)

    rc.cache_update = grab
    try:
        r.step(state)
    finally:
        rc.cache_update = orig
    a, k = seen[0]
    live = int((a[4] > 0).sum())
    outs = [orig(*a, **k) for _ in range(2)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        orig(*a, **k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs.append(orig(*a, **k))
    graph.replay()
    torch.cuda.synchronize()
    for out in outs[1:]:
        for f in ("key", "rad", "count", "age", "cellw0", "cellw1"):
            check(torch_equal_bits(getattr(outs[0], f), getattr(out, f)),
                  f"cache_update: {f} differs between runs")
    # ~50 kernels a call: few calls, so the launch queue never fills
    ms = device_ms(lambda: orig(*a, **k), reps=4)
    occupied = int((outs[0].key != 0).sum())
    log(f"composed cache_update on a frame's {a[1].shape[0]} records "
        f"({live} live) into {outs[0].capacity} slots ({occupied} occupied "
        f"after): bit for bit equal twice and from a CUDA graph; "
        f"{ms:.4f} ms on the device")
    results["composed_cache"] = dict(update_ms=ms, records=live,
                                     occupied=occupied)


def cornell_scene(device: str):
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam = cornell.make(device="cpu")
    return compile_scene(meshes, mats, with_cwbvh=True, with_light_bvh=True,
                         device=device), cam.to(device)


def phase_composed_gates(results):
    """The JAX package's statistical gates of the composed frame's parts,
    on the card through the port (the wavefront traversal, the port's
    only):

    * ReSTIR DI is unbiased (tests/test_restir_di.py:19-44): 48
      restir_di_step frames of the Cornell box at 32x32, 1 bounce,
      Lambert, 4 candidates and 1 spatial pass, against `render` at 192
      spp: interior means within rel 0.05, each channel within 0.08;
    * the composed frame keeps the energy (tests/test_composition.py:
      88-110): 8 frames of the cache + DI + GI at 24x24, 2 bounces,
      Lambert, CDF light sampling, against `render` at 96 spp: rel
      < 0.3; with SVGF, 3 frames finite and in [0, 1];
    * probing survives contention (tests/test_radiance_cache.py:
      95-123): at ~50% occupancy of 4096 slots, two frames of inserts,
      queries hit > 0.9."""
    import torch
    from truetrace_tpu_torch.integrate import radiance_cache as rc
    from truetrace_tpu_torch.integrate.pathtrace import RenderConfig, render
    from truetrace_tpu_torch.integrate.restir_di import (
        ReSTIRDIState, restir_di_step)
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    t0 = time.perf_counter()
    sc, cam = cornell_scene(DEVICE)
    cfg = RenderConfig(width=32, height=32, bounces=1, bsdf="lambert",
                       traversal="wavefront")
    ref = render(sc, cam, cfg, spp=192).cpu().numpy()
    st = ReSTIRDIState.create(32, 32, DEVICE)
    acc = torch.zeros((32, 32, 3), device=DEVICE)
    for s in range(48):
        img, st, _ = restir_di_step(sc, cam, cfg, st, s, n_candidates=4,
                                    n_spatial=1)
        acc += img
    a, b = (acc / 48).cpu().numpy()[4:-4, 4:-4], ref[4:-4, 4:-4]
    rel = abs(a.mean() - b.mean()) / max(b.mean(), 1e-6)
    relc = [abs(a[..., c].mean() - b[..., c].mean())
            / max(b[..., c].mean(), 1e-6) for c in range(3)]
    log(f"ReSTIR DI unbiased (Cornell 32x32, 48 frames vs 192 spp): rel "
        f"{rel:.4f} (< 0.05), per channel {np.round(relc, 4)} (< 0.08)")
    check(rel < 0.05 and max(relc) < 0.08, "ReSTIR DI is biased")

    kw = dict(width=24, height=24, bounces=2, bsdf="lambert",
              traversal="wavefront", light_sampling="cdf", use_restir=True,
              use_restir_di=True, use_radiance_cache=True,
              cache_capacity=1 << 12)
    r = Renderer(sc, cam, RendererConfig(**kw))
    st = r.init_state()
    vals = []
    for _ in range(8):
        _, rad, st = r.step(st)
        vals.append(float(rad.mean()))
    ref = render(sc, cam, RenderConfig(width=24, height=24, bounces=2,
                                       bsdf="lambert", traversal="wavefront"),
                 spp=96).cpu().numpy()
    e_rel = abs(np.mean(vals) - ref.mean()) / max(ref.mean(), 1e-6)
    r = Renderer(sc, cam, RendererConfig(denoiser="svgf", **kw))
    st = r.init_state()
    for _ in range(3):
        d, _, st = r.step(st)
    d = d.cpu().numpy()
    log(f"composed energy (Cornell 24x24x2, 8 frames vs 96 spp): mean "
        f"{np.mean(vals):.5f} vs {ref.mean():.5f}, rel {e_rel:.4f} (< 0.3); "
        f"with SVGF: display in [{d.min():.3f}, {d.max():.3f}]")
    check(e_rel < 0.3, "the composed frame loses or gains energy")
    check(bool(np.isfinite(d).all()) and d.min() >= 0 and d.max() <= 1,
          "the composed SVGF display is not finite in [0, 1]")

    g = np.random.default_rng(11)
    C = 1 << 12
    N = C // 2
    pos = torch.from_numpy(g.uniform(-50, 50, (N, 3)).astype(np.float32)
                           ).to(DEVICE)
    nrm = torch.zeros((N, 3), device=DEVICE)
    nrm[:, 1] = 1.0
    cam0 = torch.zeros(3, device=DEVICE)
    h, key = rc.cache_cell(pos, nrm, cam0)
    cache = rc.RadianceCache.create(C, DEVICE)
    for _ in range(2):
        cache = rc.cache_update(cache, h, key, torch.ones((N, 3),
                                                          device=DEVICE),
                                torch.full((N,), rc.CONFIDENT_COUNT,
                                           device=DEVICE))
    _, hit = rc.cache_query(cache, pos, nrm, cam0)
    rate = float(hit.float().mean())
    log(f"cache contention (4096 slots, 2048 cells, two frames): hit rate "
        f"{rate:.4f} (> 0.9); gates {time.perf_counter() - t0:.1f} s")
    check(rate > 0.9, "cache probing loses entries under contention")
    results["composed_gates"] = dict(
        di_rel=float(rel), di_rel_channels=[float(x) for x in relc],
        energy_rel=float(e_rel), cache_hit_rate=rate)


def phase_composed_card_vs_cpu(results):
    """Two composed Cornell frames at 16x16 (Disney, light tree, SVGF, the
    cache with query bounce 1, ReSTIR GI and DI; the second moving the
    camera) on the card and on the CPU. The reservoirs keep a sample
    where u * wsum < w, which the card's rounding can flip: a lane may
    hold another sample only near a pick within 1e-5 of its threshold
    (or a spatial tap away from one), on at most 1% of the lanes, as
    tests/test_torch_composed.py holds the port against JAX; the
    displays agree within 1e-3 on >= 98% of pixels and in mean to 1e-3."""
    import torch
    from truetrace_tpu_torch.integrate import restir, restir_di
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    kw = dict(width=16, height=16, bounces=2, bsdf="disney",
              traversal="wavefront", light_sampling="tree", denoiser="svgf",
              use_restir=True, use_restir_di=True, use_radiance_cache=True,
              cache_query_bounce=1, cache_capacity=1 << 12)
    out = {}
    for dev in (DEVICE, "cpu"):
        sc, cam = cornell_scene(dev)
        near = {}
        origs = {m: m.keep for m in (restir_di, restir)}

        def watch(m):
            def keep(u, wsum, w):
                ws = torch.clamp(wsum, min=1e-20)
                n = ((u * ws - w).abs() < 1e-5 * ws).cpu()
                near[m] = n if m not in near else near[m] | n
                return origs[m](u, wsum, w)
            return keep
        for m in origs:
            m.keep = watch(m)
        try:
            r = Renderer(sc, cam, RendererConfig(**kw))
            st = r.init_state()
            frames = []
            for c, moved in ((None, None), (moved_camera(cam), True)):
                d, _, st = r.step(st, cam=c, cam_moved=moved)
                frames.append(d.cpu())
        finally:
            for m, f in origs.items():
                m.keep = f
        out[dev] = (frames, st, near)
    (fg, sg, ng), (fc, scpu, nc) = out[DEVICE], out["cpu"]
    flips = {}
    for name, m, fields, taps, seq in (
            ("restir_di", restir_di, ("pos", "ln", "rad"),
             restir_di.SPATIAL_TAPS, True),
            ("restir", restir, ("x2", "n2", "rad"), restir.SPATIAL_TAPS,
             False)):
        g, c = getattr(sg, name), getattr(scpu, name)
        pick = lambda s: torch.cat([getattr(s, f).cpu() for f in fields], -1)
        flip = ~torch.isclose(pick(g), pick(c), rtol=1e-5,
                              atol=1e-6).all(-1)
        reach = (ng[m] | nc[m]).numpy()
        passes = [taps] if seq else [[(dy * k, dx * k) for dy, dx in taps]
                                     for k in (1, 2)]
        for p in passes:
            if seq:
                for t in p:
                    reach = reach | np.roll(reach, t, (0, 1))
            else:
                reach = reach | np.any([np.roll(reach, t, (0, 1))
                                        for t in p], axis=0)
        flips[name] = int(flip.sum())
        check(float(flip.float().mean()) <= 0.01 and not bool(
            (flip.numpy() & ~reach).any()), f"card vs CPU: {name} "
            f"reservoirs differ on {flips[name]} lanes")
    shares = []
    for a, b in zip(fg, fc):
        shares.append(float(((a - b).abs() <= 1e-3).all(-1).float().mean()))
        rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        check(bool(torch.isfinite(a).all()) and shares[-1] >= 0.98
              and rel < 1e-3, f"composed card vs CPU: {shares[-1]:.4f} of "
              f"pixels within 1e-3, mean rel {rel:.2e}")
    ct = (float(sg.cache.count.sum()), float(scpu.cache.count.sum()))
    check(abs(ct[0] - ct[1]) <= 1e-5 * ct[1], f"cache totals {ct}")
    log(f"composed Cornell 16x16x2 card vs CPU, two frames: displays "
        f"{[round(x, 4) for x in shares]} of pixels within 1e-3; reservoir "
        f"lanes holding another sample (all near a threshold pick): "
        f"{flips}; cache count totals {ct}")
    results["composed_card_vs_cpu"] = dict(display_share=shares,
                                           flips=flips)


# ---------------------------------------------------------------------------
# phase 6: glass scenes (the transmittance kernel, the medium stack) and
# the temporal denoisers ASVGF and ReCur
# ---------------------------------------------------------------------------

# the frames of the slice, each FRAME's 512x512x4 atrium frame unless said
ASVGF = dict(FRAME, denoiser="asvgf")
RECUR = dict(FRAME, denoiser="recur")
COMPOSED_ASVGF = dict(COMPOSED, denoiser="asvgf")     # ReSTIR-ASVGF
# the JAX package's nested-glass showcase (scripts/demo.py:230-290) as
# that script renders it (10 bounces, roulette from bounce 6), with SVGF;
# the pcg sampler (the demo's blue noise is ROADMAP A.19)
GLASS = dict(FRAME, bounces=10, rr_start=6)


def nested_glass_scene(device: str):
    """scripts/demo.py's scene 6, built from numpy with the port: a
    floor, a brick-checker wall (a 32x32 texture tiled 4 times and turned
    30 degrees), a water block (ior 1.33) holding a rose glass sphere
    (ior 1.5), and a quad light. Returns (scene, camera)."""
    from truetrace_tpu_torch.scene.atlas import AtlasBuilder
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    from truetrace_tpu_torch.scene.primitives import transform, uv_sphere
    builder = AtlasBuilder()
    tex = np.zeros((32, 32, 3), np.float32)
    tex[...] = (0.65, 0.3, 0.22)                     # brick
    tex[::8] = (0.85, 0.82, 0.78)                    # mortar rows
    tex[:, ::8] = (0.85, 0.82, 0.78)
    brick = builder.add(tex)
    atlas, rects, level_y = builder.build()
    mats = [
        HostMaterial(base_color=(0.7, 0.7, 0.7), roughness=0.9),
        HostMaterial(base_color=(1, 1, 1), roughness=0.8, tex_albedo=brick,
                     uv_scale=(4.0, 4.0, 0.0, 0.0),
                     uv_rot=float(np.pi / 6)),
        HostMaterial(base_color=(0.8, 0.92, 1.0), roughness=0.02,
                     spec_trans=1.0, ior=1.33,
                     transmit_color=(0.75, 0.92, 1.0)),
        HostMaterial(base_color=(1.0, 0.85, 0.8), roughness=0.02,
                     spec_trans=1.0, ior=1.5,
                     transmit_color=(1.0, 0.55, 0.45)),
        HostMaterial(emission=(22.0, 21.0, 19.0)),
    ]
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    floor = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]],
                     np.float32)
    wall = np.array([[-4, 0, -2.5], [4, 0, -2.5], [4, 4, -2.5],
                     [-4, 4, -2.5]], np.float32)
    light = np.array([[-1, 3.9, 0.2], [1, 3.9, 0.2], [1, 3.9, 2.0],
                      [-1, 3.9, 2.0]], np.float32)
    sv, si, _ = uv_sphere(20, 30, radius=0.45)
    meshes = [
        HostMesh(floor, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                 np.zeros(2, np.int32)),
        HostMesh(wall, quad, np.ones(2, np.int32),
                 uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                              np.float32)),
        box_mesh((-1.0, 0.001, 0.0), (1.0, 1.6, 1.6), 2),
        HostMesh(transform(sv, translate=(0.0, 0.8, 0.8)), si,
                 np.full(len(si), 3, np.int32)),
        HostMesh(light, quad, np.full(2, 4, np.int32)),
    ]
    scene = compile_scene(meshes, mats, atlas=atlas, atlas_rects=rects,
                          atlas_level_y=level_y, with_cwbvh=True,
                          with_light_bvh=True, device=device)
    cam = Camera.look_at(eye=(0.2, 1.6, 5.2), target=(0, 1.0, 0.3),
                         fov_y_deg=42, device=device)
    return scene, cam


def box_mesh(lo, hi, mat_id):
    """Axis-aligned box, outward-facing triangles (tests/test_glass.py)."""
    from truetrace_tpu_torch.scene.mesh import HostMesh
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    v = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                  [0, 5, 4], [3, 6, 2], [3, 7, 6], [0, 4, 7], [0, 7, 3],
                  [1, 2, 6], [1, 6, 5]], np.int32)
    return HostMesh(v, f, np.full(len(f), mat_id, np.int32))


def quad_mesh(center, half, axis, mat_id, flip=False):
    """Axis-aligned quad with its normal along +axis (-axis when flip)
    (tests/test_glass.py)."""
    from truetrace_tpu_torch.scene.mesh import HostMesh
    a, b = [i for i in range(3) if i != axis]
    v = np.tile(np.asarray(center, np.float32), (4, 1))
    for i, (sa, sb) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        v[i, a] += sa * half
        v[i, b] += sb * half
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return HostMesh(v, f[:, ::-1].copy() if flip else f,
                    np.full(2, mat_id, np.int32))


# the glass Cornell box's extra materials: demo scene 2's coloured glass
# (Beer-Lambert interior) and gold metal, and a half cut-out pane
GLASS_MAT = dict(base_color=(0.55, 0.82, 0.95), roughness=0.02,
                 spec_trans=1.0, ior=1.5, scatter_dist=0.15)
METAL_MAT = dict(base_color=(0.95, 0.78, 0.4), metallic=1.0, roughness=0.15)
PANE_MAT = dict(base_color=(0.8, 0.8, 0.8), alpha=0.5)


def glass_cornell_host(mesh_cls, mat_cls, make_cornell, prim,
                       extra=(GLASS_MAT, METAL_MAT, PANE_MAT)):
    """The Cornell box with demo scene 2's glass and metal spheres
    (scripts/demo.py:68-90) and a horizontal cut-out pane under the
    light, from one package's HostMesh / HostMaterial, cornell.make and
    primitives (the port's here; the parity tests build the JAX
    package's scene from the same numbers). `extra` are the three added
    materials' fields. Returns (meshes, materials, camera)."""
    meshes, mats, cam = make_cornell()
    base = meshes[0]
    sv, si, _ = prim.uv_sphere(12, 18, radius=0.09)
    n0 = len(mats)
    mats = mats + [mat_cls(**m) for m in extra]
    pane = np.array([[0.12, 0.32, 0.12], [0.36, 0.32, 0.12],
                     [0.36, 0.32, 0.36], [0.12, 0.32, 0.36]], np.float32)
    off, ns = base.positions.shape[0], sv.shape[0]
    pos = np.concatenate([base.positions,
                          prim.transform(sv, translate=(0.40, 0.09, 0.14)),
                          prim.transform(sv, translate=(0.20, 0.09, 0.30)),
                          pane])
    idx = np.concatenate([base.indices, si + off, si + off + ns,
                          np.array([[0, 2, 1], [0, 3, 2]]) + off + 2 * ns])
    mid = np.concatenate([base.mat_id, np.full(len(si), n0),
                          np.full(len(si), n0 + 1), np.full(2, n0 + 2)])
    return [mesh_cls(pos.astype(np.float32), idx.astype(np.int32),
                     mid.astype(np.int32))], mats, cam


# the forest frame: an instanced scene (trees and moving lanterns scattered
# over a heightfield terrain) under the baked physical sky, traced with the
# two-level traversal; the lanterns bob between frames
# The full-size forest samples its lanterns by the power CDF: every
# lantern move rebuilds the light BVH on the host (as the JAX package's
# update_instance_transforms does), which over its 10,752 world light rows
# takes about a minute (scripts/torch_forest_build.py), and the forest
# path moves them 23 times. The small forests (phase_forest_card_vs_cpu,
# tests/test_torch_forest.py, the card tests) take the light tree.
FOREST = dict(FRAME, traversal="tlas", light_sampling="cdf")
FOREST_TREE = dict(FOREST, light_sampling="tree")
FOREST_SIZE = dict(n_hm=257, n_trees=2048, n_lanterns=64)
FOREST_SKY = dict(sun_dir=(0.4, 0.5, 0.3), sun_irradiance=25.0)
FOREST_BOB = 0.05       # the lanterns' bob (world units)
FOREST_MATS = (dict(base_color=(0.35, 0.45, 0.2), roughness=0.9),     # grass
               dict(base_color=(0.45, 0.38, 0.3), roughness=0.95),    # dirt
               dict(base_color=(0.3, 0.2, 0.12), roughness=0.8),      # bark
               dict(base_color=(0.15, 0.4, 0.12), roughness=0.6,
                    sheen=0.3),                                       # leaves
               dict(base_color=(0.0, 0.0, 0.0), emission=(6.0, 4.0, 2.0)))


def forest_host(mesh_cls, mat_cls, prim, terrain_mod, n_hm: int = 257,
                n_trees: int = 2048, n_lanterns: int = 64):
    """The forest from one package's HostMesh / HostMaterial, primitives
    and scene.terrain module (the port's here; tests/test_torch_forest.py
    builds the JAX package's from the same numbers): a demo_hills terrain
    (64 x 64 world units, heights to 6, grass and dirt blended by a
    slope-based alphamap as scripts/demo.py scene 4 makes one), source 0
    a tree (cylinder(24, 8) bark trunk, uv_sphere(24, 36) leaf crown),
    source 1 an emissive lantern (uv_sphere(8, 12, radius=0.25)),
    n_trees trees and n_lanterns lanterns scattered on the terrain (the
    lanterns raised 1.5). Returns (sources, materials, instances,
    (heightmap, make_terrain's keyword arguments), camera (eye, target,
    fov_y_deg))."""
    hm = terrain_mod.demo_hills(n_hm, seed=4)
    k = max(n_hm // 16, 1)
    slope = np.maximum(np.abs(np.gradient(hm, axis=0)),
                       np.abs(np.gradient(hm, axis=1)))
    am = np.zeros((16, 16, 4), np.float32)
    am[..., 1] = np.clip(slope[::k, ::k][:16, :16] * 40 * k, 0, 1)
    am[..., 0] = 1.0 - am[..., 1]
    ter = dict(origin=(-32.0, 0.0, -32.0), size_xz=(64.0, 64.0),
               mat_ids=[0, 1], alphamap=am, height_scale=6.0)
    tv, ti, _ = prim.cylinder(24, 8, radius=0.15, height=1.6)
    cv, ci, _ = prim.uv_sphere(24, 36, radius=0.9)
    tree = mesh_cls(
        np.concatenate([tv, prim.transform(cv, translate=(0, 2.1, 0))]
                       ).astype(np.float32),
        np.concatenate([ti, ci + len(tv)]).astype(np.int32),
        np.concatenate([np.full(len(ti), 2), np.full(len(ci), 3)]
                       ).astype(np.int32))
    lv, li, _ = prim.uv_sphere(8, 12, radius=0.25)
    lantern = mesh_cls(lv.astype(np.float32), li.astype(np.int32),
                       np.full(len(li), 4, np.int32))
    place = dict(origin=ter["origin"], size_xz=ter["size_xz"],
                 height_scale=ter["height_scale"])
    trees = terrain_mod.scatter_on_terrain(hm, n=n_trees, seed=3,
                                           max_slope=1.0, **place)
    lanterns = terrain_mod.scatter_on_terrain(hm, n=n_lanterns, source_id=1,
                                              seed=5, **place)
    for _, m in lanterns:
        m[3, 1] += 1.5
    mats = [mat_cls(**m) for m in FOREST_MATS]
    return ([tree, lantern], mats, trees + lanterns, (hm, ter),
            ((0.0, 14.0, 30.0), (0.0, 3.0, 0.0), 50.0))


def forest_bob(instances, frame: int):
    """The instances with every lantern (source 1) moved up by FOREST_BOB
    sin(frame + its index): their per-frame motion."""
    out = []
    for i, (src, m) in enumerate(instances):
        if src == 1:
            m = m.copy()
            m[3, 1] += FOREST_BOB * np.sin(frame + i)
        out.append((src, m))
    return out


def forest_scene(device: str, sky=None, with_light_bvh: bool = False,
                 **size):
    """forest_host's scene compiled by the port on `device`, its terrain
    attached (with the light BVH over the lanterns' world light rows
    where asked): (scene, InstancedScene, materials, instances,
    camera)."""
    import dataclasses
    from truetrace_tpu_torch.scene import primitives, terrain
    from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
    from truetrace_tpu_torch.scene.instances import compile_scene_instanced
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
    sources, mats, inst, (hm, ter), (eye, target, fov) = forest_host(
        HostMesh, HostMaterial, primitives, terrain, **size)
    if sky is None:
        sky = bake_sky_env(**FOREST_SKY, device=device)
    scene, isc = compile_scene_instanced(sources, mats, inst, env=sky,
                                         with_light_bvh=with_light_bvh,
                                         device=device)
    scene = dataclasses.replace(
        scene, terrain=terrain.make_terrain(hm, device=device, **ter))
    cam = Camera.look_at(eye, target, fov_y_deg=fov, device=device)
    return scene, isc, mats, inst, cam


def analytic_lights_host(lo, hi, counts=(4, 4, 4, 3, 1), seed: int = 0):
    """numpy fields of AnalyticLights (either package's from_numpy or
    constructor takes them) for counts[i] lights of each kind, in this
    order: soft points, spots, quads turned in plane by z_rot, disks and
    directional lights, all inside the box [lo, hi]. Spots and area
    lights face down within ~17 degrees; delta lights' intensities scale
    with the box's size squared, so their irradiance does not depend on
    it, and penumbrae and extents with its size."""
    from truetrace_tpu_torch.integrate.lights import (
        LIGHT_DIR, LIGHT_DISK, LIGHT_POINT, LIGHT_QUAD, LIGHT_SPOT)
    rs = np.random.RandomState(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    span = float(np.max(hi - lo))
    kinds = (LIGHT_POINT, LIGHT_SPOT, LIGHT_QUAD, LIGHT_DISK, LIGHT_DIR)
    ltype = np.repeat(np.asarray(kinds, np.int32), counts)
    K = ltype.shape[0]
    down = np.array([0.0, -1.0, 0.0]) + 0.3 * rs.normal(size=(K, 3))
    down[ltype == LIGHT_DIR] += (0.4, 0.0, 0.3)
    colour = rs.uniform(0.6, 1.0, (K, 3))
    delta = (ltype == LIGHT_POINT) | (ltype == LIGHT_SPOT)
    power = np.where(delta, 0.4 * span * span, np.where(
        ltype == LIGHT_DIR, 1.0, 6.0)) * rs.uniform(0.5, 1.5, K)
    inner = rs.uniform(0.85, 0.95, K)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        position=f32(lo + (hi - lo) * rs.uniform(size=(K, 3))),
        direction=f32(down / np.linalg.norm(down, axis=1, keepdims=True)),
        radiance=f32(colour * power[:, None]), ltype=ltype,
        spot_cos=f32(np.stack([inner, inner - rs.uniform(0.1, 0.3, K)], 1)),
        extent=f32(span * rs.uniform(0.03, 0.1, (K, 2))),
        softness=f32(np.where(ltype == LIGHT_DIR, rs.uniform(2.0, 8.0, K),
                              span * rs.uniform(0.2, 1.0, K))),
        z_rot=f32(np.where(ltype == LIGHT_QUAD, rs.uniform(0, np.pi, K),
                           0.0)))


def glass_cornell(device: str):
    """glass_cornell_host's scene, compiled by the port. Returns (scene,
    camera)."""
    from truetrace_tpu_torch.scene import cornell, primitives
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    meshes, mats, cam = glass_cornell_host(
        HostMesh, HostMaterial, lambda: cornell.make(device="cpu"),
        primitives)
    scene = compile_scene(meshes, mats, with_cwbvh=True,
                          with_light_bvh=True, device=device)
    return scene, cam.to(device)


def hold_transmit(scene, tint, ro, rd, tm, label: str, time_it=True):
    """The kernel against transmit_plain, bit for bit, on one ray set;
    the plain run counts the work, which sets the bound; with `time_it`
    the kernel's device time (device_ms), any hit's on the same rays (the
    opaque table does its work) and one plain run. Returns a dict."""
    import torch
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_wavefront, transmit_plain, transmit_wavefront)
    table, C, S = scene.cw_table(), scene.cw_nodes.shape[0], scene.cw_stack
    R = ro.shape[0]
    tk = transmit_wavefront(table, C, tint, ro, rd, tm, S)
    counts = {}
    tp = transmit_plain(table, C, tint, ro, rd, tm, S, counts)
    check(torch_equal_bits(tk, tp), f"transmit {label}: differs from plain "
          f"on {int((tk != tp).any(-1).sum())} of {R} rays")
    blocked, clear = (tp == 0).all(-1), (tp == 1).all(-1)
    shares = dict(blocked=float(blocked.float().mean()),
                  partial=float((~blocked & ~clear).float().mean()),
                  clear=float(clear.float().mean()))
    out = dict(rays=R, max_abs_err=max_abs_diff(tk, tp), shares=shares,
               work=traversal_work(counts, R, table.shape[1]))
    if time_it:
        out["ms"] = device_ms(lambda: transmit_wavefront(
            table, C, tint, ro, rd, tm, S), 20)
        out["any_hit_ms"] = device_ms(lambda: any_hit_wavefront(
            table, C, ro, rd, tm, S), 20)
        out["plain_ms"] = cuda_ms(lambda: transmit_plain(
            table, C, tint, ro, rd, tm, S), 1)
        out["share_of_bound"] = out["work"]["bound_ms"] / out["ms"]
        out.update({k: out["work"][k] for k in ("bound_ms", "bound_by")})
    log(f"transmit {label}: bit for bit equal to plain on {R} rays "
        f"(blocked {shares['blocked']:.3f}, partial {shares['partial']:.3f},"
        f" clear {shares['clear']:.3f}); {work_line(out['work'])}, "
        f"{out['work']['tinted_per_ray']:.2f} tinted triangles"
        + (f"; kernel {out['ms']:.5f} ms, any hit on the same rays "
           f"{out['any_hit_ms']:.5f} ms, plain {out['plain_ms']:.1f} ms, "
           f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}) = "
           f"{out['share_of_bound']:.3f} of the kernel's time"
           if time_it else ""))
    return out


def phase_transmit_atrium(results, scene, cam):
    """The transmittance kernel at the frame's 262144 lanes on the
    atrium (K = 6), bench.py's shadow rays: with a tint table of zeros
    (the any hit's work: every lane stops at its first surface) and with
    one that passes every third triangle at 0.8 (the pass-through path:
    lanes walk on through tinted surfaces)."""
    import torch
    R = FRAME["width"] * FRAME["height"]
    _, _, ro, rd, tm = bench_rays(scene, cam, R)
    T = scene.n_tris()
    opaque = torch.zeros((T, 3), device=scene.device)
    third = torch.where((torch.arange(T, device=scene.device) % 3 == 0)[
        :, None], 0.8, 0.0).expand(T, 3).contiguous()
    res = {}
    for name, tint in (("opaque", opaque), ("pass_third", third)):
        res[name] = hold_transmit(scene, tint, ro, rd, tm,
                                  f"atrium {name}")
    check(res["pass_third"]["shares"]["partial"] > 0.01,
          "transmit: the pass-through table passes no ray in part")
    results["transmit_atrium"] = res


def phase_transmit_glass(results, scene, cam):
    """The transmittance kernel on the nested-glass frame's own NEE
    shadow rays (its 10 bounces at 262144 lanes, grabbed from one eager
    frame): every bounce's rays bit for bit against plain; bounce 0's
    timed. Returns its result (the kernels line's row)."""
    from truetrace_tpu_torch.integrate import pathtrace
    seen = []
    orig = pathtrace._transmission

    def grab(sc, ro, rd, tm, cfg):
        seen.append((ro.clone(), rd.clone(), tm.clone()))
        return orig(sc, ro, rd, tm, cfg)

    r = make_renderer(scene, cam, GLASS)
    pathtrace._transmission = grab
    try:
        r.step(r.init_state())
    finally:
        pathtrace._transmission = orig
    check(len(seen) == GLASS["bounces"], f"glass frame: {len(seen)} "
          f"transmittance calls, not {GLASS['bounces']}")
    res = None
    for b, (ro, rd, tm) in enumerate(seen):
        out = hold_transmit(scene, scene.tri_shadow, ro, rd, tm,
                            f"glass NEE bounce {b}", time_it=b == 0)
        res = res or out
    check(res["shares"]["partial"] > 0.01, "glass frame: no NEE ray passes "
          "the glass in part")
    results["transmit_wavefront"] = res
    return res


def run_path(results, scene, cam, label: str, cfg: dict, hook=None):
    """A new frame's phases, as phase 3's: timed eager frames with their
    launch counts, the sync-free frames, the profile and the CUDA graphs
    (every state tensor bit for bit); hook(renderer, state), where
    given, after the profile. Returns the launches."""
    launches, r, state = phase_frame(results, scene, cam, label, cfg)
    state = phase_sync_free(r, state, cam, label)
    results[f"{label}_profile"] = phase_profile(r, state,
                                                label=f"{label} frame")
    if hook is not None:
        hook(r, state)
    del r, state
    phase_graph(results, scene, cam, label, cfg)
    return launches


def phase_asvgf_split(results, scene, cam):
    """Where the ASVGF frame's extra device time goes: its two parts
    profiled alone on one frame's own inputs (grabbed on the way), the
    stratum replay with its gradient chain (asvgf_gradient: a 4-bounce
    trace at (H/3)(W/3) lanes) and the LF/HF filter (asvgf_filter, SVGF
    inside)."""
    from truetrace_tpu_torch import renderer as rmod
    seen = {}
    origs = {f: getattr(rmod, f) for f in ("asvgf_gradient", "asvgf_filter")}

    def grab(name):
        def call(*a, **k):
            seen[name] = (a, k)
            return origs[name](*a, **k)
        return call

    r = make_renderer(scene, cam, ASVGF)
    state = r.init_state()
    _, _, state = r.step(state)
    for f in origs:
        setattr(rmod, f, grab(f))
    try:
        r.step(state)
    finally:
        for f, fn in origs.items():
            setattr(rmod, f, fn)
    res = {}
    for f, fn in origs.items():
        a, k = seen[f]
        res[f] = phase_profile(None, None, lambda: fn(*a, **k),
                               f"ASVGF's {f} alone")
    results["asvgf_split"] = res


def _furnace_cfg(**kw):
    from truetrace_tpu_torch.integrate.pathtrace import RenderConfig
    return RenderConfig(bsdf="disney", traversal="wavefront", use_nee=False,
                        **kw)


def phase_glass_gates(results):
    """The JAX package's glass, transmit-shadow, ASVGF and ReCur gates on
    the card through the port, at their thresholds. The glass gates
    render as many samples as the JAX tests (their 8x8 images at 512,
    256 and 96 spp) spread over more pixels at fewer spp (the camera's 2
    degrees see one material, so the mean estimates the same value):

    * tests/test_glass.py:65: a coloured slab's Beer-Lambert transmission
      against the analytic value, rtol 0.06, and blue absorbs;
    * tests/test_glass.py:96: a white glass box in a white furnace stays
      at 1, rtol 0.03;
    * tests/test_nested_glass.py:23: glass inside water against the
      analytic chain with the relative-eta Fresnel, rtol 0.08, nearer to
      it than to the absolute-eta value;
    * tests/test_shadow_transmit.py:74, 92, 106: stained glass tints the
      floor's direct light red and an opaque pane blocks it; an alpha 0.5
      pane gives half a shadow (within 0.1); an alpha 0 pane is invisible
      (rel < 0.03);
    * tests/test_asvgf.py:34, 51: ASVGF's gradient rises 2x on a 4x
      lighting change and its alpha with it; it converges faster than
      SVGF after a 6x change;
    * tests/test_recur.py:17, 38: ReCur cuts temporal variance (mean
      within 0.08, std < 0.06) and keeps a hard edge (dark < 0.35 of
      bright)."""
    import dataclasses
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render, render_sample_with_stats)
    from truetrace_tpu_torch.post import asvgf, recur, svgf
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.ir import Camera, EnvMap
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    t0 = time.perf_counter()
    out = {}
    build = lambda meshes, mats, **kw: compile_scene(
        meshes, mats, with_cwbvh=True, with_light_bvh=True, device=DEVICE,
        **kw)
    cam = Camera.look_at((0, 0, 1.0), (0, 0, -1.0), fov_y_deg=2.0,
                         device=DEVICE)

    def ext(color):
        app = np.clip(1.0 - np.asarray(color, np.float32), 0.0, 1.0)
        s = 1.9 - app + 3.5 * (app - 0.8) ** 2
        return np.where(app <= 0.0, 0.0, 1.0 / s)

    r0 = lambda n1, n2: ((n1 - n2) / (n1 + n2)) ** 2
    mean = lambda sc, cfg, spp: render(sc, cam, cfg, spp=spp).mean(
        (0, 1)).cpu().numpy()

    # slab Beer-Lambert (test_glass.py:65)
    color, E = (0.9, 0.5, 0.25), 4.0
    sc = build([box_mesh((-6, -6, -1.5), (6, 6, -1.0), 0),
                quad_mesh((0, 0, -4.0), 20.0, 2, 1)],
               [HostMaterial(base_color=color, roughness=0.02,
                             spec_trans=1.0, ior=1.5, specular=0.0,
                             scatter_dist=0.0),
                HostMaterial(base_color=(0, 0, 0), emission=(E, E, E))])
    got = mean(sc, _furnace_cfg(width=64, height=64, bounces=8, rr_start=8),
               8)
    a = np.exp(-ext(color) * 0.5)
    expect = E * (1 - r0(1, 1.5)) ** 2 * np.asarray(color) * a / (
        1 - r0(1, 1.5) ** 2 * a ** 2)
    out["slab"] = dict(got=got.tolist(), expect=expect.tolist())
    log(f"gate glass slab: {np.round(got, 4)} vs analytic "
        f"{np.round(expect, 4)} (rtol 0.06)")
    check(bool(np.all(np.abs(got - expect) <= 0.06 * np.abs(expect))),
          "glass slab: Beer-Lambert off the analytic value")
    check(got[2] < E * (1 - r0(1, 1.5)) ** 2 * color[2] * 0.75,
          "glass slab: blue does not absorb")

    # white furnace (test_glass.py:96)
    sc = build([box_mesh((-6, -6, -2.0), (6, 6, -1.0), 0)],
               [HostMaterial(base_color=(1, 1, 1), roughness=0.02,
                             spec_trans=1.0, ior=1.5, specular=0.0)],
               env=EnvMap.constant((1.0, 1.0, 1.0), DEVICE))
    got = mean(sc, _furnace_cfg(width=64, height=32, bounces=16,
                                rr_start=16), 8)
    out["furnace"] = got.tolist()
    log(f"gate white furnace: {np.round(got, 4)} (1 within rtol 0.03)")
    check(bool(np.all(np.abs(got - 1.0) <= 0.03)), "white glass furnace "
          "not neutral")

    # glass in water (test_nested_glass.py:23)
    cw, cg = np.array([0.85, 0.95, 0.7]), np.array([0.9, 0.6, 0.8])
    sc = build([box_mesh((-6, -6, -3.0), (6, 6, -0.5), 0),
                box_mesh((-5, -5, -2.0), (5, 5, -1.5), 1),
                quad_mesh((0, 0, -5.0), 20.0, 2, 2)],
               [HostMaterial(base_color=tuple(cw), roughness=0.02,
                             spec_trans=1.0, ior=1.33, specular=0.0),
                HostMaterial(base_color=tuple(cg), roughness=0.02,
                             spec_trans=1.0, ior=1.5, specular=0.0),
                HostMaterial(base_color=(0, 0, 0), emission=(E, E, E))])
    got = mean(sc, _furnace_cfg(width=32, height=24, bounces=10,
                                rr_start=10), 8)
    fr = (1 - r0(1.0, 1.33)) ** 2 * (1 - r0(1.33, 1.5)) ** 2
    expect = E * fr * cw * cg * np.exp(-ext(cw) * 2.0) * np.exp(
        -ext(cg) * 0.5)
    wrong = expect / (1 - r0(1.33, 1.5)) ** 2 * (1 - r0(1.0, 1.5)) ** 2
    out["nested"] = dict(got=got.tolist(), expect=expect.tolist())
    log(f"gate glass in water: {np.round(got, 4)} vs analytic "
        f"{np.round(expect, 4)} (rtol 0.08; absolute-eta "
        f"{np.round(wrong, 4)})")
    check(bool(np.all(np.abs(got - expect) <= 0.08 * np.abs(expect))),
          "glass in water off the analytic chain")
    check(bool(np.all(np.abs(got - expect) < np.abs(got - wrong))),
          "glass in water: nearer the absolute-eta Fresnel")

    # stained glass and cutout shadows (test_shadow_transmit.py)
    def pane_scene(pane_mat, with_pane=True):
        def q(y, half, mat, down=False):
            pos = np.array([[-half, y, -half], [half, y, -half],
                            [half, y, half], [-half, y, half]], np.float32)
            idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
            return HostMesh(pos, idx if down else idx[:, ::-1].copy(),
                            np.full(2, mat, np.int32))
        meshes = [q(0.0, 3.0, 0), q(4.0, 0.7, 1, down=True)]
        mats = [HostMaterial(base_color=(0.75, 0.75, 0.75)),
                HostMaterial(emission=(20.0, 20.0, 20.0))]
        if with_pane:
            meshes.append(q(2.0, 2.0, 2, down=True))
            mats.append(pane_mat)
        return build(meshes, mats)

    pcam = Camera.look_at(eye=(0, 2.2, 6.0), target=(0, 0.3, 0),
                          fov_y_deg=40, device=DEVICE)
    lam = lambda n, b: RenderConfig(width=n, height=n, bounces=b,
                                    bsdf="lambert", traversal="wavefront",
                                    light_sampling="cdf")
    img = lambda sc, cfg, spp: render(sc, pcam, cfg, spp=spp).cpu().numpy()
    fr_ = img(pane_scene(HostMaterial(base_color=(0.9, 0.05, 0.05),
                                      spec_trans=1.0)), lam(32, 1), 32)[
        20:].mean((0, 1))
    fo = img(pane_scene(HostMaterial(base_color=(0.9, 0.05, 0.05))),
             lam(32, 1), 32)[20:].mean((0, 1))
    fh = img(pane_scene(HostMaterial(alpha=0.5)), lam(32, 1), 64)[20:].mean()
    fn = img(pane_scene(HostMaterial(alpha=0.0)), lam(32, 1), 64)[20:].mean()
    a0 = img(pane_scene(HostMaterial(alpha=0.0)), lam(24, 2), 48).mean()
    b0 = img(pane_scene(None, with_pane=False), lam(24, 2), 48).mean()
    out["shadow"] = dict(red=fr_.tolist(), opaque=fo.tolist(),
                         half=float(fh / max(fn, 1e-6)),
                         invisible_rel=float(abs(a0 - b0) / b0))
    log(f"gate stained glass floor {np.round(fr_, 4)} (red > 4x green), "
        f"opaque pane {np.round(fo, 4)}; alpha 0.5 pane "
        f"{out['shadow']['half']:.4f} of no pane (0.5 within 0.1); alpha 0 "
        f"pane vs none rel {out['shadow']['invisible_rel']:.4f} (< 0.03)")
    check(fr_[0] > 4.0 * max(fr_[1], 1e-5), "stained glass: floor not red")
    check(fr_[0] > 5.0 * max(fo[0], 1e-5), "opaque pane does not block")
    check(abs(out["shadow"]["half"] - 0.5) < 0.1, "alpha 0.5 pane is not "
          "half a shadow")
    check(b0 > 0.01 and out["shadow"]["invisible_rel"] < 0.03,
          "alpha 0 pane is not invisible")

    # ASVGF (test_asvgf.py:34, 51): the Cornell box at 33x33, 2 bounces
    meshes, mats, ccam = cornell.make(device="cpu")
    sc = build(meshes, mats)
    ccam = ccam.to(DEVICE)
    cfg = RenderConfig(width=33, height=33, bounces=2,
                       traversal="wavefront")

    def brighter(s, k):
        return dataclasses.replace(s, materials=dataclasses.replace(
            s.materials, emission=s.materials.emission * k))

    st = asvgf.ASVGFState.create(33, 33, DEVICE)
    for s in range(3):
        _, st, aux0 = asvgf.asvgf_step(sc, ccam, cfg, st, s)
    _, st, aux1 = asvgf.asvgf_step(brighter(sc, 4.0), ccam, cfg, st, 3)
    g0, g1 = float(aux0["gradient"].mean()), float(aux1["gradient"].mean())
    al0, al1 = float(aux0["alpha"].mean()), float(aux1["alpha"].mean())
    bright = brighter(sc, 6.0)
    target = float(render(bright, ccam, cfg, spp=48).mean())
    a_st = asvgf.ASVGFState.create(33, 33, DEVICE)
    s_st = svgf.SVGFState.create(33, 33, DEVICE)
    pix = torch.arange(33 * 33, device=DEVICE)
    a_m, s_m = [], []
    for s in range(10):
        scn = sc if s < 5 else bright
        o_a, a_st, _ = asvgf.asvgf_step(scn, ccam, cfg, a_st, s)
        rad, gs = render_sample_with_stats(scn, ccam, cfg, pix, s)
        o_s, s_st = svgf.svgf_denoise(
            rad.reshape(33, 33, 3), gs["albedo"].reshape(33, 33, 3),
            gs["normal"].reshape(33, 33, 3), gs["depth"].reshape(33, 33),
            s_st)
        a_m.append(float(o_a.mean()))
        s_m.append(float(o_s.mean()))
    lag_a = sum(abs(a_m[i] - target) for i in (5, 6, 7))
    lag_s = sum(abs(s_m[i] - target) for i in (5, 6, 7))
    out["asvgf"] = dict(gradient=[g0, g1], alpha=[al0, al1], lag=[lag_a,
                                                                  lag_s])
    log(f"gate ASVGF: gradient mean {g0:.4f} -> {g1:.4f} on a 4x light "
        f"(> 2x), alpha {al0:.4f} -> {al1:.4f}; lag over frames 5-7 after "
        f"a 6x light {lag_a:.4f} vs SVGF {lag_s:.4f}")
    check(g1 > 2.0 * g0 and al1 > al0, "ASVGF misses a lighting change")
    check(lag_a < lag_s, "ASVGF adapts no faster than SVGF")

    # ReCur (test_recur.py:17, 38): denoiser-only, 32x32
    n = torch.zeros((32, 32, 3), device=DEVICE)
    n[..., 2] = 1.0
    depth = torch.full((32, 32), 5.0, device=DEVICE)
    albedo = torch.full((32, 32, 3), 0.5, device=DEVICE)
    g = np.random.default_rng(0)
    st = recur.ReCurState.create(32, 32, DEVICE)
    for _ in range(24):
        noisy = torch.from_numpy(g.exponential(0.4, (32, 32, 3)).astype(
            np.float32)).to(DEVICE)
        o, st = recur.recur_denoise(noisy, albedo, n, depth, st)
    o = o.cpu().numpy()
    n[:, :16, 0], n[:, :16, 2] = 1.0, 0.0
    g = np.random.default_rng(1)
    st = recur.ReCurState.create(32, 32, DEVICE)
    base = np.ones((32, 32, 3), np.float32)
    base[:, :16] *= 0.1
    for _ in range(16):
        noisy = torch.from_numpy(base * g.exponential(1.0, (32, 32, 3))
                                 .astype(np.float32)).to(DEVICE)
        e, st = recur.recur_denoise(noisy, albedo, n, depth, st)
    e = e.cpu().numpy()
    edge = float(e[:, :14].mean() / e[:, 18:].mean())
    out["recur"] = dict(mean=float(o.mean()), std=float(o.std()), edge=edge)
    log(f"gate ReCur: mean {o.mean():.4f} (0.4 within 0.08), std "
        f"{o.std():.4f} (< 0.06); edge dark/bright {edge:.4f} (< 0.35); "
        f"gates {time.perf_counter() - t0:.1f} s")
    check(bool(np.isfinite(o).all()) and abs(o.mean() - 0.4) < 0.08
          and o.std() < 0.06, "ReCur does not cut temporal variance")
    check(edge < 0.35, "ReCur blurs across an edge")
    results["glass_gates"] = out


def phase_glass_card_vs_cpu(results):
    """Two glass + ASVGF frames of the Cornell box with spheres and a
    cut-out pane (tests/test_torch_glass.py's scene, 16x16, 3 bounces,
    Disney, the light tree; the second moving the camera) on the card and
    on the CPU: the displays within 1e-3 on >= 98% of pixels and in mean
    to 1e-3 (ROADMAP §C: the glass facets turn last-ulp differences into
    other paths on a few lanes)."""
    import torch
    kw = dict(width=16, height=16, bounces=3, bsdf="disney",
              traversal="wavefront", light_sampling="tree", denoiser="asvgf")
    frames = {}
    for dev in (DEVICE, "cpu"):
        sc, cam = glass_cornell(dev)
        r = make_renderer(sc, cam, kw)
        st = r.init_state()
        frames[dev] = []
        for c, moved in ((None, None), (moved_camera(cam), True)):
            d, _, st = r.step(st, cam=c, cam_moved=moved)
            frames[dev].append(d.cpu())
    shares = []
    for a, b in zip(frames[DEVICE], frames["cpu"]):
        shares.append(float(((a - b).abs() <= 1e-3).all(-1).float().mean()))
        rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
        check(bool(torch.isfinite(a).all()) and shares[-1] >= 0.98
              and rel < 1e-3, f"glass card vs CPU: {shares[-1]:.4f} of "
              f"pixels within 1e-3, mean rel {rel:.2e}")
    log(f"glass + ASVGF Cornell 16x16x3 card vs CPU, two frames: displays "
        f"{[round(x, 4) for x in shares]} of pixels within 1e-3")
    results["glass_card_vs_cpu"] = dict(display_share=shares)


# ---------------------------------------------------------------------------
# phase 7: the post chain, TAAU with partial rendering under analytic
# lights, and the neural denoiser
# ---------------------------------------------------------------------------

# the JAX package's recorded frame's post chain (scripts/profile_frame.py
# :143: ACES, bloom 0.08, CAS 0.3) with temporal auto exposure, on FRAME
POST_CHAIN = dict(tonemap="aces", bloom_strength=0.08, sharpen=0.3,
                  auto_expose=True)
POST_FRAME = dict(FRAME, post=POST_CHAIN)
# interactivity on a large display: sponza_like with 16 analytic lights,
# half the pixels of a 512x512 frame traced a frame (partial_rendering
# 2: FRAME's lanes over two frames), TAAU to 1024x1024, SVGF
INTERACTIVE = dict(FRAME, width=1024, height=1024, upscale=2,
                   partial_rendering=2)
# the in-repo U-Net checkpoint with its temporal blend, on FRAME
NEURAL = dict(FRAME, denoiser="neural_taa", neural_weights=os.path.join(
    HERE, "examples", "denoiser.msgpack"))
# a tonemap on the card against the same function on the CPU (rtol and
# atol): log2, pow and the AgX matrices round their last ulps apart
TONEMAP_TOL = 1e-5


def sponza_lit(scene, meshes):
    """sponza_like's scene with analytic_lights_host's 16 lights inside
    its bounds (within its walls, in its lower part)."""
    import dataclasses
    from truetrace_tpu_torch.scene.ir import AnalyticLights
    pos = np.concatenate([np.asarray(m.positions) for m in meshes])
    lo, hi = pos.min(0), pos.max(0)
    span = hi - lo
    box = (lo + span * (0.15, 0.1, 0.15), hi - span * (0.15, 0.4, 0.15))
    return dataclasses.replace(scene, lights=AnalyticLights.from_numpy(
        analytic_lights_host(*box), scene.device))


def phase_post_tonemaps(results, hdr):
    """The post frame's accumulated HDR image through every other
    tonemap and a 33^3 LUT baked from AgX (apply_lut3d), on the card
    against the same function on the CPU, each timed on the card."""
    import torch
    from truetrace_tpu_torch.post import pipeline as pp
    cpu = hdr.cpu()
    lut = pp.bake_tonemap_lut("agx", 33, device=hdr.device)
    lut_cpu = pp.bake_tonemap_lut("agx", 33, device="cpu")
    fns = {n: (lambda f=pp._TONEMAPS[n]: f(hdr), pp._TONEMAPS[n](cpu))
           for n in ("reinhard", "agx", "agx_punchy", "agx_golden", "none")}
    fns["lut3d"] = (lambda: pp.apply_lut3d(hdr, lut),
                    pp.apply_lut3d(cpu, lut_cpu))
    res = {}
    for name, (card, host) in fns.items():
        a = card().cpu()
        res[name] = dict(
            max_abs_err=float((a - host).abs().max()), ms=cuda_ms(card, 20),
            close=bool(torch.allclose(a, host, rtol=TONEMAP_TOL,
                                      atol=TONEMAP_TOL)))
    lut_err = float((lut.cpu() - lut_cpu).abs().max())
    log(f"post frame's HDR image ({tuple(hdr.shape)}, mean "
        f"{float(hdr.mean()):.4f}) through each tonemap, card vs CPU: "
        + ", ".join(f"{n} {r['max_abs_err']:.2e} ({r['ms']:.4f} ms)"
                    for n, r in res.items())
        + f"; the 33^3 AgX LUT's bake {lut_err:.2e}")
    for name, r in res.items():
        check(r["close"], f"tonemap {name}: card and CPU differ by "
              f"{r['max_abs_err']:.2e}")
    check(lut_err <= TONEMAP_TOL, f"baked LUT: card and CPU differ by "
          f"{lut_err:.2e}")
    results["post_tonemaps"] = dict(res, lut_bake_max_abs_err=lut_err)


def phase_unet(results, model, hdr):
    """The neural frame's U-Net alone at the frame's size (denoise on its
    HDR image as colour, albedo and normal: the values do not change
    the work), on the device alone (device_ms), against its float32
    bound: 2 operations a multiply-add of its eleven 3x3 convolutions
    over 67 TFLOP/s (no TF32, so no tensor cores)."""
    from truetrace_tpu_torch.post.neural import denoise
    H, W = hdr.shape[:2]
    flops = 0
    for m in model.modules():
        if hasattr(m, "kernel_size"):
            s = 1 << (2 * _unet_level(m, model))
            flops += 2 * 9 * m.in_channels * m.out_channels * H * W // s
    # ~60 kernels a call: few calls, so the launch queue never fills
    ms = device_ms(lambda: denoise(model, hdr, hdr, hdr), reps=8)
    res = dict(ms=ms, gflop=flops / 1e9, bound_ms=1e3 * flops / PEAK_F32,
               bound_by="operations")
    res["share_of_bound"] = res["bound_ms"] / ms
    log(f"neural U-Net alone at {H}x{W}: {ms:.4f} ms on the device, "
        f"{res['gflop']:.2f} GFLOP, bound {res['bound_ms']:.4f} ms "
        f"({100 * res['share_of_bound']:.1f}%)")
    results["unet"] = res


def _unet_level(conv, model) -> int:
    """The resolution level (0 full, 1 half, 2 quarter) a convolution of
    the U-Net runs at."""
    for i, blk in enumerate(model.blocks):
        if conv in (blk.conv0, blk.conv1):
            return (0, 1, 2, 1, 0)[i]
    return 0


def render_image(scene, cam, W: int, H: int, spp: int, base: int = 0,
                 **cfg):
    """[H,W,3] numpy mean of `spp` samples a pixel (ids from `base`),
    traced in batches of 256 samples (sample ids are per-lane counters,
    so this equals the JAX package's `render`)."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample_with_stats)
    c = RenderConfig(width=W, height=H, **{"traversal": "wavefront", **cfg})
    acc = torch.zeros((W * H, 3), device=scene.device)
    for s0 in range(0, spp, 256):
        b = min(256, spp - s0)
        pix = torch.arange(W * H, device=scene.device).repeat(b)
        sid = torch.arange(base + s0, base + s0 + b, device=scene.device
                           ).repeat_interleave(W * H)
        rad, _ = render_sample_with_stats(scene, cam, c, pix, sid)
        acc += rad.view(b, W * H, 3).sum(0)
    img = (acc / spp).view(H, W, 3).cpu().numpy()
    check(bool(np.isfinite(img).all()), "render not finite")
    return img


def _lights_np(n: int, **kw):
    """numpy AnalyticLights fields of n lights, every field given or
    its default (a point light straight down, no softness)."""
    one = dict(position=(0.0, 2.5, 0.0), direction=(0.0, -1.0, 0.0),
               radiance=(30.0, 30.0, 30.0), ltype=0, spot_cos=(0.9, 0.7),
               extent=(0.3, 0.3), softness=0.0, z_rot=0.0)
    out = {}
    for k, v in one.items():
        a = np.asarray(kw.get(k, [v] * n))
        out[k] = a.astype(np.int32 if k == "ltype" else np.float32)
    return out


def grid_lights(n: int = 64, seed: int = 0, bright_k: int = 2):
    """tests/test_analytic_ris.py's lights: n point lights on a grid high
    above the floor, most dim, bright_k dominant."""
    rs = np.random.RandomState(seed)
    side = int(np.sqrt(n))
    xs, zs = np.meshgrid(np.linspace(-6, 6, side), np.linspace(-6, 6, side))
    power = rs.uniform(0.02, 0.2, n)
    power[rs.choice(n, bright_k, replace=False)] = 25.0
    return _lights_np(n, position=np.stack([xs.ravel(), np.full(n, 3.0),
                                            zs.ravel()], -1),
                      radiance=np.stack([power, power * 0.9, power * 0.8],
                                        -1))


def _floor_scene(lights: dict, half: float, blocker: bool = False):
    """A grey Lambert floor quad of half-size `half` (and a 1x1 blocker
    quad 0.8 above its centre), lit by `lights` only."""
    from truetrace_tpu_torch.scene.ir import AnalyticLights
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    h = half
    quads = [np.array([[-h, 0, -h], [h, 0, -h], [h, 0, h], [-h, 0, h]],
                      np.float32)]
    if blocker:
        quads.append(np.array([[-0.5, 0.8, -0.5], [0.5, 0.8, -0.5],
                               [0.5, 0.8, 0.5], [-0.5, 0.8, 0.5]],
                              np.float32))
    fi = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    return compile_scene(
        [HostMesh(q, fi, np.zeros(2, np.int32)) for q in quads],
        [HostMaterial(base_color=(0.8, 0.8, 0.8), roughness=1.0)],
        lights=AnalyticLights.from_numpy(lights, DEVICE), with_cwbvh=True,
        device=DEVICE)


def phase_modes_gates(results):
    """The JAX package's checks of this slice's parts, rerun with the
    port on the card at those tests' sizes: tests/test_analytic_ris.py
    (RIS unbiased against uniform selection, its variance cut at 64
    lights, the target weight, the reservoir's pick),
    tests/test_light_softness.py (point and directional penumbrae, the
    quad's z_rot), tests/test_post.py::test_taau_reconstructs_subpixel_
    detail and tests/test_partial_exposure.py::test_partial_converges_
    to_full and ::test_temporal_exposure_adapts_smoothly (the traversal
    is the wavefront CWBVH where those tests took the BVH2)."""
    import torch
    from truetrace_tpu_torch.integrate.lights import (
        analytic_target_weight, sample_analytic_ris)
    from truetrace_tpu_torch.post.pipeline import (
        auto_exposure_temporal, taau_jitter, taau_upscale)
    from truetrace_tpu_torch.scene.ir import AnalyticLights, Camera
    g = {}
    # ---- RIS (tests/test_analytic_ris.py)
    scene = _floor_scene(grid_lights(), 8.0)
    cam = Camera.look_at((0, 7.0, 0.01), (0, 0, 0), fov_y_deg=55,
                         device=DEVICE)
    img = lambda ris, spp, base=0: render_image(
        scene, cam, 32, 32, spp, base, bounces=1, bsdf="lambert",
        analytic_ris=ris)
    a, b = img(8, 512), img(0, 2048)
    g["ris_mean_rel"] = float(abs(a.mean() - b.mean()) / b.mean())
    g["ris_pixel_rel"] = float(np.abs(a - b).mean() / b.mean())
    ref = img(8, 768)
    g["mse_ris"] = float(np.mean((img(8, 8, 1000) - ref) ** 2))
    g["mse_uniform"] = float(np.mean((img(0, 8, 1000) - ref) ** 2))
    check(g["ris_mean_rel"] < 0.03 and g["ris_pixel_rel"] < 0.15,
          f"RIS against uniform: {g}")
    check(g["mse_ris"] < 0.4 * g["mse_uniform"], f"RIS variance: {g}")
    four = AnalyticLights.from_numpy(grid_lights(4, bright_k=1), DEVICE)
    w = analytic_target_weight(four, torch.arange(4, device=DEVICE),
                               torch.zeros((4, 3), device=DEVICE))
    bright = int(four.radiance[:, 0].argmax())
    check(bool((w > 0).all()) and int(w.argmax()) == bright,
          f"target weights {w.tolist()}")
    sixteen = AnalyticLights.from_numpy(grid_lights(16, bright_k=1), DEVICE)
    rs = np.random.RandomState(1)
    u = lambda *s: torch.from_numpy(rs.uniform(size=s).astype(
        np.float32)).to(DEVICE)
    R = 4096
    s = sample_analytic_ris(sixteen, torch.zeros((R, 3), device=DEVICE),
                            u(R, 8), u(R, 8), u(R, 2))
    bpos = sixteen.position[int(sixteen.radiance[:, 0].argmax())]
    g["ris_pick_bright"] = float(((s.wi @ (bpos / bpos.norm())) > 0.999)
                                 .float().mean())
    check(g["ris_pick_bright"] > 0.3 and bool(torch.isfinite(s.pmf).all()),
          f"the reservoir's pick: {g['ris_pick_bright']}")
    # ---- softness and z_rot (tests/test_light_softness.py)
    cam = Camera.look_at((0, 5.5, 0.01), (0, 0, 0), fov_y_deg=50,
                         device=DEVICE)

    def render(lights, spp=96, blocker=True):
        return render_image(_floor_scene(lights, 4.0, blocker), cam, 48, 48,
                            spp, bounces=1, bsdf="lambert")

    def penumbra(lights):
        lum = render(lights).mean(-1)
        lum0 = render(lights, blocker=False).mean(-1)
        ok = lum0 > 1e-3
        v = np.where(ok, lum / np.maximum(lum0, 1e-6), 1.0)
        return int(((v > 0.12) & (v < 0.88) & ok).sum())

    hard = _lights_np(1, position=[(2.0, 2.0, 0.0)])
    soft = _lights_np(1, position=[(2.0, 2.0, 0.0)], softness=[6.0])
    g["point_penumbra"] = (penumbra(hard), penumbra(soft))
    lum_h, lum_s = render(hard).mean(), render(soft).mean()
    check(g["point_penumbra"][1] > 1.5 * g["point_penumbra"][0] + 4
          and abs(lum_s - lum_h) < 0.15 * lum_h,
          f"point softness: penumbra px {g['point_penumbra']}, mean "
          f"{lum_h:.4f} -> {lum_s:.4f}")
    d = [(-0.55, -1.0, 0.0)]
    g["dir_penumbra"] = (
        penumbra(_lights_np(1, ltype=[1], direction=d)),
        penumbra(_lights_np(1, ltype=[1], direction=d, softness=[45.0])))
    check(g["dir_penumbra"][1] > 1.5 * g["dir_penumbra"][0] + 4,
          f"directional softness: penumbra px {g['dir_penumbra']}")

    def spread(im):
        lum = im.mean(-1)
        lit = np.percentile(lum[lum > 0], 90)
        ys, xs = np.nonzero((lum > 0.2 * lit) & (lum < 0.8 * lit))
        return float(np.var(xs)), float(np.var(ys))

    quad = dict(ltype=[3], extent=[(0.9, 0.1)])
    ax, ay = spread(render(_lights_np(1, **quad), spp=128))
    bx, by = spread(render(_lights_np(1, z_rot=[np.pi / 2], **quad),
                           spp=128))
    g["quad_spread"] = ((ax, ay), (bx, by))
    check((ax - ay) * (bx - by) < 0, f"quad z_rot: spreads {g['quad_spread']}")
    # ---- TAAU (tests/test_post.py)
    scale, h, w = 2, 24, 24
    pat = lambda py, px: np.repeat((0.5 + 0.5 * np.sin(
        (px + 2.0 * py) * (2 * np.pi / 6.0)))[..., None], 3, -1
    ).astype(np.float32)
    yy, xx = np.mgrid[0:h * scale, 0:w * scale]
    ly, lx = np.mgrid[0:h, 0:w]
    hist = None
    for i in range(48):
        j = taau_jitter(torch.tensor(i, device=DEVICE))
        jx, jy = (float(v) for v in j)
        low = torch.from_numpy(pat((ly + jy) * scale, (lx + jx) * scale))
        out, hist = taau_upscale(low.to(DEVICE), hist, scale=scale,
                                 jitter=j, alpha=0.35)
    g["taau_err"] = float(np.abs(out.cpu().numpy()
                                 - pat(yy + 0.5, xx + 0.5)).mean())
    box = np.repeat(np.repeat(pat((ly + 0.5) * scale, (lx + 0.5) * scale),
                              scale, 0), scale, 1)
    g["taau_box_err"] = float(np.abs(box - pat(yy + 0.5, xx + 0.5)).mean())
    check(g["taau_err"] < 0.5 * g["taau_box_err"], f"TAAU detail: {g}")
    # ---- partial rendering and exposure (tests/test_partial_exposure.py)
    sc, cam = cornell_scene(DEVICE)

    def run(k, frames):
        r = make_renderer(sc, cam, dict(
            width=32, height=32, bounces=2, bsdf="lambert",
            traversal="wavefront", light_sampling="cdf",
            partial_rendering=k))
        st = r.init_state()
        for _ in range(frames):
            _, rad, st = r.step(st)
        return rad.cpu().numpy()

    full, part, early = run(1, 8), run(4, 11), run(4, 2)
    ze, zp = (early.mean(-1) == 0).mean(), (part.mean(-1) == 0).mean()
    g["partial"] = dict(zero_early=float(ze), zero_after=float(zp),
                        mean_full=float(full.mean()),
                        mean_partial=float(part.mean()))
    check(bool(np.isfinite(part).all()) and zp < 0.2 and zp < ze - 0.2
          and abs(part.mean() - full.mean()) <= 0.1 * full.mean(),
          f"partial rendering: {g['partial']}")
    bright = torch.ones((16, 16, 3), device=DEVICE) * 4.0
    dim = torch.ones((16, 16, 3), device=DEVICE) * 0.05
    cold = torch.full((), -1.0, device=DEVICE)
    _, e0 = auto_exposure_temporal(bright, cold)
    _, e1 = auto_exposure_temporal(bright, e0)
    _, et = auto_exposure_temporal(dim, cold)
    _, es = auto_exposure_temporal(dim, e0)
    e = e0
    for _ in range(400):
        _, e = auto_exposure_temporal(dim, e)
    e0, e1, et, es, e = (float(v) for v in (e0, e1, et, es, e))
    g["exposure"] = dict(cold=e0, steady=e1, target=et, step=es, after=e)
    check(e0 > 0 and abs(e1 - e0) < 0.02 * e0
          and 0.0 < abs(es - e0) < 0.1 * abs(et - e0) + 1e-6
          and abs(e - et) < 0.1 * abs(et), f"exposure: {g['exposure']}")
    log(f"analytic-light, TAAU, partial-rendering and exposure gates on "
        f"the card: {g}")
    results["modes_gates"] = g


def phase_modes_card_vs_cpu(results):
    """Each new path's configuration at 16x16 on the Cornell box (2
    bounces, Disney, the light tree; "interactive" with 16 analytic
    lights in the box, TAAU traced at 8x8), two frames (the second
    moving the camera), on the card and on the CPU: the displays within
    1e-3 on >= 98% of pixels and in mean to 1e-3. No path has ReSTIR on,
    so no reservoir rule is needed."""
    import dataclasses
    import torch
    from truetrace_tpu_torch.scene.ir import AnalyticLights
    small = dict(width=16, height=16, bounces=2, bsdf="disney",
                 traversal="wavefront", light_sampling="tree")
    cfgs = {"post": dict(small, denoiser="svgf", post=POST_CHAIN),
            "interactive": dict(small, denoiser="svgf", upscale=2,
                                partial_rendering=2),
            "neural": dict(small, denoiser="neural_taa",
                           neural_weights=NEURAL["neural_weights"])}
    lights = analytic_lights_host((0.05, 0.25, 0.05), (0.5, 0.5, 0.5))
    out = {}
    for label, cfg in cfgs.items():
        frames = {}
        for dev in (DEVICE, "cpu"):
            sc, cam = cornell_scene(dev)
            if label == "interactive":
                sc = dataclasses.replace(sc, lights=AnalyticLights.from_numpy(
                    lights, dev))
            r = make_renderer(sc, cam, cfg)
            st = r.init_state()
            frames[dev] = []
            for c, moved in ((None, None), (moved_camera(cam), True)):
                d, _, st = r.step(st, cam=c, cam_moved=moved)
                frames[dev].append(d.cpu())
        shares = []
        for a, b in zip(frames[DEVICE], frames["cpu"]):
            shares.append(float(((a - b).abs() <= 1e-3).all(-1).float()
                                .mean()))
            rel = abs(float(a.mean()) - float(b.mean())) / float(b.mean())
            check(bool(torch.isfinite(a).all()) and shares[-1] >= 0.98
                  and rel < 1e-3, f"{label} card vs CPU: {shares[-1]:.4f} "
                  f"of pixels within 1e-3, mean rel {rel:.2e}")
        out[label] = dict(display_share=shares)
    log(f"post, interactive and neural Cornell 16x16x2 card vs CPU, two "
        f"frames: display shares within 1e-3 "
        f"{ {k: [round(x, 4) for x in v['display_share']] for k, v in out.items()} }")
    results["modes_card_vs_cpu"] = out


# ---------------------------------------------------------------------------
# phase 8: instanced scenes and terrain (the forest frame)
# ---------------------------------------------------------------------------

OPS_ENTER = 40        # an instance entry: 2 x 3 W2L rows (fma) and the
                      # translation, the squared length, sqrt, 3 divisions,
                      # 3 reciprocals and the push
OPS_HM_SAMPLE = 37    # one bilinear height sample of the march: the grid
                      # coordinates (10), weights (6), the blend (9), the
                      # ray point and f (7), the step and the sign test (5)


def tinted_tlas_host(mesh_cls, mat_cls, make_transform):
    """tests/test_tlas_transmit.py's instanced scene (a floor, two red
    glass panes, a cut-out pane and a light, the glass sources shared)
    from one package's classes: (sources, materials, instances, camera
    (eye, target, fov_y_deg))."""
    def quad(y, half, mat):
        pos = np.array([[-half, y, -half], [half, y, -half],
                        [half, y, half], [-half, y, half]], np.float32)
        return mesh_cls(pos, np.array([[0, 2, 1], [0, 3, 2]], np.int32),
                        np.full(2, mat, np.int32))
    mats = [mat_cls(base_color=(0.7, 0.7, 0.7)),
            mat_cls(base_color=(0.9, 0.15, 0.1), alpha=1.0, spec_trans=1.0),
            mat_cls(base_color=(0.2, 0.9, 0.3), alpha=0.35, spec_trans=1.0),
            mat_cls(emission=(10.0, 10.0, 10.0))]
    sources = [quad(0.0, 1.0, 1), quad(0.0, 1.0, 2), quad(0.0, 4.0, 0),
               quad(0.0, 0.5, 3)]
    inst = [(2, make_transform((0, 0, 0))),
            (0, make_transform((0.0, 1.0, 0.0), rot_y=0.3)),
            (0, make_transform((0.3, 1.8, 0.2), rot_y=-0.5, scale=0.7)),
            (1, make_transform((-0.2, 2.4, -0.1), rot_y=0.9)),
            (3, make_transform((0.0, 3.2, 0.0)))]
    return sources, mats, inst, ((0.0, 1.4, 4.5), (0.0, 0.8, 0.0), 45.0)


def flatten_instances(mesh_cls, sources, instances):
    """The world-space meshes of an instanced scene (one per instance)."""
    return [mesh_cls((sources[s].positions @ m[:3, :3] + m[3, :3]).astype(
        np.float32), sources[s].indices, sources[s].mat_id)
        for s, m in instances]


def tinted_tlas_scene(device: str, flat: bool = False, env=None):
    """tinted_tlas_host's scene compiled by the port (instanced, or
    flattened into one BLAS), under `env` where given (its light quad
    faces up: without a sky the camera sees no light): (scene,
    camera)."""
    from truetrace_tpu_torch.scene.instances import (
        compile_scene_instanced, make_transform)
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    sources, mats, inst, (eye, target, fov) = tinted_tlas_host(
        HostMesh, HostMaterial, make_transform)
    cam = Camera.look_at(eye, target, fov_y_deg=fov, device=device)
    if flat:
        return compile_scene(flatten_instances(HostMesh, sources, inst),
                             mats, env=env, with_cwbvh=True,
                             device=device), cam
    return compile_scene_instanced(sources, mats, inst, env=env,
                                   device=device)[0], cam


def terrain_demo_scene(device: str, sky=None):
    """scripts/demo.py scene 4 built by the port: the hills terrain (grass
    and dirt by slope), a normal-mapped sphere and a matcap sphere under
    the baked sky, compiled with its CWBVH: (scene, camera)."""
    from truetrace_tpu_torch.scene.atlas import AtlasBuilder
    from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    from truetrace_tpu_torch.scene.primitives import transform, uv_sphere
    from truetrace_tpu_torch.scene.terrain import demo_hills, make_terrain
    builder = AtlasBuilder()
    n = 64
    yy, xx = np.mgrid[0:n, 0:n] / n * 8 * np.pi
    hgt = 0.35 * np.sin(xx) * np.sin(yy)
    gx, gy = np.gradient(hgt, axis=1), np.gradient(hgt, axis=0)
    nz = 1.0 / np.sqrt(1 + gx ** 2 + gy ** 2)
    nm_id = builder.add((np.stack([-gx * nz, -gy * nz, nz], -1) * 0.5
                         + 0.5).astype(np.float32))
    vv, uu = np.mgrid[0:n, 0:n] / (n - 1) * 2 - 1
    r2 = uu ** 2 + vv ** 2
    mc = (np.clip(0.8 - 0.6 * vv, 0, 1)[..., None] * np.array([1.0, 0.85, 0.6])
          + np.clip(r2 - 0.5, 0, 1)[..., None] * np.array([0.1, 0.2, 0.5]))
    mc_id = builder.add(mc.astype(np.float32))
    atlas, rects, level_y = builder.build()
    hm = demo_hills(97, seed=4)
    mats = [HostMaterial(base_color=(0.35, 0.45, 0.2), roughness=0.9),
            HostMaterial(base_color=(0.45, 0.38, 0.3), roughness=0.95),
            HostMaterial(base_color=(0.8, 0.3, 0.2), roughness=0.35,
                         tex_normal=nm_id),
            HostMaterial(base_color=(1.0, 1.0, 1.0), metallic=1.0,
                         roughness=0.2, tex_matcap=mc_id)]
    am = np.zeros((16, 16, 4), np.float32)
    slope = np.maximum(np.abs(np.gradient(hm, axis=0)),
                       np.abs(np.gradient(hm, axis=1)))
    am[..., 1] = np.clip(slope[::6, ::6][:16, :16] * 40, 0, 1)
    am[..., 0] = 1.0 - am[..., 1]
    ter = make_terrain(hm, origin=(-8, 0, -8), size_xz=(16, 16),
                       mat_ids=[0, 1], alphamap=am, height_scale=2.2,
                       device=device)
    sv, si, _ = uv_sphere(20, 30, radius=0.9)
    nrm = sv / np.linalg.norm(sv, axis=-1, keepdims=True)
    uv = np.stack([np.arctan2(nrm[:, 2], nrm[:, 0]) / (2 * np.pi) + 0.5,
                   nrm[:, 1] * 0.5 + 0.5], -1).astype(np.float32)
    spheres = [HostMesh(transform(sv, translate=t), si,
                        np.full(len(si), mid, np.int32), uvs=uv)
               for t, mid in (((-1.6, 2.6, 0.5), 2), ((1.6, 2.8, -0.5), 3))]
    if sky is None:
        sky = bake_sky_env(**FOREST_SKY, device=device)
    scene = compile_scene(spheres, mats, env=sky, atlas=atlas,
                          atlas_rects=rects, atlas_level_y=level_y,
                          terrain=ter, with_cwbvh=True, device=device)
    return scene, Camera.look_at((0.0, 4.5, 9.5), (0, 1.8, 0),
                                 fov_y_deg=45, device=device)


def grab_rays(r, state, names=("_trace", "_occluded_mesh")):
    """The rays one eager frame of renderer r hands pathtrace's `names`
    (ro, rd and the third argument, cloned), per name in call order."""
    from truetrace_tpu_torch.integrate import pathtrace
    seen = {n: [] for n in names}
    orig = {n: getattr(pathtrace, n) for n in names}

    def wrap(n):
        def f(scene, ro, rd, third, cfg):
            seen[n].append((ro.clone(), rd.clone(), third.clone()))
            return orig[n](scene, ro, rd, third, cfg)
        return f

    for n in names:
        setattr(pathtrace, n, wrap(n))
    try:
        r.step(state)
    finally:
        for n in names:
            setattr(pathtrace, n, orig[n])
    return seen


def tlas_work(counts: dict, R: int, W: int) -> dict:
    """Per-ray work of the two-level traversal (the plain version's
    counts) and its bound: decodes, triangle tests and instance entries
    at OPS_NODE / OPS_TRI / OPS_ENTER (+ OPS_TINT a tinted triangle), the
    touched table rows read once, 48 bytes a walked ray (origin,
    direction, t_max in; t, tri, u, v, inst out; transmittance: 40) and
    24 a dead one (16)."""
    nd, lr, tt, ne = (float(counts[f].sum()) for f in (
        "node_decodes", "leaf_rows", "tri_tests", "inst_entries"))
    live = counts["live_rays"]
    out = dict(node_decodes_per_ray=nd / R, leaf_rows_per_ray=lr / R,
               tri_tests_per_ray=tt / R, inst_entries_per_ray=ne / R,
               rows_touched=counts["rows_touched"], live_share=live / R)
    ops = OPS_NODE * nd + OPS_TRI * tt + OPS_ENTER * ne
    nbytes = 4 * W * counts["rows_touched"]
    if "accepted" in counts:
        acc = float(counts["accepted"].sum())
        out.update(tinted_per_ray=acc / R, tint_rows=counts["tint_rows"])
        return dict(out, **bound(ops + OPS_TINT * acc, nbytes + 40 * live
                                 + 16 * (R - live) + 12 * counts["tint_rows"]))
    return dict(out, **bound(ops, nbytes + 48 * live + 24 * (R - live)))


def hm_work(counts: dict, R: int, grid: int, closest: bool) -> dict:
    """Per-ray work of the march (the plain version's sample counts) and
    its bound: OPS_HM_SAMPLE a sample, the height grid read once, 28
    bytes a ray in and 25 (closest: t, valid, normal, uv) or 1 out."""
    n = float(counts["samples"].sum())
    return dict(samples_per_ray=n / R,
                march_steps_per_ray=float(counts["march_steps"].sum()) / R,
                **bound(OPS_HM_SAMPLE * n,
                        4 * grid + R * (28 + (25 if closest else 1))))


def hold_tlas(scene, ro, rd, tm, label: str, query: str, tint=None,
              time_it=False):
    """A TLAS kernel against its plain version, bit for bit, on one ray
    set (query "closest", "any" or "transmit"). With `time_it` the plain
    run also counts the work (which sets the bound) and is timed once
    (with its counters: the plain version runs once a ray set, ~7 s at
    262144 lanes), and the kernel's device time is measured."""
    import torch
    from truetrace_tpu_torch.kernels import cwbvh_tlas as K
    a = (scene.cw_table(), scene.cw_nodes.shape[0],
         scene.cw_leaf_rows.shape[0])
    R = ro.shape[0]
    kernel, plain = dict(
        closest=(K.closest_hit_tlas, K.closest_hit_tlas_plain),
        any=(K.any_hit_tlas, K.any_hit_tlas_plain),
        transmit=(K.transmit_tlas, K.transmit_tlas_plain))[query]
    a = a + ((tint,) if query == "transmit" else ())
    run = lambda: kernel(*a, ro, rd, tm)
    counts = {} if time_it else None
    got = run()
    want, plain_ms = timed_once(lambda: plain(*a, ro, rd, tm,
                                              counts=counts))
    if query == "closest":
        (hk, ik), (hp, ip) = got, want
        for f in ("t", "tri", "u", "v"):
            check(torch_equal_bits(getattr(hk, f), getattr(hp, f)),
                  f"closest_hit_tlas {label}: {f} differs from plain")
        check(torch.equal(ik, ip), f"closest_hit_tlas {label}: inst differs")
        err, share = max_abs_diff(hk.t, hp.t), float((hk.tri >= 0).float()
                                                     .mean())
    elif query == "any":
        check(torch.equal(got, want), f"any_hit_tlas {label}: occlusion "
              f"differs on {int((got != want).sum())} of {R} rays")
        err, share = max_abs_diff(got.float(), want.float()), float(
            got.float().mean())
    else:
        check(torch_equal_bits(got, want), f"transmit_tlas {label}: "
              f"differs from plain on {int((got != want).any(-1).sum())} "
              f"of {R} rays")
        err = max_abs_diff(got, want)
        share = float(((want > 0) & (want < 1)).any(-1).float().mean())
    out = dict(rays=R, max_abs_err=err, share=share)
    line = (f"{query} tlas {label}: bit for bit equal to plain on {R} rays "
            f"({share:.3f} {'hit' if query != 'transmit' else 'in part'})")
    if time_it:
        work = tlas_work(counts, R, a[0].shape[1])
        out.update(work=work, ms=device_ms(run, 20), plain_ms=plain_ms,
                   bound_ms=work["bound_ms"], bound_by=work["bound_by"])
        out["share_of_bound"] = work["bound_ms"] / out["ms"]
        line += (f"; per ray {work['node_decodes_per_ray']:.2f} decodes, "
                 f"{work['leaf_rows_per_ray']:.2f} leaf rows, "
                 f"{work['tri_tests_per_ray']:.2f} triangle tests, "
                 f"{work['inst_entries_per_ray']:.2f} instance entries; "
                 f"kernel {out['ms']:.4f} ms, plain {plain_ms:.1f} ms, bound "
                 f"{out['bound_ms']:.5f} ms ({out['bound_by']}) = "
                 f"{out['share_of_bound']:.3f} of the kernel's time")
    log(line)
    return out


def hold_heightmap(ter, ro, rd, tm, label: str, closest: bool,
                   time_it=False):
    """heightmap_closest / heightmap_any against the plain march, bit for
    bit (t, valid, normal, uv / valid); the plain run counts the samples
    and, with `time_it`, is timed once beside the kernel's device time."""
    import torch
    from truetrace_tpu_torch.kernels import heightmap as K
    R = ro.shape[0]
    counts = {}
    kernel, plain = ((K.heightmap_closest, K.heightmap_closest_plain)
                     if closest else (K.heightmap_any, K.heightmap_any_plain))
    run = lambda: kernel(ter, ro, rd, tm)
    got = run()
    want, plain_ms = timed_once(lambda: plain(ter, ro, rd, tm,
                                              counts=counts))
    if closest:
        check(torch.equal(got.valid, want.valid), f"heightmap_closest "
              f"{label}: valid differs on "
              f"{int((got.valid != want.valid).sum())} rays")
        for f in ("t", "normal", "uv"):
            check(torch_equal_bits(getattr(got, f), getattr(want, f)),
                  f"heightmap_closest {label}: {f} differs from plain")
        err, share = max_abs_diff(got.t, want.t), float(got.valid.float()
                                                         .mean())
    else:
        check(torch.equal(got, want), f"heightmap_any {label}: differs on "
              f"{int((got != want).sum())} rays")
        err, share = 0.0, float(got.float().mean())
    work = hm_work(counts, R, ter.hm_shape[0] * ter.hm_shape[1], closest)
    out = dict(rays=R, max_abs_err=err, share=share, work=work)
    if time_it:
        out.update(ms=device_ms(run, 20), plain_ms=plain_ms,
                   bound_ms=work["bound_ms"], bound_by=work["bound_by"])
        out["share_of_bound"] = work["bound_ms"] / out["ms"]
    log(f"heightmap {'closest' if closest else 'any'} {label}: bit for bit "
        f"equal to plain on {R} rays ({share:.3f} hit); "
        f"{work['samples_per_ray']:.1f} samples a ray"
        + (f"; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.1f} ms, "
           f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}) = "
           f"{out['share_of_bound']:.3f} of the kernel's time"
           if time_it else ""))
    return out


def phase_forest_kernels(results, scene, cam):
    """Every new kernel against its plain version on the forest frame's
    own rays (one eager frame at 262144 lanes, its rays grabbed): each
    bounce's closest-hit rays (the TLAS closest hit, and the march with
    the TLAS hit's t as its t_max, as the frame runs it) and NEE shadow
    rays (the TLAS any hit and the march's any hit), all bit for bit, and
    bounce 0's NEE rays through the transmittance with a tint table of
    zeros and one that passes every third triangle at 0.8 (bit for bit;
    the transmittance is timed on its own frame's rays,
    phase_tinted_tlas); bounce 0's timed (device_ms, the plain version
    once) and bounded from the plain version's counted work."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import T_MAX
    from truetrace_tpu_torch.kernels.cwbvh_tlas import closest_hit_tlas
    r = make_renderer(scene, cam, FOREST)
    seen = grab_rays(r, r.init_state())
    ter = scene.terrain
    T = scene.n_tris()
    tints = {"opaque": torch.zeros((T, 3), device=scene.device),
             "pass_third": torch.where((torch.arange(
                 T, device=scene.device) % 3 == 0)[:, None], 0.8, 0.0)
             .expand(T, 3).contiguous()}
    table, C, L = scene.cw_table(), scene.cw_nodes.shape[0], \
        scene.cw_leaf_rows.shape[0]
    res = {}
    for b, (ro, rd, alive) in enumerate(seen["_trace"]):
        tm = torch.where(alive, T_MAX, 0.0)
        first = b == 0
        c = hold_tlas(scene, ro, rd, tm, f"bounce {b}", "closest",
                      time_it=first)
        hit, _ = closest_hit_tlas(table, C, L, ro, rd, tm)
        h = hold_heightmap(ter, ro, rd, hit.t, f"bounce {b}", True,
                           time_it=first)
        if first:
            res["closest_hit_tlas"], res["heightmap_closest"] = c, h
    for b, (ro, rd, tm) in enumerate(seen["_occluded_mesh"]):
        first = b == 0
        a = hold_tlas(scene, ro, rd, tm, f"NEE bounce {b}", "any",
                      time_it=first)
        h = hold_heightmap(ter, ro, rd, tm, f"NEE bounce {b}", False,
                           time_it=first)
        if first:
            res["any_hit_tlas"], res["heightmap_any"] = a, h
            res["transmit_tlas_forest"] = {
                name: hold_tlas(scene, ro, rd, tm, f"NEE bounce {b} {name}",
                                "transmit", tint=tint)
                for name, tint in tints.items()}
    check(len(seen["_trace"]) == FOREST["bounces"]
          and len(seen["_occluded_mesh"]) == FOREST["bounces"],
          "forest frame: not one closest-hit and one NEE call a bounce")
    check(res["transmit_tlas_forest"]["pass_third"]["share"] > 0.001,
          "transmit_tlas: the pass-through table passes no ray in part")
    results.update(res)


def forest_updates(scene, isc, mats, inst, n: int):
    """n scenes with the lanterns bobbed by forest_bob(frame 1..n), each
    made by update_instance_transforms on the host (timed: update_s) with
    its traversal table packed; the TLAS keeps its node count."""
    import torch
    from truetrace_tpu_torch.scene.instances import update_instance_transforms
    scenes, times = [], []
    for k in range(1, n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk, _ = update_instance_transforms(scene, isc, mats,
                                           forest_bob(inst, k))
        sk.cw_table()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        scenes.append(sk)
    return scenes, times


def phase_forest(results, scene, isc, mats, inst, cam):
    """The forest frame (FOREST, 512x512x4): the lanterns bob and the
    camera moves along x between frames, each frame handed its scene
    (Renderer.step(scene=, cam=, cam_moved=True)): 1 warm-up and FRAMES -
    1 timed eager frames with every kernel's launch count set to 0 just
    before and read just after; two frames under the sync debug mode; one
    profiled; then the frame as CUDA graphs (graph_step(cam_moved=True)):
    four frames over three lantern updates bit for bit the eager ones
    with one capture (every later update copied into the captured scene
    on the device), eager and replayed frames timed in turns, replays
    under the sync debug mode and the profiler. update_s: the host's
    update_instance_transforms, outside every frame time."""
    import torch
    from truetrace_tpu_torch.renderer import _tensors
    n = 3 * FRAMES + 8        # the frames below, each with its own scene
    scenes, upd = forest_updates(scene, isc, mats, inst, n)
    cams = [moved_camera(cam, 0.05 * k) for k in range(n)]
    it = iter(range(n))
    r = make_renderer(scene, cam, FOREST)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state = r.init_state()
    times = []
    for f in range(FRAMES):
        k = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        display, accum, state = r.step(state, cam=cams[k], cam_moved=True,
                                       scene=scenes[k])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    H, W = FOREST["height"], FOREST["width"]
    check(tuple(display.shape) == (H, W, 3)
          and bool(torch.isfinite(display).all())
          and float(display.min()) >= 0.0 and float(display.max()) <= 1.0,
          "forest display not finite in [0, 1]")
    mean = float(accum.mean())
    check(bool(torch.isfinite(accum).all()) and mean > 1e-3,
          f"forest radiance mean {mean}")
    for name in PATHS["forest"]:
        check(launches[name] > 0, f"{name} never launched on the forest path")
    ms = 1e3 * sum(times[1:]) / (FRAMES - 1)
    log(f"frame forest {H}x{W}x{FOREST['bounces']} svgf ({len(inst)} "
        f"instances, terrain, lanterns bobbing): warm-up "
        f"{times[0] * 1e3:.1f} ms, frames "
        f"{[round(t * 1e3, 1) for t in times[1:]]} ms -> mean "
        f"{ms:.1f} ms; radiance mean {mean:.4f}; update_s "
        f"{[round(u, 4) for u in upd[:FRAMES]]}")
    log(f"launches over the forest path's {FRAMES} frames: {launches}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            k = next(it)
            _, _, state = r.step(state, cam=cams[k], cam_moved=True,
                                 scene=scenes[k])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("forest: two frames (each moving the camera and the lanterns) "
        "under set_sync_debug_mode('error'): no host copy or sync")
    k = next(it)
    prof = phase_profile(r, state, lambda: r.step(
        state, cam=cams[k], cam_moved=True, scene=scenes[k]), "forest frame")
    del r, state

    re, rg = make_renderer(scene, cam, FOREST), make_renderer(scene, cam,
                                                              FOREST)
    gm = rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for i in range(4):
        k = next(it)
        de, ae, se = re.step(se, cam=cams[k], cam_moved=True,
                             scene=scenes[k])
        dg, ag, sg = gm(sg, cam=cams[k], scene=scenes[k])
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        check(te.keys() == tg.keys(), "forest: state fields differ")
        for what, a, b in [("display", de, dg), ("radiance", ae, ag)] + [
                (key, te[key], tg[key]) for key in te]:
            check(torch_equal_bits(a, b), f"forest frame {i + 1}: the "
                  f"replayed {what} differs from the eager one")
    check(gm.captures == 1, f"forest: {gm.captures} captures over three "
          f"lantern updates")
    log("forest graph: four frames over three lantern updates (the first "
        "eager, one capture, two replays of copied-in scenes) bit for bit "
        "equal to Renderer.step's display, radiance and state")
    eager, replay, replay_dev = [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(FRAMES - 1):
        k = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, se = re.step(se, cam=cams[k], cam_moved=True, scene=scenes[k])
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
        k = next(it)
        t0 = time.perf_counter()
        ev[0].record()
        _, _, sg = gm(sg, cam=cams[k], scene=scenes[k])
        ev[1].record()
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - t0)
        replay_dev.append(ev[0].elapsed_time(ev[1]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            k = next(it)
            _, _, sg = gm(sg, cam=cams[k], scene=scenes[k])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    k = next(it)
    gprof = phase_profile(None, None, lambda: gm(sg, cam=cams[k],
                                                 scene=scenes[k]),
                          "forest replay")
    check(gm.captures == 1, f"forest: {gm.captures} captures")
    mean_ms = lambda xs: 1e3 * sum(xs) / len(xs)
    res = dict(ms=ms, warmup_ms=times[0] * 1e3, mean=mean,
               eager_ms=mean_ms(eager), replay_ms=mean_ms(replay),
               replay_device_ms=sum(replay_dev) / len(replay_dev),
               captures=gm.captures, update_s=upd, profile=gprof,
               eager_profile=prof, instances=len(inst))
    log(f"forest {H}x{W}x{FOREST['bounces']}, in turns: eager "
        f"{res['eager_ms']:.1f} ms/frame, replayed {res['replay_ms']:.1f} "
        f"ms/frame (device {res['replay_device_ms']:.1f} ms), "
        f"{res['eager_ms'] / res['replay_ms']:.2f} times, across lantern "
        f"updates with {gm.captures} capture; update_s mean "
        f"{sum(upd) / len(upd):.4f} s")
    results["forest"] = res
    results["forest_profile"] = prof
    results["forest_graph"] = dict(
        eager_ms=res["eager_ms"], replay_ms=res["replay_ms"],
        replay_device_ms=res["replay_device_ms"], profile=gprof)
    return launches


def phase_tinted_tlas(results):
    """transmit_tlas's frame: tests/test_tlas_transmit.py's instanced
    glass scene at FRAME's size with the two-level traversal (NEE shadow
    rays through the tinted panes) under the forest's sky. First the
    kernel against its plain version on the frame's own shadow rays (one
    eager frame, every bounce's rays grabbed, with the scene's shadow
    tints), bit for bit, bounce 0's timed and bounded from the plain
    version's counted work; then 1 warm-up and FRAMES - 1 timed frames
    with the launch counts set to 0 just before and read just after."""
    from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
    scene, cam = tinted_tlas_scene(DEVICE, env=bake_sky_env(
        **FOREST_SKY, device=DEVICE))
    cfg = dict(FRAME, traversal="tlas", light_sampling="cdf")
    r = make_renderer(scene, cam, cfg)
    seen = grab_rays(r, r.init_state(), names=("_transmission",))
    check(len(seen["_transmission"]) == cfg["bounces"],
          "tinted frame: not one shadow-ray call a bounce")
    for b, (ro, rd, tm) in enumerate(seen["_transmission"]):
        res = hold_tlas(scene, ro, rd, tm, f"tinted bounce {b}", "transmit",
                        tint=scene.tri_shadow, time_it=b == 0)
        if b == 0:
            results["transmit_tlas"] = res
    check(results["transmit_tlas"]["share"] > 0.001,
          "transmit_tlas: no shadow ray of the tinted frame passes in part")
    del r
    launches, r, state = phase_frame(results, scene, cam, "tinted", cfg)
    return launches


def phase_forest_gates(results):
    """The JAX package's instancing, object-motion, tinted-TLAS and
    terrain checks, run with the port on the card:
    test_instances.py::test_tlas_matches_loop_traversal (against the
    port's flattened scene, the per-instance loop being unported),
    test_instanced_render.py (both), test_object_motion.py::
    test_object_motion_reprojection_beats_camera_only,
    test_tlas_transmit.py::test_tlas_render_with_tinted_shadows,
    test_terrain.py::test_hills_match_dense_marching and
    test_any_hit_consistent."""
    import dataclasses
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sample_with_stats)
    from truetrace_tpu_torch.kernels.cwbvh_tlas import (
        any_hit_tlas, closest_hit_tlas)
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_wavefront, closest_hit_wavefront)
    from truetrace_tpu_torch.kernels.heightmap import (
        _sample_height, heightmap_any, heightmap_closest)
    from truetrace_tpu_torch.post.motion import (
        motion_vectors, motion_vectors_objects)
    from truetrace_tpu_torch.scene.instances import (
        compile_scene_instanced, make_transform, update_instance_transforms)
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    from truetrace_tpu_torch.scene.primitives import grid, uv_sphere
    from truetrace_tpu_torch.scene.terrain import demo_hills, make_terrain
    dev = DEVICE
    out = {}
    tf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    # test_tlas_matches_loop_traversal
    sv, si, _ = uv_sphere(8, 12, radius=0.5)
    gv, gi, _ = grid(4, 4, 6.0, 6.0)
    srcs = [HostMesh(sv, si, np.zeros(len(si), np.int32)),
            HostMesh(gv, gi, np.ones(len(gi), np.int32))]
    inst = [(0, make_transform(translate=(-1.5, 0.5, 0.0))),
            (0, make_transform(translate=(1.2, 0.8, 0.5), rot_y=0.7,
                               scale=1.6)),
            (1, make_transform(translate=(0, 0, 0)))]
    mats2 = [HostMaterial(), HostMaterial()]
    sc, _ = compile_scene_instanced(srcs, mats2, inst, device=dev)
    fl = compile_scene(flatten_instances(HostMesh, srcs, inst), mats2,
                       with_cwbvh=True, device=dev)
    rng = np.random.default_rng(2)
    R = 384
    ro = tf(rng.uniform(-5, 5, (R, 3)))
    d = rng.normal(size=(R, 3))
    rd = tf(d / np.linalg.norm(d, axis=-1, keepdims=True))
    tab = (sc.cw_table(), sc.cw_nodes.shape[0], sc.cw_leaf_rows.shape[0])
    h_t, i_t = closest_hit_tlas(*tab, ro, rd, 1e30)
    h_f = closest_hit_wavefront(fl.cw_table(), fl.cw_nodes.shape[0], ro, rd,
                                1e30, fl.cw_stack)
    hm_ = h_f.tri >= 0
    check(torch.equal(hm_, h_t.tri >= 0), "tlas vs flattened: hit masks")
    check(bool(torch.allclose(h_t.t[hm_], h_f.t[hm_], rtol=2e-4,
                              atol=2e-4)), "tlas vs flattened: t")
    check(bool((i_t[hm_] >= 0).all()) and bool((i_t[~hm_] == -1).all()),
          "tlas: instance ids")
    tmax = tf(rng.uniform(0.5, 10.0, R))
    occ_t = any_hit_tlas(*tab, ro, rd, tmax)
    occ_f = any_hit_wavefront(fl.cw_table(), fl.cw_nodes.shape[0], ro, rd,
                              tmax, fl.cw_stack)
    out["tlas_vs_flat_any_agree"] = float((occ_t == occ_f).float().mean())
    check(out["tlas_vs_flat_any_agree"] > 0.99, "tlas any vs flattened")

    # test_instanced_render.py
    def box(center=(0, 0, 0), size=(1, 1, 1), mat=0):
        c = np.asarray(center, np.float32)
        s = np.asarray(size, np.float32) * 0.5
        corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                            for z in (-1, 1)], np.float32) * s + c
        faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                          [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                          [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
                         np.int32)
        return HostMesh(corners, faces, np.full(12, mat, np.int32))

    def quad(y, half, mat, up=True):
        pos = np.array([[-half, y, -half], [half, y, -half],
                        [half, y, half], [-half, y, half]], np.float32)
        idx = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        return HostMesh(pos, idx if up else idx[:, ::-1].copy(),
                        np.full(2, mat, np.int32))
    mats = [HostMaterial(base_color=(0.75, 0.75, 0.75)),
            HostMaterial(base_color=(0.8, 0.2, 0.2)),
            HostMaterial(emission=(12.0, 11.0, 10.0))]
    srcs = [box(size=(0.8, 0.8, 0.8), mat=1), quad(0.0, 4.0, 0),
            quad(0.0, 0.6, 2, up=False)]
    inst = [(1, make_transform((0, 0, 0))),
            (0, make_transform((-1.2, 0.4, 0.0), rot_y=0.4)),
            (0, make_transform((1.1, 0.4, -0.6), rot_y=-0.7, scale=0.8)),
            (2, make_transform((0.0, 2.5, 0.0), rot_y=0.3))]
    cam = Camera.look_at((0, 3.0, 6.0), (0, 0.5, 0), fov_y_deg=45,
                         device=dev)
    sc_i, isc = compile_scene_instanced(srcs, mats, inst, device=dev)
    sc_f = compile_scene(flatten_instances(HostMesh, srcs, inst), mats,
                         with_cwbvh=True, device=dev)
    kw = dict(bounces=2, bsdf="lambert", light_sampling="cdf")
    img_i = render_image(sc_i, cam, 32, 32, 48, traversal="tlas", **kw)
    img_f = render_image(sc_f, cam, 32, 32, 48, **kw)
    rel = float(abs(img_i.mean() - img_f.mean()) / max(img_f.mean(), 1e-6))
    close = float(np.mean(np.abs(img_i - img_f).mean(-1)
                          / np.maximum(img_f.mean(-1), 0.05) < 0.5))
    check(img_i.mean() > 0 and rel < 0.05 and close > 0.9,
          f"instanced render vs flattened: mean rel {rel}, close {close}")
    out["instanced_vs_flat"] = dict(mean_rel=rel, close=close)
    moved = [(s, m.copy()) for s, m in inst]
    moved[1] = (0, make_transform((-0.6, 0.7, 0.4), rot_y=1.1))
    moved[2] = (0, make_transform((1.4, 0.3, 0.2), rot_y=0.2, scale=0.8))
    sc_u, _ = update_instance_transforms(sc_i, isc, mats, moved)
    sc_r, _ = compile_scene_instanced(srcs, mats, moved, device=dev)
    a = render_image(sc_u, cam, 24, 24, 8, traversal="tlas", **kw)
    b = render_image(sc_r, cam, 24, 24, 8, traversal="tlas", **kw)
    check(bool(np.allclose(a, b, rtol=1e-4, atol=1e-5)),
          "update_instance_transforms render differs from the rebuild")

    # test_object_motion_reprojection_beats_camera_only
    W = H = 48
    mats_m = [HostMaterial(base_color=(0.7, 0.7, 0.7)),
              HostMaterial(base_color=(0.9, 0.1, 0.1))]
    floor = quad(0.0, 4.0, 0)
    mbox = box(size=(0.8, 0.8, 0.8), mat=1)
    cam = Camera.look_at((0, 2.5, 5.0), (0, 0.4, 0), fov_y_deg=45,
                         device=dev)
    cfg = RenderConfig(width=W, height=H, bounces=1, bsdf="lambert",
                       traversal="tlas", use_nee=False)
    pixel = torch.arange(W * H, device=dev)
    s0, isc0 = compile_scene_instanced(
        [floor, mbox], mats_m, [(0, make_transform((0, 0, 0))),
                                (1, make_transform((0.0, 0.4, 0.0)))],
        device=dev)
    _, st0 = render_sample_with_stats(s0, cam, cfg, pixel, 0)
    s1, _ = update_instance_transforms(
        s0, isc0, mats_m, [(0, make_transform((0, 0, 0))),
                           (1, make_transform((0.6, 0.4, 0.0)))])
    _, st1 = render_sample_with_stats(s1, cam, cfg, pixel, 0)
    alb0 = st0["albedo"].reshape(H, W, 3).cpu().numpy()
    alb1 = st1["albedo"].reshape(H, W, 3).cpu().numpy()
    depth1 = st1["depth"].reshape(H, W)
    inst_g = st1["inst"].reshape(H, W)
    mv = motion_vectors_objects(cam, cam, depth1, inst_g, s0.inst_l2w,
                                s1.inst_l2w).cpu().numpy()
    mv_cam = motion_vectors(cam, cam, depth1).cpu().numpy()
    ys, xs = np.mgrid[0:H, 0:W]

    def reproject(m):
        sy = np.clip((ys - m[..., 1]).round().astype(int), 0, H - 1)
        sx = np.clip((xs - m[..., 0]).round().astype(int), 0, W - 1)
        return alb0[sy, sx]

    ig = inst_g.cpu().numpy()
    box_ids = set(ig[alb1[..., 0] > 0.8].tolist()) - {-1}
    box_px = np.isin(ig, list(box_ids))
    err_obj = np.abs(reproject(mv) - alb1)[box_px].mean()
    err_cam = np.abs(reproject(mv_cam) - alb1)[box_px].mean()
    interior = box_px & (np.abs(reproject(mv) - alb1).max(-1) < 1e-3)
    check((ig >= 0).sum() > 50 and box_px.sum() > 30 and err_cam > 0.05
          and err_obj < 0.25 * err_cam
          and interior.sum() > 0.5 * box_px.sum(),
          f"object motion: err_obj {err_obj}, err_cam {err_cam}")
    out["object_motion"] = dict(err_obj=float(err_obj),
                                err_cam=float(err_cam))

    # test_tlas_render_with_tinted_shadows
    st_i, cam_t = tinted_tlas_scene(dev)
    st_f, _ = tinted_tlas_scene(dev, flat=True)
    kw = dict(bounces=2, bsdf="disney", light_sampling="cdf")
    img_i = render_image(st_i, cam_t, 32, 32, 24, traversal="tlas", **kw)
    img_f = render_image(st_f, cam_t, 32, 32, 24, **kw)
    check(bool(np.allclose(img_i.mean((0, 1)), img_f.mean((0, 1)),
                           rtol=0.08)), "tinted TLAS render vs flattened")

    # test_hills_match_dense_marching and test_any_hit_consistent
    ter = make_terrain(demo_hills(65), origin=(0, 0, 0),
                       size_xz=(10.0, 10.0), mat_ids=[0], height_scale=2.0,
                       device=dev)
    rng = np.random.default_rng(1)
    R = 128
    ro = tf(np.stack([rng.uniform(1, 9, R), np.full(R, 5.0),
                      rng.uniform(1, 9, R)], -1))
    d = np.stack([rng.normal(size=R) * 0.3, -np.ones(R),
                  rng.normal(size=R) * 0.3], -1)
    rd = tf(d / np.linalg.norm(d, axis=-1, keepdims=True))
    hit = heightmap_closest(ter, ro, rd, 100.0)
    ts = torch.linspace(1e-4, 12.0, 20000, device=dev)[:, None]
    f = (ro[:, 1] + rd[:, 1] * ts) - _sample_height(
        ter, (ro[:, 0] + rd[:, 0] * ts).reshape(-1),
        (ro[:, 2] + rd[:, 2] * ts).reshape(-1)).reshape(ts.shape[0], R)
    f = f.cpu().numpy()
    change = np.sign(f[1:]) != np.sign(f[:-1])
    t_ref = ts[:, 0].cpu().numpy()[np.argmax(change, axis=0)]
    has = change.any(0)
    ok = hit.valid.cpu().numpy()
    both = ok & has
    terr = float(np.abs(hit.t.cpu().numpy()[both] - t_ref[both]).max())
    check((ok == has).mean() > 0.97 and terr < 0.05,
          f"terrain vs dense march: {(ok == has).mean()}, {terr}")
    rng = np.random.default_rng(2)
    R = 64
    ro = tf(np.stack([rng.uniform(1, 9, R), np.full(R, 4.0),
                      rng.uniform(1, 9, R)], -1))
    d = np.stack([rng.normal(size=R), -np.abs(rng.normal(size=R)) - 0.2,
                  rng.normal(size=R)], -1)
    rd = tf(d / np.linalg.norm(d, axis=-1, keepdims=True))
    check(torch.equal(heightmap_any(ter, ro, rd, 100.0),
                      heightmap_closest(ter, ro, rd, 100.0).valid),
          "heightmap any vs closest")
    out["terrain_dense_t_err"] = terr
    rel = out["instanced_vs_flat"]["mean_rel"]
    log(f"forest gates on the card: TLAS vs the flattened scene, instanced "
        f"render vs flattened (mean rel {rel:.4f}), "
        f"update == rebuild, object motion (err {err_obj:.4f} vs camera "
        f"{err_cam:.4f}), tinted TLAS shadows, terrain vs dense march "
        f"(t err {terr:.4f}), any == closest: all pass")
    results["forest_gates"] = out


def phase_forest_card_vs_cpu(results):
    """Three scenes at 16x16, two frames each on the card and on the CPU:
    the forest small (33^2 terrain, 24 trees, 4 lanterns; FOREST_TREE,
    NEE by the light tree over the lanterns' world light rows, the second
    frame moving the camera and the lanterns), scripts/demo.py
    scene 4 (terrain, normal-mapped and matcap spheres; wavefront) and the
    tinted TLAS scene (under the forest's sky); the displays within 1e-3
    on >= 98% of pixels."""
    import torch
    from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
    from truetrace_tpu_torch.scene.instances import update_instance_transforms
    sky = bake_sky_env(**FOREST_SKY, device="cpu")
    small = dict(width=16, height=16, bounces=3, bsdf="disney",
                 denoiser="svgf")
    out = {}
    for label in ("forest", "terrain_demo", "tinted"):
        frames = {}
        for dev in (DEVICE, "cpu"):
            if label == "forest":
                sc, isc, mats, inst, cam = forest_scene(
                    dev, sky=sky.to(dev), with_light_bvh=True, n_hm=33,
                    n_trees=24, n_lanterns=4)
                cfg = dict(FOREST_TREE, **small)
                nxt, _ = update_instance_transforms(sc, isc, mats,
                                                    forest_bob(inst, 1))
            elif label == "terrain_demo":
                sc, cam = terrain_demo_scene(dev, sky=sky.to(dev))
                cfg = dict(small, traversal="wavefront", light_sampling="cdf")
                nxt = None
            else:
                sc, cam = tinted_tlas_scene(dev, env=sky.to(dev))
                cfg = dict(small, traversal="tlas", light_sampling="cdf")
                nxt = None
            r = make_renderer(sc, cam, cfg)
            st = r.init_state()
            d0, _, st = r.step(st)
            d1, _, st = r.step(st, cam=moved_camera(cam), cam_moved=True,
                               scene=nxt)
            frames[dev] = [d0.cpu(), d1.cpu()]
        shares = []
        for a, b in zip(frames[DEVICE], frames["cpu"]):
            shares.append(float(((a - b).abs() <= 1e-3).all(-1).float()
                                .mean()))
            check(bool(torch.isfinite(a).all()) and shares[-1] >= 0.98,
                  f"{label} card vs CPU: {shares[-1]:.4f} of pixels within "
                  f"1e-3")
        out[label] = dict(display_share=shares)
    shares = {k: [round(x, 4) for x in v["display_share"]]
              for k, v in out.items()}
    log(f"forest, terrain demo and tinted TLAS 16x16 card vs CPU, two "
        f"frames: display shares within 1e-3 {shares}")
    results["forest_card_vs_cpu"] = out


# ---------------------------------------------------------------------------
# phase 9: the animated atrium (a skinned mesh refit every frame)
# ---------------------------------------------------------------------------

# the atrium's meshes with tests/test_dynamic_scene.py's two-bone cylinder
# at 128 x 256: 293,176 + 65,792 = 358,968 triangles in one K = 3 BLAS
ANIMATED_CYL = dict(n_radial=128, n_height=256, radius=0.45, height=3.6)
ANIMATED_TRIS = 358968
ANIMATED_AT = (-7.0, 0.0, 0.6)      # the cylinder's foot, in the camera view
ANIMATED_MAT = dict(base_color=(0.65, 0.32, 0.18), roughness=0.35,
                    metallic=0.3)
ANIMATED_POSES = 10     # the graph run's poses (one eager, one captured)
ANIMATED = FRAME        # 512x512x4, Disney, light-tree NEE, SVGF


def animated_scene(device: str, detail: float = ATRIUM_DETAIL,
                   n_radial: int = ANIMATED_CYL["n_radial"],
                   n_height: int = ANIMATED_CYL["n_height"]):
    """The atrium's meshes (static) and the two-bone cylinder standing at
    ANIMATED_AT, in one DynamicScene (compile_dynamic_scene: K = 3, the
    light BVH and its cut over the ceiling panels). The cylinder's rest
    vertices sit at their place and its inverse binds undo that, so
    `animated_bones(k)` at angle 0 is the rest pose. Returns (dyn,
    camera)."""
    import torch
    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.dynamic import compile_dynamic_scene
    from truetrace_tpu_torch.scene.mesh import HostMaterial
    from truetrace_tpu_torch.scene.skinning import make_two_bone_cylinder
    meshes, mats, cam, env = atrium.make(detail=detail, device=device)
    mesh = make_two_bone_cylinder(n_radial, n_height, ANIMATED_CYL["radius"],
                                  ANIMATED_CYL["height"], device=device)
    at = torch.tensor(ANIMATED_AT, device=device)
    inv = mesh.inv_bind.clone()
    inv[:, :, 3] -= at
    mesh = mesh._replace(rest_verts=mesh.rest_verts + at, inv_bind=inv)
    mats = list(mats) + [HostMaterial(**ANIMATED_MAT)]
    dyn = compile_dynamic_scene(mesh, len(mats) - 1, mats,
                                static_meshes=meshes, env=env,
                                with_light_bvh=True, device=device)
    return dyn, cam


def animated_bones(k: int, device: str):
    """The bones of pose k (made on `device`): the root sways about z by
    0.05 sin k, the tip bends about x by 0.12 k (a new angle every
    frame); both joints at their place in the atrium."""
    import torch
    from truetrace_tpu_torch.scene.skinning import bone_matrix
    x, y, z = ANIMATED_AT
    mid = y + 0.5 * ANIMATED_CYL["height"]
    return torch.stack([
        bone_matrix((0, 0, 1), 0.05 * math.sin(k), (x, y, z), device=device),
        bone_matrix((1, 0, 0), 0.12 * k, (x, mid, z), device=device)])


def animated_poses(dyn, ks):
    """pose_scene at the poses `ks` (bones made first), each posed scene's
    traversal table packed."""
    from truetrace_tpu_torch.scene.dynamic import pose_scene
    bones = [animated_bones(k, dyn.scene.device) for k in ks]
    out = []
    for b in bones:
        sc = pose_scene(dyn, b)
        sc.cw_table()
        out.append(sc)
    return out


def phase_animated_kernels(results, dyn, cam):
    """The K = 3 closest and any hit on a bent pose's own rays (one eager
    ANIMATED frame at 262144 lanes, its rays grabbed): every bounce's
    closest-hit rays and NEE shadow rays against the plain traversal, bit
    for bit; bounce 0's timed (device_ms; the plain version once) and
    bounded from the plain version's counted work (traversal_work)."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import T_MAX
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_plain, any_hit_wavefront, closest_hit_plain,
        closest_hit_wavefront)
    scene = animated_poses(dyn, [6])[0]
    r = make_renderer(scene, cam, ANIMATED)
    seen = grab_rays(r, r.init_state())
    table, C, S = scene.cw_table(), scene.cw_nodes.shape[0], scene.cw_stack
    check(table.shape[1] == 30, f"animated table width {table.shape[1]}")
    res = {}
    for b, (ro, rd, alive) in enumerate(seen["_trace"]):
        tm = torch.where(alive, T_MAX, 0.0)
        hk = closest_hit_wavefront(table, C, ro, rd, tm, S)
        counts = {}
        hp, plain_ms = timed_once(lambda: closest_hit_plain(
            table, C, ro, rd, tm, S, counts))
        for f in ("t", "tri", "u", "v"):
            check(torch_equal_bits(getattr(hk, f), getattr(hp, f)),
                  f"animated bounce {b}: closest hit {f} differs")
        if b == 0:
            work = traversal_work(counts, ro.shape[0], table.shape[1])
            ms = device_ms(lambda: closest_hit_wavefront(
                table, C, ro, rd, tm, S), 20)
            res["closest"] = dict(rays=ro.shape[0], ms=ms, plain_ms=plain_ms,
                                  max_abs_err=max_abs_diff(hk.t, hp.t),
                                  share_of_bound=work["bound_ms"] / ms,
                                  **{k: work[k] for k in (
                                      "bound_ms", "bound_by")}, work=work)
    for b, (ro, rd, tm) in enumerate(seen["_occluded_mesh"]):
        ok = any_hit_wavefront(table, C, ro, rd, tm, S)
        counts = {}
        op, plain_ms = timed_once(lambda: any_hit_plain(
            table, C, ro, rd, tm, S, counts))
        check(torch.equal(ok, op), f"animated NEE bounce {b}: any hit "
              f"differs on {int((ok != op).sum())} rays")
        if b == 0:
            work = traversal_work(counts, ro.shape[0], table.shape[1])
            ms = device_ms(lambda: any_hit_wavefront(table, C, ro, rd, tm,
                                                     S), 20)
            res["any"] = dict(rays=ro.shape[0], ms=ms, plain_ms=plain_ms,
                              max_abs_err=max_abs_diff(ok.float(),
                                                       op.float()),
                              share_of_bound=work["bound_ms"] / ms,
                              **{k: work[k] for k in ("bound_ms",
                                                      "bound_by")},
                              work=work)
    check(len(seen["_trace"]) == ANIMATED["bounces"]
          and len(seen["_occluded_mesh"]) == ANIMATED["bounces"],
          "animated frame: not one closest-hit and one NEE call a bounce")
    for q in ("closest", "any"):
        x = res[q]
        log(f"animated K=3 {q} hit (bounce 0, {x['rays']} rays): bit for "
            f"bit the plain version on every bounce; kernel {x['ms']:.4f} "
            f"ms, bound {x['bound_ms']:.4f} ms ({x['bound_by']}) = "
            f"{x['share_of_bound']:.3f}, plain {x['plain_ms']:.1f} ms; "
            f"{work_line(x['work'])}")
    results["animated_kernels"] = res


def phase_animated_pose(results, dyn):
    """pose_scene alone: its device time (CUDA events, mean of 10 poses
    after one), its kernels and host copies and syncs under the profiler
    (all four must be 0), and a pose under set_sync_debug_mode("error");
    its output against a plain re-derivation: the refit nodes must bound
    every skinned triangle they hold."""
    import torch
    from truetrace_tpu_torch.scene.dynamic import pose_scene
    bones = [animated_bones(k, dyn.scene.device) for k in range(12)]
    pose_scene(dyn, bones[0])
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for b in bones[1:11]:
        pose_scene(dyn, b)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 10
    events, wall = profiled(lambda: pose_scene(dyn, bones[11]))
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(e) > 0]
    n = sum(e.count for e in kernels)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    copies = copies_of(events)
    for k in COPY_KEYS[:4]:
        check(copies[k] == 0, f"pose_scene: {copies[k]} {k}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        posed = pose_scene(dyn, bones[5])
        posed.cw_table()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the refit's root box holds every posed triangle
    from truetrace_tpu_torch.build.refit import refit_cwbvh
    _, root = refit_cwbvh(posed.cw_nodes, posed.tri_p0, posed.tri_e1,
                          posed.tri_e2, dyn.slot_child, dyn.slot_tri_base,
                          dyn.slot_tri_count, dyn.levels)
    v = torch.cat([posed.tri_p0, posed.tri_p0 + posed.tri_e1,
                   posed.tri_p0 + posed.tri_e2])
    check(bool((root[0] <= v.amin(0)).all() and (root[1] >= v.amax(0)).all()),
          "pose_scene: the refit root box misses a triangle")
    log(f"pose_scene ({dyn.skin_tri_ids.shape[0]} skinned of "
        f"{posed.n_tris()} triangles, {len(dyn.levels)} refit levels): "
        f"{ms:.3f} ms a pose on the device (CUDA events, 10 poses), "
        f"{n} kernels ({busy:.3f} ms busy) under the profiler; host copies "
        f"and syncs {copies}; one pose under set_sync_debug_mode('error')")
    results["animated_pose"] = dict(ms=ms, kernels=n, busy_ms=busy,
                                    levels=len(dyn.levels),
                                    copies={k: copies[k] for k in COPY_KEYS})


def phase_animated(results, dyn, cam):
    """The animated frame (ANIMATED, 512x512x4), each frame handed a new
    pose (pose_scene -> Renderer.step(scene=, cam=, cam_moved=True)): 1
    warm-up and FRAMES - 1 timed eager frames with every kernel's launch
    count set to 0 just before and read just after; two frames under the
    sync debug mode (pose_scene among them); one profiled; then the frame
    as CUDA graphs (graph_step(cam_moved=True)) over ANIMATED_POSES poses,
    every frame bit for bit the eager one, with one capture (each later
    pose copied into the captured scene on the device), pose + replay and
    eager frames timed in turns, replays under the sync debug mode and
    the profiler. For scale: the host seconds of a from-scratch
    compile_scene at one pose."""
    import torch
    from truetrace_tpu_torch.renderer import _tensors
    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.dynamic import pose_scene
    from truetrace_tpu_torch.scene.mesh import (HostMaterial, HostMesh,
                                                compile_scene)
    from truetrace_tpu_torch.scene.skinning import skin_vertices
    dev = dyn.scene.device
    bones = [animated_bones(k, dev) for k in range(3 * FRAMES + 8
                                                    + ANIMATED_POSES)]
    it = iter(range(len(bones)))
    r = make_renderer(dyn.scene, cam, ANIMATED)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    state = r.init_state()
    times = []
    for _ in range(FRAMES):
        k = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        display, accum, state = r.step(state, cam=cam, cam_moved=True,
                                       scene=pose_scene(dyn, bones[k]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {name: fn.launches for name, fn in counters.items()}
    H, W = ANIMATED["height"], ANIMATED["width"]
    check(tuple(display.shape) == (H, W, 3)
          and bool(torch.isfinite(display).all())
          and float(display.min()) >= 0.0 and float(display.max()) <= 1.0,
          "animated display not finite in [0, 1]")
    mean = float(accum.mean())
    check(bool(torch.isfinite(accum).all()) and mean > 1e-3,
          f"animated radiance mean {mean}")
    for name in PATHS["animated"]:
        check(launches[name] > 0, f"{name} never launched on the animated "
              f"path")
    ms = 1e3 * sum(times[1:]) / (FRAMES - 1)
    log(f"frame animated {H}x{W}x{ANIMATED['bounces']} svgf (pose_scene + "
        f"step): warm-up {times[0] * 1e3:.1f} ms, frames "
        f"{[round(t * 1e3, 1) for t in times[1:]]} ms -> mean {ms:.1f} ms; "
        f"radiance mean {mean:.4f}")
    log(f"launches over the animated path's {FRAMES} frames: {launches}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            k = next(it)
            _, _, state = r.step(state, cam=cam, cam_moved=True,
                                 scene=pose_scene(dyn, bones[k]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("animated: two frames (pose_scene and step) under "
        "set_sync_debug_mode('error'): no host copy or sync")
    k = next(it)
    posed = pose_scene(dyn, bones[k])
    prof = phase_profile(r, state, lambda: r.step(
        state, cam=cam, cam_moved=True, scene=posed), "animated frame")
    del r, state

    re, rg = make_renderer(dyn.scene, cam, ANIMATED), make_renderer(
        dyn.scene, cam, ANIMATED)
    gm = rg.graph_step(cam_moved=True)
    se, sg = re.init_state(), rg.init_state()
    for i in range(ANIMATED_POSES):
        sc = pose_scene(dyn, bones[next(it)])
        de, ae, se = re.step(se, cam=cam, cam_moved=True, scene=sc)
        dg, ag, sg = gm(sg, cam=cam, scene=sc)
        te, tg = dict(_tensors(se)), dict(_tensors(sg))
        check(te.keys() == tg.keys(), "animated: state fields differ")
        for what, a, b in [("display", de, dg), ("radiance", ae, ag)] + [
                (key, te[key], tg[key]) for key in te]:
            check(torch_equal_bits(a, b), f"animated pose {i + 1}: the "
                  f"replayed {what} differs from the eager one")
    check(gm.captures == 1, f"animated: {gm.captures} captures over "
          f"{ANIMATED_POSES} poses")
    log(f"animated graph: {ANIMATED_POSES} poses (the first eager, one "
        f"capture, {ANIMATED_POSES - 2} replays of posed scenes copied in) "
        f"bit for bit equal to Renderer.step's display, radiance and state")
    eager, replay, replay_dev, pose_replay = [], [], [], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(FRAMES - 1):
        k = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, se = re.step(se, cam=cam, cam_moved=True,
                           scene=pose_scene(dyn, bones[k]))
        torch.cuda.synchronize()
        eager.append(time.perf_counter() - t0)
        k = next(it)
        t0 = time.perf_counter()
        ev[0].record()
        sc = pose_scene(dyn, bones[k])
        ev[1].record()
        _, _, sg = gm(sg, cam=cam, scene=sc)
        ev[2].record()
        torch.cuda.synchronize()
        pose_replay.append(time.perf_counter() - t0)
        replay_dev.append(ev[1].elapsed_time(ev[2]))
    # the replay alone, a pose already loaded
    for _ in range(FRAMES - 1):
        t0 = time.perf_counter()
        _, _, sg = gm(sg, cam=cam)
        torch.cuda.synchronize()
        replay.append(time.perf_counter() - t0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            _, _, sg = gm(sg, cam=cam, scene=pose_scene(
                dyn, bones[next(it)]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sc = pose_scene(dyn, bones[next(it)])
    gprof = phase_profile(None, None, lambda: gm(sg, cam=cam, scene=sc),
                          "animated replay (scene load included)")
    check(gm.captures == 1, f"animated: {gm.captures} captures")
    # for scale: a from-scratch host build at one pose
    v = skin_vertices(dyn.mesh, bones[3])
    meshes, mats, _, env = atrium.make(detail=ATRIUM_DETAIL, device=dev)
    mats = list(mats) + [HostMaterial(**ANIMATED_MAT)]
    skin = HostMesh(v.cpu().numpy(), dyn.mesh.tri_vidx.cpu().numpy(),
                    np.full(dyn.mesh.tri_vidx.shape[0], len(mats) - 1,
                            np.int32))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rebuilt = compile_scene(meshes + [skin], mats, env=env, with_cwbvh=True,
                            with_light_bvh=True, leaf_k=3, device=dev)
    rebuilt.cw_table()
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    check(rebuilt.n_tris() == dyn.scene.n_tris(), "rebuild triangle count")
    mean_ms = lambda xs: 1e3 * sum(xs) / len(xs)
    res = dict(ms=ms, warmup_ms=times[0] * 1e3, mean=mean,
               eager_ms=mean_ms(eager), replay_ms=mean_ms(replay),
               pose_replay_ms=mean_ms(pose_replay),
               replay_device_ms=sum(replay_dev) / len(replay_dev),
               captures=gm.captures, poses=ANIMATED_POSES,
               rebuild_s=rebuild_s, profile=gprof, eager_profile=prof)
    log(f"animated {H}x{W}x{ANIMATED['bounces']}, in turns: eager (pose + "
        f"step) {res['eager_ms']:.1f} ms/frame, pose + replay "
        f"{res['pose_replay_ms']:.1f} ms/frame (replay device "
        f"{res['replay_device_ms']:.1f} ms), replay alone "
        f"{res['replay_ms']:.1f} ms; {gm.captures} capture over "
        f"{ANIMATED_POSES + FRAMES + 2} poses; a from-scratch compile_scene "
        f"at one pose: {rebuild_s:.2f} s on the host")
    results["animated"] = res
    results["animated_profile"] = prof
    results["animated_graph"] = dict(
        eager_ms=res["eager_ms"], replay_ms=res["replay_ms"],
        replay_device_ms=res["replay_device_ms"], profile=gprof)
    return launches


def _render_np(scene, cam, W: int, spp: int, **cfg):
    """[W,W,3] numpy mean of spp samples of render() on the card."""
    from truetrace_tpu_torch.integrate.pathtrace import RenderConfig, render
    c = RenderConfig(width=W, height=W, **cfg)
    return render(scene, cam, c, spp=spp).cpu().numpy()


def phase_animated_gates(results):
    """The JAX package's checks of dynamic scenes, run with the port on
    the card: tests/test_refit.py (the identity refit keeps the
    traversal; a twisted refit equals brute force), test_skinning.py (the
    rest pose, the bend, the skinned refit against brute force),
    test_light_refit.py (the refit light tree is conservative, its power
    exact, and its descent's pmf is its pdf), test_dynamic_scene.py (the
    posed image against a rebuild; the pose sequence through the
    Renderer), test_asset_manager.py (every commit renders as a direct
    compile, and the BLAS cache) and test_video_matcap.py (each video
    frame dominates its channel, time binding wraps, the matcap)."""
    import torch
    from truetrace_tpu_torch.build.bvh2 import build_bvh2
    from truetrace_tpu_torch.build.cwbvh import build_cwbvh
    from truetrace_tpu_torch.build.lightbvh import (build_light_bvh,
                                                    build_pairs,
                                                    build_pairs_torch)
    from truetrace_tpu_torch.build.refit import (
        deform_tris, level_worklists, light_level_worklists, refit_cwbvh,
        refit_light_bvh)
    from truetrace_tpu_torch.core import aabb
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        closest_hit_wavefront, pack_leaf_rows, pack_table)
    from truetrace_tpu_torch.kernels.lighttree import (light_tree_pdf,
                                                       sample_light_tree)
    from truetrace_tpu_torch.kernels.traverse_ref import brute_force_closest
    from truetrace_tpu_torch.scene.ir import Camera, light_bvh_depth
    from truetrace_tpu_torch.scene.skinning import (
        bone_matrix, make_two_bone_cylinder, skin_vertices, skinned_tris)
    dev = DEVICE
    out = {}
    tf = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        dev)

    def refit_case(p0, e1, e2, deform=None, bones=None, mesh=None):
        """Build at rest on the host, deform, refit on the card, trace
        against brute force (test_refit / test_skinning)."""
        box = aabb.from_tris(p0, p0 + e1, p0 + e2)
        bvh = build_bvh2(box, max_leaf=3, sah_leaf_cap=3)
        cw = build_cwbvh(bvh, box[bvh.order])
        perm = bvh.order[cw.tri_index]
        if mesh is not None:
            n0, n1, n2 = skinned_tris(mesh, bones)
            p = torch.as_tensor(perm, device=dev)
            n0, n1, n2 = n0[p], n1[p], n2[p]
        else:
            n0, n1, n2 = deform(tf(p0[perm]), tf(e1[perm]), tf(e2[perm]))
        nodes_l, rows = pack_leaf_rows(
            cw.nodes, cw.slot_tri_base, cw.slot_tri_count,
            n0.cpu().numpy(), n1.cpu().numpy(), n2.cpu().numpy())
        i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        nodes2, root = refit_cwbvh(
            torch.as_tensor(nodes_l.view(np.int32), device=dev), n0, n1, n2,
            i64(cw.slot_child), i64(cw.slot_tri_base),
            i64(cw.slot_tri_count), level_worklists(cw.node_depth, dev))
        table = pack_table(nodes2, tf(rows))
        return n0, n1, n2, table, nodes2.shape[0], int(cw.depth) + 1, root

    def rays(seed, R, spread):
        g = np.random.default_rng(seed)
        ro = g.uniform(-spread, spread, (R, 3)).astype(np.float32)
        rd = g.normal(size=(R, 3))
        return tf(ro), tf(rd / np.linalg.norm(rd, axis=-1, keepdims=True))

    # test_refit.py
    p0, e1, e2 = random_tris(1200, seed=2)

    def twist(v):
        ang = 0.08 * v[:, 1]
        c, s = torch.cos(ang), torch.sin(ang)
        return torch.stack([c * v[:, 0] - s * v[:, 2] + 0.5, v[:, 1] * 1.1,
                            s * v[:, 0] + c * v[:, 2] - 0.25], -1)
    n0, n1, n2, table, C, S, _ = refit_case(
        p0, e1, e2, deform=lambda a, b, c: deform_tris(a, b, c, twist))
    ro, rd = rays(3, 384, 15)
    h = closest_hit_wavefront(table, C, ro, rd, 1e30, S)
    bf = brute_force_closest(n0, n1, n2, ro, rd, 1e30)
    hm, bm = h.tri >= 0, bf.tri >= 0
    check(torch.equal(hm, bm) and bool(torch.allclose(
        h.t[hm], bf.t[bm], rtol=1e-4, atol=1e-4)),
        "test_refit_after_deformation_matches_brute_force")
    p0, e1, e2 = random_tris(1200, seed=0)
    n0, n1, n2, table, C, S, root = refit_case(
        p0, e1, e2, deform=lambda a, b, c: (a, b, c))
    box = aabb.from_tris(p0, p0 + e1, p0 + e2)
    bvh = build_bvh2(box, max_leaf=3, sah_leaf_cap=3)
    cw = build_cwbvh(bvh, box[bvh.order])
    perm = bvh.order[cw.tri_index]
    nodes_l, rows = pack_leaf_rows(cw.nodes, cw.slot_tri_base,
                                   cw.slot_tri_count, p0[perm], e1[perm],
                                   e2[perm])
    ro, rd = rays(1, 256, 15)
    h_old = closest_hit_wavefront(pack_table(torch.as_tensor(
        nodes_l.view(np.int32), device=dev), tf(rows)), C, ro, rd, 1e30, S)
    h_new = closest_hit_wavefront(table, C, ro, rd, 1e30, S)
    lo = np.minimum(np.minimum(p0, p0 + e1), p0 + e2).min(0)
    hi = np.maximum(np.maximum(p0, p0 + e1), p0 + e2).max(0)
    check(torch.equal(h_old.tri, h_new.tri)
          and bool((root[0].cpu().numpy() <= lo + 1e-4).all())
          and bool((root[1].cpu().numpy() >= hi - 1e-4).all()),
          "test_refit_identity_preserves_traversal")
    out["refit"] = "pass"

    # test_skinning.py
    mesh = make_two_bone_cylinder(device=dev)
    rest = mesh.rest_verts
    bb = lambda a0, t0, a1, t1: torch.stack([
        bone_matrix(a0, t0, (0, 0, 0), device=dev),
        bone_matrix(a1, t1, (0, 1.0, 0), device=dev)])
    v = skin_vertices(mesh, bb((0, 0, 1), 0.0, (0, 0, 1), 0.0))
    check(float((v - rest).abs().max()) <= 1e-5,
          "test_rest_pose_is_identity")
    v = skin_vertices(mesh, bb((0, 0, 1), 0.0, (0, 0, 1), 0.7))
    root_v, tip_v = rest[:, 1] < 0.2, rest[:, 1] > 1.8
    check(float((v[root_v] - rest[root_v]).abs().max()) < 1e-4
          and float((v[tip_v] - rest[tip_v]).abs().max()) > 0.3,
          "test_bend_moves_tip_not_root")
    r0, r1, r2 = (x.cpu().numpy() for x in skinned_tris(
        mesh, bb((0, 0, 1), 0.0, (0, 0, 1), 0.0)))
    n0, n1, n2, table, C, S, _ = refit_case(
        r0, r1, r2, mesh=mesh, bones=bb((0, 0, 1), 0.1, (1, 0, 0), 0.9))
    ro, rd = rays(5, 256, 4)
    h = closest_hit_wavefront(table, C, ro, rd, 1e30, S)
    bf = brute_force_closest(n0, n1, n2, ro, rd, 1e30)
    hm = h.tri >= 0
    check(torch.equal(hm, bf.tri >= 0) and bool(torch.allclose(
        h.t[hm], bf.t[hm], rtol=1e-4, atol=1e-4)),
        "test_skinned_refit_traversal_matches_brute_force")
    out["skinning"] = "pass"

    # test_light_refit.py
    for seed, move in ((0, False), (3, True)):
        tris, ids, power = light_refit_scene(seed=seed)
        lb = build_light_bvh(tris, ids, power)
        if move:
            ang = 0.5
            R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                          [-np.sin(ang), 0, np.cos(ang)]], np.float32)
            tris = dict(p0=tris["p0"] @ R.T + np.array([1.0, 0.5, -2.0],
                                                       np.float32),
                        e1=tris["e1"] @ R.T, e2=tris["e2"] @ R.T)
        i64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
        nodes2 = refit_light_bvh(
            tf(lb.nodes), i64(lb.info), i64(lb.prim), tf(tris["p0"]),
            tf(tris["e1"]), tf(tris["e2"]), i64(ids), tf(power),
            light_level_worklists(lb.info, dev))
        n_np = nodes2.cpu().numpy()
        check_light_nodes_conservative(n_np, lb.info, lb.prim, tris, ids)
        if not move:
            check(abs(float(n_np[0, 11]) - float(power.sum()))
                  <= 1e-5 * float(power.sum()),
                  "test_identity_refit_conservative_and_power_exact")
            continue
        pairs0, children = build_pairs(lb.nodes, lb.info)
        pairs = build_pairs_torch(nodes2, tf(pairs0), i64(children))
        g = np.random.default_rng(1)
        K = 128
        p = tf(g.uniform(-6, 6, (K, 3)))
        n = tf(np.tile([0, 1, 0], (K, 1)))
        u = tf(g.uniform(0, 1, K))
        depth = light_bvh_depth(lb.info)
        idx, pmf, _ = sample_light_tree(pairs, i64(lb.prim), p, n, u, depth)
        pdf = light_tree_pdf(pairs, torch.as_tensor(
            lb.trail.view(np.int32), device=dev), idx, p, n, depth)
        check(bool(torch.allclose(pmf, pdf, rtol=1e-4, atol=1e-6))
              and bool((pmf > 0).all()),
              "test_refit_after_motion_stays_valid_and_samples")
    out["light_refit"] = "pass"

    # test_dynamic_scene.py
    from truetrace_tpu_torch.renderer import Renderer, RendererConfig
    from truetrace_tpu_torch.scene.dynamic import (compile_dynamic_scene,
                                                   pose_scene)
    from truetrace_tpu_torch.scene.mesh import (HostMaterial, HostMesh,
                                                compile_scene)
    mats = [HostMaterial(base_color=(0.7, 0.7, 0.7)),
            HostMaterial(base_color=(0.6, 0.3, 0.2)),
            HostMaterial(emission=(10.0, 10.0, 10.0))]
    floor = HostMesh(np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4],
                               [-4, 0, 4]], np.float32),
                     np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     np.zeros(2, np.int32))
    light = HostMesh(np.array([[-1, 3.2, -1], [1, 3.2, -1], [1, 3.2, 1],
                               [-1, 3.2, 1]], np.float32),
                     np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     np.full(2, 2, np.int32))
    mesh = make_two_bone_cylinder(n_radial=10, n_height=12, device=dev)
    dyn = compile_dynamic_scene(mesh, 1, mats, static_meshes=[floor, light],
                                device=dev)
    cam = Camera.look_at(eye=(0, 2.5, 5.5), target=(0, 1.0, 0),
                         fov_y_deg=45, device=dev)
    bent = bb((0, 0, 1), 0.15, (1, 0, 0), 0.8)
    posed = pose_scene(dyn, bent)
    v = skin_vertices(mesh, bent).cpu().numpy()
    rebuilt = compile_scene(
        [floor, light, HostMesh(v, mesh.tri_vidx.cpu().numpy(),
                                np.full(mesh.tri_vidx.shape[0], 1,
                                        np.int32))], mats, with_cwbvh=True,
        device=dev)
    kw = dict(bounces=2, bsdf="lambert", traversal="wavefront",
              light_sampling="cdf")
    a = _render_np(posed, cam, 24, 12, **kw)
    b = _render_np(rebuilt, cam, 24, 12, **kw)
    close = np.abs(a - b).mean(-1) / np.maximum(b.mean(-1), 0.05)
    check(np.isfinite(a).all() and a.mean() > 0.01
          and abs(a.mean() - b.mean()) <= 0.02 * b.mean()
          and float(np.mean(close < 0.5)) > 0.92,
          "test_pose_refit_matches_rebuild_image")
    r = Renderer(dyn.scene, cam, RendererConfig(width=24, height=24,
                                                denoiser="svgf", **kw))
    st = r.init_state()
    for k in range(4):
        disp, rad, st = r.step(st, scene=pose_scene(dyn, bb(
            (0, 0, 1), 0.05 * k, (1, 0, 0), 0.25 * k)))
        check(bool(torch.isfinite(disp).all()), "animated sequence finite")
    check(float(st.accum.count) == 1.0 and float(rad.max()) > 0.0,
          "test_animated_sequence_through_renderer")
    out["dynamic_scene"] = "pass"

    # test_asset_manager.py
    import truetrace_tpu_torch.scene.asset_manager as am_mod
    from truetrace_tpu_torch.scene.instances import (compile_scene_instanced,
                                                     make_transform)
    sources, amats, instances = instanced_sources()
    acam = Camera.look_at(eye=(0, 3.0, 6.0), target=(0, 0.5, 0),
                          fov_y_deg=45, device=dev)
    akw = dict(bounces=2, bsdf="lambert", traversal="tlas",
               light_sampling="cdf")
    img = lambda sc: _render_np(sc, acam, 24, 8, **akw)

    def same_image(sc, srcs, ms, insts, what):
        ref, _ = compile_scene_instanced(srcs, ms, insts, device=dev)
        check(np.allclose(img(sc), img(ref), rtol=1e-4, atol=1e-5), what)

    def manager():
        am = am_mod.AssetManager(materials=list(amats), device=dev)
        src_h = [am.add_mesh(s) for s in sources]
        inst_h = [am.add_instance(src_h[s], m) for s, m in instances]
        return am, src_h, inst_h

    am, _, _ = manager()
    same_image(am.commit(), sources, amats, instances,
               "test_commit_matches_direct_compile")
    calls = []
    orig = am_mod.build_source
    am_mod.build_source = lambda m, **k: calls.append(m) or orig(m, **k)
    try:
        am, src_h, inst_h = manager()
        am.commit()
        calls.clear()
        m_new = make_transform((-0.6, 0.7, 0.4), rot_y=1.1)
        am.set_transform(inst_h[1], m_new)
        moved = list(instances)
        moved[1] = (moved[1][0], m_new)
        same_image(am.commit(), sources, amats, moved,
                   "test_transform_update_fast_path")
        check(calls == [], "a transform commit rebuilt a BLAS")
        m_add = make_transform((0.0, 0.4, 1.5), rot_y=0.9, scale=0.6)
        am.add_instance(src_h[0], m_add)
        am.remove_instance(inst_h[2])
        same_image(am.commit(), sources, amats,
                   [moved[0], moved[1], moved[3], (0, m_add)],
                   "test_add_remove_instance_and_blas_cache")
        check(calls == [], "an instance add / remove rebuilt a BLAS")
        am, src_h, _ = manager()
        am.commit()
        calls.clear()
        bigger = HostMesh(sources[0].positions * 1.4, sources[0].indices,
                          sources[0].mat_id)
        am.update_mesh(src_h[0], bigger)
        same_image(am.commit(), [bigger] + sources[1:], amats, instances,
                   "test_update_mesh_rebuilds_only_that_source")
        check(len(calls) == 1, "update_mesh rebuilt more than its source")
    finally:
        am_mod.build_source = orig
    am, src_h, _ = manager()
    am.commit()
    blue = HostMaterial(base_color=(0.2, 0.6, 0.9))
    am.set_material(1, blue)
    check(not am._topology_dirty, "a colour edit is a topology change")
    mats2 = list(amats)
    mats2[1] = blue
    same_image(am.commit(), sources, mats2, instances,
               "test_material_edit_no_rebuild_unless_emission")
    lit = HostMaterial(base_color=(0.2, 0.6, 0.9), emission=(3.0, 3.0, 3.0))
    am.set_material(1, lit)
    check(am._topology_dirty, "an emission edit is no topology change")
    mats2[1] = lit
    same_image(am.commit(), sources, mats2, instances,
               "test_material_edit_no_rebuild_unless_emission (emission)")
    am.remove_mesh(src_h[0])
    same_image(am.commit(), sources[1:], mats2,
               [(s - 1, m) for s, m in instances if s != 0],
               "test_remove_mesh_drops_its_instances")
    out["asset_manager"] = "pass"

    # test_video_matcap.py
    from truetrace_tpu_torch.scene.atlas import AtlasBuilder
    from truetrace_tpu_torch.scene.ir import EnvMap
    from truetrace_tpu_torch.scene.video import (bind_video_frame,
                                                 bind_video_time,
                                                 register_video)
    quad = HostMesh(np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0],
                              [-1, 1, 0]], np.float32),
                    np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                    np.zeros(2, np.int32),
                    uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]],
                                 np.float32))
    vcam = Camera.look_at(eye=(0, 0, 3), target=(0, 0, 0), fov_y_deg=45,
                          device=dev)
    builder = AtlasBuilder()
    frames = np.zeros((3, 8, 8, 3), np.float32)
    for k in range(3):
        frames[k, ..., k] = 1.0
    vid = register_video(builder, frames, fps=10.0, device=dev)
    atlas, rects, level_y = builder.build()
    vscene = compile_scene(
        [quad], [HostMaterial(base_color=(1, 1, 1), emission=(4, 4, 4),
                              tex_emission=vid.tex_id)],
        env=EnvMap.constant((0, 0, 0), dev), atlas=atlas, atlas_rects=rects,
        atlas_level_y=level_y, with_cwbvh=True, device=dev)
    vkw = dict(bounces=1, bsdf="lambert", traversal="wavefront")
    for k in range(3):
        m = _render_np(bind_video_frame(vscene, vid, k), vcam, 16, 4,
                       **vkw).reshape(-1, 3).mean(0)
        check(m[k] > 2.0 * (m.sum() - m[k]) + 1e-6,
              f"test_video_frame_binding (frame {k}: {m})")
    check(torch.equal(bind_video_time(vscene, vid, 0.25).atlas,
                      bind_video_frame(vscene, vid, 5).atlas),
          "test_video_time_binding_wraps")
    builder = AtlasBuilder()
    mc = np.zeros((16, 16, 3), np.float32)
    mc[..., 0] = 1.0
    mc_id = builder.add(mc)
    atlas, rects, level_y = builder.build()
    env = EnvMap.constant((1.0, 1.0, 1.0), dev)
    mkw = dict(bounces=2, bsdf="lambert", traversal="wavefront")
    c = [_render_np(compile_scene(
        [quad], [HostMaterial(base_color=(1, 1, 1), **x)], env=env,
        atlas=atlas, atlas_rects=rects, atlas_level_y=level_y,
        with_cwbvh=True, device=dev), vcam, 16, 4, **mkw).reshape(
            -1, 3).mean(0) for x in ({}, dict(tex_matcap=mc_id))]
    check(abs(c[1][0] - c[0][0]) < 0.05 and c[1][1] < 0.5 * c[0][1]
          and c[1][2] < 0.5 * c[0][2], "test_matcap_modulates_primary")
    out["video_matcap"] = "pass"
    log(f"animated gates (the JAX package's dynamic-scene checks with the "
        f"port on the card): {out}")
    results["animated_gates"] = out


def random_tris(n, seed=0, spread=10.0, size=0.5):
    """tests/test_bvh2.py's random triangles (p0, e1, e2)."""
    r = np.random.default_rng(seed)
    p0 = (r.uniform(-1, 1, size=(n, 3)) * spread).astype(np.float32)
    e1 = (r.normal(size=(n, 3)) * size).astype(np.float32)
    e2 = (r.normal(size=(n, 3)) * size).astype(np.float32)
    return p0, e1, e2


def light_refit_scene(n_lights=24, seed=0):
    """tests/test_light_refit.py's emissive triangles: (tris, ids,
    power)."""
    rng = np.random.default_rng(seed)
    p0 = rng.uniform(-5, 5, (n_lights, 3)).astype(np.float32)
    e1 = rng.uniform(-0.4, 0.4, (n_lights, 3)).astype(np.float32)
    e2 = rng.uniform(-0.4, 0.4, (n_lights, 3)).astype(np.float32)
    ids = np.arange(n_lights, dtype=np.int32)
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    power = (area * rng.uniform(1, 5, n_lights)).astype(np.float32)
    return dict(p0=p0, e1=e1, e2=e2), ids, power


def check_light_nodes_conservative(nodes, info, prim, tris, ids):
    """tests/test_light_refit.py's check: every light under a node lies
    inside its box and its cone."""
    p0, e1, e2 = tris["p0"], tris["e1"], tris["e2"]
    gn = np.cross(e1, e2)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)

    def lights_under(n):
        if info[n, 1] > 0:
            return [prim[info[n, 0] + k] for k in range(info[n, 1])]
        return lights_under(info[n, 0]) + lights_under(-info[n, 1])

    for n in range(nodes.shape[0]):
        lo, hi = nodes[n, 0:3], nodes[n, 3:6]
        theta_o = np.arccos(np.clip(nodes[n, 9], -1, 1))
        for li in lights_under(n):
            t = ids[li]
            for v in (p0[t], p0[t] + e1[t], p0[t] + e2[t]):
                check(bool((v >= lo - 1e-3).all() and (v <= hi + 1e-3).all()),
                      f"light node {n}: light {li} outside its box")
            ang = np.arccos(np.clip(np.dot(nodes[n, 6:9], gn[t]), -1, 1))
            check(ang <= theta_o + 1e-3, f"light node {n}: light {li} "
                  f"outside its cone")


def instanced_sources():
    """tests/test_instanced_render.py's sources (a box, a floor, a light
    facing down) and four instances, from the port's classes."""
    from truetrace_tpu_torch.scene.instances import make_transform
    from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
    mats = [HostMaterial(base_color=(0.75, 0.75, 0.75)),
            HostMaterial(base_color=(0.8, 0.2, 0.2)),
            HostMaterial(emission=(12.0, 11.0, 10.0))]
    bv = np.array([[x, y, z] for x in (-.4, .4) for y in (-.4, .4)
                   for z in (-.4, .4)], np.float32)
    bf = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                   [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int32)
    quad = lambda y, h: np.array([[-h, y, -h], [h, y, -h], [h, y, h],
                                  [-h, y, h]], np.float32)
    up = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    sources = [HostMesh(bv, bf, np.ones(12, np.int32)),
               HostMesh(quad(0.0, 4.0), up, np.zeros(2, np.int32)),
               HostMesh(quad(0.0, 0.6), up[:, ::-1].copy(),
                        np.full(2, 2, np.int32))]
    instances = [(1, make_transform((0, 0, 0))),
                 (0, make_transform((-1.2, 0.4, 0.0), rot_y=0.4)),
                 (0, make_transform((1.1, 0.4, -0.6), rot_y=-0.7,
                                    scale=0.8)),
                 (2, make_transform((0.0, 2.5, 0.0), rot_y=0.3))]
    return sources, mats, instances


def phase_animated_card_vs_cpu(results):
    """The animated frame small (the atrium at detail 0.2 with a 16 x 24
    cylinder) at 16x16, three frames on the card and on the CPU, the pose
    changing every frame: the displays within 1e-3 on >= 98% of
    pixels."""
    import torch
    small = dict(ANIMATED, width=16, height=16, bounces=3)
    frames = {}
    for dev in (DEVICE, "cpu"):
        dyn, cam = animated_scene(dev, detail=0.2, n_radial=16, n_height=24)
        posed = animated_poses(dyn, [0, 3, 6])
        r = make_renderer(dyn.scene, cam, small)
        st = r.init_state()
        out = []
        for sc in posed:
            d, _, st = r.step(st, cam=cam, cam_moved=True, scene=sc)
            out.append(d.cpu())
        frames[dev] = out
    shares = []
    for a, b in zip(frames[DEVICE], frames["cpu"]):
        shares.append(float(((a - b).abs() <= 1e-3).all(-1).float().mean()))
        check(bool(torch.isfinite(a).all()) and shares[-1] >= 0.98,
              f"animated card vs CPU: {shares[-1]:.4f} of pixels within "
              f"1e-3")
    log(f"animated 16x16 card vs CPU, three poses: display shares within "
        f"1e-3 {[round(s, 4) for s in shares]}")
    results["animated_card_vs_cpu"] = dict(display_share=shares)


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
    ("transmit_wavefront", "truetrace_tpu_torch/kernels/csrc/traverse.cu",
     "truetrace_tpu/kernels/cwbvh_wavefront.py:1039",
     "traverse_kernel<6,2>"),
    ("step_core", "truetrace_tpu_torch/kernels/csrc/step_core.cu",
     "truetrace_tpu/kernels/step_pallas.py:120", "step_core_kernel"),
    ("atrous_pass", "truetrace_tpu_torch/kernels/csrc/atrous.cu",
     "truetrace_tpu/kernels/atrous_pallas.py:110",
     "atrous_staged|atrous_direct"),
    ("closest_hit_tlas", "truetrace_tpu_torch/kernels/csrc/traverse_tlas.cu",
     "truetrace_tpu/kernels/cwbvh_tlas.py:483", "tlas_kernel"),
    ("any_hit_tlas", "truetrace_tpu_torch/kernels/csrc/traverse_tlas.cu",
     "truetrace_tpu/kernels/cwbvh_tlas.py:492", "tlas_kernel<6,1>"),
    ("transmit_tlas", "truetrace_tpu_torch/kernels/csrc/traverse_tlas.cu",
     "truetrace_tpu/kernels/cwbvh_tlas.py:422", "tlas_kernel<6,2>"),
    ("heightmap_closest", "truetrace_tpu_torch/kernels/csrc/heightmap.cu",
     "truetrace_tpu/kernels/heightmap.py:87", "heightmap_kernel<1>"),
    ("heightmap_any", "truetrace_tpu_torch/kernels/csrc/heightmap.cu",
     "truetrace_tpu/kernels/heightmap.py:137", "heightmap_kernel<0>"),
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


PATH_KERNELS = ("closest_hit_wavefront", "any_hit_wavefront",
                "transmit_wavefront", "atrous_pass", "closest_hit_tlas",
                "any_hit_tlas", "transmit_tlas", "heightmap_closest",
                "heightmap_any")
# the hand kernels each path launches (phase_frame fails where one of
# them never does): the opaque frames' NEE shadow rays take the any hit,
# the glass frame's the transmittance; ReCur filters without a-trous
_OPAQUE = ("closest_hit_wavefront", "any_hit_wavefront", "atrous_pass")
PATHS = {"atrium": _OPAQUE, "composed": _OPAQUE, "sponza": _OPAQUE,
         "asvgf": _OPAQUE, "composed_asvgf": _OPAQUE,
         "recur": ("closest_hit_wavefront", "any_hit_wavefront"),
         "glass": ("closest_hit_wavefront", "transmit_wavefront",
                   "atrous_pass"),
         "post": _OPAQUE, "interactive": _OPAQUE,
         "neural": ("closest_hit_wavefront", "any_hit_wavefront"),
         "forest": ("closest_hit_tlas", "any_hit_tlas", "heightmap_closest",
                    "heightmap_any", "atrous_pass"),
         "tinted": ("closest_hit_tlas", "transmit_tlas", "atrous_pass"),
         "animated": _OPAQUE}
# the frames after the first three, each with its own launch counts in
# the kernels line
NEW_PATHS = ("asvgf", "recur", "composed_asvgf", "glass", "post",
             "interactive", "neural", "forest", "animated")
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
    log(f"card (name, power limit): {card}")

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
    phase_profile_sees_syncs()
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
    from truetrace_tpu_torch.kernels.cwbvh_tlas import MAX_STACK
    smem_tlas = _cuda.lib("traverse_tlas.cu").tt_tlas_smem(MAX_STACK)
    del renderer, state

    c_launches, renderer, state = phase_frame(results, scenes[6], cam,
                                              "composed", COMPOSED)
    state = phase_sync_free(renderer, state, cam, "composed")
    results["composed_profile"] = phase_profile(renderer, state,
                                                label="composed frame")
    phase_composed_cache(results, renderer, state)
    del renderer, state
    phase_graph(results, scenes[6], cam, "composed", COMPOSED)
    phase_transmit_atrium(results, scenes[6], cam)
    new_launches = {}
    for label, cfg in (("asvgf", ASVGF), ("recur", RECUR),
                       ("composed_asvgf", COMPOSED_ASVGF)):
        new_launches[label] = run_path(results, scenes[6], cam, label, cfg)
    phase_asvgf_split(results, scenes[6], cam)
    new_launches["post"] = run_path(
        results, scenes[6], cam, "post", POST_FRAME,
        hook=lambda r, st: phase_post_tonemaps(results, st.accum.image))
    new_launches["neural"] = run_path(
        results, scenes[6], cam, "neural", NEURAL,
        hook=lambda r, st: phase_unet(results, r.neural, st.accum.image))
    del scenes
    glass, g_cam = nested_glass_scene(DEVICE)
    log(f"nested glass scene: {glass.n_tris()} triangles, "
        f"{glass.cw_nodes.shape[0]} nodes, K = "
        f"{glass.cw_leaf_rows.shape[1] // 10}, stack {glass.cw_stack}, "
        f"media {glass.has_media}")
    phase_transmit_glass(results, glass, g_cam)
    new_launches["glass"] = run_path(results, glass, g_cam, "glass", GLASS)
    del glass

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
    new_launches["interactive"] = run_path(
        results, sponza_lit(sponza, parts[0]), s_cam, "interactive",
        INTERACTIVE)
    del parts, sponza
    phase_cornell()
    phase_composed_gates(results)
    phase_composed_card_vs_cpu(results)
    phase_glass_gates(results)
    phase_glass_card_vs_cpu(results)
    phase_modes_gates(results)
    phase_modes_card_vs_cpu(results)

    forest, isc, f_mats, f_inst, f_cam = forest_scene(DEVICE, **FOREST_SIZE)
    n_trees = len(f_inst) - FOREST_SIZE["n_lanterns"]
    log(f"forest: {len(f_inst)} instances ({n_trees} "
        f"trees of {FOREST_SIZE['n_trees']} placed, "
        f"{FOREST_SIZE['n_lanterns']} lanterns), {forest.n_tris()} "
        f"triangles ({forest.light_tris.tri_index.shape[0]} world light "
        f"rows), {forest.cw_nodes.shape[0]} nodes ({isc.n_tlas_nodes} TLAS), "
        f"{forest.cw_leaf_rows.shape[0]} leaf rows, K = "
        f"{forest.cw_leaf_rows.shape[1] // 10}, terrain "
        f"{forest.terrain.hm_shape}")
    phase_forest_kernels(results, forest, f_cam)
    new_launches["forest"] = phase_forest(results, forest, isc, f_mats,
                                          f_inst, f_cam)
    del forest, isc
    new_launches["tinted"] = phase_tinted_tlas(results)
    phase_forest_gates(results)
    phase_forest_card_vs_cpu(results)

    t0 = time.perf_counter()
    dyn, a_cam = animated_scene(DEVICE)
    log(f"animated atrium: {dyn.scene.n_tris()} triangles "
        f"({dyn.skin_tri_ids.shape[0]} skinned), "
        f"{dyn.scene.cw_nodes.shape[0]} nodes, "
        f"{dyn.scene.cw_leaf_rows.shape[0]} leaf rows, K = "
        f"{dyn.scene.cw_leaf_rows.shape[1] // 10}, {len(dyn.levels)} refit "
        f"levels, stack {dyn.scene.cw_stack}; compile_dynamic_scene "
        f"{time.perf_counter() - t0:.1f} s")
    check(dyn.scene.n_tris() == ANIMATED_TRIS,
          f"animated atrium: {dyn.scene.n_tris()} triangles")
    phase_animated_pose(results, dyn)
    phase_animated_kernels(results, dyn, a_cam)
    new_launches["animated"] = phase_animated(results, dyn, a_cam)
    del dyn
    phase_animated_gates(results)
    phase_animated_card_vs_cpu(results)

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
    p = results["composed_profile"]
    log(f"frame composed {FRAME['width']}x{FRAME['height']}x"
        f"{FRAME['bounces']} (cache, ReSTIR GI and DI, svgf): "
        f"{results['composed']['ms']:.1f} ms (median "
        f"{results['composed']['median_ms']:.1f}); device busy "
        f"{p['busy_ms']:.1f} ms in {p['kernels']} kernels, traversal "
        f"{p['traversal_ms']:.3f} ms, a-trous {p['atrous_ms']:.3f} ms, "
        f"index_put sort and sums {p['scatter_ms']:.3f} ms; cache_update "
        f"alone {results['composed_cache']['update_ms']:.4f} ms")
    frames = {}
    for label, prof in (("atrium", "profile"), ("sponza", "sponza_profile"),
                        ("composed", "composed_profile")) + tuple(
                            (n, f"{n}_profile") for n in NEW_PATHS):
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
    frames["asvgf"]["split"] = {
        f: {k: p[k] for k in ("kernels", "busy_ms", "traversal_ms")}
        for f, p in results["asvgf_split"].items()}
    frames["glass"].update(gates=results["glass_gates"],
                           card_vs_cpu=results["glass_card_vs_cpu"])
    frames["post"]["tonemaps"] = results["post_tonemaps"]
    frames["neural"]["unet"] = results["unet"]
    for label in ("post", "interactive", "neural"):
        frames[label]["card_vs_cpu"] = results["modes_card_vs_cpu"][label]
    frames["interactive"]["gates"] = results["modes_gates"]
    frames["forest"].update(
        captures=results["forest"]["captures"],
        update_s=results["forest"]["update_s"],
        instances=results["forest"]["instances"],
        gates=results["forest_gates"],
        card_vs_cpu=results["forest_card_vs_cpu"])
    frames["animated"].update(
        **{k: results["animated"][k] for k in (
            "captures", "poses", "rebuild_s", "pose_replay_ms")},
        pose=results["animated_pose"], gates=results["animated_gates"],
        card_vs_cpu=results["animated_card_vs_cpu"])
    frames["composed"].update(
        scatter_ms=results["composed_profile"]["scatter_ms"],
        cache_update_ms=results["composed_cache"]["update_ms"],
        **{k: results[k] for k in ("composed_gates",
                                   "composed_card_vs_cpu")})
    a = results["atrous_pass"]
    log("a-trous kernel ms by step: " + ", ".join(
        f"{k}: {v:.5f}" for k, v in a["ms_by_step"].items())
        + f"; mean {a['ms']:.5f} = {a['bound_ms'] / a['ms']:.3f} of the "
        f"bound; packing {a['pack_ms']:.5f} ms a frame")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    # library_ms: no single PyTorch call computes any of these functions
    # each kernel's main path: the atrium frame's, the glass frame's for
    # the transmittance (the opaque frames shoot no such ray)
    # the two-level kernels' and the march's main path is the forest's,
    # transmit_tlas's the tinted TLAS frame's (the forest is opaque)
    main_launches = dict(launches,
                         transmit_wavefront=new_launches["glass"][
                             "transmit_wavefront"])
    main_launches.update({k: new_launches["forest"][k] for k in (
        "closest_hit_tlas", "any_hit_tlas", "heightmap_closest",
        "heightmap_any")}, transmit_tlas=new_launches["tinted"][
            "transmit_tlas"])
    rows = {}
    src_of = {name: src for name, src, _, _ in KERNELS}
    for name, src, rep, _ in KERNELS:
        res = results[name]
        n = main_launches[name]
        rows[name] = dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=n, max_abs_err=res["max_abs_err"],
            ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=None, launches_per_frame=n / FRAMES,
            share_of_bound=res["bound_ms"] / res["ms"],
            ptxas=ptxas[name], **{k: res[k] for k in (
                "work", "ms_by_step", "plain_ms_by_step", "pack_ms",
                "filter_ms", "atrium_frame_max_abs_err", "by_lanes",
                "any_hit_ms", "shares", "rays")
                if k in res})
        rows[name]["sponza"] = sponza_row(name, results, s_launches)
        for label, ln in [("atrium", launches), ("composed", c_launches)] + [
                (p, new_launches[p]) for p in NEW_PATHS + ("tinted",)]:
            rows[name].setdefault(label, {}).update(
                launches=ln[name], launches_per_frame=ln[name] / FRAMES)
    rows["transmit_wavefront"]["atrium"].update(results["transmit_atrium"])
    rows["transmit_tlas"]["forest"].update(results["transmit_tlas_forest"])
    rows["transmit_tlas"]["main_path"] = "tinted"
    # the K = 3 traversal, which only the animated frame runs at full
    # size: its time and bound on that frame's bounce-0 rays
    for name, q, inst in (("closest_hit_wavefront", "closest", "<3,0>"),
                          ("any_hit_wavefront", "any", "<3,1>")):
        rows[name]["animated"].update(
            k=3, ptxas=ptxas_of(src_of[name], "traverse_kernel" + inst),
            **results["animated_kernels"][q])
    for name in ("closest_hit_wavefront", "any_hit_wavefront",
                 "transmit_wavefront"):
        # the ring stack's dynamic shared memory, as the launch sizes it
        rows[name]["smem_dynamic"] = smem
    for name in ("closest_hit_tlas", "any_hit_tlas", "transmit_tlas"):
        rows[name]["smem_dynamic"] = smem_tlas
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
