#!/usr/bin/env python3
"""Drive the torch port (`truetrace_tpu_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on a failed check:

1. the card's name and power limit; build every CUDA kernel of the port
   from `truetrace_tpu_torch/kernels/csrc/` (one nvcc per source);
2. every kernel against its plain PyTorch version on the same inputs, at
   the main path's shapes: the a-trous pass at 512x512 for steps 1-16,
   the traversal step core at R = 65536 (K = 3 rows of the atrium), and
   closest / any hit on the 293k-triangle atrium at K = 6 and K = 3 with
   bench.py's ray mix (primary, cosine-bounce and shadow rays) at the
   frame's 262144 rays per class, and Mrays/s at that count and at
   bench.py's 131072;
3. the main path: `Renderer.step` on the atrium, 512x512, 4 bounces,
   Disney BSDF, light-tree NEE and SVGF; 1 warm-up and 4 timed frames,
   with every kernel's launch count read around exactly that run, then
   one more frame under torch.profiler (device time by kernel, and the
   device's busy share of the frame);
4. correctness of the output: a Cornell box rendered on the card agrees
   with the same render on the CPU, and passes the physics checks of
   scripts/verify_drive.py at 256x256.

It prints the card line, one JSON line of kernel results, and as its last
line {"ok": true, "device": {...}}. It exits non-zero, with no result
line, when there is no CUDA card or the port's package is missing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
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
# a-trous kernel vs plain: same arithmetic, but expf/powf on the card and
# torch's exp/pow differ in the last ulps, which the normalised sums carry
ATROUS_RTOL, ATROUS_ATOL = 1e-4, 1e-5


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

def phase_atrous(results):
    import torch
    from truetrace_tpu_torch.kernels.atrous_pallas import (
        atrous_pass, atrous_pass_plain)
    r = np.random.default_rng(7)
    H = W = 512
    n = r.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    dev = DEVICE
    color = torch.from_numpy(r.uniform(0, 3, (H, W, 3)).astype(
        np.float32)).to(dev)
    var = torch.from_numpy(r.uniform(0, 0.5, (H, W)).astype(
        np.float32)).to(dev)
    normal = torch.from_numpy(n).to(dev)
    depth = torch.from_numpy(r.uniform(0.5, 10, (H, W)).astype(
        np.float32)).to(dev)
    err, ms, plain_ms = 0.0, [], []
    for step in (1, 2, 4, 8, 16):
        c1, v1 = atrous_pass(color, var, normal, depth, step)
        c2, v2 = atrous_pass_plain(color, var, normal, depth, step)
        torch.cuda.synchronize()
        for a, b in ((c1, c2), (v1, v2)):
            d = (a - b).abs()
            e = float(d.max())
            check(bool((d <= ATROUS_ATOL + ATROUS_RTOL * b.abs()).all()),
                  f"atrous_pass step {step}: max |diff| {e}")
            err = max(err, e)
        k = cuda_ms(lambda: atrous_pass(color, var, normal, depth, step), 20)
        p = cuda_ms(lambda: atrous_pass_plain(color, var, normal, depth,
                                              step), 3)
        ms.append(k)
        plain_ms.append(p)
        log(f"atrous_pass 512x512 step {step}: kernel {k:.4f} ms, "
            f"plain {p:.4f} ms, max |diff| {err:.3g}")
    results["atrous_pass"] = dict(
        max_abs_err=err, ms=sum(ms) / len(ms),
        plain_ms=sum(plain_ms) / len(plain_ms))


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


def phase_traversal(results, scenes, cam):
    """Kernel against plain on the bench mix at the frame's lane count
    (512 x 512 rays per class, the shape Renderer.step hands the
    traversal); kernel times at that count and at bench.py's 131072."""
    import torch
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        any_hit_plain, any_hit_wavefront, closest_hit_plain,
        closest_hit_wavefront)
    R = FRAME["width"] * FRAME["height"]
    for k, scene in scenes.items():
        table, C, S = scene.cw_table(), scene.cw_nodes.shape[0], \
            scene.cw_stack
        ro_p, rd_p, ro_b, rd_b, tm_b = bench_rays(scene, cam, R)
        plain, err = {}, {}
        for name, ro, rd in (("primary", ro_p, rd_p),
                             ("bounce", ro_b, rd_b)):
            hk = closest_hit_wavefront(table, C, ro, rd, 1e30, S)
            hp = closest_hit_plain(table, C, ro, rd, 1e30, S)
            for f in ("t", "tri", "u", "v"):
                a, b = getattr(hk, f), getattr(hp, f)
                check(torch_equal_bits(a, b),
                      f"closest hit K={k} {name}: {f} differs on "
                      f"{int((a != b.to(a.dtype)).sum())} of {R} rays")
            err["closest"] = max(err.get("closest", 0.0),
                                 max_abs_diff(hk.t, hp.t))
            hit_share = float((hk.tri >= 0).float().mean())
            check(hit_share > 0.5, f"closest hit K={k} {name}: only "
                  f"{hit_share:.3f} of rays hit")
            log(f"closest hit K={k} {name}: bitwise equal to plain "
                f"(t, tri, u, v) on {R} rays; {hit_share:.3f} hit")
            plain[name] = cuda_ms(lambda: closest_hit_plain(
                table, C, ro, rd, 1e30, S), 1)
        ok = any_hit_wavefront(table, C, ro_b, rd_b, tm_b, S)
        op = any_hit_plain(table, C, ro_b, rd_b, tm_b, S)
        check(torch.equal(ok, op), f"any hit K={k}: occlusion differs on "
              f"{int((ok != op).sum())} of {R} rays")
        err["any"] = max_abs_diff(ok.float(), op.float())
        log(f"any hit K={k} shadow: occlusion equal to plain on {R} rays; "
            f"{float(ok.float().mean()):.3f} blocked")
        plain["any"] = cuda_ms(lambda: any_hit_plain(
            table, C, ro_b, rd_b, tm_b, S), 1)

        for n in (BENCH_RAYS, R):
            t_cp = cuda_ms(lambda: closest_hit_wavefront(
                table, C, ro_p[:n], rd_p[:n], 1e30, S), 20)
            t_cb = cuda_ms(lambda: closest_hit_wavefront(
                table, C, ro_b[:n], rd_b[:n], 1e30, S), 20)
            t_an = cuda_ms(lambda: any_hit_wavefront(
                table, C, ro_b[:n], rd_b[:n], tm_b[:n], S), 20)
            mrays = 3 * n / ((t_cp + t_cb + t_an) * 1e-3) / 1e6
            log(f"traversal K={k} (bench mix, {n} rays per class): closest "
                f"primary {t_cp:.3f} ms, closest bounce {t_cb:.3f} ms, any "
                f"hit {t_an:.3f} ms -> {mrays:.2f} Mrays/s")
            results[f"traversal_k{k}_{n}"] = dict(mrays=mrays)
        log(f"traversal K={k} plain at {R} rays: closest primary "
            f"{plain['primary']:.1f} ms, closest bounce "
            f"{plain['bounce']:.1f} ms, any hit {plain['any']:.1f} ms")
        if k == 6:
            results["closest_hit_wavefront"] = dict(
                max_abs_err=err["closest"], ms=(t_cp + t_cb) / 2,
                plain_ms=(plain["primary"] + plain["bounce"]) / 2)
            results["any_hit_wavefront"] = dict(
                max_abs_err=err["any"], ms=t_an, plain_ms=plain["any"])


def phase_step_core(results, scene3, cam):
    """step_core at R = 65536 on rows of the K = 3 atrium table: leaf
    lanes get the leaf row holding the triangle a traversal found for the
    same ray (so Moller tests hit), node lanes a random node row."""
    import torch
    from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
        closest_hit_wavefront)
    from truetrace_tpu_torch.kernels.step_pallas import (
        step_core, step_core_plain)
    R = 65536
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
    out_k = step_core(rowt, ray9, st5)
    out_p = step_core_plain(rowt, ray9, st5)
    check(torch.equal(out_k, out_p),
          f"step_core: {int((out_k != out_p).any(0).sum())} of {R} lanes "
          f"differ")
    n_hit = int((out_k[1] >= 0).sum())
    check(n_hit > R // 8, f"step_core: only {n_hit} Moller hits")
    # t, u, v rows as float32; tri and the hits group as integers
    f_rows = [0, 2, 3]
    err = max(max_abs_diff(out_k[f_rows].view(torch.float32),
                           out_p[f_rows].view(torch.float32)),
              max_abs_diff(out_k, out_p))
    k = cuda_ms(lambda: step_core(rowt, ray9, st5), 50)
    p = cuda_ms(lambda: step_core_plain(rowt, ray9, st5), 3)
    log(f"step_core R={R}: bitwise equal to plain ({n_hit} hits); "
        f"kernel {k:.4f} ms, plain {p:.3f} ms")
    results["step_core"] = dict(max_abs_err=err, ms=k, plain_ms=p)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def launch_counters():
    from truetrace_tpu_torch.kernels import atrous_pallas, cwbvh_wavefront
    from truetrace_tpu_torch.kernels import step_pallas
    return {"closest_hit_wavefront": cwbvh_wavefront.closest_hit_wavefront,
            "any_hit_wavefront": cwbvh_wavefront.any_hit_wavefront,
            "step_core": step_pallas.step_core,
            "atrous_pass": atrous_pallas.atrous_pass}


def phase_frame(results, scene, cam):
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
    for _ in range(4):
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
    log(f"frame atrium {H}x{W}x{FRAME['bounces']} svgf: warm-up "
        f"{warm * 1e3:.1f} ms, frames {[round(t * 1e3, 1) for t in times]}"
        f" ms -> mean {ms:.1f} ms/frame, median {med:.1f}; radiance mean "
        f"{mean:.4f}")
    log(f"launches over the 5 frames: {launches}")
    for name in PATH_KERNELS:
        check(launches[name] > 0, f"{name} never launched on the main path")
    results["frame"] = dict(ms=ms, median_ms=med, warmup_ms=warm * 1e3,
                            mean=mean)
    return launches, r, state


def phase_profile(r, state):
    """One more frame under torch.profiler: device time by kernel, the
    number of kernels, and the device's busy share of the frame's wall
    time (one stream, so kernel times do not overlap). The profiler's
    own overhead inflates the wall time; the busy time is the kernels'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    log(f"profiled frame: wall {wall * 1e3:.1f} ms, {n} kernels, device "
        f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        log(f"  {dev_us(e) / 1e3:8.3f} ms  {e.count:6d}x  {e.key[:100]}")
    return dict(kernels=n, busy_ms=busy)


# ---------------------------------------------------------------------------
# phase 4: correctness of the output
# ---------------------------------------------------------------------------

def phase_cornell():
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render, render_sample)
    from truetrace_tpu_torch.scene import cornell
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam = cornell.make()
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

KERNELS = (
    ("closest_hit_wavefront", "truetrace_tpu_torch/kernels/csrc/traverse.cu",
     "truetrace_tpu/kernels/cwbvh_wavefront.py:861"),
    ("any_hit_wavefront", "truetrace_tpu_torch/kernels/csrc/traverse.cu",
     "truetrace_tpu/kernels/cwbvh_wavefront.py:927"),
    ("step_core", "truetrace_tpu_torch/kernels/csrc/step_core.cu",
     "truetrace_tpu/kernels/step_pallas.py:120"),
    ("atrous_pass", "truetrace_tpu_torch/kernels/csrc/atrous.cu",
     "truetrace_tpu/kernels/atrous_pallas.py:110"),
)


PATH_KERNELS = ("closest_hit_wavefront", "any_hit_wavefront", "atrous_pass")


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
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_cuda.NVCC_FLAGS[:3])})")
    for src, out in _cuda.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    results = {}
    phase_atrous(results)

    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.mesh import compile_scene
    meshes, mats, cam, env = atrium.make(detail=ATRIUM_DETAIL)
    cam = cam.to(DEVICE)
    scenes = {}
    for k in (6, 3):
        t0 = time.perf_counter()
        scenes[k] = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                                  with_light_bvh=(k == 6), leaf_k=k,
                                  device=DEVICE)
        log(f"atrium detail {ATRIUM_DETAIL} K={k}: {scenes[k].n_tris()} triangles, "
            f"{scenes[k].cw_nodes.shape[0]} nodes, "
            f"{scenes[k].cw_leaf_rows.shape[0]} leaf rows, stack "
            f"{scenes[k].cw_stack}, built in "
            f"{time.perf_counter() - t0:.1f} s")
    phase_step_core(results, scenes[3], cam)
    phase_traversal(results, scenes, cam)
    del scenes[3]
    launches, renderer, state = phase_frame(results, scenes[6], cam)
    results["profile"] = phase_profile(renderer, state)
    del renderer, state
    phase_cornell()

    for k in (6, 3):
        log(f"traversal Mrays/s (bench mix, atrium K={k}): " + ", ".join(
            f"{results[f'traversal_k{k}_{n}']['mrays']:.2f} at {n} rays"
            for n in (BENCH_RAYS, FRAME["width"] * FRAME["height"])))
    log(f"frame 512x512x4 svgf: {results['frame']['ms']:.1f} ms "
        f"(median {results['frame']['median_ms']:.1f}); device busy "
        f"{results['profile']['busy_ms']:.1f} ms in "
        f"{results['profile']['kernels']} kernels")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(card, flush=True)
    rows = {name: dict(name=name, route="cuda", source=src, replaces=rep,
                       launches=launches[name],
                       max_abs_err=results[name]["max_abs_err"],
                       ms=results[name]["ms"],
                       plain_ms=results[name]["plain_ms"])
            for name, src, rep in KERNELS}
    # "kernels": the main path's kernels. step_core's code runs inside
    # the traversal kernel; its own launch is held against its plain
    # version above but is not on the main path ("off_path").
    print(json.dumps({"kernels": [rows[n] for n in PATH_KERNELS],
                      "off_path": [rows["step_core"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
