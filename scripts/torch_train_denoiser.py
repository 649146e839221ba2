"""Train and evaluate the port's learned denoiser (post/neural.py, the
OIDN slot) on pairs the port renders.

Port of scripts/train_denoiser.py. The same CLI defaults (400 steps,
96x96, 2 against 192 spp), the same numpy seed and scene mix (four
Cornell variants, three orbit frames of the atrium at detail 0.5, two
sphere still-lifes; the instanced boxes held out, last), the same flips
and gains, Adam at 1e-3 from `init_params` (flax's initialisation,
drawn from torch.Generator seed 0). One deliberate difference: the mix's
traversal="bvh2" becomes "wavefront" over compile_scene(with_cwbvh=True),
as it was written before the port's BVH2 traversal and its recorded runs
(PERF.md) were made so; as the JAX script says itself, the denoiser only
needs pixels. The held-out scene keeps "tlas".

Pairs come from the port's `render_sample_with_stats` on `--device`,
as many samples a pass as `render_sum` puts together.
The checkpoint is a flax msgpack (`write_msgpack`), which the JAX
package's `denoise` and the port's `load_denoiser` both read; it goes to
a git-ignored path, never over examples/denoiser.msgpack. The eval JSON
has PSNR and SSIM of the noisy input, SVGF (csrc/atrous.cu on the card)
and the network on the held-out pairs and two training pairs, as the JAX
script's examples/denoiser_eval.json. The last line printed is a JSON
summary: render and train seconds, steps/s, the loss at the first and
last steps, the eval.

Usage:
    python3 scripts/torch_train_denoiser.py [--steps 400] [--res 96]
        [--spp-noisy 2] [--spp-target 192] [--device cuda]
        [--out runs/torch_denoiser.msgpack]
        [--eval-out runs/torch_denoiser_eval.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, None) - np.clip(b, 0, None)) ** 2))
    return float(10.0 * np.log10(max(float(np.max(b)) ** 2, 1e-9)
                                 / max(mse, 1e-12)))


def ssim(a, b):
    """Global-statistics SSIM (one window: coarse but monotone)."""
    a = a.mean(-1)
    b = b.mean(-1)
    mu_a, mu_b = a.mean(), b.mean()
    va, vb = a.var(), b.var()
    cov = ((a - mu_a) * (b - mu_b)).mean()
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float(((2 * mu_a * mu_b + c1) * (2 * cov + c2))
                 / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def _boxes():
    """The held-out scene's parts: a box, a floor quad, a light quad."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float32) * 0.4
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return corners, faces


def _floor_and_light():
    floor = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5], [-5, 0, 5]],
                     np.float32)
    fi = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    lq = np.array([[-1, 4, -1], [1, 4, -1], [1, 4, 1], [-1, 4, 1]],
                  np.float32)
    li = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return floor, fi, lq, li


def build_scene_mix(rng, device="cuda", holdout_only=False,
                    atrium_detail=0.5, cornells=4, orbits=3, spheres=2):
    """[(name, scene, cam, cfg_kwargs)], the held-out entry last; the
    draws from `rng` are the JAX script's, in its order (the counts cut a
    smaller mix from the front of each group)."""
    from truetrace_tpu_torch.scene import atrium, cornell
    from truetrace_tpu_torch.scene.camera_rig import orbit_path
    from truetrace_tpu_torch.scene.instances import (
        compile_scene_instanced, make_transform)
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.mesh import (
        HostMaterial, HostMesh, compile_scene)
    from truetrace_tpu_torch.scene.primitives import transform, uv_sphere

    wave = dict(traversal="wavefront")
    out = []
    if not holdout_only:
        for si in range(4):
            meshes, mats, cam = cornell.make(
                light_radiance=float(rng.uniform(8, 25)), device=device)
            for m in mats:
                m.base_color = tuple(np.clip(
                    np.asarray(m.base_color) * rng.uniform(0.5, 1.4, 3),
                    0, 1))
                m.roughness = float(np.clip(
                    m.roughness * rng.uniform(0.5, 1.5), 0.03, 1))
            if si < cornells:
                out.append((f"cornell{si}", compile_scene(
                    meshes, mats, with_cwbvh=True, device=device), cam,
                    wave))
        if orbits:
            meshes, mats, _, env = atrium.make(detail=atrium_detail,
                                               device=device)
            sc = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                               device=device)
            cams = orbit_path((0, 3, 0), radius=9.0, height=4.0, n_frames=3,
                              device=device)
            for ci, cam in enumerate(cams[:orbits]):
                out.append((f"atrium{ci}", sc, cam, wave))
        # metal / rough primitive still-lifes under an area light: they
        # bridge the gap to the held-out instanced boxes
        for pi in range(2):
            sv, si_, _ = uv_sphere(16, 24, radius=0.5)
            floor, fi, lq, li = _floor_and_light()
            pmats = [HostMaterial(base_color=tuple(rng.uniform(0.3, 0.9, 3)),
                                  roughness=float(rng.uniform(0.1, 0.9)),
                                  metallic=float(rng.uniform(0, 1))),
                     HostMaterial(base_color=(0.7, 0.7, 0.72), roughness=0.9),
                     HostMaterial(emission=tuple(rng.uniform(10, 16, 3)))]
            pmeshes = [HostMesh(floor, fi, np.ones(2, np.int32)),
                       HostMesh(lq, li, np.full(2, 2, np.int32))]
            for _ in range(4):
                pmeshes.append(HostMesh(
                    transform(sv, translate=(
                        float(rng.uniform(-2, 2)), 0.5,
                        float(rng.uniform(-2, 2)))), si_,
                    np.zeros(len(si_), np.int32)))
            if pi < spheres:
                psc = compile_scene(pmeshes, pmats, with_cwbvh=True,
                                    device=device)
                pcam = Camera.look_at((4.0, 3.0, 4.0), (0, 0.5, 0),
                                      fov_y_deg=45, device=device)
                out.append((f"spheres{pi}", psc, pcam, wave))

    # held out: instanced boxes under an area light (never trained on)
    corners, faces = _boxes()
    floor, fi, lq, li = _floor_and_light()
    mats = [HostMaterial(base_color=(0.75, 0.5, 0.3), roughness=0.4,
                         metallic=0.6),
            HostMaterial(base_color=(0.7, 0.7, 0.72), roughness=0.9),
            HostMaterial(emission=(14.0, 13.0, 12.0))]
    sources = [HostMesh(corners, faces, np.zeros(12, np.int32)),
               HostMesh(floor, fi, np.ones(2, np.int32)),
               HostMesh(lq, li, np.full(2, 2, np.int32))]
    instances = [(1, make_transform((0, 0, 0))),
                 (2, make_transform((0, 0, 0)))]
    for _ in range(5):
        instances.append((0, make_transform(
            (float(rng.uniform(-2, 2)), 0.4, float(rng.uniform(-2, 2))),
            rot_y=float(rng.uniform(0, 3)))))
    sc_i, _ = compile_scene_instanced(sources, mats, instances,
                                      with_light_bvh=False, device=device)
    cam_i = Camera.look_at((4.5, 3.5, 4.5), (0, 0.5, 0), fov_y_deg=45,
                           device=device)
    out.append(("HELDOUT_instanced", sc_i, cam_i, dict(traversal="tlas")))
    return out


@torch.no_grad()
def render_pair(scene, cam, cfg_kwargs, res, spp_noisy, spp_target):
    """The noisy (samples 0..spp_noisy-1) and target (samples 1000..)
    averages of the port's render_sample_with_stats (through render_sum),
    3 bounces, Disney, with the last noisy sample's primary-hit albedo,
    normal and depth; numpy [H,W,*]."""
    from truetrace_tpu_torch.integrate.pathtrace import (
        RenderConfig, render_sum)
    H = W = res
    cfg = RenderConfig(width=W, height=H, bounces=3, bsdf="disney",
                       **cfg_kwargs)
    noisy, st = render_sum(scene, cam, cfg, spp_noisy, 0)
    target, _ = render_sum(scene, cam, cfg, spp_target, 1000)
    f = lambda t, *s: t.reshape(H, W, *s).cpu().numpy()
    return dict(noisy=f(noisy / spp_noisy, 3),
                target=f(target / spp_target, 3),
                albedo=f(st["albedo"], 3), normal=f(st["normal"], 3),
                depth=f(st["depth"]))


def augment(rng, pair):
    """A training batch [1,H,W,*] from a pair: random flips and an
    exposure gain on the radiance (the held-out category differs mostly
    in layout and brightness), the JAX script's draws."""
    b = {k: v for k, v in pair.items()
         if k in ("noisy", "target", "albedo", "normal")}
    fx, fy = rng.integers(2), rng.integers(2)
    gain = float(np.exp(rng.uniform(-0.7, 0.7)))
    for k in list(b):
        a = b[k]
        if fx:
            a = a[:, ::-1]
        if fy:
            a = a[::-1]
        if k in ("noisy", "target"):
            a = a * gain
        b[k] = np.ascontiguousarray(a)[None]
    return b


def evaluate(model, pairs, device):
    """{name: PSNR and SSIM of noisy, SVGF and neural} against each
    pair's target."""
    from truetrace_tpu_torch.post.neural import denoise
    from truetrace_tpu_torch.post.svgf import SVGFState, svgf_denoise
    report = {}
    with torch.no_grad():
        for p in pairs:
            t_ = {k: torch.from_numpy(np.ascontiguousarray(p[k])).to(device)
                  for k in ("noisy", "albedo", "normal", "depth")}
            H, W = p["depth"].shape
            d_neural = denoise(model, t_["noisy"], t_["albedo"],
                               t_["normal"]).cpu().numpy()
            d_svgf = svgf_denoise(t_["noisy"], t_["albedo"], t_["normal"],
                                  t_["depth"], SVGFState.create(
                                      H, W, device=device))[0].cpu().numpy()
            n, t = p["noisy"], p["target"]
            report[p["name"]] = {
                "psnr_noisy": round(psnr(n, t), 2),
                "psnr_svgf": round(psnr(d_svgf, t), 2),
                "psnr_neural": round(psnr(d_neural, t), 2),
                "ssim_noisy": round(ssim(n, t), 4),
                "ssim_svgf": round(ssim(d_svgf, t), 4),
                "ssim_neural": round(ssim(d_neural, t), 4)}
    return report


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--spp-noisy", type=int, default=2)
    ap.add_argument("--spp-target", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="runs/torch_denoiser.msgpack")
    ap.add_argument("--eval-out",
                    default="runs/torch_denoiser_eval.json")
    args = ap.parse_args()
    if os.path.abspath(args.out) == os.path.abspath(
            "examples/denoiser.msgpack"):
        raise SystemExit("refusing to overwrite examples/denoiser.msgpack")

    from truetrace_tpu_torch.post.neural import (
        init_params, make_train_step, params_to_numpy, write_msgpack)

    dev = args.device
    rng = np.random.default_rng(0)
    mix = build_scene_mix(rng, device=dev)
    print(f"rendering {len(mix)} scene pairs at {args.res}^2 "
          f"({args.spp_noisy} vs {args.spp_target} spp) on {dev}...",
          flush=True)
    pairs, holdout = [], []
    t_render = time.perf_counter()
    for name, scene, cam, kw in mix:
        t0 = time.perf_counter()
        p = render_pair(scene, cam, kw, args.res, args.spp_noisy,
                        args.spp_target)
        p["name"] = name
        (holdout if name.startswith("HELDOUT") else pairs).append(p)
        print(f"  {name}: target mean {float(p['target'].mean()):.4f} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    render_s = time.perf_counter() - t_render

    model = init_params(torch.Generator().manual_seed(0), device=dev)
    init, step = make_train_step(1e-3, device=dev)
    opt = init(model)
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for it in range(args.steps):
        k = rng.integers(len(pairs))
        b = {kk: torch.from_numpy(v).to(dev)
             for kk, v in augment(rng, pairs[k]).items()}
        loss = step(model, opt, b)
        if it % 50 == 0 or it == args.steps - 1:
            losses.append((it, float(loss)))
            print(f"step {it:5d} loss {losses[-1][1]:.5f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _sync(dev)
    train_s = time.perf_counter() - t0

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        f.write(write_msgpack(params_to_numpy(model.state_dict())))
    print(f"saved {args.out}", flush=True)

    report = evaluate(model, holdout + pairs[:2], dev)
    for k, v in report.items():
        print(k, v, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.eval_out)),
                exist_ok=True)
    with open(args.eval_out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"saved {args.eval_out}", flush=True)
    print(json.dumps({"render_s": render_s, "train_s": train_s,
                      "steps": args.steps,
                      "steps_per_s": args.steps / max(train_s, 1e-9),
                      "loss_first": losses[0][1], "loss_last": losses[-1][1],
                      "res": args.res, "spp_noisy": args.spp_noisy,
                      "spp_target": args.spp_target, "eval": report}))


if __name__ == "__main__":
    main()
