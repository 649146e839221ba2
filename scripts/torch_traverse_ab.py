#!/usr/bin/env python3
"""Time the port's CWBVH traversal kernel against an earlier version of
it on one CUDA card, in turns, on bench.py's ray mix over the atrium.

    python3 scripts/torch_traverse_ab.py --old DIR [--json FILE]

DIR holds the earlier `traverse.cu` and the `cwbvh_core.cuh` it includes
(for example `git archive <commit> truetrace_tpu_torch/kernels/csrc`
unpacked into a git-ignored directory). Its C entry point must take the
current argument list: (table, W, C, L, S, ro, rd, t_max, R, any_hit,
next_ray, out_t, out_tri, out_u, out_v, stream).

On the 293k-triangle atrium (detail 1.5) at K = 6 and K = 3, with
chip_smoke.bench_rays' mix at 262144 rays per class:

1. the earlier kernel's t/tri/u/v and occlusion against the current one,
   bitwise;
2. kernel times and Mrays/s at 131072 and 262144 rays per class, in the
   order earlier, current, current, earlier (20 launches per class);
3. warm against cold L2 (K = 6, 262144 rays, both kernels): each launch
   timed alone between CUDA events, after a 64 MB write that evicts the
   50 MB L2 (cold) or not (warm), a device-side sleep letting the host
   queue the launch first in both.

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SIZES = (1 << 17, 1 << 18)


def build_old(src_dir: str):
    """The earlier traverse.cu, built as the port builds its own; returns
    the library and the compiler's output."""
    from truetrace_tpu_torch.kernels import _cuda
    lib, log = _cuda.build_file(os.path.abspath(src_dir), "traverse.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tt_traverse.argtypes = [P, I, I, I, I, P, P, P, I, I, P, P, P, P, P,
                                P]
    lib.tt_traverse.restype = ctypes.c_int
    return lib, log


def old_traverse(lib, table, C, ro, rd, t_max, S, any_hit):
    import torch
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels.traverse_ref import Hit
    R = ro.shape[0]
    N, W = table.shape
    dev = ro.device
    # as the port's wrapper makes it: a scalar t_max is a fill kernel, not
    # a host-to-device copy (which would stall the timed launches)
    if isinstance(t_max, torch.Tensor):
        tm = t_max.to(device=dev, dtype=torch.float32).expand(R).contiguous()
    else:
        tm = torch.full((R,), float(t_max), dtype=torch.float32, device=dev)
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    err = lib.tt_traverse(table.data_ptr(), W, C, N - C, S, ro.data_ptr(),
                          rd.data_ptr(), tm.data_ptr(), R, int(any_hit),
                          next_ray.data_ptr(), t.data_ptr(), tri.data_ptr(),
                          u.data_ptr(), v.data_ptr(), _cuda.stream_ptr(ro))
    _cuda.check(err, "earlier tt_traverse")
    hit = Hit(t=t, tri=tri, u=u, v=v)
    return hit.tri >= 0 if any_hit else hit


def per_launch_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of fn() timed alone between two events, after a
    write of `flush` (cold L2) and a ~0.2 ms device sleep that lets the
    host queue the launch before the device reaches it."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.add_(1.0)
        torch.cuda._sleep(400_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier traverse.cu")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_traverse_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import cwbvh_wavefront as wf
    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.mesh import compile_scene
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    t0 = time.perf_counter()
    _cuda.build_all()
    old_lib, old_log = build_old(args.old)
    cs.log(f"built both in {time.perf_counter() - t0:.1f} s")
    for src, log in (("current traverse.cu", _cuda.build_log.get(
            "traverse.cu", "")), ("earlier traverse.cu", old_log)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {src}: {line.strip()}")

    meshes, mats, cam, env = atrium.make(detail=cs.ATRIUM_DETAIL,
                                         device="cuda")
    res = dict(card=card, kind=torch.cuda.get_device_name(0), runs={})
    R = max(SIZES)
    for k in (6, 3):
        sc = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                           leaf_k=k, device="cuda")
        table, C, S = sc.cw_table(), sc.cw_nodes.shape[0], sc.cw_stack
        ro_p, rd_p, ro_b, rd_b, tm_b = cs.bench_rays(sc, cam, R)
        classes = (("primary", ro_p, rd_p, 1e30, False),
                   ("bounce", ro_b, rd_b, 1e30, False),
                   ("shadow", ro_b, rd_b, tm_b, True))
        new = lambda ro, rd, tm, a, n: (
            wf.any_hit_wavefront if a else wf.closest_hit_wavefront)(
                table, C, ro[:n], rd[:n], tm if isinstance(tm, float)
                else tm[:n], S)
        old = lambda ro, rd, tm, a, n: old_traverse(
            old_lib, table, C, ro[:n], rd[:n], tm if isinstance(tm, float)
            else tm[:n], S, a)
        for name, ro, rd, tm, a in classes:
            hn, ho = new(ro, rd, tm, a, R), old(ro, rd, tm, a, R)
            torch.cuda.synchronize()
            if a:
                same = bool(torch.equal(hn, ho))
            else:
                same = all(cs.torch_equal_bits(getattr(hn, f),
                                               getattr(ho, f))
                           for f in ("t", "tri", "u", "v"))
            cs.check(same, f"K={k} {name}: current and earlier differ")
        cs.log(f"K={k}: current and earlier kernels bitwise equal on the "
               f"mix at {R} rays per class")
        run = dict(stack=S)
        for n in SIZES:
            turns = []
            for label in ("earlier", "current", "current", "earlier"):
                fn = old if label == "earlier" else new
                ms = [cs.cuda_ms(lambda: fn(ro, rd, tm, a, n), args.reps)
                      for _, ro, rd, tm, a in classes]
                mrays = 3 * n / (sum(ms) * 1e-3) / 1e6
                turns.append(dict(kernel=label, primary_ms=ms[0],
                                  bounce_ms=ms[1], shadow_ms=ms[2],
                                  mrays=mrays))
                cs.log(f"K={k} n={n} {label}: primary {ms[0]:.4f} ms, "
                       f"bounce {ms[1]:.4f} ms, shadow {ms[2]:.4f} ms -> "
                       f"{mrays:.2f} Mrays/s")
            run[f"turns_{n}"] = turns
        if k == 6:
            flush = torch.zeros((16 << 20,), device="cuda")   # 64 MB
            l2 = {}
            for label, fn in (("current", new), ("earlier", old)):
                for mode, fl in (("warm", None), ("cold", flush)):
                    ms = [per_launch_ms(lambda: fn(ro, rd, tm, a, R),
                                        args.reps, fl)
                          for _, ro, rd, tm, a in classes]
                    l2[f"{label}_{mode}"] = dict(
                        primary_ms=ms[0], bounce_ms=ms[1], shadow_ms=ms[2],
                        mrays=3 * R / (sum(ms) * 1e-3) / 1e6)
                    cs.log(f"L2 {mode} {label}: primary {ms[0]:.4f} ms, "
                           f"bounce {ms[1]:.4f} ms, shadow {ms[2]:.4f} ms "
                           f"-> {l2[f'{label}_{mode}']['mrays']:.2f} "
                           f"Mrays/s")
            run["l2"] = l2
        res["runs"][f"k{k}"] = run
        del sc, table
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
