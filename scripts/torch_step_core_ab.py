#!/usr/bin/env python3
"""Time the port's step_core kernel against an earlier version of it on
one CUDA card, in turns, at several lane counts.

    python3 scripts/torch_step_core_ab.py --old DIR [--lanes 65536,262144,1048576]
                                          [--reps 50] [--json FILE]

DIR holds the earlier `step_core.cu` and the `cwbvh_core.cuh` it includes
(for example `git archive <commit> truetrace_tpu_torch/kernels/csrc`
unpacked into a git-ignored directory such as `_parent/`). Its C entry
point must take (rowt, ray9, st5, out, R, write_uv, stream), as every
version so far does. It is built with the port's flags for step_core.cu
(`--fmad=false`).

On chip_smoke.step_core_inputs' rows of the 293k-triangle atrium at
K = 3 (leaf lanes on the row of the triangle a traversal hit, node lanes
on random node rows) at each lane count:

1. both kernels bitwise against step_core_plain, with write_uv true and
   false;
2. device time per launch (chip_smoke.device_ms: no host launch gaps),
   in the order of ORDER, beside the bound (chip_smoke.step_core_bound).

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

ORDER = ("earlier", "current", "current", "earlier")


def build_old(src_dir: str):
    """The earlier step_core.cu, built with the port's flags for it."""
    from truetrace_tpu_torch.kernels import _cuda
    lib, log = _cuda.build_file(os.path.abspath(src_dir), "step_core.cu")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tt_step_core.argtypes = [P, P, P, P, I, I, P]
    lib.tt_step_core.restype = ctypes.c_int
    return lib, log


def old_step_core(lib, rowt, ray9, st5, write_uv: bool = True):
    import torch
    from truetrace_tpu_torch.kernels import _cuda
    R = rowt.shape[1]
    out = torch.empty((7, R), dtype=torch.int32, device=rowt.device)
    err = lib.tt_step_core(rowt.data_ptr(), ray9.data_ptr(), st5.data_ptr(),
                           out.data_ptr(), R, int(write_uv),
                           _cuda.stream_ptr(rowt))
    _cuda.check(err, "earlier tt_step_core")
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier step_core.cu")
    ap.add_argument("--lanes", default="65536,262144,1048576")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_core_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels.step_pallas import step_core
    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.mesh import compile_scene
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    _cuda.build_all()
    old_lib, old_log = build_old(args.old)
    for src, log in (("current step_core.cu",
                      _cuda.build_log["step_core.cu"]),
                     ("earlier step_core.cu", old_log)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log(f"  {src}: {line.strip()}")

    t0 = time.perf_counter()
    meshes, mats, cam, env = atrium.make(detail=cs.ATRIUM_DETAIL,
                                         device=cs.DEVICE)
    scene3 = compile_scene(meshes, mats, env=env, with_cwbvh=True,
                           leaf_k=3, device=cs.DEVICE)
    cs.log(f"atrium detail {cs.ATRIUM_DETAIL} K=3: {scene3.n_tris()} "
           f"triangles, built in {time.perf_counter() - t0:.1f} s")
    run = {"earlier": lambda *a: old_step_core(old_lib, *a),
           "current": step_core}
    res = dict(card=card, kind=torch.cuda.get_device_name(0), lanes={})
    for R in (int(x) for x in args.lanes.split(",")):
        rowt, ray9, st5 = cs.step_core_inputs(scene3, cam, R)
        for label, fn in run.items():
            cs.hold_step_core(fn, rowt, ray9, st5, f"{label} step_core")
        b = cs.step_core_bound(R)
        turns = [dict(kernel=label, ms=cs.device_ms(
            lambda: run[label](rowt, ray9, st5), args.reps))
            for label in ORDER]
        for t in turns:
            t["share_of_bound"] = b["bound_ms"] / t["ms"]
        res["lanes"][str(R)] = dict(turns=turns, **b)
        cs.log(f"R={R}: both bitwise equal to plain (write_uv both ways); "
               f"bound {b['bound_ms']:.5f} ms ({b['bound_by']}); " + ", ".join(
                   f"{t['kernel']} {t['ms']:.5f} ms ({t['share_of_bound']:.3f}"
                   f" of the bound)" for t in turns))
        del rowt, ray9, st5
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
