#!/usr/bin/env python3
"""Time the port's a-trous kernel against an earlier version of it on one
CUDA card, in turns, at every step of the SVGF frame's five passes.

    python3 scripts/torch_atrous_ab.py --old DIR [--size 512] [--json FILE]

DIR holds the earlier `atrous.cu` (for example `git archive <commit>
truetrace_tpu_torch/kernels/csrc` unpacked into a git-ignored directory).
Its C entry point must take the unpacked planes of that version:
(color, var, normal, depth, out_c, out_v, H, W, step, stream). It is
built as the port built it then, with `--fmad=false`.

On chip_smoke.atrous_inputs' random colour, variance, normals and depths
at size x size:

1. every kernel against the plain pass at steps 1, 2, 4, 8 and 16, to
   chip_smoke's rtol / atol: the earlier one, and the current one on each
   of its paths (staged in shared memory; direct, every tap through
   L1/L2, in 32x8 blocks; the same in 128x2 blocks, "wide");
2. device time per launch (chip_smoke.device_ms: no host launch gaps) at
   each step, in the order of ORDER.

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

ORDER = ("earlier", "staged", "direct", "wide", "wide", "direct", "staged",
         "earlier")


def build_old(src_dir: str):
    """The earlier atrous.cu, built with the flags it was built with."""
    from truetrace_tpu_torch.kernels import _cuda
    lib, log = _cuda.build_file(os.path.abspath(src_dir), "atrous.cu",
                                _cuda.BITWISE_FLAGS)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tt_atrous_pass.argtypes = [P, P, P, P, P, P, I, I, I, P]
    lib.tt_atrous_pass.restype = ctypes.c_int
    return lib, log


def old_pass(lib, color, var, normal, depth, step):
    import torch
    from truetrace_tpu_torch.kernels import _cuda
    H, W = depth.shape
    out_c, out_v = torch.empty_like(color), torch.empty_like(var)
    err = lib.tt_atrous_pass(color.data_ptr(), var.data_ptr(),
                             normal.data_ptr(), depth.data_ptr(),
                             out_c.data_ptr(), out_v.data_ptr(), H, W, step,
                             _cuda.stream_ptr(color))
    _cuda.check(err, "earlier tt_atrous_pass")
    return out_c, out_v


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier atrous.cu")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_atrous_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels.atrous_pallas import (
        DIRECT, DIRECT_WIDE, STAGED, _launch, atrous_pass_plain, pack,
        unpack)
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")
    _cuda.build_all()
    old_lib, old_log = build_old(args.old)
    for src, log in (("current atrous.cu", _cuda.build_log["atrous.cu"]),
                     ("earlier atrous.cu", old_log)):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                cs.log(f"  {src}: {line.strip()}")

    H = W = args.size
    color, var, normal, depth = cs.atrous_inputs(H, W)
    cv, nz = pack(color, var), pack(normal, depth)
    run = {
        "earlier": lambda s: old_pass(old_lib, color, var, normal, depth, s),
        "staged": lambda s: _launch(cv, nz, s, STAGED),
        "direct": lambda s: _launch(cv, nz, s, DIRECT),
        "wide": lambda s: _launch(cv, nz, s, DIRECT_WIDE),
    }
    res = dict(card=card, kind=torch.cuda.get_device_name(0), size=H,
               steps={})
    for step in cs.ATROUS_STEPS:
        pc, pv = atrous_pass_plain(color, var, normal, depth, step)
        for label, fn in run.items():
            out = fn(step)
            c, v = out if label == "earlier" else unpack(out)
            torch.cuda.synchronize()
            cs.atrous_close(c, pc, f"{label} step {step} colour")
            cs.atrous_close(v, pv, f"{label} step {step} variance")
        turns = [dict(kernel=label, ms=cs.device_ms(
            lambda: run[label](step), args.reps)) for label in ORDER]
        res["steps"][str(step)] = turns
        cs.log(f"step {step}: " + ", ".join(
            f"{t['kernel']} {t['ms']:.5f}" for t in turns) + " ms")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
