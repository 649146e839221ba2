#!/usr/bin/env python3
"""Converged image means of the port's NEE + MIS and BSDF-only renders of
sponza_like on one CUDA card, over a ladder of bounce counts.

    python3 scripts/torch_nee_ladder.py [--detail 5] [--bounces 2 3 4 5 6]
        [--bsdf disney lambert] [--json FILE]

The scene is chip_smoke.py's: sponza_like exported into a temporary
directory, loaded and built at K = 6 with the light BVH, under the golden
ladder's soft wide sun (tests/test_golden.py). For each BSDF and bounce
count B it renders 40x30 at chip_smoke.NEE_SPP samples with NEE + MIS and
at chip_smoke.BSDF_SPP without NEE, and prints the three channel means of
each. The integrator does NEE at every vertex, the last included, while
the BSDF-only estimator with the same B never traces the segment that
follows the last vertex; so NEE(B) holds the light of paths up to B
segments plus the NEE-weighted share of B + 1, and lies between
BSDF-only(B) and BSDF-only(B + 1).

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--detail", type=float, default=cs.SPONZA_DETAIL)
    ap.add_argument("--bounces", type=int, nargs="+", default=[2, 3, 4, 5, 6])
    ap.add_argument("--bsdf", nargs="+", default=["disney", "lambert"])
    ap.add_argument("--json", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_nee_ladder: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.build.env_cdf import (
        build_env_cdf, procedural_sky)
    from truetrace_tpu_torch.scene import sponza_like
    from truetrace_tpu_torch.scene.mesh import compile_scene
    with tempfile.TemporaryDirectory(prefix="sponza_like_") as tmp:
        m, mats, atlas, rects, level_y, cam, _ = sponza_like.make(
            args.detail, assets_dir=tmp, device=cs.DEVICE)
    scene = compile_scene(m, mats, env=build_env_cdf(
        procedural_sky(**cs.GOLDEN_SKY), device=cs.DEVICE), atlas=atlas,
        atlas_rects=rects, atlas_level_y=level_y, with_cwbvh=True,
        with_light_bvh=True, device=cs.DEVICE)
    W, H = 40, 30
    rows = []
    for bsdf in args.bsdf:
        for b in args.bounces:
            kw = dict(bounces=b, bsdf=bsdf, traversal="wavefront",
                      light_sampling="tree")
            nee, _ = cs.render_mean(scene, cam, W, H, cs.NEE_SPP, **kw)
            pt, _ = cs.render_mean(scene, cam, W, H, cs.BSDF_SPP,
                                   use_nee=False, **kw)
            rows.append(dict(bsdf=bsdf, bounces=b, nee=nee.tolist(),
                             bsdf_only=pt.tolist()))
            cs.log(f"{bsdf} B={b}: NEE + MIS {nee.round(5)}, BSDF-only "
                   f"{pt.round(5)}, ratio {(nee / pt).round(4)}")
    out = dict(scene=f"sponza_like d{args.detail:g}", tris=scene.n_tris(),
               size=[W, H], nee_spp=cs.NEE_SPP, bsdf_spp=cs.BSDF_SPP,
               sky=cs.GOLDEN_SKY, rows=rows,
               device=torch.cuda.get_device_name(0))
    print(cs.card_line(), flush=True)
    line = json.dumps(out)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
