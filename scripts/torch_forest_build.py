#!/usr/bin/env python3
"""Host-side build times of the forest scene (chip_smoke.forest_scene)
with the torch port, on the CPU: compile_scene_instanced without and
with the light BVH over the lanterns' world light rows, and
update_instance_transforms for one lantern move, each way.

    python3 scripts/torch_forest_build.py [--n-hm 257] [--n-trees 2048]
                                          [--n-lanterns 64]

Prints one JSON line of seconds and sizes.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import chip_smoke as cs
    from truetrace_tpu_torch.scene import primitives, terrain
    from truetrace_tpu_torch.scene.instances import (
        compile_scene_instanced, update_instance_transforms)
    from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-hm", type=int, default=257)
    ap.add_argument("--n-trees", type=int, default=2048)
    ap.add_argument("--n-lanterns", type=int, default=64)
    a = ap.parse_args()
    sources, mats, inst, _, _ = cs.forest_host(
        HostMesh, HostMaterial, primitives, terrain, n_hm=a.n_hm,
        n_trees=a.n_trees, n_lanterns=a.n_lanterns)
    out = dict(instances=len(inst))
    for light_bvh in (False, True):
        key = "light_bvh" if light_bvh else "no_light_bvh"
        t0 = time.perf_counter()
        scene, isc = compile_scene_instanced(sources, mats, inst,
                                             with_light_bvh=light_bvh,
                                             device="cpu")
        out[f"compile_s_{key}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        update_instance_transforms(scene, isc, mats, cs.forest_bob(inst, 1))
        out[f"update_s_{key}"] = time.perf_counter() - t0
        out["light_rows"] = int(scene.light_tris.tri_index.shape[0])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
