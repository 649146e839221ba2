#!/usr/bin/env python3
"""Time the port's two-level traversal kernel (csrc/traverse_tlas.cu)
against an earlier version of it on one CUDA card, in turns, on the
forest frame's and the tinted frame's own rays.

    python3 scripts/torch_tlas_ab.py --old DIR [--variant DIR ...]
                                     [--reps N] [--json FILE]

DIR holds the earlier `traverse_tlas.cu` and the headers it includes
(for example `git archive <commit> truetrace_tpu_torch/kernels/csrc`
unpacked into a git-ignored directory such as `_parent/`). Each
`--variant DIR` is one more build of the same source, timed in the same
turns. Every build's C entry points take the current argument lists.

1. The ray sets: one eager frame of chip_smoke.py's forest (`FOREST` at
   `FOREST_SIZE`, 262144 lanes), its rays grabbed: each bounce's
   closest-hit rays and NEE shadow rays; and one eager frame of the
   tinted scene (`tinted_tlas_scene` under the forest's sky), its shadow
   rays through the transmittance.
2. Every build against the current one, bit for bit, on every bounce's
   rays, and the current one against the plain version on bounce 0's,
   whose counted work sets the bound (`chip_smoke.tlas_work`).
3. Bounce 0's closest hit, any hit and transmittance timed
   (`chip_smoke.device_ms`, CUDA events) in turns: earlier, current,
   variants, then the same in reverse.
4. A counting build (`-DTT_TLAS_COUNT`) of every source that has the
   counting lines: per body (node, triangles, instance entry) the warp
   trips that ran it, the lanes that ran it per trip and the lanes busy
   in those trips, on bounce 0's rays.
5. Each build's ptxas report (registers, spills, stack frame) of
   `tlas_kernel<K,Q>` at the scenes' K, and the resident blocks per SM
   that its registers and the stack's shared memory allow.

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SRC = "traverse_tlas.cu"
QUERIES = ("closest", "any", "transmit")
BODIES = ("node", "triangles", "entry", "drain")
P = ctypes.c_void_p


def blocks_per_sm(regs: int, smem: int, threads: int = 128) -> int:
    """Resident blocks of `threads` threads on one H100 SM for `regs`
    registers a thread and `smem` bytes of shared memory a block:
    registers go to warps in units of 256 (65,536 an SM, 16,384 to each
    quarter), shared memory 233,472 bytes an SM with 1,024 reserved a
    block; at most 64 warps and 32 blocks."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 4 * (16384 // per_warp) // warps
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 64 // warps, 32)


def build(src_dir: str, count: bool):
    """One build of src_dir's traverse_tlas.cu with the port's flags
    (and -DTT_TLAS_COUNT): (library, nvcc output)."""
    from truetrace_tpu_torch.kernels import _cuda
    flags = _cuda.NVCC_FLAGS[SRC] + (["-DTT_TLAS_COUNT"] if count else [])
    lib, log = _cuda.build_file(os.path.abspath(src_dir), SRC, flags)
    for fn, argtypes in _cuda._SIGNATURES[SRC].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if count:
        lib.tt_tlas_counts.argtypes = [P]
        lib.tt_tlas_counts.restype = ctypes.c_int
    return lib, log


def counted(src_dir: str) -> bool:
    with open(os.path.join(src_dir, SRC)) as f:
        return "#ifdef TT_TLAS_COUNT\n" in f.read()


def read_counts(lib) -> dict:
    """The counting build's counts since the last read, per body."""
    import numpy as np
    import torch
    torch.cuda.synchronize()
    out = np.zeros(12, np.uint64)
    cs.check(lib.tt_tlas_counts(out.ctypes.data) == 0, "tt_tlas_counts")
    res = {}
    for b, (trips, lanes, busy) in zip(BODIES, out.reshape(4, 3).tolist()):
        res[b] = dict(trips=trips, lanes=lanes,
                      lanes_per_trip=lanes / max(trips, 1),
                      busy_per_trip=busy / max(trips, 1))
    return res


def run(lib, scene, rays, query: str, tint=None):
    """One launch of `lib` (a build of traverse_tlas.cu) on a ray set
    through the port's wrapper code: (Hit, inst) or the transmittance."""
    from truetrace_tpu_torch.kernels import cwbvh_tlas as K
    ro, rd, tm = rays
    q = dict(closest=K.CLOSEST, any=K.ANY, transmit=K.TRANSMIT)[query]
    return K._launch(scene.cw_table(), scene.cw_nodes.shape[0],
                     scene.cw_leaf_rows.shape[0], ro, rd, tm, q,
                     K.MAX_STACK, tint, lib=lib)


def same(a, b, query: str) -> bool:
    if query == "transmit":
        return cs.torch_equal_bits(a, b)
    (ha, ia), (hb, ib) = a, b
    return all(cs.torch_equal_bits(getattr(ha, f), getattr(hb, f))
               for f in ("t", "tri", "u", "v")) and bool((ia == ib).all())


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier traverse_tlas.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of one more build to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tlas_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.integrate.pathtrace import T_MAX
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import cwbvh_tlas as K
    from truetrace_tpu_torch.scene.atmosphere import bake_sky_env
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")

    dirs = {"earlier": args.old, "current": _cuda.CSRC}
    for d in args.variant:
        dirs[os.path.basename(os.path.normpath(d))] = d
    # the current build is the port's own (build_all); the others by
    # build_file, all at once
    jobs = {(label, c): (d, c) for label, d in dirs.items()
            for c in ((False, True) if counted(d) else (False,))
            if (label, c) != ("current", False)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        whole = pool.submit(_cuda.build_all)
        futs = {k: pool.submit(build, *v) for k, v in jobs.items()}
        whole.result()
        built = {k: f.result() for k, f in futs.items()}
    built["current", False] = (_cuda.lib(SRC), _cuda.build_log[SRC])
    cs.log(f"{len(built)} builds of {SRC} and the port's kernels in "
           f"{time.perf_counter() - t0:.1f} s")
    libs = {label: built[(label, False)][0] for label in dirs}
    count_libs = {label: built[(label, True)][0] for label in dirs
                  if (label, True) in built}

    forest, _, _, _, f_cam = cs.forest_scene(cs.DEVICE, **cs.FOREST_SIZE)
    r = cs.make_renderer(forest, f_cam, cs.FOREST)
    seen = cs.grab_rays(r, r.init_state())
    del r
    tinted, t_cam = cs.tinted_tlas_scene(cs.DEVICE, env=bake_sky_env(
        **cs.FOREST_SKY, device=cs.DEVICE))
    cfg = dict(cs.FRAME, traversal="tlas", light_sampling="cdf")
    r = cs.make_renderer(tinted, t_cam, cfg)
    shadow = cs.grab_rays(r, r.init_state(), names=("_transmission",))
    del r
    sets = {"closest": (forest, [(ro, rd, torch.where(alive, T_MAX, 0.0))
                                 for ro, rd, alive in seen["_trace"]], None),
            "any": (forest, seen["_occluded_mesh"], None),
            "transmit": (tinted, shadow["_transmission"], tinted.tri_shadow)}
    ks = {q: sc.cw_leaf_rows.shape[1] // 10 for q, (sc, _, _) in sets.items()}
    cs.log(f"forest: {forest.n_tris()} triangles, {forest.cw_nodes.shape[0]}"
           f" nodes, K = {ks['closest']}; tinted: K = {ks['transmit']}")

    res = dict(card=card, kind=torch.cuda.get_device_name(0),
               builds={}, sets={})
    smem = _cuda.lib(SRC).tt_tlas_smem(K.MAX_STACK)
    for label, d in dirs.items():
        rep = {}
        for q, qi in zip(QUERIES, range(3)):
            name = f"tlas_kernel<{ks[q]},{qi}>"
            info = cs.ptxas_of(SRC, name, built[(label, False)][1])[name]
            rep[name] = dict(info, blocks_per_sm=blocks_per_sm(
                info["registers"], smem + info["smem"]))
            cs.log(f"{label} {name}: {rep[name]}")
        res["builds"][label] = dict(dir=os.path.relpath(d, HERE), ptxas=rep)

    for q in QUERIES:
        sc, rays, tint = sets[q]
        for b, rs in enumerate(rays):
            want = run(libs["current"], sc, rs, q, tint)
            for label, lib in libs.items():
                cs.check(same(run(lib, sc, rs, q, tint), want, q),
                         f"{q} bounce {b}: {label} differs from current")
        cs.log(f"{q}: every build bit for bit the current one on "
               f"{len(rays)} bounces of {rays[0][0].shape[0]} lanes")
        rs = rays[0]
        counts = {}
        plain = dict(closest=K.closest_hit_tlas_plain,
                     any=K.any_hit_tlas_plain,
                     transmit=K.transmit_tlas_plain)[q]
        a = (sc.cw_table(), sc.cw_nodes.shape[0], sc.cw_leaf_rows.shape[0])
        a = a + ((tint,) if q == "transmit" else ())
        want, plain_ms = cs.timed_once(lambda: plain(*a, *rs, counts=counts))
        got = run(libs["current"], sc, rs, q, tint)
        ok = (cs.torch_equal_bits(got, want) if q == "transmit" else
              bool(torch.equal(got[0].tri >= 0, want)) if q == "any" else
              same(got, (want[0], want[1].to(torch.int32)), q))
        cs.check(ok, f"{q} bounce 0: current differs from plain")
        work = cs.tlas_work(counts, rs[0].shape[0], sc.cw_table().shape[1])
        order = list(libs) + list(libs)[::-1]
        turns = [dict(build=label, ms=cs.device_ms(
            lambda: run(libs[label], sc, rs, q, tint), args.reps))
            for label in order]
        ms = {label: sum(t["ms"] for t in turns if t["build"] == label) / 2
              for label in libs}
        cts = {}
        for label, lib in count_libs.items():
            read_counts(lib)
            run(lib, sc, rs, q, tint)
            cts[label] = read_counts(lib)
        res["sets"][q] = dict(
            rays=rs[0].shape[0], k=ks[q], plain_ms=plain_ms, work=work,
            bound_ms=work["bound_ms"], bound_by=work["bound_by"],
            turns=turns, ms=ms,
            share_of_bound={lb: work["bound_ms"] / m for lb, m in ms.items()},
            counts=cts)
        cs.log(f"{q} bounce 0 ({rs[0].shape[0]} lanes, bound "
               f"{work['bound_ms']:.5f} ms, {work['bound_by']}): " + ", ".join(
                   f"{t['build']} {t['ms']:.4f}" for t in turns))
        for label, c in cts.items():
            cs.log(f"  {label}: " + "; ".join(
                f"{b} {c[b]['trips']} trips, {c[b]['lanes_per_trip']:.2f} "
                f"lanes ({c[b]['busy_per_trip']:.2f} busy)" for b in BODIES))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
