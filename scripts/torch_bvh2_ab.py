#!/usr/bin/env python3
"""Time the port's BVH2 traversal kernel (csrc/traverse_bvh2.cu) against
an earlier version of it on one CUDA card, in turns, on the default-build
frame's own rays and on bench.py's mix.

    python3 scripts/torch_bvh2_ab.py --old DIR [--variant DIR ...]
                                     [--reps N] [--json FILE]

DIR holds the earlier `traverse_bvh2.cu` and the headers it includes
(for example `git archive <commit> truetrace_tpu_torch/kernels/csrc`
unpacked into a git-ignored directory such as `_parent/`). Each
`--variant DIR` is one more build, timed in the same turns. A source
whose `tt_bvh2` takes the raw tables (box, left, count, p0, e1, e2: the
first version) is called with them; the others with the packed table of
`pack_bvh2_table`, the scene's cached one.

1. The ray sets: one eager frame of chip_smoke.py's BVH2_FRAME (the
   atrium at ATRIUM_DETAIL built by compile_scene's defaults, 262144
   lanes), its rays grabbed: each bounce's closest-hit rays (t_max 0 on
   the dead lanes) and NEE shadow rays; and bench.py's mix at the same
   count (`chip_smoke.bench_rays`: primary, cosine bounce, shadow).
2. Every build against the earlier one, bit for bit (t, tri, u, v;
   occlusion), on every ray set, and every build against the plain
   version on bounce 0's, whose counted work sets the bound
   (`chip_smoke.bvh2_work`).
3. Every set timed (`chip_smoke.device_ms`, CUDA events) in turns:
   earlier, current, variants, then the same in reverse.
4. A counting build (`-DTT_BVH2_COUNT`) of each source, on bounce 0's
   closest-hit and NEE rays: warp trips, lanes busy a trip, lanes that
   ran the trip's body (pops), trips that ran both bodies, trips after
   the ray pool ran dry. A source without the counting lines (the first
   version) is counted from a copy with them added at the top of its
   loop (`add_counting`), by `__activemask()`. SIMD efficiency is pops
   over 32 x trips; for one thread a ray, also the plain version's pops
   over 32 x the sum of each warp's longest ray.
5. Each build's ptxas report (registers, spills, stack frame) of the
   closest and any hit's `bvh2_kernel` at the path's leaf width, the
   resident blocks and warps an SM, the SM clock (cycles of a device
   sleep over its time) and the cycles one warp trip
   takes: kernel ms x clock x resident warps / (trips / SMs); beside it
   the cycles of one dependent load through L2 and through the L1 (a
   pointer chase of the current counting build).

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from torch_tlas_ab import blocks_per_sm  # noqa: E402

SRC = "traverse_bvh2.cu"
P, I = ctypes.c_void_p, ctypes.c_int
# the first version's argument list: the raw tables
RAW_ENTRY = 'extern "C" int tt_bvh2(const void* box,'
RAW_ARGS = [P, P, P, I, P, P, P, I, P, P, P, I, I, I, I, P, P, P, P, P]
COUNT_KEYS = ("trips", "busy", "ran", "both", "dry_trips", "dry_busy")
# the counting lines added to a copy of a source that lacks them: after
# the first version's pop, one warp-wide count a trip of its loop
COUNT_DECL = """
#ifdef TT_BVH2_COUNT
__device__ unsigned long long tt_bvh2_counts[6];
#endif
"""
COUNT_TRIP = """#ifdef TT_BVH2_COUNT
    {
      const unsigned m = __activemask();
      const unsigned lf = __ballot_sync(m, ncount > 0);
      if ((threadIdx.x & 31) == __ffs(m) - 1) {
        atomicAdd(&tt_bvh2_counts[0], 1ull);
        atomicAdd(&tt_bvh2_counts[1], (unsigned long long)__popc(m));
        atomicAdd(&tt_bvh2_counts[2], (unsigned long long)__popc(m));
        atomicAdd(&tt_bvh2_counts[3], (unsigned long long)(lf != 0u &&
                                                           lf != m));
      }
    }
#endif
"""
COUNT_READ = """
#ifdef TT_BVH2_COUNT
extern "C" int tt_bvh2_counts_read(void* out) {
  unsigned long long zero[6] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tt_bvh2_counts, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tt_bvh2_counts, zero, sizeof zero);
  return (int)e;
}
#endif
"""
POP_LINE = "    const int ncount = (int)__ldg(b.count + node);\n"
NAMESPACE = "namespace {\n"


def source(src_dir: str) -> str:
    with open(os.path.join(src_dir, SRC)) as f:
        return f.read()


def add_counting(src_dir: str, label: str) -> str:
    """A directory whose traverse_bvh2.cu counts (src_dir itself, or a
    copy of it, named `label`, under the port's git-ignored build
    directory with the counting lines added to the first version's
    loop)."""
    from truetrace_tpu_torch.kernels import _cuda
    text = source(src_dir)
    if "#ifdef TT_BVH2_COUNT\n" in text:
        return src_dir
    cs.check(text.count(POP_LINE) == 1 and text.count(NAMESPACE) == 1,
             f"{src_dir}/{SRC}: no place for the counting lines")
    out = os.path.join(_cuda.BUILD_DIR, "bvh2_ab_count", label)
    shutil.copytree(src_dir, out, dirs_exist_ok=True)
    text = (text.replace(NAMESPACE, NAMESPACE + COUNT_DECL)
            .replace(POP_LINE, POP_LINE + COUNT_TRIP) + COUNT_READ)
    with open(os.path.join(out, SRC), "w") as f:
        f.write(text)
    return out


def build(src_dir: str, count: bool):
    """One build of src_dir's traverse_bvh2.cu with the port's flags (and
    -DTT_BVH2_COUNT): (library, nvcc output, raw argument list)."""
    from truetrace_tpu_torch.kernels import _cuda
    raw = RAW_ENTRY in source(src_dir)
    flags = _cuda.NVCC_FLAGS[SRC] + (["-DTT_BVH2_COUNT"] if count else [])
    lib, log = _cuda.build_file(os.path.abspath(src_dir), SRC, flags)
    lib.tt_bvh2.argtypes = RAW_ARGS if raw else _cuda._SIGNATURES[SRC][
        "tt_bvh2"]
    lib.tt_bvh2.restype = I
    if count:
        lib.tt_bvh2_counts_read.argtypes = [P]
        lib.tt_bvh2_counts_read.restype = I
        if hasattr(lib, "tt_bvh2_chase"):
            lib.tt_bvh2_chase.argtypes = [P, I, I, P, P]
            lib.tt_bvh2_chase.restype = I
    return lib, log, raw


def run(b, scene, rays, closest: bool, max_leaf: int):
    """One launch of build b = (library, raw) on a ray set: the Hit
    (t, u, v None for the any hit)."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import _bvh2
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import traverse_ref as K
    lib, raw = b
    ro, rd, tm = rays
    if not raw:
        return K._launch(*_bvh2(scene), ro, rd, tm, not closest, max_leaf,
                         K.MAX_STACK, table=scene.bvh2_table(), lib=lib)
    box, left, count, p0, e1, e2 = _bvh2(scene)
    R, dev = ro.shape[0], ro.device
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    t, u, v = ((torch.empty((R,), device=dev) for _ in range(3))
               if closest else (None, None, None))
    ptr = (lambda x: 0 if x is None else x.data_ptr())
    _cuda.check(lib.tt_bvh2(
        box.data_ptr(), left.data_ptr(), count.data_ptr(), box.shape[0],
        p0.data_ptr(), e1.data_ptr(), e2.data_ptr(), p0.shape[0],
        ro.data_ptr(), rd.data_ptr(), tm.data_ptr(), R, max_leaf,
        K.MAX_STACK, int(not closest), ptr(t), tri.data_ptr(), ptr(u),
        ptr(v), _cuda.stream_ptr(ro)), "tt_bvh2")
    return K.Hit(t=t, tri=tri, u=u, v=v)


def same(a, b, closest: bool) -> bool:
    if not closest:
        return bool(((a.tri >= 0) == (b.tri >= 0)).all())
    return all(cs.torch_equal_bits(getattr(a, f), getattr(b, f).to(
        getattr(a, f).dtype)) for f in ("t", "tri", "u", "v"))


def read_counts(lib) -> dict:
    import numpy as np
    import torch
    torch.cuda.synchronize()
    out = np.zeros(6, np.uint64)
    cs.check(lib.tt_bvh2_counts_read(out.ctypes.data) == 0,
             "tt_bvh2_counts_read")
    c = dict(zip(COUNT_KEYS, (int(x) for x in out)))
    trips = max(c["trips"], 1)
    return dict(c, busy_per_trip=c["busy"] / trips,
                ran_per_trip=c["ran"] / trips,
                simd_efficiency=c["ran"] / (32 * trips),
                both_share=c["both"] / trips)


def warp_longest(pops) -> dict:
    """One thread a ray: the plain version's pops over 32 x the sum of
    each warp's longest ray (lanes in order, 32 a warp)."""
    import torch
    R = pops.shape[0]
    p = torch.nn.functional.pad(pops, (0, -R % 32)).view(-1, 32)
    longest = int(p.max(1).values.sum())
    return dict(warp_trips=longest,
                simd_efficiency=float(pops.sum()) / (32 * max(longest, 1)),
                max_pops=int(pops.max()),
                p99_pops=float(pops.double().quantile(0.99)))


def sm_clock_hz() -> float:
    """The SM clock under load: the cycles of a device sleep over its
    time by CUDA events."""
    import torch
    cycles = 1 << 26
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    torch.cuda._sleep(cycles)
    ev[1].record()
    torch.cuda.synchronize()
    return cycles / (ev[0].elapsed_time(ev[1]) * 1e-3)


def chase_cycles(lib, nbytes: int, l1: bool, steps: int = 1 << 14) -> float:
    """Cycles of one dependent load over a random cycle of 128-byte lines
    spanning `nbytes` (warm: the chain is walked once before)."""
    import numpy as np
    import torch
    from truetrace_tpu_torch.kernels import _cuda
    n = nbytes // 128
    order = np.random.default_rng(0).permutation(n) * 32
    nxt = np.zeros(n * 32, np.int32)
    nxt[order] = np.roll(order, -1)
    dev_next = torch.from_numpy(nxt).to(cs.DEVICE)
    out = torch.zeros(2, dtype=torch.int64, device=cs.DEVICE)
    for _ in range(2):
        _cuda.check(lib.tt_bvh2_chase(dev_next.data_ptr(), steps, int(l1),
                                      out.data_ptr(),
                                      _cuda.stream_ptr(dev_next)),
                    "tt_bvh2_chase")
    return float(out[0]) / steps


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier traverse_bvh2.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of one more build to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the result object here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bvh2_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.integrate.pathtrace import (
        T_MAX, RenderConfig, _bvh2, _scene_max_leaf)
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import traverse_ref as K
    from truetrace_tpu_torch.scene import atrium
    from truetrace_tpu_torch.scene.mesh import compile_scene
    card = cs.card_line()
    cs.log(f"card: {card}; torch {torch.__version__}, CUDA "
           f"{torch.version.cuda}")

    dirs = {"earlier": args.old, "current": _cuda.CSRC}
    for d in args.variant:
        dirs[os.path.basename(os.path.normpath(d))] = d
    jobs = {(label, c): (add_counting(d, label) if c else d, c)
            for label, d in dirs.items() for c in (False, True)
            if (label, c) != ("current", False)}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 1) as pool:
        whole = pool.submit(_cuda.build_all)
        futs = {k: pool.submit(build, *v) for k, v in jobs.items()}
        whole.result()
        built = {k: f.result() for k, f in futs.items()}
    cur = _cuda.lib(SRC)
    built["current", False] = (cur, _cuda.build_log[SRC], False)
    cs.log(f"{len(built)} builds of {SRC} and the port's kernels in "
           f"{time.perf_counter() - t0:.1f} s")
    builds = {lb: (built[lb, False][0], built[lb, False][2]) for lb in dirs}

    meshes, mats, cam, env = atrium.make(detail=cs.ATRIUM_DETAIL,
                                         device=cs.DEVICE)
    scene = compile_scene(meshes, mats, env=env, device=cs.DEVICE)
    ml = _scene_max_leaf(scene, RenderConfig())
    r = cs.make_renderer(scene, cam, cs.BVH2_FRAME)
    seen = cs.grab_rays(r, r.init_state())
    del r
    R = cs.FRAME["width"] * cs.FRAME["height"]
    a = _bvh2(scene)
    ro_p, rd_p, ro_b, rd_b, tm_b = cs.bench_rays(
        scene, cam, R, closest=lambda ro, rd: K.closest_hit_bvh2(
            *a, ro, rd, 1e30, max_leaf=ml, table=scene.bvh2_table()))
    sets = {}
    for b, (ro, rd, alive) in enumerate(seen["_trace"]):
        sets[f"closest_b{b}"] = (True, (ro, rd, torch.where(alive, T_MAX,
                                                             0.0)))
    for b, rays in enumerate(seen["_occluded_mesh"]):
        sets[f"any_b{b}"] = (False, rays)
    far = torch.full((R,), 1e30, device=cs.DEVICE)
    sets.update(mix_primary=(True, (ro_p, rd_p, far)),
                mix_bounce=(True, (ro_b, rd_b, far)),
                mix_shadow=(False, (ro_b, rd_b, tm_b)))
    cs.log(f"atrium detail {cs.ATRIUM_DETAIL}, default build: "
           f"{scene.n_tris()} triangles, {scene.bvh2_box.shape[0]} nodes, "
           f"max_leaf {ml}; {len(sets)} ray sets of {R} lanes")

    res = dict(card=card, kind=torch.cuda.get_device_name(0),
               sms=torch.cuda.get_device_properties(0).multi_processor_count,
               rays=R, builds={}, sets={})
    sms = res["sms"]
    for label, d in dirs.items():
        rep = {}
        kernels = cs.ptxas_of(SRC, "bvh2_kernel", built[label, False][1])
        for q in (0, 1):
            # the instantiation the path's max_leaf runs
            name = next(n for n in (f"bvh2_kernel<{q},{ml}>",
                                    f"bvh2_kernel<{q},0>",
                                    f"bvh2_kernel<{q}>") if n in kernels)
            info = kernels[name]
            bps = blocks_per_sm(info["registers"], info["smem"])
            rep[q] = dict(info, kernel=name, blocks_per_sm=bps)
            cs.log(f"{label} {name}: {rep[q]}")
        res["builds"][label] = dict(dir=os.path.relpath(d, HERE),
                                    raw_tables=builds[label][1], ptxas=rep)

    for name, (closest, rays) in sets.items():
        want = run(builds["earlier"], scene, rays, closest, ml)
        for label, b in builds.items():
            cs.check(same(run(b, scene, rays, closest, ml), want, closest),
                     f"{name}: {label} differs from earlier")
    cs.log(f"every build bit for bit the earlier one on {len(sets)} sets")

    for name, (closest, rays) in sets.items():
        entry = {}
        if name in ("closest_b0", "any_b0"):
            counts = {}
            plain = (K.closest_hit_bvh2_plain if closest else
                     K.any_hit_bvh2_plain)
            want, plain_ms = cs.timed_once(lambda: plain(
                *a, *rays, max_leaf=ml, counts=counts))
            if not closest:
                want = K.Hit(t=None, tri=torch.where(want, 0, -1), u=None,
                             v=None)
            for label, b in builds.items():
                cs.check(same(run(b, scene, rays, closest, ml), want,
                              closest), f"{name}: {label} differs from plain")
            work = cs.bvh2_work(counts, R, closest)
            entry.update(plain_ms=plain_ms, work=work,
                         one_thread_a_ray=warp_longest(counts["pops"]))
        order = list(builds) + list(builds)[::-1]
        turns = [dict(build=label, ms=cs.device_ms(
            lambda: run(builds[label], scene, rays, closest, ml),
            args.reps)) for label in order]
        entry.update(turns=turns, ms={lb: sum(
            t["ms"] for t in turns if t["build"] == lb) / 2
            for lb in builds})
        if "work" in entry:
            bnd = entry["work"]["bound_ms"]
            entry.update(bound_ms=bnd, bound_by=entry["work"]["bound_by"],
                         share_of_bound={lb: bnd / m
                                         for lb, m in entry["ms"].items()})
        res["sets"][name] = entry
        cs.log(f"{name}: " + ", ".join(f"{t['build']} {t['ms']:.4f}"
                                       for t in turns)
               + (f"; bound {entry['bound_ms']:.5f} ms ({entry['bound_by']})"
                  if "bound_ms" in entry else ""))

    clock = sm_clock_hz()
    count_lib = built["current", True][0]
    lat = dict(l2_cycles=chase_cycles(count_lib, 8 << 20, False),
               l1_cycles=chase_cycles(count_lib, 16 << 10, True))
    res.update(sm_clock_hz=clock, latency=lat)
    cs.log(f"SM clock {clock / 1e6:.0f} MHz; one dependent load: L2 "
           f"{lat['l2_cycles']:.0f} cycles, L1 {lat['l1_cycles']:.0f}")
    for name in ("closest_b0", "any_b0"):
        closest, rays = sets[name]
        cts = {}
        for label in builds:
            lib = built[label, True][0]
            read_counts(lib)
            run((lib, built[label, True][2]), scene, rays, closest, ml)
            c = read_counts(lib)
            bps = res["builds"][label]["ptxas"][0 if closest else 1][
                "blocks_per_sm"]
            warps = min(4 * bps, 4 * -(-R // 128) / sms)
            ms = res["sets"][name]["ms"][label]
            c.update(resident_warps=warps, cycles_per_trip=(
                ms * 1e-3 * clock * warps / max(c["trips"] / sms, 1e-9)))
            cts[label] = c
            cs.log(f"  {name} {label}: {c['trips']} trips, "
                   f"{c['busy_per_trip']:.2f} busy, {c['ran_per_trip']:.2f} "
                   f"ran (SIMD {c['simd_efficiency']:.3f}), both bodies "
                   f"{c['both_share']:.3f}, dry {c['dry_trips']}; "
                   f"{warps:.1f} warps an SM, {c['cycles_per_trip']:.0f} "
                   f"cycles a trip")
        res["sets"][name]["counts"] = cts
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
