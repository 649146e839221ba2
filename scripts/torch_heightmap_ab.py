#!/usr/bin/env python3
"""Time the port's heightmap march kernel (csrc/heightmap.cu) against an
earlier version of it on one CUDA card, in turns, on the forest frame's
own rays.

    python3 scripts/torch_heightmap_ab.py --old DIR [--variant DIR ...]
                                          [--reps N] [--json FILE]
                                          [--sass DIR]

DIR holds the earlier `heightmap.cu` and the headers it includes (for
example `git archive <commit> truetrace_tpu_torch/kernels/csrc` unpacked
into a git-ignored directory such as `_parent/`). Each `--variant DIR`
is one more build, timed in the same turns (a copy of csrc/, for example
with a `#define` put at the top of `heightmap.cu`). A source whose
`tt_heightmap` takes no table (the first version, which skips no step)
is called with its own argument list.

1. The ray sets: one eager frame of chip_smoke.py's FOREST (the forest
   at FOREST_SIZE, 262144 lanes), its rays grabbed as
   `phase_forest_kernels` builds them: each bounce's closest-hit rays,
   with the two-level closest hit's t as t_max, and NEE shadow rays.
2. Every build against the earlier one, bit for bit (t, valid, normal,
   uv; valid), on every ray set, and every build against the plain
   version on bounce 0's; from the plain version the share of lanes
   whose clip is empty, whose clip has no length, and whose march runs
   all its steps. Bounce 0's bound (`chip_smoke.hm_work`) is that of the
   fewest samples any build takes (step 4), one bound for every build;
   the bound of the plain version's samples stands beside it.
3. Every set timed (`chip_smoke.device_ms`, CUDA events) in turns:
   earlier, current, variants, then the same in reverse.
4. A counting build (`-DTT_HM_COUNT`) of each source, on every set: warp
   trips (one pass of a loop that takes a sample, counted by
   `__activemask()`: the converged lanes), lanes busy a trip, samples
   taken, span tests and those passed, steps skipped. A source without
   the counting lines (the first version) is counted from a copy with
   them added at the top of its `sample` (`add_counting`): a trip is then
   one sample call of a converged group of lanes. SIMD efficiency is
   samples over 32 x trips.
5. Each build's ptxas report (registers, spills, stack frame) of both
   kernels, the resident blocks and warps an SM, the SM clock (cycles of
   a device sleep over its time) and the cycles one warp trip takes:
   kernel ms x clock x resident warps / (trips / SMs); beside it the
   cycles of one dependent load through L2 and through the L1 (the
   pointer chase of traverse_bvh2.cu's counting build). With `--sass
   DIR`, each build's SASS (the toolkit's cuobjdump) is written there
   and its instructions are counted per kernel.

Prints the card line and one JSON object as its last line (also written
to the file --json names, if given).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import torch_bvh2_ab  # noqa: E402
from torch_bvh2_ab import chase_cycles, sm_clock_hz, warp_longest  # noqa: E402
from torch_tlas_ab import blocks_per_sm  # noqa: E402

SRC = "heightmap.cu"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the first version's argument list: no table
OLD_ENTRY = 'extern "C" int tt_heightmap(const void* height, int Hm,'
OLD_ARGS = [P, I, I] + [F] * 10 + [P, P, P, I, I, I, I, P, P, P, P, P]
# the counting lines added to a copy of a source that lacks them: at the
# top of the first version's `sample`, one count a call of a converged
# group of lanes
COUNT_DECL = """
#ifdef TT_HM_COUNT
__device__ unsigned long long tt_hm_counts[6];
#endif
"""
COUNT_SAMPLE = """#ifdef TT_HM_COUNT
  {
    const unsigned m = __activemask();
    if ((threadIdx.x & 31) == __ffs(m) - 1) {
      atomicAdd(&tt_hm_counts[0], 1ull);
      atomicAdd(&tt_hm_counts[1], (unsigned long long)__popc(m));
      atomicAdd(&tt_hm_counts[2], (unsigned long long)__popc(m));
    }
  }
#endif
"""
COUNT_READ = """
#ifdef TT_HM_COUNT
extern "C" int tt_hm_counts_read(void* out) {
  unsigned long long zero[6] = {};
  cudaError_t e = cudaMemcpyFromSymbol(out, tt_hm_counts, sizeof zero);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tt_hm_counts, zero, sizeof zero);
  return (int)e;
}
#endif
"""
SAMPLE_HEAD = ("__device__ __forceinline__ float sample(const Grid& g, "
               "float x, float z,\n"
               "                                        bool last) {\n")
NAMESPACE = "namespace {\n"


def source(src_dir: str) -> str:
    with open(os.path.join(src_dir, SRC)) as f:
        return f.read()


def add_counting(src_dir: str, label: str) -> str:
    """A directory whose heightmap.cu counts (src_dir itself, or a copy of
    it, named `label`, under the port's git-ignored build directory with
    the counting lines added to the first version's `sample`)."""
    from truetrace_tpu_torch.kernels import _cuda
    text = source(src_dir)
    if "#ifdef TT_HM_COUNT\n" in text:
        return src_dir
    cs.check(text.count(SAMPLE_HEAD) == 1 and text.count(NAMESPACE) == 1,
             f"{src_dir}/{SRC}: no place for the counting lines")
    out = os.path.join(_cuda.BUILD_DIR, "hm_ab_count", label)
    shutil.copytree(src_dir, out, dirs_exist_ok=True)
    text = (text.replace(NAMESPACE, NAMESPACE + COUNT_DECL, 1)
            .replace(SAMPLE_HEAD, SAMPLE_HEAD + COUNT_SAMPLE) + COUNT_READ)
    with open(os.path.join(out, SRC), "w") as f:
        f.write(text)
    return out


def build(src_dir: str, count: bool):
    """One build of src_dir's heightmap.cu with the port's flags (and
    -DTT_HM_COUNT): (library, nvcc output, first version's arguments,
    library path)."""
    from truetrace_tpu_torch.kernels import _cuda
    old = OLD_ENTRY in source(src_dir)
    flags = _cuda.NVCC_FLAGS[SRC] + (["-DTT_HM_COUNT"] if count else [])
    lib, log = _cuda.build_file(os.path.abspath(src_dir), SRC, flags)
    lib.tt_heightmap.argtypes = (OLD_ARGS if old else
                                 _cuda._SIGNATURES[SRC]["tt_heightmap"])
    lib.tt_heightmap.restype = I
    if count:
        lib.tt_hm_counts_read.argtypes = [P]
        lib.tt_hm_counts_read.restype = I
    return lib, log, old, _cuda._so_path(SRC, os.path.abspath(src_dir),
                                          flags)


def run(b, ter, rays, closest: bool):
    """One launch of build b = (library, first version) on a ray set: the
    TerrainHit (closest) or valid (any)."""
    import torch
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import heightmap as K
    lib, old = b
    ro, rd, tm = rays
    bisect = K.BISECT_STEPS if closest else 0
    if not old:
        return K._launch(ter, ro, rd, tm, closest, K.MARCH_STEPS, bisect,
                         lib=lib)
    R, dev = ro.shape[0], ro.device
    (ox, oy, oz), (hx, hy, hz) = K._box(ter)
    _, _, _, sx, sz, _ = ter.consts
    valid = torch.empty((R,), dtype=torch.bool, device=dev)
    t, n, uv = ((torch.empty(s, device=dev) for s in ((R,), (R, 3), (R, 2)))
                if closest else (None, None, None))
    ptr = (lambda x: 0 if x is None else x.data_ptr())
    _cuda.check(lib.tt_heightmap(
        ter.height.data_ptr(), *ter.hm_shape, ox, oy, oz, hx, hy, hz, sx,
        sz, *K._spacing(ter), ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
        R, K.MARCH_STEPS, bisect, int(closest), valid.data_ptr(), ptr(t),
        ptr(n), ptr(uv), _cuda.stream_ptr(ro)), "tt_heightmap")
    return K.TerrainHit(t=t, valid=valid, normal=n, uv=uv) if closest \
        else valid


def same(a, b, closest: bool) -> bool:
    import torch
    if not closest:
        return bool(torch.equal(a, b))
    return bool(torch.equal(a.valid, b.valid)) and all(
        cs.torch_equal_bits(getattr(a, f), getattr(b, f))
        for f in ("t", "normal", "uv"))


def read_counts(lib) -> dict:
    c = cs.hm_read_counts(lib)
    trips = max(c["trips"], 1)
    return dict(c, busy_per_trip=c["busy"] / trips,
                samples_per_trip=c["samples"] / trips,
                simd_efficiency=c["samples"] / (32 * trips),
                pass_share=c["passed"] / max(c["tests"], 1))


def clip_shares(ter, rays, counts: dict, steps: int) -> dict:
    """From the plain version: the lanes whose clip is empty, whose clip
    has no length (dt = 0) and whose march runs all `steps` steps."""
    import torch
    from truetrace_tpu_torch.kernels import heightmap as K
    ro, rd, tm = rays
    tn, tf, inside = K._aabb_clip(ter, ro, rd, tm)
    R = ro.shape[0]
    share = (lambda m: float(m.sum()) / R)
    return dict(empty_clip=share(~inside),
                no_length=share(inside & (tf == tn)),
                full_march=share(counts["march_steps"] == steps),
                samples_max=int(counts["samples"].max()))


def sass(so: str, out_dir: str, label: str) -> dict | None:
    """The build's SASS written to out_dir/hm_sass_<label>.txt, and per
    kernel its instruction count and the counts of its commonest
    opcodes; None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300).stdout
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"hm_sass_{label}.txt"), "w") as f:
        f.write(text)
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if cur is not None and m:
            cur[m.group(2).split(".")[0]] += 1
    return {k: dict(instructions=sum(v.values()),
                    top=dict(v.most_common(12))) for k, v in out.items()
            if "heightmap_kernel" in k}


def ray_sets(scene, cam) -> dict:
    """chip_smoke's FOREST frame's rays, grabbed from one eager frame:
    {name: (closest, (ro, rd, t_max))}."""
    import torch
    from truetrace_tpu_torch.integrate.pathtrace import T_MAX
    from truetrace_tpu_torch.kernels.cwbvh_tlas import closest_hit_tlas
    r = cs.make_renderer(scene, cam, cs.FOREST)
    seen = cs.grab_rays(r, r.init_state())
    del r
    table, C, L = scene.cw_table(), scene.cw_nodes.shape[0], \
        scene.cw_leaf_rows.shape[0]
    sets = {}
    for b, (ro, rd, alive) in enumerate(seen["_trace"]):
        hit, _ = closest_hit_tlas(table, C, L, ro, rd,
                                  torch.where(alive, T_MAX, 0.0))
        sets[f"closest_b{b}"] = (True, (ro, rd, hit.t))
    for b, rays in enumerate(seen["_occluded_mesh"]):
        sets[f"any_b{b}"] = (False, rays)
    return sets


def main() -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="directory of the earlier heightmap.cu")
    ap.add_argument("--variant", action="append", default=[],
                    help="directory of one more build to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the result object here")
    ap.add_argument("--sass", help="write each build's SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_heightmap_ab: no CUDA device", file=sys.stderr)
        return 2
    from truetrace_tpu_torch.kernels import _cuda
    from truetrace_tpu_torch.kernels import heightmap as K
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
    with concurrent.futures.ThreadPoolExecutor(len(jobs) + 2) as pool:
        whole = pool.submit(_cuda.build_all)
        chase = pool.submit(torch_bvh2_ab.build, _cuda.CSRC, True)
        futs = {k: pool.submit(build, *v) for k, v in jobs.items()}
        whole.result()
        chase_lib = chase.result()[0]
        built = {k: f.result() for k, f in futs.items()}
    built["current", False] = (_cuda.lib(SRC), _cuda.build_log[SRC], False,
                               _cuda._so_path(SRC, _cuda.CSRC,
                                              _cuda.NVCC_FLAGS[SRC]))
    cs.log(f"{len(built)} builds of {SRC} and the port's kernels in "
           f"{time.perf_counter() - t0:.1f} s")
    builds = {lb: (built[lb, False][0], built[lb, False][2]) for lb in dirs}

    scene, _, _, _, cam = cs.forest_scene(cs.DEVICE, **cs.FOREST_SIZE)
    ter = scene.terrain
    sets = ray_sets(scene, cam)
    R = cs.FOREST["width"] * cs.FOREST["height"]
    cs.log(f"forest {cs.FOREST_SIZE}: terrain {ter.hm_shape}; "
           f"{len(sets)} ray sets of {R} lanes")

    res = dict(card=card, kind=torch.cuda.get_device_name(0),
               sms=torch.cuda.get_device_properties(0).multi_processor_count,
               rays=R, builds={}, sets={})
    sms = res["sms"]
    for label, d in dirs.items():
        rep = {}
        kernels = cs.ptxas_of(SRC, "heightmap_kernel", built[label, False][1])
        for q in (1, 0):
            info = kernels[f"heightmap_kernel<{q}>"]
            bps = blocks_per_sm(info["registers"], info["smem"])
            rep[q] = dict(info, blocks_per_sm=bps)
            cs.log(f"{label} heightmap_kernel<{q}>: {rep[q]}")
        res["builds"][label] = dict(
            dir=os.path.relpath(d, HERE), first_version=builds[label][1],
            ptxas=rep, sass=sass(built[label, False][3], args.sass, label)
            if args.sass else None)

    for name, (closest, rays) in sets.items():
        want = run(builds["earlier"], ter, rays, closest)
        for label, b in builds.items():
            cs.check(same(run(b, ter, rays, closest), want, closest),
                     f"{name}: {label} differs from earlier")
    cs.log(f"every build bit for bit the earlier one on {len(sets)} sets")

    plain_counts = {}
    for name, (closest, rays) in sets.items():
        entry = {}
        if name in ("closest_b0", "any_b0"):
            counts = {}
            plain = (K.heightmap_closest_plain if closest else
                     K.heightmap_any_plain)
            want, plain_ms = cs.timed_once(lambda: plain(
                ter, *rays, counts=counts))
            for label, b in builds.items():
                cs.check(same(run(b, ter, rays, closest), want, closest),
                         f"{name}: {label} differs from plain")
            work = cs.hm_work(counts, R, ter.hm_shape[0] * ter.hm_shape[1],
                              closest)
            plain_counts[name] = counts
            entry.update(plain_ms=plain_ms, work=work,
                         clip=clip_shares(ter, rays, counts, K.MARCH_STEPS),
                         one_thread_a_ray=warp_longest(counts["samples"]))
            cs.log(f"{name}: plain bit for bit; {work['samples_per_ray']:.2f}"
                   f" samples a ray; {entry['clip']}")
        order = list(builds) + list(builds)[::-1]
        turns = [dict(build=label, ms=cs.device_ms(
            lambda: run(builds[label], ter, rays, closest), args.reps))
            for label in order]
        entry.update(turns=turns, ms={lb: sum(
            t["ms"] for t in turns if t["build"] == lb) / 2
            for lb in builds})
        res["sets"][name] = entry
        cs.log(f"{name}: " + ", ".join(f"{t['build']} {t['ms']:.5f}"
                                       for t in turns))

    clock = sm_clock_hz()
    lat = dict(l2_cycles=chase_cycles(chase_lib, 8 << 20, False),
               l1_cycles=chase_cycles(chase_lib, 16 << 10, True))
    res.update(sm_clock_hz=clock, latency=lat)
    cs.log(f"SM clock {clock / 1e6:.0f} MHz; one dependent load: L2 "
           f"{lat['l2_cycles']:.0f} cycles, L1 {lat['l1_cycles']:.0f}")
    for name, (closest, rays) in sets.items():
        cts = {}
        for label in builds:
            lib = built[label, True][0]
            read_counts(lib)
            run((lib, built[label, True][2]), ter, rays, closest)
            c = read_counts(lib)
            bps = res["builds"][label]["ptxas"][int(closest)][
                "blocks_per_sm"]
            warps = min(4 * bps, 4 * -(-R // 128) / sms)
            ms = res["sets"][name]["ms"][label]
            c.update(resident_warps=warps, cycles_per_trip=(
                ms * 1e-3 * clock * warps / max(c["trips"] / sms, 1e-9)))
            cts[label] = c
            cs.log(f"  {name} {label}: {c['trips']} trips, "
                   f"{c['busy_per_trip']:.2f} busy, "
                   f"{c['samples_per_trip']:.2f} samples (SIMD "
                   f"{c['simd_efficiency']:.3f}), {c['samples'] / R:.2f} "
                   f"samples a ray, tests {c['tests'] / R:.2f} a ray "
                   f"({c['pass_share']:.2f} passed, {c['skipped'] / R:.1f} "
                   f"steps skipped); "
                   f"{warps:.1f} warps an SM, {c['cycles_per_trip']:.0f} "
                   f"cycles a trip")
        res["sets"][name]["counts"] = cts
        if name in plain_counts:
            # one bound for every build: the fewest samples any build
            # takes (the plain version's beside it, as plain_bound_ms)
            entry = res["sets"][name]
            work = cs.hm_work(plain_counts[name], R,
                              ter.hm_shape[0] * ter.hm_shape[1], closest,
                              min(c["samples"] for c in cts.values()))
            bnd, plain_bnd = work["bound_ms"], work["plain_bound_ms"]
            entry.update(work=work, bound_ms=bnd, bound_by=work["bound_by"],
                         share_of_bound={lb: bnd / m
                                         for lb, m in entry["ms"].items()},
                         share_of_plain_bound={
                             lb: plain_bnd / m
                             for lb, m in entry["ms"].items()})
            cs.log(f"{name}: bound {bnd:.5f} ms ({work['bound_by']}, "
                   f"{work['kernel_samples_per_ray']:.2f} samples a ray); "
                   f"the plain samples' {plain_bnd:.5f} ms "
                   f"({work['plain_bound_by']})")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(card, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
