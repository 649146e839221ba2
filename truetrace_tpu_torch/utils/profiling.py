"""Profiling + render metrics (SURVEY.md sections 5.1 / 5.5).

The reference times every pass with CommandBuffer samples
(RayTracingMaster.cs:914-1182) and logs build stats via Debug.Log; the
equivalents here are `torch.profiler.record_function` annotations (named
ranges in a torch.profiler trace), a wall-clock pass timer that respects
asynchronous CUDA launches (`torch.cuda.synchronize` fences), and a
structured metrics record (Mrays/s, rays-alive per bounce, cache hit
rate, reservoir M stats) emitted as JSON lines.

Port of `truetrace_tpu/utils/profiling.py`, with the same rounds, slopes
and statistics.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    """Named region for torch.profiler traces (shows as a track slice)."""
    with torch.profiler.record_function(name):
        yield


@dataclass
class PassTimer:
    """Wall-clock pass timing with device fencing.

    with timer.time("trace"): h = traverse(...); timer.fence(h)
    """
    times: Dict[str, List[float]] = field(default_factory=dict)
    _t0: float = 0.0
    _name: str = ""

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.times.setdefault(name, []).append(dt)

    def fence(self, x: Any) -> Any:
        _hard_sync(x)
        return x

    def summary(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self.times.items() if v}


@dataclass
class RenderMetrics:
    """Structured per-frame metrics, dumped as JSON lines."""
    frames: List[Dict[str, Any]] = field(default_factory=list)

    def record(self, frame: int, wall_s: float,
               n_trace: float = 0.0, n_shadow: float = 0.0,
               cache_hits: Optional[float] = None,
               reservoir_m_mean: Optional[float] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        total = n_trace + n_shadow
        rec = {
            "frame": frame,
            "wall_s": round(wall_s, 5),
            "rays_traced": float(total),
            "mrays_per_s": round(total / wall_s / 1e6, 4) if wall_s > 0
            else 0.0,
            "n_closest": float(n_trace),
            "n_shadow": float(n_shadow),
        }
        if cache_hits is not None:
            rec["cache_hit_rate"] = float(cache_hits)
        if reservoir_m_mean is not None:
            rec["reservoir_m_mean"] = float(reservoir_m_mean)
        if extra:
            rec.update(extra)
        self.frames.append(rec)
        return rec

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for rec in self.frames:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        if not self.frames:
            return {}
        ms = [r["mrays_per_s"] for r in self.frames]
        return {"frames": len(self.frames),
                "mrays_per_s_mean": sum(ms) / len(ms),
                "mrays_per_s_max": max(ms)}


# ---------------------------------------------------------------------------
# Same-session interleaved A/B (round-5 perf-harness tightening)
# ---------------------------------------------------------------------------
#
# Session-to-session timings drift, and even same-session sequential
# blocks drift by several percent — enough to swamp the sub-10% frame
# effects a build option decides on. The cure is PAIRED measurement: warm
# every variant up front, then alternate variants within one process in
# round-robin ROUNDS, take a marginal slope per (variant, round), and do
# statistics on the per-round paired differences. Drift that is slow
# relative to a round cancels in the pairing; the paired CI tells us when
# a difference is real.

def _first_tensor(r: Any):
    if isinstance(r, torch.Tensor):
        return r
    if isinstance(r, dict):
        r = list(r.values())
    elif dataclasses.is_dataclass(r) and not isinstance(r, type):
        r = [getattr(r, f.name) for f in dataclasses.fields(r)]
    if isinstance(r, (list, tuple)):
        for x in r:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _hard_sync(r: Any) -> None:
    """Wait for the device work behind `r`: torch.cuda.synchronize on the
    device of its first tensor when that is a CUDA device (a CPU
    tensor's work has finished when the call returns)."""
    t = _first_tensor(r)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def marginal_slope(fn, *args, n1: int = 3, n2: int = 9) -> float:
    """Seconds/iteration as the slope between an n1- and an n2-iteration
    block with hard host syncs; cancels per-call dispatch overhead."""
    import time as _time
    r = fn(*args)
    _hard_sync(r)
    t0 = _time.perf_counter()
    for _ in range(n1):
        r = fn(*args)
    _hard_sync(r)
    t1 = _time.perf_counter()
    for _ in range(n2):
        r = fn(*args)
    _hard_sync(r)
    t2 = _time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (n2 - n1)


# two-sided 97.5% t quantiles for df = 1..30 (paired-CI without scipy)
_T975 = [12.706, 4.303, 3.182, 2.776, 2.571, 2.447, 2.365, 2.306, 2.262,
         2.228, 2.201, 2.179, 2.160, 2.145, 2.131, 2.120, 2.110, 2.101,
         2.093, 2.086, 2.080, 2.074, 2.069, 2.064, 2.060, 2.056, 2.052,
         2.048, 2.045, 2.042]


def interleaved_ab(variants, rounds: int = 4, n1: int = 3, n2: int = 9,
                   verbose: bool = True) -> Dict[str, Any]:
    """Paired same-session A/B over variants.

    variants: list of (name, fn, args_tuple). Every fn is warmed first
    (its kernels built, its caches filled); then `rounds` round-robin passes each take one marginal slope
    per variant (n1/n2 blocks => n1+n2+1 calls per variant per round, so
    each variant sees >= rounds*(n1+n2) timed iterations — the >=24-
    iteration bar of VERDICT r4 item 8 at the defaults). The start order
    rotates per round so slow drift is not aliased onto one variant.

    Returns {name: {"median_s", "mean_s", "slopes"}} plus, for every pair,
    paired-difference stats {"mean_s", "ci95_s", "significant"} under key
    ("pair", a, b) — difference = a - b, CI from the t distribution over
    per-round paired differences.
    """
    import numpy as np
    names = [v[0] for v in variants]
    # first calls (kernel builds, uploads), all variants, before any timing
    for name, fn, args in variants:
        _hard_sync(fn(*args))
        if verbose:
            print(f"[ab] warmed {name}", flush=True)
    slopes: Dict[str, List[float]] = {n: [] for n in names}
    for r in range(rounds):
        order = variants[r % len(variants):] + variants[:r % len(variants)]
        for name, fn, args in order:
            s = marginal_slope(fn, *args, n1=n1, n2=n2)
            slopes[name].append(s)
            if verbose:
                print(f"[ab] round {r} {name}: {s * 1e3:.1f} ms",
                      flush=True)
    out: Dict[str, Any] = {}
    for n in names:
        arr = np.asarray(slopes[n])
        out[n] = {"median_s": float(np.median(arr)),
                  "mean_s": float(arr.mean()),
                  "slopes": [float(x) for x in arr]}
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            d = np.asarray(slopes[a]) - np.asarray(slopes[b])
            df = len(d) - 1
            if df >= 1:
                half = _T975[min(df, len(_T975)) - 1] * d.std(ddof=1) \
                    / np.sqrt(len(d))
            else:
                half = float("inf")
            out[("pair", a, b)] = {
                "mean_s": float(d.mean()),
                "ci95_s": float(half),
                "significant": bool(abs(d.mean()) > half)}
    return out
