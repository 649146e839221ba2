"""The Tier-1 test budget from pytest's junit files: seconds per test
file, the port's summed seconds (tests/test_torch_*.py) against a
parent's over runs taken in turns, and where the wall goes under
pytest-xdist's `--dist loadfile`.

The schedule replay: pytest-xdist (`--loadscope-reorder`, its default)
hands out whole files in order of their test count, most first (ties in
collection order), each to the first worker to free up. Replaying one
run's per-file seconds through that order gives the run's wall without
the workers' start-up and names the files that end it.

Usage:
    python3 scripts/torch_test_budget.py --parent p1.xml,p2.xml,p3.xml \
        --change c1.xml,c2.xml,c3.xml [--workers 6] [--schedule run.xml]
"""
from __future__ import annotations

import argparse
import collections
import heapq
import statistics
import xml.etree.ElementTree as ET

PORT = "test_torch_"


def per_file(path: str):
    """({file: summed test seconds}, {file: test count}) of one junit
    file; a module fixture's set-up is in its first test's time."""
    secs, count = collections.Counter(), collections.Counter()
    for case in ET.parse(path).getroot().iter("testcase"):
        f = case.attrib.get("classname", "").split(".")[-1]
        secs[f] += float(case.attrib["time"])
        count[f] += 1
    return secs, count


def port_sum(secs) -> float:
    return sum(v for k, v in secs.items() if k.startswith(PORT))


def schedule(secs, count, workers: int):
    """[(file, start, end)] of the loadfile replay, the latest end first."""
    order = sorted(sorted(count), key=lambda f: -count[f])
    free = [(0.0, w) for w in range(workers)]
    out = []
    for f in order:
        t, w = heapq.heappop(free)
        out.append((f, t, t + secs[f]))
        heapq.heappush(free, (t + secs[f], w))
    return sorted(out, key=lambda r: -r[2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    ap.add_argument("--change", default="")
    ap.add_argument("--schedule", default="")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args()
    runs = {k: [per_file(p)[0] for p in v.split(",") if p]
            for k, v in (("parent", args.parent), ("change", args.change))}
    for k, rs in runs.items():
        if rs:
            sums = [port_sum(r) for r in rs]
            print(f"{k}: port seconds {[round(s, 1) for s in sums]}, mean "
                  f"{statistics.mean(sums):.1f}, median "
                  f"{statistics.median(sums):.1f}")
    if runs["parent"] and runs["change"]:
        files = sorted({f for rs in runs.values() for r in rs for f in r
                        if f.startswith(PORT)})
        mean = {k: {f: statistics.mean(r[f] for r in rs) for f in files}
                for k, rs in runs.items()}
        for f in sorted(files, key=lambda f: mean["change"][f]
                        - mean["parent"][f]):
            print(f"  {f:34s} parent {mean['parent'][f]:7.1f}  change "
                  f"{mean['change'][f]:7.1f}  "
                  f"{mean['change'][f] - mean['parent'][f]:+7.1f}")
    if args.schedule:
        secs, count = per_file(args.schedule)
        rows = schedule(secs, count, args.workers)
        total = sum(secs.values())
        print(f"schedule replay of {args.schedule}: wall {rows[0][2]:.1f} "
              f"s, summed {total:.1f} s ({total / args.workers:.1f} s a "
              f"worker if balanced); last to end:")
        for f, start, end in rows[:5]:
            print(f"  {f:34s} {count[f]:4d} tests {secs[f]:7.1f} s, "
                  f"from {start:7.1f} to {end:7.1f}")


if __name__ == "__main__":
    main()
