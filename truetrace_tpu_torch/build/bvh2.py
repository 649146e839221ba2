"""Binary BVH builder (binned SAH), host-side numpy.

Role-equivalent of the reference's BVH2Builder (Builders/BVH2Builder.cs:39-216,
a full-sweep SAH build over 3 axis-sorted index lists). We use binned SAH
(Wald 2007, 16 bins) instead of full sweep: same quality class, vectorizes
over numpy, and the binning inner loop is what the optional C++ fast path
(build/native/) accelerates for San Miguel-scale scenes.

Output is a flat node array in depth-first order:
  box   [N,2,3] float32   node bounds
  left  [N]     int32     internal: left-child index (right = left+1)
                          leaf:     first primitive (in permuted order)
  count [N]     int32     0 for internal, primitive count for leaf
  order [T]     int32     permutation: leaf-order slot -> original prim id

The same builder serves BLAS (over triangle AABBs) and TLAS (over mesh AABBs),
like the reference's two BVH2Builder ctors (BVH2Builder.cs:117,166).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16
DEFAULT_MAX_LEAF = 4
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0


@dataclass
class BVH2:
    box: np.ndarray     # [N,2,3] f32
    left: np.ndarray    # [N] i32
    count: np.ndarray   # [N] i32
    order: np.ndarray   # [T] i32
    depth: int          # max depth (root = 1)

    @property
    def n_nodes(self) -> int:
        return self.box.shape[0]


def build_bvh2(prim_box: np.ndarray, max_leaf: int = DEFAULT_MAX_LEAF,
               sah_leaf_cap: int = 24, use_native: bool = True) -> BVH2:
    """prim_box: [T,2,3] primitive AABBs.

    max_leaf: split until <= this many prims; sah_leaf_cap: largest leaf the
    SAH early-termination may create (use == max_leaf when the tree feeds the
    CWBVH collapse, which needs leaves <= 3 prims).

    The C++ fast path (build/native/bvh2.cpp, same algorithm) is used when
    available and the scene is big enough for Python overhead to matter."""
    if use_native and prim_box.shape[0] >= 20000:
        from truetrace_tpu_torch.build.native import build_bvh2_native
        out = build_bvh2_native(prim_box, max_leaf, sah_leaf_cap)
        if out is not None:
            box, left, count, order, depth = out
            return BVH2(box=box, left=left, count=count, order=order,
                        depth=depth)
    T = prim_box.shape[0]
    assert T > 0
    lo = prim_box[:, 0, :].astype(np.float64)
    hi = prim_box[:, 1, :].astype(np.float64)
    cent = 0.5 * (lo + hi)

    # output, grown geometrically
    cap = max(2 * T, 16)
    box = np.empty((cap, 2, 3), np.float32)
    left = np.zeros(cap, np.int32)
    count = np.zeros(cap, np.int32)
    order = np.arange(T, dtype=np.int32)

    n_nodes = 0
    max_depth = 0

    def alloc(k: int) -> int:
        nonlocal n_nodes, cap, box, left, count
        if n_nodes + k > cap:
            cap = max(cap * 2, n_nodes + k)
            box = np.resize(box, (cap, 2, 3))
            left = np.resize(left, cap)
            count = np.resize(count, cap)
        i = n_nodes
        n_nodes += k
        return i

    root = alloc(1)
    # stack entries: (node_index, start, end, depth)
    stack = [(root, 0, T, 1)]

    while stack:
        node, s, e, depth = stack.pop()
        max_depth = max(max_depth, depth)
        idx = order[s:e]
        nlo = lo[idx]
        nhi = hi[idx]
        node_lo = nlo.min(axis=0)
        node_hi = nhi.max(axis=0)
        box[node, 0] = node_lo
        box[node, 1] = node_hi
        n = e - s
        if n <= max_leaf:
            left[node] = s
            count[node] = n
            continue

        c = cent[idx]
        c_lo = c.min(axis=0)
        c_hi = c.max(axis=0)
        ext = c_hi - c_lo
        axis = int(np.argmax(ext))
        if ext[axis] <= 1e-12:
            # degenerate: split in the middle by index
            mid = s + n // 2
        else:
            # binned SAH along the widest centroid axis
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            b = ((c[:, axis] - c_lo[axis]) * scale).astype(np.int32)
            # per-bin counts and bounds via scatter-min/max
            cnt = np.bincount(b, minlength=N_BINS)
            blo = np.full((N_BINS, 3), np.inf)
            bhi = np.full((N_BINS, 3), -np.inf)
            np.minimum.at(blo, b, nlo)
            np.maximum.at(bhi, b, nhi)
            # prefix sweeps
            lcnt = np.cumsum(cnt)[:-1]
            rcnt = n - lcnt
            llo = np.minimum.accumulate(blo, axis=0)[:-1]
            lhi = np.maximum.accumulate(bhi, axis=0)[:-1]
            rlo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
            rhi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]

            def _ha(alo, ahi):
                d = np.maximum(ahi - alo, 0.0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = _ha(llo, lhi) * lcnt + _ha(rlo, rhi) * rcnt
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            split_bin = int(np.argmin(cost))

            # leaf termination test (SAH): leaf cost = n * area vs split cost
            d = np.maximum(node_hi - node_lo, 0.0)
            node_area = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
            leaf_cost = INTERSECT_COST * n * node_area
            split_cost = (TRAVERSAL_COST * node_area
                          + INTERSECT_COST * cost[split_bin])
            if leaf_cost <= split_cost and n <= sah_leaf_cap:
                left[node] = s
                count[node] = n
                continue
            sel = b <= split_bin
            k = int(sel.sum())
            if k == 0 or k == n:
                mid = s + n // 2
            else:
                # stable partition of the order slice
                order[s:e] = np.concatenate([idx[sel], idx[~sel]])
                mid = s + k

        lchild = alloc(2)
        left[node] = lchild
        count[node] = 0
        stack.append((lchild + 1, mid, e, depth + 1))
        stack.append((lchild, s, mid, depth + 1))

    return BVH2(box=box[:n_nodes].astype(np.float32),
                left=left[:n_nodes].copy(),
                count=count[:n_nodes].copy(),
                order=order, depth=max_depth)


def sah_cost(bvh: BVH2) -> float:
    """Global SAH cost of the tree (for builder-quality tests)."""
    d = np.maximum(bvh.box[:, 1] - bvh.box[:, 0], 0.0)
    area = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
    root_area = max(float(area[0]), 1e-20)
    internal = bvh.count == 0
    return float((TRAVERSAL_COST * area[internal].sum()
                  + INTERSECT_COST * (area * bvh.count).sum()) / root_area)
