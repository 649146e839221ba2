"""PBRT-4 style light BVH: SAOH build over emissive triangles.

Role-equivalent of the reference's LightBVHBuilder
(Builders/LightBVHBuilder.cs:35-345: LightBounds cones, UnionCone,
SAOH EvaluateCost, compact 40-byte nodes) — implemented fresh from the
published PBRT-4 light-sampling chapter, with a layout shared with the JAX
descent kernel (kernels/lighttree.py):

  nodes [N,12] float32:  bounds_min(3) bounds_max(3) axis(3)
                         cos_theta_o cos_theta_e phi
  info  [N,2]  int32:    leaf     -> (first_prim_slot, count > 0)
                         internal -> (left_child, -right_child)  (b < 0)
  prim  [L]    int32:    leaf slots -> light index (into LightTris)
  trail [L]    uint32:   per-light root->leaf path bits (bit k set = right
                         child at depth k) for O(depth) pdf evaluation.

Emission cones: triangles emit from their front face -> axis = geometric
normal, cos_theta_o = 1 (no orientation spread within one tri),
cos_theta_e = cos(pi/2) = 0 (emission falls to zero at grazing).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_LEAF = 1            # one emissive tri per leaf keeps pdf eval exact
N_SPLIT_BINS = 12


@dataclass
class LightBVH:
    nodes: np.ndarray   # [N,12] f32
    info: np.ndarray    # [N,2] i32
    prim: np.ndarray    # [L] i32 leaf slot -> light index
    trail: np.ndarray   # [L] u32 indexed by light index
    depth: int


def _clip1(x):
    """np.clip(x, -1, 1) of a scalar, without the ufunc's overhead."""
    return min(max(x, -1.0), 1.0)


def _cross(a, b):
    """np.cross of two 3-vectors: each component two rounded products and
    their rounded difference, as numpy computes it, without its
    overhead (the build calls it hundreds of thousands of times)."""
    return np.array([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def _cone_union(a_axis, a_cos, b_axis, b_cos):
    """Union of two direction cones (axis, cos half-angle) -> (axis, cos).
    Algorithm of PBRT-4 DirectionCone::Union."""
    t_a = np.arccos(_clip1(a_cos))
    t_b = np.arccos(_clip1(b_cos))
    d = np.arccos(_clip1(np.dot(a_axis, b_axis)))
    if min(d + t_b, np.pi) <= t_a:
        return a_axis, a_cos          # a contains b
    if min(d + t_a, np.pi) <= t_b:
        return b_axis, b_cos          # b contains a
    theta_o = (t_a + d + t_b) / 2.0
    if theta_o >= np.pi:
        return a_axis, -1.0
    axis = _rotate_toward(a_axis, b_axis, theta_o - t_a)
    return axis, float(np.cos(theta_o))


def _rotate_toward(a, b, angle):
    """Rotate unit vector a toward b by `angle` radians (in their plane)."""
    c = _cross(a, b)
    s = np.linalg.norm(c)
    if s < 1e-8:
        return a
    c = c / s
    return (a * np.cos(angle) + _cross(c, a) * np.sin(angle)
            + c * np.dot(c, a) * (1 - np.cos(angle)))


def _measure(bounds_tuple):
    """SAOH cost surrogate: half-area * phi * orientation solid angle
    (PBRT-4 LightBounds; reference EvaluateCost
    LightBVHBuilder.cs:116-150)."""
    lo, hi, axis, cos_o, phi = bounds_tuple
    d = np.maximum(hi - lo, 0.0)
    area = d[0] * d[1] + d[1] * d[2] + d[2] * d[0]
    theta_o = np.arccos(np.clip(cos_o, -1.0, 1.0))
    theta_e = np.pi / 2.0
    theta_w = min(theta_o + theta_e, np.pi)
    sin_o = np.sin(theta_o)
    m_omega = (2.0 * np.pi * (1.0 - cos_o)
               + 0.5 * np.pi * (2.0 * theta_w * sin_o
                                - np.cos(theta_o - 2.0 * theta_w)
                                - 2.0 * theta_o * sin_o + cos_o))
    return max(area, 1e-12) * phi * max(m_omega, 1e-6)


def build_light_bvh(tris: dict, light_tri_ids: np.ndarray,
                    power: np.ndarray) -> LightBVH:
    """tris: dict with p0/e1/e2 (final global arrays); light_tri_ids: [L]
    global tri ids of emissive tris; power: [L] emitted power."""
    L = len(light_tri_ids)
    p0 = tris["p0"][light_tri_ids].astype(np.float64)
    p1 = p0 + tris["e1"][light_tri_ids]
    p2 = p0 + tris["e2"][light_tri_ids]
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    gn = np.cross(p1 - p0, p2 - p0)
    gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    cent = (p0 + p1 + p2) / 3.0

    nodes_f: list = []
    nodes_i: list = []
    prim_order: list = []
    trail = np.zeros(L, np.uint32)
    max_depth = [1]

    def make_bounds(ids):
        blo = lo[ids].min(axis=0)
        bhi = hi[ids].max(axis=0)
        axis, cos_o = gn[ids[0]].copy(), 1.0
        for k in ids[1:]:
            axis, cos_o = _cone_union(axis, cos_o, gn[k], 1.0)
        return blo, bhi, axis, cos_o, float(power[ids].sum())

    def emit(ids, depth, trail_bits, trail_len):
        max_depth[0] = max(max_depth[0], depth)
        node_id = len(nodes_f)
        blo, bhi, axis, cos_o, phi = make_bounds(ids)
        nodes_f.append(np.concatenate(
            [blo, bhi, axis, [cos_o, 0.0, phi]]).astype(np.float32))
        nodes_i.append([0, 0])
        if len(ids) <= MAX_LEAF or depth > 30:
            first = len(prim_order)
            for k in ids:
                trail[k] = trail_bits
                prim_order.append(k)
            nodes_i[node_id] = [first, len(ids)]
            return node_id
        c = cent[ids]
        best = None
        for ax in range(3):
            cmin, cmax = c[:, ax].min(), c[:, ax].max()
            if cmax - cmin < 1e-9:
                continue
            for b in range(1, N_SPLIT_BINS):
                t = cmin + (cmax - cmin) * b / N_SPLIT_BINS
                sel = c[:, ax] <= t
                if sel.all() or not sel.any():
                    continue
                cost = (_measure(make_bounds(ids[sel]))
                        + _measure(make_bounds(ids[~sel])))
                if best is None or cost < best[0]:
                    best = (cost, sel)
        if best is None:          # coincident centroids: index split
            half = len(ids) // 2
            sel = np.zeros(len(ids), bool)
            sel[:half] = True
            best = (0.0, sel)
        sel = best[1]
        left_id = emit(ids[sel], depth + 1, trail_bits, trail_len + 1)
        right_id = emit(ids[~sel], depth + 1,
                        trail_bits | np.uint32(1 << trail_len),
                        trail_len + 1)
        nodes_i[node_id] = [left_id, -right_id]
        return node_id

    emit(np.arange(L), 1, np.uint32(0), 0)
    return LightBVH(nodes=np.stack(nodes_f),
                    info=np.asarray(nodes_i, np.int32),
                    prim=np.asarray(prim_order, np.int32),
                    trail=trail, depth=max_depth[0])


def build_pairs(nodes: np.ndarray, info: np.ndarray):
    """Pack the light BVH into descent 'pair rows' so the sampler does ONE
    gather per step instead of three (left row + right row + info):

      pairs [Ni, 26] f32: cols 0..11  = left-child bounds row,
                          cols 12..23 = right-child bounds row,
                          col 24/25   = links (bitcast int32):
                              >= 0 -> pair-row index of that internal child
                              <  0 -> -(leaf first_prim + 1)

    Returns (pairs, pair_children [Ni,2] node ids — the refit path uses
    them to rebuild pairs from refit node rows). The root is pair row 0
    (or the tree is a single leaf: Ni == 0)."""
    N = nodes.shape[0]
    internal = info[:, 1] < 0
    node_to_pair = np.full(N, -1, np.int32)
    ids = np.nonzero(internal)[0]
    node_to_pair[ids] = np.arange(ids.size, dtype=np.int32)
    Ni = ids.size
    pairs = np.zeros((Ni, 26), np.float32)
    pair_children = np.zeros((Ni, 2), np.int32)
    for k, n in enumerate(ids):
        l, r = info[n, 0], -info[n, 1]
        pairs[k, 0:12] = nodes[l]
        pairs[k, 12:24] = nodes[r]
        pair_children[k] = (l, r)
        for c, col in ((l, 24), (r, 25)):
            if info[c, 1] < 0:
                pairs[k:k + 1].view(np.int32)[0, col] = node_to_pair[c]
            else:
                pairs[k:k + 1].view(np.int32)[0, col] = -(info[c, 0] + 1)
    return pairs, pair_children


@dataclass
class LightCut:
    """Fixed cut of the light BVH for dense (gather-free) selection.

    The descent's per-step dependent gathers are latency-bound on TPU
    (~190 ms/frame measured at 512^2 x 4 bounces); evaluating importance
    DENSELY over a small cut of subtree roots is throughput-bound VPU work
    instead. Sampling = categorical over the cut + a residual descent
    below the chosen cut node (zero steps when the tree has <= max_cut
    lights, as the cut is then the leaf set).
    """
    bounds: np.ndarray     # [M,12] f32 node bounds rows of the cut
    link: np.ndarray       # [M] i32: pair-row index (internal) or
                           #          -(first_prim+1) (leaf)
    node_ids: np.ndarray   # [M] i32 node id of each cut entry (refit
                           #          refresh: bounds = nodes[node_ids])
    of_light: np.ndarray   # [L] i32 light index -> cut entry of ancestor
    skip: np.ndarray       # [L] i32 trail bits consumed above the cut
                           #          (= cut-entry depth, root = 0)


def build_cut(bvh: LightBVH, max_cut: int = 128) -> LightCut:
    """BFS the light BVH to the shallowest frontier with <= max_cut
    entries; leaves encountered above it join the cut directly."""
    nodes, info, prim = bvh.nodes, bvh.info, bvh.prim
    L = prim.shape[0]
    internal = info[:, 1] < 0
    node_to_pair = np.full(nodes.shape[0], -1, np.int32)
    ids = np.nonzero(internal)[0]
    node_to_pair[ids] = np.arange(ids.size, dtype=np.int32)

    frontier = [(0, 0)]                    # (node_id, depth)
    while True:
        nxt = []
        grew = False
        for nid, d in frontier:
            if internal[nid]:
                nxt.append((info[nid, 0], d + 1))
                nxt.append((-info[nid, 1], d + 1))
                grew = True
            else:
                nxt.append((nid, d))
        if not grew or len(nxt) > max_cut:
            break
        frontier = nxt

    M = len(frontier)
    bounds = np.zeros((M, 12), np.float32)
    link = np.zeros((M,), np.int32)
    node_ids = np.zeros((M,), np.int32)
    of_light = np.zeros((L,), np.int32)
    skip = np.zeros((L,), np.int32)

    def leaves_under(nid):
        if internal[nid]:
            yield from leaves_under(info[nid, 0])
            yield from leaves_under(-info[nid, 1])
        else:
            first, count = info[nid]
            for s in range(first, first + count):
                yield prim[s]

    for k, (nid, d) in enumerate(frontier):
        bounds[k] = nodes[nid]
        node_ids[k] = nid
        link[k] = (node_to_pair[nid] if internal[nid]
                   else -(info[nid, 0] + 1))
        for li in leaves_under(nid):
            of_light[li] = k
            skip[li] = d
    return LightCut(bounds=bounds, link=link, node_ids=node_ids,
                    of_light=of_light, skip=skip)
