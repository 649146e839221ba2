"""CWBVH and light-BVH refit: bottom-up level sweeps for deformed
geometry (torch ops).

Port of `truetrace_tpu/build/refit.py` (the reference's
BVHRefitter.compute `RefitLayer` / `NodeUpdate` / `NodeCompress` and
LightBVHRefitter.compute). The node boxes go up one vectorised pass per
depth level (gather the child boxes, union); the requantisation and the
repack of the 20-word rows, per node as the JAX package's level sweep
does them, then run once over all nodes. Topology (words 4..7) is
untouched. The level worklists are index tensors made once when the
scene is built and moved to its device, so a refit makes no host copy
and no sync.

The node words are the JAX package's bit for bit: the exponent comes
from XLA:CPU's own log2 and exp2 (core/math.py `log2_xla`, `exp2_xla`),
which torch's differ from by an ulp near powers of two; the u32 words
are assembled in int64 masked to 32 bits and kept as int32 bits.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from truetrace_tpu_torch.core.math import cross_fma, exp2_xla, log2_xla

M32 = 0xFFFFFFFF
INF = math.inf


def level_worklists(node_depth: np.ndarray, device="cuda"
                    ) -> Tuple[torch.Tensor, ...]:
    """Node ids grouped by depth, deepest level first, on `device`."""
    d = np.asarray(node_depth)
    return tuple(torch.as_tensor(np.nonzero(d == lvl)[0], dtype=torch.int64,
                                 device=device)
                 for lvl in range(int(d.max()), 0, -1))


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def _pack_bytes4(b0, b1, b2, b3):
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def refit_cwbvh(nodes, tri_p0, tri_e1, tri_e2, slot_child, slot_tri_base,
                slot_tri_count, levels, leaf_k: int = 3):
    """Recompute every node's bounds for updated triangles.

    nodes [C,20] int32 bits; tri_* [T,3] in CWBVH order; slot_* [C,8]
    from the builder; levels from `level_worklists`; leaf_k the builder's
    triangles per leaf slot. Returns (new nodes [C,20] int32 bits, root
    aabb [2,3]).

    Only the node boxes need the bottom-up order (an internal slot is its
    child's box); the leaf slots' boxes, the requantisation and the
    repack are the same per-node formulas as the JAX package's level
    sweep, run once over all nodes: the same bits in a few hundred
    kernels rather than a few hundred a level."""
    C = nodes.shape[0]
    T = tri_p0.shape[0]
    dev = tri_p0.device
    # leaf-slot boxes: the union of up to leaf_k triangles
    leaf_lo = torch.full((C, 8, 3), INF, device=dev)
    leaf_hi = torch.full((C, 8, 3), -INF, device=dev)
    for j in range(leaf_k):
        tid = torch.clamp(slot_tri_base + j, 0, T - 1)
        p0 = tri_p0[tid]
        p1 = p0 + tri_e1[tid]
        p2 = p0 + tri_e2[tid]
        use = (j < slot_tri_count)[..., None]
        leaf_lo = torch.where(use, torch.minimum(
            leaf_lo, torch.minimum(torch.minimum(p0, p1), p2)), leaf_lo)
        leaf_hi = torch.where(use, torch.maximum(
            leaf_hi, torch.maximum(torch.maximum(p0, p1), p2)), leaf_hi)
    is_int = (slot_child >= 0)[..., None]
    is_leaf = (slot_tri_count > 0)[..., None]
    ch = torch.clamp(slot_child, min=0)
    leaf_lo = torch.where(is_leaf, leaf_lo, INF)
    leaf_hi = torch.where(is_leaf, leaf_hi, -INF)

    # node boxes, deepest level first: internal slots from the children
    node_lo = torch.full((C, 3), INF, device=dev)
    node_hi = torch.full((C, 3), -INF, device=dev)
    for ids in levels:
        if ids.numel() == 0:
            continue
        c, i = ch[ids], is_int[ids]
        node_lo[ids] = torch.where(i, node_lo[c], leaf_lo[ids]).amin(1)
        node_hi[ids] = torch.where(i, node_hi[c], leaf_hi[ids]).amax(1)
    slot_lo = torch.where(is_int, node_lo[ch], leaf_lo)
    slot_hi = torch.where(is_int, node_hi[ch], leaf_hi)
    n_lo, n_hi = node_lo, node_hi

    # requantise (reference NodeUpdate: conservative 8-bit)
    ext = torch.clamp(n_hi - n_lo, min=0.0)
    e = torch.ceil(log2_xla(torch.clamp(ext, min=1e-30) / 255.0))
    e = torch.where(255.0 * exp2_xla(e) < ext, e + 1.0, e)
    e_b = torch.clamp(e + 127.0, 1.0, 254.0).to(torch.int64)
    scale = exp2_xla(e_b.to(torch.float32) - 127.0)[:, None, :]
    valid = is_int | is_leaf
    q_lo = torch.floor((slot_lo - n_lo[:, None, :]) / scale)
    q_hi = torch.ceil((slot_hi - n_lo[:, None, :]) / scale)
    q_lo = torch.where(valid, torch.clamp(q_lo, 0, 255), 255.0)
    q_hi = torch.where(valid, torch.clamp(q_hi, 0, 255), 0.0)
    q_lo, q_hi = q_lo.to(torch.int64), q_hi.to(torch.int64)

    # repack words 0..3 (origin, exponents, imask) and 8..19 (the
    # quantised bytes); words 4..7 (topology) stay
    rows = nodes.to(torch.int64) & M32
    origin = n_lo.contiguous().view(torch.int32).to(torch.int64) & M32
    words = [origin[:, a] for a in range(3)]
    words.append(e_b[:, 0] | (e_b[:, 1] << 8) | (e_b[:, 2] << 16)
                 | (rows[:, 3] & 0xFF000000))
    words += [rows[:, w] for w in range(4, 8)]
    for src in (q_lo, q_hi):
        for axis in range(3):
            a = src[:, :, axis]
            words.append(_pack_bytes4(a[:, 0], a[:, 1], a[:, 2], a[:, 3]))
            words.append(_pack_bytes4(a[:, 4], a[:, 5], a[:, 6], a[:, 7]))
    # every node of a builder's tree sits on a level (root depth 1)
    return _as_i32(torch.stack(words, 1)), torch.stack([node_lo[0],
                                                        node_hi[0]])


def deform_tris(tri_p0, tri_e1, tri_e2, transform_fn):
    """Apply a vertex-space deformation ([N,3] -> [N,3]) to edge-form
    triangles. Returns new (p0, e1, e2)."""
    v0 = transform_fn(tri_p0)
    v1 = transform_fn(tri_p0 + tri_e1)
    v2 = transform_fn(tri_p0 + tri_e2)
    return v0, v1 - v0, v2 - v0


# ---------------------------------------------------------------------------
# light-BVH refit (reference LightBVHRefitter.compute: bottom-up cone
# unions, bounds and power per depth layer)
# ---------------------------------------------------------------------------

def light_level_worklists(info: np.ndarray, device="cuda"
                          ) -> Tuple[torch.Tensor, ...]:
    """Node ids per depth (deepest first) for the light BVH layout of
    build/lightbvh.py (info: leaf -> (first, count > 0); internal ->
    (left, -right)), on `device`."""
    info = np.asarray(info)
    depth = np.zeros(info.shape[0], np.int32)
    stack = [(0, 1)]
    while stack:
        n, d = stack.pop()
        depth[n] = d
        if info[n, 1] < 0:
            stack.append((info[n, 0], d + 1))
            stack.append((-info[n, 1], d + 1))
    return tuple(torch.as_tensor(np.nonzero(depth == lvl)[0],
                                 dtype=torch.int64, device=device)
                 for lvl in range(int(depth.max()), 0, -1))


def _cone_union(a_axis, a_cos, b_axis, b_cos):
    """Vectorised PBRT-4 DirectionCone::Union ([K,3] / [K] inputs)."""
    a_cos = torch.clamp(a_cos, -1.0, 1.0)
    b_cos = torch.clamp(b_cos, -1.0, 1.0)
    t_a = torch.arccos(a_cos)
    t_b = torch.arccos(b_cos)
    d = torch.arccos(torch.clamp((a_axis * b_axis).sum(-1), -1.0, 1.0))
    a_holds = torch.clamp(d + t_b, max=math.pi) <= t_a + 1e-6
    b_holds = torch.clamp(d + t_a, max=math.pi) <= t_b + 1e-6
    theta_o = 0.5 * (t_a + d + t_b)
    full = theta_o >= math.pi - 1e-6
    # rotate a toward b by (theta_o - t_a)
    c = cross_fma(a_axis, b_axis)
    s = torch.linalg.norm(c, dim=-1, keepdim=True)
    c_n = c / torch.clamp(s, min=1e-8)
    ang = (theta_o - t_a)[..., None]
    rot = (a_axis * torch.cos(ang) + cross_fma(c_n, a_axis) * torch.sin(ang)
           + c_n * (c_n * a_axis).sum(-1, keepdim=True)
           * (1 - torch.cos(ang)))
    rot = torch.where(s < 1e-8, a_axis, rot)
    axis = torch.where(a_holds[..., None], a_axis,
                       torch.where(b_holds[..., None], b_axis, rot))
    cos_o = torch.where(a_holds, a_cos, torch.where(
        b_holds, b_cos, torch.where(full, -1.0, torch.cos(theta_o))))
    return axis, cos_o


def refit_light_bvh(nodes, info, prim, tri_p0, tri_e1, tri_e2,
                    light_tri_ids, power, levels):
    """Recompute the light BVH's node bounds, cones and power for moved
    emissive triangles; the topology (info, prim, trail) stays, as in the
    reference's GPU light refit. Returns new nodes [N,12].

    nodes [N,12], info [N,2], prim [L], light_tri_ids [L] (global
    triangle ids), power [L], all on the device; levels from
    `light_level_worklists`."""
    tid = light_tri_ids[prim]                 # leaf slot -> triangle
    p0 = tri_p0[tid]
    p1 = p0 + tri_e1[tid]
    p2 = p0 + tri_e2[tid]
    slot_lo = torch.minimum(torch.minimum(p0, p1), p2)
    slot_hi = torch.maximum(torch.maximum(p0, p1), p2)
    gn = cross_fma(p1 - p0, p2 - p0)
    gn = gn / torch.clamp(torch.linalg.norm(gn, dim=-1, keepdim=True),
                          min=1e-20)
    slot_pow = power[prim]
    N = nodes.shape[0]
    S = slot_lo.shape[0]
    out = nodes.clone()
    for ids in levels:
        if ids.numel() == 0:
            continue
        is_leaf = info[ids, 1] > 0
        # leaves hold exactly one light (the build's MAX_LEAF = 1)
        first = torch.clamp(info[ids, 0], 0, S - 1)
        l_ph = slot_pow[first]
        leaf = torch.cat([slot_lo[first], slot_hi[first], gn[first],
                          torch.stack([torch.ones_like(l_ph),
                                       torch.zeros_like(l_ph), l_ph], 1)], 1)
        # internal: the union of the two children refit a level below
        lc = torch.clamp(info[ids, 0], 0, N - 1)
        rc = torch.clamp(-info[ids, 1], 0, N - 1)
        i_ax, i_cos = _cone_union(out[lc, 6:9], out[lc, 9], out[rc, 6:9],
                                  out[rc, 9])
        i_ph = out[lc, 11] + out[rc, 11]
        inner = torch.cat([torch.minimum(out[lc, 0:3], out[rc, 0:3]),
                           torch.maximum(out[lc, 3:6], out[rc, 3:6]), i_ax,
                           torch.stack([i_cos, torch.zeros_like(i_ph), i_ph],
                                       1)], 1)
        out[ids] = torch.where(is_leaf[:, None], leaf, inner)
    return out
