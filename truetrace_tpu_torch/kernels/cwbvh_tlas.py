"""Two-level (TLAS -> BLAS) CWBVH traversal over instanced scenes.

Port of `truetrace_tpu/kernels/cwbvh_tlas.py`: the TLAS is a CWBVH whose
leaf slots are instances. A leaf slot of a lane outside a BLAS enters
that instance: the ray goes into instance-local space by the instance's
W2L, with its direction normalised (the local-per-world t scale is kept
beside it), the TLAS remainder is pushed and the walk goes on from the
instance's BLAS root; a pop below the stack height of the entry restores
the world ray. t is kept in world units and compared as t * scale inside
a BLAS.

The unified table gets a third section (`pack_table(nodes, leaf_rows,
inst_rows)`): rows [0, C) expanded nodes (TLAS first, then every BLAS),
[C, C+L) the BLAS leaf rows, [C+L, C+L+I) the instance rows
(`pack_instance_rows`: W2L as 12 floats, the BLAS root node at word 12,
the instance id at word 13, in TLAS leaf order).

Two implementations of one traversal, with three query types:

* `closest_hit_tlas` / `any_hit_tlas` / `transmit_tlas` launch the CUDA
  kernel `csrc/traverse_tlas.cu` on CUDA tensors and run the plain
  version on CPU tensors; each counts its launches in `launches`.
* `closest_hit_tlas_plain` / `any_hit_tlas_plain` /
  `transmit_tlas_plain`: plain PyTorch, lock-step iterations over all
  lanes mirroring the JAX `_step` / `_step_transmit` op for op (the
  shift-register stack included), which can count each ray's work.

The XLA:CPU contraction sites (the Moller mul-adds, the W2L transform
and the squared length of the local direction) are fma()s in both, so
t, u, v and the transmittance are bitwise those of the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from truetrace_tpu_torch.core.math import fma, sqrt_rn
from truetrace_tpu_torch.kernels import _cuda
from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
    ANY, CLOSEST, ITER_CAP, LEAF_MASK, M32, OPAQUE, PTR_MASK, TRANSMIT,
    _DETACH_SITE, _decode, _extract_slot, _inv_dir, _launch_args, _row_cols,
    _tri_test, popcount32)
from truetrace_tpu_torch.kernels.traverse_ref import Hit

MAX_STACK = 16          # the JAX package's MAX_STACK: the ring's depth


def pack_instance_rows(w2l: np.ndarray, node_offset: np.ndarray,
                       inst_id: np.ndarray, width: int = 30) -> np.ndarray:
    """[I, width] f32 rows: W2L as 12 floats (3 rotation rows and the
    translation column, scene/instances.py `_mat34`), the BLAS root node
    id (int32 bits at word 12) and the instance id (word 13; rows are in
    TLAS leaf order). `width` is the leaf-row width 10K."""
    I = w2l.shape[0]
    rows = np.zeros((I, width), np.float32)
    rows[:, 0:12] = w2l.reshape(I, 12)
    rows.view(np.int32)[:, 12] = node_offset.astype(np.int32)
    rows.view(np.int32)[:, 13] = inst_id.astype(np.int32)
    return rows


# ---------------------------------------------------------------------------
# plain PyTorch traversal (CPU path and the kernel's reference)
# ---------------------------------------------------------------------------

def _xform(col, px, py, pz, translate: bool):
    """The 3x4 W2L of gathered instance rows (col(k) -> [R] f32) applied
    to a point or a direction, contracted as XLA:CPU does."""
    ox = fma(col(2), pz, fma(col(0), px, col(1) * py))
    oy = fma(col(6), pz, fma(col(4), px, col(5) * py))
    oz = fma(col(10), pz, fma(col(8), px, col(9) * py))
    if translate:
        ox, oy, oz = ox + col(3), oy + col(7), oz + col(11)
    return ox, oy, oz


def _local_dir(ldx, ldy, ldz, s2):
    """The local direction over its length sqrt(s2), divided. The square
    root is rounded to nearest (core/math.py sqrt_rn), as XLA and the
    kernel's __fsqrt_rn give it: torch.sqrt on a CPU tensor is not."""
    n = sqrt_rn(s2)
    return torch.stack([ldx / n, ldy / n, ldz / n], -1)


def _oct(rd):
    return ((rd[:, 0] < 0).long() | ((rd[:, 1] < 0).long() << 1)
            | ((rd[:, 2] < 0).long() << 2))


def _traverse_tlas_plain(table, C: int, L: int, ro, rd, t_max, query: int,
                         max_stack: int, counts: dict | None = None,
                         tint=None):
    """Lock-step two-level traversal of every lane until all are done (the
    JAX `_traverse_tlas` / `transmit_tlas` loops). Returns (Hit, inst)
    for CLOSEST and ANY, the transmittance [R,3] for TRANSMIT.

    counts: if a dict, it receives each ray's work as the kernel does it
    ([R] int64): "node_decodes" (the root's and one per descent),
    "leaf_rows", "tri_tests" (non-padding triangles of those rows),
    "inst_entries" (instance rows read), "accepted" (TRANSMIT: tinted
    triangles), and as ints "rows_touched" (distinct table rows read),
    "live_rays" (the rays the kernel walks: t_max > 0) and "tint_rows"
    (TRANSMIT: distinct tint rows its accepted triangles read)."""
    R = ro.shape[0]
    N, W = table.shape
    I = N - C - L
    K = W // 10
    dev = ro.device
    ro_w, rd_w = ro, rd
    inv_w, oct_w = _inv_dir(rd), _oct(rd)
    inv, oct_key = inv_w, oct_w
    t = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(
        R).clone()
    scale = torch.ones((R,), device=dev)
    ret_sp = torch.full((R,), -1, dtype=torch.int64, device=dev)
    tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
    inst = torch.full((R,), -1, dtype=torch.int64, device=dev)
    inst_cur = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u_b = torch.zeros((R,), device=dev)
    v_b = torch.zeros((R,), device=dev)
    ucol, _, _ = _row_cols(table[:1].expand(R, -1))
    hits, chim, bleaf = _decode(ucol, ro, inv, t)
    S = max_stack
    ph = torch.zeros((S, R), dtype=torch.int64, device=dev)
    pc = torch.zeros_like(ph)
    pb = torch.zeros_like(ph)
    sp = torch.zeros((R,), dtype=torch.int64, device=dev)
    if query == TRANSMIT:
        tp = [torch.ones((R,), device=dev) for _ in range(3)]
        T = tint.shape[0]
    if counts is not None:
        live = t > 0
        n_node = live.long()
        n_leaf = torch.zeros_like(n_node)
        n_tri = torch.zeros_like(n_node)
        n_ent = torch.zeros_like(n_node)
        n_acc = torch.zeros_like(n_node)
        touched = torch.zeros((N,), dtype=torch.bool, device=dev)
        touched[0] = bool(live.any())
        if query == TRANSMIT:
            tint_touched = torch.zeros((T,), dtype=torch.bool, device=dev)

    for _ in range(ITER_CAP):
        if not bool(((hits != 0) | (sp > 0)).any()):
            break
        in_blas = ret_sp >= 0
        # 1. pop; a pop below the entry's stack height leaves the instance
        pop = (hits == 0) & (sp > 0)
        hits = torch.where(pop, ph[0], hits)
        chim = torch.where(pop, pc[0], chim)
        bleaf = torch.where(pop, pb[0], bleaf)
        sp = sp - pop.long()
        leave = pop & in_blas & (sp < ret_sp)
        ro = torch.where(leave[:, None], ro_w, ro)
        rd = torch.where(leave[:, None], rd_w, rd)
        inv = torch.where(leave[:, None], inv_w, inv)
        oct_key = torch.where(leave, oct_w, oct_key)
        scale = torch.where(leave, 1.0, scale)
        ret_sp = torch.where(leave, -1, ret_sp)
        in_blas = ret_sp >= 0
        inst_cur = torch.where(leave, -1, inst_cur)
        # 2. choose work: a leaf slot enters an instance outside a BLAS
        # and is a leaf row of triangles inside one
        leaf_bits = hits & LEAF_MASK
        node_bits = hits >> 24
        active = hits != 0
        leaf_lane = active & (leaf_bits != 0)
        descend = active & ~leaf_lane
        enter = leaf_lane & ~in_blas
        tri_lane = leaf_lane & in_blas
        lsb = leaf_bits & ((~leaf_bits + 1) & M32)
        lbase = (bleaf & PTR_MASK) + popcount32((bleaf >> 24)
                                                & ((lsb - 1) & M32))
        lrow = torch.clamp(lbase, 0, max(L - 1, 0))
        irow = torch.clamp(lbase, 0, I - 1)
        slot, node_rest = _extract_slot(node_bits, oct_key)
        below = (chim >> 24) & (((1 << torch.clamp(slot, max=31)) - 1) & M32)
        child = torch.clamp((chim & PTR_MASK) + popcount32(below), 0, C - 1)
        # 3. one row per lane: leaf row, instance row or child node row
        row_idx = torch.where(tri_lane, C + lrow, torch.where(
            enter, C + L + irow, torch.where(descend, child, 0)))
        ucol, fcol, icol = _row_cols(table[row_idx])
        if counts is not None:
            n_node += (live & descend).long()
            n_leaf += (live & tri_lane).long()
            n_ent += (live & enter).long()
            for j in range(K):
                n_tri += (live & tri_lane & (icol(9 * K + j) >= 0)).long()
            touched[row_idx[live & active]] = True
        # 3a. triangle lanes: Moller tests in local space against t*scale
        t_loc = t * scale
        for j in range(K):
            ok, th, u, v, tri_id = _tri_test(fcol, icol, K, j, ro, rd,
                                             tri_lane, t_loc)
            if query == TRANSMIT:
                trow = tint[torch.clamp(tri_id, 0, T - 1)]
                for c in range(3):
                    tp[c] = torch.where(ok, tp[c] * trow[:, c], tp[c])
                if counts is not None:
                    n_acc += (live & ok).long()
                    tint_touched[torch.clamp(tri_id, 0, T - 1)[
                        live & ok]] = True
                continue
            t_loc = torch.where(ok, th, t_loc)
            t = torch.where(ok, th / torch.clamp(scale, min=1e-20), t)
            tri = torch.where(ok, tri_id, tri)
            inst = torch.where(ok, inst_cur, inst)
            u_b = torch.where(ok, u, u_b)
            v_b = torch.where(ok, v, v_b)
        hits_after_leaf = hits & (~lsb & M32)
        # 3b. instance-entry lanes: the ray in local space
        lox, loy, loz = _xform(fcol, ro[:, 0], ro[:, 1], ro[:, 2], True)
        ldx, ldy, ldz = _xform(fcol, rd[:, 0], rd[:, 1], rd[:, 2], False)
        s2 = torch.clamp(fma(ldz, ldz, fma(ldx, ldx, ldy * ldy)), min=1e-20)
        lscale = sqrt_rn(s2)
        ro_l = torch.stack([lox, loy, loz], -1)
        rd_l = _local_dir(ldx, ldy, ldz, s2)
        # 4. stack: pop applies first, then push on the popped state; an
        # entry pushes the TLAS remainder (its leaf bits included)
        push = ((descend & (node_rest != 0))
                | (enter & (hits_after_leaf != 0)))
        saved = torch.where(enter, hits_after_leaf, node_rest << 24)
        for plane, val in ((ph, saved), (pc, chim), (pb, bleaf)):
            based = torch.where(pop[None, :], torch.cat(
                [plane[1:], torch.zeros_like(plane[:1])]), plane)
            pushed = torch.cat([val[None, :], based[:-1]])
            plane.copy_(torch.where(push[None, :], pushed, based))
        sp = sp + push.long()
        ro = torch.where(enter[:, None], ro_l, ro)
        rd = torch.where(enter[:, None], rd_l, rd)
        inv = torch.where(enter[:, None], _inv_dir(rd_l), inv)
        oct_key = torch.where(enter, _oct(rd_l), oct_key)
        scale = torch.where(enter, lscale, scale)
        ret_sp = torch.where(enter, sp, ret_sp)
        inst_cur = torch.where(enter, icol(13), inst_cur)
        # descend lanes decode the fetched node; entering lanes take a
        # one-slot group whose internal slot 0 is the BLAS root
        c_hits, c_chim, c_bleaf = _decode(ucol, ro, inv, t * scale)
        hits = torch.where(descend, c_hits, torch.where(
            enter, 1 << 24, torch.where(tri_lane, hits_after_leaf, hits)))
        chim = torch.where(descend, c_chim, torch.where(
            enter, (ucol(12) & PTR_MASK) | (1 << 24), chim))
        bleaf = torch.where(descend, c_bleaf, torch.where(enter, 0, bleaf))
        if query == ANY:
            done = tri >= 0
        elif query == TRANSMIT:
            done = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]) < OPAQUE
        if query != CLOSEST:
            hits = torch.where(done, 0, hits)
            sp = torch.where(done, 0, sp)
    if counts is not None:
        counts.update(node_decodes=n_node, leaf_rows=n_leaf, tri_tests=n_tri,
                      inst_entries=n_ent, rows_touched=int(touched.sum()),
                      live_rays=int(live.sum()))
        if query == TRANSMIT:
            counts.update(accepted=n_acc, tint_rows=int(tint_touched.sum()))
    if query == TRANSMIT:
        tp = torch.stack(tp, -1)
        return torch.where(tp.amax(-1, keepdim=True) < OPAQUE, 0.0, tp)
    return (Hit(t=t, tri=tri.to(torch.int32), u=u_b, v=v_b),
            inst.to(torch.int32))


def closest_hit_tlas_plain(table, C: int, L: int, ro, rd, t_max,
                           max_stack: int = MAX_STACK,
                           counts: dict | None = None):
    """Two-level closest hit: (Hit with global triangle ids, instance id
    per ray, -1 = miss)."""
    return _traverse_tlas_plain(table, C, L, ro, rd, t_max, CLOSEST,
                                max_stack, counts)


def any_hit_tlas_plain(table, C: int, L: int, ro, rd, t_max,
                       max_stack: int = MAX_STACK,
                       counts: dict | None = None):
    """Occlusion bool [R]: True = blocked before t_max."""
    hit, _ = _traverse_tlas_plain(table, C, L, ro, rd, t_max, ANY,
                                  max_stack, counts)
    return hit.tri >= 0


def transmit_tlas_plain(table, C: int, L: int, tint, ro, rd, t_max,
                        max_stack: int = MAX_STACK,
                        counts: dict | None = None):
    """Shadow transmittance [R,3]: the product of the shadow tints tint
    [T,3] (indexed by global triangle id) of every triangle crossed
    before t_max; 0 where it falls below OPAQUE."""
    return _traverse_tlas_plain(table, C, L, ro, rd, t_max, TRANSMIT,
                                max_stack, counts, tint)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _launch(table, C: int, L: int, ro, rd, t_max, query: int,
            max_stack: int, tint=None, lib=None):
    """Check the arguments, allocate the outputs and the ray counter,
    launch traverse_tlas.cu (or another build of it, `lib`, with the same
    entry points): (Hit, inst) for CLOSEST / ANY, the transmittance [R,3]
    for TRANSMIT."""
    dev = ro.device
    R = ro.shape[0]
    tm = _launch_args(table, ro, rd, t_max, max_stack,
                      tint if query == TRANSMIT else None,
                      "traverse_tlas.cu")
    N, W = table.shape
    I = N - C - L
    if C < 1 or L < 1 or I < 1:
        raise ValueError(f"bad table {tuple(table.shape)} for {C} nodes "
                         f"and {L} leaf rows")
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    if lib is None:
        lib = _cuda.lib("traverse_tlas.cu")
    if query == TRANSMIT:
        T = tint.shape[0]
        tp = torch.empty((R, 3), dtype=torch.float32, device=dev)
        err = lib.tt_tlas_transmit(
            table.data_ptr(), W, C, L, I, max_stack, tint.data_ptr(), T,
            ro.data_ptr(), rd.data_ptr(), tm.data_ptr(), R,
            next_ray.data_ptr(), tp.data_ptr(), _cuda.stream_ptr(ro))
        _cuda.check(err, "tt_tlas_transmit")
        return tp
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    inst = torch.empty((R,), dtype=torch.int32, device=dev)
    err = lib.tt_tlas_traverse(
        table.data_ptr(), W, C, L, I, max_stack, ro.data_ptr(),
        rd.data_ptr(), tm.data_ptr(), R, int(query == ANY),
        next_ray.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), inst.data_ptr(), _cuda.stream_ptr(ro))
    _cuda.check(err, "tt_tlas_traverse")
    return Hit(t=t, tri=tri, u=u, v=v), inst


def closest_hit_tlas(table, C: int, L: int, ro, rd, t_max,
                     max_stack: int = MAX_STACK):
    """Two-level closest hit of rays ro/rd [R,3] before t_max (scalar or
    [R]) in the unified table (`pack_table` with instance rows: C node
    rows, L leaf rows, then the instance rows). Returns (Hit, inst [R]
    int32). CUDA tensors launch csrc/traverse_tlas.cu; CPU tensors take
    closest_hit_tlas_plain. A tensor that requires grad raises
    ValueError (the traversal is not differentiated)."""
    _cuda.refuse_grad("closest_hit_tlas", _DETACH_SITE, table, ro, rd, t_max)
    if ro.device.type == "cpu":
        return closest_hit_tlas_plain(table, C, L, ro, rd, t_max, max_stack)
    out = _launch(table, C, L, ro, rd, t_max, CLOSEST, max_stack)
    closest_hit_tlas.launches += 1
    return out


def any_hit_tlas(table, C: int, L: int, ro, rd, t_max,
                 max_stack: int = MAX_STACK):
    """Occlusion bool [R] (True = blocked before t_max); dispatch as
    closest_hit_tlas."""
    _cuda.refuse_grad("any_hit_tlas", _DETACH_SITE, table, ro, rd, t_max)
    if ro.device.type == "cpu":
        return any_hit_tlas_plain(table, C, L, ro, rd, t_max, max_stack)
    hit, _ = _launch(table, C, L, ro, rd, t_max, ANY, max_stack)
    any_hit_tlas.launches += 1
    return hit.tri >= 0


def transmit_tlas(table, C: int, L: int, tint, ro, rd, t_max,
                  max_stack: int = MAX_STACK):
    """Shadow transmittance [R,3] (1 = clear, 0 = blocked) through the
    shadow tints tint [T,3]; dispatch as closest_hit_tlas."""
    _cuda.refuse_grad("transmit_tlas", _DETACH_SITE, table, tint, ro, rd,
                      t_max)
    if ro.device.type == "cpu":
        return transmit_tlas_plain(table, C, L, tint, ro, rd, t_max,
                                   max_stack)
    tp = _launch(table, C, L, ro, rd, t_max, TRANSMIT, max_stack, tint)
    transmit_tlas.launches += 1
    return tp


closest_hit_tlas.launches = 0
any_hit_tlas.launches = 0
transmit_tlas.launches = 0
