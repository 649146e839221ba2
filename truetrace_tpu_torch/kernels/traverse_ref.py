"""BVH2 traversal, the hit record and the brute-force oracles.

Port of `truetrace_tpu/kernels/traverse_ref.py`: `Hit`,
`closest_hit_bvh2` / `any_hit_bvh2` (the traversal of the JAX package's
default build and `RenderConfig()`'s default `traversal="bvh2"`),
`brute_force_closest` and `transmit_brute`.

The BVH2 traversal has two implementations of one loop:

* `closest_hit_bvh2` / `any_hit_bvh2` launch the CUDA kernel
  `csrc/traverse_bvh2.cu` (persistent warps pulling rays, a lane's stack
  in local memory) on CUDA tensors, over the packed table of
  `pack_bvh2_table` (the scene's cached one where the caller passes it,
  else one packed for the call); on CPU tensors they run the plain
  version. Each counts its launches in its `launches` attribute.
* `closest_hit_bvh2_plain` / `any_hit_bvh2_plain`: plain PyTorch, a
  Python loop of lock-step iterations over all lanes with active masks,
  mirroring the JAX `_traverse` op for op: the root pre-pushed, one pop
  a lane an iteration, a leaf's triangles `j = 0..max_leaf-1` tested in
  order (ids clamped to T - 1, masked by `j < count`), an internal
  node's two children slab-tested against the current closest t and
  pushed far first then near (`near0 = d0 <= d1`), the any hit emptying
  its stack once a triangle is found. A push writes slot
  `min(sp, max_stack - 1)` while `sp` counts on, and a pop reads slot
  `sp - 1` clamped to `max_stack - 1`, as XLA's gather clamps the index.
  It is the CPU path and the kernel's reference on the card, and can
  count each ray's work.

Both round every operation as the JAX loop does on XLA:CPU (core/math.py
`ray_tri_fma`: the contracted mul-adds are `fma`s), so t, tri, u and v
are bitwise equal across the three.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from truetrace_tpu_torch.core.math import ray_aabb, ray_tri, ray_tri_fma
from truetrace_tpu_torch.kernels import _cuda

# the JAX package's default stack depth, and the local-memory stack
# entries a thread of the kernel has (a deeper max_stack raises there)
MAX_STACK = 64


class Hit(NamedTuple):
    t: torch.Tensor        # [R] hit distance (t_max if miss)
    tri: torch.Tensor      # [R] int32 triangle id (-1 if miss)
    u: torch.Tensor        # [R] barycentric u
    v: torch.Tensor        # [R] barycentric v


# ---------------------------------------------------------------------------
# plain PyTorch BVH2 traversal (CPU path and the kernel's reference)
# ---------------------------------------------------------------------------

def _inv_dir(rd):
    return 1.0 / torch.where(rd.abs() < 1e-12,
                             torch.where(rd >= 0, 1e-12, -1e-12), rd)


def _traverse_plain(box, left, count, p0, e1, e2, ro, rd, t_max,
                    any_hit: bool, max_leaf: int, max_stack: int,
                    counts: dict | None = None) -> Hit:
    """The lock-step loop of the JAX `_traverse`, until every stack is
    empty.

    counts: if a dict, it receives each ray's work ([R] int64) as the
    kernel does it: "pops" (nodes taken off the stack), "box_tests" (two
    an internal node), "tri_tests" (triangles a leaf tests); "live" ([R]
    bool, t_max > 1e-4: a lane that can hit, since ray_tri takes only t >
    1e-4); and as ints, over the live lanes, "nodes_touched" (distinct
    nodes popped), "boxes_touched" (distinct child boxes tested) and
    "tris_touched" (distinct triangles tested). Every lane walks, dead
    ones (t_max = 0) too, as in the JAX loop, and its per-ray counts say
    so; a dead lane's answer is fixed (a miss), so no bound charges its
    walk."""
    R = ro.shape[0]
    N = box.shape[0]
    T = p0.shape[0]
    dev = ro.device
    S = max_stack
    inv = _inv_dir(rd)
    stack = torch.zeros((R, S), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)
    t_best = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(
        R).clone()
    tri_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    u_best = torch.zeros((R,), device=dev)
    v_best = torch.zeros((R,), device=dev)
    left = left.long()
    count = count.long()
    js = torch.arange(max_leaf, device=dev)
    if counts is not None:
        n_pop = torch.zeros((R,), dtype=torch.int64, device=dev)
        n_box = torch.zeros_like(n_pop)
        n_tri = torch.zeros_like(n_pop)
        node_seen = torch.zeros((N,), dtype=torch.bool, device=dev)
        box_seen = torch.zeros((N,), dtype=torch.bool, device=dev)
        tri_seen = torch.zeros((T,), dtype=torch.bool, device=dev)
        live = t_best > 1e-4

    while bool((sp > 0).any()):
        active = sp > 0
        spm1 = torch.clamp(sp - 1, min=0)
        node = torch.where(active, stack.gather(
            1, torch.clamp(spm1, max=S - 1)[:, None])[:, 0], 0)
        sp = torch.where(active, spm1, sp)
        nleft = left[node]
        ncount = count[node]
        is_leaf = ncount > 0

        # leaf: up to max_leaf triangles, tested in order against the
        # closest t so far (the other conditions do not depend on it)
        leaf_active = active & is_leaf
        tid = torch.clamp(nleft[:, None] + js, 0, T - 1)
        valid = leaf_active[:, None] & (js < ncount[:, None])
        h, th, hu, hv = ray_tri_fma(ro[:, None], rd[:, None], p0[tid],
                                    e1[tid], e2[tid], torch.inf)
        for j in range(max_leaf):
            take = valid[:, j] & h[:, j] & (th[:, j] < t_best)
            t_best = torch.where(take, th[:, j], t_best)
            tri_best = torch.where(take, tid[:, j], tri_best)
            u_best = torch.where(take, hu[:, j], u_best)
            v_best = torch.where(take, hv[:, j], v_best)
        if any_hit:
            sp = torch.where(tri_best >= 0, 0, sp)

        # internal: both children's slabs, far pushed first, then near
        int_active = active & ~is_leaf
        c = torch.clamp(nleft[:, None] + torch.arange(2, device=dev), 0,
                        N - 1)
        bx = box[c]
        hit2, d = ray_aabb(ro[:, None], inv[:, None], bx[:, :, 0],
                           bx[:, :, 1], t_best[:, None])
        h0 = hit2[:, 0] & int_active
        h1 = hit2[:, 1] & int_active
        both = h0 & h1
        near0 = d[:, 0] <= d[:, 1]
        near = torch.where(near0, c[:, 0], c[:, 1])
        far = torch.where(near0, c[:, 1], c[:, 0])
        top = torch.where(both, near, torch.where(h0, c[:, 0], c[:, 1]))
        for push, val in ((both, far), (h0 | h1, top)):
            slot = torch.clamp(sp, max=S - 1)[:, None]
            cur = stack.gather(1, slot)[:, 0]
            stack.scatter_(1, slot, torch.where(push, val, cur)[:, None])
            sp = sp + push.long()

        if counts is not None:
            n_pop += active.long()
            n_box += 2 * int_active.long()
            n_tri += valid.long().sum(1)
            node_seen[node[active & live]] = True
            box_seen[c[int_active & live].reshape(-1)] = True
            tri_seen[tid[valid & live[:, None]]] = True
    if counts is not None:
        counts.update(pops=n_pop, box_tests=n_box, tri_tests=n_tri,
                      live=live, nodes_touched=int(node_seen.sum()),
                      boxes_touched=int(box_seen.sum()),
                      tris_touched=int(tri_seen.sum()))
    return Hit(t=t_best, tri=tri_best.to(torch.int32), u=u_best, v=v_best)


def closest_hit_bvh2_plain(box, left, count, p0, e1, e2, ro, rd, t_max,
                           max_leaf: int = 4, max_stack: int = MAX_STACK,
                           counts: dict | None = None) -> Hit:
    """Closest hit of rays ro/rd [R,3] before t_max (scalar or [R]) over
    the BVH2 box [N,2,3], left / count [N] and the triangles p0/e1/e2
    [T,3] in leaf order (plain PyTorch)."""
    return _traverse_plain(box, left, count, p0, e1, e2, ro, rd, t_max,
                           False, max_leaf, max_stack, counts)


def any_hit_bvh2_plain(box, left, count, p0, e1, e2, ro, rd, t_max,
                       max_leaf: int = 4, max_stack: int = MAX_STACK,
                       counts: dict | None = None):
    """Occlusion: bool [R], True = blocked before t_max."""
    return _traverse_plain(box, left, count, p0, e1, e2, ro, rd, t_max,
                           True, max_leaf, max_stack, counts).tri >= 0


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

# words of a pair row and of a triangle row of the packed table
PAIR_WORDS, TRI_WORDS = 16, 12


def pack_bvh2_table(box, left, count, p0, e1, e2) -> torch.Tensor:
    """The kernel's table of a BVH2, int32 words [16 (N + 1) + 12 T]
    (empty for N = 0): N + 1 pair rows, then T triangle rows.

    Pair row r holds the boxes of nodes c0 = min(r, N - 1) and c1 =
    min(r + 1, N - 1) (min then max, 12 float words), then each one's
    stack entry (left, count); row N holds node 0 twice, the pair a
    negative `left` clamps to. A node's entry is (left, count) for a
    leaf (count > 0), its left clamped to [-2^30, T - 1] and its count to
    the int32 range, which leaves every triangle id the traversal takes
    (clamp(left + j, 0, T - 1), j < max_leaf) as it was; and (the pair
    row of its children, 0) for an internal node: clamp(left, 0, N - 1),
    or N where left < 0, so the row's two boxes are the ones the loop
    slab-tests, clamps included. A triangle row is p0, e1, e2 and three
    zero words. Device work only (no host sync): the scene caches it
    (Scene.bvh2_table)."""
    N, T = box.shape[0], p0.shape[0]
    dev = box.device
    if N == 0:
        return torch.zeros((0,), dtype=torch.int32, device=dev)
    left, count = left.long(), count.long()
    leaf = count > 0
    kids = torch.where(left < 0, N, torch.clamp(left, max=N - 1))
    entry = torch.stack([
        torch.where(leaf, torch.clamp(left, -(1 << 30), T - 1), kids),
        torch.where(leaf, torch.clamp(count, max=(1 << 31) - 1), 0)],
        1).to(torch.int32)
    r = torch.arange(N + 1, device=dev)
    c0 = torch.where(r < N, r, 0)
    c1 = torch.where(r < N, torch.clamp(r + 1, max=N - 1), 0)
    bx = box.detach().reshape(N, 6).contiguous().view(torch.int32)
    pairs = torch.cat([bx[c0], bx[c1], entry[c0], entry[c1]], 1)
    tris = torch.cat([p0.detach(), e1.detach(), e2.detach(),
                      torch.zeros((T, 3), dtype=torch.float32,
                                  device=dev)], 1).view(torch.int32)
    return torch.cat([pairs.reshape(-1), tris.reshape(-1)])


def _launch(box, left, count, p0, e1, e2, ro, rd, t_max, any_hit: bool,
            max_leaf: int, max_stack: int, table=None, lib=None) -> Hit:
    """Check the arguments, allocate the outputs and the ray counter,
    launch traverse_bvh2.cu (or `lib`, another build of it) over `table`
    (packed here when None; the any hit writes tri alone)."""
    dev = ro.device
    R = ro.shape[0]
    N, T = box.shape[0], p0.shape[0]
    for name, x, dt, shape in (
            ("box", box, torch.float32, (N, 2, 3)),
            ("left", left, torch.int64, (N,)),
            ("count", count, torch.int64, (N,)),
            ("p0", p0, torch.float32, (T, 3)),
            ("e1", e1, torch.float32, (T, 3)),
            ("e2", e2, torch.float32, (T, 3)),
            ("ro", ro, torch.float32, (R, 3)),
            ("rd", rd, torch.float32, (R, 3))):
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} tensor of "
                             f"shape {shape} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if N < 1 or T < 1:
        raise ValueError(f"empty BVH2 ({N} nodes, {T} triangles): the "
                         f"scene has no triangles to traverse")
    if not 1 <= max_stack <= MAX_STACK:
        raise ValueError(f"max_stack {max_stack} outside 1..{MAX_STACK}")
    if max_leaf < 1:
        raise ValueError(f"max_leaf {max_leaf} < 1")
    if table is None:
        table = pack_bvh2_table(box, left, count, p0, e1, e2)
    words = PAIR_WORDS * (N + 1) + TRI_WORDS * T
    if (table.device != dev or table.dtype != torch.int32
            or tuple(table.shape) != (words,) or not table.is_contiguous()
            or table.data_ptr() % 16):
        raise ValueError(f"table: need pack_bvh2_table's contiguous, "
                         f"16-byte aligned int32 [{words}] on {dev}, got "
                         f"{table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    if isinstance(t_max, torch.Tensor):
        tm = t_max.to(device=dev, dtype=torch.float32).expand(R).contiguous()
    else:
        tm = torch.full((R,), float(t_max), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    if any_hit:
        t = u = v = None
    else:
        t, u, v = (torch.empty((R,), dtype=torch.float32, device=dev)
                   for _ in range(3))
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    ptr = (lambda x: 0 if x is None else x.data_ptr())
    lib = _cuda.lib("traverse_bvh2.cu") if lib is None else lib
    err = lib.tt_bvh2(
        table.data_ptr(), N, T, ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
        R, max_leaf, max_stack, int(any_hit), next_ray.data_ptr(), ptr(t),
        tri.data_ptr(), ptr(u), ptr(v), _cuda.stream_ptr(ro))
    _cuda.check(err, "tt_bvh2")
    return Hit(t=t, tri=tri, u=u, v=v)


# where the integrator detaches what the traversal must not see with grad
_DETACH_SITE = ("integrate/pathtrace.py detaches the hit record after "
                "_trace (the detached-sampling estimator does not "
                "differentiate the traversal)")


def closest_hit_bvh2(box, left, count, p0, e1, e2, ro, rd, t_max,
                     max_leaf: int = 4, max_stack: int = MAX_STACK,
                     table=None) -> Hit:
    """Closest hit of rays ro/rd [R,3] before t_max (scalar or [R]) over
    the BVH2 box [N,2,3], left / count [N] (int64) and the triangles
    p0/e1/e2 [T,3] in leaf order, leaves of at most `max_leaf` triangles.
    CUDA tensors launch csrc/traverse_bvh2.cu over `table` (these
    tables' pack_bvh2_table, as Scene.bvh2_table caches it; packed for
    the call when None); CPU tensors take closest_hit_bvh2_plain, which
    needs no table. A tensor that requires grad raises ValueError (the
    traversal is not differentiated)."""
    _cuda.refuse_grad("closest_hit_bvh2", _DETACH_SITE, box, p0, e1, e2,
                      ro, rd, t_max)
    if ro.device.type == "cpu":
        return closest_hit_bvh2_plain(box, left, count, p0, e1, e2, ro, rd,
                                      t_max, max_leaf, max_stack)
    hit = _launch(box, left, count, p0, e1, e2, ro, rd, t_max, False,
                  max_leaf, max_stack, table)
    closest_hit_bvh2.launches += 1
    return hit


def any_hit_bvh2(box, left, count, p0, e1, e2, ro, rd, t_max,
                 max_leaf: int = 4, max_stack: int = MAX_STACK, table=None):
    """Occlusion bool [R] (True = blocked before t_max); dispatch as
    closest_hit_bvh2."""
    _cuda.refuse_grad("any_hit_bvh2", _DETACH_SITE, box, p0, e1, e2, ro, rd,
                      t_max)
    if ro.device.type == "cpu":
        return any_hit_bvh2_plain(box, left, count, p0, e1, e2, ro, rd,
                                  t_max, max_leaf, max_stack)
    hit = _launch(box, left, count, p0, e1, e2, ro, rd, t_max, True,
                  max_leaf, max_stack, table)
    any_hit_bvh2.launches += 1
    return hit.tri >= 0


closest_hit_bvh2.launches = 0
any_hit_bvh2.launches = 0


# ---------------------------------------------------------------------------
# brute-force oracles
# ---------------------------------------------------------------------------

def brute_force_closest(p0, e1, e2, ro, rd, t_max) -> Hit:
    """O(R*T) ground truth: every ray against every triangle."""
    h, t, u, v = ray_tri(ro[:, None, :], rd[:, None, :], p0[None], e1[None],
                         e2[None], t_max)
    t = torch.where(h, t, torch.inf)
    i = torch.argmin(t, dim=1)
    rows = torch.arange(ro.shape[0], device=ro.device)
    ti = t[rows, i]
    hit_any = torch.isfinite(ti)
    return Hit(t=torch.where(hit_any, ti, torch.as_tensor(
                   t_max, dtype=torch.float32, device=ro.device)),
               tri=torch.where(hit_any, i, -1).to(torch.int32),
               u=u[rows, i], v=v[rows, i])


# elements of the [rays, triangles] products transmit_brute makes at once
BRUTE_CHUNK = 1 << 26


def _tree_sum(x):
    """Sum over dim 1 as a fixed pairwise tree of elementwise adds (the
    first half plus the second; an odd column left over goes up as it
    is), so each row's bits depend on its own values alone: not on the
    rows beside it, nor on how a device's reduction splits its work."""
    while x.shape[1] > 1:
        n = x.shape[1]
        h = n // 2
        s = x[:, :h] + x[:, n - h:]
        x = s if n == 2 * h else torch.cat([s, x[:, h:h + 1]], 1)
    return x.sum(1)


def transmit_brute(p0, e1, e2, tint, ro, rd, t_max):
    """O(R*T) shadow-transmittance oracle [R,3]: the product of the shadow
    tints [T,3] of every triangle crossed before t_max (scalar or [R]),
    taken as exp of a sum of logs, 0 where the largest channel falls
    below 1e-3. The rays go in chunks of at most BRUTE_CHUNK // T, so a
    large scene never holds [R, T] at once; each ray's sum over the
    triangles is `_tree_sum`'s, so a ray's result is the same bits in
    any chunk."""
    R, T = ro.shape[0], p0.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32,
                         device=ro.device).expand(R)
    step = max(1, BRUTE_CHUNK // max(T, 1))
    parts = []
    for a in range(0, max(R, 1), step):
        o, d, m = ro[a:a + step], rd[a:a + step], tm[a:a + step]
        h, t, _, _ = ray_tri(o[:, None, :], d[:, None, :], p0[None],
                             e1[None], e2[None], m[:, None])
        crossed = h & (t < m[:, None])
        f = torch.where(crossed[..., None], tint[None], 1.0)
        parts.append(torch.exp(_tree_sum(torch.log(torch.clamp(f,
                                                               min=1e-30)))))
    tp = torch.cat(parts) if len(parts) != 1 else parts[0]
    return torch.where(tp.amax(-1, keepdim=True) < 1e-3, 0.0, tp)
