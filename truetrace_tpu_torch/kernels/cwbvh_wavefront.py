"""CWBVH traversal over the unified node + leaf-row table.

Port of `truetrace_tpu/kernels/cwbvh_wavefront.py` (single-BLAS closest
hit, any hit and shadow transmittance). The table layout is the JAX package's: `pack_leaf_rows`
(host) builds [L, 10K] leaf rows and rewrites node word 5, `expand_nodes`
turns the 20-word quantized nodes into 26-word rows of absolute
conservative-bf16 bounds, and `pack_table` stacks both into one
[C+L, 10K] table (int32 bits here, uint32 there).

Two implementations of one traversal, with three query types:

* `closest_hit_wavefront` / `any_hit_wavefront` / `transmit_wavefront`
  launch the CUDA kernel `csrc/traverse.cu` (persistent warps pulling
  rays from a counter, one ray per lane at a time, whole-row vector
  loads, an 8-byte stack entry in shared memory) on CUDA tensors; on CPU
  tensors they run the plain version. Each counts its launches in its
  `launches` attribute.
* `closest_hit_plain` / `any_hit_plain` / `transmit_plain`: plain
  PyTorch, a Python loop of lock-step iterations over all lanes with
  active masks, mirroring `cwbvh_wavefront._step` (and `_step_transmit`)
  op for op (the JAX shift-register stack included). It is the CPU path
  and the kernel's reference on the card, and can count each ray's work.

Both round every operation as the JAX package does on the CPU (see
core/math.py `fma`), so t, and the transmittance's products, are
bitwise equal across the three.
"""
from __future__ import annotations

import numpy as np
import torch

from truetrace_tpu_torch.core.math import fma
from truetrace_tpu_torch.kernels import _cuda
from truetrace_tpu_torch.kernels.traverse_ref import Hit

M32 = 0xFFFFFFFF
PTR_MASK = 0x00FFFFFF   # low 24 bits of chim/bleaf hold the base index
LEAF_MASK = 0xFF        # hits bits 0..7 = pending leaf slots
ITER_CAP = 65536        # as the JAX package's _ITER_CAP
MAX_STACK_CUDA = 32     # ring entries per lane in traverse.cu
CUDA_LEAF_K = (3, 4, 5, 6, 8, 12)   # leaf widths traverse.cu is built for
# query types, traverse.cu's template argument Q
CLOSEST, ANY, TRANSMIT = 0, 1, 2
OPAQUE = 1e-3           # transmittance below which a shadow ray retires


def pack_leaf_rows(nodes: np.ndarray, slot_tri_base: np.ndarray,
                   slot_tri_count: np.ndarray, p0: np.ndarray,
                   e1: np.ndarray, e2: np.ndarray, k: int = 3):
    """Host post-pass: per-leaf rows and node word 5 -> base_leaf_row.

    Returns (nodes_patched [C,20] u32, leaf_rows [L,10k] f32 — tri-id
    columns 9k..10k-1 are int32 bits; missing tris are degenerate (e=0,
    never hit) with id -1)."""
    C = nodes.shape[0]
    T = p0.shape[0]
    mask = slot_tri_count > 0                        # [C,8]
    per_node = mask.sum(axis=1)
    base_leaf = np.concatenate([[0], np.cumsum(per_node)[:-1]])
    L = int(per_node.sum())
    if L >= (1 << 24) or C >= (1 << 24):
        raise ValueError("chim/bleaf pack base indices into 24 bits")
    nodes2 = nodes.copy()
    nodes2[:, 5] = base_leaf.astype(np.uint32)
    sb = slot_tri_base[mask].astype(np.int64)        # [L] node-major order
    scnt = slot_tri_count[mask]
    if scnt.size and int(scnt.max()) > k:
        raise ValueError("leaf slot exceeds k tris: build the BVH2 with "
                         "max_leaf <= k")
    rows = np.zeros((L, 10 * k), np.float32)
    for j in range(k):
        valid = (j < scnt)[:, None]
        tid = np.clip(sb + j, 0, T - 1)
        rows[:, 9 * j + 0: 9 * j + 3] = np.where(valid, p0[tid], 0.0)
        rows[:, 9 * j + 3: 9 * j + 6] = np.where(valid, e1[tid], 0.0)
        rows[:, 9 * j + 6: 9 * j + 9] = np.where(valid, e2[tid], 0.0)
        rows.view(np.int32)[:, 9 * k + j] = np.where(
            valid[:, 0], sb + j, -1).astype(np.int32)
    return nodes2, rows


def pack_leaf_rows_torch(slot_tri_base: torch.Tensor,
                         slot_tri_count: torch.Tensor, p0: torch.Tensor,
                         e1: torch.Tensor, e2: torch.Tensor, k: int = 3):
    """The leaf rows of `pack_leaf_rows` rebuilt on the device for
    deformed triangles (skinning, refit): slot_tri_base / slot_tri_count
    are the [L] slots that hold triangles (the builder's [C,8] metadata
    at count > 0, in node-major order), p0 / e1 / e2 [T,3] in CWBVH
    order. The id columns are int32 bits, written through an int32
    view."""
    T = p0.shape[0]
    cols, ids = [], []
    for j in range(k):
        valid = (j < slot_tri_count)[:, None]
        tid = torch.clamp(slot_tri_base + j, 0, T - 1)
        cols += [torch.where(valid, p0[tid], 0.0),
                 torch.where(valid, e1[tid], 0.0),
                 torch.where(valid, e2[tid], 0.0)]
        ids.append(torch.where(valid[:, 0], slot_tri_base + j, -1))
    idf = torch.stack(ids, 1).to(torch.int32).view(torch.float32)
    return torch.cat(cols + [idf], 1)


def reorder_leaf_rows_hot(nodes2: "np.ndarray", rows: "np.ndarray"):
    """Permute leaf-row GROUPS (one contiguous group per node) so
    high-heat groups pack at the FRONT of the unified gather table.

    Motivation (round-5 locality probe, BASELINE.md): the TPU gather
    cache operates on address granules, so a hot subset of rows
    SCATTERED across an HBM-sized table drags cold granule neighbours
    into cache and thrashes, while the same subset packed contiguously
    stays resident. Heat proxy = leaf AABB half-area (probability a
    random ray's slab test touches the row — the same SAH measure the
    builder minimizes; reference CWBVH exists for cache-friendly
    traversal, CommonData.cginc:641-707).

    Bitwise-neutral: rows carry their own triangle data + global ids,
    so only node word 5 (base_leaf_row) is rewritten. NOT compatible
    with the deformable refit path (pack_leaf_rows_jax regenerates rows
    in node-major order) — compile_scene(hot_order=True) is for static
    HBM-scale scenes.
    """
    import numpy as np
    C = nodes2.shape[0]
    L = rows.shape[0]
    base = nodes2[:, 5].astype(np.int64)
    per_node = np.diff(np.append(base, L))
    k = rows.shape[1] // 10
    # per-row AABB over the valid triangles' vertices
    ids = rows.view(np.int32)[:, 9 * k:]
    lo = np.full((L, 3), np.inf, np.float32)
    hi = np.full((L, 3), -np.inf, np.float32)
    for j in range(k):
        valid = (ids[:, j] >= 0)[:, None]
        p0 = rows[:, 9 * j: 9 * j + 3]
        v1 = p0 + rows[:, 9 * j + 3: 9 * j + 6]
        v2 = p0 + rows[:, 9 * j + 6: 9 * j + 9]
        for v in (p0, v1, v2):
            lo = np.where(valid, np.minimum(lo, v), lo)
            hi = np.where(valid, np.maximum(hi, v), hi)
    d = np.maximum(hi - lo, 0.0)
    row_heat = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 0] * d[:, 2]
    row_heat = np.where(np.isfinite(row_heat), row_heat, 0.0)
    node_heat = np.zeros(C)
    np.add.at(node_heat, np.repeat(np.arange(C), per_node), row_heat)
    order = np.argsort(-node_heat, kind="stable")
    new_base = np.concatenate([[0], np.cumsum(per_node[order])[:-1]])
    perm = np.concatenate([np.arange(base[n], base[n] + per_node[n])
                           for n in order]).astype(np.int64) \
        if L else np.zeros((0,), np.int64)
    out_nodes = nodes2.copy()
    out_nodes[order, 5] = new_base.astype(np.uint32)
    return out_nodes, rows[perm]


# ---------------------------------------------------------------------------
# uint32 helpers: bit patterns in int64, masked (see core/rng.py)
# ---------------------------------------------------------------------------

def _u(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> uint32 value in int64."""
    return x.to(torch.int64) & M32


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    """uint32 value in int64 -> int32 with the same bits."""
    return torch.where(u >= (1 << 31), u - (1 << 32), u).to(torch.int32)


def _bits_to_f32(u: torch.Tensor) -> torch.Tensor:
    return _as_i32(u).view(torch.float32)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return _u(x.contiguous().view(torch.int32))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of uint32 values held in int64 (SWAR)."""
    x = x & M32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _bf16_down(x):
    """f32 -> bf16 bits rounded toward -inf (conservative lower bound)."""
    b = _f32_bits(x)
    trunc = b & 0xFFFF0000
    rem = (b & 0xFFFF) != 0
    neg = (b >> 31) == 1
    return torch.where(neg & rem, (trunc + 0x10000) & M32, trunc)


def _bf16_up(x):
    """f32 -> bf16 bits rounded toward +inf (conservative upper bound)."""
    b = _f32_bits(x)
    trunc = b & 0xFFFF0000
    rem = (b & 0xFFFF) != 0
    neg = (b >> 31) == 1
    return torch.where(~neg & rem, (trunc + 0x10000) & M32, trunc)


def expand_nodes(nodes: torch.Tensor) -> torch.Tensor:
    """Canonical 20-word quantized nodes (int32 bits) -> [C,26] traversal
    rows (int32 bits) with ABSOLUTE child bounds in conservative bf16, two
    per word:

      cols 0..23 : per axis 8 words: lo[8 slots] as 4 words, then hi[8]
                   as 4 words; slot j in word j>>1, half j&1
      col 24     : chim  = base_child | imask << 24
      col 25     : bleaf = base_leaf  | leafmask << 24

    Bounds round outward, so traversal results are identical to the
    quantized boxes'; empty slots get inverted boxes that never pass."""
    n = _u(nodes)
    C = n.shape[0]
    w3 = n[:, 3]
    imask = w3 >> 24
    m0, m1 = n[:, 6], n[:, 7]
    out = [torch.zeros((C,), dtype=torch.int64, device=nodes.device)
           for _ in range(24)]
    leafmask = torch.zeros_like(w3)
    for j in range(8):
        sh = 8 * (j % 4)
        m = ((m0 if j < 4 else m1) >> sh) & 0xFF
        is_int = ((imask >> j) & 1) == 1
        leafmask = leafmask | torch.where((m != 0) & ~is_int, 1 << j, 0)
        for axis in range(3):
            p = nodes[:, axis].contiguous().view(torch.float32)
            scale = _bits_to_f32(((w3 >> (8 * axis)) & 0xFF) << 23)
            lo_w = n[:, (8 if j < 4 else 9) + 2 * axis]
            hi_w = n[:, (14 if j < 4 else 15) + 2 * axis]
            qlo = ((lo_w >> sh) & 0xFF).to(torch.float32)
            qhi = ((hi_w >> sh) & 0xFF).to(torch.float32)
            # q * scale is exact (8-bit integer times a power of two), so
            # XLA's contracted form of p + q*scale rounds the same way
            lo16 = _bf16_down(p + qlo * scale) >> 16
            hi16 = _bf16_up(p + qhi * scale) >> 16
            wi = 8 * axis + (j >> 1)
            half = 16 * (j & 1)
            out[wi] = out[wi] | (lo16 << half)
            out[wi + 4] = out[wi + 4] | (hi16 << half)
    chim = (n[:, 4] & PTR_MASK) | (imask << 24)
    bleaf = (n[:, 5] & PTR_MASK) | (leafmask << 24)
    return _as_i32(torch.stack(out + [chim, bleaf], 1))


def pack_table(nodes: torch.Tensor, leaf_rows: torch.Tensor,
               inst_rows: torch.Tensor | None = None) -> torch.Tensor:
    """One [C+L, 10K] int32 table: expanded node rows zero-padded to the
    leaf-row width, then the leaf rows' bits; an instanced scene's
    instance rows [I, 10K] (kernels/cwbvh_tlas.py) follow as a third
    section."""
    exp = expand_nodes(nodes)
    W = leaf_rows.shape[1]
    if W % 10 or W < 30:
        raise ValueError(f"bad leaf-row width {W} (10K words, K >= 3)")
    exp = torch.nn.functional.pad(exp, (0, W - exp.shape[1]))
    parts = [exp, leaf_rows.contiguous().view(torch.int32)]
    if inst_rows is not None:
        parts.append(inst_rows.contiguous().view(torch.int32))
    return torch.cat(parts, 0)


# ---------------------------------------------------------------------------
# plain PyTorch traversal (CPU path and the kernel's reference)
# ---------------------------------------------------------------------------

def _inv_dir(rd):
    return 1.0 / torch.where(rd.abs() < 1e-12,
                             torch.where(rd >= 0, 1e-12, -1e-12), rd)


def _tri_test(fcol, icol, K, j, ro, rd, leaf_lane, t):
    """The Moller test of slot j of gathered leaf rows given column
    accessors (fcol(k) -> [R] f32, icol(k) -> [R] int64): (ok, th, u, v,
    tri_id), ok where the triangle is hit in (1e-4, t). The mul-adds XLA
    contracts are fma()s (see csrc/cwbvh_core.cuh for the pattern)."""
    rdx, rdy, rdz = rd[:, 0], rd[:, 1], rd[:, 2]
    rox, roy, roz = ro[:, 0], ro[:, 1], ro[:, 2]
    b = 9 * j
    p0x, p0y, p0z = fcol(b), fcol(b + 1), fcol(b + 2)
    e1x, e1y, e1z = fcol(b + 3), fcol(b + 4), fcol(b + 5)
    e2x, e2y, e2z = fcol(b + 6), fcol(b + 7), fcol(b + 8)
    tri_id = icol(9 * K + j)
    pvx = fma(rdy, e2z, -(rdz * e2y))
    pvy = fma(rdz, e2x, -(rdx * e2z))
    pvz = fma(rdx, e2y, -(rdy * e2x))
    det = fma(e1z, pvz, fma(e1x, pvx, e1y * pvy))
    inv_det = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    tvx, tvy, tvz = rox - p0x, roy - p0y, roz - p0z
    u = fma(tvz, pvz, fma(tvx, pvx, tvy * pvy)) * inv_det
    qvx = fma(tvy, e1z, -(tvz * e1y))
    qvy = fma(tvz, e1x, -(tvx * e1z))
    qvz = fma(tvx, e1y, -(tvy * e1x))
    v = fma(rdz, qvz, fma(rdx, qvx, rdy * qvy)) * inv_det
    th = fma(e2z, qvz, fma(e2x, qvx, e2y * qvy)) * inv_det
    ok = (leaf_lane & (tri_id >= 0) & (u >= 0) & (v >= 0)
          & (u + v <= 1) & (th > 1e-4) & (th < t)
          & (det.abs() > 1e-12))
    return ok, th, u, v, tri_id


def _moller(fcol, icol, K, ro, rd, leaf_lane, write_uv, t, tri, u_b, v_b):
    """<= K Moller tests of gathered leaf rows, keeping the closest hit."""
    for j in range(K):
        ok, th, u, v, tri_id = _tri_test(fcol, icol, K, j, ro, rd,
                                         leaf_lane, t)
        t = torch.where(ok, th, t)
        tri = torch.where(ok, tri_id, tri)
        if write_uv:
            u_b = torch.where(ok, u, u_b)
            v_b = torch.where(ok, v, v_b)
    return t, tri, u_b, v_b


def _decode(ucol, ro, inv, t):
    """8-slot slab test of gathered expanded node rows given a column
    accessor ucol(k) -> [R] uint32 in int64. Returns (hits, chim, bleaf)."""
    chim = ucol(24)
    bleaf = ucol(25)
    imask = chim >> 24
    occ = imask | (bleaf >> 24)
    zero = t.new_zeros(())
    hits = torch.zeros_like(chim)
    for j in range(8):
        wi = j >> 1
        lo_sh = 16 * (j & 1)
        tn = torch.full_like(t, -torch.inf)
        tf = torch.full_like(t, torch.inf)
        for a in range(3):
            lo = _bits_to_f32(((ucol(8 * a + wi) >> lo_sh) & 0xFFFF) << 16)
            hi = _bits_to_f32(((ucol(8 * a + 4 + wi) >> lo_sh) & 0xFFFF)
                              << 16)
            t0 = (lo - ro[:, a]) * inv[:, a]
            t1 = (hi - ro[:, a]) * inv[:, a]
            tn = torch.maximum(tn, torch.minimum(t0, t1))
            tf = torch.minimum(tf, torch.maximum(t0, t1))
        hitj = ((tf >= torch.maximum(tn, zero)) & (tn < t)
                & (((occ >> j) & 1) == 1))
        bit = torch.where(((imask >> j) & 1) == 1, 1 << (24 + j), 1 << j)
        hits = hits | torch.where(hitj, bit, 0)
    return hits, chim, bleaf


def _row_cols(row):
    """Column accessors of a gathered [R,W] int32 row block."""
    rt = row.t().contiguous()
    return (lambda k: _u(rt[k]), lambda k: rt[k].view(torch.float32),
            lambda k: rt[k].to(torch.int64))


def _xor_permute8(m, v):
    b = (v & 1) > 0
    m = torch.where(b, ((m & 0xAA) >> 1) | ((m & 0x55) << 1), m)
    b = (v & 2) > 0
    m = torch.where(b, ((m & 0xCC) >> 2) | ((m & 0x33) << 2), m)
    b = (v & 4) > 0
    m = torch.where(b, ((m & 0xF0) >> 4) | ((m & 0x0F) << 4), m)
    return m


def _extract_slot(mask, oct_key):
    """Next slot near-to-far: the set bit i of mask minimizing i ^ oct."""
    pm = _xor_permute8(mask, oct_key)
    lsb = pm & ((~pm + 1) & M32)
    idx = popcount32((lsb - 1) & M32)
    slot = (idx ^ oct_key) & 7
    return slot, mask & (~(1 << slot) & M32)


def _traverse_plain(table, n_nodes, ro, rd, t_max, query: int,
                    max_stack: int, counts: dict | None = None, tint=None):
    """Lock-step traversal of every lane until all are done (the JAX
    package's single-stage `_traverse`, and `transmit_wavefront`'s loop
    of `_step_transmit`). Returns a Hit (CLOSEST, ANY), or the
    transmittance [R,3] (TRANSMIT: every triangle accepted before t_max,
    which is never shortened, multiplies the lane's RGB throughput by
    tint[tri] in slot order; a lane retires once its largest channel
    falls below OPAQUE, and reads 0 then).

    counts: if a dict, it receives each ray's work as the kernel does it
    ([R] int64): "node_decodes" (the root's and one per descent),
    "leaf_rows", "tri_tests" (non-padding triangles of those rows),
    "accepted" (TRANSMIT: tinted triangles), and as ints "rows_touched",
    the number of distinct table rows read, "live_rays", the rays it
    walks, and "tint_rows" (TRANSMIT), the number of distinct tint rows
    its accepted triangles read. A ray with t_max <= 1e-4 can accept no
    triangle, so the kernel does not walk it (it reads only its t_max
    and writes its result) and it counts nothing."""
    R = ro.shape[0]
    C = n_nodes
    L = table.shape[0] - C
    K = table.shape[1] // 10
    dev = ro.device
    inv = _inv_dir(rd)
    oct_key = ((rd[:, 0] < 0).long() | ((rd[:, 1] < 0).long() << 1)
               | ((rd[:, 2] < 0).long() << 2))
    t = torch.as_tensor(t_max, dtype=torch.float32, device=dev).expand(
        R).clone()
    tri = torch.full((R,), -1, dtype=torch.int64, device=dev)
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
        live = t > 1e-4
        n_node = live.long()
        n_leaf = torch.zeros_like(n_node)
        n_tri = torch.zeros_like(n_node)
        n_acc = torch.zeros_like(n_node)
        touched = torch.zeros((table.shape[0],), dtype=torch.bool,
                              device=dev)
        touched[0] = bool(live.any())
        if query == TRANSMIT:
            tint_touched = torch.zeros((T,), dtype=torch.bool, device=dev)

    for _ in range(ITER_CAP):
        if not bool(((hits != 0) | (sp > 0)).any()):
            break
        # 1. pop a saved group where the current one is exhausted
        pop = (hits == 0) & (sp > 0)
        hits = torch.where(pop, ph[0], hits)
        chim = torch.where(pop, pc[0], chim)
        bleaf = torch.where(pop, pb[0], bleaf)
        sp = sp - pop.long()
        # 2. pending leaves first, else descend
        leaf_bits = hits & LEAF_MASK
        node_bits = hits >> 24
        active = hits != 0
        leaf_lane = active & (leaf_bits != 0)
        descend = active & ~leaf_lane
        lsb = leaf_bits & ((~leaf_bits + 1) & M32)
        lrank = popcount32((bleaf >> 24) & ((lsb - 1) & M32))
        lrow = torch.clamp((bleaf & PTR_MASK) + lrank, 0, L - 1)
        if query != CLOSEST:
            lsb_n = node_bits & ((~node_bits + 1) & M32)
            slot = popcount32((lsb_n - 1) & M32)
            node_rest = node_bits & (~lsb_n & M32)
        else:
            slot, node_rest = _extract_slot(node_bits, oct_key)
        imask = chim >> 24
        below = imask & ((((1 << torch.clamp(slot, max=31)) - 1) & M32))
        child = torch.clamp((chim & PTR_MASK) + popcount32(below), 0, C - 1)
        # 3. one row per lane: leaf row or child node row
        row_idx = torch.where(leaf_lane, C + lrow,
                              torch.where(descend, child, 0))
        ucol, fcol, icol = _row_cols(table[row_idx])
        if counts is not None:     # the kernel walks live rays only
            n_node += (live & descend).long()
            n_leaf += (live & leaf_lane).long()
            for j in range(K):
                n_tri += (live & leaf_lane & (icol(9 * K + j) >= 0)).long()
            touched[row_idx[live & active]] = True
        if query == TRANSMIT:
            for j in range(K):
                ok, _, _, _, tri_id = _tri_test(fcol, icol, K, j, ro, rd,
                                                leaf_lane, t)
                trow = tint[torch.clamp(tri_id, 0, T - 1)]
                for c in range(3):
                    tp[c] = torch.where(ok, tp[c] * trow[:, c], tp[c])
                if counts is not None:
                    n_acc += (live & ok).long()
                    tint_touched[torch.clamp(tri_id, 0, T - 1)[
                        live & ok]] = True
        else:
            t, tri, u_b, v_b = _moller(fcol, icol, K, ro, rd, leaf_lane,
                                       query == CLOSEST, t, tri, u_b, v_b)
        c_hits, c_chim, c_bleaf = _decode(ucol, ro, inv, t)
        # 4. stack: pop applies first, then push on the popped state
        rest = node_rest << 24
        push = descend & (rest != 0)
        for plane, saved in ((ph, rest), (pc, chim), (pb, bleaf)):
            based = torch.where(pop[None, :], torch.cat(
                [plane[1:], torch.zeros_like(plane[:1])]), plane)
            pushed = torch.cat([saved[None, :], based[:-1]])
            plane.copy_(torch.where(push[None, :], pushed, based))
        sp = sp + push.long()
        hits = torch.where(descend, c_hits,
                           torch.where(leaf_lane, hits & (~lsb & M32), hits))
        chim = torch.where(descend, c_chim, chim)
        bleaf = torch.where(descend, c_bleaf, bleaf)
        if query == ANY:
            done = tri >= 0
        elif query == TRANSMIT:
            done = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2]) < OPAQUE
        if query != CLOSEST:
            hits = torch.where(done, 0, hits)
            sp = torch.where(done, 0, sp)
    if counts is not None:
        counts.update(node_decodes=n_node, leaf_rows=n_leaf, tri_tests=n_tri,
                      rows_touched=int(touched.sum()),
                      live_rays=int(live.sum()))
        if query == TRANSMIT:
            counts.update(accepted=n_acc, tint_rows=int(tint_touched.sum()))
    if query == TRANSMIT:
        tp = torch.stack(tp, -1)
        return torch.where(tp.amax(-1, keepdim=True) < OPAQUE, 0.0, tp)
    return Hit(t=t, tri=tri.to(torch.int32), u=u_b, v=v_b)


def closest_hit_plain(table, n_nodes, ro, rd, t_max, max_stack: int,
                      counts: dict | None = None) -> Hit:
    return _traverse_plain(table, n_nodes, ro, rd, t_max, CLOSEST, max_stack,
                           counts)


def any_hit_plain(table, n_nodes, ro, rd, t_max, max_stack: int,
                  counts: dict | None = None):
    """Occlusion: bool [R], True = blocked before t_max."""
    return _traverse_plain(table, n_nodes, ro, rd, t_max, ANY, max_stack,
                           counts).tri >= 0


def transmit_plain(table, n_nodes, tint, ro, rd, t_max, max_stack: int,
                   counts: dict | None = None):
    """Shadow transmittance [R,3] of each segment: the product of the
    shadow tints tint [T,3] (scene/mesh.py shadow_tint_table) of every
    triangle crossed before t_max; 0 where it falls below OPAQUE."""
    return _traverse_plain(table, n_nodes, ro, rd, t_max, TRANSMIT,
                           max_stack, counts, tint)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _launch_args(table, ro, rd, t_max, max_stack: int, tint=None,
                 src: str = "traverse.cu"):
    """Check the arguments a traversal kernel of `src` takes (the table's
    dtype, width and alignment, the rays, the stack depth, the tint table
    where given) and return t_max as a contiguous [R] float32 tensor."""
    dev = ro.device
    R = ro.shape[0]
    for name, x, dt in (("table", table, torch.int32),
                        ("ro", ro, torch.float32), ("rd", rd, torch.float32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    if ro.shape != (R, 3) or rd.shape != (R, 3):
        raise ValueError(f"ro/rd must be [R,3], got {tuple(ro.shape)}, "
                         f"{tuple(rd.shape)}")
    N, W = table.shape
    if W % 10 or W < 30 or N >= (1 << 31) // W:
        raise ValueError(f"bad table {tuple(table.shape)}")
    K = W // 10
    if K not in CUDA_LEAF_K:
        raise ValueError(f"{src} is built for leaf rows of K in "
                         f"{CUDA_LEAF_K}, not K = {K}")
    # rows are read 16 bytes at a time when 10K words is a multiple of 4
    # (K even), else 8 bytes at a time
    align = 16 if W % 4 == 0 else 8
    if table.data_ptr() % align:
        raise ValueError(f"table: rows of K = {K} are read {align} bytes "
                         f"at a time, so its data must be {align}-byte "
                         f"aligned")
    if not 1 <= max_stack <= MAX_STACK_CUDA:
        raise ValueError(f"max_stack {max_stack} outside 1..{MAX_STACK_CUDA}")
    if tint is not None:
        T = tint.shape[0]
        if (tint.device != dev or tint.dtype != torch.float32
                or tint.shape != (T, 3) or T < 1
                or not tint.is_contiguous()):
            raise ValueError(f"tint: need a contiguous float32 [T,3] tensor "
                             f"on {dev}, got {tuple(tint.shape)} "
                             f"{tint.dtype} on {tint.device}")
    if isinstance(t_max, torch.Tensor):
        return t_max.to(device=dev, dtype=torch.float32).expand(
            R).contiguous()
    return torch.full((R,), float(t_max), dtype=torch.float32, device=dev)


def _launch(table, n_nodes, ro, rd, t_max, query: int, max_stack: int,
            tint=None):
    """Check the arguments, allocate the outputs and the ray counter the
    warps pull from, launch traverse.cu: a Hit (CLOSEST, ANY) or the
    transmittance [R,3] (TRANSMIT, against tint [T,3])."""
    dev = ro.device
    R = ro.shape[0]
    tm = _launch_args(table, ro, rd, t_max, max_stack,
                      tint if query == TRANSMIT else None)
    N, W = table.shape
    if not 0 < n_nodes < N:
        raise ValueError(f"bad table {tuple(table.shape)} for "
                         f"{n_nodes} nodes")
    next_ray = torch.zeros((1,), dtype=torch.int32, device=dev)
    if query == TRANSMIT:
        T = tint.shape[0]
        tp = torch.empty((R, 3), dtype=torch.float32, device=dev)
        err = _cuda.lib("traverse.cu").tt_transmit(
            table.data_ptr(), W, n_nodes, N - n_nodes, max_stack,
            tint.data_ptr(), T, ro.data_ptr(), rd.data_ptr(), tm.data_ptr(),
            R, next_ray.data_ptr(), tp.data_ptr(), _cuda.stream_ptr(ro))
        _cuda.check(err, "tt_transmit")
        return tp
    t = torch.empty((R,), dtype=torch.float32, device=dev)
    tri = torch.empty((R,), dtype=torch.int32, device=dev)
    u = torch.empty((R,), dtype=torch.float32, device=dev)
    v = torch.empty((R,), dtype=torch.float32, device=dev)
    err = _cuda.lib("traverse.cu").tt_traverse(
        table.data_ptr(), W, n_nodes, N - n_nodes, max_stack,
        ro.data_ptr(), rd.data_ptr(), tm.data_ptr(), R, int(query == ANY),
        next_ray.data_ptr(), t.data_ptr(), tri.data_ptr(), u.data_ptr(),
        v.data_ptr(), _cuda.stream_ptr(ro))
    _cuda.check(err, "tt_traverse")
    return Hit(t=t, tri=tri, u=u, v=v)


# where the integrator detaches what the traversal must not see with grad
_DETACH_SITE = ("integrate/pathtrace.py detaches the hit record after _trace "
                "and the transmittance after _transmission (the "
                "detached-sampling estimator does not differentiate the "
                "traversal)")


def closest_hit_wavefront(table, n_nodes, ro, rd, t_max,
                          max_stack: int) -> Hit:
    """Closest hit of rays ro/rd [R,3] before t_max (scalar or [R]) in the
    unified table (`pack_table`, `n_nodes` node rows first). CUDA tensors
    launch csrc/traverse.cu; CPU tensors take closest_hit_plain. A tensor
    that requires grad raises ValueError (the traversal is not
    differentiated)."""
    _cuda.refuse_grad("closest_hit_wavefront", _DETACH_SITE, table, ro, rd,
                      t_max)
    if ro.device.type == "cpu":
        return closest_hit_plain(table, n_nodes, ro, rd, t_max, max_stack)
    hit = _launch(table, n_nodes, ro, rd, t_max, CLOSEST, max_stack)
    closest_hit_wavefront.launches += 1
    return hit


def any_hit_wavefront(table, n_nodes, ro, rd, t_max, max_stack: int):
    """Occlusion bool [R] (True = blocked before t_max); dispatch as
    closest_hit_wavefront."""
    _cuda.refuse_grad("any_hit_wavefront", _DETACH_SITE, table, ro, rd,
                      t_max)
    if ro.device.type == "cpu":
        return any_hit_plain(table, n_nodes, ro, rd, t_max, max_stack)
    hit = _launch(table, n_nodes, ro, rd, t_max, ANY, max_stack)
    any_hit_wavefront.launches += 1
    return hit.tri >= 0


def transmit_wavefront(table, n_nodes, tint, ro, rd, t_max, max_stack: int):
    """Shadow transmittance [R,3] (1 = unoccluded, 0 = blocked) of rays
    ro/rd [R,3] up to t_max through the shadow tints tint [T,3]; dispatch
    as closest_hit_wavefront (CPU tensors take transmit_plain)."""
    _cuda.refuse_grad("transmit_wavefront", _DETACH_SITE, table, tint, ro,
                      rd, t_max)
    if ro.device.type == "cpu":
        return transmit_plain(table, n_nodes, tint, ro, rd, t_max, max_stack)
    tp = _launch(table, n_nodes, ro, rd, t_max, TRANSMIT, max_stack, tint)
    transmit_wavefront.launches += 1
    return tp


closest_hit_wavefront.launches = 0
any_hit_wavefront.launches = 0
transmit_wavefront.launches = 0
