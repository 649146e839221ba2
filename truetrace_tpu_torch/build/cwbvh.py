"""CWBVH build: collapse a binary BVH into an 8-wide compressed BVH.

Implements the Ylitie et al. 2017 ("Efficient Incoherent Ray Traversal on
GPUs Through Compressed Wide BVHs") dynamic-programming collapse — the same
algorithm class as the reference's BVH8Builder (Builders/BVH8Builder.cs:30-341)
— built from the published algorithm, with a node encoding we control end to
end (builder + JAX/Pallas traversal agree on it):

80-byte node = 20 uint32 words:
  w0..w2   p.xyz                (float32 quantization origin)
  w3       e_x | e_y<<8 | e_z<<16 | imask<<24
           (e_* = biased-127 power-of-two exponent bytes of the per-axis
            quantization scale; imask bit i = slot i holds an internal child)
  w4       base_index_child     (first internal-child node id)
  w5       base_index_triangle  (first triangle of this node's leaves)
  w6..w7   meta[8] bytes: empty slot = 0
           internal slot i -> 0b001_00000 | i
           leaf slot       -> unary(count)<<5 | tri_offset   (count<=3)
  w8..w13  q_lo[8] bytes per axis (x then y then z)
  w14..w19 q_hi[8] bytes per axis

Decoding rules shared with the traversal kernels:
  internal child node id = base_child + popcount(imask & ((1<<i)-1))
  leaf triangles         = base_tri + offset .. + count
  child AABB             = p + q * 2^(e-127)  (conservative by construction)

Triangles are emitted in traversal order into `tri_index` (CWBVH leaf order
-> BVH2-leaf-order slot), so the caller re-permutes triangle arrays once.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from truetrace_tpu_torch.build.bvh2 import BVH2

P_MAX = 3          # max triangles per leaf slot
C_NODE = 1.0       # internal-node traversal cost
C_PRIM = 0.3       # per-triangle intersection cost
INVALID = 0xFFFFFFFF


@dataclass
class CWBVH:
    nodes: np.ndarray      # [C,20] uint32
    tri_index: np.ndarray  # [T] int32: CWBVH emit order -> input tri slot
    leaf_start: np.ndarray # [N2] int32: BVH2 leaf node -> first tri in CWBVH
                           # order (-1 for internal). Each BVH2 leaf's tris
                           # stay contiguous, so the BVH2 arrays can be
                           # remapped onto CWBVH-ordered triangles.
    depth: int
    # refit metadata (build/refit.py level sweeps — the reference's
    # DocumentNodes layer worklists, ParentObject.cs:638):
    node_depth: np.ndarray     # [C] int32 (root = 1)
    slot_child: np.ndarray     # [C,8] int32 internal child node id, -1 else
    slot_tri_base: np.ndarray  # [C,8] int32 first tri of leaf slot, -1 else
    slot_tri_count: np.ndarray # [C,8] int32 tris in leaf slot (0 = not leaf)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def _half_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def build_cwbvh(bvh: BVH2, prim_box: np.ndarray,
                use_native: bool = True, p_max: int = 3) -> CWBVH:
    """bvh: binary BVH (ideally built with max_leaf<=p_max);
    prim_box: [T,2,3] primitive AABBs in the SAME order as bvh leaf slots
    (i.e. already permuted by bvh.order).

    The C++ collapse (build/native/cwbvh.cpp, identical algorithm and
    output) takes over for scenes big enough for Python overhead to
    matter — the Python DP is ~15 s at 300k tris, the native one ~0.1 s."""
    if use_native and bvh.order.shape[0] >= 20000:
        from truetrace_tpu_torch.build.native import build_cwbvh_native
        out = build_cwbvh_native(bvh.box, bvh.left, bvh.count, p_max=p_max)
        if out is not None:
            (nodes, tri_index, leaf_start, depth, node_depth,
             slot_child, slot_tri_base, slot_tri_count) = out
            return CWBVH(nodes=nodes, tri_index=tri_index,
                         leaf_start=leaf_start, depth=depth,
                         node_depth=node_depth, slot_child=slot_child,
                         slot_tri_base=slot_tri_base,
                         slot_tri_count=slot_tri_count)
    n2 = bvh.n_nodes
    box = bvh.box.astype(np.float64)
    left = bvh.left
    count = bvh.count
    area = np.array([_half_area(box[i, 0], box[i, 1]) for i in range(n2)])

    # prim counts per subtree (iterative post-order)
    nprims = np.zeros(n2, np.int64)
    order_stack = [0]
    post = []
    while order_stack:
        n = order_stack.pop()
        post.append(n)
        if count[n] == 0:
            order_stack.append(left[n])
            order_stack.append(left[n] + 1)
    for n in reversed(post):
        nprims[n] = count[n] if count[n] > 0 else \
            nprims[left[n]] + nprims[left[n] + 1]

    # ---- DP cost table: cost[n, i] = min cost of subtree n using i+1 root
    # slots; decision[n, i]: 0 = leaf, 1 = internal, k>=2 = distribute with
    # k-1 slots in the left child.
    cost = np.full((n2, 7), np.inf)
    decision = np.zeros((n2, 7), np.int8)

    for n in reversed(post):
        a = area[n]
        if count[n] > 0:
            # BVH2 leaf: must fit in one CWBVH leaf slot
            p = count[n]
            c_leaf = a * p * C_PRIM if p <= p_max else np.inf
            cost[n, :] = c_leaf
            decision[n, :] = 0
            continue
        l, r = left[n], left[n] + 1
        # distribute costs for j = 2..8 root slots is handled via the
        # standard recurrence on (cost of left with k slots)+(right, j-k)
        cl = cost[l]
        cr = cost[r]
        # C_distribute(n, j slots) for j in 1..7 (index j-1); j>=2 meaningful
        dist = np.full(8, np.inf)     # dist[j-1], j slots total
        dist_k = np.zeros(8, np.int8)
        for j in range(2, 9):
            best = np.inf
            bk = 1
            for k in range(1, j):
                if k <= 7 and (j - k) <= 7:
                    c = cl[k - 1] + cr[j - k - 1]
                    if c < best:
                        best = c
                        bk = k
            dist[j - 1] = best
            dist_k[j - 1] = bk
        c_internal = a * C_NODE + dist[7]   # all 8 slots available
        # i = 1 slot: choose leaf(impossible here) vs internal
        cost[n, 0] = c_internal
        decision[n, 0] = 1
        for i in range(1, 7):           # i+1 slots
            c_d = dist[i]
            if c_d < cost[n, i - 1]:
                cost[n, i] = c_d
                decision[n, i] = 1 + dist_k[i]
            else:
                cost[n, i] = cost[n, i - 1]
                decision[n, i] = decision[n, i - 1]

    # ---- collapse: emit CWBVH nodes (BFS so children are contiguous)
    sys.setrecursionlimit(max(10000, bvh.depth * 4 + 100))

    def get_children(n, i, out):
        """Expand node n using i+1 slots into `out` (list of BVH2 node ids,
        each to be realized with 1 slot)."""
        d = decision[n, i]
        if d == 0 or d == 1:
            out.append(n)
            return
        k = d - 1
        l, r = left[n], left[n] + 1
        get_children(l, k - 1, out)
        get_children(r, i - k, out)

    nodes = []                   # list of 20-word rows
    tri_index = []
    new_leaf_start = np.full(n2, -1, np.int32)
    meta_depth: list = []        # per emitted node
    meta_slot_child: list = []
    meta_slot_tri: list = []     # (base, count) pairs

    from collections import deque

    def emit_internal(n_ids):
        """Reserve a node row for an internal node whose children are the
        BVH2 subtrees realized by n_ids (each with decision at 1 slot)."""
        nodes.append(np.zeros(20, np.uint32))
        meta_depth.append(1)
        meta_slot_child.append(np.full(8, -1, np.int32))
        meta_slot_tri.append(np.full((8, 2), -1, np.int32))
        return len(nodes) - 1

    def expand_internal(n):
        """Children of BVH2 node n when realized as a CWBVH internal node:
        distribute its two BVH2 children over the 8 slots."""
        ch: list = []
        l, r = left[n], left[n] + 1
        best, bk = np.inf, 1
        for k in range(1, 8):
            c = cost[l, k - 1] + cost[r, 8 - k - 1]
            if c < best:
                best, bk = c, k
        get_children(l, bk - 1, ch)
        get_children(r, 8 - bk - 1, ch)
        return ch

    queue = deque()
    if count[0] > 0:
        # degenerate: root is a single BVH2 leaf — wrap it in one node
        root_children = [0]
    else:
        root_children = expand_internal(0)
    root_id = emit_internal(root_children)
    queue.append((root_id, root_children))

    max_depth = 1
    depth_of = {0: 1}

    while queue:
        node_id, children = queue.popleft()
        d_here = depth_of.get(node_id, 1)
        # children: list of BVH2 node ids, each realized in one slot:
        # leaf if it is a BVH2 leaf, internal otherwise
        assert len(children) <= 8
        # node bounds = union of child bounds
        c_lo = np.min([box[c, 0] for c in children], axis=0)
        c_hi = np.max([box[c, 1] for c in children], axis=0)

        # per-axis power-of-two scale
        ext = np.maximum(c_hi - c_lo, 0.0)
        e_b = np.empty(3, np.int64)
        for k in range(3):
            if ext[k] <= 0:
                e_b[k] = 1
            else:
                e = int(np.ceil(np.log2(ext[k] / 255.0)))
                e_b[k] = np.clip(e + 127, 1, 254)
        scale = np.exp2(e_b - 127.0)

        # --- order children into slots by octant heuristic (Ylitie sec 4.2):
        # greedy assignment maximizing alignment of child direction with the
        # slot's octant direction.
        n_ch = len(children)
        parent_c = 0.5 * (c_lo + c_hi)
        child_dirs = []
        for c in children:
            cc = 0.5 * (box[c, 0] + box[c, 1])
            v = cc - parent_c
            nv = np.linalg.norm(v)
            child_dirs.append(v / nv if nv > 1e-12 else np.zeros(3))
        slot_of = [-1] * 8        # slot -> child list index
        assigned = [False] * n_ch
        # greedy: for each (slot, child) pair pick best dot
        pairs = []
        for s in range(8):
            ds = np.array([1.0 if (s >> k) & 1 else -1.0 for k in range(3)])
            ds /= np.sqrt(3.0)
            for ci in range(n_ch):
                pairs.append((-float(np.dot(ds, child_dirs[ci])), s, ci))
        pairs.sort()
        used_slot = [False] * 8
        for _, s, ci in pairs:
            if not used_slot[s] and not assigned[ci]:
                used_slot[s] = True
                assigned[ci] = True
                slot_of[s] = ci
        # any leftovers (n_ch > unassigned shouldn't happen)

        # --- reserve child node ids (internal children contiguous) and
        # triangle range (leaf children contiguous), then fill words
        imask = 0
        meta = [0] * 8
        qlo = np.zeros((8, 3), np.int64)
        qhi = np.zeros((8, 3), np.int64)
        internal_children = []
        base_tri = len(tri_index)
        tri_off = 0
        for s in range(8):
            ci = slot_of[s]
            if ci < 0:
                qlo[s] = 255
                qhi[s] = 0
                continue
            c = children[ci]
            lo_q = np.floor((box[c, 0] - c_lo) / scale)
            hi_q = np.ceil((box[c, 1] - c_lo) / scale)
            qlo[s] = np.clip(lo_q, 0, 255)
            qhi[s] = np.clip(hi_q, 0, 255)
            if count[c] == 0 and decision[c, 0] == 1:
                imask |= (1 << s)
                meta[s] = 0b0010_0000 | s
                internal_children.append(c)
            else:
                # leaf slot: flatten the BVH2 leaf's triangles
                assert count[c] > 0, "leaf slot must be a BVH2 leaf"
                ntri = int(count[c])
                assert ntri <= p_max
                # classic meta byte encodes <=3 tris / offset<=31; fat
                # builds (p_max>3) store a nonzero marker — traversal
                # consumers read slot_tri_base/count directly
                if ntri <= 3 and tri_off <= 31:
                    unary = (1 << ntri) - 1
                    meta[s] = (unary << 5) | tri_off
                else:
                    meta[s] = 0b1000_0000 | s
                new_leaf_start[c] = base_tri + tri_off
                meta_slot_tri[node_id][s] = (base_tri + tri_off, ntri)
                for t in range(ntri):
                    tri_index.append(int(left[c]) + t)
                tri_off += ntri

        base_child = len(nodes)
        for c in internal_children:
            ch = expand_internal(c)
            cid = emit_internal(ch)
            depth_of[cid] = d_here + 1
            max_depth = max(max_depth, d_here + 1)
            queue.append((cid, ch))

        # refit metadata for this node
        meta_depth[node_id] = d_here
        rank = 0
        for s in range(8):
            if meta[s] == 0:
                continue
            if imask & (1 << s):
                meta_slot_child[node_id][s] = base_child + rank
                rank += 1
            # leaf slots: meta_slot_tri was written at emission (the meta
            # byte no longer round-trips counts in fat-leaf builds)

        # fill the 20 words
        w = np.zeros(20, np.uint32)
        w[0:3] = np.frombuffer(
            np.asarray(c_lo, np.float32).tobytes(), np.uint32)
        w[3] = (int(e_b[0]) | (int(e_b[1]) << 8) | (int(e_b[2]) << 16)
                | (imask << 24))
        w[4] = base_child
        w[5] = base_tri
        mb = 0
        for s in range(4):
            mb |= meta[s] << (8 * s)
        w[6] = mb
        mb = 0
        for s in range(4):
            mb |= meta[s + 4] << (8 * s)
        w[7] = mb
        for axis in range(3):
            lo_bytes = qlo[:, axis]
            hi_bytes = qhi[:, axis]
            w[8 + 2 * axis] = int(sum(int(lo_bytes[s]) << (8 * s)
                                      for s in range(4)))
            w[9 + 2 * axis] = int(sum(int(lo_bytes[s + 4]) << (8 * s)
                                      for s in range(4)))
            w[14 + 2 * axis] = int(sum(int(hi_bytes[s]) << (8 * s)
                                       for s in range(4)))
            w[15 + 2 * axis] = int(sum(int(hi_bytes[s + 4]) << (8 * s)
                                       for s in range(4)))
        nodes[node_id] = w

    slot_tri = np.stack(meta_slot_tri)           # [C,8,2]
    return CWBVH(nodes=np.stack(nodes).astype(np.uint32),
                 tri_index=np.asarray(tri_index, np.int32),
                 leaf_start=new_leaf_start,
                 depth=max_depth,
                 node_depth=np.asarray(meta_depth, np.int32),
                 slot_child=np.stack(meta_slot_child),
                 slot_tri_base=slot_tri[:, :, 0].copy(),
                 slot_tri_count=np.maximum(slot_tri[:, :, 1], 0))
