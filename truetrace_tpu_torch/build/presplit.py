"""Triangle pre-splitting: bound per-primitive AABB size before the BVH
build (the classic SBVH-lite quality lever for architectural scenes).

Scenes like the atrium mix room-sized wall/floor triangles with dense
small geometry; the big triangles' AABBs overlap many nodes and inflate
traversal visits/ray. Bisecting oversized triangles at the midpoint of
their longest edge (interpolating per-vertex shading attributes, which
is exact — barycentric interpolation is affine) tightens the tree at the
cost of a few percent more primitives. Applied by
`compile_scene(presplit=...)` BEFORE light lists / shadow tables / BVH
build, so every downstream [T]-sized array stays consistent.

The reference instead relies on its CWBVH spatial quality alone; this
pass is a TPU-side build-quality option (fewer dependent gathers/ray is
the #1 traversal cost, BASELINE.md).

Port of `truetrace_tpu/build/presplit.py`: the same float32 numpy, rounds
and budget, so both packages split the same triangles into the same bits
(tests/test_torch_build_opts.py).
"""
from __future__ import annotations

import numpy as np


def _aabb_half_area(v0, v1, v2):
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    d = hi - lo
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def presplit_triangles(tris: dict, max_ratio: float = 16.0,
                       max_rounds: int = 8, budget: float = 1.5) -> dict:
    """Split triangles whose AABB half-area exceeds max_ratio x the mean
    until none do (or the triangle count reaches budget x original).

    tris: the flatten_meshes dict — p0/e1/e2 [T,3], n [T,3,3],
    uv [T,3,2], tan [T,3], mat [T]. Returns a dict of the same layout.
    """
    p0 = tris["p0"].astype(np.float32)
    e1 = tris["e1"].astype(np.float32)
    e2 = tris["e2"].astype(np.float32)
    n = tris["n"].astype(np.float32)
    uv = tris["uv"].astype(np.float32)
    tan = tris["tan"].astype(np.float32)
    mat = tris["mat"]
    T0 = p0.shape[0]

    for _ in range(max_rounds):
        v0 = p0
        v1 = p0 + e1
        v2 = p0 + e2
        area = _aabb_half_area(v0, v1, v2)
        thresh = max_ratio * max(float(area.mean()), 1e-20)
        big = area > thresh
        if not big.any() or p0.shape[0] >= budget * T0:
            break
        bi = np.nonzero(big)[0]
        b0, b1, b2 = v0[bi], v1[bi], v2[bi]
        bn, buv = n[bi], uv[bi]
        # longest edge: 0 = v0v1, 1 = v1v2, 2 = v2v0
        e_len = np.stack([((b1 - b0) ** 2).sum(-1),
                          ((b2 - b1) ** 2).sum(-1),
                          ((b0 - b2) ** 2).sum(-1)], axis=1)
        which = e_len.argmax(axis=1)
        # edge endpoints (indices into the triangle's own vertices)
        ia = which                       # 0,1,2
        ib = (which + 1) % 3
        io = (which + 2) % 3             # opposite vertex
        verts = np.stack([b0, b1, b2], axis=1)       # [B,3,3]
        rows = np.arange(bi.size)
        va, vb, vo = verts[rows, ia], verts[rows, ib], verts[rows, io]
        vm = 0.5 * (va + vb)
        na, nb, no = bn[rows, ia], bn[rows, ib], bn[rows, io]
        nm = na + nb
        nm = nm / np.maximum(np.linalg.norm(nm, axis=-1, keepdims=True),
                             1e-12)
        ua, ub, uo = buv[rows, ia], buv[rows, ib], buv[rows, io]
        um = 0.5 * (ua + ub)

        def tri(pa, pb, pc, nna, nnb, nnc, uua, uub, uuc):
            return (pa, pb - pa, pc - pa,
                    np.stack([nna, nnb, nnc], 1),
                    np.stack([uua, uub, uuc], 1))

        # (va, vm, vo) and (vm, vb, vo) keep the original winding
        A = tri(va, vm, vo, na, nm, no, ua, um, uo)
        B = tri(vm, vb, vo, nm, nb, no, um, ub, uo)
        keep = ~big
        p0 = np.concatenate([p0[keep], A[0], B[0]])
        e1 = np.concatenate([e1[keep], A[1], B[1]])
        e2 = np.concatenate([e2[keep], A[2], B[2]])
        n = np.concatenate([n[keep], A[3], B[3]])
        uv = np.concatenate([uv[keep], A[4], B[4]])
        tan = np.concatenate([tan[keep], tan[bi], tan[bi]])
        mat = np.concatenate([mat[keep], mat[bi], mat[bi]])

    return dict(p0=p0, e1=e1, e2=e2, n=n, uv=uv, tan=tan,
                mat=mat.astype(tris["mat"].dtype))
