"""Light-BVH importance descent and its pdf — torch ops.

Port of `truetrace_tpu/kernels/lighttree.py`: the cut path
(`_cut_select`, `sample_light_tree_cut`, `light_tree_pdf_cut`: a dense
categorical pick over a <=128-entry cut of subtree roots, then a descent
below the picked entry) and the descent from the root for a scene
without a cut (`sample_light_tree`, `light_tree_pdf`), over "pair rows"
(build/lightbvh.py build_pairs: both children's 12-float bounds + two
int32 links per row), and `node_importance`. The JAX while_loops become
Python loops over the tree depth (`Scene.lbvh_depth`); iterations after
a lane is done leave it unchanged, as there.
"""
from __future__ import annotations

import torch

COS_E = 0.0     # emission cone falloff half-angle = pi/2 for area lights


def _cos_sub_clamped(sin_a, cos_a, sin_b, cos_b):
    """cos(a-b), = 1 when a < b (angles in [0, pi])."""
    return torch.where(cos_a > cos_b, 1.0, cos_a * cos_b + sin_a * sin_b)


def _sin_sub_clamped(sin_a, cos_a, sin_b, cos_b):
    """sin(a-b), = 0 when a < b."""
    return torch.where(cos_a > cos_b, 0.0, sin_a * cos_b - cos_a * sin_b)


def _importance(c, px, py, pz, nx, ny, nz):
    """PBRT-4 LightBounds::Importance given a column accessor c(k) over a
    12-float bounds block; all other arguments broadcast against it."""
    lox, loy, loz = c(0), c(1), c(2)
    hix, hiy, hiz = c(3), c(4), c(5)
    ax, ay, az = c(6), c(7), c(8)
    cos_o = c(9)
    phi = c(11)

    dx = 0.5 * (lox + hix) - px
    dy = 0.5 * (loy + hiy) - py
    dz = 0.5 * (loz + hiz) - pz
    d2 = torch.clamp(dx * dx + dy * dy + dz * dz, min=1e-12)
    ex, ey, ez = hix - lox, hiy - loy, hiz - loz
    r2 = 0.25 * (ex * ex + ey * ey + ez * ez)
    d2c = torch.maximum(d2, 0.5 * r2)
    inv_d = torch.rsqrt(d2)
    wx, wy, wz = dx * inv_d, dy * inv_d, dz * inv_d   # p -> light centre

    cos_w = -(ax * wx + ay * wy + az * wz)
    sin_w = torch.sqrt(torch.clamp(1.0 - cos_w * cos_w, min=0.0))
    sin2_b = torch.clamp(r2 / d2, 0.0, 1.0)
    cos_b = torch.sqrt(torch.clamp(1.0 - sin2_b, min=0.0))
    sin_b = torch.sqrt(sin2_b)
    sin_o = torch.sqrt(torch.clamp(1.0 - cos_o * cos_o, min=0.0))

    cos_x = _cos_sub_clamped(sin_w, cos_w, sin_o, cos_o)
    sin_x = _sin_sub_clamped(sin_w, cos_w, sin_o, cos_o)
    cos_p = _cos_sub_clamped(sin_x, cos_x, sin_b, cos_b)
    imp = phi * torch.where(cos_p > COS_E, cos_p, 0.0) / d2c

    cos_i = (wx * nx + wy * ny + wz * nz).abs()
    sin_i = torch.sqrt(torch.clamp(1.0 - cos_i * cos_i, min=0.0))
    cos_ip = _cos_sub_clamped(sin_i, cos_i, sin_b, cos_b)
    return torch.clamp(imp * cos_ip, min=0.0)


def _importance_cols(row, off, p, n):
    """Importance of the bounds block at column `off` of gathered pair
    rows [R,26]."""
    return _importance(lambda k: row[:, off + k], p[:, 0], p[:, 1], p[:, 2],
                       n[:, 0], n[:, 1], n[:, 2])


def _importance_dense(cut, p, n, dtype=torch.float32):
    """Importance of every cut entry for every lane: [M,R] (no gathers).
    dtype=bfloat16 runs the whole computation in bf16, as the JAX package
    does for nee_mis="approx"."""
    cut = cut.to(dtype)
    q = [p[:, k].to(dtype)[None, :] for k in range(3)]
    m = [n[:, k].to(dtype)[None, :] for k in range(3)]
    return _importance(lambda k: cut[:, k][:, None], *q, *m)


def node_importance(nodes, idx, p, n):
    """Importance of standalone node rows [N,12] at indices idx (the
    refit and diagnostic checks; the samplers read pair rows)."""
    row = nodes[idx]
    return _importance(lambda k: row[:, k], p[..., 0], p[..., 1], p[..., 2],
                       n[..., 0], n[..., 1], n[..., 2])


def _link(row, col):
    return row[:, col].contiguous().view(torch.int32).to(torch.int64)


def _cut_select(cut_bounds, p, n, u, dtype=torch.float32):
    """Categorical pick over the cut: (pick [R], p_cut [R], u' [R]).

    The pmf is derived from CDF differences, so p_cut is exactly the
    probability of the bin actually picked, in any select precision."""
    imp = _importance_dense(cut_bounds, p, n, dtype=dtype)       # [M,R]
    M = imp.shape[0]
    cdf = torch.cumsum(imp.to(torch.float32), 0)
    tot = cdf[-1]
    zero = tot <= 0.0            # all-zero importance: uniform fallback
    ramp = torch.arange(1, M + 1, dtype=torch.float32,
                        device=p.device)[:, None]
    cdf = torch.where(zero[None, :], ramp.expand_as(cdf), cdf)
    tot = torch.where(zero, float(M), tot)
    x = u * tot
    pick = torch.clamp((cdf <= x[None, :]).sum(0), 0, M - 1)
    chi = torch.gather(cdf, 0, pick[None, :])[0]
    prev = torch.where(pick > 0, torch.gather(
        cdf, 0, torch.clamp(pick - 1, min=0)[None, :])[0], 0.0)
    width = torch.clamp(chi - prev, min=0.0)
    u2 = torch.clamp((x - prev) / torch.clamp(width, min=1e-20),
                     0.0, 1.0 - 1e-7)
    p_cut = width / tot
    return pick, p_cut, u2


def sample_light_tree_cut(pairs, prim, cut_bounds, cut_link, p, n, u,
                          depth: int, select_dtype=torch.float32):
    """Cut pick then residual descent: (light_idx [R], pmf [R], u' [R]).
    depth bounds the descent (Scene.lbvh_depth)."""
    Ni = pairs.shape[0]
    pick, p_cut, u = _cut_select(cut_bounds, p, n, u, dtype=select_dtype)
    link = cut_link[pick]
    leaf_now = link < 0
    first = torch.where(leaf_now, -(link + 1), 0)
    if Ni == 0:
        return prim[first], p_cut, u

    row = pairs[torch.clamp(torch.where(leaf_now, 0, link), 0, Ni - 1)]
    pmf, u, first = _descend(pairs, row, p_cut, u, first, leaf_now, p, n,
                             depth)
    return prim[first], pmf, u


def light_tree_pdf_cut(pairs, trail, cut_bounds, cut_link, cut_of_light,
                       cut_skip, light_idx, p, n, depth: int):
    """pmf sample_light_tree_cut assigns to `light_idx` from p (f32
    importance): the cut probability times the below-cut trail descent.
    trail holds the root->leaf bit trails as int32 bits."""
    Ni = pairs.shape[0]
    li = torch.clamp(light_idx, min=0)
    imp = _importance_dense(cut_bounds, p, n)                     # [M,R]
    M = imp.shape[0]
    tot = imp.sum(0)
    imp = torch.where((tot > 0.0)[None, :], imp, 1.0)
    tot = torch.where(tot > 0.0, tot, float(M))
    entry = cut_of_light[li]
    p_cut = torch.gather(imp, 0, entry[None, :])[0] / tot
    link = cut_link[entry]
    if Ni == 0:
        return torch.where(light_idx >= 0, p_cut, 0.0)
    bits = trail[li].to(torch.int64) & 0xFFFFFFFF
    k0 = cut_skip[li]

    leaf_now = link < 0
    row = pairs[torch.clamp(torch.where(leaf_now, 0, link), 0, Ni - 1)]
    pmf = _trail_pmf(pairs, row, p_cut, leaf_now, bits, k0, p, n, depth)
    return torch.where(light_idx >= 0, pmf, 0.0)


def _descend(pairs, row, pmf, u, first, done, p, n, depth: int):
    """The importance descent from gathered pair rows `row`: up to
    `depth` branch steps, each rescaling u and multiplying pmf by the
    branch probability; lanes already done stay."""
    Ni = pairs.shape[0]
    for _ in range(depth):
        il = _importance_cols(row, 0, p, n)
        ir = _importance_cols(row, 12, p, n)
        tot = il + ir
        ql = torch.where(tot > 0.0, il / torch.clamp(tot, min=1e-20), 0.5)
        go_left = u < ql
        u_new = torch.where(go_left, u / torch.clamp(ql, min=1e-9),
                            (u - ql) / torch.clamp(1.0 - ql, min=1e-9))
        u_new = torch.clamp(u_new, 0.0, 1.0 - 1e-7)
        q = torch.where(go_left, ql, 1.0 - ql)
        lnk = torch.where(go_left, _link(row, 24), _link(row, 25))
        act = ~done
        pmf = torch.where(act, pmf * torch.clamp(q, min=1e-12), pmf)
        u = torch.where(act, u_new, u)
        hit_leaf = act & (lnk < 0)
        first = torch.where(hit_leaf, -(lnk + 1), first)
        done = done | hit_leaf
        nxt = torch.clamp(torch.where(act & ~hit_leaf, lnk, 0), 0, Ni - 1)
        row = torch.where(done[:, None], row, pairs[nxt])
    return pmf, u, first


def _trail_pmf(pairs, row, pmf, done, bits, k0, p, n, depth: int):
    """The pmf of the descent that follows the trail bits (bit k0 + k at
    step k: 1 = right) from gathered pair rows `row`."""
    Ni = pairs.shape[0]
    for k in range(depth):
        il = _importance_cols(row, 0, p, n)
        ir = _importance_cols(row, 12, p, n)
        tot = il + ir
        ql = torch.where(tot > 0.0, il / torch.clamp(tot, min=1e-20), 0.5)
        go_right = ((bits >> torch.clamp(k0 + k, max=31)) & 1) == 1
        q = torch.where(go_right, 1.0 - ql, ql)
        lnk = torch.where(go_right, _link(row, 25), _link(row, 24))
        act = ~done
        pmf = torch.where(act, pmf * torch.clamp(q, min=1e-12), pmf)
        done = done | (act & (lnk < 0))
        nxt = torch.clamp(torch.where(lnk >= 0, lnk, 0), 0, Ni - 1)
        row = torch.where(done[:, None], row, pairs[nxt])
    return pmf


def sample_light_tree(pairs, prim, p, n, u, depth: int):
    """The descent from the root (a scene without a cut): (light_idx [R],
    pmf [R], u' [R]); u is one uniform a lane, rescaled at every branch
    (the reference's SampleLightBVH, CommonData.cginc:1126)."""
    R = p.shape[0]
    z = torch.zeros((R,), dtype=torch.int64, device=p.device)
    one = torch.ones((R,), device=p.device)
    if pairs.shape[0] == 0:          # a single-leaf tree
        return prim[z], one, u
    row = pairs[0].expand(R, -1)
    pmf, u, first = _descend(pairs, row, one, u, z, z.bool(), p, n, depth)
    return prim[first], pmf, u


def light_tree_pdf(pairs, trail, light_idx, p, n, depth: int):
    """The pmf sample_light_tree assigns to `light_idx` from p, following
    its stored root->leaf bit trail (the reference's CalcLightPDF,
    CommonData.cginc:1057). trail holds the trails as int32 bits."""
    R = p.shape[0]
    if pairs.shape[0] == 0:
        return torch.where(light_idx >= 0, 1.0, 0.0)
    bits = trail[torch.clamp(light_idx, min=0)].to(torch.int64) & 0xFFFFFFFF
    z = torch.zeros((R,), dtype=torch.int64, device=p.device)
    pmf = _trail_pmf(pairs, pairs[0].expand(R, -1),
                     torch.ones((R,), device=p.device), z.bool(), bits, z,
                     p, n, depth)
    return torch.where(light_idx >= 0, pmf, 0.0)
