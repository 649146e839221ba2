"""Sponza-class benchmark asset: generator + OBJ/MTL/PNG exporter + loader.

Port of `truetrace_tpu/scene/sponza_like.py`, the JAX package's headline
bench scene (bench.py, tests/test_golden.py): a procedural two-story
colonnaded atrium in the Sponza layout (arcades with round arches, ribbed
columns, curtains and banners, pots, emissive lamps, open roof) with full
UVs and procedural textures. `export` writes it as a real OBJ + MTL +
textures/ directory, byte for byte the JAX package's OBJ and MTL, and
`make` loads it back through the port's asset pipeline
(scene/obj_loader.py load_obj_scene -> atlas), so the scene takes the path
a user's own Sponza files would. Textures are written with the port's PNG
codec (scene/png.py): no Pillow.

    from truetrace_tpu_torch.scene import sponza_like
    meshes, mats, atlas, rects, level_y, cam, env = sponza_like.make(2.0)
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# geometry kit (positions/uvs/normals + triangle fans, all numpy)
# ---------------------------------------------------------------------------


class Geo:
    """Accumulates one OBJ object per material."""

    def __init__(self):
        self.v: List[np.ndarray] = []
        self.vt: List[np.ndarray] = []
        self.vn: List[np.ndarray] = []
        self.f: List[Tuple[np.ndarray, str]] = []   # (corner idx [F,3,3], mat)
        self._nv = 0
        self._nt = 0
        self._nn = 0

    def add(self, P, UV, N, F, mat: str):
        """P [V,3], UV [V,2], N [V,3], F [T,3] vertex indices."""
        F = np.asarray(F, np.int64)
        idx = np.stack([F + 1 + self._nv, F + 1 + self._nt,
                        F + 1 + self._nn], axis=-1)
        self.f.append((idx, mat))
        self.v.append(np.asarray(P, np.float32))
        self.vt.append(np.asarray(UV, np.float32))
        self.vn.append(np.asarray(N, np.float32))
        self._nv += P.shape[0]
        self._nt += UV.shape[0]
        self._nn += N.shape[0]

    def n_tris(self):
        return sum(i.shape[0] for i, _ in self.f)


def _grid(nx, ny):
    """Index grid [nx*ny] -> quads -> tris [2*(nx-1)*(ny-1), 3]."""
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    a = (i * ny + j).ravel()
    b = a + ny
    return np.concatenate([np.stack([a, b, a + 1], 1),
                           np.stack([b, b + 1, a + 1], 1)], 0)


def box(g: Geo, lo, hi, mat, uv_scale=0.5):
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    P, UV, N, F = [], [], [], []
    n = 0
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            c = np.zeros((4, 3), np.float32)
            c[:, axis] = hi[axis] if sgn > 0 else lo[axis]
            uu = np.array([lo[u], hi[u], hi[u], lo[u]], np.float32)
            vv = np.array([lo[v], lo[v], hi[v], hi[v]], np.float32)
            c[:, u] = uu
            c[:, v] = vv
            nrm = np.zeros(3, np.float32)
            nrm[axis] = sgn
            order = [0, 1, 2, 0, 2, 3] if sgn > 0 else [0, 2, 1, 0, 3, 2]
            P.append(c)
            UV.append(np.stack([uu, vv], 1) * uv_scale)
            N.append(np.broadcast_to(nrm, (4, 3)))
            F.append(np.asarray(order).reshape(2, 3) + n)
            n += 4
    g.add(np.concatenate(P), np.concatenate(UV), np.concatenate(N),
          np.concatenate(F), mat)


def cylinder(g: Geo, center, r, y0, y1, segs, mat, ribs=0.0, cap=True,
             r_top=None):
    """Vertical cylinder with cylindrical UVs; ribs adds fluting."""
    cx, cz = center
    r_top = r if r_top is None else r_top
    th = np.linspace(0, 2 * np.pi, segs + 1)
    rr0 = r * (1.0 + ribs * 0.5 * np.cos(th * 12))
    rr1 = r_top * (1.0 + ribs * 0.5 * np.cos(th * 12))
    ring0 = np.stack([cx + rr0 * np.cos(th), np.full_like(th, y0),
                      cz + rr0 * np.sin(th)], 1)
    ring1 = np.stack([cx + rr1 * np.cos(th), np.full_like(th, y1),
                      cz + rr1 * np.sin(th)], 1)
    P = np.concatenate([ring0, ring1]).astype(np.float32)
    u = th / (2 * np.pi) * 4.0
    UV = np.concatenate([np.stack([u, np.zeros_like(u)], 1),
                         np.stack([u, np.full_like(u, (y1 - y0))], 1)]
                        ).astype(np.float32)
    nx = np.stack([np.cos(th), np.zeros_like(th), np.sin(th)], 1)
    N = np.concatenate([nx, nx]).astype(np.float32)
    k = segs + 1
    i = np.arange(segs)
    F = np.concatenate([np.stack([i, i + k, i + 1], 1),
                        np.stack([i + k, i + k + 1, i + 1], 1)], 0)
    g.add(P, UV, N, F, mat)
    if cap:
        top = np.stack([cx + r_top * np.cos(th[:-1]),
                        np.full(segs, y1),
                        cz + r_top * np.sin(th[:-1])], 1).astype(np.float32)
        c = np.array([[cx, y1, cz]], np.float32)
        P2 = np.concatenate([top, c])
        UV2 = (P2[:, [0, 2]] * 0.3).astype(np.float32)
        N2 = np.broadcast_to(np.array([0, 1, 0], np.float32),
                             P2.shape).copy()
        i = np.arange(segs)
        F2 = np.stack([i, (i + 1) % segs, np.full(segs, segs)], 1)
        g.add(P2, UV2, N2, F2, mat)


def arch_panel(g: Geo, x0, x1, y_base, y_top, z, depth, r, mat, segs=12):
    """Wall panel from y_base..y_top spanning x0..x1 at depth `z`..`z+depth`
    with a semicircular arch cutout of radius r centered on the span.
    Front + back faces + the curved soffit."""
    cx = 0.5 * (x0 + x1)
    th = np.linspace(np.pi, 0, segs + 1)
    ax = cx + r * np.cos(th)
    ay = y_base + r * np.sin(th)
    # outer boundary matched 1:1 to the arc samples (fan-friendly strips):
    # walk the frame top edge above each arc sample
    ox = np.interp(np.linspace(0, 1, segs + 1), [0, 1], [x0, x1])
    for zz, flip in ((z, True), (z + depth, False)):
        P, UV, N, F = [], [], [], []
        n = 0
        nrm = np.array([0, 0, -1.0 if flip else 1.0], np.float32)
        for k in range(segs):
            quad = np.array([
                [ax[k], ay[k], zz], [ax[k + 1], ay[k + 1], zz],
                [ox[k + 1], y_top, zz], [ox[k], y_top, zz]], np.float32)
            order = [0, 1, 2, 0, 2, 3] if not flip else [0, 2, 1, 0, 3, 2]
            P.append(quad)
            UV.append(quad[:, :2] * 0.5)
            N.append(np.broadcast_to(nrm, (4, 3)))
            F.append(np.asarray(order).reshape(2, 3) + n)
            n += 4
        # side pieces below the arc spring line
        for xa, xb in ((x0, cx - r), (cx + r, x1)):
            quad = np.array([[xa, y_base, zz], [xb, y_base, zz],
                             [xb, y_top, zz], [xa, y_top, zz]], np.float32)
            order = [0, 1, 2, 0, 2, 3] if not flip else [0, 2, 1, 0, 3, 2]
            P.append(quad)
            UV.append(quad[:, :2] * 0.5)
            N.append(np.broadcast_to(nrm, (4, 3)))
            F.append(np.asarray(order).reshape(2, 3) + n)
            n += 4
        g.add(np.concatenate(P), np.concatenate(UV), np.concatenate(N),
              np.concatenate(F), mat)
    # soffit (underside of the arch)
    P = np.concatenate([np.stack([ax, ay, np.full_like(ax, z)], 1),
                        np.stack([ax, ay, np.full_like(ax, z + depth)], 1)]
                       ).astype(np.float32)
    UV = np.concatenate([np.stack([th * r, np.zeros_like(th)], 1),
                         np.stack([th * r, np.full_like(th, depth)], 1)]
                        ).astype(np.float32)
    nin = np.stack([-np.cos(th), -np.sin(th), np.zeros_like(th)], 1)
    N = np.concatenate([nin, nin]).astype(np.float32)
    k = segs + 1
    i = np.arange(segs)
    F = np.concatenate([np.stack([i, i + 1, i + k], 1),
                        np.stack([i + 1, i + k + 1, i + k], 1)], 0)
    g.add(P, UV, N, F, mat)


def cloth(g: Geo, x0, x1, y0, y1, z, mat, segs, wave=0.25, sag=0.3):
    """Hanging cloth: grid with sinusoidal depth waves + catenary sag."""
    nx = max(segs, 4)
    ny = max(segs, 4)
    xs = np.linspace(x0, x1, nx)
    ys = np.linspace(y1, y0, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    t = (X - x0) / max(x1 - x0, 1e-6)
    drop = (y1 - Y) / max(y1 - y0, 1e-6)
    Z = z + wave * np.sin(t * np.pi * 5) * drop \
        + sag * np.sin(t * np.pi) * drop
    P = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1).astype(np.float32)
    UV = np.stack([t.ravel() * 2.0, drop.ravel() * 2.0], 1
                  ).astype(np.float32)
    # analytic-ish normals via finite differences
    dzdx = np.gradient(Z, axis=0)
    dzdy = np.gradient(Z, axis=1)
    dx = xs[1] - xs[0]
    dy = ys[1] - ys[0] if ny > 1 else 1.0
    N = np.stack([-(dzdx / dx).ravel(), -(dzdy / dy).ravel(),
                  np.ones(nx * ny)], 1)
    N /= np.linalg.norm(N, axis=1, keepdims=True)
    g.add(P, UV, N.astype(np.float32), _grid(nx, ny), mat)


def pot(g: Geo, center, scale, mat, segs=16):
    """Lathe profile vase."""
    prof_r = np.array([0.22, 0.34, 0.42, 0.38, 0.22, 0.26]) * scale
    prof_y = np.array([0.0, 0.18, 0.45, 0.72, 0.92, 1.0]) * scale
    cx, cz = center
    th = np.linspace(0, 2 * np.pi, segs + 1)
    rings = []
    for r_, y_ in zip(prof_r, prof_y):
        rings.append(np.stack([cx + r_ * np.cos(th),
                               np.full_like(th, y_),
                               cz + r_ * np.sin(th)], 1))
    P = np.concatenate(rings).astype(np.float32)
    u = th / (2 * np.pi) * 3
    UV = np.concatenate([np.stack([u, np.full_like(u, y_)], 1)
                         for y_ in prof_y]).astype(np.float32)
    nx = np.stack([np.cos(th), np.zeros_like(th), np.sin(th)], 1)
    N = np.concatenate([nx] * len(prof_y)).astype(np.float32)
    k = segs + 1
    F = []
    for ring in range(len(prof_y) - 1):
        i = np.arange(segs) + ring * k
        F.append(np.stack([i, i + k, i + 1], 1))
        F.append(np.stack([i + k, i + k + 1, i + 1], 1))
    g.add(P, UV, N, np.concatenate(F), mat)


# ---------------------------------------------------------------------------
# procedural textures
# ---------------------------------------------------------------------------


def _noise(rng, n, octaves=4):
    img = np.zeros((n, n), np.float32)
    for o in range(octaves):
        s = max(n >> (octaves - 1 - o), 2)
        layer = rng.uniform(0, 1, (s, s)).astype(np.float32)
        layer = np.kron(layer, np.ones((n // s, n // s), np.float32))
        img += layer * (0.5 ** (o + 1))
    return img / img.max()


def make_textures(n: int = 256) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(7)
    tex: Dict[str, np.ndarray] = {}
    y, x = np.mgrid[0:n, 0:n] / n

    # stone floor tiles
    tile = ((np.floor(x * 6) + np.floor(y * 6)) % 2) * 0.12
    grout = ((np.abs((x * 6) % 1 - 0.5) > 0.46)
             | (np.abs((y * 6) % 1 - 0.5) > 0.46)) * -0.25
    base = 0.55 + tile + grout + 0.18 * (_noise(rng, n) - 0.5)
    tex["stone_floor"] = np.clip(np.stack(
        [base * 1.02, base, base * 0.92], -1), 0, 1)

    # brick courses
    row = np.floor(y * 12)
    bx = (x * 6 + (row % 2) * 0.5) % 1
    mortar = ((bx > 0.94) | ((y * 12) % 1 > 0.85)) * -0.3
    b = 0.52 + mortar + 0.2 * (_noise(rng, n) - 0.5)
    tex["brick"] = np.clip(np.stack(
        [b * 1.25, b * 0.78, b * 0.62], -1), 0, 1)

    # plaster
    p = 0.72 + 0.1 * (_noise(rng, n, 5) - 0.5)
    tex["plaster"] = np.clip(np.stack([p, p * 0.97, p * 0.9], -1), 0, 1)

    # column stone with vertical striations
    c = 0.62 + 0.08 * np.sin(x * 60) * 0.5 + 0.12 * (_noise(rng, n) - 0.5)
    tex["column"] = np.clip(np.stack([c, c * 0.98, c * 0.93], -1), 0, 1)

    # fabrics: weave + stripes, three hues
    weave = 0.8 + 0.2 * np.sin(x * n * 0.7) * np.sin(y * n * 0.7)
    stripes = 1.0 - 0.35 * (np.floor(y * 8) % 2)
    for name, tint in (("fabric_red", (0.6, 0.08, 0.08)),
                       ("fabric_green", (0.10, 0.42, 0.12)),
                       ("fabric_blue", (0.10, 0.16, 0.50))):
        f = weave * stripes
        tex[name] = np.clip(np.stack([f * tint[0], f * tint[1],
                                      f * tint[2]], -1), 0, 1)

    # banner with emblem rings
    d = np.sqrt((x - 0.5) ** 2 + (y - 0.4) ** 2)
    ring = (np.abs(d - 0.22) < 0.03) | (np.abs(d - 0.12) < 0.02)
    bb = np.stack([np.full_like(d, 0.45), np.full_like(d, 0.32),
                   np.full_like(d, 0.12)], -1)
    bb[ring] = (0.85, 0.72, 0.25)
    tex["banner"] = np.clip(bb * weave[..., None], 0, 1)
    return tex


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

MTL: Dict[str, dict] = {
    "floor": dict(Kd=(1, 1, 1), map_Kd="stone_floor", Ns=30),
    "wall": dict(Kd=(1, 1, 1), map_Kd="brick", Ns=10),
    "plaster": dict(Kd=(1, 1, 1), map_Kd="plaster", Ns=10),
    "column": dict(Kd=(1, 1, 1), map_Kd="column", Ns=40),
    "trim": dict(Kd=(0.95, 0.75, 0.35), Ns=900, Pm=1.0),
    "curtain_r": dict(Kd=(1, 1, 1), map_Kd="fabric_red", Ns=5),
    "curtain_g": dict(Kd=(1, 1, 1), map_Kd="fabric_green", Ns=5),
    "curtain_b": dict(Kd=(1, 1, 1), map_Kd="fabric_blue", Ns=5),
    "banner": dict(Kd=(1, 1, 1), map_Kd="banner", Ns=5),
    "pot": dict(Kd=(0.35, 0.22, 0.12), Ns=60),
    "lamp": dict(Kd=(0, 0, 0), Ke=(14.0, 11.0, 7.0)),
}


def build(detail: float = 1.0) -> Geo:
    """Two-story arcaded atrium, ~55k tris at detail=1 (cloth-dominated —
    detail scales cloth/curve tessellation roughly quadratically)."""
    g = Geo()
    W, D, H = 24.0, 12.0, 10.5       # outer extents
    t = 0.4                          # wall thickness
    segs = max(int(8 * detail), 6)
    csegs = max(int(14 * detail), 8)

    # floor + outer walls (inner faces carry brick, cap with plaster tops)
    box(g, (-W / 2, -0.3, -D / 2), (W / 2, 0.0, D / 2), "floor", 0.25)
    for (lo, hi) in (((-W / 2, 0, -D / 2 - t), (W / 2, H, -D / 2)),
                     ((-W / 2, 0, D / 2), (W / 2, H, D / 2 + t)),
                     ((-W / 2 - t, 0, -D / 2 - t), (-W / 2, H, D / 2 + t)),
                     ((W / 2, 0, -D / 2 - t), (W / 2 + t, H, D / 2 + t))):
        box(g, lo, hi, "wall", 0.35)

    # two arcade levels along both long sides
    n_bay = 7
    bay = W / n_bay
    for level, (y0, y1) in enumerate(((0.0, 4.2), (4.8, 8.4))):
        col_h = y1 - y0 - 1.2
        r_arch = bay * 0.32
        for zs in (-D / 2 + 2.2, D / 2 - 2.2):
            for i in range(n_bay + 1):
                x = -W / 2 + i * bay
                cylinder(g, (x, zs), 0.28, y0, y0 + col_h, csegs,
                         "column", ribs=0.12)
                box(g, (x - 0.42, y0 + col_h, zs - 0.42),
                    (x + 0.42, y0 + col_h + 0.35, zs + 0.42), "trim", 1.0)
                box(g, (x - 0.36, y0 - 0.001, zs - 0.36),
                    (x + 0.36, y0 + 0.18, zs + 0.36), "column", 1.0)
            for i in range(n_bay):
                x0 = -W / 2 + i * bay + 0.28
                x1 = -W / 2 + (i + 1) * bay - 0.28
                arch_panel(g, x0, x1, y0 + col_h - r_arch * 0.6,
                           y0 + col_h + 1.2, zs - 0.18, 0.36, r_arch,
                           "plaster", segs=segs)
        # entablature band across each side
        for zs in (-D / 2 + 2.2, D / 2 - 2.2):
            box(g, (-W / 2, y1 - 0.35, zs - 0.5),
                (W / 2, y1, zs + 0.5), "plaster", 0.4)

    # walkway slabs behind the second-floor arcade
    for zs in ((-D / 2, -D / 2 + 2.2), (D / 2 - 2.2, D / 2)):
        box(g, (-W / 2, 4.2, zs[0]), (W / 2, 4.8, zs[1]), "floor", 0.3)

    # curtains between ground columns (alternating hues)
    cseq = ["curtain_r", "curtain_g", "curtain_b"]
    csegs2 = max(int(24 * detail), 10)
    for side, zs in ((0, -D / 2 + 2.0), (1, D / 2 - 2.0)):
        for i in range(1, n_bay, 2):
            x0 = -W / 2 + i * bay + 0.35
            x1 = -W / 2 + (i + 1) * bay - 0.35
            cloth(g, x0, x1, 0.4, 3.4, zs, cseq[(i + side) % 3],
                  csegs2, wave=0.18 if side else 0.22, sag=0.25)

    # banners hanging from the second floor into the atrium
    for i in range(2, n_bay, 2):
        x = -W / 2 + i * bay
        for zs in (-D / 2 + 2.6, D / 2 - 2.6):
            cloth(g, x - 0.7, x + 0.7, 2.2, 7.6, zs, "banner",
                  max(int(16 * detail), 8), wave=0.08, sag=0.12)

    # pots along the atrium edge + lamps
    for i in range(n_bay):
        x = -W / 2 + (i + 0.5) * bay
        pot(g, (x, -D / 2 + 3.2), 0.9, "pot", segs=csegs)
        pot(g, (x, D / 2 - 3.2), 0.9, "pot", segs=csegs)
    for i in range(1, n_bay, 2):
        x = -W / 2 + i * bay
        for zs in (-D / 2 + 2.2, D / 2 - 2.2):
            box(g, (x - 0.18, 3.6, zs - 0.18), (x + 0.18, 3.9, zs + 0.18),
                "lamp", 1.0)
    return g


# ---------------------------------------------------------------------------
# OBJ/MTL/PNG export + load
# ---------------------------------------------------------------------------


def export(dir_: str, detail: float = 1.0) -> str:
    """Write sponza_like.obj + .mtl + textures/*.png; returns the obj
    path. Deterministic for a given detail."""
    from truetrace_tpu_torch.scene.png import write_png

    os.makedirs(os.path.join(dir_, "textures"), exist_ok=True)
    g = build(detail)
    obj_path = os.path.join(dir_, "sponza_like.obj")

    for name, img in make_textures().items():
        write_png(os.path.join(dir_, "textures", f"{name}.png"),
                  (img * 255).astype(np.uint8))

    with open(os.path.join(dir_, "sponza_like.mtl"), "w") as f:
        for name, m in MTL.items():
            f.write(f"newmtl {name}\n")
            kd = m.get("Kd", (0.8, 0.8, 0.8))
            f.write(f"Kd {kd[0]} {kd[1]} {kd[2]}\n")
            if "Ke" in m:
                ke = m["Ke"]
                f.write(f"Ke {ke[0]} {ke[1]} {ke[2]}\n")
            f.write(f"Ns {m.get('Ns', 10)}\n")
            if "Pm" in m:
                f.write(f"Pm {m['Pm']}\n")
            if "map_Kd" in m:
                f.write(f"map_Kd textures/{m['map_Kd']}.png\n")
            f.write("\n")

    with open(obj_path, "w") as f:
        f.write("mtllib sponza_like.mtl\n")
        for arr, tag in ((g.v, "v"), (g.vt, "vt"), (g.vn, "vn")):
            for block in arr:
                np.savetxt(f, block, fmt=f"{tag} %.5g %.5g %.5g"
                           if tag != "vt" else f"{tag} %.5g %.5g")
        cur = None
        for idx, mat in g.f:
            if mat != cur:
                f.write(f"usemtl {mat}\n")
                cur = mat
            rows = idx.reshape(idx.shape[0], 9)
            np.savetxt(f, rows, fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return obj_path


def make(detail: float = 1.0, assets_dir: str = None, device="cuda"):
    """Export-if-missing + load through the OBJ pipeline; the camera and
    the sky (bench.py's: sun 900) live on `device`. Returns (meshes,
    mats, atlas, rects, level_y, cam, env)."""
    from truetrace_tpu_torch.build.env_cdf import (
        build_env_cdf, procedural_sky)
    from truetrace_tpu_torch.scene.ir import Camera
    from truetrace_tpu_torch.scene.obj_loader import load_obj_scene

    if assets_dir is None:
        assets_dir = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "examples", "assets", f"sponza_like_d{detail:g}")
    obj_path = os.path.join(assets_dir, "sponza_like.obj")
    if not os.path.exists(obj_path):
        export(assets_dir, detail)
    meshes, mats, atlas, rects, level_y = load_obj_scene(obj_path)

    cam = Camera.look_at(eye=(-9.5, 2.1, 0.0), target=(6.0, 3.2, -0.5),
                         fov_y_deg=55, device=device)
    env = build_env_cdf(procedural_sky(sun_dir=(0.3, 0.85, 0.44),
                                       sun_intensity=900.0), device=device)
    return meshes, mats, atlas, rects, level_y, cam, env
