"""Procedural Sponza-class benchmark scene ("atrium").

The reference benchmarks on Crytek Sponza (README.md:270-290); its geometry
is not shipped in the repo, so the Mrays/s benchmark here uses a procedural
atrium with the same workload character: ~250k triangles, two-story
colonnade hall with fluted columns, arches, draped curtains, clutter
objects, heavy occlusion, a sun-like directional env + emissive ceiling
panels. Tessellation scales with `detail` so the same generator serves
quick tests (detail=0.25) and the full benchmark (detail=1.0).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from truetrace_tpu_torch.scene.ir import Camera, EnvMap
from truetrace_tpu_torch.scene.mesh import HostMaterial, HostMesh
from truetrace_tpu_torch.scene import primitives as prim

# hall dimensions (meters)
HALL_L = 30.0   # x
HALL_W = 12.0   # z
HALL_H = 12.0   # y

M_FLOOR, M_WALL, M_COLUMN, M_CURTAIN_R, M_CURTAIN_G, M_POT, M_GOLD, \
    M_LIGHT = range(8)


def materials() -> List[HostMaterial]:
    return [
        HostMaterial(base_color=(0.55, 0.50, 0.45), roughness=0.35,
                     specular=0.6),                       # stone floor
        HostMaterial(base_color=(0.65, 0.60, 0.52), roughness=0.8),  # walls
        HostMaterial(base_color=(0.70, 0.66, 0.58), roughness=0.6),  # columns
        HostMaterial(base_color=(0.55, 0.08, 0.08), roughness=0.9,
                     sheen=0.5),                          # red curtain
        HostMaterial(base_color=(0.10, 0.35, 0.12), roughness=0.9,
                     sheen=0.5),                          # green curtain
        HostMaterial(base_color=(0.35, 0.22, 0.12), roughness=0.5),  # pots
        HostMaterial(base_color=(0.95, 0.75, 0.35), metallic=1.0,
                     roughness=0.25),                     # gold trim
        HostMaterial(base_color=(0.0, 0.0, 0.0),
                     emission=(40.0, 38.0, 34.0)),        # ceiling panels
    ]


def make(detail: float = 1.0, device="cuda",
         ) -> Tuple[List[HostMesh], List[HostMaterial], Camera, EnvMap]:
    """Build the atrium; the camera and env live on `device`. Returns
    (meshes, materials, camera, env)."""
    d = detail
    rs = np.random.default_rng(42)
    verts_list, idx_list, mat_list = [], [], []
    off = 0

    def add(verts, idx, mat_id):
        nonlocal off
        verts_list.append(verts.astype(np.float32))
        idx_list.append(np.asarray(idx, np.int32) + off)
        mat_list.append(np.full(len(idx), mat_id, np.int32))
        off += len(verts)

    def gi(n):
        return max(2, int(round(n * d)))

    # ---- floor (rough displaced stone grid) and ceiling
    v, i, _ = prim.grid(gi(96), gi(48), HALL_L, HALL_W,
                        height_fn=lambda x, z: 0.01 * np.sin(7 * x)
                        * np.cos(9 * z))
    add(v, i, M_FLOOR)
    v, i, _ = prim.grid(gi(48), gi(24), HALL_L, HALL_W)
    add(prim.transform(v, translate=(0, HALL_H, 0))[:, [0, 1, 2]]
        * np.array([1, 1, 1], np.float32), i[:, ::-1], M_WALL)  # flip to face down

    # ---- long walls (subdivided, slightly wavy plaster) as vertical grids
    for zside in (-1, 1):
        v, i, _ = prim.grid(gi(96), gi(36), HALL_L, HALL_H)
        # rotate plane XZ->XY: swap y/z
        v2 = v[:, [0, 2, 1]].copy()
        v2[:, 1] += HALL_H / 2
        v2[:, 2] = zside * HALL_W / 2
        add(v2, i if zside > 0 else i[:, ::-1], M_WALL)
    # ---- end walls
    for xside in (-1, 1):
        v, i, _ = prim.grid(gi(36), gi(36), HALL_W, HALL_H)
        v2 = v[:, [2, 0, 1]].copy()   # place in YZ plane
        v2 = np.stack([np.full(len(v), xside * HALL_L / 2, np.float32),
                       v[:, 2] + HALL_H / 2, v[:, 0]], axis=-1)
        add(v2, i if xside < 0 else i[:, ::-1], M_WALL)

    # ---- two-story colonnade: two rows of fluted columns, two levels
    n_cols = 8
    col_r = 0.45
    xs = np.linspace(-HALL_L / 2 + 2.5, HALL_L / 2 - 2.5, n_cols)
    for level, (y0, h) in enumerate([(0.0, 5.0), (6.0, 4.5)]):
        for zrow in (-HALL_W / 2 + 1.8, HALL_W / 2 - 1.8):
            for x in xs:
                v, i, _ = prim.cylinder(gi(28), gi(10), col_r, h,
                                        flutes=16, flute_depth=0.08)
                add(prim.transform(v, translate=(x, y0, zrow)), i, M_COLUMN)
                # capital + base (gold torus rings)
                for y_ring in (y0 + 0.1, y0 + h - 0.1):
                    v, i, _ = prim.torus(gi(24), gi(8), col_r * 1.15, 0.08)
                    add(prim.transform(v, translate=(x, y_ring, zrow)), i,
                        M_GOLD)

    # ---- architrave beams between columns (second floor slab edges)
    for zrow in (-HALL_W / 2 + 1.8, HALL_W / 2 - 1.8):
        v, i, _ = prim.grid(gi(96), gi(6), HALL_L - 4.0, 1.2)
        add(prim.transform(v, translate=(0, 5.6, zrow)), i, M_WALL)

    # ---- arches between upper columns
    for zrow in (-HALL_W / 2 + 1.8, HALL_W / 2 - 1.8):
        for k in range(n_cols - 1):
            xm = 0.5 * (xs[k] + xs[k + 1])
            span = (xs[k + 1] - xs[k]) * 0.5
            v, i, _ = prim.torus(gi(20), gi(8), span, 0.12, arc=np.pi)
            # arc in XY plane: rotate torus (default around y) -> stand up
            v2 = v[:, [0, 2, 1]].copy()
            add(prim.transform(v2, translate=(xm, 10.5, zrow)), i, M_WALL)

    # ---- curtains: displaced cloth grids hanging between upper columns
    for k in range(n_cols - 1):
        for zrow, mat in ((-HALL_W / 2 + 1.2, M_CURTAIN_R),
                          (HALL_W / 2 - 1.2, M_CURTAIN_G)):
            if rs.uniform() < 0.4:
                continue
            xm = 0.5 * (xs[k] + xs[k + 1])
            wave = rs.uniform(3.0, 8.0)
            v, i, _ = prim.grid(
                gi(30), gi(24), 2.6, 3.4,
                height_fn=lambda x, z, w=wave: 0.12 * np.sin(w * x + 2 * z))
            v2 = v[:, [0, 2, 1]].copy()   # vertical: grid y->world y
            v2 = np.stack([v[:, 0], v[:, 2] + 8.0,
                           v[:, 1] + zrow], axis=-1)
            add(prim.transform(v2, translate=(xm, 0, 0)), i, mat)

    # ---- clutter: pots (spheres) and boxes on the floor
    for _ in range(int(40 * max(d, 0.2))):
        x = rs.uniform(-HALL_L / 2 + 2, HALL_L / 2 - 2)
        z = rs.uniform(-HALL_W / 2 + 2, HALL_W / 2 - 2)
        r = rs.uniform(0.2, 0.5)
        v, i, _ = prim.uv_sphere(gi(14), gi(20), r)
        add(prim.transform(v, translate=(x, r, z)), i,
            M_POT if rs.uniform() < 0.7 else M_GOLD)

    # ---- emissive ceiling panels
    for x in np.linspace(-HALL_L / 2 + 4, HALL_L / 2 - 4, 5):
        v, i, _ = prim.grid(2, 2, 2.0, 1.5)
        add(prim.transform(v, translate=(x, HALL_H - 0.05, 0)), i[:, ::-1],
            M_LIGHT)

    mesh = HostMesh(positions=np.concatenate(verts_list),
                    indices=np.concatenate(idx_list),
                    mat_id=np.concatenate(mat_list))

    cam = Camera.look_at(eye=(-HALL_L / 2 + 2.0, 2.0, 0.0),
                         target=(HALL_L / 2, 4.5, 0.0), fov_y_deg=55.0,
                         device=device)
    env = EnvMap.constant((0.4, 0.55, 0.8), device)   # sky, open ends
    return [mesh], materials(), cam, env
