"""Procedural mesh primitives (host-side numpy): grids, cylinders, spheres,
tori, boxes. Used by test scenes and the Sponza-class benchmark atrium."""
from __future__ import annotations

import numpy as np


def grid(nx: int, nz: int, size_x=1.0, size_z=1.0,
         height_fn=None):
    """Subdivided XZ plane centered at origin, +y normal.
    height_fn(x, z) -> y displacement (vectorized) or None."""
    xs = np.linspace(-size_x / 2, size_x / 2, nx + 1, dtype=np.float32)
    zs = np.linspace(-size_z / 2, size_z / 2, nz + 1, dtype=np.float32)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = height_fn(X, Z).astype(np.float32) if height_fn else np.zeros_like(X)
    verts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    idx = []
    for i in range(nx):
        for j in range(nz):
            a = i * (nz + 1) + j
            b = (i + 1) * (nz + 1) + j
            # winding chosen so cross(e1, e2) = +y
            idx.append([a, b + 1, b])
            idx.append([a, a + 1, b + 1])
    uv = np.stack([(X + size_x / 2) / size_x, (Z + size_z / 2) / size_z],
                  axis=-1).reshape(-1, 2).astype(np.float32)
    return verts, np.asarray(idx, np.int32), uv


def cylinder(n_radial: int = 24, n_height: int = 8, radius=0.5, height=1.0,
             flutes: int = 0, flute_depth=0.0, cap=True):
    """Y-axis cylinder from y=0..height; optional column fluting."""
    th = np.linspace(0, 2 * np.pi, n_radial, endpoint=False)
    ys = np.linspace(0, height, n_height + 1, dtype=np.float32)
    r = radius * (1.0 + flute_depth * np.cos(flutes * th)) if flutes \
        else np.full_like(th, radius)
    ring = np.stack([r * np.cos(th), np.zeros_like(th), r * np.sin(th)],
                    axis=-1).astype(np.float32)
    verts = np.concatenate([ring + np.array([0, y, 0], np.float32)
                            for y in ys])
    idx = []
    for j in range(n_height):
        for i in range(n_radial):
            a = j * n_radial + i
            b = j * n_radial + (i + 1) % n_radial
            c = a + n_radial
            d = b + n_radial
            idx.append([a, c, b])
            idx.append([b, c, d])
    if cap:
        base = len(verts)
        verts = np.concatenate(
            [verts, np.array([[0, 0, 0], [0, height, 0]], np.float32)])
        for i in range(n_radial):
            b = (i + 1) % n_radial
            idx.append([base, i, b])                       # bottom
            top = n_height * n_radial
            idx.append([base + 1, top + b, top + i])        # top
    return verts, np.asarray(idx, np.int32), None


def uv_sphere(n_lat: int = 12, n_lon: int = 18, radius=0.5):
    verts = []
    for i in range(n_lat + 1):
        phi = np.pi * i / n_lat
        for j in range(n_lon):
            th = 2 * np.pi * j / n_lon
            verts.append([radius * np.sin(phi) * np.cos(th),
                          radius * np.cos(phi),
                          radius * np.sin(phi) * np.sin(th)])
    verts = np.asarray(verts, np.float32)
    idx = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = a + n_lon
            d = b + n_lon
            if i > 0:
                idx.append([a, c, b])
            if i < n_lat - 1:
                idx.append([b, c, d])
    return verts, np.asarray(idx, np.int32), None


def torus(n_major: int = 24, n_minor: int = 12, R=1.0, r=0.2,
          arc=2 * np.pi):
    """Torus (or arc segment) around the y axis."""
    verts = []
    closed = abs(arc - 2 * np.pi) < 1e-6
    n_maj = n_major if closed else n_major + 1
    for i in range(n_maj):
        a = arc * i / n_major
        cx, cz = np.cos(a), np.sin(a)
        for j in range(n_minor):
            b = 2 * np.pi * j / n_minor
            x = (R + r * np.cos(b)) * cx
            z = (R + r * np.cos(b)) * cz
            y = r * np.sin(b)
            verts.append([x, y, z])
    verts = np.asarray(verts, np.float32)
    idx = []
    n_seg = n_major if closed else n_major
    for i in range(n_major if closed else n_major):
        i2 = (i + 1) % n_maj if closed else i + 1
        for j in range(n_minor):
            j2 = (j + 1) % n_minor
            a = i * n_minor + j
            b = i * n_minor + j2
            c = i2 * n_minor + j
            d = i2 * n_minor + j2
            idx.append([a, c, b])
            idx.append([b, c, d])
    return verts, np.asarray(idx, np.int32), None


def transform(verts: np.ndarray, scale=1.0, rot_y=0.0, translate=(0, 0, 0)):
    v = verts * np.asarray(scale, np.float32)
    if rot_y:
        c, s = np.cos(rot_y), np.sin(rot_y)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        v = v @ rot.T
    return v + np.asarray(translate, np.float32)
