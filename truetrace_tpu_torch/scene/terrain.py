"""Terrain heightfields: a regular-grid heightmap with an up-to-4-layer
alphamap choosing between layer materials.

Port of `truetrace_tpu/scene/terrain.py`. `Terrain` is a plain dataclass
(a flax struct there): the height grid lies flat [Hm*Wm] so a texel fetch
is one gather, the alphamap stays [A,A,4]. Its shape and placement (the
grid shape, the origin, the extent and the top of its box) are also kept
as Python numbers fixed at build time, so the march's loop bounds and
constants never read the card back (ROADMAP.md §C.1). `height_top`, the
grid's block maxima by level (kernels/heightmap.py `height_top`, whose
layout kernels/csrc/heightmap.cu reads), is built with the terrain: the
march kernel skips the steps it proves lie above them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from truetrace_tpu_torch.kernels.heightmap import height_top


@dataclass
class Terrain:
    """One heightfield. `height_top` is derived from `height` and must be
    rebuilt (kernels/heightmap.py `height_top`) wherever `height`
    changes: a stale table lets the march kernel skip steps that cross
    the new surface."""
    height: torch.Tensor      # [Hm*Wm] f32 world-space heights (y)
    hm_shape: tuple           # (Hm, Wm)
    origin: torch.Tensor      # [3] world min corner (x, y_base, z)
    size: torch.Tensor        # [2] world extent in x, z
    h_max: torch.Tensor       # [] max height above origin.y (box top)
    alphamap: torch.Tensor    # [A,A,4] layer weights
    mat_ids: torch.Tensor     # [4] int64 material rows, -1 = unused
    height_top: torch.Tensor  # the grid's block maxima, from height

    # the placement as float32 values in Python floats, fixed at build
    # time: (origin x, y, z, size x, z, h_max)
    consts: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.height.device

    @staticmethod
    def from_numpy(d: dict, device) -> "Terrain":
        """Terrain from the JAX Terrain's leaves (numpy arrays keyed by
        field name; hm_shape as a pair)."""
        t = lambda k, dt=None: torch.from_numpy(np.array(
            d[k], dt)).to(device)
        f32 = lambda k: [float(v) for v in np.asarray(d[k], np.float32)
                         .reshape(-1)]
        hm_shape = tuple(int(v) for v in np.asarray(d["hm_shape"]))
        height = t("height", np.float32)
        return Terrain(height=height, hm_shape=hm_shape,
                       origin=t("origin", np.float32),
                       size=t("size", np.float32),
                       h_max=t("h_max", np.float32),
                       alphamap=t("alphamap", np.float32),
                       mat_ids=t("mat_ids", np.int64),
                       height_top=height_top(height, *hm_shape),
                       consts=tuple(f32("origin") + f32("size")
                                    + f32("h_max")))

    def to(self, device) -> "Terrain":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if f.name not in ("hm_shape", "consts")})


def make_terrain(heightmap: np.ndarray, origin, size_xz,
                 mat_ids: Sequence[int], alphamap: np.ndarray | None = None,
                 height_scale: float = 1.0, device="cuda") -> Terrain:
    """A Terrain on `device` (the card unless the caller asks for the
    CPU) from a [Hm,Wm] heightmap: heights * height_scale are world y
    offsets above origin[1]."""
    hm = np.asarray(heightmap, np.float32) * float(height_scale)
    Hm, Wm = hm.shape
    if alphamap is None:
        alphamap = np.zeros((2, 2, 4), np.float32)
        alphamap[..., 0] = 1.0
    ids = np.full((4,), -1, np.int32)
    ids[:len(mat_ids)] = np.asarray(list(mat_ids), np.int32)
    org = np.asarray(origin, np.float32)
    return Terrain.from_numpy(dict(
        height=(hm + org[1]).reshape(-1), hm_shape=(Hm, Wm), origin=org,
        size=np.asarray(size_xz, np.float32),
        h_max=np.float32(float(hm.max()) + 1e-3),
        alphamap=np.asarray(alphamap, np.float32), mat_ids=ids), device)


def demo_hills(n: int = 129, seed: int = 0) -> np.ndarray:
    """Procedural fractal hills in [0, 1] for tests and demos."""
    rng = np.random.default_rng(seed)
    h = np.zeros((n, n), np.float32)
    freq, amp = 1.5, 1.0
    xs = np.linspace(0, 1, n)
    X, Z = np.meshgrid(xs, xs, indexing="ij")
    for _ in range(4):
        ph = rng.uniform(0, 2 * np.pi, 4)
        h += amp * (np.sin(2 * np.pi * freq * X + ph[0])
                    * np.sin(2 * np.pi * freq * Z + ph[1])
                    + 0.5 * np.cos(2 * np.pi * freq * (X + Z) + ph[2]))
        freq *= 2.1
        amp *= 0.45
    h -= h.min()
    return (h / max(h.max(), 1e-6)).astype(np.float32)


def scatter_on_terrain(heightmap: np.ndarray, origin, size_xz,
                       height_scale: float = 1.0, n: int = 64,
                       source_id: int = 0, seed: int = 0,
                       max_slope: float = 0.6,
                       scale_range=(0.8, 1.3)) -> list:
    """Instance transforms scattered over a heightfield: rejection-sampled
    uniform xz positions on the bilinear terrain height, slopes above
    `max_slope` (rise per unit run) skipped, random yaw and scale. Returns
    (source_id, l2w 4x4) pairs for compile_scene_instanced."""
    from truetrace_tpu_torch.scene.instances import make_transform
    hm = np.asarray(heightmap, np.float64) * float(height_scale)
    Hm, Wm = hm.shape
    org = np.asarray(origin, np.float64)
    sx, sz = float(size_xz[0]), float(size_xz[1])
    rng = np.random.default_rng(seed)
    out = []
    tries = 0
    while len(out) < n and tries < 20 * n:
        tries += 1
        u, v = rng.random(2)
        fx = u * (Wm - 1)
        fz = v * (Hm - 1)
        x0 = min(int(fx), Wm - 2)
        z0 = min(int(fz), Hm - 2)
        tx = fx - x0
        tz = fz - z0
        h = ((1 - tx) * (1 - tz) * hm[z0, x0]
             + tx * (1 - tz) * hm[z0, x0 + 1]
             + (1 - tx) * tz * hm[z0 + 1, x0]
             + tx * tz * hm[z0 + 1, x0 + 1])
        dhdx = (hm[z0, x0 + 1] - hm[z0, x0]) / (sx / (Wm - 1))
        dhdz = (hm[z0 + 1, x0] - hm[z0, x0]) / (sz / (Hm - 1))
        if np.hypot(dhdx, dhdz) > max_slope:
            continue
        pos = (org[0] + u * sx, org[1] + h, org[2] + v * sz)
        s = rng.uniform(*scale_range)
        out.append((source_id,
                    make_transform(translate=pos,
                                   rot_y=rng.uniform(0, 2 * np.pi),
                                   scale=s)))
    return out
