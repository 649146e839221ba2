"""Texture atlas: host-side packing (numpy) + sampling (torch), with mips.

Port of `truetrace_tpu/scene/atlas.py` (the reference's
AssetManager.CreateAtlas, AssetManager.cs:396-533, and its rect UV
transform, CommonData.cginc:569-591): one shelf-packed RGBA f32 atlas per
scene, no BCn compression.

Mip chain: every rect is 16-aligned, so levels 1..3 are exact 2x2-average
downscales of the whole atlas with rect coordinates shifted right. The
chain is stacked below level 0 in one image; `level_y[k]` is each level's
row origin. The integrator picks the level from its ray cones.

Sampling: wrap-repeat inside the texture's rect, bilinear taps, nearest
mip by round(lod) (half to even in both frameworks). Float `%` is
floor-mod (`torch.remainder`), as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

ALIGN = 16          # rect alignment; supports 4 clean mip levels
N_MIPS = 4


def _pad_align(img: np.ndarray) -> np.ndarray:
    """Edge-clamp pad H/W up to multiples of ALIGN (keeps mips bleed-free)."""
    h, w = img.shape[:2]
    ph = (-h) % ALIGN
    pw = (-w) % ALIGN
    if ph or pw:
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
    return img


@dataclass
class AtlasBuilder:
    """Shelf packer: add [H,W,C] uint8/float images, then build()."""
    max_width: int = 4096
    images: List[np.ndarray] = field(default_factory=list)

    def add(self, img: np.ndarray) -> int:
        """Returns the texture id."""
        if img.ndim == 2:
            img = img[..., None]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        if img.shape[-1] == 1:
            # grayscale -> RGB + opaque alpha (alpha feeds the cutout
            # path; replicating the value would punch holes)
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate(
                [img, np.ones_like(img[..., :1])], axis=-1)
        self.images.append(_pad_align(img.astype(np.float32)))
        return len(self.images) - 1

    def build(self, mips: int = N_MIPS
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (atlas [AHm,AW,4] f32 with the mip chain stacked below
        level 0, rects [N,4] i32 (x,y,w,h in level-0 texels),
        level_y [mips] i32 row origins)."""
        if not self.images:
            return (np.zeros((1, 1, 4), np.float32),
                    np.zeros((0, 4), np.int32),
                    np.zeros((max(mips, 1),), np.int32))
        order = sorted(range(len(self.images)),
                       key=lambda i: -self.images[i].shape[0])
        rects = np.zeros((len(self.images), 4), np.int32)
        shelf_y = 0
        shelf_h = 0
        x = 0
        aw = min(self.max_width,
                 max(int(np.ceil(np.sqrt(
                     sum(im.shape[0] * im.shape[1]
                         for im in self.images)))),
                     max(im.shape[1] for im in self.images)))
        aw = aw + ((-aw) % ALIGN)
        for i in order:
            h, w = self.images[i].shape[:2]
            if x + w > aw:
                shelf_y += shelf_h
                shelf_h = 0
                x = 0
            rects[i] = (x, shelf_y, w, h)
            shelf_h = max(shelf_h, h)
            x += w
        ah = shelf_y + shelf_h
        ah = ah + ((-ah) % ALIGN)
        level0 = np.zeros((ah, aw, 4), np.float32)
        for i, im in enumerate(self.images):
            rx, ry, w, h = rects[i]
            level0[ry:ry + h, rx:rx + w] = im

        # stacked mip chain (2x2 box filter per level)
        levels = [level0]
        for _ in range(1, mips):
            prev = levels[-1]
            hh, ww = prev.shape[0] // 2, prev.shape[1] // 2
            if hh < 1 or ww < 1:
                break
            down = prev[:hh * 2, :ww * 2].reshape(hh, 2, ww, 2, 4
                                                  ).mean(axis=(1, 3))
            levels.append(down.astype(np.float32))
        level_y = np.zeros((len(levels),), np.int32)
        y = 0
        padded = []
        for k, lv in enumerate(levels):
            level_y[k] = y
            row = np.zeros((lv.shape[0], aw, 4), np.float32)
            row[:, :lv.shape[1]] = lv
            padded.append(row)
            y += lv.shape[0]
        return np.concatenate(padded, axis=0), rects, level_y


def transform_uv(uv, scale_offset, rot):
    """Per-material UV transform (reference AlignUV,
    CommonData.cginc:569-591): uv' = uv * scale.xy + offset.zw, then,
    where rot != 0, wrapped, rotated by `rot` radians about (0.5, 0.5)
    and re-wrapped. uv [R,2]; scale_offset [R,4] (sx, sy, ox, oy); rot
    [R] radians. Identity rows pass uv through (sample_atlas wraps)."""
    out = uv * scale_offset[:, 0:2] + scale_offset[:, 2:4]
    s = torch.sin(rot)[:, None]
    c = torch.cos(rot)[:, None]
    w = torch.remainder(out, 1.0) - 0.5
    rot_uv = torch.cat([w[:, 0:1] * c - w[:, 1:2] * s,
                        w[:, 0:1] * s + w[:, 1:2] * c], dim=1) + 0.5
    return torch.where((rot != 0.0)[:, None], torch.remainder(rot_uv, 1.0),
                       out)


def sample_atlas(atlas, rects, tex_id, uv, bilinear: bool = True,
                 lod=None, level_y: Optional[torch.Tensor] = None):
    """Sample texture `tex_id` [R] at uv [R,2] (wrap-repeat). Returns
    [R,4]; lanes with tex_id < 0 read texture 0 (callers select).

    lod: optional [R] mip level (float; the nearest level is used).
    Needs `level_y` from AtlasBuilder.build; None = level 0."""
    safe_id = torch.clamp(tex_id, min=0)
    r = rects[safe_id]                       # [R,4] x,y,w,h (level 0)
    if lod is not None and level_y is not None and level_y.shape[0] > 1:
        M = level_y.shape[0]
        # clamp the rounded level as a float: NaN -> 0 and +-inf -> the
        # end levels, as XLA's saturating f32 -> int conversion gives
        k = torch.clamp(torch.nan_to_num(torch.round(lod), nan=0.0),
                        0, M - 1).to(torch.int64)
        rx = r[:, 0] >> k
        ry = (r[:, 1] >> k) + level_y[k]
        rw = torch.clamp(r[:, 2] >> k, min=1)
        rh = torch.clamp(r[:, 3] >> k, min=1)
    else:
        rx, ry = r[:, 0], r[:, 1]
        rw = torch.clamp(r[:, 2], min=1)
        rh = torch.clamp(r[:, 3], min=1)
    w = rw.to(torch.float32)
    h = rh.to(torch.float32)
    u = torch.remainder(uv[:, 0], 1.0) * w
    v = torch.remainder(uv[:, 1], 1.0) * h
    AH, AW = atlas.shape[0], atlas.shape[1]

    def fetch(xi, yi):
        x = rx + torch.remainder(xi, rw)
        y = ry + torch.remainder(yi, rh)
        return atlas[torch.clamp(y, 0, AH - 1), torch.clamp(x, 0, AW - 1)]

    if not bilinear:
        return fetch(u.to(torch.int64), v.to(torch.int64))
    x0 = torch.floor(u - 0.5)
    y0 = torch.floor(v - 0.5)
    fx = (u - 0.5 - x0)[:, None]
    fy = (v - 0.5 - y0)[:, None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    c00 = fetch(x0i, y0i)
    c10 = fetch(x0i + 1, y0i)
    c01 = fetch(x0i, y0i + 1)
    c11 = fetch(x0i + 1, y0i + 1)
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)
