"""Texture downscale: Pillow's bicubic `Image.resize` on RGBA, in numpy.

The JAX package halves a texture wider than `max_tex` with
`Image.open(p).convert("RGBA").resize((w // 2, h // 2))` until it fits.
The card's machine has no Pillow, so the port carries the same arithmetic,
bit for bit (tests/test_torch_sources.py holds it against Pillow):

* RGBA is resized premultiplied: each colour becomes `c * a / 255` rounded
  as Pillow's MULDIV255, and comes back as `min(255 * c // a, 255)`
  (alpha 0 and 255 pass unchanged).
* The filter is the cubic with a = -0.5, its support scaled by the
  downscale factor. Each output sample's taps are normalised in double,
  then rounded to 22-bit fixed point away from zero.
* The horizontal pass runs first and is clipped to 8 bits; then the
  vertical pass, clipped again.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 22        # Pillow's 8-bit resampling precision


def _cubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a,
                             0.0))


def _coeffs(in_size: int, out_size: int):
    """Per output sample: first tap (xmin [O]) and fixed-point taps
    [O, ksize] (zero past each sample's last tap)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5),
                      in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    x = (taps[None, :] + xmin[:, None] - center[:, None] + 0.5) \
        * (1.0 / filterscale)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, _cubic(x), 0.0)
    # the taps are summed in order, as the C loop does
    ww = np.zeros(out_size)
    for j in range(ksize):
        ww = ww + w[:, j]
    w = w / np.where(ww == 0.0, 1.0, ww)[:, None]
    fx = w * float(1 << PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, fx - 0.5, fx + 0.5)).astype(np.int64)
    return xmin, kk


def _clip8(ss: np.ndarray) -> np.ndarray:
    return np.clip(ss >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 1-D resampling pass along `axis` (1 = columns, 0 = rows) of an
    [H, W, C] uint8 image."""
    in_size = img.shape[axis]
    xmin, kk = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)      # [in, n, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for j in range(kk.shape[1]):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += src[idx] * kk[:, j][:, None, None]
    return np.moveaxis(_clip8(acc), 0, axis)


def _premultiply(img: np.ndarray) -> np.ndarray:
    a = img[..., 3:].astype(np.uint32)
    tmp = img[..., :3].astype(np.uint32) * a + 128
    rgb = ((tmp >> 8) + tmp) >> 8
    return np.concatenate([rgb.astype(np.uint8), img[..., 3:]], -1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    a = img[..., 3:].astype(np.uint32)
    c = img[..., :3].astype(np.uint32)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), c, div)
    return np.concatenate([rgb.astype(np.uint8), img[..., 3:]], -1)


def resize_rgba(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's `Image.fromarray(img, "RGBA").resize((width, height))`
    for a uint8 [H, W, 4] image."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    pm = _premultiply(img)
    if w != width:
        pm = _pass(pm, width, 1)
    if h != height:
        pm = _pass(pm, height, 0)
    return _unpremultiply(pm)


def halve_to_fit(img: np.ndarray, max_tex: int) -> np.ndarray:
    """Halve an RGBA texture (each side `max(side // 2, 1)`) until its
    larger side is at most max_tex, as the JAX loader does with Pillow."""
    while max(img.shape[:2]) > max_tex:
        h, w = img.shape[:2]
        img = resize_rgba(img, max(w // 2, 1), max(h // 2, 1))
    return img
