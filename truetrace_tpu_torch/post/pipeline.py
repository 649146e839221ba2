"""Post-processing chain: accumulate -> exposure -> tonemap -> TAA -> gamma.

Port of `truetrace_tpu/post/pipeline.py` for the slice's defaults: the
ACES tonemap, TAA with motion reprojection, the RCRS firefly clamp and
progressive accumulation. All functions take and return [H,W,3] float32
linear-radiance images. The other tonemaps, 3-D LUTs, bloom, auto
exposure, CAS sharpening and TAAU raise NotImplementedError naming their
ROADMAP.md item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def _todo(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md A.10)")


@dataclass(frozen=True)
class PostConfig:
    """The JAX package's PostConfig without the 3-D LUT table."""
    tonemap: str = "aces"
    exposure: float = 1.0
    auto_expose: bool = False
    bloom_strength: float = 0.0
    taa_alpha: float = 0.1
    sharpen: float = 0.0
    gamma: float = 2.2
    # RCRS firefly clamp factor applied before accumulation; 0 disables
    firefly: float = 3.0

    def check_supported(self) -> None:
        if self.tonemap != "aces":
            _todo(f"tonemap={self.tonemap!r}")
        if self.auto_expose:
            _todo("auto exposure")
        if self.bloom_strength > 0:
            _todo("bloom")
        if self.sharpen > 0:
            _todo("CAS sharpening")


@dataclass
class Accumulator:
    """Progressive running mean of the frames since the last reset."""
    image: torch.Tensor   # [H,W,3]
    count: torch.Tensor   # [] float32 samples so far

    @staticmethod
    def create(h: int, w: int, device="cuda") -> "Accumulator":
        return Accumulator(image=torch.zeros((h, w, 3), device=device),
                           count=torch.zeros((), device=device))

    @staticmethod
    def from_numpy(d: dict, device) -> "Accumulator":
        t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
        return Accumulator(image=t(d["image"]), count=t(d["count"]))

    def add(self, frame: torch.Tensor, weight: float = 1.0) -> "Accumulator":
        n = self.count + weight
        img = self.image + (frame - self.image) * (
            weight / torch.clamp(n, min=1e-9))
        return Accumulator(image=img, count=n)

    def reset(self) -> "Accumulator":
        return Accumulator(image=torch.zeros_like(self.image),
                           count=torch.zeros_like(self.count))


def tonemap_aces(x):
    """Narkowicz ACES filmic fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _roll2(img, dy: int, dx: int):
    return torch.roll(img, shifts=(dy, dx), dims=(0, 1))


def taa(cur, history, alpha: float = 0.1, motion=None):
    """Reproject history along motion vectors (None = static camera),
    clamp it to the 3x3 neighbourhood min/max of the current frame, then
    blend exponentially."""
    if motion is not None:
        H, W = cur.shape[:2]
        dev = cur.device
        sy = torch.arange(H, device=dev)[:, None] - motion[..., 1]
        sx = torch.arange(W, device=dev)[None, :] - motion[..., 0]
        ys = torch.clamp(torch.round(sy).to(torch.int64), 0, H - 1)
        xs = torch.clamp(torch.round(sx).to(torch.int64), 0, W - 1)
        inb = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
        history = torch.where(inb[..., None], history[ys, xs], cur)
    nmin = cur
    nmax = cur
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            n = _roll2(cur, dy, dx)
            nmin = torch.minimum(nmin, n)
            nmax = torch.maximum(nmax, n)
    hist = torch.minimum(torch.maximum(history, nmin), nmax)
    return hist + alpha * (cur - hist)


def postprocess(img, cfg: PostConfig, history: Optional[torch.Tensor] = None,
                motion: Optional[torch.Tensor] = None):
    """Linear HDR [H,W,3] -> (display [H,W,3] in [0,1], new TAA history)."""
    cfg.check_supported()
    x = tonemap_aces(img * cfg.exposure)
    new_history = x
    if history is not None:
        x = taa(x, history, cfg.taa_alpha, motion=motion)
        new_history = x
    x = torch.clamp(x, 0.0, 1.0) ** (1.0 / cfg.gamma)
    return x, new_history


def firefly_clamp(img, factor: float = 3.0):
    """A pixel may not exceed `factor` x the max of its 3x3 neighbours
    (excluding itself)."""
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _roll2(img, dy, dx)
            nmax = n if nmax is None else torch.maximum(nmax, n)
    return torch.minimum(img, nmax * factor + 1e-4)
