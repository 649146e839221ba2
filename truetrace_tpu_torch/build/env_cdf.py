"""Environment-map importance-sampling tables.

Port of `truetrace_tpu/build/env_cdf.py` (the reference's
CDFCreator.compute, Utility/CDFCreator.compute:26-169: per-row conditional
CDFs, a sin-theta-weighted marginal CDF and the total). The tables are
built in numpy exactly as the JAX package builds them, so they are
bitwise equal to its tables (tests/test_torch_envmap.py); only the
container is the port's `EnvMap` on `device`.
"""
from __future__ import annotations

import numpy as np
import torch

from truetrace_tpu_torch.scene.ir import EnvMap


def build_env_cdf(image: np.ndarray, rotation: float = 0.0,
                  intensity: float = 1.0, device="cuda") -> EnvMap:
    """image: [H,W,3] equirect radiance -> EnvMap with CDF tables, on
    `device` (the card unless the caller asks for the CPU)."""
    img = np.asarray(image, np.float32)
    H, W = img.shape[:2]
    lum = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
           + 0.0722 * img[..., 2])
    # sin(theta) weight per row (theta = pi*(y+0.5)/H)
    sin_t = np.sin(np.pi * (np.arange(H) + 0.5) / H).astype(np.float32)
    w = lum * sin_t[:, None]

    row_sum = w.sum(axis=1)
    cdf_x = np.cumsum(w, axis=1)
    cdf_x = cdf_x / np.maximum(row_sum[:, None], 1e-20)
    cdf_y = np.cumsum(row_sum)
    total = max(float(cdf_y[-1]), 1e-20)
    cdf_y = cdf_y / total

    f = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return EnvMap(image=f(img), cdf_x=f(cdf_x), cdf_y=f(cdf_y),
                  total=f(np.float32(total * (np.pi / H) * (2 * np.pi / W))),
                  rotation=f(np.float32(rotation)),
                  intensity=f(np.float32(intensity)))


def procedural_sky(h: int = 128, w: int = 256, sun_dir=(0.3, 0.6, 0.2),
                   sun_intensity: float = 500.0, sun_angle_deg: float = 1.5,
                   sky_tint=(0.35, 0.5, 0.85), ground=(0.25, 0.2, 0.15),
                   ) -> np.ndarray:
    """Simple analytic sky + sun disk (the JAX package's stand-in for the
    reference's Bruneton atmosphere LUTs). [h,w,3] float32."""
    sd = np.asarray(sun_dir, np.float64)
    sd /= np.linalg.norm(sd)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    theta = np.pi * (ys + 0.5) / h
    phi = 2 * np.pi * (xs + 0.5) / w
    d = np.stack([np.sin(theta) * np.cos(phi), np.cos(theta),
                  np.sin(theta) * np.sin(phi)], axis=-1)
    cos_sun = d @ sd
    horizon = np.clip(d[..., 1], -1, 1)
    sky = (np.asarray(sky_tint)[None, None] *
           (0.35 + 0.65 * np.clip(horizon, 0, 1))[..., None])
    grad = np.clip(1 - np.abs(horizon) * 4, 0, 1)[..., None] \
        * np.array([0.25, 0.2, 0.12])[None, None]
    img = np.where(horizon[..., None] > 0, sky + grad,
                   np.asarray(ground)[None, None] * 0.4 + grad)
    sun_cos = np.cos(np.deg2rad(sun_angle_deg))
    img = img + (cos_sun > sun_cos)[..., None] * np.asarray(
        [sun_intensity, sun_intensity * 0.95, sun_intensity * 0.85])
    return img.astype(np.float32)


def star_field(h: int = 128, w: int = 256, density: float = 0.004,
               brightness: float = 40.0, seed: int = 7) -> np.ndarray:
    """Procedural star field (the reference's hash-based night-sky stars,
    CommonData.cginc:1228-1382): sparse texels with a power-law
    brightness and a slight blue/yellow tint, weighted by sin(theta) so
    the density is uniform on the sphere. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    ys = (np.arange(h) + 0.5) / h
    sin_t = np.sin(np.pi * ys)[:, None]                  # [h,1]
    u = rng.random((h, w))
    is_star = u < density * sin_t
    mag = rng.random((h, w)) ** 8.0                      # few bright stars
    temp = rng.random((h, w))                            # color variation
    r = 0.8 + 0.4 * temp
    b = 1.2 - 0.4 * temp
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = is_star * mag * r * brightness
    img[..., 1] = is_star * mag * brightness
    img[..., 2] = is_star * mag * b * brightness
    return img
