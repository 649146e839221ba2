"""Post-processing chain: accumulate -> exposure -> bloom -> tonemap -> TAA
-> sharpen -> gamma, the RCRS firefly clamp, and temporal upscaling.

Port of `truetrace_tpu/post/pipeline.py`: the analytic tonemaps (ACES,
Reinhard, AgX and its looks) and 3-D LUTs (.cube files in and out, a
baker), auto exposure (instant, and the temporal histogram median),
bloom, TAA with motion reprojection, CAS sharpening, progressive
accumulation, and TAAU (the Halton jitter sequence and the jitter-aware
upscaler). All image functions take and return [H,W,3] float32
linear-radiance images on any device. Their constants are Python
numbers, never tensors made from host data, so the frame makes no host
copy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from truetrace_tpu_torch.core.math import luminance


@dataclass(frozen=True)
class PostConfig:
    """The JAX package's PostConfig. lut3d: a [N,N,N,3] 3-D LUT on the
    frame's device for tonemap="lut" (load_cube_lut / bake_tonemap_lut);
    lut_shaper: its input is HDR through the Reinhard shaper (baked LUTs)
    rather than display-referred [0, 1] (.cube grading LUTs)."""
    tonemap: str = "aces"
    exposure: float = 1.0
    auto_expose: bool = False
    bloom_strength: float = 0.0
    taa_alpha: float = 0.1
    sharpen: float = 0.0
    gamma: float = 2.2
    # RCRS firefly clamp factor applied before accumulation; 0 disables
    firefly: float = 3.0
    lut3d: Optional[torch.Tensor] = None
    lut_shaper: bool = True

    def check_supported(self) -> None:
        if self.tonemap != "lut" and self.tonemap not in _TONEMAPS:
            raise ValueError(f"unknown tonemap {self.tonemap!r}")
        if self.tonemap == "lut" and self.lut3d is None:
            raise ValueError('tonemap="lut" needs PostConfig.lut3d (the JAX '
                             "package fails inside apply_lut3d there)")


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


# ---------------------------------------------------------------------------
# tonemaps (reference ToneMap.compute; the published analytic fits)
# ---------------------------------------------------------------------------

def tonemap_reinhard(x):
    return x / (1.0 + x)


def tonemap_aces(x):
    """Narkowicz ACES filmic fit."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


_AGX_IN = np.asarray([[0.842479, 0.0784336, 0.0792237],
                      [0.0423282, 0.878468, 0.0791661],
                      [0.0423756, 0.0784336, 0.879142]], np.float32)
_AGX_OUT = np.linalg.inv(_AGX_IN.astype(np.float64)).astype(np.float32)


def _mat3(m: np.ndarray, x):
    """m [3,3] (float32 constants) times the colour vectors x [...,3]."""
    rows = [[float(v) for v in r] for r in m]
    return torch.stack([r[0] * x[..., 0] + r[1] * x[..., 1] + r[2] * x[..., 2]
                        for r in rows], -1)


def _agx_base(x):
    """AgX inset, log2 encoding and sigmoid, without the outset: the
    space the looks work in."""
    v = _mat3(_AGX_IN, torch.clamp(x, min=1e-10))
    lo, hi = -12.47393, 4.026069
    v = (torch.log2(v) - lo) / (hi - lo)
    v = torch.clamp(v, 0.0, 1.0)
    v2 = v * v
    v4 = v2 * v2
    return (15.5 * v4 * v2 - 40.14 * v4 * v + 31.96 * v4 - 6.868 * v2 * v
            + 0.4298 * v2 + 0.1191 * v - 0.00232)


def _agx_outset(s):
    return torch.clamp(_mat3(_AGX_OUT, s), 0.0, 1.0)


def tonemap_agx(x):
    """AgX base (Benjamin Wrensch's minimal fit): log2 encoding and a
    6th-order sigmoid polynomial."""
    return _agx_outset(_agx_base(x))


def _agx_look(x, slope, power, sat):
    """AgX look (Sobotka / Blender) between the sigmoid and the outset:
    v' = (v slope)^power, then saturation about Rec.709 luma."""
    v = _agx_base(x)
    v = torch.stack([torch.clamp(v[..., c] * slope[c], min=0.0) ** power[c]
                     for c in range(3)], -1)
    luma = (0.2126 * v[..., 0] + 0.7152 * v[..., 1]
            + 0.0722 * v[..., 2])[..., None]
    v = luma + sat * (v - luma)
    return _agx_outset(v)


def tonemap_agx_punchy(x):
    """AgX "punchy" look: deeper contrast and more saturation."""
    return _agx_look(x, (1.0, 1.0, 1.0), (1.35, 1.35, 1.35), 1.4)


def tonemap_agx_golden(x):
    """AgX "golden" look: warm slope, lifted mids, muted saturation."""
    return _agx_look(x, (1.0, 0.9, 0.5), (0.8, 0.8, 0.8), 0.8)


_TONEMAPS = {"aces": tonemap_aces, "reinhard": tonemap_reinhard,
             "agx": tonemap_agx, "agx_punchy": tonemap_agx_punchy,
             "agx_golden": tonemap_agx_golden, "none": lambda x: x}


# ---------------------------------------------------------------------------
# 3-D LUT tonemapping (reference ToneMap.compute's LUT path): .cube files
# in and out, a baker for the analytic tonemaps, and a trilinear apply
# ---------------------------------------------------------------------------

# the shaper u = x / (1 + x) maps HDR [0, inf) onto the LUT's [0, 1)
_SHAPER_EPS = 1.0 / 4096.0   # caps the baker's inverse shaper at ~4096


def load_cube_lut(path: str):
    """Parse an Adobe/Resolve .cube 3-D LUT. Returns (lut [N,N,N,3]
    float32 numpy, indexed [b][g][r] with red fastest as the format
    stores it, (domain_min, domain_max) per-channel tuples)."""
    size = None
    dmin = (0.0, 0.0, 0.0)
    dmax = (1.0, 1.0, 1.0)
    data = []
    with open(path) as f:
        for line in f:
            t = line.split("#", 1)[0].strip()
            if not t:
                continue
            parts = t.split()
            key = parts[0].upper()
            if key == "LUT_3D_SIZE":
                size = int(parts[1])
            elif key == "DOMAIN_MIN":
                dmin = tuple(float(x) for x in parts[1:4])
            elif key == "DOMAIN_MAX":
                dmax = tuple(float(x) for x in parts[1:4])
            elif key in ("TITLE", "LUT_1D_SIZE"):
                continue
            else:
                try:
                    data.append([float(x) for x in parts[:3]])
                except ValueError:
                    continue
    if size is None or len(data) != size ** 3:
        raise ValueError(f"bad .cube file {path}: size={size}, "
                         f"rows={len(data)}")
    lut = np.asarray(data, np.float32).reshape(size, size, size, 3)
    return lut, (dmin, dmax)


def save_cube_lut(path: str, lut, title: str = "truetrace_tpu",
                  domain=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))) -> None:
    """Write a [N,N,N,3] LUT (indexed [b][g][r]; numpy or a tensor) as an
    Adobe/Resolve .cube file that load_cube_lut reads back."""
    a = (lut.detach().cpu().numpy() if isinstance(lut, torch.Tensor)
         else np.asarray(lut)).astype(np.float32)
    n = a.shape[0]
    with open(path, "w") as f:
        f.write(f'TITLE "{title}"\nLUT_3D_SIZE {n}\n')
        f.write("DOMAIN_MIN %g %g %g\n" % tuple(domain[0]))
        f.write("DOMAIN_MAX %g %g %g\n" % tuple(domain[1]))
        for b in range(n):
            for g in range(n):
                for r in range(n):
                    f.write("%.6f %.6f %.6f\n" % tuple(a[b, g, r]))


def bake_tonemap_lut(tonemap, size: int = 33, device="cuda"):
    """Bake an analytic tonemap (a name in _TONEMAPS or a callable) into
    a [N,N,N,3] LUT on `device` over the Reinhard-shaped HDR domain;
    apply it with apply_lut3d(x, lut, shaper=True)."""
    fn = _TONEMAPS[tonemap] if isinstance(tonemap, str) else tonemap
    g = np.linspace(0.0, 1.0, size).astype(np.float32)
    hdr = g / np.maximum(1.0 - g, _SHAPER_EPS)
    b, gg, r = np.meshgrid(hdr, hdr, hdr, indexing="ij")
    pts = torch.from_numpy(np.stack([r, gg, b], axis=-1).reshape(-1, 3))
    return fn(pts.to(device)).reshape(size, size, size, 3)


def apply_lut3d(x, lut, shaper: bool = True,
                domain=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))):
    """Trilinear 3-D LUT on [...,3] images (8 corner gathers). shaper=True
    maps HDR input through u = x / (1 + x) (for bake_tonemap_lut);
    shaper=False takes display-referred input in the .cube DOMAIN box."""
    n = lut.shape[0]
    if shaper:
        u = x / (1.0 + torch.clamp(x, min=0.0))
    else:
        lo = np.asarray(domain[0], np.float32)
        span = np.asarray(domain[1], np.float32) - lo
        u = torch.stack([(x[..., c] - float(lo[c])) / float(span[c])
                         for c in range(3)], -1)
    u = torch.clamp(u, 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(u).to(torch.int64), 0, max(n - 2, 0))
    f = u - i0.to(torch.float32)
    flat = lut.reshape(-1, 3)
    ir, ig, ib = i0[..., 0], i0[..., 1], i0[..., 2]

    def at(dr, dg, db):
        return flat[((ib + db) * n + (ig + dg)) * n + (ir + dr)]

    fr, fg, fb = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c00 = at(0, 0, 0) * (1 - fr) + at(1, 0, 0) * fr
    c10 = at(0, 1, 0) * (1 - fr) + at(1, 1, 0) * fr
    c01 = at(0, 0, 1) * (1 - fr) + at(1, 0, 1) * fr
    c11 = at(0, 1, 1) * (1 - fr) + at(1, 1, 1) * fr
    c0 = c00 * (1 - fg) + c10 * fg
    c1 = c01 * (1 - fg) + c11 * fg
    return c0 * (1 - fb) + c1 * fb


# ---------------------------------------------------------------------------
# auto exposure (reference AutoExpose.compute)
# ---------------------------------------------------------------------------

def auto_exposure(img, key: float = 0.18):
    """Scale to `key` over the log-average luminance."""
    log_avg = torch.exp(torch.mean(torch.log(torch.clamp(luminance(img),
                                                         min=1e-6))))
    return img * (key / torch.clamp(log_avg, min=1e-6))


EXPOSURE_BINS = 256


def exposure_bins(img):
    """Each pixel's bin of the 256 log-luminance bins (reference getBin:
    log(12 L) * 12 + 220), [H*W] int64."""
    L = torch.clamp(luminance(img), min=1e-8)
    bins = (torch.log(L * 12.0) * 12.0 + 220.0).to(torch.int32)
    return torch.clamp(bins, 0, EXPOSURE_BINS - 1).reshape(-1).to(torch.int64)


def auto_exposure_temporal(img, prev_exposure, decay: float = 0.05,
                           growth: float = 0.035):
    """Histogram-median auto exposure adapted over time (reference
    AutoExpose.compute: the median of the log-luminance histogram, a
    key-remapped target, asymmetric exponential adaptation). Returns
    (scaled img, new exposure [] tensor). prev_exposure <= 0 is a cold
    start, which jumps to the target.

    The histogram is a fixed [256] scatter-add of ones: its counts are
    integers below 2^24, exact in any order of the adds, and no size is
    read back (torch.bincount reads its maximum to the host)."""
    bins = exposure_bins(img)
    pdf = torch.zeros((EXPOSURE_BINS,), device=img.device).scatter_add_(
        0, bins, torch.ones(bins.shape, device=img.device))
    cdf = torch.cumsum(pdf, 0)
    # the median bin: the first whose CDF reaches half the pixels (argmax
    # returns the first of equal maxima)
    med_bin = torch.argmax((cdf >= 0.5 * cdf[-1]).to(torch.int32))
    l_med = torch.exp((med_bin.to(torch.float32) - 220.0) / 12.0) / 12.0
    key_val = 1.5 - 2.0 / (2.0 + torch.log10(l_med + 1.0))
    target = key_val * 2.15 / torch.clamp(l_med, 7.5e-4, 50.0)
    speed = torch.where(target < prev_exposure, decay, growth)
    adapted = prev_exposure + (target - prev_exposure) * speed
    e_new = torch.where(prev_exposure <= 0.0, target, adapted)
    return img * e_new, e_new


# ---------------------------------------------------------------------------
# bloom (reference Bloom.compute; a separable Gaussian pyramid, 3 octaves)
# ---------------------------------------------------------------------------

def _blur1d(img, axis: int, sigma_px: int):
    radius = max(1, sigma_px)
    # float32 weights, as the JAX package computes them on its device
    offsets = np.arange(-radius, radius + 1)
    w = np.exp(-0.5 * (offsets.astype(np.float32) / max(sigma_px, 1)) ** 2)
    w = w / np.sum(w)
    out = torch.zeros_like(img)
    for k, o in enumerate(offsets):
        out = out + float(w[k]) * torch.roll(img, int(o), dims=axis)
    return out


def _downsample2(img):
    h, w, _ = img.shape
    return img[:h - h % 2, :w - w % 2].reshape(
        h // 2, 2, w // 2, 2, 3).mean(dim=(1, 3))


def _upsample_to(img, h: int, w: int):
    fy = max(1, -(-h // img.shape[0]))
    fx = max(1, -(-w // img.shape[1]))
    up = img.repeat_interleave(fy, dim=0).repeat_interleave(fx, dim=1)
    return up[:h, :w]


def bloom(img, strength: float = 0.1, threshold: float = 1.0):
    h, w, _ = img.shape
    bright = torch.clamp(img - threshold, min=0.0)
    acc = torch.zeros_like(img)
    level = bright
    for _ in range(3):
        if min(level.shape[0], level.shape[1]) < 4:
            break
        level = _downsample2(level)
        blurred = _blur1d(_blur1d(level, 0, 2), 1, 2)
        acc = acc + _upsample_to(blurred, h, w)
        level = blurred
    return img + strength * acc


# ---------------------------------------------------------------------------
# TAA (reference TAA.compute) and CAS sharpening (Sharpen.compute)
# ---------------------------------------------------------------------------

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


def sharpen_cas(img, amount: float = 0.3):
    cross = (torch.roll(img, 1, 0) + torch.roll(img, -1, 0)
             + torch.roll(img, 1, 1) + torch.roll(img, -1, 1))
    sharp = img * (1.0 + 4.0 * amount) - amount * cross
    return torch.minimum(torch.clamp(sharp, min=0.0),
                         torch.clamp(img.max(), min=1.0))


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def postprocess(img, cfg: PostConfig, history: Optional[torch.Tensor] = None,
                motion: Optional[torch.Tensor] = None,
                exposure_state: Optional[torch.Tensor] = None):
    """Linear HDR [H,W,3] -> (display [H,W,3] in [0,1], new TAA history),
    in the reference's order (RayTracingMaster.cs:1132-1182): exposure,
    bloom, tonemap, TAA, sharpen, gamma. With `exposure_state` (the last
    frame's adapted exposure, a [] tensor) and auto_expose, the temporal
    histogram exposure runs instead of the instant log-average, and a
    third element, the new exposure, is returned."""
    cfg.check_supported()
    x = img * cfg.exposure
    new_exposure = exposure_state
    if cfg.auto_expose:
        if exposure_state is not None:
            x, new_exposure = auto_exposure_temporal(x, exposure_state)
        else:
            x = auto_exposure(x)
    if cfg.bloom_strength > 0:
        x = bloom(x, cfg.bloom_strength)
    if cfg.tonemap == "lut":
        x = apply_lut3d(x, cfg.lut3d, shaper=cfg.lut_shaper)
    else:
        x = _TONEMAPS[cfg.tonemap](x)
    new_history = x
    if history is not None:
        x = taa(x, history, cfg.taa_alpha, motion=motion)
        new_history = x
    if cfg.sharpen > 0:
        x = sharpen_cas(x, cfg.sharpen)
    x = torch.clamp(x, 0.0, 1.0) ** (1.0 / cfg.gamma)
    if exposure_state is not None:
        return x, new_history, new_exposure
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


# ---------------------------------------------------------------------------
# temporal upscaling (reference TAAU.compute): each frame renders at the
# internal size with one Halton subpixel offset, and the upscaler weighs
# the 3x3 nearest low-res samples by their true (jittered) positions
# against a motion-reprojected, neighbourhood-clamped history
# ---------------------------------------------------------------------------

def halton(i, base: int):
    """The i-th Halton sample in [0, 1): i an integer tensor (0-d, on any
    device; a sample id on the card as graph_step holds it) or a Python
    int. float32 digits times the Python-float weights, 10 digits, as the
    JAX package rounds them."""
    ii = torch.as_tensor(i).to(torch.int64)
    f = 1.0
    r = torch.zeros((), device=ii.device)
    for _ in range(10):          # 2^10 / 3^10 frames of unique offsets
        f = f / base
        r = r + f * (ii % base).to(torch.float32)
        ii = ii // base
    return r


def taau_jitter(frame_id):
    """The frame's subpixel offset in [0, 1)^2 (Halton 2, 3)."""
    return torch.stack([halton(frame_id, 2), halton(frame_id, 3)])


def taau_upscale(low, history, scale: int = 2, alpha: float = 0.2,
                 jitter=None, motion=None):
    """Temporal upscaling of a jittered low-res frame.

    low [h,w,3]: the frame, each pixel's sample at subpixel offset
    `jitter` (taau_jitter; None = the pixel centre). history [h*scale,
    w*scale, 3] or None. motion [h,w,2]: low-res pixel motion or None.
    Returns (out [H,W,3], new history). Each high-res pixel gathers the
    3x3 nearest low-res samples weighted by a Gaussian of the distance
    from its centre to each sample's jittered position; the history is
    reprojected by truncation, kept where |motion| < the frame, clamped
    to the gathered samples' min/max, and blended with a confidence
    weight."""
    h, w = low.shape[:2]
    H, W = h * scale, w * scale
    dev = low.device
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[0], jitter[1]
    # high-res pixel centres in low-res pixel units
    yy = (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
          + 0.5) / scale
    xx = (torch.arange(W, dtype=torch.float32, device=dev)[None, :]
          + 0.5) / scale
    cy = torch.floor(yy - 0.5).to(torch.int64)
    cx = torch.floor(xx - 0.5).to(torch.int64)
    # a narrow kernel (sigma in low-res pixels): the nearest jittered
    # sample dominates its high-res pixel
    sigma2 = 2.0 * (0.22 ** 2)
    acc = torch.zeros((H, W, 3), device=dev)
    wsum = torch.zeros((H, W), device=dev)
    wmax = torch.zeros((H, W), device=dev)
    nmin = torch.full((H, W, 3), math.inf, device=dev)
    nmax = torch.full((H, W, 3), -math.inf, device=dev)
    for dy in (0, 1, -1):
        for dx in (0, 1, -1):
            sy = torch.clamp(cy + dy, 0, h - 1)                   # [H,1]
            sx = torch.clamp(cx + dx, 0, w - 1)                   # [1,W]
            c = low[sy[:, 0]][:, sx[0, :]]                        # [H,W,3]
            py = sy.to(torch.float32) + jy
            px = sx.to(torch.float32) + jx
            d2 = (py - yy) ** 2 + (px - xx) ** 2
            wgt = torch.exp(-d2 / sigma2)
            acc = acc + c * wgt[..., None]
            wsum = wsum + wgt
            wmax = torch.maximum(wmax, wgt)
            nmin = torch.minimum(nmin, c)
            nmax = torch.maximum(nmax, c)
    cur = acc / torch.clamp(wsum, min=1e-8)[..., None]
    if history is None:
        return cur, cur
    if motion is not None:
        mo = upscale_motion(motion, scale, H, W)
        ys = torch.clamp((torch.arange(H, dtype=torch.float32, device=dev
                                       )[:, None] - mo[..., 1]
                          ).to(torch.int64), 0, H - 1)
        xs = torch.clamp((torch.arange(W, dtype=torch.float32, device=dev
                                       )[None, :] - mo[..., 0]
                          ).to(torch.int64), 0, W - 1)
        inb = (mo[..., 0].abs() < W) & (mo[..., 1].abs() < H)
        history = torch.where(inb[..., None], history[ys, xs], cur)
    hist = torch.minimum(torch.maximum(history, nmin), nmax)
    # pixels whose nearest sample landed near their centre take more of
    # the new frame
    a = alpha * (0.1 + 0.9 * wmax)
    out = hist + a[..., None] * (cur - hist)
    return out, out


def upscale_motion(motion, scale: int, H: int, W: int):
    """Low-res motion [h,w,2] as output-resolution pixel motion [H,W,2]."""
    return (motion.repeat_interleave(scale, 0).repeat_interleave(scale, 1)
            [:H, :W] * scale)
