"""Stateless counter-based RNG: pcg3d keyed by (pixel, sample, dim).

Port of `truetrace_tpu/core/rng.py`. Every random number is a pure
function of its counters, so the port draws the same numbers as the JAX
package. Torch has no full uint32 arithmetic (no unsigned shifts, adds,
products or compares on the CPU, and only part of them on CUDA), so one
code path serves both devices: values are uint32 bit patterns held in
int64 and masked with 0xFFFFFFFF after every operation. A wrapped int64
product keeps its low 32 bits exact, so the results are bitwise equal to
the uint32 ones.

A Python-int counter (a sample or dimension id) stays a Python int,
masked to 32 bits, and broadcasts against the pixel tensor: making a
device tensor of it would be a host-to-device copy, and a stream sync,
at every draw. Python int products are exact, so they are masked before
they meet a tensor (an int64 scalar); the low 32 bits, all that is kept,
are those of the wrapped product.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_M = 1664525
_A = 1013904223


def u32(x):
    """An integer tensor -> int64 tensor of its uint32 bits; a Python int
    -> a Python int in [0, 2^32)."""
    if not isinstance(x, torch.Tensor):
        return int(x) & M32
    return x.to(torch.int64) & M32


def _mul(a, b):
    """a * b, masked first where both are Python ints."""
    p = a * b
    return p & M32 if isinstance(p, int) else p


def pcg3d(v0, v1, v2):
    """3-D PCG hash (Jarzynski & Olano 2020): three uint32 counters -> three
    decorrelated uint32, each as int64 bits (Python ints where every
    counter is one)."""
    x, y, z = u32(v0), u32(v1), u32(v2)
    x = (x * _M + _A) & M32
    y = (y * _M + _A) & M32
    z = (z * _M + _A) & M32
    x = (x + _mul(y, z)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + _mul(y, z)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    return x, y, z


def _u32_to_unit_float(u):
    """uint32 -> float32 in [0, 1) from the top 24 bits (exact)."""
    return (u >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform1(pixel_id, sample_id, dim_id):
    x, _, _ = pcg3d(pixel_id, sample_id, dim_id)
    return _u32_to_unit_float(x)


def uniform2(pixel_id, sample_id, dim_id):
    """Two independent U[0,1) floats per lane, [..., 2]."""
    x, y, _ = pcg3d(pixel_id, sample_id, dim_id)
    return torch.stack([_u32_to_unit_float(x), _u32_to_unit_float(y)], -1)


def uniform3(pixel_id, sample_id, dim_id):
    x, y, z = pcg3d(pixel_id, sample_id, dim_id)
    return torch.stack([_u32_to_unit_float(x), _u32_to_unit_float(y),
                        _u32_to_unit_float(z)], -1)


# dimension-slot layout along a path (stride per bounce), as in the JAX
# package: the same (pixel, sample, dim) triple replays the same decision
DIMS_PER_BOUNCE = 8
DIM_CAMERA_JITTER = 0   # subpixel jitter + DoF lens sample
DIM_BSDF_LOBE = 1       # lobe selection
DIM_BSDF_SAMPLE = 2     # 2-D direction sample
DIM_LIGHT_SELECT = 3    # light-tree selection
DIM_LIGHT_SAMPLE = 4    # 2-D point-on-light sample
DIM_RR = 5              # russian roulette
DIM_AUX = 6             # free slot (ReSTIR etc.)
DIM_NEE_RR = 7          # NEE shadow-ray russian roulette


def path_dim(bounce: int, slot: int) -> int:
    """Dimension id for a given bounce and slot."""
    return bounce * DIMS_PER_BOUNCE + slot
