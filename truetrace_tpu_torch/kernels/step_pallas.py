"""The traversal step core: Moller block + 8-slot slab decode.

Port of `truetrace_tpu/kernels/step_pallas.py` `step_core` with its
lane-major layout contract (uint32 there, int32 bits here):

  rowt [32, R] : unified-table rows, transposed (30 words + 2 pad)
  ray9 [9, R]  : ro(0..2), rd(3..5), inv_rd(6..8) as float32
  st5  [5, R]  : t_best (f32 bits), tri_best, u, v (f32 bits), leaf_lane
  out  [7, R]  : t, tri, u, v, c_hits, c_chim, c_bleaf

On Hopper the core is a `__device__` function (csrc/cwbvh_core.cuh) that
the traversal kernel runs every iteration; `step_core` launches it on its
own (csrc/step_core.cu) so it can be held against `step_core_plain`.
"""
from __future__ import annotations

import torch

from truetrace_tpu_torch.kernels import _cuda
from truetrace_tpu_torch.kernels.cwbvh_wavefront import (
    _as_i32, _decode, _f32_bits, _moller, _u)


def step_core_plain(rowt, ray9, st5, write_uv: bool = True):
    """Plain PyTorch step core (K = 3 rows, as the Pallas kernel)."""
    ro = ray9[0:3].t()
    rd = ray9[3:6].t()
    inv = ray9[6:9].t()
    t = st5[0].contiguous().view(torch.float32)
    tri = st5[1].to(torch.int64)
    u = st5[2].contiguous().view(torch.float32)
    v = st5[3].contiguous().view(torch.float32)
    leaf_lane = st5[4] != 0
    t, tri, u, v = _moller(lambda k: rowt[k].contiguous().view(torch.float32),
                           lambda k: rowt[k].to(torch.int64), 3, ro, rd,
                           leaf_lane, write_uv, t, tri, u, v)
    hits, chim, bleaf = _decode(lambda k: _u(rowt[k]), ro, inv, t)
    return torch.stack([_as_i32(_f32_bits(t)), tri.to(torch.int32),
                        _as_i32(_f32_bits(u)), _as_i32(_f32_bits(v)),
                        _as_i32(hits), _as_i32(chim), _as_i32(bleaf)])


def step_core(rowt, ray9, st5, write_uv: bool = True):
    """Step core: CUDA tensors launch csrc/step_core.cu, CPU tensors take
    step_core_plain. Counts launches in `step_core.launches`. A tensor
    that requires grad raises ValueError (the step is not
    differentiated)."""
    _cuda.refuse_grad("step_core", "the traversal's rays are "
                      "(integrate/pathtrace.py detaches the hit record)",
                      rowt, ray9, st5)
    if rowt.device.type == "cpu":
        return step_core_plain(rowt, ray9, st5, write_uv)
    R = rowt.shape[1]
    for name, x, rows, dt in (("rowt", rowt, 32, torch.int32),
                              ("ray9", ray9, 9, torch.float32),
                              ("st5", st5, 5, torch.int32)):
        if (x.device != rowt.device or x.dtype != dt
                or x.shape != (rows, R) or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {dt} [{rows},{R}] "
                             f"tensor on {rowt.device}")
    out = torch.empty((7, R), dtype=torch.int32, device=rowt.device)
    err = _cuda.lib("step_core.cu").tt_step_core(
        rowt.data_ptr(), ray9.data_ptr(), st5.data_ptr(), out.data_ptr(), R,
        int(write_uv), _cuda.stream_ptr(rowt))
    _cuda.check(err, "tt_step_core")
    step_core.launches += 1
    return out


step_core.launches = 0
