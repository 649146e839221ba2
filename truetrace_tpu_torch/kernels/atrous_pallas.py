"""SVGF edge-aware a-trous pass: CUDA kernel + plain version.

Port of `truetrace_tpu/kernels/atrous_pallas.py`. The Pallas kernel kept
the whole frame in VMEM and only ran when `atrous_fits_vmem` held
(<= 12 MB, so not at 512^2); the Hopper kernel (csrc/atrous.cu, a tiled
stencil with a shared-memory halo) has no such limit, and
`post/svgf.svgf_denoise` calls it for every pass on CUDA tensors.
"""
from __future__ import annotations

import torch

from truetrace_tpu_torch.kernels import _cuda


def atrous_pass_plain(color, var, normal, depth, step: int):
    """Plain PyTorch pass (post/svgf._atrous_pass)."""
    from truetrace_tpu_torch.post.svgf import _atrous_pass
    return _atrous_pass(color, var, normal, depth, step)


def atrous_pass(color, var, normal, depth, step: int):
    """One a-trous pass at `step`: color [H,W,3], var [H,W],
    normal [H,W,3], depth [H,W] float32 -> (color, var). CUDA tensors
    launch csrc/atrous.cu; CPU tensors take atrous_pass_plain. Counts
    launches in `atrous_pass.launches`."""
    if color.device.type == "cpu":
        return atrous_pass_plain(color, var, normal, depth, step)
    H, W = depth.shape
    for name, x, shape in (("color", color, (H, W, 3)), ("var", var, (H, W)),
                           ("normal", normal, (H, W, 3)),
                           ("depth", depth, (H, W))):
        if (x.device != color.device or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous float32 {shape} "
                             f"tensor on {color.device}")
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    out_c = torch.empty_like(color)
    out_v = torch.empty_like(var)
    err = _cuda.lib("atrous.cu").tt_atrous_pass(
        color.data_ptr(), var.data_ptr(), normal.data_ptr(),
        depth.data_ptr(), out_c.data_ptr(), out_v.data_ptr(), H, W,
        int(step), _cuda.stream_ptr(color))
    _cuda.check(err, "tt_atrous_pass")
    atrous_pass.launches += 1
    return out_c, out_v


atrous_pass.launches = 0
