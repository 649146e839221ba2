"""SVGF edge-aware a-trous pass: CUDA kernel + plain version.

Port of `truetrace_tpu/kernels/atrous_pallas.py`. The Pallas kernel kept
the whole frame in VMEM and only ran when `atrous_fits_vmem` held
(<= 12 MB, so not at 512^2); the Hopper kernel (csrc/atrous.cu) has no
such limit and runs every pass of `post/svgf.svgf_denoise` on CUDA
tensors.

The kernel works on packed planes: `pack(color, var)` gives the
[H,W,4] (colour.rgb, variance) plane that each pass reads and writes,
`pack(normal, depth)` the [H,W,4] guide plane that stays fixed across a
frame's passes. `atrous_filter` runs a frame's passes on them;
`atrous_pass` is one pass on unpacked planes.
"""
from __future__ import annotations

import torch

from truetrace_tpu_torch.kernels import _cuda

# csrc/atrous.cu's paths: staged in shared memory, direct (every tap
# through L1/L2) in 32x8 or in 128x2 blocks
STAGED, DIRECT, DIRECT_WIDE = 0, 1, 2


def _path(step: int) -> int:
    """The fastest path at each step of the 512x512 frame on the H100
    (PERF.md §6): staged at step 1, direct in 32x8 blocks at steps 2-4,
    in 128x2 blocks beyond (their four warps a row share each tap row in
    L1)."""
    return STAGED if step == 1 else DIRECT if step < 8 else DIRECT_WIDE


def atrous_pass_plain(color, var, normal, depth, step: int):
    """Plain PyTorch pass (post/svgf._atrous_pass)."""
    from truetrace_tpu_torch.post.svgf import _atrous_pass
    return _atrous_pass(color, var, normal, depth, step)


def pack(rgb, w):
    """[H,W,3] and [H,W] -> one contiguous [H,W,4] plane."""
    return torch.cat([rgb, w[..., None]], -1)


def unpack(p):
    """[H,W,4] -> ([H,W,3], [H,W]) views."""
    return p[..., :3], p[..., 3]


def _check_plane(name, x, ref):
    if (x.device != ref.device or x.dtype != torch.float32
            or x.dim() != 3 or x.shape[-1] != 4
            or x.shape != ref.shape or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f"{name}: need a contiguous, 16-byte aligned "
                         f"float32 {tuple(ref.shape)} tensor on {ref.device}"
                         f" (last dim 4)")


def _launch(cv, nz, step: int, path: int):
    """One launch of csrc/atrous.cu on packed planes on `path` (STAGED
    needs step to divide H and W)."""
    H, W = cv.shape[:2]
    out = torch.empty_like(cv)
    err = _cuda.lib("atrous.cu").tt_atrous_pass(
        cv.data_ptr(), nz.data_ptr(), out.data_ptr(), H, W, int(step),
        path, _cuda.stream_ptr(cv))
    _cuda.check(err, "tt_atrous_pass")
    return out


def atrous_pass_packed(cv, nz, step: int):
    """One a-trous pass at `step` on packed planes: cv [H,W,4] (colour,
    variance), nz [H,W,4] (normal, depth) -> the next cv. CUDA tensors
    launch csrc/atrous.cu on the path `_path` picks for the step; CPU
    tensors take atrous_pass_plain. Counts launches in
    `atrous_pass_packed.launches`. A plane that requires grad raises
    ValueError (the passes are not differentiated)."""
    _cuda.refuse_grad("atrous_pass_packed", "SVGF's inputs are: the "
                      "denoisers run on rendered frames, outside any "
                      "gradient", cv, nz)
    if cv.device.type == "cpu":
        return pack(*atrous_pass_plain(*unpack(cv), *unpack(nz), step))
    _check_plane("cv", cv, cv)
    _check_plane("nz", nz, cv)
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    out = _launch(cv, nz, step, _path(step))
    atrous_pass_packed.launches += 1
    return out


atrous_pass_packed.launches = 0


def atrous_filter(color, var, normal, depth, n_passes: int):
    """A frame's a-trous passes at steps 1, 2, 4, ...: color [H,W,3],
    var [H,W], normal [H,W,3], depth [H,W] float32 -> (the first pass's
    colour, the last pass's colour, the last pass's variance). The guide
    is packed once, colour and variance once; the outputs are views of
    the packed planes."""
    nz = pack(normal, depth)
    cv = pack(color, var)
    first = color
    for i in range(n_passes):
        cv = atrous_pass_packed(cv, nz, 1 << i)
        if i == 0:
            first = cv[..., :3]
    c, v = unpack(cv) if n_passes else (color, var)
    return first, c, v


def atrous_pass(color, var, normal, depth, step: int):
    """One a-trous pass at `step`: color [H,W,3], var [H,W],
    normal [H,W,3], depth [H,W] float32 -> (color, var), through
    atrous_pass_packed (the kernel on CUDA tensors, the plain version on
    CPU tensors)."""
    H, W = depth.shape
    for name, x, shape in (("color", color, (H, W, 3)), ("var", var, (H, W)),
                           ("normal", normal, (H, W, 3)),
                           ("depth", depth, (H, W))):
        if (x.device != color.device or x.dtype != torch.float32
                or tuple(x.shape) != shape):
            raise ValueError(f"{name}: need a float32 {shape} tensor on "
                             f"{color.device}")
    return unpack(atrous_pass_packed(pack(color, var), pack(normal, depth),
                                     step))
