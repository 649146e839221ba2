"""Learned denoiser, the OIDN slot (reference UnityDenoiserPlugin.cs).

Port of `truetrace_tpu/post/neural.py`'s inference: the 3-level U-Net
(`DenoiserUNet`, ~200k parameters) over log colour, albedo and normal,
predicting a residual on the log colour. Its convolutions are
`torch.nn.functional.conv2d`, as the JAX package's are XLA convolutions
(flax `nn.Conv`) outside any Pallas kernel.

The weights come from the JAX package's flax checkpoints (msgpack, as
`flax.serialization.to_bytes` writes them; `examples/denoiser.msgpack`
is one), read here without msgpack or flax: `read_msgpack` decodes the
format, `params_from_numpy` turns the flax parameter tree (HWIO kernels)
into the module's state (OIHW). Training (the JAX package's `loss_fn`,
`make_train_step` and scripts/train_denoiser.py) is not ported.
"""
from __future__ import annotations

import struct
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _pre_color(c):
    """HDR -> log space (OIDN's transfer function idea)."""
    return torch.log1p(torch.clamp(c, min=0.0))


class ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, ch, 3, padding=1)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return F.relu(self.conv1(F.relu(self.conv0(x))))


class DenoiserUNet(nn.Module):
    """3-level U-Net over [B,9,H,W] (log colour, albedo, normal) -> the
    residual [B,3,H,W] on the log colour. H and W must be multiples of 4.
    The decoder concatenates [upsampled, skip], as the flax module."""

    def __init__(self, chans: Sequence[int] = (24, 48, 96)):
        super().__init__()
        c0, c1, c2 = chans
        self.blocks = nn.ModuleList([
            ConvBlock(9, c0), ConvBlock(c0, c1), ConvBlock(c1, c2),
            ConvBlock(c2 + c1, c1), ConvBlock(c1 + c0, c0)])
        self.out = nn.Conv2d(c0, 3, 3, padding=1)

    def forward(self, x):
        b = self.blocks
        c0 = b[0](x)
        c1 = b[1](F.avg_pool2d(c0, 2))
        c2 = b[2](F.avg_pool2d(c1, 2))
        u1 = F.interpolate(c2, scale_factor=2, mode="nearest")
        c3 = b[3](torch.cat([u1, c1], 1))
        u0 = F.interpolate(c3, scale_factor=2, mode="nearest")
        c4 = b[4](torch.cat([u0, c0], 1))
        return self.out(c4)


def features(noisy, albedo, normal):
    """The network input [...,9]: log colour, albedo, normal."""
    return torch.cat([_pre_color(noisy), albedo, normal], -1)


def denoise(model: DenoiserUNet, noisy, albedo, normal):
    """[H,W,3] noisy radiance -> denoised radiance (non-negative).
    The convolutions run in float32 (no TF32) and with cuDNN's
    deterministic algorithms, chosen without autotuning, so a frame and
    its CUDA-graph replay launch the same ones."""
    x = features(noisy, albedo, normal).permute(2, 0, 1)[None]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=False, deterministic=True,
                                    allow_tf32=False):
        resid = model(x)[0].permute(1, 2, 0)
    return torch.clamp(torch.expm1(_pre_color(noisy) + resid), min=0.0)


def params_from_numpy(tree: dict) -> dict:
    """The flax parameter tree of the JAX DenoiserUNet ({"ConvBlock_i":
    {"Conv_j": {"kernel" [3,3,I,O], "bias" [O]}}, "Conv_0": ...}, numpy
    leaves) -> this module's state dict (kernels as [O,I,3,3])."""
    def conv(p, name):
        k = np.asarray(p["kernel"], np.float32)
        return {f"{name}.weight": torch.from_numpy(
                    np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
                f"{name}.bias": torch.from_numpy(
                    np.asarray(p["bias"], np.float32).copy())}
    state = conv(tree["Conv_0"], "out")
    for i in range(5):
        blk = tree[f"ConvBlock_{i}"]
        for j in range(2):
            state.update(conv(blk[f"Conv_{j}"], f"blocks.{i}.conv{j}"))
    return state


def load_denoiser(path: str, device="cuda") -> DenoiserUNet:
    """The U-Net with the flax checkpoint at `path`, on `device`, for
    inference (no gradients)."""
    if not path:
        raise ValueError(
            "the neural denoiser needs RendererConfig.neural_weights (a flax "
            "msgpack checkpoint such as examples/denoiser.msgpack): the JAX "
            "package's fallback, flax's PRNGKey(0) initialisation, cannot "
            "be reproduced in torch")
    with open(path, "rb") as f:
        tree = read_msgpack(f.read())
    model = DenoiserUNet()
    model.load_state_dict(params_from_numpy(tree))
    model.requires_grad_(False)
    return model.eval().to(device)


# ---------------------------------------------------------------------------
# msgpack, as flax writes a parameter tree: maps with str keys, arrays as
# ext type 1 (a packed [shape, dtype name, C-order bytes]) and numpy
# scalars as ext type 3
# ---------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.num("B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.take(t & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.num(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.num("b"), self.take(n))
        if 0xD4 <= t <= 0xD8:               # fixext 1, 2, 4, 8, 16
            code = self.num("b")
            return self.ext(code, self.take(1 << (t - 0xD4)))
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if t in scalars:
            return self.num(scalars[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, dtype, buf = read_msgpack(data)
        if dtype == "bfloat16":
            raise ValueError("bfloat16 checkpoint arrays are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def read_msgpack(data: bytes):
    """Decode one msgpack object as `flax.serialization.msgpack_restore`
    does a parameter tree: maps, lists, strings, numbers, and numpy arrays
    and scalars from flax's ext types (not its chunked form of arrays
    over 2 GiB)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out
