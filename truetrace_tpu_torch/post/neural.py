"""Learned denoiser, the OIDN slot (reference UnityDenoiserPlugin.cs).

Port of `truetrace_tpu/post/neural.py`: the 3-level U-Net
(`DenoiserUNet`, ~200k parameters) over log colour, albedo and normal,
predicting a residual on the log colour. Its convolutions are
`torch.nn.functional.conv2d`, as the JAX package's are XLA convolutions
(flax `nn.Conv`) outside any Pallas kernel; they run in float32 (no
TF32) with cuDNN's deterministic algorithms.

Training: `init_params` (flax's default `nn.Conv` initialisation, from
an explicit torch.Generator: flax's distribution, not its bits),
`loss_fn` (L1 in log space) and `make_train_step` (torch.optim.Adam with
optax.adam's defaults; `adam_state_from_numpy` / `adam_state_to_numpy`
carry an optax ScaleByAdamState across). scripts/torch_train_denoiser.py
trains on pairs the port renders.

Checkpoints are flax's (msgpack, as `flax.serialization.to_bytes` writes
them; `examples/denoiser.msgpack` is one), read and written here without
msgpack or flax: `read_msgpack` / `write_msgpack` code the format,
`params_from_numpy` / `params_to_numpy` turn the flax parameter tree
(HWIO kernels) into the module's state (OIHW) and back.
"""
from __future__ import annotations

import math
import struct
from typing import Optional, Sequence

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


def _conv_flags():
    """float32 convolutions (no TF32) on cuDNN's deterministic
    algorithms, chosen without autotuning, forward and backward."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=False,
        deterministic=True, allow_tf32=False)


def _residual(model, x):
    """The network on NHWC features x [B,H,W,9] -> [B,H,W,3]."""
    return model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def denoise(model: DenoiserUNet, noisy, albedo, normal):
    """[H,W,3] noisy radiance -> denoised radiance (non-negative).
    The convolutions run in float32 (no TF32) and with cuDNN's
    deterministic algorithms, chosen without autotuning, so a frame and
    its CUDA-graph replay launch the same ones."""
    with _conv_flags():
        resid = _residual(model, features(noisy, albedo, normal)[None])[0]
    return torch.clamp(torch.expm1(_pre_color(noisy) + resid), min=0.0)


# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def init_params(generator: Optional[torch.Generator] = None,
                device="cuda") -> DenoiserUNet:
    """A fresh U-Net on `device` with flax's default nn.Conv
    initialisation: kernels lecun-normal (variance_scaling(1, "fan_in",
    "truncated_normal"): a normal cut at two standard deviations, scaled
    to variance 1 / fan_in), biases zero. The draws come from
    `generator` (a CPU torch.Generator) on the CPU, so every device gets
    the same weights; flax's PRNGKey bits cannot be reproduced."""
    model = DenoiserUNet()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                m.bias.zero_()
    return model.to(device)


def loss_fn(model: DenoiserUNet, batch: dict):
    """L1 in log space (robust to HDR outliers and fireflies) of the
    denoised batch: batch noisy, target, albedo, normal [B,H,W,3]."""
    x = features(batch["noisy"], batch["albedo"], batch["normal"])
    pred = _pre_color(batch["noisy"]) + _residual(model, x)
    return torch.mean(torch.abs(pred - _pre_color(batch["target"])))


# optax.adam's defaults (eps_root 0)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def make_train_step(learning_rate: float = 1e-3, device="cuda"):
    """Adam on `loss_fn`, as the JAX package's optax.adam step. Returns
    (init, step): init(model) -> the torch.optim.Adam of a model on
    `device`; step(model, opt, batch) -> the loss before the update (0-d,
    on the device), the model and the optimizer updated in place (the JAX
    step returns new params and opt_state instead)."""
    dev = torch.device(device).type

    def init(model: DenoiserUNet) -> torch.optim.Adam:
        for name, p in model.named_parameters():
            if p.device.type != dev:
                raise ValueError(f"{name} is on {p.device}, not {device}")
        return torch.optim.Adam(model.parameters(), lr=learning_rate,
                                betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
                                foreach=False)

    def step(model: DenoiserUNet, opt: torch.optim.Adam, batch: dict):
        opt.zero_grad(set_to_none=True)
        with _conv_flags():
            loss = loss_fn(model, batch)
            loss.backward()
        opt.step()
        return loss.detach()

    return init, step


def adam_state_from_numpy(opt: torch.optim.Adam, model: DenoiserUNet,
                          state: dict) -> None:
    """Load an optax ScaleByAdamState {"count", "mu", "nu"} (numpy
    leaves, mu and nu flax parameter trees) into `opt`, the optimizer
    `make_train_step`'s init made for `model`."""
    named = dict(model.named_parameters())
    mu, nu = params_from_numpy(state["mu"]), params_from_numpy(state["nu"])
    step = torch.tensor(float(np.asarray(state["count"])),
                        dtype=torch.float32)
    for name, p in named.items():
        opt.state[p] = {"step": step.clone(),
                        "exp_avg": mu[name].to(p.device),
                        "exp_avg_sq": nu[name].to(p.device)}


def adam_state_to_numpy(opt: torch.optim.Adam, model: DenoiserUNet) -> dict:
    """`opt`'s state as an optax ScaleByAdamState {"count", "mu", "nu"}
    of numpy leaves (the inverse of adam_state_from_numpy)."""
    named = dict(model.named_parameters())
    st = [opt.state[p] for p in named.values()]
    if not st or not st[0]:
        raise ValueError("the optimizer has taken no step")
    moments = lambda key: params_to_numpy(
        {n: s[key] for n, s in zip(named, st)})
    return {"count": np.int32(int(st[0]["step"])), "mu": moments("exp_avg"),
            "nu": moments("exp_avg_sq")}


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


def params_to_numpy(state: dict) -> dict:
    """The inverse of params_from_numpy: this module's state dict (or any
    dict of its parameter names) -> the flax parameter tree of numpy
    leaves, in flax's key order (ConvBlock_0..4, then Conv_0; kernel
    before bias), kernels [3,3,I,O]."""
    def conv(name):
        k = state[f"{name}.weight"].detach().cpu().numpy()
        return {"kernel": np.ascontiguousarray(k.transpose(2, 3, 1, 0)),
                "bias": state[f"{name}.bias"].detach().cpu().numpy().copy()}
    tree = {f"ConvBlock_{i}": {f"Conv_{j}": conv(f"blocks.{i}.conv{j}")
                               for j in range(2)} for i in range(5)}
    tree["Conv_0"] = conv("out")
    return tree


def load_denoiser(path: str, device="cuda") -> DenoiserUNet:
    """The U-Net with the flax checkpoint at `path`, on `device`, for
    inference (no gradients)."""
    if not path:
        raise ValueError(
            "the neural denoiser needs RendererConfig.neural_weights (a flax "
            "msgpack checkpoint such as examples/denoiser.msgpack): the JAX "
            "package's fallback, flax's PRNGKey(0) initialisation, cannot "
            "be reproduced in torch (init_params draws from flax's "
            "distribution, for training)")
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
    over 1 GiB)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def _pack(x, out: list) -> None:
    """Append x's msgpack encoding as msgpack.packb writes it (bin type
    for bytes; arrays and numpy scalars as flax's ext types)."""
    def head(n, small_base, small_max, codes):
        if n <= small_max and small_base is not None:
            out.append(struct.pack(">B", small_base | n))
            return
        for code, fmt, lim in codes:
            if n < lim:
                out.append(struct.pack(">B" + fmt, code, n))
                return
        raise ValueError(f"msgpack object of {n} entries is too large")
    if x is None or isinstance(x, bool):
        out.append({None: b"\xc0", False: b"\xc2", True: b"\xc3"}[x])
    elif isinstance(x, int):
        if 0 <= x < 128:
            out.append(struct.pack(">B", x))
        elif -32 <= x < 0:
            out.append(struct.pack(">b", x))
        elif x >= 0:
            for code, fmt, lim in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                   (0xCE, "I", 1 << 32), (0xCF, "Q", 1 << 64)):
                if x < lim:
                    out.append(struct.pack(">B" + fmt, code, x))
                    break
        else:
            for code, fmt, lim in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                   (0xD2, "i", 1 << 31), (0xD3, "q", 1 << 63)):
                if x >= -lim:
                    out.append(struct.pack(">B" + fmt, code, x))
                    break
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        b = x.encode()
        head(len(b), 0xA0, 31, ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16),
                                (0xDB, "I", 1 << 32)))
        out.append(b)
    elif isinstance(x, bytes):
        head(len(x), None, -1, ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16),
                                (0xC6, "I", 1 << 32)))
        out.append(x)
    elif isinstance(x, (list, tuple)):
        head(len(x), 0x90, 15, ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        head(len(x), 0x80, 15, ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        if a.dtype.hasobject or a.nbytes > 1 << 30:
            raise ValueError("flax's chunked form of arrays over 1 GiB and "
                             "object arrays are not supported")
        data = write_msgpack((a.shape, a.dtype.name, a.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR
        n = len(data)
        if n in (1, 2, 4, 8, 16):
            out.append(struct.pack(">Bb", 0xD4 + n.bit_length() - 1, code))
        else:
            head(n, None, -1, ((0xC7, "B", 1 << 8), (0xC8, "H", 1 << 16),
                               (0xC9, "I", 1 << 32)))
            out.append(struct.pack(">b", code))
        out.append(data)
    else:
        raise ValueError(f"cannot encode {type(x).__name__} as msgpack")


def write_msgpack(tree) -> bytes:
    """Encode a parameter tree (dicts with str keys, numpy arrays and
    scalars, Python numbers, strings, lists) as
    `flax.serialization.to_bytes` does: the bytes it writes for the same
    tree, which `read_msgpack` and flax's `from_bytes` decode."""
    out = []
    _pack(tree, out)
    return b"".join(out)
