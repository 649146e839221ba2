"""PNG reader and writer on the standard library's zlib.

The JAX package reads and writes its textures with Pillow; the port
carries its own codec so that asset ingestion (scene/obj_loader.py) and
export (scene/sponza_like.py) need nothing beyond numpy. The same files go
in and the same pixels come out (tests/test_torch_atlas.py holds both
directions against Pillow).

Read: 8-bit greyscale, greyscale + alpha, RGB and RGBA, non-interlaced,
with all five row filters. Anything else (palettes, 1/2/4/16-bit depths,
Adam7 interlacing, a bad CRC or a truncated stream) raises ValueError.
Write: 8-bit, filter 0 on every row, one IDAT chunk.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples only)
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}


def _chunks(data: bytes):
    """Yield (type, payload) of each chunk, checking lengths and CRCs."""
    pos = len(_SIG)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + n
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG: bad CRC in {kind!r} chunk")
        yield kind, payload
        pos = end + 4
        if kind == b"IEND":
            return
    raise ValueError("PNG: no IEND chunk")


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) -> [h, w*bpp] uint8."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG: {len(raw)} bytes of image data for "
                         f"{h} rows of {stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:                                      # None
            cur = line.copy()
        elif ftype == 1:                                    # Sub
            cur = (np.cumsum(line.reshape(w, bpp).astype(np.int64), 0)
                   % 256).astype(np.uint8).reshape(stride)
        elif ftype == 2:                                    # Up
            cur = line + prev
        elif ftype in (3, 4):                               # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> uint8 [H, W, C], C = 1 (grey), 2 (grey +
    alpha), 3 (RGB) or 4 (RGBA)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def is_png(data: bytes) -> bool:
    return data[:8] == _SIG


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_png` of a PNG file's bytes (an embedded glTF image);
    `path` names it in errors."""
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    head, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
        elif kind == b"PLTE" and head is not None and head[3] == 3:
            raise ValueError(f"{path}: palette PNGs are not read")
    if head is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = head
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: PNG bit depth {depth} / colour type "
                         f"{ctype} is not read (8-bit grey, grey+alpha, "
                         f"RGB, RGBA only)")
    if comp != 0 or filt != 0 or interlace != 0:
        raise ValueError(f"{path}: PNG compression {comp}, filter method "
                         f"{filt}, interlace {interlace} is not read")
    c = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    return _unfilter(raw, h, w, c).reshape(h, w, c)


def to_rgba(img: np.ndarray) -> np.ndarray:
    """uint8 [H,W,C] -> [H,W,4], as Pillow's convert("RGBA") does for
    these modes: grey is copied to R, G and B; missing alpha is 255."""
    if img.ndim == 2:
        img = img[..., None]
    c = img.shape[-1]
    rgb = np.repeat(img[..., :1], 3, -1) if c <= 2 else img[..., :3]
    alpha = img[..., c - 1:] if c in (2, 4) else np.full(
        img.shape[:2] + (1,), 255, np.uint8)
    return np.ascontiguousarray(np.concatenate([rgb, alpha], -1))


def read_texture(path: str) -> np.ndarray:
    """A texture file as uint8 RGBA [H, W, 4]. The port reads PNG only:
    another format raises NotImplementedError, and a PNG it cannot decode
    raises ValueError (the JAX loaders decode with Pillow and drop a file
    that fails)."""
    if not path.lower().endswith(".png"):
        raise NotImplementedError(
            f"{path}: only PNG textures are read (ROADMAP.md A.27)")
    return to_rgba(read_png(path))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Encode uint8 [H,W] or [H,W,C] (C = 1, 2, 3 or 4) as an 8-bit PNG:
    filter 0 on every row, one IDAT chunk."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {v: k for k, v in _CHANNELS.items()}.get(c)
    if ctype is None:
        raise ValueError(f"write_png: {c} channels")
    raw = np.zeros((h, w * c + 1), np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                           0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
        f.write(chunk(b"IEND", b""))
