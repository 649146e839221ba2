"""Torch port, textures: the atlas packer and mip chain (scene/atlas.py)
bitwise against the JAX package's, transform_uv and sample_atlas against
the JAX functions on the same seeded inputs, and the port's PNG codec
(scene/png.py) against Pillow in both directions.

Tolerances: the atlas tables are bitwise. Samples are held to atol 2e-6
(texel values lie in [0, 1]; XLA:CPU contracts the bilinear mul-adds into
FMAs, torch rounds each product). transform_uv with a rotation goes
through f32 sin/cos, which differ by an ulp between the frameworks, and a
wrap (`% 1.0`) that can land on either side of 1.0: held to atol 1e-6 on
all but a 1e-3 share of lanes, where it may differ by a whole period."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from truetrace_tpu.scene import atlas as jatlas
from truetrace_tpu_torch.scene import atlas as tatlas
from truetrace_tpu_torch.scene import png

import torch_parity  # noqa: F401  (one torch thread per worker)


def _images(seed=0):
    """Textures of the kinds load_obj_scene and users add: uint8 RGB and
    RGBA, a 2-D grey image, float RGBA, sizes no multiple of 16."""
    r = np.random.default_rng(seed)
    return [r.integers(0, 256, (64, 48, 3), dtype=np.uint8),
            r.integers(0, 256, (37, 20, 4), dtype=np.uint8),
            r.integers(0, 256, (16, 16), dtype=np.uint8),
            r.random((40, 72, 4)).astype(np.float32),
            r.integers(0, 256, (128, 96, 3), dtype=np.uint8)]


def _build(mod, images, **kw):
    b = mod.AtlasBuilder(**kw)
    ids = [b.add(im) for im in images]
    return ids, b.build()


@pytest.mark.parametrize("max_width", [4096, 128])
def test_atlas_builder_bitwise(max_width):
    """Shelf packing, 16-aligned rects, the stacked 2x2 mip chain and the
    level origins, bit for bit; and the empty builder."""
    ids_j, (aj, rj, lj) = _build(jatlas, _images(), max_width=max_width)
    ids_t, (at, rt, lt) = _build(tatlas, _images(), max_width=max_width)
    assert ids_j == ids_t
    for a, b in ((aj, at), (rj, rt), (lj, lt)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert lt.shape == (tatlas.N_MIPS,) and (rt[:, :2] % 16 == 0).all()
    for a, b in zip(jatlas.AtlasBuilder().build(),
                    tatlas.AtlasBuilder().build()):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def atlas_pair():
    _, (a, rects, level_y) = _build(tatlas, _images(1))
    return a, rects, level_y


def _lanes(n, n_tex, seed):
    r = np.random.default_rng(seed)
    tid = r.integers(-1, n_tex, n).astype(np.int32)
    uv = r.uniform(-3, 3, (n, 2)).astype(np.float32)
    lod = r.uniform(-1.5, 5.5, n).astype(np.float32)
    lod[:4] = [np.nan, np.inf, -np.inf, 2.5]
    return tid, uv, lod


@pytest.mark.parametrize("mode", ["bilinear", "nearest", "mips"])
def test_sample_atlas_matches_jax(atlas_pair, mode):
    """Wrap-repeat, bilinear or nearest taps, and nearest-mip selection by
    round(lod) across every level (NaN and infinite LODs included)."""
    a, rects, level_y = atlas_pair
    tid, uv, lod = _lanes(3000, rects.shape[0], 5)
    kw = dict(bilinear=mode != "nearest")
    jkw = dict(kw, lod=jnp.asarray(lod), level_y=jnp.asarray(level_y)) \
        if mode == "mips" else kw
    tkw = dict(kw, lod=torch.from_numpy(lod),
               level_y=torch.from_numpy(level_y).long()) \
        if mode == "mips" else kw
    want = np.asarray(jatlas.sample_atlas(
        jnp.asarray(a), jnp.asarray(rects), jnp.asarray(tid),
        jnp.asarray(uv), **jkw))
    got = tatlas.sample_atlas(
        torch.from_numpy(a), torch.from_numpy(rects).long(),
        torch.from_numpy(tid).long(), torch.from_numpy(uv), **tkw).numpy()
    assert got.shape == (3000, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_transform_uv_matches_jax():
    """Scale, offset and rotation about (0.5, 0.5); identity rows pass
    through untouched."""
    r = np.random.default_rng(9)
    n = 4000
    uv = r.uniform(-2, 3, (n, 2)).astype(np.float32)
    so = np.concatenate([r.uniform(0.2, 4, (n, 2)), r.uniform(-1, 1, (n, 2))],
                        1).astype(np.float32)
    rot = r.uniform(-3.2, 3.2, n).astype(np.float32)
    so[:500] = (1, 1, 0, 0)
    rot[:1000] = 0.0
    want = np.asarray(jatlas.transform_uv(jnp.asarray(uv), jnp.asarray(so),
                                          jnp.asarray(rot)))
    got = tatlas.transform_uv(torch.from_numpy(uv), torch.from_numpy(so),
                              torch.from_numpy(rot)).numpy()
    np.testing.assert_array_equal(got[:500], uv[:500])
    close = np.isclose(got, want, rtol=0, atol=1e-6).all(-1)
    assert close.mean() >= 0.999
    d = np.abs(got - want)[~close]
    np.testing.assert_allclose(np.minimum(d, np.abs(d - 1.0)), 0, atol=1e-6)


# ---------------------------------------------------------------------------
# PNG codec against Pillow
# ---------------------------------------------------------------------------

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
CHANNELS_OF_TYPE = {0: 1, 4: 2, 2: 3, 6: 4}   # PNG colour type -> channels


def _content(h, w, c, seed):
    """Smooth gradients, flat areas, stripes and noise: rows on which
    Pillow's adaptive filtering picks each of the five filters."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    planes = []
    for k in range(c):
        p = (x * (k + 1) + y * 3) % 256
        p = np.where(y % 7 == 0, 200, p)
        p = np.where((y // 5) % 3 == 1, (x * y) % 256, p)
        p = np.where(y > h * 3 // 4, r.integers(0, 256, (h, w)), p)
        planes.append(p)
    return np.stack(planes, -1).astype(np.uint8)


def _filters(path):
    """The row filter types used in a PNG file."""
    data = open(path, "rb").read()
    pos, idat, head = 8, b"", None
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        if kind == b"IHDR":
            head = data[pos + 8:pos + 16]
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, c = int.from_bytes(head[:4], "big"), CHANNELS_OF_TYPE[data[25]]
    raw = zlib.decompress(idat)
    return set(raw[::w * c + 1])


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_pillow_files(tmp_path, mode):
    """Files Pillow writes (adaptive row filters) decode to Pillow's own
    pixels, and to_rgba equals Pillow's convert("RGBA")."""
    img = _content(61, 45, MODES[mode], MODES[mode])
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(img[..., 0] if mode == "L" else img, mode).save(path)
    got = png.read_png(path)
    pil = Image.open(path)
    want = np.asarray(pil)
    np.testing.assert_array_equal(got, want.reshape(got.shape))
    np.testing.assert_array_equal(png.to_rgba(got),
                                  np.asarray(pil.convert("RGBA")))
    if mode in ("RGB", "RGBA"):
        assert {1, 2, 4} <= _filters(path)     # Sub, Up and Paeth rows


def _encode_filtered(img, types):
    """A PNG whose row y uses filter types[y % len(types)] (PNG spec
    section 9), written here so that rows of every type occur; Pillow's
    encoder never picks Average."""
    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int64)
    prev = np.zeros_like(cur)
    prev[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, c:] = cur[:, :-c]
    upleft = np.zeros_like(cur)
    upleft[:, c:] = prev[:, :-c]
    p = left + prev - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prev, upleft))
    pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2, 4: paeth}
    rows = []
    for y in range(h):
        t = types[y % len(types)]
        res = (cur[y] - (pred[t][y] if t else 0)) % 256
        rows.append(bytes([t]) + res.astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, payload):
        return (len(payload).to_bytes(4, "big") + kind + payload
                + zlib.crc32(kind + payload).to_bytes(4, "big"))
    head = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, ctype, 0, 0, 0]))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_every_row_filter(tmp_path, mode):
    """Rows of all five filter types, each decoded as Pillow decodes
    them."""
    img = _content(40, 29, MODES[mode], 11)
    path = str(tmp_path / f"{mode}.png")
    open(path, "wb").write(_encode_filtered(img, (3, 4, 1, 0, 2, 3, 3)))
    assert _filters(path) == {0, 1, 2, 3, 4}
    want = np.asarray(Image.open(path))
    np.testing.assert_array_equal(png.read_png(path),
                                  want.reshape(img.shape))
    np.testing.assert_array_equal(png.read_png(path), img)


@pytest.mark.parametrize("mode", list(MODES))
def test_pillow_reads_port_files(tmp_path, mode):
    """Files the port writes (filter 0) open in Pillow with the same mode
    and pixels, and read back through the port unchanged."""
    img = _content(33, 70, MODES[mode], 7)
    if mode == "L":
        img = img[..., 0]
    path = str(tmp_path / f"{mode}.png")
    png.write_png(path, img)
    pil = Image.open(path)
    assert pil.mode == mode and pil.size == (70, 33)
    np.testing.assert_array_equal(np.asarray(pil), img)
    np.testing.assert_array_equal(png.read_png(path),
                                  img.reshape(33, 70, -1))
    assert _filters(path) == {0}


def test_png_rejects_what_it_does_not_read(tmp_path):
    """Palette, 16-bit and 1-bit files, a corrupt CRC, truncated data and
    a non-PNG raise ValueError; nothing is decoded halfway."""
    p = str(tmp_path / "x.png")
    cases = {"palette": Image.new("P", (8, 8)),
             "16-bit": Image.fromarray(np.zeros((8, 8), np.uint16)),
             "1-bit": Image.new("1", (8, 8))}
    for name, im in cases.items():
        im.save(p)
        with pytest.raises(ValueError):
            png.read_png(p)
    png.write_png(p, np.zeros((8, 8, 3), np.uint8))
    data = bytearray(open(p, "rb").read())
    bad = bytearray(data)
    bad[40] ^= 0xFF                         # inside the IDAT payload
    for blob in (bytes(bad), bytes(data[:-20]), b"GIF89a" + bytes(30)):
        open(p, "wb").write(blob)
        with pytest.raises(ValueError):
            png.read_png(p)
    with pytest.raises(ValueError):
        png.write_png(p, np.zeros((4, 4, 3), np.float32))
