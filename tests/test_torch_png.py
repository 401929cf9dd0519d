"""The port's PNG codec (``blobctrl_torch.utils.png``) against PIL, which
serves here only as the oracle: ``decode_png`` bit-equal to
``np.asarray(Image.open(f).convert("RGB"))`` for PIL-written files of every
mode PIL writes, and for files written here of every colour type, bit depth,
filter type and interlace method the codec supports; ``encode_png`` read
back by PIL bit-equal; JPEG, garbage and decompression bombs raise
ValueError."""

import io
import struct
import tracemalloc
import zlib

import numpy as np
import pytest

from blobctrl_torch.utils import png

Image = pytest.importorskip("PIL.Image")


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _ramp(rng, shape, hi=256):
    """Smooth content plus noise, so every filter predicts something."""
    base = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 3
    base = base.reshape(shape[:2] + (1,) * (len(shape) - 2))
    return ((base + rng.randint(0, 40, shape)) % hi)


@pytest.mark.parametrize("mode,shape,opts", [
    ("RGB", (37, 53, 3), {}), ("RGBA", (29, 31, 4), {}),
    ("L", (41, 23), {}), ("LA", (17, 19, 2), {}), ("1", (13, 27), {}),
    ("I;16", (11, 14), {}), ("P", (21, 18), {}), ("P", (21, 18), {"bits": 4}),
    ("P", (21, 18), {"bits": 2}), ("P", (21, 18), {"bits": 1}),
    ("RGB", (33, 45, 3), {"optimize": True}),
    ("L", (19, 25), {"transparency": 7})])
def test_decode_matches_pil_on_pil_files(mode, shape, opts):
    rng = np.random.RandomState(len(shape) * 7 + shape[0])
    if mode == "1":
        im = Image.fromarray((rng.rand(*shape) > 0.5).astype(np.uint8) * 255
                             ).convert("1")
    elif mode == "I;16":
        im = Image.fromarray(rng.randint(0, 600, shape).astype(np.uint16))
    elif mode == "P":
        levels = 2 ** opts.get("bits", 8)
        im = Image.fromarray(rng.randint(0, levels, shape).astype(np.uint8),
                             "P")
        im.putpalette(rng.randint(0, 256, 3 * levels).astype(np.uint8)
                      .tolist())
    else:
        im = Image.fromarray(_ramp(rng, shape).astype(np.uint8), mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **opts)
    data = buf.getvalue()
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == shape[:2] + (3,)
    np.testing.assert_array_equal(got, _pil_rgb(data))


def _chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _filter_rows(rows, bpp, ftype):
    """Filter each row of bytes (rows, stride) with one filter type."""
    out = []
    prev = np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if ftype == 0:
            f = r
        elif ftype == 1:
            f = r - left
        elif ftype == 2:
            f = r - prev
        elif ftype == 3:
            f = r - ((left + prev) >> 1)
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            f = r - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, prev, upleft))
        out.append(np.concatenate([[ftype], f & 255]).astype(np.uint8))
        prev = r
    return np.concatenate(out).tobytes() if out else b""


def _pack(samples, depth):
    """(h, w, spp) integer samples -> (h, stride) bytes."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(h, -1).astype(np.uint8)
    return np.packbits(bits, axis=1)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _write(samples, ctype, depth, ftype, interlace=False, palette=None,
           trns=None):
    h, w, spp = samples.shape
    bpp = max(1, spp * depth // 8)
    if interlace:
        raw = b"".join(
            _filter_rows(_pack(samples[y0::dy, x0::dx], depth), bpp, ftype)
            for x0, y0, dx, dy in ADAM7
            if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter_rows(_pack(samples, depth), bpp, ftype)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    # two IDAT chunks: the codec must join them
    z = zlib.compress(raw)
    return (out + _chunk(b"IDAT", z[:len(z) // 2])
            + _chunk(b"IDAT", z[len(z) // 2:]) + _chunk(b"IEND", b""))


FORMATS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
           (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype,depth", FORMATS)
def test_decode_matches_pil_every_type_depth_and_filter(ctype, depth, ftype,
                                                        interlace):
    rng = np.random.RandomState(ctype * 100 + depth * 10 + ftype)
    spp = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    h, w = 13, 11   # odd sizes: partial bytes, short Adam7 passes
    hi = 2 ** depth
    samples = _ramp(rng, (h, w, spp), hi)
    if ctype == 0 and depth == 16:
        samples = rng.randint(0, 600, (h, w, 1))   # PIL clips at 255
    palette = trns = None
    if ctype == 3:
        palette = rng.randint(0, 256, (min(hi, 256), 3))
        trns = bytes(range(min(hi, 256)))[:5]
    elif ctype == 2 and depth == 8:
        trns = struct.pack(">HHH", 1, 2, 3)
    data = _write(samples, ctype, depth, ftype, interlace, palette, trns)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


@pytest.mark.parametrize("shape", [(9, 14), (23, 17, 3), (8, 31, 4),
                                   (512, 512, 3)])
def test_encode_reads_back_in_pil(shape):
    a = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    back = np.asarray(Image.open(io.BytesIO(png.encode_png(a))))
    np.testing.assert_array_equal(back, a)
    rgb = a if a.ndim == 3 and a.shape[2] == 3 else None
    if rgb is not None:
        np.testing.assert_array_equal(png.decode_png(png.encode_png(a)), a)


def test_jpeg_garbage_and_unsupported_raise_value_error():
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        png.decode_png(buf.getvalue())
    for junk in (b"not an image", b"", b"\x89PNG\r\n\x1a\n" + b"\0" * 20):
        with pytest.raises(ValueError):
            png.decode_png(junk)
    good = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(good[:-5] + b"x" + good[-4:])
    bad_depth = _write(np.zeros((2, 2, 3), np.int64), 2, 8, 0)
    bad_depth = bad_depth.replace(struct.pack(">IIBB", 2, 2, 8, 2),
                                  struct.pack(">IIBB", 2, 2, 4, 2))
    with pytest.raises(ValueError):
        png.decode_png(bad_depth)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError):
        png.encode_png(np.zeros((2, 2, 2), np.uint8))


def bomb(kind: str) -> bytes:
    """A PNG that claims more memory than its bytes: "data" is a 16x16 RGB
    header over 64 MiB of deflated zeros (about 64 KiB), "interlaced" the
    same with Adam7, "header" a 20000x20000 header over one row."""
    side, rows, inter = {"data": (16, 64 << 20, 0),
                         "interlaced": (16, 64 << 20, 1),
                         "header": (20000, 3 * 20000 + 1, 0)}[kind]
    z = zlib.compressobj()
    idat = b"".join(z.compress(bytes(1 << 20)) for _ in range(rows >> 20))
    idat += z.compress(bytes(rows % (1 << 20))) + z.flush()
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", side, side, 8, 2, 0, 0, inter))
        + _chunk(b"IDAT", idat) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("kind,word", [("data", "inflates past"),
                                       ("interlaced", "inflates past"),
                                       ("header", "decompression-bomb")])
def test_decompression_bombs_raise_value_error(kind, word):
    data = bomb(kind)
    assert len(data) < 1 << 17
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match=word):
            png.decode_png(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20, peak     # inflated no further than the header
    if kind == "header":            # where PIL refuses it too
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(data))
