"""PNG decoding and encoding on the standard library's ``zlib``.

The JAX package reads and writes images through PIL; the card's machine has
no PIL, so the port keeps this codec instead. ``decode_png`` gives what
``np.asarray(PIL.Image.open(f).convert("RGB"))`` gives:

- colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
  (RGBA) at bit depth 8, gray and palette at 1, 2 and 4 bits, every type
  PNG allows at 16 bits;
- every filter type, and Adam7 interlacing;
- alpha and ``tRNS`` dropped, as PIL drops them in ``convert("RGB")``;
- low-bit gray scaled to 0..255 (2 bits x 85, 4 bits x 17, 1 bit x 255);
- 16-bit colour reduced to its high byte, 16-bit gray clipped to 255 (PIL
  opens it as mode "I;16" and converts by clipping, not by scaling).

Anything else raises ``ValueError`` naming what is not supported, JPEG
included, and so does a decompression bomb: an image of more than
``MAX_PIXELS`` pixels (PIL's ``DecompressionBombError`` bound), or image
data that inflates past the size its header implies. The data is inflated
only that far, so a small body cannot claim more memory than its image.
``encode_png`` writes uint8 gray, RGB and RGBA images.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# twice PIL's Image.MAX_IMAGE_PIXELS: where PIL raises DecompressionBombError
MAX_PIXELS = 2 * 89_478_485
# colour type -> (samples per pixel, bit depths allowed)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes):
    """-> [(type, payload)] up to IEND, CRCs checked."""
    if data[:2] == b"\xff\xd8":
        raise ValueError("JPEG data: only PNG decoding is supported")
    if data[:8] != _SIGNATURE:
        raise ValueError("not PNG data (bad signature)")
    out, pos = [], 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), \
            data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if len(payload) != length or pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        out.append((kind, payload))
        pos += 12 + length
        if kind == b"IEND":
            return out


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of one (sub-)image: raw holds rows x (1 +
    stride) bytes, each row its filter type then its bytes; bpp is the
    bytes per complete pixel (at least 1). A byte depends on the one to
    its left, above and above-left, so the bytes of one anti-diagonal of
    pixels are independent: the image is rebuilt a diagonal at a time."""
    if raw.size < rows * (stride + 1):
        raise ValueError("truncated PNG image data")
    raw = raw[:rows * (stride + 1)].reshape(rows, stride + 1)
    ftypes = raw[:, 0].astype(np.int64)
    if ftypes.max() > 4:
        raise ValueError(f"unsupported PNG filter type {int(ftypes.max())}")
    ncols = stride // bpp
    line = raw[:, 1:].reshape(rows, ncols, bpp).astype(np.int32)
    # padded by a zero row above and a zero pixel to the left
    out = np.zeros((rows + 1, ncols + 1, bpp), np.int32)
    for d in range(rows + ncols - 1):
        ys = np.arange(max(0, d - ncols + 1), min(rows, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftypes[ys][:, None], [np.zeros_like(a), a, b,
                                               (a + b) >> 1, paeth])
        out[ys + 1, xs + 1] = (line[ys, xs] + pred) & 255
    return out[1:, 1:].reshape(rows, stride).astype(np.uint8)


def _samples(rows: np.ndarray, width: int, spp: int, depth: int
             ) -> np.ndarray:
    """Unfiltered row bytes -> (rows, width, spp) samples as integers."""
    n = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(n, -1)[:, :width * spp].reshape(
            n, width, spp).astype(np.int32)
    if depth == 8:
        return rows[:, :width * spp].reshape(n, width, spp).astype(np.int32)
    bits = np.unpackbits(rows, axis=1).reshape(n, -1, depth)
    weights = 1 << np.arange(depth - 1, -1, -1)
    vals = (bits * weights).sum(-1)
    return vals[:, :width].reshape(n, width, 1).astype(np.int32)


def _pixels(idat: bytes, width: int, height: int, spp: int, depth: int,
            interlaced: bool) -> np.ndarray:
    """The image's samples (height, width, spp)."""
    bpp = max(1, spp * depth // 8)

    def stride(w):
        return (w * spp * depth + 7) // 8

    if interlaced:
        expected = sum(ph * (stride(pw) + 1) for pw, ph in (
            (max(0, (width - x0 + dx - 1) // dx),
             max(0, (height - y0 + dy - 1) // dy))
            for x0, y0, dx, dy in _ADAM7) if pw and ph)
    else:
        expected = height * (stride(width) + 1)
    inflate = zlib.decompressobj()
    try:
        raw = inflate.decompress(idat, expected + 1)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from None
    if len(raw) > expected:
        raise ValueError(f"PNG image data inflates past the {expected} "
                         f"bytes its header implies")
    raw = np.frombuffer(raw, np.uint8)
    if not interlaced:
        return _samples(_unfilter(raw, height, stride(width), bpp), width,
                        spp, depth)
    out = np.zeros((height, width, spp), np.int32)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = max(0, (width - x0 + dx - 1) // dx)
        ph = max(0, (height - y0 + dy - 1) // dy)
        if pw == 0 or ph == 0:
            continue
        n = ph * (stride(pw) + 1)
        sub = _unfilter(raw[pos:pos + n], ph, stride(pw), bpp)
        out[y0::dy, x0::dx] = _samples(sub, pw, spp, depth)
        pos += n
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")`` gives it
    (see the module docstring). Raises ValueError on anything else."""
    chunks = _chunks(bytes(data))
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError("PNG without a valid IHDR chunk")
    width, height, depth, ctype, comp, filt, inter = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"unsupported PNG colour type {ctype} at bit depth "
                         f"{depth}")
    if comp != 0 or filt != 0 or inter not in (0, 1):
        raise ValueError(f"unsupported PNG compression {comp}, filter "
                         f"method {filt} or interlace method {inter}")
    if width == 0 or height == 0:
        raise ValueError("PNG with an empty image")
    if width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width}x{height} pixels is above the "
                         f"{MAX_PIXELS}-pixel decompression-bomb limit")
    idat = b"".join(p for k, p in chunks if k == b"IDAT")
    if not idat:
        raise ValueError("PNG without image data")
    spp = _COLOR_TYPES[ctype][0]
    px = _pixels(idat, width, height, spp, depth, inter == 1)
    if ctype == 3:
        plte = [p for k, p in chunks if k == b"PLTE"]
        if not plte or len(plte[0]) % 3:
            raise ValueError("palette PNG without a valid PLTE chunk")
        pal = np.frombuffer(plte[0], np.uint8).reshape(-1, 3)
        # indices past the palette read black, as PIL pads its palette
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal[:256]
        return full[px[..., 0]]
    if depth == 16:
        if ctype in (0, 4):
            gray = np.minimum(px[..., 0], 255)   # PIL's "I;16" -> RGB clip
            if ctype == 4:                       # "LA;16B": the high byte
                gray = px[..., 0] >> 8
            return np.repeat(gray[..., None], 3, -1).astype(np.uint8)
        return (px[..., :3] >> 8).astype(np.uint8)
    if ctype == 0:
        scale = {1: 255, 2: 85, 4: 17, 8: 1}[depth]
        return np.repeat((px * scale).astype(np.uint8), 3, -1)
    if ctype == 4:
        return np.repeat(px[..., :1].astype(np.uint8), 3, -1)
    return px[..., :3].astype(np.uint8)


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes
    (filter type 0 on every row, zlib at its default level 6)."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(a.shape[-1])}.get(a.ndim)
    if ctype is None or a.shape[0] == 0 or a.shape[1] == 0:
        raise ValueError(f"encode_png takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"got {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                          0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
