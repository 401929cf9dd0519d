"""Host-side uint8 image resizing that agrees bit for bit with the
libraries the JAX package calls (it resizes with PIL and cv2; the port's
machines need neither).

  * ``pil_resize``: PIL's two-pass convolution resampler (horizontal pass,
    then vertical, each rounding to uint8), its filter support widened by
    the scale on downscale, the normalized coefficients quantized to
    ``PRECISION_BITS`` = 22 fractional bits and each sum rounded with a
    half-unit bias before it is clipped. BICUBIC (a = -0.5) and LANCZOS
    (a = 3).
  * ``cv2_resize_linear``: OpenCV's INTER_LINEAR for 8-bit images: float32
    source coordinates, 11-bit fixed-point weights, a horizontal pass into
    int sums and the vertical pass with its shift-and-round cast; an exact
    2x reduction is the 2x2 box average, as cv2 switches to INTER_AREA
    there.

Images are (H, W) or (H, W, C) uint8 numpy arrays.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _pil_coeffs(in_size: int, out_size: int, filt: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` -> (index
    (out, ksize), int64 weights (out, ksize)); unused taps weigh 0."""
    fn, support = FILTERS[filt]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)
        for x in range(xmax):
            k = w[x] / ww if ww != 0.0 else w[x]
            kk[xx, x] = int((-0.5 if k < 0 else 0.5) + k * (1 << PRECISION_BITS))
            idx[xx, x] = xmin + x
    return idx, kk


def _pil_pass(img: np.ndarray, axis: int, out_size: int, filt: str
              ) -> np.ndarray:
    """One 8-bit pass of PIL's resampler along ``axis`` of (H, W, C)."""
    idx, kk = _pil_coeffs(img.shape[axis], out_size, filt)
    src = np.moveaxis(img.astype(np.int64), axis, 0)       # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for k in range(idx.shape[1]):
        acc += src[idx[:, k]] * kk[:, k][:, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255)
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def pil_resize(img: np.ndarray, size: Tuple[int, int],
               filt: str = "bicubic") -> np.ndarray:
    """``Image.fromarray(img).resize(size, filter)``; size is (width,
    height) as PIL takes it."""
    arr = np.asarray(img, np.uint8)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    w, h = size
    if (arr.shape[1], arr.shape[0]) == (w, h):
        out = arr.copy()
    else:
        out = arr
        if w != arr.shape[1]:
            out = _pil_pass(out, 1, w, filt)
        if h != arr.shape[0]:
            out = _pil_pass(out, 0, h, filt)
    return out[..., 0] if squeeze else out


def _cv_linear_coeffs(in_size: int, out_size: int, clamp: bool):
    """OpenCV's INTER_LINEAR source offsets and 11-bit weights per output
    index: (x0, x1, w0, w1). Along x an offset outside the source is pinned
    to its edge with weights (1, 0) (``clamp``); along y only the rows are
    pinned and the weights stay as computed."""
    scale = 1.0 / (out_size / in_size)
    pos = np.float32((np.arange(out_size, dtype=np.float64) + 0.5) * scale
                     - 0.5)
    sx = np.floor(pos).astype(np.int64)
    f = (pos - sx.astype(np.float32)).astype(np.float32)
    if clamp:
        low = sx < 0
        f[low], sx[low] = 0.0, 0
        high = sx >= in_size - 1
        f[high], sx[high] = 0.0, in_size - 1
    w0 = np.round((np.float32(1.0) - f) * np.float32(2048)).astype(np.int64)
    w1 = np.round(f * np.float32(2048)).astype(np.int64)
    return (np.clip(sx, 0, in_size - 1), np.clip(sx + 1, 0, in_size - 1),
            w0, w1)


def cv2_resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size)`` (INTER_LINEAR) on uint8; size is (width,
    height) as cv2 takes it."""
    arr = np.asarray(img, np.uint8)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    h, w = arr.shape[:2]
    ow, oh = size
    if (ow, oh) == (w, h):
        out = arr.copy()
    elif (w, h) == (2 * ow, 2 * oh):
        # cv2 reduces an exact 2x with INTER_AREA: the rounded 2x2 mean
        s = arr.astype(np.int32)
        out = ((s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2]
                + s[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    else:
        x0, x1, a0, a1 = _cv_linear_coeffs(w, ow, True)
        y0, y1, b0, b1 = _cv_linear_coeffs(h, oh, False)
        s = arr.astype(np.int64)
        rows = (s[:, x0] * a0[None, :, None]
                + s[:, x1] * a1[None, :, None])          # (H, OW, C)
        out = ((((b0[:, None, None] * (rows[y0] >> 4)) >> 16)
                + ((b1[:, None, None] * (rows[y1] >> 4)) >> 16) + 2) >> 2)
        out = out.astype(np.uint8)
    return out[..., 0] if squeeze else out
