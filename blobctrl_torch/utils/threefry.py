"""JAX's counter-based PRNG, threefry2x32, as the JAX package uses it, in
torch: a seed draws the numbers ``jax.random`` draws for it, on the CPU or
on the card.

Matches ``jax.random`` 0.9.0 with its defaults, ``jax_enable_x64`` off and
``jax_threefry_partitionable`` on:

  * a key is two uint32 words, ``key(seed)`` = [0, seed mod 2**32];
  * ``fold_in(key, d)`` is threefry2x32(key, (0, d)); ``split(key, n)[j]``
    is threefry2x32(key, (0, j));
  * ``random_bits(key, shape)``: element j (row-major flat index) is
    x0 ^ x1 of threefry2x32(key, (j >> 32, j mod 2**32)), so any block of
    rows of a leading axis can be drawn alone (``rows=``) and equals that
    block of the whole draw;
  * ``uniform``: the top 23 bits as a float in [1, 2), less 1, then
    ``f * (maxval - minval) + minval`` rounded once to float32 (XLA fuses
    it into one multiply-add), then ``max(minval, .)``;
  * ``randint``: JAX's two-draw multiply-and-remainder over
    ``split(key)``;
  * ``normal``: sqrt(2) * erfinv(u), u uniform on [nextafter(-1, 0), 1),
    through the float32 erfinv (Giles' polynomial), log1p and log
    (Cephes') that XLA's CPU backend emits, each multiply-add fused as it
    fuses them.

Keys are int64 CPU tensors of uint32 words, derived (``fold_in``,
``split``) on Python ints. A draw is made on the ``device`` asked for (the
CPU by default), a uint32 word in an int64 tensor masked to 32 bits after
each sum and shift; the uniform's multiply-add is formed in float64 and
rounded once to float32 (``_fma32``), those of erfinv and log through
float64 (``_madd``), and a square root is rounded correctly
(``_sqrt32``). Every other step is an integer operation or one IEEE
float32 or float64 +, -, * or /, each rounded once, so a draw gives the
same bits on every device. R keys (R, 2) draw R rows at once, as
``jax.vmap`` over the keys does.
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def _rotl(v, r: int):
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple:
    """The threefry2x32 block (20 rounds) of the counter pair (x0, x1)
    under the key words (k0, k1): uint32 values as Python ints or int64
    tensors of one shape; -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
    return x0, x1


def _keys(k) -> list:
    """One key (2,) or R keys (R, 2) -> [(k0, k1), ...] as Python ints."""
    rows = torch.as_tensor(k, dtype=torch.int64).reshape(-1, 2).tolist()
    return [(a & _M32, b & _M32) for a, b in rows]


def _many(k) -> bool:
    return torch.as_tensor(k).dim() == 2


def key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s data with x64 off: [0, seed mod
    2**32], int64 on the CPU."""
    return torch.tensor([0, int(seed) % 2 ** 32], dtype=torch.int64)


def as_key(k) -> torch.Tensor:
    """One key from ``k``: an int is ``key(k)``, as ``PRNGKey(k)``; a key's
    two words (a tensor, or a numpy or JAX uint32 array) as its (2,) int64
    tensor."""
    if isinstance(k, numbers.Integral):
        return key(int(k))
    words = [int(w) for w in k]
    if len(words) != 2:
        raise ValueError(f"a key has two words, not {len(words)}")
    return torch.tensor([w % 2 ** 32 for w in words], dtype=torch.int64)


def fold_in(k, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``; of each of R keys (R, 2) too.
    Computed on Python ints: a key costs microseconds on the host."""
    out = torch.tensor([threefry2x32(a, b, 0, int(data) % 2 ** 32)
                        for a, b in _keys(k)], dtype=torch.int64)
    return out if _many(k) else out[0]


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: (num, 2), row j the j-th key; (R, num,
    2) for R keys (R, 2)."""
    out = torch.tensor([[threefry2x32(a, b, 0, j) for j in range(num)]
                        for a, b in _keys(k)], dtype=torch.int64)
    return out if _many(k) else out[0]


def _shape(shape: Sequence[int], rows: Optional[range]) -> tuple:
    """(the drawn block's shape, its first flat index)."""
    shape = tuple(int(s) for s in shape)
    if rows is None:
        return shape, 0
    if not shape or rows.step != 1 or not (
            0 <= rows.start <= rows.stop <= shape[0]):
        raise ValueError(f"rows {rows} is not a block of the leading axis "
                         f"of {shape}")
    inner = math.prod(shape[1:])
    return (len(rows),) + shape[1:], rows.start * inner


def random_bits(k, shape: Sequence[int], rows: Optional[range] = None,
                device=None) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)``, or only its ``rows`` of the
    leading axis, as uint32 values in an int64 tensor on ``device``. For R
    keys (R, 2), (R, *shape): row r the draw of key r, as ``jax.vmap``
    over the keys draws it."""
    out_shape, start = _shape(shape, rows)
    j = torch.arange(start, start + math.prod(out_shape), dtype=torch.int64,
                     device=device)
    if not _many(k):
        (k0, k1), = _keys(k)
        x0, x1 = threefry2x32(k0, k1, j >> 32, j & _M32)
        return (x0 ^ x1).reshape(out_shape)
    # R keys: every operand at (R, n), contiguous (CPU broadcasts are slow)
    words = torch.tensor(_keys(k), dtype=torch.int64, device=device)
    k0, k1 = (words[:, i:i + 1].expand(-1, len(j)).contiguous()
              for i in (0, 1))
    hi, lo = ((v + torch.zeros_like(k0)) for v in (j >> 32, j & _M32))
    x0, x1 = threefry2x32(k0, k1, hi, lo)
    return (x0 ^ x1).reshape((len(words),) + out_shape)


def _fma32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c for a float32 tensor a and float32 numbers b and c,
    rounded once to float32. The product is exact in float64 and the sum
    is rounded there first; that second rounding differs from the single
    one only where the float64 sum falls exactly halfway between two
    float32 numbers (low 29 bits 1 << 28, in float32's normal range) and
    is inexact, and there the sum is moved one float64 step towards the
    exact value (the sign of its rounding error, by TwoSum)."""
    p = a.double() * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    tie = ((s.view(torch.int64) & 0x1FFFFFFF) == (1 << 28)) & (err != 0)
    toward = torch.where(err > 0, math.inf, -math.inf)
    return torch.where(tie, torch.nextafter(s, toward), s).float()


def _madd(a, b, c) -> torch.Tensor:
    """A multiply-add step of XLA's float32 log and erfinv, which it fuses:
    a * b + c, the product exact in float64 and the sum rounded there,
    then to float32; ``b`` a float64 tensor or a Python float. Unlike
    ``_fma32`` it does not repair a float64 sum that is inexact and on a
    float32 tie, where it may be one ulp off (no tested draw meets one);
    it costs four operations against eleven."""
    a, c = (v.double() if isinstance(v, torch.Tensor) else v for v in (a, c))
    return (a * b + c).float()


def uniform(k, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, rows: Optional[range] = None,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, or its
    ``rows``, as a float32 tensor on ``device``."""
    lo32, hi32 = (torch.tensor(v, dtype=torch.float32)
                  for v in (minval, maxval))
    lo, span = lo32.item(), (hi32 - lo32).item()
    bits = random_bits(k, shape, rows, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(_fma32(f, span, lo), lo)


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """a * m mod 2**32 for uint32 values a and m, without leaving int64."""
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (a * (m & 0xFFFF) + hi) & _M32


def randint(k, shape: Sequence[int], minval: int, maxval: int,
            rows: Optional[range] = None, device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32 values), or
    its ``rows``, as an int64 tensor on ``device``. Bounds outside int32
    are refused, as JAX refuses them with x64 off."""
    minval, maxval = int(minval), int(maxval)
    if not all(-2 ** 31 <= v < 2 ** 31 for v in (minval, maxval)):
        raise OverflowError(f"randint bounds {minval}, {maxval} are not "
                            "int32")
    pair = split(k)
    k1, k2 = pair[..., 0, :], pair[..., 1, :]
    higher = random_bits(k1, shape, rows, device)
    lower = random_bits(k2, shape, rows, device)
    span = maxval - minval if maxval > minval else 1
    mult = (2 ** 16 % span) ** 2 % 2 ** 32 % span
    offset = ((_mul32(higher % span, mult) + lower % span) & _M32) % span
    return minval + offset


# XLA's ErfInv32 (Giles, "Approximating the erfinv function"), w < 5 and
# w >= 5, highest power first
_ERFINV_SMALL = [_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)]
_ERFINV_LARGE = [_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682)]
# Cephes' log1p rational function (XLA's EmitLog1p below sqrt(2) - 1)
_LOG1P_NUM = [_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [_f32(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]
# Cephes' logf polynomial (XLA's CPU log)
_LOG_P = [_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_SQRT_HALF = _f32(0.707106781186547524)
_LOG1P_EDGE = _f32(0.41421356237309504880)
_LN2_HI, _LN2_LO = _f32(0.693359375), _f32(-2.12194440e-4)
_MIN_NORMAL = _f32(1.17549435e-38)
_SQRT2 = _f32(math.sqrt(2.0))
_NORMAL_LO = _f32(-1.0 + 2.0 ** -24)   # nextafter(-1, 0) in float32


def _log32(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 log: x = m * 2**e with m in [sqrt(1/2), sqrt(2)),
    log(m) by Cephes' polynomial in m - 1, plus e * ln 2 in two parts."""
    t = torch.clamp_min(x, _MIN_NORMAL).view(torch.int32)
    e = 1.0 + ((t >> 23) - 0x7F).float()
    m = ((t & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    below = m < _SQRT_HALF
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, 0.0)
    m2 = m * m
    m3 = (m2 * m).double()
    p = _LOG_P
    md = m.double()
    y = _madd(_madd(md, p[0], p[1]), md, p[2])
    y1 = _madd(_madd(md, p[3], p[4]), md, p[5])
    y2 = _madd(_madd(md, p[6], p[7]), md, p[8])
    y = _madd(_madd(y, m3, y1), m3, y2)
    y = _madd(y, m3, _LN2_LO * e)
    out = _madd(e, _LN2_HI, _madd(m2, -0.5, md) + y)
    out = torch.where(x == 0, -math.inf, out)
    out = torch.where(x == math.inf, math.inf, out)
    return torch.where((x < 0) | torch.isnan(x), math.nan, out)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """sqrt of float32 x, correctly rounded (torch's own CPU sqrt may be a
    unit off): a candidate s through float64, then moved one step where x
    lies beyond the midpoint between s and its neighbour (for x > 0).
    Those midpoints and their squares are exact in float64."""
    s = torch.sqrt(x.double()).float()
    up, down = (torch.nextafter(s, torch.full_like(s, v))
                for v in (math.inf, -math.inf))
    hi, lo = ((s.double() + n.double()) * 0.5 for n in (up, down))
    x = x.double()
    return torch.where(x > hi * hi, up,
                       torch.where((x < lo * lo) & (s > 0), down, s))


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.full_like(x, coeffs[0])
    x = x.double()
    for c in coeffs[1:]:
        p = _madd(p, x, c)
    return p


def _log1p32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: Cephes' rational function where |x| < sqrt(2)
    - 1, else log(1 + x)."""
    x2 = x * x
    r = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + _madd(x2, -0.5, r)
    return torch.where(x.abs() < _LOG1P_EDGE, small, _log32(x + 1.0))


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's ErfInv32 on float32 x."""
    w = -_log1p32(x * -x)
    small = _poly(w - 2.5, _ERFINV_SMALL) * x
    large = _poly(_sqrt32(w) - 3.0, _ERFINV_LARGE) * x
    out = torch.where(w < 5.0, small, large)
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def normal(k, shape: Sequence[int], rows: Optional[range] = None,
           device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``, or its ``rows``, as a
    float32 tensor on ``device``; for R keys (R, 2) as ``random_bits``."""
    u = uniform(k, shape, _NORMAL_LO, 1.0, rows, device)
    return _SQRT2 * _erfinv32(u)
