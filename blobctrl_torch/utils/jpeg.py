"""JPEG decoding on numpy alone.

The JAX package reads images through PIL, which decodes JPEG with
libjpeg(-turbo) at its defaults; the card's machine has no PIL, so the port
keeps this decoder instead. ``decode_jpeg`` gives what
``np.asarray(PIL.Image.open(f).convert("RGB"))`` gives, bit for bit:

- baseline and extended sequential (SOF0/SOF1) and progressive (SOF2)
  Huffman-coded frames at 8-bit precision, restart intervals included;
  progressive scans with spectral selection and successive approximation
  (DC and AC, first and refinement scans);
- gray and YCbCr at 4:4:4, 4:2:2 and 4:2:0;
- libjpeg's "ISLOW" integer IDCT (``jidctint.c``: 13-bit constants, two
  extra bits between the passes, its range-limit table), its "fancy"
  triangle-filter upsampling (``h2v1_fancy_upsample``,
  ``h2v2_fancy_upsample``; plain replication for planes two samples wide
  or less, as libjpeg chooses) and its fixed-point YCbCr -> RGB tables
  (``jdcolor.c``);
- gray replicated to RGB (PIL's "L" -> "RGB"); no EXIF rotation, as PIL
  does none.

Anything else raises ``ValueError`` naming the missing feature: CMYK,
Adobe-transform or RGB-coded files, arithmetic coding, 12-bit samples,
lossless and hierarchical frames, DNL, other sampling factors (4:4:0,
4:1:1, ...), truncated or corrupt data, and a progressive file whose scans
leave some low-frequency coefficient bits unrefined (libjpeg smooths such
blocks; this decoder does not, so it refuses rather than differ). The size
in the frame header is held to ``png.MAX_PIXELS`` (PIL's bomb bound)
before any entropy decoding.

The entropy decoder is a plain Python loop over 16-bit lookahead tables
(one lookup per Huffman code, and for most AC codes the coefficient's
value too); dequantization and the IDCT (int64, a chunk of blocks at a
time), upsampling and colour conversion (int32, a band of rows at a
time) are vectorised numpy, so the decode holds a few bytes a pixel
(the coefficients, then the planes and the output) plus a bounded chunk.
"""

from __future__ import annotations

import array
import functools
import struct

import numpy as np

from blobctrl_torch.utils.png import MAX_PIXELS

# zigzag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the output is made in bands of about this many pixels, and the IDCT runs
# over about this many blocks at a time: the temporaries stay bounded
_BAND_PIXELS = 1 << 18
_IDCT_BLOCKS = 4096

# libjpeg's smoothing looks at the first SAVED_COEFS coefficients (zigzag)
_SMOOTHED_COEFS = 10

_SOF_NAMES = {
    0xC3: "lossless (SOF3) frames", 0xC5: "hierarchical (SOF5) frames",
    0xC6: "hierarchical (SOF6) frames", 0xC7: "hierarchical lossless (SOF7) "
    "frames", 0xC9: "arithmetic coding (SOF9)", 0xCA: "arithmetic coding "
    "(SOF10)", 0xCB: "arithmetic coding (SOF11)", 0xCD: "arithmetic coding "
    "(SOF13)", 0xCE: "arithmetic coding (SOF14)", 0xCF: "arithmetic coding "
    "(SOF15)"}


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "bw", "bh", "dw", "dh",
                 "coef", "td", "ta", "bits")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qt = None


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

def _code_table(counts, symbols):
    """(code length, symbol) for every 16-bit lookahead value; length 0
    where no code matches (a corrupt stream)."""
    length = np.zeros(65536, np.int64)
    sym = np.zeros(65536, np.int64)
    code, k = 0, 0
    for ln in range(1, 17):
        for _ in range(counts[ln - 1]):
            if code >= (1 << ln):
                raise ValueError("corrupt JPEG: bad Huffman table")
            lo = code << (16 - ln)
            hi = (code + 1) << (16 - ln)
            length[lo:hi] = ln
            sym[lo:hi] = symbols[k]
            code += 1
            k += 1
        code <<= 1
    return length, sym


def _extend(bits, s):
    """HUFF_EXTEND over arrays: s-bit magnitude field -> signed value."""
    return np.where(bits < (1 << np.maximum(s - 1, 0)),
                    bits - (1 << s) + 1, bits)


class _Huffman:
    """Lookup tables of one Huffman table, indexed by the next 16 bits.

    ``dc[look]`` = (bits, value, size): when the code and its magnitude
    field fit in 16 bits, bits consumed by both and the difference, size
    -1; else the code's length, 0 and the magnitude size s.
    ``ac[look]`` = (bits, run, value): a coefficient (value != 0) resolved
    with its magnitude field; else (code length, run, 0) with run 0 for EOB
    (or EOBr, r > 0, as 64 + r in progressive scans), 16 for ZRL and
    256 + rs for a code whose magnitude field does not fit. Length 0 marks
    a corrupt code."""

    def __init__(self, counts, symbols, is_ac):
        length, sym = _code_table(counts, symbols)
        look = np.arange(65536, dtype=np.int64)
        if not is_ac:
            self._dc(look, length, sym)
            return
        s = sym & 15
        r = sym >> 4
        fits = (length > 0) & (length + s <= 16)
        mag = (look >> np.maximum(16 - length - s, 0)) & ((1 << s) - 1)
        val = np.where(s > 0, _extend(mag, s), 0)
        fast = fits & (s > 0)
        run = np.where(fast, r, np.where(s == 0, np.where(
            r == 15, 16, np.where(r == 0, 0, 64 + r)), 256 + sym))
        self.ac = _shared_rows(np.where(fast, length + s, length), run,
                               np.where(fast, val, 0))

    def _dc(self, look, length, sym):
        dc_fast = (length > 0) & (length + sym <= 16)
        dmag = (look >> np.maximum(16 - length - sym, 0)) & ((1 << sym) - 1)
        dval = np.where(sym > 0, _extend(dmag, sym), 0)
        self.dc = _shared_rows(np.where(dc_fast, length + sym, length),
                               np.where(dc_fast, dval, 0),
                               np.where(dc_fast, -1, sym))


def _shared_rows(*cols) -> list:
    """Columns of 65536 lookahead entries -> a list of tuples in which
    each run of equal entries is one object (a code of n bits fills a run
    of 2^(16 - n) entries), so a table holds 65536 references to far
    fewer tuples."""
    a = np.stack(cols, 1)
    starts = np.flatnonzero(np.r_[True, (a[1:] != a[:-1]).any(1)])
    out = []
    for row, n in zip(a[starts].tolist(),
                      np.diff(np.r_[starts, len(a)]).tolist()):
        out += [tuple(row)] * n
    return out


@functools.lru_cache(maxsize=8)
def _huffman(counts: bytes, symbols: bytes, is_ac: bool) -> _Huffman:
    """Tables by content: most files carry the standard tables, so they
    are built once per process; files with their own (optimized) tables
    keep at most 8 tables resident."""
    return _Huffman(list(counts), list(symbols), is_ac)


# ---------------------------------------------------------------------------
# bit windows over one entropy-coded segment
# ---------------------------------------------------------------------------

def _windows(seg: bytes):
    """-> array of the 32 bits that start at each byte of ``seg`` (big
    endian, zero-padded past its end)."""
    b = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
    w = (b[:-7] << 24) | (b[1:-6] << 16) | (b[2:-5] << 8) | b[3:-4]
    return array.array("I", w.astype(np.uint32).tobytes())


def _split_scan(data: bytes, pos: int):
    """Entropy-coded data from ``pos`` -> (segments split at RST markers,
    unstuffed, position of the marker that ends the scan)."""
    segs, start, i, n = [], pos, pos, len(data)
    expect = 0
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            raise ValueError("truncated JPEG: scan data without an end "
                             "marker")
        c = data[j + 1]
        if c == 0:
            i = j + 2
            continue
        if c == 0xFF:
            i = j + 1
            continue
        if 0xD0 <= c <= 0xD7:
            if c - 0xD0 != expect:
                raise ValueError("corrupt JPEG: restart markers out of "
                                 "order")
            expect = (expect + 1) & 7
            segs.append(data[start:j].replace(b"\xff\x00", b"\xff"))
            start = i = j + 2
            continue
        end = j
        while end > start and data[end - 1] == 0xFF:
            end -= 1       # fill bytes before the marker
        segs.append(data[start:end].replace(b"\xff\x00", b"\xff"))
        return segs, j


# ---------------------------------------------------------------------------
# scan decoders (libjpeg's jdhuff.c / jdphuff.c, one per scan kind)
# ---------------------------------------------------------------------------

class _Scan:
    """The units (MCUs) of one scan: for each, the block bases (index *
    64 into each component's coefficient array) and the component of each
    block."""

    def __init__(self, comps, frame, ss, se, ah, al, restart):
        self.comps, self.ss, self.se, self.ah, self.al = comps, ss, se, ah, al
        self.restart = restart
        if len(comps) == 1:
            c = comps[0]
            bw, bh = -(-c.dw // 8), -(-c.dh // 8)
            rows = np.arange(bh)[:, None] * c.bw + np.arange(bw)[None, :]
            self.bases = [[b] for b in (rows.reshape(-1) * 64).tolist()]
            self.owner = [0]
        else:
            mx, my = frame
            per, owner = [], []
            for ci, c in enumerate(comps):
                for dy in range(c.v):
                    for dx in range(c.h):
                        by = np.arange(my)[:, None] * c.v + dy
                        bx = np.arange(mx)[None, :] * c.h + dx
                        per.append(((by * c.bw + bx) * 64).reshape(-1))
                        owner.append(ci)
            self.bases = np.stack(per, 1).tolist()
            self.owner = owner

    def intervals(self):
        n = len(self.bases)
        step = self.restart or n
        return [self.bases[i:i + step] for i in range(0, n, step)]


def _check_end(p, seg):
    if p > 8 * len(seg):
        raise ValueError("truncated or corrupt JPEG: a scan reads past its "
                         "entropy-coded data")


def _corrupt():
    raise ValueError("corrupt JPEG: bad Huffman code")


def _decode_sequential(scan, segs, coefs, dcs, acs):
    owner = scan.owner
    for units, seg in zip(scan.intervals(), segs):
        win = _windows(seg)
        p = 0
        pred = [0] * len(scan.comps)
        for bases in units:
            for ci, base in zip(owner, bases):
                coef = coefs[ci]
                ln, v, s = dcs[ci][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if ln == 0:
                    _corrupt()
                p += ln
                if s > 0:
                    bits = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    v = bits if bits >> (s - 1) else bits - (1 << s) + 1
                pred[ci] += v
                coef[base] = pred[ci]
                ac = acs[ci]
                k = 1
                while k < 64:
                    ln, r, v = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    p += ln
                    if v:
                        k += r
                        if k > 63:
                            _corrupt()
                        coef[base + k] = v
                        k += 1
                    elif r == 16:
                        k += 16
                    elif r < 256:
                        # EOB (libjpeg ends the block on any run code
                        # that is not ZRL)
                        if ln == 0:
                            _corrupt()
                        break
                    else:
                        rs = r - 256
                        s = rs & 15
                        k += rs >> 4
                        if k > 63:
                            _corrupt()
                        bits = (win[p >> 3] >> (32 - s - (p & 7))) & \
                            ((1 << s) - 1)
                        p += s
                        coef[base + k] = bits if bits >> (s - 1) \
                            else bits - (1 << s) + 1
                        k += 1
        _check_end(p, seg)


def _decode_dc_first(scan, segs, coefs, dcs):
    owner, al = scan.owner, scan.al
    for units, seg in zip(scan.intervals(), segs):
        win = _windows(seg)
        p = 0
        pred = [0] * len(scan.comps)
        for bases in units:
            for ci, base in zip(owner, bases):
                ln, v, s = dcs[ci][(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if ln == 0:
                    _corrupt()
                p += ln
                if s > 0:
                    bits = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    v = bits if bits >> (s - 1) else bits - (1 << s) + 1
                pred[ci] += v
                coefs[ci][base] = pred[ci] << al
        _check_end(p, seg)


def _decode_dc_refine(scan, segs, coefs):
    owner, bit = scan.owner, 1 << scan.al
    for units, seg in zip(scan.intervals(), segs):
        win = _windows(seg)
        p = 0
        for bases in units:
            for ci, base in zip(owner, bases):
                if (win[p >> 3] >> (31 - (p & 7))) & 1:
                    coefs[ci][base] |= bit
                p += 1
        _check_end(p, seg)


def _decode_ac_first(scan, segs, coef, ac):
    ss, se, al = scan.ss, scan.se, scan.al
    for units, seg in zip(scan.intervals(), segs):
        win = _windows(seg)
        p = 0
        eobrun = 0
        for (base,) in units:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                ln, r, v = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                p += ln
                if v:
                    k += r
                    if k > se:
                        _corrupt()
                    coef[base + k] = v << al
                    k += 1
                elif r == 16:
                    k += 16
                elif r < 256:
                    if ln == 0:
                        _corrupt()
                    if r:
                        r -= 64
                        eobrun = (1 << r) + ((win[p >> 3] >> (32 - r - (p & 7)))
                                             & ((1 << r) - 1))
                        p += r
                        eobrun -= 1
                    break
                else:
                    rs = r - 256
                    s = rs & 15
                    k += rs >> 4
                    if k > se:
                        _corrupt()
                    bits = (win[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    coef[base + k] = (bits if bits >> (s - 1)
                                      else bits - (1 << s) + 1) << al
                    k += 1
        _check_end(p, seg)


def _decode_ac_refine(scan, segs, coef, ac):
    """jdphuff.c's decode_mcu_AC_refine: newly nonzero coefficients of
    magnitude 1 << Al, and a correction bit for each coefficient already
    nonzero that the band passes over."""
    ss, se = scan.ss, scan.se
    p1 = 1 << scan.al
    m1 = -p1
    for units, seg in zip(scan.intervals(), segs):
        win = _windows(seg)
        p = 0
        eobrun = 0
        for (base,) in units:
            k = ss
            if eobrun == 0:
                while k <= se:
                    ln, r, v = ac[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if ln == 0:
                        _corrupt()
                    p += ln
                    if v or r >= 256:
                        # a new coefficient: its size must be 1, its sign
                        # the next bit (a resolved entry consumed it)
                        if v:
                            if v not in (1, -1):
                                _corrupt()
                            s = p1 if v > 0 else m1
                        else:
                            rs = r - 256
                            if rs & 15 != 1:
                                _corrupt()
                            r = rs >> 4
                            s = p1 if (win[p >> 3] >> (31 - (p & 7))) & 1 \
                                else m1
                            p += 1
                    elif r == 16:
                        r, s = 15, 0
                    else:
                        if r:
                            r -= 64
                            eobrun = (1 << r) + (
                                (win[p >> 3] >> (32 - r - (p & 7)))
                                & ((1 << r) - 1))
                            p += r
                        else:
                            eobrun = 1
                        break
                    # advance over nonzero coefficients (a correction bit
                    # each) and r zero ones
                    while k <= se:
                        c = coef[base + k]
                        if c:
                            if (win[p >> 3] >> (31 - (p & 7))) & 1:
                                if c & p1 == 0:
                                    coef[base + k] = c + p1 if c >= 0 \
                                        else c + m1
                            p += 1
                        else:
                            if r == 0:
                                break
                            r -= 1
                        k += 1
                    if s:
                        if k > se:
                            _corrupt()
                        coef[base + k] = s
                    k += 1
            if eobrun > 0:
                while k <= se:
                    c = coef[base + k]
                    if c:
                        if (win[p >> 3] >> (31 - (p & 7))) & 1:
                            if c & p1 == 0:
                                coef[base + k] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1
        _check_end(p, seg)


# ---------------------------------------------------------------------------
# ISLOW IDCT (jidctint.c), all blocks at once
# ---------------------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
F_0_298, F_0_390, F_0_541, F_0_765 = 2446, 3196, 4433, 6270
F_0_899, F_1_175, F_1_501, F_1_847 = 7373, 9633, 12299, 15137
F_1_961, F_2_053, F_2_562, F_3_072 = 16069, 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """The post-IDCT part of jdmaster.c's sample_range_limit table,
    indexed by (value & 1023) with value the descaled IDCT output before
    the +128 level shift."""
    t = np.zeros(1024, np.int64)
    t[:128] = np.arange(128, 256)      # 0..127 -> 128..255
    t[128:512] = 255
    t[896:] = np.arange(128)           # -128..-1 -> 0..127
    return t


_RANGE_LIMIT = _range_limit_table()


def _idct_1d(x0, x1, x2, x3, x4, x5, x6, x7):
    """The even/odd butterflies of both passes; returns the 8 outputs
    before their descale."""
    z1 = (x2 + x6) * F_0_541
    tmp2 = z1 - x6 * F_1_847
    tmp3 = z1 + x2 * F_0_765
    tmp0 = (x0 + x4) << CONST_BITS
    tmp1 = (x0 - x4) << CONST_BITS
    t10, t13 = tmp0 + tmp3, tmp0 - tmp3
    t11, t12 = tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x7, x5, x3, x1
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F_1_175
    o0 = o0 * F_0_298
    o1 = o1 * F_2_053
    o2 = o2 * F_3_072
    o3 = o3 * F_1_501
    z1 = z1 * -F_0_899
    z2 = z2 * -F_2_562
    z3 = z3 * -F_1_961 + z5
    z4 = z4 * -F_0_390 + z5
    o0 += z1 + z3
    o1 += z2 + z4
    o2 += z2 + z3
    o3 += z1 + z4
    return (t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(N, 64) coefficients in natural order and a (64,) quantization
    table -> (N, 8, 8) uint8 samples, as libjpeg's jpeg_idct_islow."""
    x = coef.astype(np.int64).reshape(-1, 8, 8) * qt.astype(
        np.int64).reshape(8, 8)
    # pass 1: columns, descaled by CONST_BITS - PASS1_BITS
    sh = CONST_BITS - PASS1_BITS
    cols = _idct_1d(*(x[:, i, :] for i in range(8)))
    ws = np.stack([(c + (1 << (sh - 1))) >> sh for c in cols], 1)
    # pass 2: rows, descaled by CONST_BITS + PASS1_BITS + 3, range-limited
    sh = CONST_BITS + PASS1_BITS + 3
    rows = _idct_1d(*(ws[:, :, i] for i in range(8)))
    out = np.stack([(r + (1 << (sh - 1))) >> sh for r in rows], 2)
    return _RANGE_LIMIT[out & 1023].astype(np.uint8)


# ---------------------------------------------------------------------------
# upsampling (jdsample.c) and colour conversion (jdcolor.c)
# ---------------------------------------------------------------------------

def _h2v1_fancy(x: np.ndarray) -> np.ndarray:
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out


def _h2v2_fancy(x: np.ndarray) -> np.ndarray:
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, near in ((0, above), (1, below)):
        cs = 3 * x + near
        left = np.concatenate([cs[:, :1], cs[:, :-1]], 1)
        right = np.concatenate([cs[:, 1:], cs[:, -1:]], 1)
        out[v::2, 0::2] = (3 * cs + left + 8) >> 4
        out[v::2, 1::2] = (3 * cs + right + 7) >> 4
    return out


def _upsample_rows(plane: np.ndarray, fx: int, fy: int, r0: int,
                   r1: int) -> np.ndarray:
    """Rows ``r0:r1`` (``r0`` a multiple of ``fy``) of the whole plane
    upsampled by libjpeg's choice: fancy h2v1/h2v2 when the plane is more
    than two samples wide, else plain replication. Only the source rows
    of the band and one row of context on each side are widened to int32,
    and the image's edge rows are replicated as for the whole plane."""
    s0, s1 = r0 // fy, -(-r1 // fy)
    if fy == 1 or plane.shape[1] <= 2:
        x = plane[s0:s1].astype(np.int32)
        if fx == fy == 1:
            return x
        if x.shape[1] > 2:
            return _h2v1_fancy(x)
        return np.repeat(np.repeat(x, fx, 1), fy, 0)[:r1 - r0]
    lo, hi = max(s0 - 1, 0), min(s1 + 1, plane.shape[0])
    out = _h2v2_fancy(plane[lo:hi].astype(np.int32))
    return out[2 * (s0 - lo):][:r1 - r0]


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(f):
        return int(f * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    # |cb_g + cr_g| < 2^23: int32 holds every sum
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8-valued planes -> (H, W, 3) uint8, jdcolor.c's ycc_rgb_convert,
    in int32."""
    y = y.astype(np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    for i, v in enumerate((y + _CR_R[cr],
                           y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                           y + _CB_B[cb])):
        out[..., i] = np.clip(v, 0, 255)
    return out


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------

def _segment(data, pos):
    if pos + 4 > len(data):
        raise ValueError("truncated JPEG: marker segment past the end")
    (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
    body = data[pos + 4:pos + 2 + length]
    if length < 2 or len(body) != length - 2:
        raise ValueError("truncated JPEG: marker segment past the end")
    return body, pos + 2 + length


def _parse_dqt(body, qts):
    i = 0
    while i < len(body):
        pq, tq = body[i] >> 4, body[i] & 15
        n = 64 * (pq + 1)
        if pq > 1 or tq > 3 or i + 1 + n > len(body):
            raise ValueError("corrupt JPEG: bad quantization table")
        raw = np.frombuffer(body[i + 1:i + 1 + n], ">u2" if pq else np.uint8)
        qt = np.zeros(64, np.int64)
        qt[ZIGZAG] = raw.astype(np.int64)
        qts[tq] = qt
        i += 1 + n


def _parse_dht(body, dcs, acs):
    i = 0
    while i < len(body):
        if i + 17 > len(body):
            raise ValueError("corrupt JPEG: bad Huffman table")
        tc, th = body[i] >> 4, body[i] & 15
        counts = list(body[i + 1:i + 17])
        n = sum(counts)
        symbols = list(body[i + 17:i + 17 + n])
        if tc > 1 or th > 3 or len(symbols) != n:
            raise ValueError("corrupt JPEG: bad Huffman table")
        (acs if tc else dcs)[th] = _huffman(bytes(counts), bytes(symbols),
                                            tc == 1)
        i += 17 + n


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8, as PIL's ``convert("RGB")`` gives it
    (see the module docstring). Raises ValueError on anything else."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("not JPEG data (no SOI marker)")
    try:
        return _decode(data)
    except (OverflowError, IndexError):
        # a coefficient past int16, or a read past the bit windows: only
        # corrupt data gets there
        raise ValueError("corrupt JPEG data") from None


def _decode(data: bytes) -> np.ndarray:
    qts, dcs, acs = {}, {}, {}
    comps, frame, progressive, restart = None, None, False, 0
    jfif = adobe = False
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1                      # fill bytes
        if pos + 2 > len(data):
            raise ValueError("truncated JPEG: no EOI marker")
        if data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: marker expected")
        m = data[pos + 1]
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            pos += 2
            continue
        body, nxt = _segment(data, pos)
        if m == 0xDB:
            _parse_dqt(body, qts)
        elif m == 0xC4:
            _parse_dht(body, dcs, acs)
        elif m == 0xDD:
            if len(body) != 2:
                raise ValueError("corrupt JPEG: bad DRI segment")
            (restart,) = struct.unpack(">H", body)
        elif m == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif m == 0xEE and body[:5] == b"Adobe":
            adobe = True
        elif m in (0xC0, 0xC1, 0xC2):
            if comps is not None:
                raise ValueError("corrupt JPEG: a second frame header")
            comps, frame = _parse_sof(body)
            progressive = m == 0xC2
            x, y, mx, my = frame
            if adobe:
                raise ValueError("unsupported JPEG: Adobe-transform files "
                                 "(APP14) are not decoded")
            if len(comps) == 3 and not jfif and \
                    [c.cid for c in comps] == [82, 71, 66]:
                raise ValueError("unsupported JPEG: RGB-coded components")
            for c in comps:
                c.coef = array.array("h", bytes(2 * 64 * c.bw * c.bh))
                c.bits = [-1] * 64
        elif m in _SOF_NAMES:
            raise ValueError(f"unsupported JPEG: {_SOF_NAMES[m]}")
        elif m in (0xCC, 0xDE, 0xDF):
            raise ValueError("unsupported JPEG: arithmetic coding or "
                             "hierarchical markers")
        elif m == 0xDC:
            raise ValueError("unsupported JPEG: DNL marker")
        elif m == 0xDA:
            if comps is None:
                raise ValueError("corrupt JPEG: scan before the frame header")
            nxt = _scan(data, body, nxt, comps, frame, progressive, restart,
                        qts, dcs, acs)
        pos = nxt
    if comps is None:
        raise ValueError("corrupt JPEG: no frame header")
    return _output(comps, frame)


def _parse_sof(body):
    if len(body) < 6:
        raise ValueError("corrupt JPEG: bad frame header")
    prec, y, x, nf = struct.unpack(">BHHB", body[:6])
    if prec != 8:
        raise ValueError(f"unsupported JPEG: {prec}-bit samples (only 8-bit "
                         f"is decoded)")
    if y == 0:
        raise ValueError("unsupported JPEG: height defined by a DNL marker")
    if x == 0:
        raise ValueError("corrupt JPEG: empty image")
    if x * y > MAX_PIXELS:
        raise ValueError(f"JPEG of {x}x{y} pixels is above the {MAX_PIXELS}"
                         f"-pixel decompression-bomb limit")
    if nf == 4:
        raise ValueError("unsupported JPEG: CMYK (4 components)")
    if nf not in (1, 3) or len(body) != 6 + 3 * nf:
        raise ValueError(f"unsupported JPEG: {nf} components")
    comps = []
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    for c in comps:
        if c.h < 1 or c.v < 1 or c.h > 4 or c.v > 4:
            raise ValueError("corrupt JPEG: bad sampling factors")
    if nf == 3:
        fx = [hmax // c.h for c in comps]
        fy = [vmax // c.v for c in comps]
        ok = all(hmax % c.h == 0 and vmax % c.v == 0 for c in comps) and \
            fx[0] == fy[0] == 1 and fx[1] == fx[2] and fy[1] == fy[2] and \
            (fx[1], fy[1]) in ((1, 1), (2, 1), (2, 2))
        if not ok:
            desc = "x".join(f"{c.h}{c.v}" for c in comps)
            raise ValueError(f"unsupported JPEG sampling factors {desc} "
                             f"(only 4:4:4, 4:2:2 and 4:2:0 are decoded)")
    mx = -(-x // (8 * hmax))
    my = -(-y // (8 * vmax))
    for c in comps:
        c.dw = -(-x * c.h // hmax)
        c.dh = -(-y * c.v // vmax)
        if nf == 1:                 # one component: its own block grid
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
        else:
            c.bw, c.bh = mx * c.h, my * c.v
    return comps, (x, y, mx, my)


def _scan(data, body, pos, comps, frame, progressive, restart, qts, dcs,
          acs):
    ns = body[0] if body else 0
    if ns < 1 or len(body) != 4 + 2 * ns:
        raise ValueError("corrupt JPEG: bad scan header")
    by_id = {c.cid: c for c in comps}
    sc = []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        if cid not in by_id:
            raise ValueError("corrupt JPEG: scan of an unknown component")
        c = by_id[cid]
        c.td, c.ta = t >> 4, t & 15
        if c.qt is None:
            if c.tq not in qts:
                raise ValueError("corrupt JPEG: missing quantization table")
            c.qt = qts[c.tq]
        sc.append(c)
    ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif ss > se or se > 63 or (ss == 0) != (se == 0) or \
            (ss > 0 and ns != 1) or al > 13:
        raise ValueError("corrupt JPEG: bad progressive scan parameters")
    x, y, mx, my = frame
    scan = _Scan(sc, (mx, my), ss, se, ah, al, restart)
    segs, end = _split_scan(data, pos)
    if len(segs) != len(scan.intervals()):
        raise ValueError("truncated or corrupt JPEG: restart intervals do "
                         "not match the scan")
    coefs = [c.coef for c in sc]

    def tables(kind, idx):
        try:
            return [kind[getattr(c, idx)] for c in sc]
        except KeyError:
            raise ValueError("corrupt JPEG: missing Huffman table") from None

    if not progressive:
        _decode_sequential(scan, segs, coefs, [t.dc for t in tables(dcs, "td")],
                           [t.ac for t in tables(acs, "ta")])
        for c in sc:
            c.bits[:] = [0] * 64
        return end
    # successive approximation bookkeeping (libjpeg's coef_bits)
    for c in sc:
        for k in range(ss, se + 1):
            if (c.bits[k] < 0) != (ah == 0) or (ah and c.bits[k] != ah):
                raise ValueError("corrupt JPEG: progressive scans out of "
                                 "order")
            c.bits[k] = al
    if ss == 0:
        if ah == 0:
            _decode_dc_first(scan, segs, coefs,
                             [t.dc for t in tables(dcs, "td")])
        else:
            _decode_dc_refine(scan, segs, coefs)
    elif ah == 0:
        _decode_ac_first(scan, segs, coefs[0], tables(acs, "ta")[0].ac)
    else:
        _decode_ac_refine(scan, segs, coefs[0], tables(acs, "ta")[0].ac)
    return end


def _output(comps, frame):
    x, y, _, _ = frame
    for c in comps:
        if c.qt is None:
            raise ValueError("corrupt JPEG: a component without any scan")
        if any(b != 0 for b in c.bits[:_SMOOTHED_COEFS]):
            raise ValueError("unsupported JPEG: progressive scans leave "
                             "coefficients unrefined (libjpeg's block "
                             "smoothing is not reproduced)")
    planes = []
    for c in comps:        # each coefficient array dropped once it is used
        planes.append(_plane(c))
        c.coef = None
    if len(comps) == 1:
        return np.repeat(planes[0][:y, :x, None], 3, -1)
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    # upsampling and colour conversion a band of rows at a time, so the
    # int32 temporaries stay at about _BAND_PIXELS whatever the size
    out = np.empty((y, x, 3), np.uint8)
    band = max(2, (_BAND_PIXELS // x) & ~1)
    for r0 in range(0, y, band):
        r1 = min(r0 + band, y)
        out[r0:r1] = ycc_to_rgb(*(
            _upsample_rows(p, hmax // c.h, vmax // c.v, r0, r1)[:, :x]
            for p, c in zip(planes, comps)))
    return out


def _plane(c) -> np.ndarray:
    """A component's coefficients -> its (dh, dw) uint8 samples, the IDCT
    over about _IDCT_BLOCKS blocks at a time (zigzag reorder included)."""
    bw, bh = -(-c.dw // 8), -(-c.dh // 8)
    coef = np.frombuffer(c.coef, np.int16).reshape(c.bh, c.bw, 64)
    plane = np.empty((bh * 8, bw * 8), np.uint8)
    rows = max(1, _IDCT_BLOCKS // bw)
    for b0 in range(0, bh, rows):
        zz = coef[b0:min(b0 + rows, bh), :bw].reshape(-1, 64)
        nat = np.empty_like(zz)
        nat[:, ZIGZAG] = zz
        pix = idct_islow(nat, c.qt)
        plane[8 * b0:8 * b0 + 8 * len(pix) // bw] = pix.reshape(
            -1, bw, 8, 8).transpose(0, 2, 1, 3).reshape(-1, bw * 8)
    return plane[:c.dh, :c.dw]
