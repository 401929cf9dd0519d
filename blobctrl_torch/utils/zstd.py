"""A Zstandard frame decoder (RFC 8878) in Python: the plain version of
the compiled decoder ``csrc/zstd_decode.cpp``.

The JAX package's training checkpoints (orbax: OCDBT nodes and zarr
chunks) are zstd frames, and neither machine of the port has a zstd
library. ``decompress`` reads what any conforming encoder writes:

- the frame header (window, content size, checksum flag), skippable
  frames and several frames one after another;
- raw, RLE and compressed blocks;
- raw, RLE and Huffman-coded literals (one or four streams; the tree
  described by FSE-coded or direct weights; the treeless repeat);
- sequences in predefined, RLE, FSE and repeat modes, the three repeat
  offsets, matches that reach back across blocks within the window;
- the XXH64 content checksum, which it verifies.

Dictionaries, truncated input and corrupt input raise ``ValueError``.
This module is the reference that the tests and ``chip_smoke.py`` hold
the compiled decoder (``params/ocdbt.zstd_decompress``) against; it runs
at a few MB/s, so nothing on the checkpoint read path calls it.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50        # ..0x184D2A5F, the low nibble free
MAX_WINDOW = 1 << 31
BLOCK_MAX = 128 * 1024
_HUF_MAX_LOG = 11

# predefined distributions (accuracy logs 6, 6, 5)
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2) + (1,) * 37 + (-1,) * 7
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2) + (1,) * 15 + (-1,) * 5
# (baseline, extra bits) of the literal-length and match-length codes
LL_CODES = tuple((i, 0) for i in range(16)) + (
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16))
ML_CODES = tuple((i + 3, 0) for i in range(32)) + (
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16))
_MAX_OF_CODE = 31

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, \
    1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum keeps its low 32 bits)."""
    data = bytes(data)
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = struct.unpack_from(f"<{(n // 32) * 4}Q", data)
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        p = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


def _corrupt(what: str):
    return ValueError(f"corrupt zstd data: {what}")


class _Forward:
    """A little-endian bit reader from the front (FSE table headers)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        b0, b1 = self.bit >> 3, (self.bit + n + 7) >> 3
        if b1 > len(self.data):
            raise ValueError("truncated zstd data: FSE table header")
        v = int.from_bytes(self.data[b0:b1], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def peek(self, n: int) -> int:
        bit = self.bit
        v = self.read(min(n, len(self.data) * 8 - bit))
        self.bit = bit
        return v

    def end(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A bit reader from the back: the stream ends in a padding 1 bit,
    and bits are read from the highest down. Bits past the start read as
    zeros; ``pos`` turns negative there (an overflow)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("bitstream without its final 1 bit")
        self.data = data
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        return self._at(self.pos, n)

    def peek(self, n: int) -> int:
        return self._at(self.pos - n, n)

    def _at(self, lo: int, n: int) -> int:
        shift = 0
        if lo < 0:
            if lo + n <= 0:
                return 0
            shift, n, lo = -lo, n + lo, 0
        v = int.from_bytes(self.data[lo >> 3:(lo + n + 7) >> 3], "little")
        return ((v >> (lo & 7)) & ((1 << n) - 1)) << shift


def read_fse_header(data: bytes, pos: int, max_symbol: int, max_log: int):
    """An FSE table description at ``pos`` -> (normalized counts,
    accuracy log, the position after it)."""
    bits = _Forward(data, pos)
    log = bits.read(4) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} > {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts, previous0 = [], False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            n0 = 0
            while True:
                r = bits.read(2)
                n0 += r
                if r != 3:
                    break
            if len(counts) + n0 > max_symbol + 1:
                raise _corrupt("FSE zero run past the last symbol")
            counts += [0] * n0
            if len(counts) > max_symbol:
                break
        high = (2 * threshold - 1) - remaining
        v = bits.peek(nbits)
        if (v & (threshold - 1)) < high:
            count = v & (threshold - 1)
            bits.read(nbits - 1)
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= high
            bits.read(nbits)
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise _corrupt("FSE counts do not sum to the table size")
    return counts, log, bits.end()


def build_fse_table(counts, log: int):
    """-> [(symbol, bits to read, baseline of the next state)] per state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = []
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise _corrupt("FSE table does not fill its states")
    table = []
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


def _rle_table(symbol: int):
    return [(symbol, 0, 0)]


def _huffman_weights(data: bytes, pos: int):
    """The Huffman tree description at ``pos`` -> (weights, next pos)."""
    if pos >= len(data):
        raise ValueError("truncated zstd data: Huffman tree")
    head = data[pos]
    if head >= 128:
        n = head - 127
        raw = data[pos + 1:pos + 1 + (n + 1) // 2]
        if len(raw) != (n + 1) // 2:
            raise ValueError("truncated zstd data: Huffman weights")
        weights = [(raw[i // 2] >> (0 if i % 2 else 4)) & 15
                   for i in range(n)]
        return weights, pos + 1 + (n + 1) // 2
    end = pos + 1 + head
    if end > len(data):
        raise ValueError("truncated zstd data: Huffman weights")
    counts, log, start = read_fse_header(data[:end], pos + 1, 255, 6)
    table = build_fse_table(counts, log)
    bits = _Backward(data[start:end])
    states = [bits.read(log), bits.read(log)]
    weights, a = [], 0
    # two interleaved states; the one that did not overflow adds the last
    while True:
        sym, nb, base = table[states[a]]
        weights.append(sym)
        states[a] = base + bits.read(nb)
        if bits.pos < 0:
            weights.append(table[states[1 - a]][0])
            break
        if len(weights) > 254:
            raise _corrupt("too many Huffman weights")
        a = 1 - a
    return weights, end


def build_huffman_table(weights):
    """Weights of symbols 0..n-2 (the last one implied) -> (table of
    (symbol, bits) indexed by the next ``log`` bits, log)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0 or any(w > _HUF_MAX_LOG for w in weights):
        raise _corrupt("Huffman weights")
    log = total.bit_length()
    if log > _HUF_MAX_LOG:
        raise _corrupt("Huffman table log > 11")
    left = (1 << log) - total
    if left & (left - 1):
        raise _corrupt("Huffman weights leave no power of two")
    weights = list(weights) + [left.bit_length()]
    rank = [0] * (log + 2)
    for w in weights:
        rank[w] += 1
    start, nxt = [0] * (log + 2), 0
    for w in range(1, log + 1):
        start[w] = nxt
        nxt += rank[w] << (w - 1)
    table = [None] * (1 << log)
    for s, w in enumerate(weights):
        if w:
            entry = (s, log + 1 - w)
            n = 1 << (w - 1)
            table[start[w]:start[w] + n] = [entry] * n
            start[w] += n
    return table, log


def _huffman_stream(data: bytes, count: int, table, log: int, out):
    if not data or data[-1] == 0:
        raise _corrupt("bitstream without its final 1 bit")
    # three zero bytes in front (bits past the start read as zeros), and
    # each byte position's next three bytes as one int: a peek is then
    # one lookup and a shift
    buf = np.frombuffer(bytes(3) + data + bytes(2), np.uint8).astype(
        np.uint32)
    w3 = (buf[:-2] | (buf[1:-1] << 8) | (buf[2:] << 16)).tolist()
    pos = (len(data) + 3) * 8 - 9 + data[-1].bit_length()
    mask = (1 << log) - 1
    append = out.append
    for _ in range(count):
        lo = pos - log
        s, nb = table[(w3[lo >> 3] >> (lo & 7)) & mask]
        pos -= nb
        append(s)
    if pos != 24:
        raise _corrupt("Huffman stream not consumed exactly")


class _Frame:
    def __init__(self, window: int):
        self.window = window
        self.out = bytearray()
        self.huffman = None
        self.tables = [None, None, None]      # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(fr: _Frame, data: bytes, pos: int):
    """The literals section at ``pos`` -> (literals, next pos)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if size > BLOCK_MAX:
            raise _corrupt("literals larger than a block")
        if kind == 0:
            lit = data[pos:pos + size]
            if len(lit) != size:
                raise ValueError("truncated zstd data: raw literals")
            return bytes(lit), pos + size
        if pos >= len(data):
            raise ValueError("truncated zstd data: RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    nbytes, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if pos + nbytes > len(data):
        raise ValueError("truncated zstd data: literals header")
    h = int.from_bytes(data[pos:pos + nbytes], "little")
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    pos += nbytes
    if size > BLOCK_MAX:
        raise _corrupt("literals larger than a block")
    end = pos + csize
    if end > len(data):
        raise ValueError("truncated zstd data: Huffman literals")
    if kind == 2:
        weights, pos = _huffman_weights(data[:end], pos)
        fr.huffman = build_huffman_table(weights)
    elif fr.huffman is None:
        raise _corrupt("treeless literals without an earlier tree")
    table, log = fr.huffman
    out = bytearray()
    if fmt == 0:
        _huffman_stream(data[pos:end], size, table, log, out)
    else:
        if pos + 6 > end:
            raise _corrupt("four-stream jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data, pos)
        pos += 6
        s4 = end - pos - s1 - s2 - s3
        if s4 < 1:
            raise _corrupt("four-stream sizes")
        each = (size + 3) // 4
        if each * 3 > size:
            raise _corrupt("four-stream regenerated size")
        for n, count in zip((s1, s2, s3, s4), (each, each, each,
                                               size - 3 * each)):
            _huffman_stream(data[pos:pos + n], count, table, log, out)
            pos += n
    return bytes(out), end


_MODES = ((LL_DEFAULT, 6, 35, 9), (OF_DEFAULT, 5, _MAX_OF_CODE, 8),
          (ML_DEFAULT, 6, 52, 9))


def _sequences(fr: _Frame, data: bytes, pos: int, end: int, lit: bytes):
    """Decode and execute the sequences section into ``fr.out``."""
    if pos >= end:
        raise ValueError("truncated zstd data: sequences header")
    b0 = data[pos]
    if b0 == 0:
        nseq, pos = 0, pos + 1
    elif b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        if pos + 2 > end:
            raise ValueError("truncated zstd data: sequences header")
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        if pos + 3 > end:
            raise ValueError("truncated zstd data: sequences header")
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if nseq == 0:
        if pos != end:
            raise _corrupt("bytes after an empty sequences section")
        fr.out += lit
        return
    if pos >= end:
        raise ValueError("truncated zstd data: sequence modes")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise _corrupt("reserved bits of the sequence modes")
    for i, shift in enumerate((6, 4, 2)):
        mode = (modes >> shift) & 3
        default, dlog, max_sym, max_log = _MODES[i]
        if mode == 0:
            fr.tables[i] = build_fse_table(default, dlog)
        elif mode == 1:
            if pos >= end:
                raise ValueError("truncated zstd data: RLE symbol")
            if data[pos] > max_sym:
                raise _corrupt("RLE symbol out of range")
            fr.tables[i] = _rle_table(data[pos])
            pos += 1
        elif mode == 2:
            counts, log, pos = read_fse_header(data[:end], pos, max_sym,
                                               max_log)
            fr.tables[i] = build_fse_table(counts, log)
        elif fr.tables[i] is None:
            raise _corrupt("repeat mode without an earlier table")
    ll_t, of_t, ml_t = fr.tables
    bits = _Backward(data[pos:end])
    logs = [(len(t) - 1).bit_length() for t in (ll_t, of_t, ml_t)]
    ll_s, of_s, ml_s = (bits.read(n) for n in logs)
    out, reps, lp = fr.out, fr.reps, 0
    for i in range(nseq):
        of_code, ll_code, ml_code = of_t[of_s][0], ll_t[ll_s][0], \
            ml_t[ml_s][0]
        if of_code > _MAX_OF_CODE:
            raise _corrupt("offset code")
        ofv = (1 << of_code) + bits.read(of_code)
        base, nb = ML_CODES[ml_code]
        ml = base + bits.read(nb)
        base, nb = LL_CODES[ll_code]
        ll = base + bits.read(nb)
        if ofv > 3:
            offset = ofv - 3
            reps[:] = [offset, reps[0], reps[1]]
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                offset = reps[0]
            else:
                offset = reps[idx] if idx < 3 else reps[0] - 1
                if offset == 0:
                    raise _corrupt("repeat offset of 0")
                if idx == 1:
                    reps[:] = [offset, reps[0], reps[2]]
                else:
                    reps[:] = [offset, reps[0], reps[1]]
        if i + 1 < nseq:
            for t, which in ((ll_t, 0), (ml_t, 2), (of_t, 1)):
                st = (ll_s, of_s, ml_s)[which]
                _, nb, base = t[st]
                new = base + bits.read(nb)
                if which == 0:
                    ll_s = new
                elif which == 1:
                    of_s = new
                else:
                    ml_s = new
        if lp + ll > len(lit):
            raise _corrupt("a sequence reads past the literals")
        out += lit[lp:lp + ll]
        lp += ll
        if offset > len(out) or offset > fr.window:
            raise _corrupt("match offset beyond the window")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            piece = bytes(out[start:])
            out += (piece * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise _corrupt("sequences bitstream not consumed exactly")
    out += lit[lp:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the zstd frame at ``pos`` (after its magic) onto ``out``.
    -> the position after the frame."""
    if pos >= len(data):
        raise ValueError("truncated zstd data: frame header")
    fhd = data[pos]
    pos += 1
    fcs_code, single, checksum = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1
    did_size = (0, 1, 2, 4)[fhd & 3]
    if fhd & 8:
        raise _corrupt("reserved bit of the frame header")
    window = None
    if not single:
        if pos >= len(data):
            raise ValueError("truncated zstd data: window descriptor")
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    if pos + did_size > len(data):
        raise ValueError("truncated zstd data: dictionary id")
    if int.from_bytes(data[pos:pos + did_size], "little"):
        raise ValueError("zstd frame needs a dictionary: not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_code]
    if pos + fcs_size > len(data):
        raise ValueError("truncated zstd data: content size")
    content = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        content += 256 if fcs_size == 2 else 0
    pos += fcs_size
    if single:
        window = content
    if window > MAX_WINDOW:
        raise ValueError(f"zstd window of {window} bytes > {MAX_WINDOW}")
    block_max = min(window, BLOCK_MAX)
    fr = _Frame(window)
    while True:
        if pos + 3 > len(data):
            raise ValueError("truncated zstd data: block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        before = len(fr.out)
        if kind == 0:
            if size > block_max:
                raise _corrupt("raw block larger than the block maximum")
            if pos + size > len(data):
                raise ValueError("truncated zstd data: raw block")
            fr.out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if size > block_max:
                raise _corrupt("RLE block larger than the block maximum")
            if pos >= len(data):
                raise ValueError("truncated zstd data: RLE block")
            fr.out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            if size > block_max:
                raise _corrupt("compressed block larger than the maximum")
            end = pos + size
            if end > len(data):
                raise ValueError("truncated zstd data: compressed block")
            block = data[:end]
            lit, p = _literals(fr, block, pos)
            _sequences(fr, block, p, end, lit)
            if len(fr.out) - before > block_max:
                raise _corrupt("block decodes past the block maximum")
            pos = end
        else:
            raise _corrupt("reserved block type")
        if content is not None and len(fr.out) > content:
            raise _corrupt("frame decodes past its content size")
        if last:
            break
    if content is not None and len(fr.out) != content:
        raise _corrupt("frame content size mismatch")
    if checksum:
        if pos + 4 > len(data):
            raise ValueError("truncated zstd data: checksum")
        (want,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if xxh64(fr.out) & 0xFFFFFFFF != want:
            raise _corrupt("content checksum mismatch")
    out += fr.out
    return pos


def decompress(data) -> bytes:
    """Every frame of ``data``, decoded and concatenated (skippable frames
    skipped). Raises ValueError on a dictionary, truncation or corruption."""
    data = bytes(data)
    if not data:
        raise ValueError("truncated zstd data: no frame")
    try:
        return _frames(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated zstd data ({e})") from None


def _frames(data: bytes) -> bytes:
    out, pos = bytearray(), 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise ValueError("truncated zstd data: magic number")
        (magic,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            if pos + 4 > len(data):
                raise ValueError("truncated zstd data: skippable frame")
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4 + n
            if pos > len(data):
                raise ValueError("truncated zstd data: skippable frame")
        elif magic == MAGIC:
            pos = _frame(data, pos, out)
        else:
            raise ValueError(f"not zstd data (magic {magic:#010x})")
    return bytes(out)
