// Zstandard frame decoder (RFC 8878), host code: the compiled counterpart
// of blobctrl_torch/utils/zstd.py, which is its reference, step for step.
// It reads the JAX package's training checkpoints (OCDBT nodes, zarr
// chunks). Plain C entry points, loaded through ctypes; no PyTorch or
// CUDA headers, so the host C++ compiler builds it in seconds.
//
//   long zstd_decompress(src, n, dst, cap): every frame of src decoded
//     into dst -> bytes written, or a negative ZSTD_E_* code.
//   long long zstd_content_size(src, n): the sum of the frames' declared
//     content sizes, -100 when a frame declares none, or an error code.
//   unsigned crc32c(data, n, crc): CRC-32C (Castagnoli) continued from crc.
//
// Dictionaries are refused; truncated or corrupt input gives an error,
// never a read outside src or a write outside dst.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <vector>

namespace {

enum {
  E_TRUNCATED = -1,
  E_CORRUPT = -2,
  E_DICTIONARY = -3,
  E_DST_SMALL = -4,
  E_WINDOW = -5,
  E_MAGIC = -6,
  E_CHECKSUM = -7,
};

const uint32_t kMagic = 0xFD2FB528u;
const uint32_t kSkippable = 0x184D2A50u;
const uint64_t kMaxWindow = 1ull << 31;
const size_t kBlockMax = 128 * 1024;
const int kHufMaxLog = 11;
const int kMaxOfCode = 31;

const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,    9,    10,   11,
    12, 13, 14, 15, 16, 18, 20, 22, 24,   28,   32,   40,
    48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

inline int bit_length(uint64_t x) { return x ? 64 - __builtin_clzll(x) : 0; }

inline uint64_t load_le(const uint8_t* p, size_t n) {  // n <= 8 bytes
  uint64_t v = 0;
  for (size_t i = 0; i < n; i++) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---------------------------------------------------------------- XXH64
const uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
               P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
               P5 = 2870177450012600261ull;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (p + 32 <= end) {
      v1 = xround(v1, load64(p));
      v2 = xround(v2, load64(p + 8));
      v3 = xround(v3, load64(p + 16));
      v4 = xround(v4, load64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h = rotl(h ^ xround(0, load64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = rotl(h ^ (load_le(p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h = rotl(h ^ (*p * P5), 11) * P1;
    p++;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------- bit readers
// From the front, little-endian (FSE table descriptions).
struct Forward {
  const uint8_t* p;
  size_t n;
  uint64_t bit;
  bool over = false;
  uint32_t peek(int k) {  // k <= 25; bits past the end read as zeros
    size_t b = bit >> 3;
    if (b >= n) return 0;
    uint64_t v = load_le(p + b, n - b < 8 ? n - b : 8);
    return uint32_t((v >> (bit & 7)) & ((1ull << k) - 1));
  }
  void skip(int k) {
    bit += k;
    if (bit > n * 8) over = true;
  }
  uint32_t read(int k) {
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

// From the back: the stream ends in a padding 1 bit; bits are read from
// the highest down, and those before the start read as zeros (pos < 0).
struct Backward {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  int init(const uint8_t* s, size_t len) {
    p = s;
    n = len;
    if (len == 0 || s[len - 1] == 0) return E_CORRUPT;
    pos = int64_t(len) * 8 - 9 + bit_length(s[len - 1]);
    return 0;
  }
  uint64_t at(int64_t lo, int k) const {  // bits [lo, lo + k), k <= 56
    if (k == 0) return 0;
    int shift = 0;
    if (lo < 0) {
      if (lo + k <= 0) return 0;
      shift = int(-lo);
      k += int(lo);
      lo = 0;
    }
    size_t b = size_t(lo) >> 3;
    uint64_t v = load_le(p + b, n - b < 8 ? n - b : 8);
    return ((v >> (lo & 7)) & ((1ull << k) - 1)) << shift;
  }
  uint64_t read(int k) {
    pos -= k;
    return at(pos, k);
  }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint8_t symbol, bits;
  uint16_t base;
};

struct FseTable {
  int log = -1;  // -1: none yet
  std::vector<FseEntry> t;
};

// An FSE table description at src[pos..n) -> counts, log; pos moved on.
int read_fse_header(const uint8_t* src, size_t n, size_t* pos, int max_sym,
                    int max_log, int16_t* counts, int* nsym, int* log_out) {
  Forward f{src, n, uint64_t(*pos) * 8};
  int log = int(f.read(4)) + 5;
  if (log > max_log) return E_CORRUPT;
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int s = 0;
  bool previous0 = false;
  while (remaining > 1 && s <= max_sym) {
    if (previous0) {
      int n0 = 0;
      for (;;) {
        uint32_t r = f.read(2);
        n0 += int(r);
        if (r != 3) break;
        if (f.over) return E_TRUNCATED;
      }
      if (s + n0 > max_sym + 1) return E_CORRUPT;
      while (n0--) counts[s++] = 0;
      if (s > max_sym) break;
    }
    int high = (2 * threshold - 1) - remaining;
    uint32_t v = f.peek(nbits);
    int count;
    if (int(v & (threshold - 1)) < high) {
      count = int(v & (threshold - 1));
      f.skip(nbits - 1);
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= high;
      f.skip(nbits);
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    counts[s++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (f.over) return E_TRUNCATED;
  }
  if (remaining != 1 || s > max_sym + 1) return E_CORRUPT;
  *nsym = s;
  *log_out = log;
  *pos = size_t((f.bit + 7) >> 3);
  return 0;
}

int build_fse(const int16_t* counts, int nsym, int log, FseTable* out) {
  int size = 1 << log, high = size - 1;
  std::vector<uint8_t> sym(size);
  uint32_t nxt[256];
  for (int s = 0; s < nsym; s++) {
    if (counts[s] == -1) {
      sym[high--] = uint8_t(s);
      nxt[s] = 1;
    } else {
      nxt[s] = uint32_t(counts[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (int s = 0; s < nsym; s++) {
    for (int i = 0; i < counts[s]; i++) {
      sym[pos] = uint8_t(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  }
  if (pos != 0) return E_CORRUPT;
  out->log = log;
  out->t.resize(size);
  for (int u = 0; u < size; u++) {
    int s = sym[u];
    uint32_t state = nxt[s]++;
    int nb = log - (bit_length(state) - 1);
    out->t[u] = FseEntry{uint8_t(s), uint8_t(nb),
                         uint16_t((state << nb) - uint32_t(size))};
  }
  return 0;
}

// -------------------------------------------------------------- Huffman
struct Huffman {
  int log = -1;                // -1: no tree yet
  std::vector<uint16_t> table;  // symbol << 8 | bits, by the next log bits
};

int huffman_weights(const uint8_t* src, size_t end, size_t* pos,
                    uint8_t* w, int* nw) {
  if (*pos >= end) return E_TRUNCATED;
  int head = src[*pos];
  if (head >= 128) {
    int n = head - 127;
    size_t bytes = size_t(n + 1) / 2;
    if (*pos + 1 + bytes > end) return E_TRUNCATED;
    const uint8_t* r = src + *pos + 1;
    for (int i = 0; i < n; i++) w[i] = (r[i / 2] >> (i % 2 ? 0 : 4)) & 15;
    *nw = n;
    *pos += 1 + bytes;
    return 0;
  }
  size_t stop = *pos + 1 + size_t(head);
  if (stop > end) return E_TRUNCATED;
  size_t p = *pos + 1;
  int16_t counts[256];
  int nsym, log;
  int rc = read_fse_header(src, stop, &p, 255, 6, counts, &nsym, &log);
  if (rc) return rc;
  FseTable t;
  if ((rc = build_fse(counts, nsym, log, &t))) return rc;
  Backward b;
  if (p >= stop) return E_TRUNCATED;
  if ((rc = b.init(src + p, stop - p))) return rc;
  uint32_t st[2] = {uint32_t(b.read(log)), uint32_t(b.read(log))};
  int n = 0, a = 0;
  for (;;) {
    const FseEntry& e = t.t[st[a]];
    w[n++] = e.symbol;
    st[a] = e.base + uint32_t(b.read(e.bits));
    if (b.pos < 0) {
      w[n++] = t.t[st[1 - a]].symbol;
      break;
    }
    if (n > 254) return E_CORRUPT;
    a = 1 - a;
  }
  *nw = n;
  *pos = stop;
  return 0;
}

int build_huffman(const uint8_t* weights, int nw, Huffman* h) {
  uint32_t total = 0;
  for (int i = 0; i < nw; i++) {
    if (weights[i] > kHufMaxLog) return E_CORRUPT;
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) return E_CORRUPT;
  int log = bit_length(total);
  if (log > kHufMaxLog) return E_CORRUPT;
  uint32_t left = (1u << log) - total;
  if (left & (left - 1)) return E_CORRUPT;
  uint8_t w[256];
  std::memcpy(w, weights, nw);
  w[nw] = uint8_t(bit_length(left));
  int n = nw + 1;
  uint32_t rank[kHufMaxLog + 2] = {0}, start[kHufMaxLog + 2] = {0};
  for (int i = 0; i < n; i++) rank[w[i]]++;
  uint32_t next = 0;
  for (int k = 1; k <= log; k++) {
    start[k] = next;
    next += rank[k] << (k - 1);
  }
  h->log = log;
  h->table.assign(size_t(1) << log, 0);
  for (int s = 0; s < n; s++) {
    if (!w[s]) continue;
    uint16_t e = uint16_t((s << 8) | (log + 1 - w[s]));
    uint32_t cnt = 1u << (w[s] - 1);
    for (uint32_t u = start[w[s]]; u < start[w[s]] + cnt; u++) h->table[u] = e;
    start[w[s]] += cnt;
  }
  return 0;
}

int huffman_stream(const uint8_t* s, size_t n, uint8_t* out, size_t count,
                   const Huffman& h) {
  Backward b;
  int rc = b.init(s, n);
  if (rc) return rc;
  const uint16_t* dt = h.table.data();
  const int log = h.log;
  const uint64_t mask = (1ull << log) - 1;
  int64_t pos = b.pos;
  size_t i = 0;
  // four symbols per load of eight bytes: at least 57 bits are fresh
  while (i + 4 <= count && pos >= 64) {
    int64_t top = (pos - 1) >> 3;
    int64_t lo = (top - 7) * 8;
    uint64_t c = load64(s + top - 7);
    for (int k = 0; k < 4; k++) {
      uint16_t e = dt[(c >> (pos - log - lo)) & mask];
      out[i++] = uint8_t(e >> 8);
      pos -= e & 0xff;
    }
  }
  while (i < count) {
    uint16_t e = dt[b.at(pos - log, log)];
    out[i++] = uint8_t(e >> 8);
    pos -= e & 0xff;
  }
  return pos == 0 ? 0 : E_CORRUPT;
}

// The four streams in lockstep (independent chains of loads, so the core
// overlaps them), then each one's tail alone.
int huffman_4streams(const uint8_t* const* s, const size_t* n, uint8_t* out,
                     const size_t* count, const Huffman& h) {
  Backward b[4];
  int64_t pos[4];
  uint8_t* o[4];
  size_t i[4] = {0, 0, 0, 0};
  for (int k = 0; k < 4; k++) {
    int rc = b[k].init(s[k], n[k]);
    if (rc) return rc;
    pos[k] = b[k].pos;
    o[k] = out;
    out += count[k];
  }
  const uint16_t* dt = h.table.data();
  const int log = h.log;
  const uint64_t mask = (1ull << log) - 1;
  for (;;) {
    bool ok = true;
    for (int k = 0; k < 4; k++)
      ok = ok && i[k] + 4 <= count[k] && pos[k] >= 64;
    if (!ok) break;
    uint64_t c[4];
    int64_t lo[4];
    for (int k = 0; k < 4; k++) {
      int64_t top = (pos[k] - 1) >> 3;
      lo[k] = (top - 7) * 8;
      c[k] = load64(s[k] + top - 7);
    }
    for (int r = 0; r < 4; r++) {
      for (int k = 0; k < 4; k++) {
        uint16_t e = dt[(c[k] >> (pos[k] - log - lo[k])) & mask];
        o[k][i[k]++] = uint8_t(e >> 8);
        pos[k] -= e & 0xff;
      }
    }
  }
  for (int k = 0; k < 4; k++) {
    while (i[k] < count[k]) {
      uint16_t e = dt[b[k].at(pos[k] - log, log)];
      o[k][i[k]++] = uint8_t(e >> 8);
      pos[k] -= e & 0xff;
    }
    if (pos[k] != 0) return E_CORRUPT;
  }
  return 0;
}

// ---------------------------------------------------------------- frame
struct Frame {
  uint64_t window;
  uint8_t* begin;  // the frame's first output byte
  Huffman huf;
  FseTable tables[3];  // LL, OF, ML
  uint64_t reps[3] = {1, 4, 8};
  std::vector<uint8_t> lit;
};

// The literals section at src[pos..end) -> fr.lit[0..*size); pos moved on.
int literals(Frame& fr, const uint8_t* src, size_t end, size_t* pos,
             size_t* size) {
  size_t p = *pos;
  if (p >= end) return E_TRUNCATED;
  int b0 = src[p], kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind == 0 || kind == 1) {
    size_t sz;
    if (fmt == 0 || fmt == 2) {
      sz = size_t(b0 >> 3);
      p += 1;
    } else if (fmt == 1) {
      if (p + 2 > end) return E_TRUNCATED;
      sz = size_t(b0 >> 4) + (size_t(src[p + 1]) << 4);
      p += 2;
    } else {
      if (p + 3 > end) return E_TRUNCATED;
      sz = size_t(b0 >> 4) + (size_t(src[p + 1]) << 4) +
           (size_t(src[p + 2]) << 12);
      p += 3;
    }
    if (sz > kBlockMax) return E_CORRUPT;
    if (kind == 0) {
      if (p + sz > end) return E_TRUNCATED;
      std::memcpy(fr.lit.data(), src + p, sz);
      p += sz;
    } else {
      if (p >= end) return E_TRUNCATED;
      std::memset(fr.lit.data(), src[p], sz);
      p += 1;
    }
    *pos = p;
    *size = sz;
    return 0;
  }
  static const int kBytes[4] = {3, 3, 4, 5}, kBits[4] = {10, 10, 14, 18};
  int nb = kBytes[fmt], bits = kBits[fmt];
  if (p + nb > end) return E_TRUNCATED;
  uint64_t h = load_le(src + p, nb);
  size_t sz = size_t((h >> 4) & ((1u << bits) - 1));
  size_t csize = size_t((h >> (4 + bits)) & ((1u << bits) - 1));
  p += nb;
  if (sz > kBlockMax) return E_CORRUPT;
  size_t stop = p + csize;
  if (stop > end) return E_TRUNCATED;
  int rc;
  if (kind == 2) {
    uint8_t w[256];
    int nw;
    if ((rc = huffman_weights(src, stop, &p, w, &nw))) return rc;
    if ((rc = build_huffman(w, nw, &fr.huf))) return rc;
  } else if (fr.huf.log < 0) {
    return E_CORRUPT;
  }
  uint8_t* out = fr.lit.data();
  if (fmt == 0) {
    if (p > stop) return E_CORRUPT;
    if ((rc = huffman_stream(src + p, stop - p, out, sz, fr.huf))) return rc;
  } else {
    if (p + 6 > stop) return E_CORRUPT;
    size_t s[4];
    s[0] = size_t(load_le(src + p, 2));
    s[1] = size_t(load_le(src + p + 2, 2));
    s[2] = size_t(load_le(src + p + 4, 2));
    p += 6;
    if (s[0] + s[1] + s[2] + 1 > stop - p) return E_CORRUPT;
    s[3] = stop - p - s[0] - s[1] - s[2];
    size_t each = (sz + 3) / 4;
    if (each * 3 > sz) return E_CORRUPT;
    size_t counts[4] = {each, each, each, sz - 3 * each};
    const uint8_t* starts[4] = {src + p, src + p + s[0],
                                src + p + s[0] + s[1],
                                src + p + s[0] + s[1] + s[2]};
    if ((rc = huffman_4streams(starts, s, out, counts, fr.huf))) return rc;
  }
  *pos = stop;
  *size = sz;
  return 0;
}

int sequences(Frame& fr, const uint8_t* src, size_t pos, size_t end,
              size_t nlit, uint8_t** op, uint8_t* oend) {
  if (pos >= end) return E_TRUNCATED;
  int b0 = src[pos];
  size_t nseq;
  if (b0 == 0) {
    nseq = 0;
    pos += 1;
  } else if (b0 < 128) {
    nseq = size_t(b0);
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) return E_TRUNCATED;
    nseq = (size_t(b0 - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) return E_TRUNCATED;
    nseq = size_t(src[pos + 1]) + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  const uint8_t* lit = fr.lit.data();
  uint8_t* out = *op;
  if (nseq == 0) {
    if (pos != end) return E_CORRUPT;
    if (size_t(oend - out) < nlit) return E_DST_SMALL;
    std::memcpy(out, lit, nlit);
    *op = out + nlit;
    return 0;
  }
  if (pos >= end) return E_TRUNCATED;
  int modes = src[pos++];
  if (modes & 3) return E_CORRUPT;
  static const int16_t* kDefault[3] = {kLLDefault, kOFDefault, kMLDefault};
  static const int kDefaultN[3] = {36, 29, 53}, kDefaultLog[3] = {6, 5, 6},
                   kMaxSym[3] = {35, kMaxOfCode, 52}, kMaxLog[3] = {9, 8, 9},
                   kShift[3] = {6, 4, 2};
  int rc;
  for (int i = 0; i < 3; i++) {
    int mode = (modes >> kShift[i]) & 3;
    if (mode == 0) {
      if ((rc = build_fse(kDefault[i], kDefaultN[i], kDefaultLog[i],
                          &fr.tables[i])))
        return rc;
    } else if (mode == 1) {
      if (pos >= end) return E_TRUNCATED;
      if (src[pos] > kMaxSym[i]) return E_CORRUPT;
      fr.tables[i].log = 0;
      fr.tables[i].t.assign(1, FseEntry{src[pos], 0, 0});
      pos += 1;
    } else if (mode == 2) {
      int16_t counts[256];
      int nsym, log;
      if ((rc = read_fse_header(src, end, &pos, kMaxSym[i], kMaxLog[i],
                                counts, &nsym, &log)))
        return rc;
      if ((rc = build_fse(counts, nsym, log, &fr.tables[i]))) return rc;
    } else if (fr.tables[i].log < 0) {
      return E_CORRUPT;
    }
  }
  const FseEntry* ll_t = fr.tables[0].t.data();
  const FseEntry* of_t = fr.tables[1].t.data();
  const FseEntry* ml_t = fr.tables[2].t.data();
  Backward b;
  if (pos >= end) return E_TRUNCATED;
  if ((rc = b.init(src + pos, end - pos))) return rc;
  uint32_t ll_s = uint32_t(b.read(fr.tables[0].log));
  uint32_t of_s = uint32_t(b.read(fr.tables[1].log));
  uint32_t ml_s = uint32_t(b.read(fr.tables[2].log));
  uint64_t* reps = fr.reps;
  size_t lp = 0;
  for (size_t i = 0; i < nseq; i++) {
    int of_code = of_t[of_s].symbol, ll_code = ll_t[ll_s].symbol,
        ml_code = ml_t[ml_s].symbol;
    if (of_code > kMaxOfCode || ll_code > 35 || ml_code > 52)
      return E_CORRUPT;
    uint64_t ofv = (1ull << of_code) + b.read(of_code);
    uint64_t ml = kMLBase[ml_code] + b.read(kMLBits[ml_code]);
    uint64_t ll = kLLBase[ll_code] + b.read(kLLBits[ll_code]);
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = offset;
    } else {
      int idx = int(ofv) - 1 + (ll == 0);
      if (idx == 0) {
        offset = reps[0];
      } else {
        offset = idx < 3 ? reps[idx] : reps[0] - 1;
        if (offset == 0) return E_CORRUPT;
        if (idx != 1) reps[2] = reps[1];
        reps[1] = reps[0];
        reps[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      ll_s = ll_t[ll_s].base + uint32_t(b.read(ll_t[ll_s].bits));
      ml_s = ml_t[ml_s].base + uint32_t(b.read(ml_t[ml_s].bits));
      of_s = of_t[of_s].base + uint32_t(b.read(of_t[of_s].bits));
    }
    if (lp + ll > nlit) return E_CORRUPT;
    if (uint64_t(oend - out) < ll + ml) return E_DST_SMALL;
    std::memcpy(out, lit + lp, ll);
    out += ll;
    lp += ll;
    if (offset > uint64_t(out - fr.begin) || offset > fr.window)
      return E_CORRUPT;
    const uint8_t* from = out - offset;
    if (offset >= ml) {
      std::memcpy(out, from, ml);
    } else {
      for (uint64_t k = 0; k < ml; k++) out[k] = from[k];
    }
    out += ml;
  }
  if (b.pos != 0) return E_CORRUPT;
  if (size_t(oend - out) < nlit - lp) return E_DST_SMALL;
  std::memcpy(out, lit + lp, nlit - lp);
  *op = out + (nlit - lp);
  return 0;
}

struct Header {
  uint64_t window, content;  // content: ~0 when not declared
  bool checksum;
  size_t size;  // header bytes after the magic
};

int frame_header(const uint8_t* s, size_t n, Header* h) {
  if (n < 1) return E_TRUNCATED;
  int fhd = s[0];
  int fcs_code = fhd >> 6, single = (fhd >> 5) & 1;
  static const int kDid[4] = {0, 1, 2, 4};
  int did = kDid[fhd & 3];
  if (fhd & 8) return E_CORRUPT;
  size_t p = 1;
  uint64_t window = 0;
  if (!single) {
    if (p >= n) return E_TRUNCATED;
    int wd = s[p++];
    uint64_t base = 1ull << (10 + (wd >> 3));
    window = base + (base >> 3) * uint64_t(wd & 7);
  }
  if (p + did > n) return E_TRUNCATED;
  if (load_le(s + p, did)) return E_DICTIONARY;
  p += did;
  static const int kFcs[4] = {0, 2, 4, 8};
  int fcs = fcs_code == 0 && single ? 1 : kFcs[fcs_code];
  if (p + fcs > n) return E_TRUNCATED;
  uint64_t content = ~0ull;
  if (fcs) content = load_le(s + p, fcs) + (fcs == 2 ? 256 : 0);
  p += fcs;
  if (single) window = content;
  if (window > kMaxWindow) return E_WINDOW;
  h->window = window;
  h->content = content;
  h->checksum = (fhd >> 2) & 1;
  h->size = p;
  return 0;
}

long decode_frame(const uint8_t* s, size_t n, size_t* used, uint8_t* dst,
                  uint8_t* oend) {
  Header hd;
  int rc = frame_header(s, n, &hd);
  if (rc) return rc;
  size_t p = hd.size;
  size_t block_max = hd.window < kBlockMax ? size_t(hd.window) : kBlockMax;
  Frame fr;
  fr.window = hd.window;
  fr.begin = dst;
  fr.lit.resize(kBlockMax + 8);
  uint8_t* op = dst;
  for (;;) {
    if (p + 3 > n) return E_TRUNCATED;
    uint32_t h = uint32_t(load_le(s + p, 3));
    p += 3;
    int last = h & 1, kind = (h >> 1) & 3;
    size_t size = h >> 3;
    if (kind == 3) return E_CORRUPT;
    if (size > block_max) return E_CORRUPT;
    if (kind == 0) {
      if (p + size > n) return E_TRUNCATED;
      if (size_t(oend - op) < size) return E_DST_SMALL;
      std::memcpy(op, s + p, size);
      op += size;
      p += size;
    } else if (kind == 1) {
      if (p >= n) return E_TRUNCATED;
      if (size_t(oend - op) < size) return E_DST_SMALL;
      std::memset(op, s[p], size);
      op += size;
      p += 1;
    } else {
      size_t end = p + size;
      if (end > n) return E_TRUNCATED;
      uint8_t* before = op;
      size_t nlit, q = p;
      if ((rc = literals(fr, s, end, &q, &nlit))) return rc;
      if ((rc = sequences(fr, s, q, end, nlit, &op, oend))) return rc;
      if (size_t(op - before) > block_max) return E_CORRUPT;
      p = end;
    }
    if (hd.content != ~0ull && uint64_t(op - dst) > hd.content)
      return E_CORRUPT;
    if (last) break;
  }
  if (hd.content != ~0ull && uint64_t(op - dst) != hd.content)
    return E_CORRUPT;
  if (hd.checksum) {
    if (p + 4 > n) return E_TRUNCATED;
    uint32_t want = uint32_t(load_le(s + p, 4));
    p += 4;
    if (uint32_t(xxh64(dst, size_t(op - dst))) != want) return E_CHECKSUM;
  }
  *used = p;
  return long(op - dst);
}

uint32_t crc_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c >> 1) ^ (c & 1 ? 0x82F63B78u : 0);
      crc_table[i] = c;
    }
  }
} crc_init;

}  // namespace

extern "C" {

long zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  if (n == 0) return E_TRUNCATED;
  size_t p = 0;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  while (p < n) {
    if (p + 4 > n) return E_TRUNCATED;
    uint32_t magic = uint32_t(load_le(src + p, 4));
    p += 4;
    if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (p + 4 > n) return E_TRUNCATED;
      uint64_t len = load_le(src + p, 4);
      p += 4;
      if (len > n - p) return E_TRUNCATED;
      p += size_t(len);
    } else if (magic == kMagic) {
      size_t used = 0;
      long got = decode_frame(src + p, n - p, &used, op, oend);
      if (got < 0) return got;
      op += got;
      p += used;
    } else {
      return E_MAGIC;
    }
  }
  return long(op - dst);
}

long long zstd_content_size(const uint8_t* src, size_t n) {
  // the frames' declared sizes, walking their blocks without decoding
  long long total = 0;
  size_t p = 0;
  if (n == 0) return E_TRUNCATED;
  while (p < n) {
    if (p + 4 > n) return E_TRUNCATED;
    uint32_t magic = uint32_t(load_le(src + p, 4));
    p += 4;
    if ((magic & 0xFFFFFFF0u) == kSkippable) {
      if (p + 4 > n) return E_TRUNCATED;
      uint64_t len = load_le(src + p, 4);
      p += 4;
      if (len > n - p) return E_TRUNCATED;
      p += size_t(len);
      continue;
    }
    if (magic != kMagic) return E_MAGIC;
    Header hd;
    int rc = frame_header(src + p, n - p, &hd);
    if (rc) return rc;
    if (hd.content == ~0ull) return -100;  // undeclared
    total += (long long)hd.content;
    p += hd.size;
    for (;;) {
      if (p + 3 > n) return E_TRUNCATED;
      uint32_t h = uint32_t(load_le(src + p, 3));
      p += 3;
      size_t size = h >> 3;
      p += ((h >> 1) & 3) == 1 ? 1 : size;
      if (p > n) return E_TRUNCATED;
      if (h & 1) break;
    }
    if (hd.checksum) p += 4;
    if (p > n) return E_TRUNCATED;
  }
  return total;
}

unsigned crc32c(const uint8_t* data, size_t n, unsigned crc) {
  uint32_t c = ~uint32_t(crc);
  for (size_t i = 0; i < n; i++) c = crc_table[(c ^ data[i]) & 0xff] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
