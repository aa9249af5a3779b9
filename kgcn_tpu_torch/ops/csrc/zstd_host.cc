// Host zstd decoder of the port (kgcn_tpu_torch/runtime/orbax.py), plain
// C++, no CUDA: the host C++ compiler builds it into its own library
// (ops/_build.py).  It reads the zstd frames of kgcn_tpu's orbax checkpoints
// (tensorstore's OCDBT nodes and zarr chunks) without the zstd library.
//
// A frame decoder to RFC 8878: raw, RLE and compressed blocks; literals
// raw, RLE, Huffman-compressed (one or four streams, the tree described
// directly or by FSE-compressed weights) and treeless (the previous
// block's tree); sequences with predefined, RLE, FSE-described and repeated
// tables for literal lengths, match lengths and offsets; the three repeat
// offsets; the optional content checksum (XXH64); skippable frames.  Frames
// that name a dictionary are refused.  Several frames in one buffer are
// decoded one after the other.
//
// Entry points (C interface, ctypes):
//   kgcn_zstd_content_size(src, n)  -> the summed content sizes of the
//       frames, -1 when a frame does not state its size, -2 on a corrupt
//       header;
//   kgcn_zstd_decompress(src, n, dst, cap, err, err_cap) -> bytes written,
//       or -1 with a message in err (a corrupt frame, a bad checksum, an
//       output larger than cap).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

inline int highest_bit(uint64_t v) {  // index of the highest set bit; v > 0
  return 63 - __builtin_clzll(v);
}

// ------------------------------------------------------------- byte reader --
struct Forward {
  const uint8_t* p;
  size_t n, at = 0;
  Forward(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  const uint8_t* take(size_t k) {
    if (k > n - at) throw Corrupt("truncated input");
    const uint8_t* r = p + at;
    at += k;
    return r;
  }
  uint8_t byte() { return *take(1); }
  uint64_t le(int k) {
    const uint8_t* b = take(k);
    uint64_t v = 0;
    for (int i = k - 1; i >= 0; --i) v = (v << 8) | b[i];
    return v;
  }
  size_t left() const { return n - at; }
};

// LSB-first bits of a buffer at a bit offset (little-endian bit order)
inline uint64_t bits_at(const uint8_t* src, size_t len, int64_t off, int nbits) {
  if (nbits == 0) return 0;
  uint64_t v = 0;
  int64_t byte = off >> 3;
  int shift = (int)(off & 7);
  int got = 0;
  for (int64_t i = byte; got < nbits + shift && i < (int64_t)len; ++i) {
    v |= (uint64_t)src[i] << got;
    got += 8;
    if (got >= 56) break;
  }
  // enough for nbits <= 56 - 7; wider reads are split by the callers
  v >>= shift;
  return nbits >= 64 ? v : (v & ((1ULL << nbits) - 1));
}

// A bitstream read backwards from its end (FSE, Huffman and sequences):
// the last byte holds a 1 marking the end of the padding.
struct Backward {
  const uint8_t* src;
  size_t len;
  int64_t off;  // bits left to read; below 0 the stream has overflowed
  Backward(const uint8_t* s, size_t n) : src(s), len(n) {
    if (n == 0) throw Corrupt("empty bitstream");
    uint8_t last = s[n - 1];
    if (last == 0) throw Corrupt("bitstream without its end mark");
    off = (int64_t)n * 8 - (8 - highest_bit(last));
  }
  uint64_t read(int nbits) {
    if (nbits == 0) return 0;
    if (nbits > 40) {  // two reads, high part first
      uint64_t hi = read(nbits - 32);
      return (hi << 32) | read(32);
    }
    off -= nbits;
    int64_t at = off;
    int actual = nbits;
    if (at < 0) {
      actual += (int)at;
      at = 0;
    }
    if (actual <= 0) return 0;
    uint64_t v = bits_at(src, len, at, actual);
    if (off < 0) v <<= -off;
    return v;
  }
};

// -------------------------------------------------------------------- FSE --
struct FSETable {
  int log = 0;
  std::vector<uint8_t> symbol, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FSETable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  t.log = log;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym, 0);
  int high = size;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.symbol[--high] = (uint8_t)s;
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = (uint16_t)norm[s];
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = (uint8_t)s;
      do {
        pos = (pos + step) & mask;
      } while (pos >= high);
    }
  }
  if (pos != 0) throw Corrupt("FSE table: probabilities do not fill the table");
  for (int i = 0; i < size; ++i) {
    uint16_t n = next[t.symbol[i]]++;
    if (n == 0) throw Corrupt("FSE table: bad state");
    int b = log - highest_bit(n);
    t.nbits[i] = (uint8_t)b;
    t.base[i] = (uint16_t)((n << b) - size);
  }
}

void fse_rle(FSETable& t, uint8_t sym) {
  t.log = 0;
  t.symbol.assign(1, sym);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// An FSE table description (forward bits); returns the bytes it took.
size_t fse_read(FSETable& t, const uint8_t* src, size_t n, int max_log, int max_sym) {
  if (n == 0) throw Corrupt("FSE table: no description");
  int64_t off = 0;
  const int64_t total_bits = (int64_t)n * 8;
  auto rd = [&](int k) -> uint64_t {
    if (off + k > total_bits) throw Corrupt("FSE table: truncated description");
    uint64_t v = bits_at(src, n, off, k);
    off += k;
    return v;
  };
  int log = (int)rd(4) + 5;
  if (log > max_log) throw Corrupt("FSE table: accuracy log too large");
  int remaining = 1 << log;
  std::vector<int16_t> norm(256, 0);
  int sym = 0;
  while (remaining > 0 && sym <= max_sym) {
    int bits = highest_bit((uint64_t)remaining + 1) + 1;
    uint32_t val = (uint32_t)rd(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - (uint32_t)(remaining + 1);
    if ((val & lower) < threshold) {
      off -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int p = (int)val - 1;
    remaining -= p < 0 ? -p : p;
    norm[sym++] = (int16_t)p;
    if (p == 0) {
      int rep = (int)rd(2);
      for (;;) {
        for (int i = 0; i < rep && sym <= max_sym; ++i) norm[sym++] = 0;
        if (rep == 3) rep = (int)rd(2); else break;
      }
    }
  }
  if (remaining != 0 || sym > max_sym + 1) throw Corrupt("FSE table: bad probabilities");
  fse_build(t, norm.data(), sym, log);
  return (size_t)((off + 7) >> 3);
}

inline uint8_t fse_peek(const FSETable& t, uint32_t state) { return t.symbol[state]; }

inline void fse_update(const FSETable& t, uint32_t& state, Backward& bs) {
  state = t.base[state] + (uint32_t)bs.read(t.nbits[state]);
}

// ---------------------------------------------------------------- Huffman --
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;
};

void huf_from_weights(HufTable& h, const uint8_t* w, int nsym) {
  // the last symbol's weight is implied by the others
  uint64_t total = 0;
  for (int i = 0; i < nsym; ++i) {
    if (w[i] > 12) throw Corrupt("Huffman weight too large");
    if (w[i]) total += 1ULL << (w[i] - 1);
  }
  if (total == 0) throw Corrupt("Huffman weights all zero");
  int max_bits = highest_bit(total) + 1;
  uint64_t left = (1ULL << max_bits) - total;
  if (left == 0 || (left & (left - 1))) throw Corrupt("Huffman weights do not close the tree");
  std::vector<uint8_t> weights(w, w + nsym);
  weights.push_back((uint8_t)(highest_bit(left) + 1));
  ++nsym;
  if (max_bits > 11) throw Corrupt("Huffman code too long");
  h.max_bits = max_bits;
  const int size = 1 << max_bits;
  h.symbol.assign(size, 0);
  h.nbits.assign(size, 0);
  std::vector<uint8_t> bits(nsym, 0);
  int rank_count[13] = {0};
  for (int i = 0; i < nsym; ++i) {
    if (weights[i]) {
      bits[i] = (uint8_t)(max_bits + 1 - weights[i]);
      rank_count[bits[i]]++;
    }
  }
  int rank_idx[14] = {0};
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1 << (max_bits - i));
    if (rank_idx[i - 1] > size) throw Corrupt("Huffman table overflow");
    for (int j = rank_idx[i]; j < rank_idx[i - 1]; ++j) h.nbits[j] = (uint8_t)i;
  }
  if (rank_idx[0] != size) throw Corrupt("Huffman table does not fill");
  for (int i = 0; i < nsym; ++i) {
    if (!bits[i]) continue;
    int code = rank_idx[bits[i]];
    int len = 1 << (max_bits - bits[i]);
    for (int j = 0; j < len; ++j) h.symbol[code + j] = (uint8_t)i;
    rank_idx[bits[i]] += len;
  }
}

// The tree description at the start of a compressed literals section;
// returns the bytes it took.
size_t huf_read(HufTable& h, const uint8_t* src, size_t n) {
  if (n == 0) throw Corrupt("Huffman tree: no description");
  uint8_t head = src[0];
  uint8_t w[256];
  int nsym = 0;
  if (head >= 128) {  // weights stored directly, 4 bits each
    nsym = head - 127;
    size_t bytes = (size_t)(nsym + 1) / 2;
    if (1 + bytes > n) throw Corrupt("Huffman tree: truncated weights");
    for (int i = 0; i < nsym; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    huf_from_weights(h, w, nsym);
    return 1 + bytes;
  }
  size_t clen = head;
  if (1 + clen > n) throw Corrupt("Huffman tree: truncated FSE weights");
  FSETable t;
  size_t hdr = fse_read(t, src + 1, clen, 6, 255);
  if (hdr >= clen) throw Corrupt("Huffman tree: no weight bitstream");
  Backward bs(src + 1 + hdr, clen - hdr);
  uint32_t s1 = (uint32_t)bs.read(t.log), s2 = (uint32_t)bs.read(t.log);
  for (;;) {
    if (nsym >= 255) throw Corrupt("Huffman tree: too many weights");
    w[nsym++] = fse_peek(t, s1);
    fse_update(t, s1, bs);
    if (bs.off < 0) {
      w[nsym++] = fse_peek(t, s2);
      break;
    }
    if (nsym >= 255) throw Corrupt("Huffman tree: too many weights");
    w[nsym++] = fse_peek(t, s2);
    fse_update(t, s2, bs);
    if (bs.off < 0) {
      if (nsym >= 255) throw Corrupt("Huffman tree: too many weights");
      w[nsym++] = fse_peek(t, s1);
      break;
    }
  }
  huf_from_weights(h, w, nsym);
  return 1 + clen;
}

void huf_stream(const HufTable& h, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  Backward bs(src, n);
  const uint32_t mask = (1u << h.max_bits) - 1;
  uint32_t state = (uint32_t)bs.read(h.max_bits);
  for (size_t i = 0; i < count; ++i) {
    out[i] = h.symbol[state];
    int b = h.nbits[state];
    state = ((state << b) + (uint32_t)bs.read(b)) & mask;
  }
  if (bs.off != -h.max_bits) throw Corrupt("Huffman stream: bits left over or missing");
}

// ------------------------------------------------------------- sequences --
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,   12,   13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24,  25,   26,   27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41,  43,   47,   51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ------------------------------------------------------------------ XXH64 --
const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  acc += in * P2;
  acc = rotl(acc, 31);
  return acc * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  acc ^= xround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t len) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0ULL - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += (uint64_t)len;
  while (p + 8 <= end) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ frame --
struct Output {
  uint8_t* dst;
  size_t cap, at = 0;
  void need(size_t k) const {
    if (k > cap - at) throw Corrupt("output larger than the buffer given");
  }
  void put(const uint8_t* s, size_t k) {
    need(k);
    if (k) std::memcpy(dst + at, s, k);
    at += k;
  }
  void fill(uint8_t b, size_t k) {
    need(k);
    std::memset(dst + at, b, k);
    at += k;
  }
};

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FSETable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  size_t frame_start = 0;  // where this frame's output begins
};

// A literals section → the block's literals; returns the bytes it took.
size_t read_literals(FrameState& fs, const uint8_t* src, size_t n, std::vector<uint8_t>& lit) {
  if (n == 0) throw Corrupt("block without a literals section");
  const int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type == 0 || type == 1) {  // raw, RLE
    size_t regen, hdr;
    if ((fmt & 1) == 0) {
      regen = src[0] >> 3;
      hdr = 1;
    } else if (fmt == 1) {
      if (n < 2) throw Corrupt("truncated literals header");
      regen = (src[0] >> 4) | ((size_t)src[1] << 4);
      hdr = 2;
    } else {
      if (n < 3) throw Corrupt("truncated literals header");
      regen = (src[0] >> 4) | ((size_t)src[1] << 4) | ((size_t)src[2] << 12);
      hdr = 3;
    }
    if (type == 0) {
      if (hdr + regen > n) throw Corrupt("truncated raw literals");
      lit.assign(src + hdr, src + hdr + regen);
      return hdr + regen;
    }
    if (hdr + 1 > n) throw Corrupt("truncated RLE literals");
    lit.assign(regen, src[hdr]);
    return hdr + 1;
  }
  size_t regen, comp, hdr;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt <= 1) {
    if (n < 3) throw Corrupt("truncated literals header");
    regen = (src[0] >> 4) | ((size_t)(src[1] & 0x3F) << 4);
    comp = (src[1] >> 6) | ((size_t)src[2] << 2);
    hdr = 3;
  } else if (fmt == 2) {
    if (n < 4) throw Corrupt("truncated literals header");
    regen = (src[0] >> 4) | ((size_t)src[1] << 4) | ((size_t)(src[2] & 3) << 12);
    comp = (src[2] >> 2) | ((size_t)src[3] << 6);
    hdr = 4;
  } else {
    if (n < 5) throw Corrupt("truncated literals header");
    regen = (src[0] >> 4) | ((size_t)src[1] << 4) | ((size_t)(src[2] & 0x3F) << 12);
    comp = (src[2] >> 6) | ((size_t)src[3] << 2) | ((size_t)src[4] << 10);
    hdr = 5;
  }
  if (hdr + comp > n) throw Corrupt("truncated compressed literals");
  const uint8_t* p = src + hdr;
  size_t left = comp;
  if (type == 2) {
    size_t t = huf_read(fs.huf, p, left);
    fs.have_huf = true;
    p += t;
    left -= t;
  } else if (!fs.have_huf) {
    throw Corrupt("treeless literals without a previous Huffman tree");
  }
  lit.resize(regen);
  if (streams == 1) {
    huf_stream(fs.huf, p, left, lit.data(), regen);
  } else {
    if (left < 6) throw Corrupt("truncated jump table");
    size_t s1 = p[0] | (p[1] << 8), s2 = p[2] | (p[3] << 8), s3 = p[4] | (p[5] << 8);
    if (6 + s1 + s2 + s3 > left) throw Corrupt("jump table beyond the literals");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t each = (regen + 3) / 4;
    if (3 * each > regen) throw Corrupt("too few literals for four streams");
    const uint8_t* q = p + 6;
    huf_stream(fs.huf, q, s1, lit.data(), each);
    huf_stream(fs.huf, q + s1, s2, lit.data() + each, each);
    huf_stream(fs.huf, q + s1 + s2, s3, lit.data() + 2 * each, each);
    huf_stream(fs.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * each, regen - 3 * each);
  }
  return hdr + comp;
}

size_t seq_table(FSETable& t, bool& have, int mode, const uint8_t* src, size_t n,
                 const int16_t* dflt, int dflt_n, int dflt_log, int max_log, int max_sym) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, dflt_n, dflt_log);
      have = true;
      return 0;
    case 1:
      if (n < 1) throw Corrupt("truncated RLE sequence table");
      if (src[0] > max_sym) throw Corrupt("RLE sequence symbol out of range");
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t k = fse_read(t, src, n, max_log, max_sym);
      have = true;
      return k;
    }
    default:
      if (!have) throw Corrupt("repeated sequence table without a previous one");
      return 0;
  }
}

void compressed_block(FrameState& fs, const uint8_t* src, size_t n, Output& out) {
  std::vector<uint8_t> lit;
  size_t at = read_literals(fs, src, n, lit);
  if (at >= n) throw Corrupt("block without a sequences section");
  const uint8_t* p = src + at;
  size_t left = n - at;
  size_t nseq = p[0], h = 1;
  if (nseq >= 128) {
    if (nseq < 255) {
      if (left < 2) throw Corrupt("truncated sequence count");
      nseq = ((nseq - 128) << 8) + p[1];
      h = 2;
    } else {
      if (left < 3) throw Corrupt("truncated sequence count");
      nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
      h = 3;
    }
  }
  p += h;
  left -= h;
  if (nseq == 0) {  // literals only: no compression modes follow
    out.put(lit.data(), lit.size());
    return;
  }
  if (left < 1) throw Corrupt("truncated compression modes");
  uint8_t modes = p[0];
  if (modes & 3) throw Corrupt("reserved bits set in the compression modes");
  p += 1;
  left -= 1;
  size_t k;
  k = seq_table(fs.ll, fs.have_ll, modes >> 6, p, left, LL_DEFAULT, 36, 6, 9, 35);
  p += k; left -= k;
  k = seq_table(fs.of, fs.have_of, (modes >> 4) & 3, p, left, OF_DEFAULT, 29, 5, 8, 31);
  p += k; left -= k;
  k = seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, p, left, ML_DEFAULT, 53, 6, 9, 52);
  p += k; left -= k;

  Backward bs(p, left);
  uint32_t ll_s = (uint32_t)bs.read(fs.ll.log);
  uint32_t of_s = (uint32_t)bs.read(fs.of.log);
  uint32_t ml_s = (uint32_t)bs.read(fs.ml.log);
  size_t lit_at = 0;
  for (size_t i = 0; i < nseq; ++i) {
    uint8_t of_code = fse_peek(fs.of, of_s), ll_code = fse_peek(fs.ll, ll_s),
            ml_code = fse_peek(fs.ml, ml_s);
    if (ll_code > 35 || ml_code > 52 || of_code > 31) throw Corrupt("sequence code out of range");
    uint64_t of_value = (1ULL << of_code) + bs.read(of_code);
    uint64_t ml = ML_BASE[ml_code] + bs.read(ML_BITS[ml_code]);
    uint64_t ll = LL_BASE[ll_code] + bs.read(LL_BITS[ll_code]);
    if (i + 1 != nseq) {
      fse_update(fs.ll, ll_s, bs);
      fse_update(fs.ml, ml_s, bs);
      fse_update(fs.of, of_s, bs);
    }
    uint64_t offset;
    if (of_value > 3) {
      offset = of_value - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      uint64_t idx = of_value - 1;
      if (ll == 0) ++idx;
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (ll > lit.size() - lit_at) throw Corrupt("sequence reads past the literals");
    out.put(lit.data() + lit_at, (size_t)ll);
    lit_at += (size_t)ll;
    if (offset == 0 || offset > out.at - fs.frame_start) throw Corrupt("match offset out of range");
    out.need((size_t)ml);
    uint8_t* d = out.dst + out.at;
    const uint8_t* s = d - offset;
    if (offset >= ml) {
      std::memcpy(d, s, (size_t)ml);
    } else {
      for (uint64_t j = 0; j < ml; ++j) d[j] = s[j];
    }
    out.at += (size_t)ml;
  }
  if (bs.off != 0) throw Corrupt("sequence bitstream not fully read");
  out.put(lit.data() + lit_at, lit.size() - lit_at);
}

const uint32_t MAGIC = 0xFD2FB528u;

struct Header {
  bool checksum = false;
  int64_t content_size = -1;
};

Header frame_header(Forward& in) {
  Header h;
  uint8_t d = in.byte();
  int fcs_flag = d >> 6;
  bool single = (d >> 5) & 1;
  if (d & 8) throw Corrupt("reserved bit set in the frame header");
  h.checksum = (d >> 2) & 1;
  int dict_flag = d & 3;
  if (!single) in.byte();  // window descriptor: the whole output is the window here
  static const int dict_bytes[4] = {0, 1, 2, 4};
  if (dict_flag) {
    uint64_t id = in.le(dict_bytes[dict_flag]);
    if (id != 0) throw Corrupt("frame needs a dictionary (not supported)");
  }
  static const int fcs_bytes[4] = {0, 2, 4, 8};
  int nb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_bytes[fcs_flag];
  if (nb) {
    uint64_t v = in.le(nb);
    if (nb == 2) v += 256;
    h.content_size = (int64_t)v;
  }
  return h;
}

void decode_frame(Forward& in, Output& out) {
  Header h = frame_header(in);
  FrameState fs;
  fs.frame_start = out.at;
  for (;;) {
    uint32_t bh = (uint32_t)in.le(3);
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 0) {
      out.put(in.take(size), size);
    } else if (type == 1) {
      out.fill(in.byte(), size);
    } else if (type == 2) {
      if (size > (1u << 17)) throw Corrupt("compressed block larger than 128 KiB");
      const uint8_t* b = in.take(size);
      compressed_block(fs, b, size, out);
    } else {
      throw Corrupt("reserved block type");
    }
    if (last) break;
  }
  size_t produced = out.at - fs.frame_start;
  if (h.content_size >= 0 && (uint64_t)h.content_size != produced)
    throw Corrupt("frame content size does not match its blocks");
  if (h.checksum) {
    uint32_t want = (uint32_t)in.le(4);
    uint32_t got = (uint32_t)(xxh64(out.dst + fs.frame_start, produced) & 0xFFFFFFFFu);
    if (want != got) throw Corrupt("content checksum mismatch");
  }
}

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

}  // namespace

extern "C" {

int64_t kgcn_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    Forward in(src, (size_t)n);
    int64_t total = 0;
    while (in.left() > 0) {
      uint32_t magic = (uint32_t)in.le(4);
      if (skippable(magic)) {
        in.take((size_t)in.le(4));
        continue;
      }
      if (magic != MAGIC) return -2;
      Header h = frame_header(in);
      if (h.content_size < 0) return -1;
      total += h.content_size;
      for (;;) {  // skip the blocks
        uint32_t bh = (uint32_t)in.le(3);
        int type = (bh >> 1) & 3;
        in.take(type == 1 ? 1 : (bh >> 3));
        if (bh & 1) break;
      }
      if (h.checksum) in.take(4);
    }
    return total;
  } catch (const std::exception&) {
    return -2;
  }
}

int64_t kgcn_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                             char* err, int64_t err_cap) {
  try {
    Forward in(src, (size_t)n);
    Output out{dst, (size_t)cap};
    if (n == 0) throw Corrupt("no zstd frame");
    while (in.left() > 0) {
      uint32_t magic = (uint32_t)in.le(4);
      if (skippable(magic)) {
        in.take((size_t)in.le(4));
        continue;
      }
      if (magic != MAGIC) throw Corrupt("not a zstd frame (bad magic number)");
      decode_frame(in, out);
    }
    return (int64_t)out.at;
  } catch (const std::exception& e) {
    if (err && err_cap > 0) std::snprintf(err, (size_t)err_cap, "%s", e.what());
    return -1;
  }
}

}  // extern "C"
