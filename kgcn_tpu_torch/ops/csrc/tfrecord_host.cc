// Host TFRecord reader of the port (kgcn_tpu_torch/data/tfrecord.py), plain
// C++, no CUDA: the host C++ compiler builds it into its own library
// (ops/_build.py), which the reader loads on any machine.  The port's copy
// of kgcn_tpu/native/tfrecord.cpp: record framing, CRC32C verification and
// a tf.train.Example wire-format walk specialised to numeric features
// (FloatList / Int64List), parallel over records, with every entry point
// named kgcn_*.  Beside them, kgcn_crc32c gives the writer its checksums.
//
// Wire format walked (no protobuf dependency):
//   Example      { 1: Features }
//   Features     { 1: repeated map entry }
//   map entry    { 1: key (bytes), 2: Feature }
//   Feature      { 1: BytesList, 2: FloatList, 3: Int64List }
//   FloatList    { 1: repeated/packed float }
//   Int64List    { 1: repeated/packed varint }

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#ifdef __SSE4_2__
#include <nmmintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- crc32c --
uint32_t crc32c_table[256];
bool crc_table_init_done = false;

void init_crc_table() {
  if (crc_table_init_done) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[i] = c;
  }
  crc_table_init_done = true;
}

uint32_t crc32c(const uint8_t* data, int64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
#ifdef __SSE4_2__
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, data, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, v);
    data += 8;
    len -= 8;
  }
  while (len > 0) {
    crc = _mm_crc32_u8(crc, *data++);
    --len;
  }
#else
  init_crc_table();
  for (int64_t i = 0; i < len; ++i)
    crc = crc32c_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
#endif
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc(const uint8_t* data, int64_t len) {
  uint32_t c = crc32c(data, len);
  return ((c >> 15) | (c << 17)) + 0xa282ead8u;
}

// ------------------------------------------------------------ proto walk --
struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t result = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      result |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return result;
      shift += 7;
      if (shift >= 64) break;
    }
    ok = false;
    return 0;
  }
};

struct Field {
  uint32_t number;
  uint32_t wire;
  const uint8_t* data;  // wire 2: payload start; wire 1/5: fixed bytes
  uint64_t len;         // wire 2: payload length
  uint64_t value;       // wire 0: varint value
};

// Read one field; returns false at end-of-message or parse error.
bool next_field(Cursor& c, Field& f) {
  if (c.p >= c.end) return false;
  uint64_t tag = c.varint();
  if (!c.ok) return false;
  f.number = (uint32_t)(tag >> 3);
  f.wire = (uint32_t)(tag & 7);
  switch (f.wire) {
    case 0:
      f.value = c.varint();
      return c.ok;
    case 2:
      f.len = c.varint();
      // compare against the remaining byte count — `c.p + f.len` would
      // overflow the pointer for adversarial varint lengths near 2^64;
      // a failed bounds check is MALFORMED input, not end-of-message
      if (!c.ok || f.len > (uint64_t)(c.end - c.p)) {
        c.ok = false;
        return false;
      }
      f.data = c.p;
      c.p += f.len;
      return true;
    case 5:
      if (c.p + 4 > c.end) { c.ok = false; return false; }
      f.data = c.p;
      c.p += 4;
      return true;
    case 1:
      if (c.p + 8 > c.end) { c.ok = false; return false; }
      f.data = c.p;
      c.p += 8;
      return true;
    default:
      c.ok = false;
      return false;
  }
}

// Key table shared by count/extract.
struct Keys {
  std::vector<const char*> name;
  std::vector<int32_t> len;
  int32_t n;

  Keys(const char* keys, const int32_t* key_lens, int32_t n_keys) : n(n_keys) {
    const char* p = keys;
    for (int32_t k = 0; k < n_keys; ++k) {
      name.push_back(p);
      len.push_back(key_lens[k]);
      p += key_lens[k];
    }
  }

  int32_t find(const uint8_t* s, uint64_t l) const {
    for (int32_t k = 0; k < n; ++k)
      if ((uint64_t)len[k] == l && std::memcmp(name[k], s, l) == 0) return k;
    return -1;
  }
};

// Walk one Example; for each known key call sink(key_idx, list_field, values).
// list_field: 2 = FloatList payload, 3 = Int64List payload (Field of the
// inner list message).  Returns false on malformed input.
template <typename Sink>
bool walk_example(const uint8_t* payload, uint64_t len, const Keys& keys,
                  int32_t* key_types, Sink&& sink) {
  Cursor ex{payload, payload + len};
  Field f;
  while (next_field(ex, f)) {
    if (f.number != 1 || f.wire != 2) continue;  // Example.features
    Cursor feats{f.data, f.data + f.len};
    Field fe;
    while (next_field(feats, fe)) {
      if (fe.number != 1 || fe.wire != 2) continue;  // map entry
      Cursor entry{fe.data, fe.data + fe.len};
      Field g;
      int32_t key_idx = -1;
      const uint8_t* value_buf = nullptr;
      uint64_t value_len = 0;
      while (next_field(entry, g)) {
        if (g.number == 1 && g.wire == 2) key_idx = keys.find(g.data, g.len);
        else if (g.number == 2 && g.wire == 2) {
          value_buf = g.data;
          value_len = g.len;
        }
      }
      if (!entry.ok) return false;
      if (key_idx < 0 || value_buf == nullptr) continue;
      Cursor feat{value_buf, value_buf + value_len};
      Field lf;
      while (next_field(feat, lf)) {
        if (lf.wire != 2) continue;
        if (lf.number == 2 || lf.number == 3) {  // FloatList / Int64List
          if (key_types) key_types[key_idx] = (int32_t)lf.number;
          sink(key_idx, (int32_t)lf.number, lf.data, lf.len);
        } else if (lf.number == 1 && key_types) {
          key_types[key_idx] = 1;  // BytesList (not extracted)
        }
      }
      if (!feat.ok) return false;
    }
    if (!feats.ok) return false;
  }
  return ex.ok;
}

int64_t count_list_elems(int32_t list_field, const uint8_t* buf,
                         uint64_t len) {
  Cursor c{buf, buf + len};
  Field f;
  int64_t count = 0;
  while (next_field(c, f)) {
    if (f.number != 1) continue;
    if (list_field == 2) {  // floats
      if (f.wire == 2) count += (int64_t)(f.len / 4);
      else if (f.wire == 5) count += 1;
    } else {  // int64 varints
      if (f.wire == 2) {
        Cursor inner{f.data, f.data + f.len};
        while (inner.p < inner.end) {
          inner.varint();
          if (!inner.ok) break;
          ++count;
        }
      } else if (f.wire == 0) {
        count += 1;
      }
    }
  }
  return count;
}

struct Record {
  const uint8_t* payload;
  int64_t len;
};

// Framing scan; fills records, returns count or negative error.
int64_t scan_frames(const uint8_t* buf, int64_t len, int verify_crc,
                    std::vector<Record>* records) {
  int64_t pos = 0;
  int64_t count = 0;
  while (pos < len) {
    if (pos + 12 > len) return -2;  // truncated header
    uint64_t rec_len;
    std::memcpy(&rec_len, buf + pos, 8);
    if (verify_crc) {
      uint32_t want;
      std::memcpy(&want, buf + pos + 8, 4);
      if (masked_crc(buf + pos, 8) != want) return -3;  // header CRC
    }
    // unsigned remaining-bytes comparison: casting rec_len to int64 and
    // adding would overflow for adversarial 8-byte length fields
    if (rec_len > (uint64_t)(len - pos - 12) ||
        (uint64_t)(len - pos - 12) - rec_len < 4)
      return -2;
    if (verify_crc) {
      uint32_t want;
      std::memcpy(&want, buf + pos + 12 + rec_len, 4);
      if (masked_crc(buf + pos + 12, (int64_t)rec_len) != want)
        return -4;  // payload CRC
    }
    if (records) records->push_back({buf + pos + 12, (int64_t)rec_len});
    pos += 12 + (int64_t)rec_len + 4;
    ++count;
  }
  return count;
}

void parallel_over(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = (int64_t)(hw ? hw : 4);
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// CRC32C (Castagnoli) of len bytes.
uint32_t kgcn_crc32c(const uint8_t* data, int64_t len) {
  return crc32c(data, len);
}

// Number of records in a framed TFRecord buffer (CRC optionally verified).
// Negative return = malformed (-2 truncation, -3/-4 CRC mismatch).
int64_t kgcn_tfrecord_num_records(const uint8_t* buf, int64_t len,
                             int verify_crc) {
  return scan_frames(buf, len, verify_crc, nullptr);
}

// Per-record per-key element counts.
//   keys/key_lens/n_keys: concatenated key names
//   key_types  out [n_keys]: 0 unseen, 1 bytes, 2 float, 3 int64
//   counts     out [n_records * n_keys]
// Returns n_records, or negative on malformed input.
int64_t kgcn_tfrecord_count(const uint8_t* buf, int64_t len, int verify_crc,
                       const char* keys, const int32_t* key_lens,
                       int32_t n_keys, int32_t* key_types, int64_t* counts) {
  std::vector<Record> records;
  int64_t n = scan_frames(buf, len, verify_crc, &records);
  if (n < 0) return n;
  Keys kt(keys, key_lens, n_keys);
  std::memset(key_types, 0, sizeof(int32_t) * n_keys);
  std::memset(counts, 0, sizeof(int64_t) * n * n_keys);
  std::vector<int32_t> errors((size_t)n, 0);
  // key_types: per-key final value is identical across records; racy writes
  // of the same value are benign but keep one canonical pass on thread 0's
  // first record for determinism, then let every thread write.
  parallel_over(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      bool ok = walk_example(
          records[i].payload, (uint64_t)records[i].len, kt, key_types,
          [&](int32_t k, int32_t list_field, const uint8_t* b, uint64_t l) {
            counts[i * n_keys + k] += count_list_elems(list_field, b, l);
          });
      if (!ok) errors[i] = 1;
    }
  });
  for (int64_t i = 0; i < n; ++i)
    if (errors[i]) return -5;  // malformed Example proto
  return n;
}

// Extract values.  offsets [n_keys * (n_records+1)]: prefix sums of counts
// (computed by the caller from tfrecord_count); out_data[k] points at a
// float32 buffer (key_types[k]==2) or int64 buffer (==3) of size
// offsets[k][n_records].  Returns 0, or negative on malformed input.
int64_t kgcn_tfrecord_extract(const uint8_t* buf, int64_t len, const char* keys,
                         const int32_t* key_lens, int32_t n_keys,
                         const int32_t* key_types, const int64_t* offsets,
                         void** out_data) {
  std::vector<Record> records;
  int64_t n = scan_frames(buf, len, 0, &records);
  if (n < 0) return n;
  Keys kt(keys, key_lens, n_keys);
  std::vector<int32_t> errors((size_t)n, 0);
  parallel_over(n, [&](int64_t lo, int64_t hi) {
    std::vector<int64_t> cursor(n_keys);
    for (int64_t i = lo; i < hi; ++i) {
      for (int32_t k = 0; k < n_keys; ++k)
        cursor[k] = offsets[k * (n + 1) + i];
      bool ok = walk_example(
          records[i].payload, (uint64_t)records[i].len, kt, nullptr,
          [&](int32_t k, int32_t list_field, const uint8_t* b, uint64_t l) {
            if (key_types[k] == 2 && list_field == 2) {
              float* out = (float*)out_data[k] + cursor[k];
              Cursor c{b, b + l};
              Field f;
              while (next_field(c, f)) {
                if (f.number != 1) continue;
                if (f.wire == 2) {
                  std::memcpy(out, f.data, f.len & ~(uint64_t)3);
                  out += f.len / 4;
                } else if (f.wire == 5) {
                  std::memcpy(out, f.data, 4);
                  out += 1;
                }
              }
              cursor[k] = out - (float*)out_data[k];
            } else if (key_types[k] == 3 && list_field == 3) {
              int64_t* out = (int64_t*)out_data[k] + cursor[k];
              Cursor c{b, b + l};
              Field f;
              while (next_field(c, f)) {
                if (f.number != 1) continue;
                if (f.wire == 2) {
                  Cursor inner{f.data, f.data + f.len};
                  while (inner.p < inner.end) {
                    uint64_t v = inner.varint();
                    if (!inner.ok) break;
                    *out++ = (int64_t)v;
                  }
                } else if (f.wire == 0) {
                  *out++ = (int64_t)f.value;
                }
              }
              cursor[k] = out - (int64_t*)out_data[k];
            }
          });
      if (!ok) errors[i] = 1;
    }
  });
  for (int64_t i = 0; i < n; ++i)
    if (errors[i]) return -5;
  return 0;
}

}  // extern "C"
