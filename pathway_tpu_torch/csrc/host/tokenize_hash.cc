// Batch hashing tokenizer and row-key hash of the port, on the host
// (counterparts of the reference's native/src/tokenizer.cc, bound by
// models/tokenizer.py, and native/src/serialize.cc + hash.cc, bound by
// internals/keys.py).
//
// One call tokenizes a whole ASCII batch, where the Python path pays a
// regex scan, a .lower().encode() and a hash per word.  The ids are the
// reference's, bit for bit:
//   token pattern [\w']+|[^\w\s] with \w = [A-Za-z0-9_] and \s = space,
//   \t-\r and the separator controls \x1c-\x1f (Python's \s over ASCII);
//   id = reserved + xxh3_64(token.lower()) % (vocab_size - reserved).
// The caller routes non-ASCII batches to the Python path.
//
// This file carries its own XXH3-64 (seed 0, default secret, XXH3 v0.8),
// written from models/_xxh3.py, so that no xxhash.h is needed: every
// length class (0, 1-3, 4-8, 9-16, 17-128, 129-240, > 240 bytes).  A token
// longer than the 4,096-byte scratch is lowered into a heap buffer and
// hashed in one shot, which equals the reference's streamed hash.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC (kernels/build.py, at first use).
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint64_t kP32_1 = 0x9E3779B1ULL;
constexpr uint64_t kP32_2 = 0x85EBCA77ULL;
constexpr uint64_t kP32_3 = 0xC2B2AE3DULL;
constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP64_4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP64_5 = 0x27D4EB2F165667C5ULL;
constexpr uint64_t kPMX1 = 0x165667919E3779F9ULL;
constexpr uint64_t kPMX2 = 0x9FB21C651E98DF25ULL;

constexpr size_t kSecretSize = 192;
constexpr size_t kStripe = 64;
constexpr size_t kStripesPerBlock = (kSecretSize - kStripe) / 8;  // 16
constexpr size_t kBlock = kStripe * kStripesPerBlock;              // 1024

alignas(64) const uint8_t kSecret[kSecretSize] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c,
    0xf7, 0x21, 0xad, 0x1c, 0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb,
    0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f, 0xcb, 0x79, 0xe6, 0x4e,
    0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6,
    0x81, 0x3a, 0x26, 0x4c, 0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb,
    0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3, 0x71, 0x64, 0x48, 0x97,
    0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7,
    0xc7, 0x0b, 0x4f, 0x1d, 0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31,
    0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64, 0xea, 0xc5, 0xac, 0x83,
    0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26,
    0x29, 0xd4, 0x68, 0x9e, 0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc,
    0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce, 0x45, 0xcb, 0x3a, 0x8f,
    0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

// little-endian reads (x86-64 and aarch64 hosts)
inline uint64_t r64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t r32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t mul128_fold64(uint64_t a, uint64_t b) {
  const unsigned __int128 p = (unsigned __int128)a * b;
  return (uint64_t)p ^ (uint64_t)(p >> 64);
}

inline uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  return h ^ (h >> 32);
}

inline uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= kPMX1;
  return h ^ (h >> 32);
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t rrmxmx(uint64_t h, uint64_t n) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kPMX2;
  h ^= (h >> 35) + n;
  h *= kPMX2;
  return h ^ (h >> 28);
}

inline uint64_t mix16(const uint8_t* d, const uint8_t* s) {
  return mul128_fold64(r64(d) ^ r64(s), r64(d + 8) ^ r64(s + 8));
}

inline void accumulate_512(uint64_t* acc, const uint8_t* d, const uint8_t* s) {
  for (int lane = 0; lane < 8; ++lane) {
    const uint64_t v = r64(d + 8 * lane);
    const uint64_t k = v ^ r64(s + 8 * lane);
    acc[lane ^ 1] += v;
    acc[lane] += (k & 0xFFFFFFFFULL) * (k >> 32);
  }
}

inline void scramble(uint64_t* acc) {
  const uint8_t* s = kSecret + kSecretSize - kStripe;
  for (int lane = 0; lane < 8; ++lane) {
    uint64_t a = acc[lane];
    a ^= a >> 47;
    a ^= r64(s + 8 * lane);
    acc[lane] = a * kP32_1;
  }
}

uint64_t hash_long(const uint8_t* d, size_t n) {
  uint64_t acc[8] = {kP32_3, kP64_1, kP64_2, kP64_3, kP64_4, kP32_2, kP64_5, kP32_1};
  const size_t nb_blocks = (n - 1) / kBlock;
  for (size_t blk = 0; blk < nb_blocks; ++blk) {
    for (size_t st = 0; st < kStripesPerBlock; ++st) {
      accumulate_512(acc, d + blk * kBlock + st * kStripe, kSecret + st * 8);
    }
    scramble(acc);
  }
  const size_t base = nb_blocks * kBlock;
  const size_t nb_stripes = ((n - 1) - base) / kStripe;
  for (size_t st = 0; st < nb_stripes; ++st) {
    accumulate_512(acc, d + base + st * kStripe, kSecret + st * 8);
  }
  // the last stripe, at XXH_SECRET_LASTACC_START = 7 from the secret's end
  accumulate_512(acc, d + n - kStripe, kSecret + kSecretSize - kStripe - 7);
  // merge, at XXH_SECRET_MERGEACCS_START = 11
  uint64_t result = n * kP64_1;
  for (int i = 0; i < 4; ++i) {
    result += mul128_fold64(acc[2 * i] ^ r64(kSecret + 11 + 16 * i), acc[2 * i + 1] ^ r64(kSecret + 11 + 16 * i + 8));
  }
  return avalanche(result);
}

uint64_t xxh3_64(const uint8_t* d, size_t n) {
  if (n == 0) {
    return xxh64_avalanche(r64(kSecret + 56) ^ r64(kSecret + 64));
  }
  if (n <= 3) {
    const uint32_t c1 = d[0], c2 = d[n >> 1], c3 = d[n - 1];
    const uint32_t combined = (c1 << 16) | (c2 << 24) | c3 | ((uint32_t)n << 8);
    const uint64_t bitflip = (uint64_t)(r32(kSecret) ^ r32(kSecret + 4));
    return xxh64_avalanche((uint64_t)combined ^ bitflip);
  }
  if (n <= 8) {
    const uint64_t in1 = r32(d), in2 = r32(d + n - 4);
    const uint64_t bitflip = r64(kSecret + 8) ^ r64(kSecret + 16);
    return rrmxmx((in2 + (in1 << 32)) ^ bitflip, n);
  }
  if (n <= 16) {
    const uint64_t lo = r64(d) ^ (r64(kSecret + 24) ^ r64(kSecret + 32));
    const uint64_t hi = r64(d + n - 8) ^ (r64(kSecret + 40) ^ r64(kSecret + 48));
    return avalanche(n + __builtin_bswap64(lo) + hi + mul128_fold64(lo, hi));
  }
  if (n <= 128) {
    uint64_t acc = n * kP64_1;
    if (n > 32) {
      if (n > 64) {
        if (n > 96) {
          acc += mix16(d + 48, kSecret + 96) + mix16(d + n - 64, kSecret + 112);
        }
        acc += mix16(d + 32, kSecret + 64) + mix16(d + n - 48, kSecret + 80);
      }
      acc += mix16(d + 16, kSecret + 32) + mix16(d + n - 32, kSecret + 48);
    }
    acc += mix16(d, kSecret) + mix16(d + n - 16, kSecret + 16);
    return avalanche(acc);
  }
  if (n <= 240) {
    uint64_t acc = n * kP64_1;
    for (size_t i = 0; i < 8; ++i) acc += mix16(d + 16 * i, kSecret + 16 * i);
    acc = avalanche(acc);
    // XXH3_MIDSIZE_STARTOFFSET = 3
    for (size_t i = 8; i < n / 16; ++i) acc += mix16(d + 16 * i, kSecret + 16 * (i - 8) + 3);
    // XXH3_SECRET_SIZE_MIN (136) - XXH3_MIDSIZE_LASTOFFSET (17)
    acc += mix16(d + n - 16, kSecret + 136 - 17);
    return avalanche(acc);
  }
  return hash_long(d, n);
}

inline bool is_word(uint8_t c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || (c >= '0' && c <= '9') || c == '_';
}
inline bool is_space(uint8_t c) {
  return c == ' ' || (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F);
}
inline uint8_t lower(uint8_t c) { return (c >= 'A' && c <= 'Z') ? (uint8_t)(c + 32) : c; }

// Row-key serialization: the tagged format of internals/keys.py
// _serialize_value, byte for byte, for typed columns.
enum ColType : uint8_t {
  COL_NONE = 0,
  COL_BOOL = 1,
  COL_INT64 = 2,
  COL_FLOAT64 = 3,
  COL_STR = 4,
  COL_BYTES = 5,
  COL_POINTER = 6,
};

inline int64_t cell_size(uint8_t type, const int64_t* offs, int64_t row) {
  switch (type) {
    case COL_BOOL:
      return 2;
    case COL_INT64:
    case COL_FLOAT64:
    case COL_POINTER:
      return 9;
    case COL_STR:
    case COL_BYTES:
      return 5 + (offs[row + 1] - offs[row]);
    default:  // COL_NONE
      return 1;
  }
}

inline int64_t write_cell(uint8_t type, const void* data, const int64_t* offs, int64_t row, uint8_t* out) {
  switch (type) {
    case COL_BOOL:
      out[0] = 0x01;
      out[1] = ((const uint8_t*)data)[row] ? 0x01 : 0x00;
      return 2;
    case COL_INT64:
    case COL_FLOAT64:  // the double's bits, as struct.pack("<d")
    case COL_POINTER:
      out[0] = type == COL_INT64 ? 0x02 : (type == COL_FLOAT64 ? 0x03 : 0x06);
      std::memcpy(out + 1, (const uint8_t*)data + 8 * row, 8);
      return 9;
    case COL_STR:
    case COL_BYTES: {
      const int64_t n = offs[row + 1] - offs[row];
      const uint32_t n32 = (uint32_t)n;
      out[0] = type == COL_STR ? 0x04 : 0x05;
      std::memcpy(out + 1, &n32, 4);
      std::memcpy(out + 5, (const uint8_t*)data + offs[row], (size_t)n);
      return 5 + n;
    }
    default:  // COL_NONE
      out[0] = 0x00;
      return 1;
  }
}

}  // namespace

extern "C" {

// XXH3-64 of n bytes (seed 0): the tests hold it against models/_xxh3.py.
uint64_t ptt_xxh3_64(const uint8_t* data, int64_t n) { return xxh3_64(data, (size_t)n); }

// Tokenize n_texts texts of the ASCII blob, text t in
// [offsets[t], offsets[t + 1]).  Token ids go to out_ids (room for one per
// byte of the blob suffices); text t's ids are
// [out_offsets[t], out_offsets[t + 1]).  Returns 0.
int32_t ptt_tokenize_hash(const uint8_t* blob, const int64_t* offsets, int64_t n_texts, int32_t vocab_size,
                          int32_t reserved, int32_t* out_ids, int64_t* out_offsets) {
  const uint64_t mod = (uint64_t)(vocab_size - reserved);
  uint8_t word[4096];  // lowered-token scratch
  std::vector<uint8_t> big;  // for tokens longer than the scratch
  int64_t out_n = 0;
  for (int64_t t = 0; t < n_texts; ++t) {
    out_offsets[t] = out_n;
    const uint8_t* p = blob + offsets[t];
    const uint8_t* end = blob + offsets[t + 1];
    while (p < end) {
      const uint8_t c = *p;
      if (is_word(c) || c == '\'') {
        const uint8_t* start = p;
        while (p < end && (is_word(*p) || *p == '\'')) ++p;
        const size_t n = (size_t)(p - start);
        uint8_t* buf = word;
        if (n > sizeof(word)) {
          big.resize(n);
          buf = big.data();
        }
        for (size_t i = 0; i < n; ++i) buf[i] = lower(start[i]);
        out_ids[out_n++] = (int32_t)(reserved + (xxh3_64(buf, n) % mod));
      } else if (is_space(c)) {
        ++p;
      } else {
        // one [^\w\s] character; lowering is the identity here, as .lower()
        const uint8_t lc = lower(c);
        out_ids[out_n++] = (int32_t)(reserved + (xxh3_64(&lc, 1) % mod));
        ++p;
      }
    }
  }
  out_offsets[n_texts] = out_n;
  return 0;
}

// Serialize n_rows rows of n_cols typed columns (ColType above) into out,
// row r in [row_offsets[r], row_offsets[r + 1]).  col_data[c] is the
// column's 8-byte values (uint8 for COL_BOOL), or the blob of a str/bytes
// column with col_offsets[c] its n_rows + 1 offsets; col_null[c], where
// not null, flags cells that serialize as None.  Returns the bytes needed;
// writes only when they fit in out_cap.
int64_t ptt_serialize_rows(int64_t n_rows, int32_t n_cols, const uint8_t* col_types, const void* const* col_data,
                           const int64_t* const* col_offsets, const uint8_t* const* col_null, uint8_t* out,
                           int64_t out_cap, int64_t* row_offsets) {
  int64_t total = 0;
  for (int64_t r = 0; r < n_rows; ++r)
    for (int32_t c = 0; c < n_cols; ++c)
      total += (col_null[c] && col_null[c][r]) ? 1 : cell_size(col_types[c], col_offsets[c], r);
  if (total > out_cap) return total;
  int64_t pos = 0;
  row_offsets[0] = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int32_t c = 0; c < n_cols; ++c) {
      if (col_null[c] && col_null[c][r])
        out[pos++] = 0x00;
      else
        pos += write_cell(col_types[c], col_data[c], col_offsets[c], r, out + pos);
    }
    row_offsets[r + 1] = pos;
  }
  return total;
}

// XXH3-64 of each row slice [row_offsets[r], row_offsets[r + 1]) of buf.
void ptt_hash_rows(const uint8_t* buf, const int64_t* row_offsets, int64_t n_rows, uint64_t* out) {
  for (int64_t r = 0; r < n_rows; ++r)
    out[r] = xxh3_64(buf + row_offsets[r], (size_t)(row_offsets[r + 1] - row_offsets[r]));
}

}  // extern "C"
