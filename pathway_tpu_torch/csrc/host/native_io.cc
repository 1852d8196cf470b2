// The port's native I/O runtime: the CSV scanner, the typed cell parsers,
// CRC-32 and snapshot frame scanning, and shard routing (counterpart of
// native/src/csv.cc, parse.cc, snapshot.cc and shard.cc of the JAX
// package, with the same C ABI under the ptt_ prefix).
//
// Differences from that library:
//  - a blank line ending in a bare '\r' is skipped like one ending in '\n'
//    or "\r\n" (a zero-cell row), as Python's csv module skips it; the
//    other library reads it as a row of one empty cell;
//  - CRC-32 (zlib's polynomial, so frames stay byte-identical) folds 64
//    bytes per step with carry-less multiplies where the CPU has PCLMULQDQ,
//    and runs slicing-by-8 elsewhere and on the tail, instead of a table
//    lookup per byte.
//
// Built with g++ at first use by pathway_tpu_torch/kernels/build.py
// (build_host("native_io")) and bound by kernels/host.py.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------- CSV

// One state machine over a sink, run twice: count, then fill.
struct CountSink {
  int64_t rows = 0;
  int64_t cells = 0;
  inline void cell(int64_t, int64_t, bool) { ++cells; }
  inline void row_end() { ++rows; }
};

struct FillSink {
  int64_t* row_cell_start;
  int64_t* cell_off;
  int64_t* cell_len;
  uint8_t* cell_quoted;
  int64_t rows = 0;
  int64_t cells = 0;
  inline void cell(int64_t off, int64_t len, bool quoted) {
    cell_off[cells] = off;
    cell_len[cells] = len;
    cell_quoted[cells] = quoted ? 1 : 0;
    ++cells;
  }
  inline void row_end() { row_cell_start[++rows] = cells; }
};

template <typename Sink>
void scan(const uint8_t* buf, int64_t len, uint8_t delim, uint8_t quote, Sink& sink) {
  bool ends[256] = {};  // the bytes that end an unquoted cell: one load per byte
  ends[delim] = ends['\n'] = ends['\r'] = true;
  auto ends_cell = [&ends](uint8_t c) { return ends[c]; };
  int64_t i = 0;
  while (i < len) {
    // a blank line ("\n", "\r\n" or a bare "\r") is a zero-cell row
    if (buf[i] == '\n') {
      sink.row_end();
      ++i;
      continue;
    }
    if (buf[i] == '\r') {
      sink.row_end();
      i += (i + 1 < len && buf[i + 1] == '\n') ? 2 : 1;
      continue;
    }
    bool row_open = true;
    while (row_open) {
      if (i < len && buf[i] == quote) {
        // quoted cell: the extent excludes the opening quote; "" stays in
        // it (flagged for unescape).  Text after the closing quote up to
        // the delimiter is kept verbatim, as Python's csv module keeps it
        // ('"Smith" Jr.' -> 'Smith Jr.'): such a cell spans body, closing
        // quote and tail, and unescape copies verbatim after the lone quote.
        int64_t start = ++i;
        while (i < len) {
          if (buf[i] == quote) {
            if (i + 1 < len && buf[i + 1] == quote) {
              i += 2;
              continue;
            }
            break;
          }
          ++i;
        }
        int64_t body_end = i;
        if (i < len) ++i;  // the closing quote
        int64_t tail_start = i;
        while (i < len && !ends_cell(buf[i])) ++i;
        sink.cell(start, (i == tail_start ? body_end : i) - start, true);
      } else {
        int64_t start = i;
        while (i < len && !ends_cell(buf[i])) ++i;
        sink.cell(start, i - start, false);
      }
      if (i >= len) {
        sink.row_end();
        row_open = false;
      } else if (buf[i] == delim) {
        ++i;
        if (i >= len) {  // a delimiter at the end of the buffer: a last empty cell
          sink.cell(len, 0, false);
          sink.row_end();
          row_open = false;
        }
      } else {  // '\n', "\r\n" or a bare '\r'
        i += (buf[i] == '\r' && i + 1 < len && buf[i + 1] == '\n') ? 2 : 1;
        sink.row_end();
        row_open = false;
      }
    }
  }
}

// ---------------------------------------------------------------- typed parse

inline void trim(const uint8_t*& p, int64_t& n) {
  while (n > 0 && (*p == ' ' || *p == '\t')) ++p, --n;
  while (n > 0 && (p[n - 1] == ' ' || p[n - 1] == '\t')) --n;
}

inline bool parse_i64(const uint8_t* p, int64_t n, int64_t* out) {
  trim(p, n);
  if (n <= 0) return false;
  bool neg = false;
  if (*p == '+' || *p == '-') {
    neg = *p == '-';
    ++p;
    --n;
    if (n == 0) return false;
  }
  uint64_t acc = 0;
  const uint64_t limit = neg ? 0x8000000000000000ULL : 0x7FFFFFFFFFFFFFFFULL;
  for (int64_t i = 0; i < n; ++i) {
    uint8_t c = p[i];
    if (c < '0' || c > '9') return false;
    uint64_t d = c - '0';
    if (acc > (limit - d) / 10) return false;  // overflow
    acc = acc * 10 + d;
  }
  *out = neg ? (int64_t)(0 - acc) : (int64_t)acc;
  return true;
}

// strtod over the whole trimmed cell: decimal and hexadecimal floats,
// inf / infinity / nan / nan(chars), any case; leading whitespace that
// strtod skips is skipped.
inline bool parse_f64(const uint8_t* p, int64_t n, double* out) {
  trim(p, n);
  if (n <= 0 || n > 510) return false;
  char tmp[512];
  std::memcpy(tmp, p, n);
  tmp[n] = '\0';
  char* end = nullptr;
  double v = std::strtod(tmp, &end);
  if (end != tmp + n) return false;
  *out = v;
  return true;
}

// ---------------------------------------------------------------- CRC-32

struct Crc32Tables {
  uint32_t t[8][256];
  Crc32Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; ++k)
      for (uint32_t i = 0; i < 256; ++i) t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
  }
};
const Crc32Tables kCrc;

// Slicing-by-8 over the inverted state ``c`` (little-endian hosts).
uint32_t crc_slice8(const uint8_t* p, int64_t n, uint32_t c) {
  const auto& t = kCrc.t;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c;
}

#if defined(__x86_64__)
// Carry-less-multiply folding over the inverted state ``c``; ``n`` is at
// least 64 and a multiple of 16.  The constants are the bit-reflected
// x^k mod P(x) of the IEEE polynomial and its Barrett pair (Gopal et al.,
// "Fast CRC Computation for Generic Polynomials Using PCLMULQDQ
// Instruction", Intel, 2009).
__attribute__((target("pclmul,sse4.1"))) uint32_t crc_pclmul(const uint8_t* p, int64_t n, uint32_t c) {
  alignas(16) static const uint64_t k1k2[] = {0x0154442bd4ULL, 0x01c6e41596ULL};
  alignas(16) static const uint64_t k3k4[] = {0x01751997d0ULL, 0x00ccaa009eULL};
  alignas(16) static const uint64_t k5k0[] = {0x0163cd6124ULL, 0x0000000000ULL};
  alignas(16) static const uint64_t poly[] = {0x01db710641ULL, 0x01f7011641ULL};
  __m128i x0, x1, x2, x3, x4, x5, x6, x7, x8;

  x1 = _mm_loadu_si128((const __m128i*)(p + 0x00));
  x2 = _mm_loadu_si128((const __m128i*)(p + 0x10));
  x3 = _mm_loadu_si128((const __m128i*)(p + 0x20));
  x4 = _mm_loadu_si128((const __m128i*)(p + 0x30));
  x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)c));
  x0 = _mm_load_si128((const __m128i*)k1k2);
  p += 64;
  n -= 64;
  while (n >= 64) {  // four lanes of 16 bytes, folded 64 bytes forward
    x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
    x6 = _mm_clmulepi64_si128(x2, x0, 0x00);
    x7 = _mm_clmulepi64_si128(x3, x0, 0x00);
    x8 = _mm_clmulepi64_si128(x4, x0, 0x00);
    x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
    x2 = _mm_clmulepi64_si128(x2, x0, 0x11);
    x3 = _mm_clmulepi64_si128(x3, x0, 0x11);
    x4 = _mm_clmulepi64_si128(x4, x0, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, x5), _mm_loadu_si128((const __m128i*)(p + 0x00)));
    x2 = _mm_xor_si128(_mm_xor_si128(x2, x6), _mm_loadu_si128((const __m128i*)(p + 0x10)));
    x3 = _mm_xor_si128(_mm_xor_si128(x3, x7), _mm_loadu_si128((const __m128i*)(p + 0x20)));
    x4 = _mm_xor_si128(_mm_xor_si128(x4, x8), _mm_loadu_si128((const __m128i*)(p + 0x30)));
    p += 64;
    n -= 64;
  }
  // the four lanes into one
  x0 = _mm_load_si128((const __m128i*)k3k4);
  const __m128i lanes[3] = {x2, x3, x4};
  for (const __m128i& next : lanes) {
    x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
    x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, next), x5);
  }
  while (n >= 16) {  // the rest, 16 bytes at a time
    x5 = _mm_clmulepi64_si128(x1, x0, 0x00);
    x1 = _mm_clmulepi64_si128(x1, x0, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(x1, _mm_loadu_si128((const __m128i*)p)), x5);
    p += 16;
    n -= 16;
  }
  // 128 bits to 64, then Barrett reduction to 32
  x2 = _mm_clmulepi64_si128(x1, x0, 0x10);
  x3 = _mm_setr_epi32(~0, 0, ~0, 0);
  x1 = _mm_xor_si128(_mm_srli_si128(x1, 8), x2);
  x0 = _mm_loadl_epi64((const __m128i*)k5k0);
  x2 = _mm_srli_si128(x1, 4);
  x1 = _mm_and_si128(x1, x3);
  x1 = _mm_xor_si128(_mm_clmulepi64_si128(x1, x0, 0x00), x2);
  x0 = _mm_load_si128((const __m128i*)poly);
  x2 = _mm_and_si128(x1, x3);
  x2 = _mm_clmulepi64_si128(x2, x0, 0x10);
  x2 = _mm_and_si128(x2, x3);
  x2 = _mm_clmulepi64_si128(x2, x0, 0x00);
  x1 = _mm_xor_si128(x1, x2);
  return (uint32_t)_mm_extract_epi32(x1, 1);
}

const bool kHavePclmul = __builtin_cpu_supports("pclmul") && __builtin_cpu_supports("sse4.1");
#endif

constexpr int64_t kParallelBytes = 8 << 20;  // frame_scan's CRCs below this run on one thread
constexpr int64_t kMaxThreads = 8;

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

// Pass 1 of the CSV scan: the row and cell counts.  Returns 0, or -1 on a
// null buffer of positive length.
int32_t ptt_csv_count(const uint8_t* buf, int64_t len, uint8_t delim, uint8_t quote, int64_t* n_rows,
                      int64_t* n_cells) {
  if (!buf && len > 0) return -1;
  CountSink sink;
  scan(buf, len, delim, quote, sink);
  *n_rows = sink.rows;
  *n_cells = sink.cells;
  return 0;
}

// Pass 2: row_cell_start[n_rows + 1] (row r's cells are
// [row_cell_start[r], row_cell_start[r + 1])), each cell's byte extent
// (without the opening quote of a quoted cell) and its quoted flag.
int32_t ptt_csv_scan(const uint8_t* buf, int64_t len, uint8_t delim, uint8_t quote, int64_t* row_cell_start,
                     int64_t* cell_off, int64_t* cell_len, uint8_t* cell_quoted) {
  if (!buf && len > 0) return -1;
  FillSink sink{row_cell_start, cell_off, cell_len, cell_quoted};
  row_cell_start[0] = 0;
  scan(buf, len, delim, quote, sink);
  return 0;
}

// A quoted cell's extent unescaped into dst (room for len bytes): "" -> ",
// the lone closing quote dropped and the tail after it copied verbatim.
// Returns the bytes written.
int64_t ptt_csv_unescape(const uint8_t* src, int64_t len, uint8_t quote, uint8_t* dst) {
  int64_t o = 0;
  bool in_quotes = true;
  for (int64_t i = 0; i < len; ++i) {
    if (in_quotes && src[i] == quote) {
      if (i + 1 < len && src[i + 1] == quote) {
        dst[o++] = quote;
        ++i;
      } else {
        in_quotes = false;
      }
    } else {
      dst[o++] = src[i];
    }
  }
  return o;
}

// n cells (off[i], len[i]) of buf parsed; ok[i] = 0 where a cell is not a
// number (out[i] is then 0, or NaN for floats).
void ptt_parse_int64(const uint8_t* buf, const int64_t* off, const int64_t* len, int64_t n, int64_t* out,
                     uint8_t* ok) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = 0;
    ok[i] = parse_i64(buf + off[i], len[i], &v) ? 1 : 0;
    out[i] = ok[i] ? v : 0;
  }
}

void ptt_parse_float64(const uint8_t* buf, const int64_t* off, const int64_t* len, int64_t n, double* out,
                       uint8_t* ok) {
  for (int64_t i = 0; i < n; ++i) {
    double v = 0.0;
    ok[i] = parse_f64(buf + off[i], len[i], &v) ? 1 : 0;
    out[i] = ok[i] ? v : std::nan("");
  }
}

// zlib.crc32(data, crc).
uint32_t ptt_crc32(const uint8_t* data, int64_t len, uint32_t crc) {
  uint32_t c = ~crc;
#if defined(__x86_64__)
  if (kHavePclmul && len >= 64) {
    const int64_t bulk = len & ~(int64_t)15;
    c = crc_pclmul(data, bulk, c);
    data += bulk;
    len -= bulk;
  }
#endif
  return ~crc_slice8(data, len, c);
}

// Walk [u32 LE payload_len][u32 LE crc32(payload)][payload] frames: the
// payload extents of up to max_frames valid frames, *consumed the bytes of
// the valid prefix (a torn or corrupt frame ends it).  Returns the count.
// The headers are walked first; the CRCs of kParallelBytes or more of
// payloads are then checked on up to kMaxThreads threads, each over a
// contiguous run of frames of about equal bytes.
int64_t ptt_frame_scan(const uint8_t* buf, int64_t len, int64_t* offsets, int64_t* lengths, int64_t max_frames,
                       int64_t* consumed) {
  std::vector<uint32_t> want;
  int64_t pos = 0, count = 0, total = 0;
  while (count < max_frames && pos + 8 <= len) {
    const uint32_t payload_len = read_u32(buf + pos);
    if (pos + 8 + (int64_t)payload_len > len) break;  // torn
    want.push_back(read_u32(buf + pos + 4));
    offsets[count] = pos + 8;
    lengths[count] = payload_len;
    ++count;
    total += payload_len;
    pos += 8 + payload_len;
  }
  std::vector<uint8_t> ok(count, 0);
  auto check = [&](int64_t lo, int64_t hi) {
    for (int64_t f = lo; f < hi; ++f) ok[f] = ptt_crc32(buf + offsets[f], lengths[f], 0) == want[f];
  };
  const int64_t threads = std::min<int64_t>({kMaxThreads, count, (int64_t)std::thread::hardware_concurrency()});
  if (total < kParallelBytes || threads < 2) {
    check(0, count);
  } else {
    std::vector<std::thread> pool;
    int64_t lo = 0, seen = 0;
    for (int64_t t = 1; t <= threads; ++t) {
      int64_t hi = lo;
      const int64_t until = total * t / threads;
      while (hi < count && (t == threads || seen < until)) seen += lengths[hi++];
      pool.emplace_back(check, lo, hi);
      lo = hi;
    }
    for (auto& th : pool) th.join();
  }
  int64_t valid = 0;
  while (valid < count && ok[valid]) ++valid;  // corruption ends the prefix
  *consumed = valid < count ? offsets[valid] - 8 : pos;
  return valid;
}

// Stable grouping of row indices by shard(key) = (key & shard_mask) %
// n_shards: counts[n_shards] and the permutation order[n].
void ptt_shard_rows(const uint64_t* keys, int64_t n, uint32_t n_shards, uint64_t shard_mask, int64_t* counts,
                    int64_t* order) {
  for (uint32_t s = 0; s < n_shards; ++s) counts[s] = 0;
  std::vector<uint32_t> shard(n);
  for (int64_t i = 0; i < n; ++i) {
    shard[i] = (uint32_t)((keys[i] & shard_mask) % n_shards);
    ++counts[shard[i]];
  }
  std::vector<int64_t> pos(n_shards, 0);
  int64_t acc = 0;
  for (uint32_t s = 0; s < n_shards; ++s) {
    pos[s] = acc;
    acc += counts[s];
  }
  for (int64_t i = 0; i < n; ++i) order[pos[shard[i]]++] = i;
}

}  // extern "C"
