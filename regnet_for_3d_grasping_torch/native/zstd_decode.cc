// A Zstandard decoder (RFC 8878) for the REGNet PyTorch port, built by
// utils/zstd.py.
//
// Orbax checkpoints hold their arrays as zarr chunks compressed with zstd
// inside an OCDBT key-value store whose manifests and B+tree nodes are
// zstd frames too (utils/ocdbt.py).  The machine that runs the port has no
// zstd library, so the port decodes the format itself.  It covers the whole
// RFC apart from dictionaries:
//
//   * frames with and without a content size or a checksum (XXH64, below),
//     skippable frames, and several frames in a row;
//   * raw, RLE and compressed blocks, within the window the frame declares;
//   * literals raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
//     previous block's Huffman table), the tree given FSE-compressed or as
//     4-bit weights;
//   * sequences in predefined, RLE, FSE-compressed and repeat modes, with the
//     repeat offsets.
//
// Input that breaks the format, corrupt or truncated, raises: the C entry
// point returns -1 with a message and never a partial output.  The crc32c of
// OCDBT's containers is here too, beside the other checksum.
//
// Exposed as a C ABI for ctypes:
//   int regnet_zstd_decode(src, n, &out, &out_len, err, err_len)
//   void regnet_zstd_free(out)
//   uint64_t regnet_xxh64(src, n, seed)
//   uint32_t regnet_crc32c(src, n)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  explicit Corrupt(const std::string& what) : std::runtime_error(what) {}
};

[[noreturn]] void fail(const char* what) { throw Corrupt(what); }

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

inline uint64_t read_le64(const uint8_t* p) {
  return uint64_t(read_le32(p)) | uint64_t(read_le32(p + 4)) << 32;
}

inline int highest_bit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64

constexpr uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
                   P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
                   P5 = 0x27D4EB2F165667C5ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  return rotl(acc + input * P2, 31) * P1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xxh_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; end - p >= 8; p += 8) h = rotl(h ^ xxh_round(0, read_le64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    h = rotl(h ^ uint64_t(read_le32(p)) * P1, 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ *p * P5, 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---------------------------------------------------------------- crc32c

uint32_t crc32c(const uint8_t* p, size_t n) {
  static uint32_t table[256];
  static bool ready = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      table[i] = c;
    }
    return true;
  }();
  (void)ready;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- bit streams

// Forward little-endian bit reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n, bit = 0;
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  // bits past the end read as zeros; the caller checks `bytes_used`
  uint32_t read(int nbits) {
    uint32_t v = 0;
    for (int i = 0; i < nbits; ++i, ++bit)
      if (bit < n * 8) v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    return v;
  }
  void rewind(int nbits) { bit -= nbits; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit reader (Huffman, FSE and sequence streams): the stream is
// read from its last bit towards its first, after the padding that ends in
// the highest set bit of the last byte.  Bits read from before the start
// are zeros; `offset` then goes negative, which the callers check.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t offset;
  // 64 bits of the stream from bit `lo` on, reloaded as `offset` passes
  // below `lo` (every 50-odd bits read)
  uint64_t cache = 0;
  int64_t lo = INT64_MAX;
  BackwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {
    if (n == 0) fail("empty bit stream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bit stream without its end marker");
    offset = int64_t(n) * 8 - (8 - highest_bit(last));
  }
  // the `nbits` bits at [pos, pos + nbits), pos >= 0, nbits <= 56 (as every
  // read is)
  uint64_t bits_at(int64_t pos, int nbits) const {
    return (load(size_t(pos) >> 3) >> (pos & 7)) & ((uint64_t(1) << nbits) - 1);
  }
  uint64_t read(int nbits) {
    if (nbits == 0) return 0;
    offset -= nbits;
    if (offset >= 0) {
      if (offset < lo) {
        // the window's first byte: its 64 bits must reach offset + nbits
        int64_t start = offset + nbits - 64;
        size_t byte = start > 0 ? size_t(start + 7) >> 3 : 0;
        lo = int64_t(byte) * 8;
        cache = load(byte);
      }
      return (cache >> (offset - lo)) & ((uint64_t(1) << nbits) - 1);
    }
    int have = nbits + int(offset);
    if (have <= 0) return 0;
    return bits_at(0, have) << (-offset);
  }
  uint64_t load(size_t byte) const {
    if (n - byte >= 8) return read_le64(p + byte);
    uint64_t v = 0;
    for (size_t i = 0; byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
  }
};

// ---------------------------------------------------------------- FSE

struct FseTable {
  int accuracy = 0;
  std::vector<uint8_t> symbol, nbits;
  std::vector<uint16_t> base;
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int accuracy) {
  const int size = 1 << accuracy;
  t.accuracy = accuracy;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<uint16_t> next(nsym > 0 ? nsym : 1, 0);
  int high = size;
  for (int s = 0; s < nsym; ++s)
    if (norm[s] == -1) {
      if (high == 0) fail("FSE distribution overflows its table");
      t.symbol[--high] = uint8_t(s);
      next[s] = 1;
    }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.symbol[pos] = uint8_t(s);
      do pos = (pos + step) & mask; while (pos >= high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    uint16_t state = next[t.symbol[u]]++;
    int nb = accuracy - highest_bit(state);
    t.nbits[u] = uint8_t(nb);
    t.base[u] = uint16_t((uint32_t(state) << nb) - size);
  }
}

// Read an FSE table description at `src`; returns the bytes it took.
size_t fse_read_table(FseTable& t, const uint8_t* src, size_t n,
                      int max_accuracy, int max_symbol) {
  ForwardBits in(src, n);
  int accuracy = int(in.read(4)) + 5;
  if (accuracy > max_accuracy) fail("FSE accuracy above its maximum");
  int32_t remaining = 1 << accuracy;
  int16_t freq[256];
  int sym = 0;
  while (remaining > 0 && sym <= max_symbol) {
    int nb = highest_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(nb);
    uint32_t lower = (1u << (nb - 1)) - 1;
    uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      in.rewind(1);
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int16_t proba = int16_t(int(val) - 1);
    remaining -= proba < 0 ? -proba : proba;
    freq[sym++] = proba;
    if (proba == 0) {
      int repeat = int(in.read(2));
      for (;;) {
        for (int i = 0; i < repeat; ++i) {
          if (sym > max_symbol) fail("FSE distribution past its last symbol");
          freq[sym++] = 0;
        }
        if (repeat != 3) break;
        repeat = int(in.read(2));
      }
    }
  }
  if (remaining != 0) fail("FSE distribution does not sum to its scale");
  if (in.bytes_used() > n) fail("FSE table description truncated");
  fse_build(t, freq, sym, accuracy);
  return in.bytes_used();
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.accuracy = 0;
  t.symbol.assign(1, symbol);
  t.nbits.assign(1, 0);
  t.base.assign(1, 0);
}

// ---------------------------------------------------------------- Huffman

constexpr int kHufMaxBits = 11;

struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> symbol, nbits;
};

void huf_build(HufTable& t, const uint8_t* weights, int nsym) {
  // the last symbol's weight is implied: the weights' sum of 2^(w-1) is
  // completed to the next power of two
  uint32_t total = 0;
  for (int s = 0; s < nsym; ++s) {
    if (weights[s] > kHufMaxBits) fail("Huffman weight above its maximum");
    if (weights[s]) total += 1u << (weights[s] - 1);
  }
  if (total == 0) fail("Huffman weights all zero");
  int max_bits = highest_bit(total) + 1;
  if (max_bits > kHufMaxBits) fail("Huffman tree too deep");
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a tree");
  std::vector<uint8_t> w(weights, weights + nsym);
  w.push_back(uint8_t(highest_bit(left) + 1));
  const int n = nsym + 1;
  std::vector<uint8_t> bits(n);
  int rank_count[kHufMaxBits + 2] = {0};
  for (int s = 0; s < n; ++s) {
    bits[s] = w[s] ? uint8_t(max_bits + 1 - w[s]) : 0;
    rank_count[bits[s]]++;
  }
  const uint32_t size = 1u << max_bits;
  t.max_bits = max_bits;
  t.symbol.assign(size, 0);
  t.nbits.assign(size, 0);
  uint32_t rank_idx[kHufMaxBits + 2];
  rank_idx[max_bits] = 0;
  for (int i = max_bits; i >= 1; --i) {
    rank_idx[i - 1] = rank_idx[i] + rank_count[i] * (1u << (max_bits - i));
    if (rank_idx[i - 1] > size) fail("Huffman table overflows");
    std::memset(&t.nbits[rank_idx[i]], i, rank_idx[i - 1] - rank_idx[i]);
  }
  if (rank_idx[0] != size) fail("Huffman table does not fill");
  for (int s = 0; s < n; ++s) {
    if (!bits[s]) continue;
    uint32_t code = rank_idx[bits[s]], len = 1u << (max_bits - bits[s]);
    std::memset(&t.symbol[code], s, len);
    rank_idx[bits[s]] += len;
  }
}

// Read a Huffman tree description; returns the bytes it took.
size_t huf_read_table(HufTable& t, const uint8_t* src, size_t n) {
  if (n < 1) fail("Huffman tree description truncated");
  uint8_t header = src[0];
  uint8_t weights[256];
  int nw = 0;
  if (header >= 128) {
    nw = header - 127;
    size_t bytes = (size_t(nw) + 1) / 2;
    if (1 + bytes > n) fail("Huffman weights truncated");
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    huf_build(t, weights, nw);
    return 1 + bytes;
  }
  size_t csize = header;
  if (csize == 0 || 1 + csize > n) fail("Huffman weights truncated");
  FseTable fse;
  size_t used = fse_read_table(fse, src + 1, csize, 6, 255);
  if (used >= csize) fail("Huffman weights without a bit stream");
  BackwardBits in(src + 1 + used, csize - used);
  uint32_t s1 = uint32_t(in.read(fse.accuracy));
  uint32_t s2 = uint32_t(in.read(fse.accuracy));
  // two interleaved states over one stream, until the stream overflows
  for (;;) {
    if (nw >= 255) fail("too many Huffman weights");
    weights[nw++] = fse.symbol[s1];
    s1 = fse.base[s1] + uint32_t(in.read(fse.nbits[s1]));
    if (in.offset < 0) {
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = fse.symbol[s2];
      break;
    }
    if (nw >= 255) fail("too many Huffman weights");
    weights[nw++] = fse.symbol[s2];
    s2 = fse.base[s2] + uint32_t(in.read(fse.nbits[s2]));
    if (in.offset < 0) {
      if (nw >= 255) fail("too many Huffman weights");
      weights[nw++] = fse.symbol[s1];
      break;
    }
  }
  huf_build(t, weights, nw);
  return 1 + csize;
}

// One Huffman stream.  The decoder's state is the max_bits bits of the
// stream below the read position `pos`: a symbol's code is their top bits
// and it consumes its length.  At the end the position must be the
// stream's start exactly (the last state's lookahead lies before it).
struct HufStream {
  const uint8_t* src;
  size_t n;
  int64_t pos;
  HufStream(const uint8_t* s, size_t n_) : src(s), n(n_) {
    pos = BackwardBits(s, n_).offset;
  }
  // the 8 bytes that end with the one holding bit pos - 1 lie inside the
  // stream (and hold the state: max_bits <= 11 < 57)
  bool fast() const { return pos >= 64; }
  uint8_t next_fast(const HufTable& t) {
    int64_t first = ((pos + 7) >> 3) - 8;
    uint32_t v = uint32_t(read_le64(src + first) >>
                          (pos - t.max_bits - first * 8)) &
                 ((1u << t.max_bits) - 1);
    pos -= t.nbits[v];
    return t.symbol[v];
  }
  // bits before the stream's start read as zeros
  uint8_t next(const HufTable& t) {
    if (fast()) return next_fast(t);
    const int mb = t.max_bits;
    uint32_t v = 0;
    for (int k = 0; k < mb; ++k) {
      int64_t b = pos - mb + k;
      if (b >= 0 && size_t(b >> 3) < n) v |= uint32_t((src[b >> 3] >> (b & 7)) & 1) << k;
    }
    pos -= t.nbits[v];
    if (pos < -mb) fail("Huffman stream overread");
    return t.symbol[v];
  }
  void finish() const {
    if (pos != 0) fail("Huffman stream not consumed exactly");
  }
};

void huf_stream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* out,
                size_t count) {
  HufStream s(src, n);
  for (size_t i = 0; i < count; ++i) out[i] = s.next(t);
  s.finish();
}

// Four streams of `seg`, `seg`, `seg` and `last` symbols, decoded in
// lockstep while all four are away from their ends (four independent
// chains of loads), then each to its end.
void huf_4streams(const HufTable& t, const uint8_t* const src[4],
                  const size_t n[4], uint8_t* out, size_t seg, size_t last) {
  HufStream s[4] = {{src[0], n[0]}, {src[1], n[1]}, {src[2], n[2]},
                    {src[3], n[3]}};
  const size_t count[4] = {seg, seg, seg, last};
  // the lockstep loop keeps everything in locals: a store through a
  // uint8_t pointer may alias any member, which would reload them
  const uint8_t *sym = t.symbol.data(), *len = t.nbits.data();
  const uint8_t *q0 = src[0], *q1 = src[1], *q2 = src[2], *q3 = src[3];
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  int64_t p0 = s[0].pos, p1 = s[1].pos, p2 = s[2].pos, p3 = s[3].pos;
  size_t i = 0;
  for (; i < last && p0 >= 64 && p1 >= 64 && p2 >= 64 && p3 >= 64; ++i) {
    int64_t f0 = ((p0 + 7) >> 3) - 8, f1 = ((p1 + 7) >> 3) - 8,
            f2 = ((p2 + 7) >> 3) - 8, f3 = ((p3 + 7) >> 3) - 8;
    uint32_t v0 = uint32_t(read_le64(q0 + f0) >> (p0 - mb - f0 * 8)) & mask;
    uint32_t v1 = uint32_t(read_le64(q1 + f1) >> (p1 - mb - f1 * 8)) & mask;
    uint32_t v2 = uint32_t(read_le64(q2 + f2) >> (p2 - mb - f2 * 8)) & mask;
    uint32_t v3 = uint32_t(read_le64(q3 + f3) >> (p3 - mb - f3 * 8)) & mask;
    p0 -= len[v0];
    p1 -= len[v1];
    p2 -= len[v2];
    p3 -= len[v3];
    out[i] = sym[v0];
    out[seg + i] = sym[v1];
    out[2 * seg + i] = sym[v2];
    out[3 * seg + i] = sym[v3];
  }
  s[0].pos = p0;
  s[1].pos = p1;
  s[2].pos = p2;
  s[3].pos = p3;
  for (int k = 0; k < 4; ++k) {
    for (size_t j = i; j < count[k]; ++j) out[k * seg + j] = s[k].next(t);
    s[k].finish();
  }
}

// ---------------------------------------------------------------- sequences

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,   9,   10,  11,   12,   13,   14,   15,   16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,    20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,    41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// What persists between the blocks of one frame.
struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
  uint64_t window = 0;
};

// Pick the table of one sequence field from its mode; returns bytes taken.
size_t seq_table(FseTable& t, bool& have, int mode, const uint8_t* src, size_t n,
                 const int16_t* dflt, int dflt_n, int dflt_acc, int max_acc,
                 int max_symbol) {
  switch (mode) {
    case 0:
      fse_build(t, dflt, dflt_n, dflt_acc);
      have = true;
      return 0;
    case 1:
      if (n < 1) fail("RLE sequence table truncated");
      if (src[0] > max_symbol) fail("RLE sequence symbol out of range");
      fse_rle(t, src[0]);
      have = true;
      return 1;
    case 2: {
      size_t used = fse_read_table(t, src, n, max_acc, max_symbol);
      have = true;
      return used;
    }
    default:
      if (!have) fail("repeat mode without an earlier table");
      return 0;
  }
}

// ---------------------------------------------------------------- blocks

void decode_literals(FrameState& fs, const uint8_t* src, size_t n,
                     std::vector<uint8_t>& lit, size_t& used) {
  if (n < 1) fail("literals section truncated");
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t regen, hdr;
    if ((fmt & 1) == 0) {
      regen = src[0] >> 3;
      hdr = 1;
    } else if (fmt == 1) {
      if (n < 2) fail("literals header truncated");
      regen = (src[0] >> 4) | (size_t(src[1]) << 4);
      hdr = 2;
    } else {
      if (n < 3) fail("literals header truncated");
      regen = (src[0] >> 4) | (size_t(src[1]) << 4) | (size_t(src[2]) << 12);
      hdr = 3;
    }
    if (regen > (1u << 17)) fail("literals above the block maximum");
    if (type == 0) {
      if (hdr + regen > n) fail("raw literals truncated");
      lit.assign(src + hdr, src + hdr + regen);
      used = hdr + regen;
    } else {
      if (hdr + 1 > n) fail("RLE literals truncated");
      lit.assign(regen, src[hdr]);
      used = hdr + 1;
    }
    return;
  }
  size_t regen, csize, hdr;
  int streams = fmt == 0 ? 1 : 4;
  if (fmt < 2) {
    if (n < 3) fail("literals header truncated");
    uint32_t h = src[0] | uint32_t(src[1]) << 8 | uint32_t(src[2]) << 16;
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
    hdr = 3;
  } else if (fmt == 2) {
    if (n < 4) fail("literals header truncated");
    uint32_t h = read_le32(src);
    regen = (h >> 4) & 0x3FFF;
    csize = h >> 18;
    hdr = 4;
  } else {
    if (n < 5) fail("literals header truncated");
    uint64_t h = read_le32(src) | uint64_t(src[4]) << 32;
    regen = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
    hdr = 5;
  }
  if (regen > (1u << 17)) fail("literals above the block maximum");
  if (hdr + csize > n) fail("compressed literals truncated");
  const uint8_t* p = src + hdr;
  size_t left = csize;
  if (type == 2) {
    size_t t = huf_read_table(fs.huf, p, left);
    fs.have_huf = true;
    p += t;
    left -= t;
  } else if (!fs.have_huf) {
    fail("treeless literals without an earlier Huffman table");
  }
  lit.resize(regen);
  if (streams == 1) {
    huf_stream(fs.huf, p, left, lit.data(), regen);
  } else {
    if (left < 6) fail("literals jump table truncated");
    size_t s1 = p[0] | size_t(p[1]) << 8, s2 = p[2] | size_t(p[3]) << 8,
           s3 = p[4] | size_t(p[5]) << 8;
    if (6 + s1 + s2 + s3 > left) fail("literals streams truncated");
    size_t s4 = left - 6 - s1 - s2 - s3;
    size_t seg = (regen + 3) / 4;
    if (3 * seg > regen) fail("too few literals for four streams");
    const uint8_t* q = p + 6;
    const uint8_t* src4[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
    const size_t n4[4] = {s1, s2, s3, s4};
    huf_4streams(fs.huf, src4, n4, lit.data(), seg, regen - 3 * seg);
  }
  used = hdr + csize;
}

void decode_block(FrameState& fs, const uint8_t* src, size_t n,
                  std::vector<uint8_t>& out, size_t frame_start,
                  size_t block_max) {
  std::vector<uint8_t> lit;
  size_t used;
  decode_literals(fs, src, n, lit, used);
  const uint8_t* p = src + used;
  size_t left = n - used;
  if (left < 1) fail("sequences section truncated");
  size_t nseq;
  if (p[0] < 128) {
    nseq = p[0];
    p += 1;
    left -= 1;
  } else if (p[0] < 255) {
    if (left < 2) fail("sequences header truncated");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    p += 2;
    left -= 2;
  } else {
    if (left < 3) fail("sequences header truncated");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
    left -= 3;
  }
  const size_t block_start = out.size();
  if (nseq == 0) {
    if (left != 0) fail("bytes after a block's literals");
    out.insert(out.end(), lit.begin(), lit.end());
    if (out.size() - block_start > block_max) fail("block above its maximum");
    return;
  }
  if (left < 1) fail("sequence modes truncated");
  uint8_t modes = p[0];
  if (modes & 3) fail("reserved bits of the sequence modes set");
  p += 1;
  left -= 1;
  size_t t;
  t = seq_table(fs.ll, fs.have_ll, modes >> 6, p, left, kLLDefault, 36, 6, 9, 35);
  p += t;
  left -= t;
  t = seq_table(fs.of, fs.have_of, (modes >> 4) & 3, p, left, kOFDefault, 29, 5, 8,
                31);
  p += t;
  left -= t;
  t = seq_table(fs.ml, fs.have_ml, (modes >> 2) & 3, p, left, kMLDefault, 53, 6, 9,
                52);
  p += t;
  left -= t;
  BackwardBits in(p, left);
  uint32_t sll = uint32_t(in.read(fs.ll.accuracy));
  uint32_t sof = uint32_t(in.read(fs.of.accuracy));
  uint32_t sml = uint32_t(in.read(fs.ml.accuracy));
  size_t lit_pos = 0;
  for (size_t i = 0; i < nseq; ++i) {
    uint8_t of_code = fs.of.symbol[sof], ll_code = fs.ll.symbol[sll],
            ml_code = fs.ml.symbol[sml];
    if (ll_code > 35 || ml_code > 52 || of_code > 31)
      fail("sequence code out of range");
    uint64_t ofv = (uint64_t(1) << of_code) + in.read(of_code);
    uint64_t ml = kMLBase[ml_code] + in.read(kMLBits[ml_code]);
    uint64_t ll = kLLBase[ll_code] + in.read(kLLBits[ll_code]);
    if (i + 1 < nseq) {
      sll = fs.ll.base[sll] + uint32_t(in.read(fs.ll.nbits[sll]));
      sml = fs.ml.base[sml] + uint32_t(in.read(fs.ml.nbits[sml]));
      sof = fs.of.base[sof] + uint32_t(in.read(fs.of.nbits[sof]));
    }
    if (in.offset < 0) fail("sequence stream overread");
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      fs.rep[2] = fs.rep[1];
      fs.rep[1] = fs.rep[0];
      fs.rep[0] = offset;
    } else {
      uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        offset = fs.rep[0];
      } else {
        offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
        if (idx > 1) fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      }
    }
    if (ll > lit.size() - lit_pos) fail("sequence reads past its literals");
    out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll);
    lit_pos += ll;
    size_t produced = out.size() - frame_start;
    if (offset == 0 || offset > produced) fail("match offset before the frame");
    if (offset > fs.window) fail("match offset beyond the window");
    if (out.size() - block_start + ml > block_max) fail("block above its maximum");
    size_t from = out.size() - offset;
    out.resize(out.size() + ml);
    uint8_t* o = out.data();
    size_t to = out.size() - ml;
    if (offset >= ml) {
      std::memcpy(o + to, o + from, ml);
    } else {
      for (size_t k = 0; k < ml; ++k) o[to + k] = o[from + k];
    }
  }
  if (in.offset != 0) fail("sequence stream not consumed exactly");
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
  if (out.size() - block_start > block_max) fail("block above its maximum");
}

// Decode one frame at `src`; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) fail("truncated frame magic");
  uint32_t magic = read_le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail("truncated skippable frame");
    uint64_t size = read_le32(src + 4);
    if (8 + size > n) fail("truncated skippable frame");
    return size_t(8 + size);
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
  if (n < 5) fail("truncated frame header");
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
      dict_flag = fhd & 3;
  if (fhd & 8) fail("reserved bit of the frame header set");
  size_t pos = 5;
  uint64_t window = 0;
  if (!single) {
    if (pos + 1 > n) fail("truncated frame header");
    uint8_t wd = src[pos++];
    int exponent = wd >> 3, mantissa = wd & 7;
    uint64_t base = uint64_t(1) << (10 + exponent);
    window = base + (base / 8) * mantissa;
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  int db = kDictBytes[dict_flag];
  if (pos + db > n) fail("truncated frame header");
  uint32_t dict = 0;
  for (int i = 0; i < db; ++i) dict |= uint32_t(src[pos + i]) << (8 * i);
  pos += db;
  if (dict != 0) fail("frame needs a dictionary");
  static const int kFcsBytes[4] = {0, 2, 4, 8};
  int fb = fcs_flag == 0 && single ? 1 : kFcsBytes[fcs_flag];
  bool has_fcs = fb > 0;
  uint64_t fcs = 0;
  if (pos + fb > n) fail("truncated frame header");
  for (int i = 0; i < fb; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fb == 2) fcs += 256;
  pos += fb;
  if (single) window = fcs;
  const size_t frame_start = out.size();
  if (has_fcs && fcs < (uint64_t(1) << 32)) out.reserve(frame_start + fcs);
  const size_t block_max = size_t(window < (1u << 17) ? window : (1u << 17));
  FrameState fs;
  fs.window = window;
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t bh = src[pos] | uint32_t(src[pos + 1]) << 8 | uint32_t(src[pos + 2]) << 16;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      if (pos + 1 > n) fail("truncated RLE block");
      if (size > block_max) fail("block above its maximum");
      out.insert(out.end(), size, src[pos]);
      pos += 1;
    } else {
      if (size > n - pos) fail("truncated block");
      if (type == 0) {
        if (size > block_max) fail("block above its maximum");
        out.insert(out.end(), src + pos, src + pos + size);
      } else {
        if (size > block_max) fail("compressed block above its maximum");
        decode_block(fs, src + pos, size, out, frame_start, block_max);
      }
      pos += size;
    }
    if (has_fcs && out.size() - frame_start > fcs)
      fail("frame longer than its content size");
    if (last) break;
  }
  if (has_fcs && out.size() - frame_start != fcs)
    fail("frame content size mismatch");
  if (checksum) {
    if (pos + 4 > n) fail("truncated frame checksum");
    uint32_t want = read_le32(src + pos);
    uint32_t got = uint32_t(xxh64(out.data() + frame_start, out.size() - frame_start, 0));
    if (want != got) fail("frame checksum mismatch");
    pos += 4;
  }
  return pos;
}

}  // namespace

extern "C" {

int regnet_zstd_decode(const uint8_t* src, size_t n, uint8_t** out,
                       size_t* out_len, char* err, size_t err_len) {
  *out = nullptr;
  *out_len = 0;
  try {
    if (n == 0) fail("no zstd frame in an empty input");
    std::vector<uint8_t> buf;
    size_t pos = 0;
    while (pos < n) pos += decode_frame(src + pos, n - pos, buf);
    uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
    if (!mem) fail("out of memory");
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_len = buf.size();
    return 0;
  } catch (const std::exception& e) {
    std::snprintf(err, err_len, "%s", e.what());
    return -1;
  }
}

void regnet_zstd_free(uint8_t* p) { std::free(p); }

uint64_t regnet_xxh64(const uint8_t* src, size_t n, uint64_t seed) {
  return xxh64(src, n, seed);
}

uint32_t regnet_crc32c(const uint8_t* src, size_t n) { return crc32c(src, n); }

}  // extern "C"
