// Zstandard frame decoder (RFC 8878) with a plain C interface, bound with
// ctypes by utils/zstd.py.  It reads what orbax's tensorstore writes (OCDBT
// nodes and manifests, zarr chunks) and any other dictionary-less frame:
//
//   frames:    concatenated and skippable frames, the frame header (window
//              descriptor, content size, single segment), the optional
//              XXH64 content checksum, which is verified;
//   blocks:    raw, RLE and compressed, at most min(window, 128 KiB) each;
//   literals:  raw, RLE, Huffman-compressed and treeless (the previous
//              block's table), one or four streams (the six-byte jump
//              table), weights direct or FSE-compressed;
//   sequences: literal-length, offset and match-length codes in predefined,
//              RLE, FSE-compressed and repeat modes, the three repeat
//              offsets (shifted by one after a literal length of 0).
//
// A frame that names a dictionary raises, naming its id.  Corrupt or
// truncated input raises too, never reading or writing out of bounds: every
// size, table and offset is checked before use.  `crc32c` (Castagnoli) is
// here as well; OCDBT closes each manifest and node with one.
//
// Build: g++ -O2 -fPIC -std=c++17 -shared -o libzstd_decoder.so zstd.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

inline uint32_t rd32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

inline uint64_t rd64(const uint8_t* p) { return uint64_t(rd32(p)) | uint64_t(rd32(p + 4)) << 32; }

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------------ XXH64

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* lim = end - 32;
    do {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    } while (p <= lim);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; p++) h = rotl(h ^ (uint64_t(*p) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- output

// The decoded bytes: the caller's buffer of a known size, or a vector that
// grows when the frames do not state their sizes.
struct Out {
  uint8_t* buf = nullptr;
  size_t cap = 0, len = 0;
  bool grows = false;
  std::vector<uint8_t> vec;
  void reserve(size_t extra) {
    if (len + extra <= cap) return;
    if (!grows) throw Error{"zstd frame decodes to more bytes than its stated content size"};
    size_t want = std::max(len + extra, cap * 2);
    vec.resize(want);
    buf = vec.data();
    cap = want;
  }
};

// ------------------------------------------------------- backward bitstream

// Bits read from the end of a stream towards its start (RFC 8878 4.1): the
// last byte's highest set bit marks where they begin.  Reading past the start
// gives zeros and leaves `pos` negative (the FSE decoders' end condition).
struct BackBits {
  const uint8_t* d = nullptr;
  size_t n = 0;
  int64_t pos = 0;                 // bits still to read
  void init(const uint8_t* p, size_t len) {
    if (len == 0) throw Error{"corrupt zstd block (empty bitstream)"};
    d = p;
    n = len;
    uint8_t last = p[len - 1];
    if (!last) throw Error{"corrupt zstd block (bitstream without its end marker)"};
    pos = int64_t(len) * 8 - 8 + highbit(last);
  }
  // the 64 bits of the stream ending at bit `pos` (exclusive), zeros past its start
  inline uint64_t window64(int64_t end) const {
    int64_t start = end - 64;
    if (start >= 0) {
      size_t b = size_t(start >> 3);
      uint64_t v;
      if (b + 9 <= n) {
        std::memcpy(&v, d + b, 8);
        v >>= (start & 7);
        if (start & 7) v |= uint64_t(d[b + 8]) << (64 - (start & 7));
        return v;
      }
    }
    uint64_t v = 0;
    for (int i = 63; i >= 0; i--) {
      int64_t bit = start + i;
      v <<= 1;
      if (bit >= 0 && bit < int64_t(n) * 8) v |= (d[bit >> 3] >> (bit & 7)) & 1;
    }
    return v;
  }
  inline uint32_t peek(int k) const {      // k <= 32
    if (k == 0) return 0;
    return uint32_t(window64(pos) >> (64 - k));
  }
  inline uint32_t get(int k) {
    uint32_t v = peek(k);
    pos -= k;
    return v;
  }
};

// ----------------------------------------------------------------- FSE

struct FseEntry {
  uint8_t sym, nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// RFC 8878 4.1.1: the normalized counts of a table description, read
// forward from `p`; returns the bytes used.
size_t read_ncount(const uint8_t* p, size_t n, int max_log, int max_sym, std::vector<int>& norm,
                   int& log) {
  if (n < 1) throw Error{"corrupt zstd block (truncated FSE table description)"};
  size_t bitpos = 0;
  auto bits = [&](int k) -> uint32_t {   // peek k <= 25 bits forward, zeros past the end
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      size_t b = bitpos + i;
      if ((b >> 3) < n) v |= uint32_t((p[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  };
  log = int(bits(4)) + 5;
  bitpos += 4;
  if (log > max_log) throw Error{"corrupt zstd block (FSE accuracy log too large)"};
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1, sym = 0;
  norm.assign(max_sym + 1, 0);
  while (remaining > 1) {
    if (sym > max_sym) throw Error{"corrupt zstd block (FSE table has too many symbols)"};
    int maxv = 2 * threshold - 1 - remaining;
    int count;
    uint32_t v = bits(nbits);
    if (int(v & (threshold - 1)) < maxv) {
      count = int(v & (threshold - 1));
      bitpos += nbits - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= maxv;
      bitpos += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[sym++] = count;
    if (count == 0) {
      for (;;) {
        int rep = int(bits(2));
        bitpos += 2;
        for (int i = 0; i < rep; i++) {
          if (sym > max_sym) throw Error{"corrupt zstd block (FSE zero run too long)"};
          norm[sym++] = 0;
        }
        if (rep != 3) break;
      }
    }
    while (remaining < threshold && threshold > 1) {
      nbits--;
      threshold >>= 1;
    }
  }
  if (remaining != 1) throw Error{"corrupt zstd block (FSE counts do not sum to the table)"};
  if ((bitpos + 7) >> 3 > n) throw Error{"corrupt zstd block (truncated FSE table description)"};
  norm.resize(sym);
  return (bitpos + 7) >> 3;
}

void build_fse(FseTable& ft, const std::vector<int>& norm, int log) {
  int size = 1 << log;
  ft.log = log;
  ft.t.assign(size, FseEntry{0, 0, 0});
  std::vector<int> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      if (high < 0) throw Error{"corrupt zstd block (FSE table overfull)"};
      ft.t[high--].sym = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      ft.t[pos].sym = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) throw Error{"corrupt zstd block (FSE table does not close)"};
  for (int u = 0; u < size; u++) {
    int s = ft.t[u].sym;
    int x = next[s]++;
    if (x <= 0) throw Error{"corrupt zstd block (FSE table)"};
    int nb = log - highbit(uint32_t(x));
    ft.t[u].nbits = uint8_t(nb);
    ft.t[u].base = uint16_t((x << nb) - size);
  }
}

void build_rle(FseTable& ft, int sym) {
  ft.log = 0;
  ft.t.assign(1, FseEntry{uint8_t(sym), 0, 0});
}

// --------------------------------------------------------------- Huffman

struct HufTable {
  int maxbits = 0;
  std::vector<uint16_t> t;         // (symbol << 8) | bits, 1 << maxbits entries
};

// RFC 8878 4.2.1: the tree description at `p`; returns the bytes used.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& ht) {
  if (n < 1) throw Error{"corrupt zstd literals (no Huffman tree description)"};
  uint8_t w[256];
  int nw = 0;
  size_t used;
  int hdr = p[0];
  if (hdr >= 128) {
    nw = hdr - 127;
    used = 1 + size_t((nw + 1) / 2);
    if (used > n) throw Error{"corrupt zstd literals (truncated Huffman weights)"};
    for (int i = 0; i < nw; i++) w[i] = (i & 1) ? (p[1 + i / 2] & 15) : (p[1 + i / 2] >> 4);
  } else {
    size_t csize = size_t(hdr);
    used = 1 + csize;
    if (used > n || csize == 0) throw Error{"corrupt zstd literals (truncated Huffman weights)"};
    std::vector<int> norm;
    int log;
    size_t nc = read_ncount(p + 1, csize, 6, 255, norm, log);
    if (nc >= csize) throw Error{"corrupt zstd literals (Huffman weight stream missing)"};
    FseTable ft;
    build_fse(ft, norm, log);
    BackBits br;
    br.init(p + 1 + nc, csize - nc);
    uint32_t s1 = br.get(log), s2 = br.get(log);
    for (;;) {
      if (nw > 253) throw Error{"corrupt zstd literals (too many Huffman weights)"};
      const FseEntry& e1 = ft.t[s1];
      w[nw++] = e1.sym;
      s1 = e1.base + br.get(e1.nbits);
      if (br.pos < 0) {
        w[nw++] = ft.t[s2].sym;
        break;
      }
      const FseEntry& e2 = ft.t[s2];
      w[nw++] = e2.sym;
      s2 = e2.base + br.get(e2.nbits);
      if (br.pos < 0) {
        w[nw++] = ft.t[s1].sym;
        break;
      }
    }
  }
  if (nw > 255) throw Error{"corrupt zstd literals (too many Huffman weights)"};
  uint32_t sum = 0;
  for (int i = 0; i < nw; i++) {
    if (w[i] > 11) throw Error{"corrupt zstd literals (Huffman weight above 11)"};
    if (w[i]) sum += 1u << (w[i] - 1);
  }
  if (sum == 0) throw Error{"corrupt zstd literals (all Huffman weights zero)"};
  int maxbits = highbit(sum) + 1;
  uint32_t rest = (1u << maxbits) - sum;
  if (rest & (rest - 1)) throw Error{"corrupt zstd literals (Huffman weights do not close)"};
  if (maxbits > 11) throw Error{"corrupt zstd literals (Huffman code longer than 11 bits)"};
  w[nw++] = uint8_t(highbit(rest) + 1);
  ht.maxbits = maxbits;
  ht.t.assign(size_t(1) << maxbits, 0);
  size_t pos = 0;
  for (int wt = 1; wt <= maxbits; wt++) {
    for (int s = 0; s < nw; s++) {
      if (w[s] != wt) continue;
      size_t span = size_t(1) << (wt - 1);
      uint16_t e = uint16_t((s << 8) | (maxbits + 1 - wt));
      for (size_t i = 0; i < span; i++) ht.t[pos + i] = e;
      pos += span;
    }
  }
  if (pos != ht.t.size()) throw Error{"corrupt zstd literals (Huffman table)"};
  return used;
}

void huff_stream(const HufTable& ht, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits br;
  br.init(p, n);
  int mb = ht.maxbits;
  const uint16_t* t = ht.t.data();
  size_t i = 0;
  int per_load = 56 / mb;
  while (i < count && br.pos >= 64) {      // several symbols per 64-bit load
    uint64_t w = br.window64(br.pos);
    int used = 0;
    for (int j = 0; j < per_load && i < count; j++) {
      uint16_t e = t[(w << used) >> (64 - mb)];
      out[i++] = uint8_t(e >> 8);
      used += e & 0xFF;
    }
    br.pos -= used;
  }
  for (; i < count; i++) {
    uint16_t e = t[br.peek(mb)];
    out[i] = uint8_t(e >> 8);
    br.pos -= e & 0xFF;
  }
  if (br.pos != 0) throw Error{"corrupt zstd literals (Huffman stream not consumed exactly)"};
}

// ---------------------------------------------------------- the decoder

const int LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                         12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                         1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,   14,   15,   16,
                         17, 18, 19, 20, 21, 22, 23, 24,  25,  26,  27,   28,   29,   30,
                         31, 32, 33, 34, 35, 37, 39, 41,  43,  47,  51,   59,   67,   83,
                         99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const int ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                         2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huf;
  bool have_huf = false;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
  size_t start = 0;                // where this frame's output begins
  uint64_t window = 0;
};

// Read one of the three sequence tables at `p`; returns the bytes used.
size_t seq_table(int mode, const uint8_t* p, size_t n, FseTable& ft, bool& have,
                 const int* dflt, int ndflt, int dlog, int max_log, int max_sym) {
  if (mode == 0) {
    build_fse(ft, std::vector<int>(dflt, dflt + ndflt), dlog);
    have = true;
    return 0;
  }
  if (mode == 1) {
    if (n < 1) throw Error{"corrupt zstd block (truncated RLE sequence table)"};
    if (p[0] > max_sym) throw Error{"corrupt zstd block (RLE symbol out of range)"};
    build_rle(ft, p[0]);
    have = true;
    return 1;
  }
  if (mode == 2) {
    std::vector<int> norm;
    int log;
    size_t used = read_ncount(p, n, max_log, max_sym, norm, log);
    build_fse(ft, norm, log);
    have = true;
    return used;
  }
  if (!have) throw Error{"corrupt zstd block (repeat mode without a previous table)"};
  return 0;
}

void decode_block(const uint8_t* p, size_t n, Out& out, FrameState& fs, size_t block_max) {
  if (n < 1) throw Error{"corrupt zstd block (empty compressed block)"};
  // --- literals
  int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      hsize = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hsize = 2;
      if (n < 2) throw Error{"corrupt zstd block (truncated literals header)"};
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hsize = 3;
      if (n < 3) throw Error{"corrupt zstd block (truncated literals header)"};
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    csize = ltype == 0 ? regen : 1;
  } else {
    hsize = sf < 2 ? 3 : (sf == 2 ? 4 : 5);
    if (n < hsize) throw Error{"corrupt zstd block (truncated literals header)"};
    uint64_t c = 0;
    for (size_t i = 0; i < hsize; i++) c |= uint64_t(p[i]) << (8 * i);
    int nb = sf < 2 ? 10 : (sf == 2 ? 14 : 18);
    regen = size_t((c >> 4) & ((1u << nb) - 1));
    csize = size_t((c >> (4 + nb)) & ((1u << nb) - 1));
    streams = sf == 0 ? 1 : 4;
  }
  if (regen > block_max) throw Error{"corrupt zstd block (literals exceed the block size)"};
  if (hsize + csize > n) throw Error{"corrupt zstd block (literals run past the block)"};
  std::vector<uint8_t> lit(regen);
  const uint8_t* lp = p + hsize;
  if (ltype == 0) {
    if (regen) std::memcpy(lit.data(), lp, regen);
  } else if (ltype == 1) {
    std::memset(lit.data(), lp[0], regen);
  } else {
    size_t tsize = 0;
    if (ltype == 2) {
      tsize = read_huffman(lp, csize, fs.huf);
      fs.have_huf = true;
    } else if (!fs.have_huf) {
      throw Error{"corrupt zstd block (treeless literals without a previous table)"};
    }
    const uint8_t* sp = lp + tsize;
    size_t slen = csize - tsize;
    if (streams == 1) {
      huff_stream(fs.huf, sp, slen, lit.data(), regen);
    } else {
      if (slen < 6) throw Error{"corrupt zstd block (truncated jump table)"};
      size_t s1 = sp[0] | sp[1] << 8, s2 = sp[2] | sp[3] << 8, s3 = sp[4] | sp[5] << 8;
      if (6 + s1 + s2 + s3 > slen) throw Error{"corrupt zstd block (jump table past the literals)"};
      size_t s4 = slen - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) throw Error{"corrupt zstd block (too few literals for four streams)"};
      const uint8_t* q = sp + 6;
      huff_stream(fs.huf, q, s1, lit.data(), seg);
      huff_stream(fs.huf, q + s1, s2, lit.data() + seg, seg);
      huff_stream(fs.huf, q + s1 + s2, s3, lit.data() + 2 * seg, seg);
      huff_stream(fs.huf, q + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
  }
  // --- sequences
  const uint8_t* sp = p + hsize + csize;
  size_t sn = n - hsize - csize;
  if (sn < 1) throw Error{"corrupt zstd block (no sequences header)"};
  size_t nseq;
  size_t k = 0;
  if (sp[0] < 128) {
    nseq = sp[0];
    k = 1;
  } else if (sp[0] < 255) {
    if (sn < 2) throw Error{"corrupt zstd block (truncated sequences header)"};
    nseq = (size_t(sp[0] - 128) << 8) + sp[1];
    k = 2;
  } else {
    if (sn < 3) throw Error{"corrupt zstd block (truncated sequences header)"};
    nseq = sp[1] + (size_t(sp[2]) << 8) + 0x7F00;
    k = 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (k >= sn) throw Error{"corrupt zstd block (no sequence modes)"};
    int modes = sp[k++];
    if (modes & 3) throw Error{"corrupt zstd block (reserved sequence mode bits set)"};
    k += seq_table(modes >> 6, sp + k, sn - k, fs.ll, fs.have_ll, LL_DEFAULT, 36, 6, 9, 35);
    if (k > sn) throw Error{"corrupt zstd block"};
    k += seq_table((modes >> 4) & 3, sp + k, sn - k, fs.of, fs.have_of, OF_DEFAULT, 29, 5, 8, 31);
    if (k > sn) throw Error{"corrupt zstd block"};
    k += seq_table((modes >> 2) & 3, sp + k, sn - k, fs.ml, fs.have_ml, ML_DEFAULT, 53, 6, 9, 52);
    if (k >= sn) throw Error{"corrupt zstd block (no sequence bitstream)"};
    BackBits br;
    br.init(sp + k, sn - k);
    uint32_t sll = br.get(fs.ll.log), sof = br.get(fs.of.log), sml = br.get(fs.ml.log);
    size_t produced = 0;
    for (size_t i = 0; i < nseq; i++) {
      const FseEntry &el = fs.ll.t[sll], &eo = fs.of.t[sof], &em = fs.ml.t[sml];
      int ofc = eo.sym, mlc = em.sym, llc = el.sym;
      if (ofc > 31 || mlc > 52 || llc > 35) throw Error{"corrupt zstd block (sequence code)"};
      uint32_t ofv = (1u << ofc) + br.get(ofc);
      size_t ml = size_t(ML_BASE[mlc]) + br.get(ML_BITS[mlc]);
      size_t ll = size_t(LL_BASE[llc]) + br.get(LL_BITS[llc]);
      if (i + 1 < nseq) {
        sll = el.base + br.get(el.nbits);
        sml = em.base + br.get(em.nbits);
        sof = eo.base + br.get(eo.nbits);
      }
      if (br.pos < 0) throw Error{"corrupt zstd block (sequence bitstream overrun)"};
      uint32_t off;
      if (ofv > 3) {
        off = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = off;
      } else {
        uint32_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          off = fs.rep[0];
        } else {
          off = idx == 3 ? fs.rep[0] - 1 : fs.rep[idx];
          if (off == 0) throw Error{"corrupt zstd block (repeat offset of zero)"};
          if (idx != 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = off;
        }
      }
      if (ll > regen - lit_pos) throw Error{"corrupt zstd block (literal length past the literals)"};
      produced += ll + ml;
      if (produced > block_max) throw Error{"corrupt zstd block (block decodes past its maximum)"};
      out.reserve(ll + ml);
      std::memcpy(out.buf + out.len, lit.data() + lit_pos, ll);
      out.len += ll;
      lit_pos += ll;
      if (off > out.len - fs.start) throw Error{"corrupt zstd block (match offset before the frame)"};
      if (off > fs.window) throw Error{"corrupt zstd block (match offset beyond the window)"};
      uint8_t* dst = out.buf + out.len;
      const uint8_t* src = dst - off;
      if (off >= ml) {
        std::memcpy(dst, src, ml);
      } else {
        for (size_t j = 0; j < ml; j++) dst[j] = src[j];
      }
      out.len += ml;
    }
    if (br.pos != 0) throw Error{"corrupt zstd block (sequence bitstream not consumed exactly)"};
  } else if (k != sn) {
    throw Error{"corrupt zstd block (bytes after an empty sequences section)"};
  }
  size_t rest = regen - lit_pos;
  out.reserve(rest);
  if (rest) std::memcpy(out.buf + out.len, lit.data() + lit_pos, rest);
  out.len += rest;
}

// Decode every frame in [p, p + n) into `out`.
void decode_all(const uint8_t* p, size_t n, Out& out) {
  size_t pos = 0;
  if (n == 0) throw Error{"empty zstd input"};
  while (pos < n) {
    if (n - pos < 4) throw Error{"truncated zstd input (partial magic number)"};
    uint32_t magic = rd32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      if (n - pos < 8) throw Error{"truncated zstd skippable frame"};
      uint64_t sz = rd32(p + pos + 4);
      if (sz > n - pos - 8) throw Error{"truncated zstd skippable frame"};
      pos += 8 + size_t(sz);
      continue;
    }
    if (magic != 0xFD2FB528u) throw Error{"not a zstd frame (bad magic number)"};
    pos += 4;
    if (pos >= n) throw Error{"truncated zstd frame header"};
    int fhd = p[pos++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did = fhd & 3;
    if (fhd & 8) throw Error{"corrupt zstd frame header (reserved bit set)"};
    uint64_t window = 0;
    if (!single) {
      if (pos >= n) throw Error{"truncated zstd frame header"};
      int wd = p[pos++];
      int wlog = 10 + (wd >> 3);
      if (wlog > 41) throw Error{"corrupt zstd frame header (window too large)"};
      uint64_t base = uint64_t(1) << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    int dsize = did == 0 ? 0 : (did == 1 ? 1 : (did == 2 ? 2 : 4));
    if (pos + dsize > n) throw Error{"truncated zstd frame header"};
    uint32_t dict = 0;
    for (int i = 0; i < dsize; i++) dict |= uint32_t(p[pos + i]) << (8 * i);
    pos += dsize;
    if (dict) {
      char buf[96];
      std::snprintf(buf, sizeof(buf), "zstd frame names dictionary %u: dictionaries are not read",
                    dict);
      throw Error{buf};
    }
    int fsize = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
    if (pos + fsize > n) throw Error{"truncated zstd frame header"};
    uint64_t fcs = 0;
    bool known = fsize > 0;
    for (int i = 0; i < fsize; i++) fcs |= uint64_t(p[pos + i]) << (8 * i);
    if (fsize == 2) fcs += 256;
    pos += fsize;
    if (single) window = fcs;
    FrameState fs;
    fs.start = out.len;
    fs.window = window;
    size_t block_max = size_t(std::min<uint64_t>(window, 128 * 1024));
    if (known && !out.grows && fcs > out.cap - out.len)
      throw Error{"zstd frame content size exceeds the output buffer"};
    for (;;) {
      if (n - pos < 3) throw Error{"truncated zstd block header"};
      uint32_t bh = p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16;
      pos += 3;
      int last = bh & 1, type = (bh >> 1) & 3;
      size_t bsize = bh >> 3;
      if (type == 3) throw Error{"corrupt zstd block (reserved block type)"};
      size_t in_size = type == 1 ? 1 : bsize;
      if (in_size > n - pos) throw Error{"truncated zstd block"};
      if (bsize > block_max) throw Error{"corrupt zstd block (larger than its maximum size)"};
      if (type == 0) {
        out.reserve(bsize);
        std::memcpy(out.buf + out.len, p + pos, bsize);
        out.len += bsize;
      } else if (type == 1) {
        out.reserve(bsize);
        std::memset(out.buf + out.len, p[pos], bsize);
        out.len += bsize;
      } else {
        decode_block(p + pos, bsize, out, fs, block_max);
      }
      pos += in_size;
      if (last) break;
    }
    size_t got = out.len - fs.start;
    if (known && got != fcs) throw Error{"corrupt zstd frame (content size does not match)"};
    if (checksum) {
      if (n - pos < 4) throw Error{"truncated zstd frame (checksum missing)"};
      uint32_t want = rd32(p + pos);
      uint32_t have = uint32_t(xxh64(out.buf + fs.start, got));
      if (want != have) throw Error{"corrupt zstd frame (content checksum mismatch)"};
      pos += 4;
    }
  }
}

// Sum of the stated content sizes of every frame, -1 when a frame states none.
int64_t content_size(const uint8_t* p, size_t n) {
  size_t pos = 0;
  int64_t total = 0;
  while (pos < n) {
    if (n - pos < 8) return -1;
    uint32_t magic = rd32(p + pos);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
      uint64_t sz = rd32(p + pos + 4);
      if (sz > n - pos - 8) return -1;
      pos += 8 + size_t(sz);
      continue;
    }
    if (magic != 0xFD2FB528u) return -1;
    size_t q = pos + 4;
    int fhd = p[q++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did = fhd & 3, checksum = (fhd >> 2) & 1;
    if (!single) q++;
    q += did == 0 ? 0 : (did == 1 ? 1 : (did == 2 ? 2 : 4));
    int fsize = fcs_flag == 0 ? (single ? 1 : 0) : (fcs_flag == 1 ? 2 : (fcs_flag == 2 ? 4 : 8));
    if (fsize == 0 || q + fsize > n) return -1;
    uint64_t fcs = 0;
    for (int i = 0; i < fsize; i++) fcs |= uint64_t(p[q + i]) << (8 * i);
    if (fsize == 2) fcs += 256;
    if (fcs > (uint64_t(1) << 40)) return -1;
    total += int64_t(fcs);
    q += fsize;
    for (;;) {                               // walk the blocks to find the next frame
      if (n - q < 3) return -1;
      uint32_t bh = p[q] | p[q + 1] << 8 | p[q + 2] << 16;
      q += 3;
      size_t in_size = ((bh >> 1) & 3) == 1 ? 1 : (bh >> 3);
      if (in_size > n - q) return -1;
      q += in_size;
      if (bh & 1) break;
    }
    if (checksum) q += 4;
    pos = q;
  }
  return total;
}

struct CrcTable {
  uint32_t t[256];
  CrcTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[i] = c;
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// The total content size the frames state, or -1 when one states none.
int64_t zstd_content_size(const uint8_t* src, size_t len) { return content_size(src, len); }

// Decode every frame of src into dst (capacity cap); *out_len gets the bytes
// written.  0 on success, 1 with a message in err on failure.
int zstd_decode_into(const uint8_t* src, size_t len, uint8_t* dst, size_t cap, size_t* out_len,
                     char* err, int errlen) {
  try {
    Out o;
    o.buf = dst;
    o.cap = cap;
    decode_all(src, len, o);
    *out_len = o.len;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "zstd decoder failed");
  }
  return 1;
}

// Decode every frame of src into a malloc'd buffer (free with zstd_free).
int zstd_decode_alloc(const uint8_t* src, size_t len, uint8_t** out, size_t* out_len, char* err,
                      int errlen) {
  try {
    Out o;
    o.grows = true;
    decode_all(src, len, o);
    *out = static_cast<uint8_t*>(std::malloc(o.len ? o.len : 1));
    if (!*out) throw Error{"out of memory"};
    if (o.len) std::memcpy(*out, o.buf, o.len);
    *out_len = o.len;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "zstd decoder failed");
  }
  return 1;
}

void zstd_free(void* p) { std::free(p); }

// CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), as OCDBT stores it.
uint32_t zstd_crc32c(const uint8_t* src, size_t len) {
  static const CrcTable table;
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table.t[(c ^ src[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // extern "C"
