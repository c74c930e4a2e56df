// Block-compressed texture decoders (S3TC / RGTC / BPTC: BC1-BC7) as Pillow
// 12.1 decodes them: its C decoder ("bcn", which its DDS and FTEX readers
// use) and, for BLP2's DXT1 / DXT3 / DXT5, the Python decoders of its BLP
// plugin, which expand 5-6-5 colours by shifting alone.
//
// One entry, `bcn_decode`: blocks of 4x4 pixels in rows of blocks, the
// partial blocks at a right or bottom edge cut off, into [height, width, C]
// uint8 pixels.  C is 4 (RGBA) for BC1, BC2, BC3 and BC7; 1 (L) for BC4; 3
// (RGB) for BC5 and BC6H; 3 for BLP's DXT1 without alpha.  Where Pillow's C
// decoder departs from the specifications this one follows Pillow:
//
// * BC1: the two interpolated colours truncated, (2a + b) / 3 and (a + b) / 2;
//   index 3 of a block whose c0 <= c1 transparent black (BC2 and BC3 always
//   take the four-colour table);
// * BC4 / BC5 signed (BC5S): each endpoint byte read as int8 plus 128, then
//   the unsigned interpolation; BC5S's blue is 128 (unsigned BC5's 0);
// * BC6H: endpoints unquantized and interpolated without rounding, each
//   colour's half float truncated to 8 bits over [0, 1] (negative values 0,
//   1 and above 255); a reserved mode gives black;
// * BC7: the reserved mode (a first byte of 0) gives opaque black.
//
// Data that ends before the last block raises, as Pillow's "image file is
// truncated" (its raw decoder: "not enough image data").
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

typedef uint8_t Block[16][4];   // 16 pixels of RGBA, row by row

// ------------------------------------------------------------------- BC1-BC5

void colour565(unsigned v, bool replicate, int* rgb) {
  const int r = (v >> 11) & 31, g = (v >> 5) & 63, b = v & 31;
  rgb[0] = r << 3 | (replicate ? r >> 2 : 0);
  rgb[1] = g << 2 | (replicate ? g >> 4 : 0);
  rgb[2] = b << 3 | (replicate ? b >> 2 : 0);
}

// The colour half of a BC1 / BC2 / BC3 block (8 bytes at s).  `four` takes
// the four-colour table whatever the endpoints' order (BC2, BC3);
// `replicate` false expands 5-6-5 as BLP's Python decoders do.
void bc1_colour(const uint8_t* s, bool four, bool replicate, Block col) {
  const unsigned c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
  const uint32_t lut = uint32_t(s[4]) | uint32_t(s[5]) << 8 | uint32_t(s[6]) << 16 |
                       uint32_t(s[7]) << 24;
  int p[4][4];
  colour565(c0, replicate, p[0]);
  colour565(c1, replicate, p[1]);
  p[0][3] = p[1][3] = p[2][3] = p[3][3] = 255;
  for (int c = 0; c < 3; c++) {
    if (c0 > c1 || four) {
      p[2][c] = (2 * p[0][c] + p[1][c]) / 3;
      p[3][c] = (p[0][c] + 2 * p[1][c]) / 3;
    } else {
      p[2][c] = (p[0][c] + p[1][c]) / 2;
      p[3][c] = 0;
    }
  }
  if (!(c0 > c1 || four)) p[3][3] = 0;
  for (int n = 0; n < 16; n++)
    for (int c = 0; c < 4; c++) col[n][c] = uint8_t(p[(lut >> (2 * n)) & 3][c]);
}

// A BC3 alpha / BC4 / BC5 channel block (8 bytes at s) into channel `ch`.
void bc3_alpha(const uint8_t* s, bool sign, int ch, Block col) {
  const int a0 = sign ? int8_t(s[0]) + 128 : s[0], a1 = sign ? int8_t(s[1]) + 128 : s[1];
  int a[8] = {a0, a1};
  if (a0 > a1) {
    for (int k = 2; k < 8; k++) a[k] = ((8 - k) * a0 + (k - 1) * a1) / 7;
  } else {
    for (int k = 2; k < 6; k++) a[k] = ((6 - k) * a0 + (k - 1) * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  uint64_t lut = 0;
  for (int k = 0; k < 6; k++) lut |= uint64_t(s[2 + k]) << (8 * k);
  for (int n = 0; n < 16; n++) col[n][ch] = uint8_t(a[(lut >> (3 * n)) & 7]);
}

// ---------------------------------------------------------- BPTC's shared

int get_bits(const uint8_t* b, int at, int n) {
  int v = 0;
  for (int i = 0; i < n; i++, at++) v |= ((b[at >> 3] >> (at & 7)) & 1) << i;
  return v;
}

// the subset of each pixel under each 2- and 3-subset partition (BPTC)
const uint16_t kPartition2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const char* const kPartition3[64] = {
    "0011001102212222", "0001001122112221", "0000200122112211", "0222002200110111",
    "0000000011221122", "0011001100220022", "0022002211111111", "0011001122112211",
    "0000000011112222", "0000111111112222", "0000111122222222", "0012001200120012",
    "0112011201120112", "0122012201220122", "0011011211221222", "0011200122002220",
    "0001001101121122", "0111001120012200", "0000112211221122", "0022002200221111",
    "0111011102220222", "0001000122212221", "0000001101220122", "0000110022102210",
    "0122012200110000", "0012001211222222", "0110122112210110", "0000011012211221",
    "0022110211020022", "0110011020022222", "0011012201220011", "0000200022112221",
    "0000000211221222", "0222002200120011", "0011001200220222", "0120012001200120",
    "0000111122220000", "0120120120120120", "0120201212010120", "0011220011220011",
    "0011112222000011", "0101010122222222", "0000000021212121", "0022112200221122",
    "0022001100220011", "0220122102201221", "0101222222220101", "0000212121212121",
    "0101010101012222", "0222011102220111", "0002111200021112", "0000211221122112",
    "0222011101110222", "0002111211120002", "0110011001102222", "0000000021122112",
    "0110011022222222", "0022001100110022", "0022112211220022", "0000000000002112",
    "0002000100020001", "0222122202221222", "0101222222222222", "0111201122012220"};
// the anchor (highest-bit-dropped) index of subset 1 (2 subsets), and of
// subsets 1 and 2 (3 subsets); subset 0's is pixel 0
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2, 8,
    8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15,
    15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15};
const uint8_t kAnchor3a[64] = {
    3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3,
    6, 10, 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5,
    15, 15, 15, 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3};
const uint8_t kAnchor3b[64] = {
    15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8,
    15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15,
    3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8};

int subset(int subsets, int partition, int n) {
  if (subsets == 2) return (kPartition2[partition] >> n) & 1;
  if (subsets == 3) return kPartition3[partition][n] - '0';
  return 0;
}

// the index of pixel n has one bit fewer where it is a subset's anchor
bool anchor(int subsets, int partition, int n) {
  return n == 0 || (subsets == 2 && n == kAnchor2[partition]) ||
         (subsets == 3 && (n == kAnchor3a[partition] || n == kAnchor3b[partition]));
}

const int kWeights2[4] = {0, 21, 43, 64};
const int kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const int kWeights4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const int* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

// ------------------------------------------------------------------- BC7

struct Bc7Mode {
  int subsets, partition_bits, rotation_bits, selector_bits, colour_bits, alpha_bits,
      endpoint_pbits, shared_pbits, index_bits, index2_bits;
};
const Bc7Mode kBc7[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

void bc7_block(const uint8_t* s, Block col) {
  if (s[0] == 0) {                       // reserved: Pillow's opaque black
    for (int n = 0; n < 16; n++) col[n][0] = col[n][1] = col[n][2] = 0, col[n][3] = 255;
    return;
  }
  int mode = 0;
  while (!(s[0] >> mode & 1)) mode++;
  const Bc7Mode& m = kBc7[mode];
  int bit = mode + 1;
  const int partition = get_bits(s, bit, m.partition_bits);
  bit += m.partition_bits;
  const int rotation = get_bits(s, bit, m.rotation_bits);
  bit += m.rotation_bits;
  const int selector = get_bits(s, bit, m.selector_bits);
  bit += m.selector_bits;
  const int ends = 2 * m.subsets;
  int e[6][4];
  for (int c = 0; c < 4; c++) {
    const int nb = c < 3 ? m.colour_bits : m.alpha_bits;
    for (int i = 0; i < ends; i++) {
      e[i][c] = nb ? get_bits(s, bit, nb) : 255;
      bit += nb;
    }
  }
  int cb = m.colour_bits, ab = m.alpha_bits;
  if (m.endpoint_pbits || m.shared_pbits) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < ends; i++) {
      if (m.endpoint_pbits || i % 2 == 0) bit++;
      const int p = get_bits(s, bit - 1, 1);
      for (int c = 0; c < 4; c++)
        if (c < 3 || ab) e[i][c] = e[i][c] << 1 | p;
    }
  }
  for (int i = 0; i < ends; i++)
    for (int c = 0; c < 4; c++) {
      const int nb = c < 3 ? cb : ab;
      if (nb) e[i][c] = (e[i][c] << (8 - nb) | e[i][c] >> (2 * nb - 8)) & 255;
    }
  const int* cw = weights(m.index_bits);
  const int* aw = weights(ab && m.index2_bits ? m.index2_bits : m.index_bits);
  int ci = bit, ai = bit + 16 * m.index_bits - m.subsets;
  for (int n = 0; n < 16; n++) {
    const int sub = 2 * subset(m.subsets, partition, n);
    const int ib = m.index_bits - anchor(m.subsets, partition, n);
    const int i0 = get_bits(s, ci, ib);
    ci += ib;
    int wc = cw[i0], wa = cw[i0];
    if (ab && m.index2_bits) {
      const int ib2 = m.index2_bits - (n == 0);
      const int i1 = get_bits(s, ai, ib2);
      ai += ib2;
      wc = selector ? aw[i1] : cw[i0];
      wa = selector ? cw[i0] : aw[i1];
    }
    for (int c = 0; c < 4; c++) {
      const int w = c < 3 ? wc : wa;
      col[n][c] = uint8_t(((64 - w) * e[sub][c] + w * e[sub + 1][c] + 32) >> 6);
    }
    if (rotation) {
      const uint8_t t = col[n][rotation - 1];
      col[n][rotation - 1] = col[n][3];
      col[n][3] = t;
    }
  }
}

// ------------------------------------------------------------------ BC6H

// endpoint fields: w, x (subset 0), y, z (subset 1), each r, g, b; d the partition
enum { RW, GW, BW, RX, GX, BX, RY, GY, BY, RZ, GZ, BZ, D };

struct Bc6Mode {
  int subsets, transformed, endpoint_bits, delta_bits[3];
  const char* layout;      // the header bits after the mode bits, lowest first
};
// Microsoft's "BC6H Format" table: "rw0-9" is rw's bits 0 to 9 in that
// order, "rw15-10" bits 15 down to 10
const Bc6Mode kBc6[14] = {
    {2, 1, 10, {5, 5, 5}, "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 "
                          "bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"},
    {2, 1, 7, {6, 6, 6}, "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 "
                         "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4"},
    {2, 1, 11, {5, 4, 4}, "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 "
                          "bw10 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"},
    {2, 1, 11, {4, 5, 4}, "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 "
                          "bw10 bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3 d0-4"},
    {2, 1, 11, {4, 4, 5}, "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 "
                          "bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3 d0-4"},
    {2, 1, 9, {5, 5, 5}, "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
                         "bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"},
    {2, 1, 8, {6, 5, 5}, "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
                         "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5 d0-4"},
    {2, 1, 8, {5, 6, 5}, "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 "
                         "gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"},
    {2, 1, 8, {5, 5, 6}, "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 "
                         "gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3 d0-4"},
    {2, 0, 6, {6, 6, 6}, "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 "
                         "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5 d0-4"},
    {1, 0, 10, {10, 10, 10}, "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9"},
    {1, 1, 11, {9, 9, 9}, "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10"},
    {1, 1, 12, {8, 8, 8}, "rw0-9 gw0-9 bw0-9 rx0-7 rw11 rw10 gx0-7 gw11 gw10 bx0-7 bw11 bw10"},
    {1, 1, 16, {4, 4, 4}, "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10"}};

// The layouts unrolled: per mode, (field << 4 | bit) of each header bit.
struct Bc6Layouts {
  uint8_t bits[14][82];
  int count[14];
  Bc6Layouts() {
    for (int m = 0; m < 14; m++) {
      int k = 0;
      for (const char* p = kBc6[m].layout; *p;) {
        if (*p == ' ') {
          p++;
          continue;
        }
        const int field = *p == 'd' ? D : 3 * (p[1] - 'w') + (*p == 'r' ? 0 : *p == 'g' ? 1 : 2);
        p += *p == 'd' ? 1 : 2;
        int lo = 0, hi;
        while (*p >= '0' && *p <= '9') lo = 10 * lo + (*p++ - '0');
        hi = lo;
        if (*p == '-') {
          hi = 0;
          for (p++; *p >= '0' && *p <= '9';) hi = 10 * hi + (*p++ - '0');
        }
        for (int b = lo;; b += hi >= lo ? 1 : -1) {
          bits[m][k++] = uint8_t(field << 4 | b);
          if (b == hi) break;
        }
      }
      count[m] = k;
    }
  }
};

int sign_extend(int v, int bits) {
  return v & (1 << (bits - 1)) ? v - (1 << bits) : v;
}

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15 || v == 0) return v;
    if (v == (1 << bits) - 1) return 0xFFFF;
    return ((v << 15) + 0x4000) >> (bits - 1);
  }
  if (bits >= 16) return v;
  const bool neg = v < 0;
  int x = neg ? -v : v;
  if (x) x = x >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (bits - 1);
  return neg ? -x : x;
}

// a finished half float's bits -> float (Pillow's half_to_float)
float half_to_float(unsigned h) {
  uint32_t u = (h & 0x7FFF) << 13;
  float f, m;
  const uint32_t mu = 0x77800000, inf = 0x47800000;
  std::memcpy(&f, &u, 4);
  std::memcpy(&m, &mu, 4);
  f *= m;
  std::memcpy(&m, &inf, 4);
  std::memcpy(&u, &f, 4);
  if (f >= m) u |= 255u << 23;
  u |= (h & 0x8000) << 16;
  std::memcpy(&f, &u, 4);
  return f;
}

uint8_t bc6_channel(int v, bool sign) {
  unsigned h;
  if (!sign) h = unsigned(v * 31) / 64;
  else h = v < 0 ? ((-v) * 31 / 32) | 0x8000 : v * 31 / 32;
  const float f = half_to_float(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

// Returns whether Pillow misreads the block (see the transform below).
bool bc6_block(const uint8_t* s, bool sign, Block col) {
  static const Bc6Layouts layouts;
  int mode = s[0] & 3, bit = 2;
  if (mode >= 2) {
    const int m5 = s[0] & 31;
    mode = (m5 & 3) == 2 ? 2 + (m5 >> 2) : 10 + (m5 >> 2);
    bit = 5;
  }
  if (mode >= 14) {                    // reserved: black
    std::memset(col, 0, sizeof(Block));
    return false;
  }
  const Bc6Mode& m = kBc6[mode];
  int f[13] = {0};
  for (int k = 0; k < layouts.count[mode]; k++, bit++) {
    const int code = layouts.bits[mode][k];
    f[code >> 4] |= get_bits(s, bit, 1) << (code & 15);
  }
  const int ends = 6 * m.subsets, eb = m.endpoint_bits, mask = (1 << eb) - 1;
  int e[12];
  for (int i = 0; i < ends; i++) e[i] = f[i];
  if (sign)
    for (int c = 0; c < 3; c++) e[c] = sign_extend(e[c], eb);
  if (sign || m.transformed)
    for (int i = 3; i < ends; i++) e[i] = sign_extend(e[i], m.delta_bits[i % 3]);
  // Pillow keeps the sums in 16 bits: signed, they are sign-extended from
  // bit 15, not from the endpoint's top bit as the specification says, so
  // a sum whose top bit is set is read as positive (a misreading)
  bool misread = false;
  if (m.transformed)
    for (int i = 3; i < ends; i++) {
      e[i] = (e[i] + e[i % 3]) & mask;
      if (sign) {
        misread |= eb < 16 && (e[i] >> (eb - 1) & 1);
        e[i] = int16_t(e[i]);
      }
    }
  for (int i = 0; i < ends; i++) e[i] = bc6_unquantize(e[i], eb, sign);
  const int ib = m.subsets == 2 ? 3 : 4, partition = f[D];
  const int* w = weights(ib);
  for (int n = 0; n < 16; n++) {
    const int ibits = ib - anchor(m.subsets, partition, n);
    const int i = get_bits(s, bit, ibits);
    bit += ibits;
    const int* e0 = e + 6 * subset(m.subsets, partition, n);
    for (int c = 0; c < 3; c++)
      col[n][c] = bc6_channel((e0[c] * (64 - w[i]) + e0[3 + c] * w[i]) >> 6, sign);
    col[n][3] = 255;
  }
  return misread;
}

}  // namespace

// Decode `width` x `height` pixels of BCn `n` (1-7) from `size` bytes at
// `src` into `out` ([height, width, channels]).  flags: 1 signed (BC5S,
// BC6HS); 2 BLP's Python DXT decoders (n 1-3: 5-6-5 without replication);
// 4 strict: a BC6HS block Pillow misreads (an endpoint its transform leaves
// positive where the specification's is negative) stops the decode with
// return code 2.
// Each pixel's first `channels` of R, G, B, A are written (BLP2's DXT1
// without alpha takes 3).
extern "C" int bcn_decode(const uint8_t* src, size_t size, int n, int flags, int width,
                          int height, int channels, uint8_t* out, char* err, int errlen) {
  if (n < 1 || n > 7 || width <= 0 || height <= 0 || channels < 1 || channels > 4) {
    std::snprintf(err, size_t(errlen), "BC%d image of %dx%d pixels", n, width, height);
    return 1;
  }
  const size_t bsize = (n == 1 || n == 4) ? 8 : 16;
  const size_t bw = (size_t(width) + 3) / 4, bh = (size_t(height) + 3) / 4;
  if (size / bsize < bw * bh) {
    std::snprintf(err, size_t(errlen),
                  "image file is truncated (BC%d data of %zu bytes for %zu blocks)", n, size,
                  bw * bh);
    return 1;
  }
  const bool sign = flags & 1, replicate = !(flags & 2);
  for (size_t by = 0; by < bh; by++)
    for (size_t bx = 0; bx < bw; bx++) {
      const uint8_t* s = src + (by * bw + bx) * bsize;
      Block col;
      std::memset(col, 0, sizeof(Block));
      switch (n) {
        case 1: bc1_colour(s, false, replicate, col); break;
        case 2:
          bc1_colour(s + 8, true, replicate, col);
          for (int k = 0; k < 16; k++) col[k][3] = uint8_t(((s[k / 2] >> (4 * (k & 1))) & 15) * 17);
          break;
        case 3:
          bc1_colour(s + 8, true, replicate, col);
          bc3_alpha(s, false, 3, col);
          break;
        case 4: bc3_alpha(s, false, 0, col); break;
        case 5:
          bc3_alpha(s, sign, 0, col);
          bc3_alpha(s + 8, sign, 1, col);
          for (int k = 0; k < 16; k++) col[k][2] = sign ? 128 : 0;
          break;
        case 6:
          if (bc6_block(s, sign, col) && (flags & 4)) {
            std::snprintf(err, size_t(errlen),
                          "BC6H signed block %zu: an endpoint the specification makes "
                          "negative, which Pillow reads as positive", by * bw + bx);
            return 2;
          }
          break;
        default: bc7_block(s, col); break;
      }
      for (int j = 0; j < 4; j++) {
        const size_t y = by * 4 + j;
        if (y >= size_t(height)) break;
        for (int i = 0; i < 4; i++) {
          const size_t x = bx * 4 + i;
          if (x >= size_t(width)) break;
          std::memcpy(out + (y * size_t(width) + x) * channels, col[j * 4 + i], channels);
        }
      }
    }
  return 0;
}
