// Baseline JPEG codec with a plain C interface, bound with ctypes by
// utils/jpeg.py.  It reproduces what libjpeg(-turbo) does at its defaults,
// so its bytes and pixels equal those of PIL's JPEG plugin:
//
//   encoder: IJG quantization tables scaled by jpeg_quality_scaling with
//            force_baseline, RGB -> YCbCr in libjpeg's 16-bit fixed point,
//            4:2:0 (h2v2) downsampling with libjpeg's alternating bias, edge
//            replication and dummy blocks as jcprepct.c / jccoefct.c make
//            them, the ISLOW forward DCT (jfdctint.c), rounding division by
//            the table, the standard Huffman tables (K.3), the JFIF 1.01
//            APP0 header, byte stuffing and 1-bit padding;
//   decoder: baseline (and extended 8-bit) sequential and progressive
//            Huffman (jdphuff.c: spectral selection, successive
//            approximation, DC and AC first and refinement scans, EOB runs,
//            coefficients buffered per component), 1, 3 or 4 components,
//            sampling factors 1-2 per axis, DRI restarts, several scans, the
//            ISLOW inverse DCT (jidctint.c) with its range-limit table, the
//            "fancy" triangle upsampling of jdsample.c (h2v1, h1v2, h2v2),
//            jdapimin.c's colour-space rules (JFIF or ids 1-2-3: YCbCr; an
//            Adobe transform 0 or ids R-G-B: RGB; 4 components: CMYK, or
//            YCCK under Adobe transform 2) and jdcolor.c's YCbCr -> RGB and
//            YCCK -> CMYK.  A 4-component file comes out inverted, as PIL's
//            "CMYK;I" raw mode reads every CMYK JPEG.
//
// Arithmetic-coded, lossless, hierarchical and 12-bit files are refused with
// a message that names the marker and its offset, as is a progressive file
// whose scans leave one of the first ten coefficients incomplete (libjpeg
// would smooth its blocks).  Corrupt files are refused too, never read or
// written past their buffers: segments shorter than their contents,
// over-subscribed Huffman tables (libjpeg's checks), more pixels than PIL's
// decompression-bomb limit, and scans that run past the end of the file or
// files without an EOI marker (where PIL raises "image file is truncated").
//
// Build: g++ -O2 -fPIC -std=c++17 -shared -o libjpeg_codec.so jpeg.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdLuminanceQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kStdChrominanceQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------- the DCTs

const int CONST_BITS = 13;
const int PASS1_BITS = 2;
const int64_t FIX_0_298631336 = 2446;
const int64_t FIX_0_390180644 = 3196;
const int64_t FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270;
const int64_t FIX_0_899976223 = 7373;
const int64_t FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299;
const int64_t FIX_1_847759065 = 15137;
const int64_t FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819;
const int64_t FIX_2_562915447 = 20995;
const int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jfdctint.c jpeg_fdct_islow: level-shifted samples in, coefficients scaled
// up by 8 out.
void fdct_islow(int* data) {
  int* p = data;
  for (int ctr = 0; ctr < 8; ctr++, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = int((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS));
    p[6] = int(descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = int(descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
    p[5] = int(descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
    p[3] = int(descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
    p[1] = int(descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
  }
  p = data;
  for (int ctr = 0; ctr < 8; ctr++, p++) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = int(descale(tmp10 - tmp11, PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS));
    p[48] = int(descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = int(descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
    p[40] = int(descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
    p[24] = int(descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
    p[8] = int(descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
  }
}

// jdmaster.c prepare_range_limit_table, the post-IDCT part: index x & 1023
// of an IDCT output x (centred on 0) -> sample.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = uint8_t(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: quantized coefficients (natural order) and
// their table -> 8x8 samples.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int64_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int64_t dc = int64_t(in[0]) * qt[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qt[16], z3 = int64_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qt[0];
    z3 = int64_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qt[56];
    tmp1 = int64_t(in[40]) * qt[40];
    tmp2 = int64_t(in[24]) * qt[24];
    tmp3 = int64_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = int(descale(tmp10 + tmp3, CONST_BITS - PASS1_BITS));
    w[56] = int(descale(tmp10 - tmp3, CONST_BITS - PASS1_BITS));
    w[8] = int(descale(tmp11 + tmp2, CONST_BITS - PASS1_BITS));
    w[48] = int(descale(tmp11 - tmp2, CONST_BITS - PASS1_BITS));
    w[16] = int(descale(tmp12 + tmp1, CONST_BITS - PASS1_BITS));
    w[40] = int(descale(tmp12 - tmp1, CONST_BITS - PASS1_BITS));
    w[24] = int(descale(tmp13 + tmp0, CONST_BITS - PASS1_BITS));
    w[32] = int(descale(tmp13 - tmp0, CONST_BITS - PASS1_BITS));
  }
  for (int r = 0; r < 8; r++) {
    const int64_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[int(descale(w[0], PASS1_BITS + 3)) & 1023];
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// ------------------------------------------------------------- the encoder

struct HuffEnc {
  uint32_t code[256];
  int size[256];
};

// jchuff.c jpeg_make_c_derived_tbl.
HuffEnc make_enc_table(const uint8_t* bits, const uint8_t* vals) {
  HuffEnc t{};
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int lastp = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  for (p = 0; p < lastp; p++) {
    t.code[vals[p]] = uint32_t(huffcode[p]);
    t.size[vals[p]] = huffsize[p];
  }
  return t;
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t code, int size) {
    acc = (acc << size) | (code & ((uint64_t(1) << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      uint8_t b = uint8_t(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {                   // jchuff.c flush_bits: pad with 1-bits
    if (nbits > 0) put((1u << (8 - nbits)) - 1, 8 - nbits);
    nbits = 0;
    acc = 0;
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 0xFF));
}

void put_marker(std::vector<uint8_t>& o, int m) {
  o.push_back(0xFF);
  o.push_back(uint8_t(m));
}

void put_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  put_marker(o, 0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back(uint8_t(cls_id));
  for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
  for (int i = 0; i < n; i++) o.push_back(vals[i]);
}

int bit_length(int v) {
  int n = 0;
  while (v) {
    n++;
    v >>= 1;
  }
  return n;
}

// jchuff.c encode_one_block over a block in natural order.
void encode_block(BitWriter& bw, const int* blk, int& last_dc, const HuffEnc& dc,
                  const HuffEnc& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = bit_length(temp);
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(uint32_t(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = bit_length(temp);
    int sym = (r << 4) + nbits;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(uint32_t(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct EncComp {
  int h, v, tq, tbl;
  int wblocks, hblocks;
  int pw, ph;                    // padded downsampled plane
  std::vector<uint8_t> plane;    // [ph, pw]
};

// The downsampled, edge-replicated plane of one component, as jcprepct.c and
// jcsample.c make it from the full-resolution plane `full` [H, W].
void make_plane(EncComp& c, const std::vector<uint8_t>& full, int W, int H, int hmax, int vmax,
                int mcu_rows) {
  int fw = c.wblocks * 8 * (hmax / c.h);
  int fh = ceil_div(H, vmax) * vmax;
  std::vector<uint8_t> pad(size_t(fw) * fh);
  for (int y = 0; y < fh; y++) {
    const uint8_t* src = &full[size_t(y < H ? y : H - 1) * W];
    uint8_t* dst = &pad[size_t(y) * fw];
    std::memcpy(dst, src, W);
    for (int x = W; x < fw; x++) dst[x] = src[W - 1];
  }
  c.pw = c.wblocks * 8;
  c.ph = mcu_rows * c.v * 8;
  c.plane.assign(size_t(c.pw) * c.ph, 0);
  int rh = hmax / c.h, rv = vmax / c.v;
  int drows = fh / rv;
  for (int y = 0; y < drows; y++) {
    uint8_t* dst = &c.plane[size_t(y) * c.pw];
    if (rh == 1) {
      std::memcpy(dst, &pad[size_t(y) * fw], c.pw);
    } else {                               // h2v2_downsample, bias 1,2,1,2...
      const uint8_t* in0 = &pad[size_t(2 * y) * fw];
      const uint8_t* in1 = &pad[size_t(2 * y + 1) * fw];
      int bias = 1;
      for (int x = 0; x < c.pw; x++) {
        dst[x] = uint8_t((in0[2 * x] + in0[2 * x + 1] + in1[2 * x] + in1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  for (int y = drows; y < c.ph; y++)
    std::memcpy(&c.plane[size_t(y) * c.pw], &c.plane[size_t(drows - 1) * c.pw], c.pw);
}

void quality_table(const int* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    if (t <= 0L) t = 1L;
    if (t > 32767L) t = 32767L;
    if (t > 255L) t = 255L;      // force_baseline
    out[i] = uint16_t(t);
  }
}

std::vector<uint8_t> encode(const uint8_t* px, int W, int H, int channels, int quality) {
  uint16_t qt[2][64];
  quality_table(kStdLuminanceQuant, quality, qt[0]);
  quality_table(kStdChrominanceQuant, quality, qt[1]);
  int nc = channels == 1 ? 1 : 3;
  std::vector<std::vector<uint8_t>> full(nc, std::vector<uint8_t>(size_t(W) * H));
  if (nc == 1) {
    std::memcpy(full[0].data(), px, size_t(W) * H);
  } else {                         // jccolor.c rgb_ycc_convert
    const int64_t SCALE = 16, HALF = int64_t(1) << 15, OFF = int64_t(128) << 16;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int64_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    int64_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.5);
    int64_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (size_t i = 0; i < size_t(W) * H; i++) {
      int64_t r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = uint8_t((ry * r + gy * g + by * b + HALF) >> SCALE);
      full[1][i] = uint8_t((rcb * r + gcb * g + bcb * b + OFF + HALF - 1) >> SCALE);
      full[2][i] = uint8_t((bcb * r + gcr * g + bcr * b + OFF + HALF - 1) >> SCALE);
    }
  }
  std::vector<EncComp> comps(nc);
  int lh = nc == 3 ? 2 : 1, lv = lh;   // 4:2:0 for YCbCr, libjpeg's default
  comps[0].h = lh;
  comps[0].v = lv;
  comps[0].tq = 0;
  comps[0].tbl = 0;
  for (int c = 1; c < nc; c++) {
    comps[c].h = comps[c].v = 1;
    comps[c].tq = 1;
    comps[c].tbl = 1;
  }
  int hmax = lh, vmax = lv;
  int mcux = ceil_div(W, hmax * 8), mcuy = ceil_div(H, vmax * 8);
  for (int c = 0; c < nc; c++) {
    comps[c].wblocks = ceil_div(W * comps[c].h, hmax * 8);
    comps[c].hblocks = ceil_div(H * comps[c].v, vmax * 8);
    if (nc == 1) mcuy = comps[c].hblocks, mcux = comps[c].wblocks;
    make_plane(comps[c], full[c], W, H, hmax, vmax, nc == 1 ? comps[c].hblocks : mcuy);
  }

  std::vector<uint8_t> o;
  o.reserve(size_t(W) * H / 2 + 1024);
  put_marker(o, 0xD8);
  put_marker(o, 0xE0);             // JFIF 1.01, no units, 1:1 density
  const uint8_t app0[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  put16(o, 16);
  o.insert(o.end(), app0, app0 + 14);
  for (int t = 0; t < (nc == 1 ? 1 : 2); t++) {
    put_marker(o, 0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; k++) o.push_back(uint8_t(qt[t][kZigzag[k]]));
  }
  put_marker(o, 0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(uint8_t((comps[c].h << 4) | comps[c].v));
    o.push_back(uint8_t(comps[c].tq));
  }
  put_dht(o, 0x00, kDcLumBits, kDcLumVals);
  put_dht(o, 0x10, kAcLumBits, kAcLumVals);
  if (nc == 3) {
    put_dht(o, 0x01, kDcChromBits, kDcChromVals);
    put_dht(o, 0x11, kAcChromBits, kAcChromVals);
  }
  put_marker(o, 0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back(uint8_t(nc));
  for (int c = 0; c < nc; c++) {
    o.push_back(uint8_t(c + 1));
    o.push_back(uint8_t((comps[c].tbl << 4) | comps[c].tbl));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  HuffEnc dc[2] = {make_enc_table(kDcLumBits, kDcLumVals), make_enc_table(kDcChromBits, kDcChromVals)};
  HuffEnc ac[2] = {make_enc_table(kAcLumBits, kAcLumVals), make_enc_table(kAcChromBits, kAcChromVals)};
  BitWriter bw(o);
  std::vector<int> last_dc(nc, 0);
  int blk[64], prev[64] = {0};
  auto coded_block = [&](const EncComp& c, int by, int bx, int* out) {
    for (int y = 0; y < 8; y++) {
      const uint8_t* row = &c.plane[size_t(by * 8 + y) * c.pw + bx * 8];
      for (int x = 0; x < 8; x++) out[y * 8 + x] = int(row[x]) - 128;
    }
    fdct_islow(out);
    const uint16_t* q = qt[c.tq];
    for (int i = 0; i < 64; i++) {   // jcdctmgr.c quantize: round half away from 0
      int d = int(q[i]) << 3, t = out[i];
      out[i] = t < 0 ? -((-t + (d >> 1)) / d) : (t + (d >> 1)) / d;
    }
  };
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      for (int ci = 0; ci < nc; ci++) {
        const EncComp& c = comps[ci];
        int mh = nc == 1 ? 1 : c.h, mv = nc == 1 ? 1 : c.v;
        for (int yi = 0; yi < mv; yi++) {
          int by = my * mv + yi;
          for (int xi = 0; xi < mh; xi++) {
            int bx = mx * mh + xi;
            if (by < c.hblocks && bx < c.wblocks) {
              coded_block(c, by, bx, blk);
            } else {                 // jccoefct.c dummy block: zero AC, DC of the block before
              int dcv = prev[0];
              std::memset(blk, 0, sizeof(blk));
              blk[0] = dcv;
            }
            encode_block(bw, blk, last_dc[ci], dc[c.tbl], ac[c.tbl]);
            std::memcpy(prev, blk, sizeof(blk));
          }
        }
      }
    }
  }
  bw.flush();
  put_marker(o, 0xD9);
  return o;
}

// ------------------------------------------------------------- the decoder

struct Error {
  std::string msg;
};

struct HuffDec {
  bool defined = false, built = false;
  uint8_t bits[17];
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t look[512];              // (size << 8) | value for codes of <= 9 bits; 0 = longer
};

// jdhuff.c jpeg_make_d_derived_tbl, with its checks: a table whose codes do
// not fit their lengths (over-subscribed) is refused.  Built, as libjpeg
// builds it, when a scan first uses it.
void build_dec(HuffDec& t) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < t.bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) throw Error{"bad Huffman table (over-subscribed code lengths)"};
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (t.bits[l]) {
      t.valoffset[l] = p - huffcode[p];
      p += t.bits[l];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof(t.look));
  p = 0;
  for (int l = 1; l <= 9; l++) {
    for (int i = 0; i < t.bits[l]; i++, p++) {
      int lookbits = huffcode[p] << (9 - l);
      if (lookbits + (1 << (9 - l)) > 512) throw Error{"bad Huffman table"};
      for (int c = 0; c < (1 << (9 - l)); c++) t.look[lookbits + c] = uint16_t((l << 8) | t.vals[p]);
    }
  }
}

// Entropy-coded data, 64 bits ahead.  At a marker it feeds zeros, as libjpeg
// does (corrupt data decodes with a warning there); at the end of the file it
// feeds zeros too but counts them, and a scan that needs them is truncated:
// PIL raises "image file is truncated" there.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0;
  int eof_bits = 0;                // zero bits fed past the end of the file, still in acc
  bool hit_marker = false;
  void fill() {
    while (nbits <= 56) {
      uint8_t b = 0;
      if (!hit_marker && pos + 1 < n && d[pos] == 0xFF && d[pos + 1] != 0x00) {
        hit_marker = true;           // a marker: feed zeros, as libjpeg does
      } else if (!hit_marker && pos < n && !(d[pos] == 0xFF && pos + 1 >= n)) {
        b = d[pos];
        pos += b == 0xFF ? 2 : 1;
      } else if (!hit_marker) {
        eof_bits += 8;
      }
      acc |= uint64_t(b) << (56 - nbits);
      nbits += 8;
    }
  }
  bool past_eof() const { return nbits < eof_bits; }
  int peek(int k) {
    if (nbits < k) fill();
    return int(acc >> (64 - k));
  }
  void skip(int k) {
    acc <<= k;
    nbits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    skip(k);
    return v;
  }
  void reset() {                   // byte-align at a restart marker
    acc = 0;
    nbits = 0;
    eof_bits = 0;
    hit_marker = false;
  }
};

int decode_sym(BitReader& br, const HuffDec& t) {
  int look = br.peek(9);
  int e = t.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int l = 10;
  int code = br.peek(l);
  while (l <= 16 && code > t.maxcode[l]) {
    l++;
    code = br.peek(l);
  }
  if (l > 16) throw Error{"corrupt Huffman data (code longer than 16 bits)"};
  br.skip(l);
  int idx = t.valoffset[l] + code;
  if (idx < 0 || idx > 255) throw Error{"corrupt Huffman data"};
  return t.vals[idx];
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct DecComp {
  int id, h, v, tq;
  int wblocks, hblocks;          // blocks with data
  int bw, bh;                    // allocated blocks (MCU multiple)
  int dw, dh;                    // downsampled_width / height
  std::vector<int16_t> coef;     // [bh * bw * 64]
};

struct Decoded {
  int w = 0, h = 0, c = 0;
  std::vector<uint8_t> px;
};

std::string hexoff(size_t off) {
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%zu", off);
  return buf;
}

std::string hexmark(int m) {
  char buf[8];
  std::snprintf(buf, sizeof(buf), "0xFF%02X", m);
  return buf;
}

// Pillow's Image.MAX_IMAGE_PIXELS doubled: past it PIL raises DecompressionBombError.
const int64_t kMaxPixels = 2 * int64_t(89478485);

const char* kRoadmap = " (ROADMAP A.12 lists what the port does not decode)";

// jpeg_natural_order with libjpeg's 16 extra entries: a corrupt run past
// position 63 writes coefficient 63, as libjpeg does.
int natural(int k) { return k < 64 ? kZigzag[k] : 63; }

// libjpeg-turbo's SAVED_COEFS: block smoothing looks at the first ten
// coefficients of a progressive file.
const int kSmoothCoefs = 10;

// libjpeg-turbo jdsample.c: fancy h2v1 on one row of dw samples.
void up_h2v1(const uint8_t* in, int dw, uint8_t* out) {
  if (dw <= 2) {
    for (int x = 0; x < dw; x++) out[2 * x] = out[2 * x + 1] = in[x];
    return;
  }
  out[0] = in[0];
  out[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
  for (int x = 1; x < dw - 1; x++) {
    int v = in[x] * 3;
    out[2 * x] = uint8_t((v + in[x - 1] + 1) >> 2);
    out[2 * x + 1] = uint8_t((v + in[x + 1] + 2) >> 2);
  }
  out[2 * dw - 2] = uint8_t((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
  out[2 * dw - 1] = in[dw - 1];
}

// fancy h2v2 on one output row: `near` is the nearer input row, `far` the row
// above (upper output row) or below (lower output row).
void up_h2v2_row(const uint8_t* nr, const uint8_t* fr, int dw, uint8_t* out) {
  int this_sum = nr[0] * 3 + fr[0];
  int next_sum = nr[1] * 3 + fr[1];
  out[0] = uint8_t((this_sum * 4 + 8) >> 4);
  out[1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 2; x < dw; x++) {
    next_sum = nr[x] * 3 + fr[x];
    out[2 * x - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x - 1] = uint8_t((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = uint8_t((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = uint8_t((this_sum * 4 + 7) >> 4);
}

Decoded decode(const uint8_t* d, size_t n) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Error{"not a JPEG file (no SOI marker)"};
  uint16_t qt[4][64] = {};
  bool qdef[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  std::vector<DecComp> comps;
  int W = 0, H = 0, hmax = 1, vmax = 1, restart = 0, mcux = 0, mcuy = 0;
  bool frame = false, adobe = false, jfif = false, any_scan = false, progressive = false;
  int adobe_transform = -1;
  std::vector<std::vector<int>> coef_bits;   // per component: the Al still owed, -1 = none yet
  size_t pos = 2;
  auto need = [&](size_t k, size_t at) {
    if (at + k > n) throw Error{"truncated JPEG file at offset " + hexoff(at)};
  };
  for (;;) {
    while (pos < n && d[pos] != 0xFF) pos++;  // skip garbage, as libjpeg does (with a warning)
    while (pos < n && d[pos] == 0xFF) pos++;  // fill bytes
    if (pos >= n)                             // no EOI: PIL raises "image file is truncated"
      throw Error{any_scan ? "truncated JPEG file (no EOI marker)" : "truncated JPEG file (no scan)"};
    int m = d[pos++];
    size_t moff = pos - 2;
    if (m == 0xD9) break;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    need(2, pos);
    int len = (d[pos] << 8) | d[pos + 1];
    if (len < 2) {                // libjpeg skips nothing of an APPn / COM that short
      if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
        pos += 2;
        continue;
      }
      throw Error{"bad marker length at offset " + hexoff(moff)};
    }
    need(len, pos);
    const uint8_t* seg = d + pos + 2;
    int slen = len - 2;
    size_t seg_end = pos + len;
    auto short_seg = [&]() {
      return Error{"short " + hexmark(m) + " segment at offset " + hexoff(moff)};
    };
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (frame) throw Error{"two SOF markers, second at offset " + hexoff(moff)};
      frame = true;
      progressive = m == 0xC2;
      if (slen < 6) throw short_seg();
      if (seg[0] != 8)
        throw Error{std::to_string(seg[0]) + "-bit JPEG (" + hexmark(m) + " at offset " +
                    hexoff(moff) + "): only 8-bit samples are decoded" + kRoadmap};
      H = (seg[1] << 8) | seg[2];
      W = (seg[3] << 8) | seg[4];
      int nc = seg[5];
      if (H == 0) throw Error{"JPEG with a DNL-defined height is not decoded"};
      if (W == 0) throw Error{"JPEG of width 0"};
      if (int64_t(W) * H > kMaxPixels)
        throw Error{"JPEG of " + std::to_string(int64_t(W) * H) + " pixels exceeds PIL's "
                    "decompression-bomb limit of " + std::to_string(kMaxPixels)};
      if (nc != 1 && nc != 3 && nc != 4)
        throw Error{std::to_string(nc) + "-component JPEG (" + hexmark(m) + " at offset " +
                    hexoff(moff) + "): PIL reads 1, 3 or 4 components"};
      if (slen < 6 + 3 * nc) throw short_seg();
      for (int i = 0; i < nc; i++) {
        DecComp c{};
        c.id = seg[6 + 3 * i];
        c.h = seg[7 + 3 * i] >> 4;
        c.v = seg[7 + 3 * i] & 15;
        c.tq = seg[8 + 3 * i] & 3;
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
          throw Error{"sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                      " (" + hexmark(m) + " at offset " + hexoff(moff) +
                      "): only factors 1-2 are decoded" + kRoadmap};
        comps.push_back(c);
        hmax = std::max(hmax, c.h);
        vmax = std::max(vmax, c.v);
      }
      if (nc == 1) comps[0].h = comps[0].v = hmax = vmax = 1;  // no subsampling alone
      mcux = ceil_div(W, hmax * 8);
      mcuy = ceil_div(H, vmax * 8);
      for (auto& c : comps) {
        c.wblocks = ceil_div(W * c.h, hmax * 8);
        c.hblocks = ceil_div(H * c.v, vmax * 8);
        c.dw = ceil_div(W * c.h, hmax);
        c.dh = ceil_div(H * c.v, vmax);
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        if (nc == 1) c.bw = c.wblocks, c.bh = c.hblocks;
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      coef_bits.assign(nc, std::vector<int>(64, -1));
    } else if (m == 0xC6 || m == 0xCA || m == 0xCE) {
      throw Error{"hierarchical or arithmetic-coded progressive JPEG (" + hexmark(m) +
                  " at offset " + hexoff(moff) + "): not decoded" + kRoadmap};
    } else if (m == 0xC3 || m == 0xC5 || m == 0xC7 || (m >= 0xC9 && m <= 0xCF) || m == 0xCC) {
      throw Error{"JPEG process " + hexmark(m) + " at offset " + hexoff(moff) +
                  " (lossless, hierarchical or arithmetic-coded) is not decoded" + kRoadmap};
    } else if (m == 0xDB) {
      int p = 0;
      while (p < slen) {
        int pq = seg[p] >> 4, tq = seg[p] & 15;
        if (tq > 3 || pq > 1) throw Error{"bad DQT table id at offset " + hexoff(moff)};
        if (p + 1 + 64 * (1 + pq) > slen) throw short_seg();
        p++;
        for (int k = 0; k < 64; k++) {
          int v = pq ? (seg[p + 2 * k] << 8) | seg[p + 2 * k + 1] : seg[p + k];
          qt[tq][kZigzag[k]] = uint16_t(v);
        }
        p += pq ? 128 : 64;
        qdef[tq] = true;
      }
    } else if (m == 0xC4) {
      int p = 0;
      while (p < slen) {
        int tc = seg[p] >> 4, th = seg[p] & 15;
        if (th > 3 || tc > 1) throw Error{"bad DHT table id at offset " + hexoff(moff)};
        if (p + 17 > slen) throw short_seg();
        HuffDec& t = tc ? ac[th] : dc[th];
        t.defined = false;
        t.bits[0] = 0;
        int cnt = 0;
        for (int l = 1; l <= 16; l++) {
          t.bits[l] = seg[p + l];
          cnt += t.bits[l];
        }
        if (cnt > 256) throw Error{"bad DHT table at offset " + hexoff(moff)};
        if (p + 17 + cnt > slen) throw short_seg();
        std::memcpy(t.vals, seg + p + 17, cnt);
        t.defined = true;
        t.built = false;
        p += 17 + cnt;
      }
    } else if (m == 0xDD) {
      if (slen < 2) throw short_seg();
      restart = (seg[0] << 8) | seg[1];
    } else if (m == 0xE0) {
      if (slen >= 14 && std::memcmp(seg, "JFIF", 5) == 0) jfif = true;
    } else if (m == 0xEE) {
      if (slen >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
        adobe = true;
        adobe_transform = seg[11];
      }
    } else if (m == 0xDC) {
      throw Error{"DNL marker at offset " + hexoff(moff) + " is not decoded"};
    } else if (m == 0xDA) {
      if (!frame) throw Error{"SOS before SOF at offset " + hexoff(moff)};
      if (slen < 1) throw short_seg();
      int ns = seg[0];
      if (ns < 1 || ns > 4 || ns > int(comps.size()))
        throw Error{"bad component count " + std::to_string(ns) + " in SOS at offset " +
                    hexoff(moff)};
      if (slen < 4 + 2 * ns) throw short_seg();
      int ss = seg[1 + 2 * ns], se = seg[2 + 2 * ns], ah = seg[3 + 2 * ns] >> 4,
          al = seg[3 + 2 * ns] & 15;
      if (!progressive && (ss != 0 || se != 63 || ah != 0 || al != 0))
        throw Error{"a scan with spectral selection or successive approximation at offset " +
                    hexoff(moff) + " in a sequential JPEG"};
      // jdinput.c / jdphuff.c's checks of a progressive scan's parameters
      if (progressive && (ss > se || se > 63 || al > 13 || (ah != 0 && ah != al + 1) ||
                          (ss == 0 && se != 0) || (ss != 0 && ns != 1)))
        throw Error{"bad progressive scan parameters Ss=" + std::to_string(ss) + " Se=" +
                    std::to_string(se) + " Ah=" + std::to_string(ah) + " Al=" +
                    std::to_string(al) + " at offset " + hexoff(moff)};
      bool need_dc = !progressive || (ss == 0 && ah == 0), need_ac = !progressive || ss != 0;
      std::vector<int> sc;
      std::vector<int> td, ta;
      for (int i = 0; i < ns; i++) {
        int cid = seg[1 + 2 * i], tb = seg[2 + 2 * i];
        int ci = -1;
        for (size_t k = 0; k < comps.size(); k++)
          if (comps[k].id == cid) ci = int(k);
        if (ci < 0) throw Error{"SOS names an unknown component at offset " + hexoff(moff)};
        sc.push_back(ci);
        td.push_back(tb >> 4);
        ta.push_back(tb & 15);
        if (td.back() > 3 || ta.back() > 3 || (need_dc && !dc[td.back()].defined) ||
            (need_ac && !ac[ta.back()].defined))
          throw Error{"SOS uses an undefined Huffman table at offset " + hexoff(moff)};
        if (!qdef[comps[ci].tq]) throw Error{"a component's quantization table is undefined"};
        for (HuffDec* t : {need_dc ? &dc[td.back()] : nullptr, need_ac ? &ac[ta.back()] : nullptr}) {
          if (t && !t->built) build_dec(*t);
          if (t) t->built = true;
        }
        if (progressive)
          for (int k = ss; k <= se; k++) coef_bits[ci][k] = al;
      }
      BitReader br{d, n, seg_end};
      std::vector<int64_t> pred(ns, 0);
      int nmcu_x, nmcu_y;
      if (ns == 1) {
        nmcu_x = comps[sc[0]].wblocks;
        nmcu_y = comps[sc[0]].hblocks;
      } else {
        nmcu_x = mcux;
        nmcu_y = mcuy;
      }
      long count = 0;
      int next_rst = 0;
      uint32_t eobrun = 0;
      const int p1 = 1 << al, m1 = -(1 << al);
      // jdphuff.c: one block of a progressive scan, in place
      auto prog_block = [&](int16_t* blk, int k) {
        if (ss == 0) {
          if (ah == 0) {                       // DC first
            int s = decode_sym(br, dc[td[k]]);
            if (s > 11) throw Error{"corrupt DC coefficient"};
            int diff = s ? extend(br.get(s), s) : 0;
            pred[k] += diff;
            blk[0] = int16_t(uint32_t(pred[k]) << al);
          } else if (br.get(1)) {              // DC refine
            blk[0] = int16_t(blk[0] | p1);
          }
          return;
        }
        const HuffDec& t = ac[ta[k]];
        if (ah == 0) {                         // AC first
          if (eobrun > 0) {
            eobrun--;
            return;
          }
          for (int kk = ss; kk <= se; kk++) {
            int rs = decode_sym(br, t);
            int r = rs >> 4, sz = rs & 15;
            if (sz) {
              kk += r;
              blk[natural(kk)] = int16_t(uint32_t(extend(br.get(sz), sz)) << al);
            } else if (r == 15) {
              kk += 15;
            } else {
              eobrun = 1u << r;
              if (r) eobrun += br.get(r);
              eobrun--;
              break;
            }
          }
          return;
        }
        int kk = ss;                           // AC refine
        auto refine = [&](int16_t& c) {
          if (br.get(1) && (c & p1) == 0) c = int16_t(c >= 0 ? c + p1 : c + m1);
        };
        if (eobrun == 0) {
          for (; kk <= se; kk++) {
            int rs = decode_sym(br, t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = br.get(1) ? p1 : m1;         // a size other than 1 is corrupt: libjpeg goes on
            } else if (r != 15) {
              eobrun = 1u << r;
              if (r) eobrun += br.get(r);
              break;
            }
            do {
              int16_t& c = blk[natural(kk)];
              if (c != 0) {
                refine(c);
              } else if (--r < 0) {
                break;
              }
              kk++;
            } while (kk <= se);
            if (s) blk[natural(kk)] = int16_t(s);
          }
        }
        if (eobrun > 0) {
          for (; kk <= se; kk++) {
            int16_t& c = blk[natural(kk)];
            if (c != 0) refine(c);
          }
          eobrun--;
        }
      };
      for (int my = 0; my < nmcu_y; my++) {
        for (int mx = 0; mx < nmcu_x; mx++) {
          if (restart && count > 0 && count % restart == 0) {
            if (br.past_eof()) throw Error{"truncated JPEG file (scan data ends early)"};
            br.reset();
            size_t p = br.pos;
            while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0 && d[p + 1] != 0xFF)) p++;
            if (p + 1 < n && d[p + 1] == 0xD0 + next_rst) {
              br.pos = p + 2;
            } else {
              br.pos = p;              // a missing restart marker: resync where we are
            }
            next_rst = (next_rst + 1) & 7;
            std::fill(pred.begin(), pred.end(), 0);
            eobrun = 0;
          }
          if (progressive) {
            for (int k = 0; k < ns; k++) {
              DecComp& c = comps[sc[k]];
              int mh = ns == 1 ? 1 : c.h, mv = ns == 1 ? 1 : c.v;
              for (int yi = 0; yi < mv; yi++)
                for (int xi = 0; xi < mh; xi++) {
                  int by = my * mv + yi, bx = mx * mh + xi;
                  int16_t tmp[64] = {};
                  prog_block((by < c.bh && bx < c.bw) ? &c.coef[(size_t(by) * c.bw + bx) * 64]
                                                       : tmp, k);
                }
            }
            count++;
            continue;
          }
          for (int k = 0; k < ns; k++) {
            DecComp& c = comps[sc[k]];
            int mh = ns == 1 ? 1 : c.h, mv = ns == 1 ? 1 : c.v;
            for (int yi = 0; yi < mv; yi++) {
              for (int xi = 0; xi < mh; xi++) {
                int by = my * mv + yi, bx = mx * mh + xi;
                int16_t tmp[64];
                int16_t* blk = (by < c.bh && bx < c.bw) ? &c.coef[(size_t(by) * c.bw + bx) * 64] : tmp;
                std::memset(blk, 0, 64 * sizeof(int16_t));
                int s = decode_sym(br, dc[td[k]]);
                if (s > 11) throw Error{"corrupt DC coefficient"};
                int diff = s ? extend(br.get(s), s) : 0;
                pred[k] += diff;
                blk[0] = int16_t(pred[k]);
                for (int kk = 1; kk < 64;) {
                  int rs = decode_sym(br, ac[ta[k]]);
                  int r = rs >> 4, sz = rs & 15;
                  if (sz) {
                    kk += r;
                    if (kk > 63) throw Error{"corrupt AC run"};
                    blk[kZigzag[kk]] = int16_t(extend(br.get(sz), sz));
                    kk++;
                  } else {
                    if (r != 15) break;
                    kk += 16;
                  }
                }
              }
            }
          }
          count++;
        }
      }
      if (br.past_eof()) throw Error{"truncated JPEG file (scan data ends early)"};
      // continue after the entropy-coded segment: find the next marker
      size_t p = br.pos;
      while (p + 1 < n && !(d[p] == 0xFF && d[p + 1] != 0 && !(d[p + 1] >= 0xD0 && d[p + 1] <= 0xD7)))
        p++;
      any_scan = true;
      pos = p;
      continue;
    }
    pos = seg_end;
  }
  if (!frame || !any_scan) throw Error{"JPEG without a frame or a scan"};
  if (progressive) {
    // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
    // file whose first coefficients are known only in part
    for (size_t ci = 0; ci < comps.size(); ci++) {
      if (coef_bits[ci][0] < 0) continue;
      for (int k = 1; k < kSmoothCoefs; k++)
        if (coef_bits[ci][k] != 0)
          throw Error{"progressive JPEG whose scans leave coefficient " + std::to_string(k) +
                      " of component " + std::to_string(ci) + " incomplete: libjpeg's block "
                      "smoothing is not implemented" + kRoadmap};
    }
  }
  // jdapimin.c default_decompress_parms: the colour space of the components
  bool rgb = false, ycck = false;
  if (comps.size() == 3 && !jfif) {
    if (adobe)
      rgb = adobe_transform == 0;
    else
      rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
  if (comps.size() == 4) ycck = adobe && adobe_transform != 0;

  // inverse DCT into each component's plane
  std::vector<std::vector<uint8_t>> planes(comps.size());
  for (size_t ci = 0; ci < comps.size(); ci++) {
    DecComp& c = comps[ci];
    int pw = c.bw * 8;
    planes[ci].assign(size_t(pw) * c.bh * 8, 0);
    for (int by = 0; by < c.hblocks; by++)
      for (int bx = 0; bx < c.wblocks; bx++)
        idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], qt[c.tq],
                   &planes[ci][size_t(by) * 8 * pw + bx * 8], pw);
  }
  Decoded out;
  out.w = W;
  out.h = H;
  out.c = int(comps.size());
  out.px.resize(size_t(W) * H * out.c);
  if (comps.size() == 1) {
    int pw = comps[0].bw * 8;
    for (int y = 0; y < H; y++) std::memcpy(&out.px[size_t(y) * W], &planes[0][size_t(y) * pw], W);
    return out;
  }
  // upsample each component to full size [H, W]
  int nc = int(comps.size());
  std::vector<std::vector<uint8_t>> fullp(nc);
  for (int ci = 0; ci < nc; ci++) {
    DecComp& c = comps[ci];
    int pw = c.bw * 8;
    int rh = hmax / c.h, rv = vmax / c.v;
    if (hmax % c.h || vmax % c.v) throw Error{"unsupported sampling-factor ratio"};
    auto& f = fullp[ci];
    int ow = c.dw * rh;
    f.assign(size_t(ow) * (c.dh * rv), 0);
    const uint8_t* pl = planes[ci].data();
    auto row = [&](int y) { return pl + size_t(y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y)) * pw; };
    bool fancy = c.dw > 2;
    for (int y = 0; y < c.dh; y++) {
      if (rh == 1 && rv == 1) {
        std::memcpy(&f[size_t(y) * ow], row(y), ow);
      } else if (rh == 2 && rv == 1) {
        if (fancy) up_h2v1(row(y), c.dw, &f[size_t(y) * ow]);
        else for (int x = 0; x < c.dw; x++) f[size_t(y) * ow + 2 * x] = f[size_t(y) * ow + 2 * x + 1] = row(y)[x];
      } else if (rh == 1 && rv == 2) {   // h1v2_fancy_upsample (always fancy)
        uint8_t* o0 = &f[size_t(2 * y) * ow];
        uint8_t* o1 = &f[size_t(2 * y + 1) * ow];
        const uint8_t *nr = row(y), *up = row(y - 1), *dn = row(y + 1);
        for (int x = 0; x < c.dw; x++) {
          o0[x] = uint8_t((nr[x] * 3 + up[x] + 1) >> 2);
          o1[x] = uint8_t((nr[x] * 3 + dn[x] + 2) >> 2);
        }
      } else {
        uint8_t* o0 = &f[size_t(2 * y) * ow];
        uint8_t* o1 = &f[size_t(2 * y + 1) * ow];
        if (fancy) {
          up_h2v2_row(row(y), row(y - 1), c.dw, o0);
          up_h2v2_row(row(y), row(y + 1), c.dw, o1);
        } else {
          for (int x = 0; x < c.dw; x++) o0[2 * x] = o0[2 * x + 1] = o1[2 * x] = o1[2 * x + 1] = row(y)[x];
        }
      }
    }
    // rearrange to stride W (output width >= W)
    if (ow != W) {
      std::vector<uint8_t> g(size_t(W) * H);
      for (int y = 0; y < H; y++) std::memcpy(&g[size_t(y) * W], &f[size_t(y) * ow], W);
      f.swap(g);
    }
  }
  size_t npx = size_t(W) * H;
  if (rgb) {                       // jdcolor.c rgb_rgb_convert
    for (size_t i = 0; i < npx; i++)
      for (int c = 0; c < 3; c++) out.px[3 * i + c] = fullp[c][i];
    return out;
  }
  if (nc == 4 && !ycck) {          // CMYK as it is, inverted as PIL's "CMYK;I"
    for (size_t i = 0; i < npx; i++)
      for (int c = 0; c < 4; c++) out.px[4 * i + c] = uint8_t(255 - fullp[c][i]);
    return out;
  }
  // jdcolor.c ycc_rgb_convert (and ycck_cmyk_convert: 255 - RGB, K as it is)
  int crr[256], cbb[256];
  int64_t crg[256], cbg[256];
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  for (int i = 0, x = -128; i < 256; i++, x++) {
    crr[i] = int((fix(1.40200) * x + (int64_t(1) << 15)) >> 16);
    cbb[i] = int((fix(1.77200) * x + (int64_t(1) << 15)) >> 16);
    crg[i] = -fix(0.71414) * x;
    cbg[i] = -fix(0.34414) * x + (int64_t(1) << 15);
  }
  auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
  for (size_t i = 0; i < npx; i++) {
    int y = fullp[0][i], cb = fullp[1][i], cr = fullp[2][i];
    int r = y + crr[cr], g = y + int((cbg[cb] + crg[cr]) >> 16), b = y + cbb[cb];
    if (nc == 3) {
      out.px[3 * i] = clamp(r);
      out.px[3 * i + 1] = clamp(g);
      out.px[3 * i + 2] = clamp(b);
    } else {                       // YCCK -> CMYK, then PIL's inversion
      out.px[4 * i] = uint8_t(255 - clamp(255 - r));
      out.px[4 * i + 1] = uint8_t(255 - clamp(255 - g));
      out.px[4 * i + 2] = uint8_t(255 - clamp(255 - b));
      out.px[4 * i + 3] = uint8_t(255 - fullp[3][i]);
    }
  }
  return out;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, size_t(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

// Encode [height, width, channels] uint8 (channels 1 or 3) at `quality`,
// 4:2:0 for RGB.  On success *out holds malloc'd bytes (free with
// jpeg_free) and 0 returns.
int jpeg_encode(const uint8_t* pixels, int width, int height, int channels, int quality,
                uint8_t** out, size_t* out_len, char* err, int errlen) {
  try {
    if (width <= 0 || height <= 0 || width > 65500 || height > 65500)
      throw Error{"image size out of range for JPEG"};
    if (channels != 1 && channels != 3) throw Error{"JPEG encodes 1 or 3 channels"};
    std::vector<uint8_t> bytes = encode(pixels, width, height, channels, quality);
    *out = static_cast<uint8_t*>(std::malloc(bytes.size()));
    if (!*out) throw Error{"out of memory"};
    std::memcpy(*out, bytes.data(), bytes.size());
    *out_len = bytes.size();
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "JPEG encoder failed");
  }
  return 1;
}

// Decode a file's bytes; on success *out holds malloc'd [h, w, c] pixels
// (free with jpeg_free), c is 1 (greyscale), 3 (RGB) or 4 (CMYK, inverted as
// PIL reads it), and 0 returns.
int jpeg_decode(const uint8_t* data, size_t len, uint8_t** out, int* width, int* height,
                int* channels, char* err, int errlen) {
  try {
    Decoded dd = decode(data, len);
    *out = static_cast<uint8_t*>(std::malloc(dd.px.size()));
    if (!*out) throw Error{"out of memory"};
    std::memcpy(*out, dd.px.data(), dd.px.size());
    *width = dd.w;
    *height = dd.h;
    *channels = dd.c;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "JPEG decoder failed");
  }
  return 1;
}

void jpeg_free(void* p) { std::free(p); }

}  // extern "C"
