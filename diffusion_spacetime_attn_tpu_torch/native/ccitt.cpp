// CCITT bilevel decoders for TIFF (ITU-T T.4 and T.6), following libtiff
// 4.7's tif_fax3.c: modified Huffman (TIFF compression 2: rows byte-aligned,
// no EOL codes), Group 3 (compression 3: an EOL before every row, 1-D or, with
// T4Options bit 0, a tag bit choosing 1-D or 2-D coding per row; fill bits
// before an EOL) and Group 4 (compression 4: every row 2-D against the row
// above, the first against an all-white row).
//
// Bits are read most significant first: a file of fill order 2 is
// bit-reversed by the caller first.  Every row decodes to (width + 7) / 8
// bytes, white 0 and black 1 (the runs as coded; the photometric
// interpretation is the caller's), the padding bits 0, as libtiff's fill.
// Where libtiff warns and pads (a row whose runs do not sum to the width, a
// code no table holds, uncompressed mode, data that ends early) this decoder
// stops with an error instead: it never writes a row libtiff would not.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// (run length, code bits as a string) of T.4's tables
struct Code {
  int run;
  const char* bits;
};

const Code kWhite[] = {
    {0, "00110101"}, {1, "000111"}, {2, "0111"}, {3, "1000"}, {4, "1011"}, {5, "1100"},
    {6, "1110"}, {7, "1111"}, {8, "10011"}, {9, "10100"}, {10, "00111"}, {11, "01000"},
    {12, "001000"}, {13, "000011"}, {14, "110100"}, {15, "110101"}, {16, "101010"},
    {17, "101011"}, {18, "0100111"}, {19, "0001100"}, {20, "0001000"}, {21, "0010111"},
    {22, "0000011"}, {23, "0000100"}, {24, "0101000"}, {25, "0101011"}, {26, "0010011"},
    {27, "0100100"}, {28, "0011000"}, {29, "00000010"}, {30, "00000011"}, {31, "00011010"},
    {32, "00011011"}, {33, "00010010"}, {34, "00010011"}, {35, "00010100"}, {36, "00010101"},
    {37, "00010110"}, {38, "00010111"}, {39, "00101000"}, {40, "00101001"}, {41, "00101010"},
    {42, "00101011"}, {43, "00101100"}, {44, "00101101"}, {45, "00000100"}, {46, "00000101"},
    {47, "00001010"}, {48, "00001011"}, {49, "01010010"}, {50, "01010011"}, {51, "01010100"},
    {52, "01010101"}, {53, "00100100"}, {54, "00100101"}, {55, "01011000"}, {56, "01011001"},
    {57, "01011010"}, {58, "01011011"}, {59, "01001010"}, {60, "01001011"}, {61, "00110010"},
    {62, "00110011"}, {63, "00110100"},
    {64, "11011"}, {128, "10010"}, {192, "010111"}, {256, "0110111"}, {320, "00110110"},
    {384, "00110111"}, {448, "01100100"}, {512, "01100101"}, {576, "01101000"},
    {640, "01100111"}, {704, "011001100"}, {768, "011001101"}, {832, "011010010"},
    {896, "011010011"}, {960, "011010100"}, {1024, "011010101"}, {1088, "011010110"},
    {1152, "011010111"}, {1216, "011011000"}, {1280, "011011001"}, {1344, "011011010"},
    {1408, "011011011"}, {1472, "010011000"}, {1536, "010011001"}, {1600, "010011010"},
    {1664, "011000"}, {1728, "010011011"}};

const Code kBlack[] = {
    {0, "0000110111"}, {1, "010"}, {2, "11"}, {3, "10"}, {4, "011"}, {5, "0011"},
    {6, "0010"}, {7, "00011"}, {8, "000101"}, {9, "000100"}, {10, "0000100"},
    {11, "0000101"}, {12, "0000111"}, {13, "00000100"}, {14, "00000111"}, {15, "000011000"},
    {16, "0000010111"}, {17, "0000011000"}, {18, "0000001000"}, {19, "00001100111"},
    {20, "00001101000"}, {21, "00001101100"}, {22, "00000110111"}, {23, "00000101000"},
    {24, "00000010111"}, {25, "00000011000"}, {26, "000011001010"}, {27, "000011001011"},
    {28, "000011001100"}, {29, "000011001101"}, {30, "000001101000"}, {31, "000001101001"},
    {32, "000001101010"}, {33, "000001101011"}, {34, "000011010010"}, {35, "000011010011"},
    {36, "000011010100"}, {37, "000011010101"}, {38, "000011010110"}, {39, "000011010111"},
    {40, "000001101100"}, {41, "000001101101"}, {42, "000011011010"}, {43, "000011011011"},
    {44, "000001010100"}, {45, "000001010101"}, {46, "000001010110"}, {47, "000001010111"},
    {48, "000001100100"}, {49, "000001100101"}, {50, "000001010010"}, {51, "000001010011"},
    {52, "000000100100"}, {53, "000000110111"}, {54, "000000111000"}, {55, "000000100111"},
    {56, "000000101000"}, {57, "000001011000"}, {58, "000001011001"}, {59, "000000101011"},
    {60, "000000101100"}, {61, "000001011010"}, {62, "000001100110"}, {63, "000001100111"},
    {64, "0000001111"}, {128, "000011001000"}, {192, "000011001001"}, {256, "000001011011"},
    {320, "000000110011"}, {384, "000000110100"}, {448, "000000110101"},
    {512, "0000001101100"}, {576, "0000001101101"}, {640, "0000001001010"},
    {704, "0000001001011"}, {768, "0000001001100"}, {832, "0000001001101"},
    {896, "0000001110010"}, {960, "0000001110011"}, {1024, "0000001110100"},
    {1088, "0000001110101"}, {1152, "0000001110110"}, {1216, "0000001110111"},
    {1280, "0000001010010"}, {1344, "0000001010011"}, {1408, "0000001010100"},
    {1472, "0000001010101"}, {1536, "0000001011010"}, {1600, "0000001011011"},
    {1664, "0000001100100"}, {1728, "0000001100101"}};

// extended make-up codes, shared by both colours
const Code kExtended[] = {
    {1792, "00000001000"}, {1856, "00000001100"}, {1920, "00000001101"},
    {1984, "000000010010"}, {2048, "000000010011"}, {2112, "000000010100"},
    {2176, "000000010101"}, {2240, "000000010110"}, {2304, "000000010111"},
    {2368, "000000011100"}, {2432, "000000011101"}, {2496, "000000011110"},
    {2560, "000000011111"}};

// 2-D modes (T.4 table 4): vertical offsets -3..3, pass, horizontal, the
// extension (uncompressed mode) and EOL
enum Mode { kV0 = 3, kPass = 10, kHoriz = 11, kExt = 12, kEol = 13 };
const Code kModes[] = {
    {kV0, "1"}, {kV0 + 1, "011"}, {kV0 - 1, "010"}, {kV0 + 2, "000011"}, {kV0 - 2, "000010"},
    {kV0 + 3, "0000011"}, {kV0 - 3, "0000010"}, {kPass, "0001"}, {kHoriz, "001"},
    {kExt, "0000001"}, {kEol, "000000000001"}};

constexpr int kPeek = 13;        // the longest code
constexpr int kEolRun = -1;      // table value of the EOL code
constexpr int kNone = -2;        // no code starts with these bits

// a table indexed by the next 13 bits: (code length << 16) | (value + 2)
struct Table {
  std::vector<uint32_t> e;
  Table() : e(1u << kPeek, 0) {}
  void add(int value, const char* bits) {
    int len = int(std::strlen(bits));
    uint32_t code = 0;
    for (int i = 0; i < len; i++) code = (code << 1) | uint32_t(bits[i] - '0');
    uint32_t first = code << (kPeek - len), n = 1u << (kPeek - len);
    for (uint32_t i = 0; i < n; i++) e[first + i] = (uint32_t(len) << 16) | uint32_t(value + 2);
  }
};

struct Tables {
  Table white, black, modes;
  Tables() {
    for (const Code& c : kWhite) white.add(c.run, c.bits);
    for (const Code& c : kBlack) black.add(c.run, c.bits);
    for (const Code& c : kExtended) {
      white.add(c.run, c.bits);
      black.add(c.run, c.bits);
    }
    white.add(kEolRun, "000000000001");
    black.add(kEolRun, "000000000001");
    for (const Code& c : kModes) modes.add(c.run, c.bits);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Fail {
  char msg[200];
};

[[noreturn]] void fail(const char* fmt, long a = 0, long b = 0) {
  Fail f;
  std::snprintf(f.msg, sizeof(f.msg), fmt, a, b);
  throw f;
}

class Bits {
 public:
  Bits(const uint8_t* p, size_t n) : p_(p), n_(n) {}
  // the next 13 bits (zeros past the end) without consuming them
  uint32_t peek() const {
    uint32_t v = 0;
    size_t byte = pos_ >> 3;
    for (int i = 0; i < 3; i++) v = (v << 8) | (byte + i < n_ ? p_[byte + i] : 0u);
    return (v >> (24 - kPeek - int(pos_ & 7))) & ((1u << kPeek) - 1);
  }
  size_t left() const { return n_ * 8 - pos_; }
  void skip(size_t k) {
    if (k > left()) fail("CCITT data ends inside a code");
    pos_ += k;
  }
  int bit() {
    if (!left()) fail("CCITT data ends early");
    int b = (p_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    pos_++;
    return b;
  }
  void align() {
    size_t at = (pos_ + 7) & ~size_t(7);
    pos_ = at < n_ * 8 ? at : n_ * 8;
  }
  // an EOL: fill bits (zeros), at least eleven zeros in all, then a one
  void eol() {
    int zeros = 0;
    while (bit() == 0) zeros++;
    if (zeros < 11) fail("CCITT Group 3 row without an EOL code");
  }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
};

// one code of `t`: its value (a run length, a mode, kEolRun)
int code(Bits& in, const Table& t) {
  if (!in.left()) fail("CCITT data ends early");
  uint32_t e = t.e[in.peek()];
  int value = int(e & 0xffff) - 2;
  if (value == kNone) fail("CCITT data holds a code no table has");
  in.skip(e >> 16);
  return value;
}

// a run of one colour: make-up codes (any number) then one terminating code
int run(Bits& in, bool black) {
  const Table& t = black ? tables().black : tables().white;
  int total = 0;
  for (;;) {
    int v = code(in, t);
    if (v == kEolRun) fail("CCITT row ends with an EOL code inside it");
    total += v;
    if (total > (1 << 24)) fail("CCITT run longer than any row");
    if (v < 64) return total;
  }
}

// A row as the positions where the colour changes, white first: white runs
// to change[0], black to change[1], ... and `width` twice at the end.
using Changes = std::vector<int>;

void row_1d(Bits& in, int width, Changes& out) {
  out.clear();
  int a0 = 0;
  bool black = false;
  while (a0 < width) {
    a0 += run(in, black);
    if (a0 > width) fail("CCITT row of %ld pixels is %ld wide", a0, width);
    out.push_back(a0);
    black = !black;
  }
}

void row_2d(Bits& in, int width, const Changes& ref, Changes& out) {
  out.clear();
  int a0 = -1;                     // before the row's first pixel
  bool black = false;
  size_t lo = 0;                   // the reference's first change right of a0
  while (a0 < width) {
    // b1: the first change on the reference row right of a0 to the colour
    // opposite a0's (even changes start black), b2 the next; `ref` ends
    // with `width` twice, so both exist
    while (ref[lo] <= a0) lo++;
    size_t i = lo + ((lo & 1) != size_t(black));
    int b1 = ref[i];
    int b2 = i + 1 < ref.size() ? ref[i + 1] : width;
    int m = code(in, tables().modes);
    if (m == kPass) {
      if (b2 >= width) fail("CCITT pass mode past the row's end");
      a0 = b2;                     // a0's colour runs on below b2
    } else if (m == kHoriz) {
      int a1 = (a0 < 0 ? 0 : a0) + run(in, black);
      int a2 = a1 + run(in, !black);
      if (a2 > width) fail("CCITT row of %ld pixels is %ld wide", a2, width);
      out.push_back(a1);
      out.push_back(a2);
      a0 = a2;
    } else if (m == kExt) {
      fail("CCITT uncompressed mode is not read (libtiff refuses it)");
    } else if (m == kEol) {
      fail("CCITT row ends with an EOL code inside it");
    } else {
      int a1 = b1 + (m - kV0);
      if (a1 <= a0 || a1 < 0 || a1 > width)
        fail("CCITT vertical mode to %ld, outside the row of %ld", a1, width);
      out.push_back(a1);
      a0 = a1;
      black = !black;
    }
  }
}

void fill(const Changes& c, int width, uint8_t* row) {
  std::memset(row, 0, size_t(width + 7) / 8);
  int x = 0;
  for (size_t k = 0; k < c.size(); k++) {
    int end = c[k] < width ? c[k] : width;
    if (k & 1) {
      for (int p = x; p < end; p++) row[p >> 3] |= uint8_t(0x80 >> (p & 7));
    }
    x = end;
  }
}

void set_error(char* err, int errlen, const char* msg) {
  if (errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

// coding: 2 (modified Huffman), 3 (Group 3; options = T4Options), 4 (Group
// 4; options = T6Options).  Decodes `rows` rows of `width` pixels into
// `out` (rows * ((width + 7) / 8) bytes).  Returns 0, or 1 with `err` set.
extern "C" int ccitt_decode(int coding, int options, const uint8_t* src, size_t n, int width,
                            int rows, uint8_t* out, char* err, int errlen) {
  try {
    if (width <= 0 || rows <= 0) fail("CCITT image of %ldx%ld pixels", width, rows);
    if (coding == 3 && (options & 2)) fail("CCITT Group 3 uncompressed mode is not read");
    if (coding == 4 && (options & 2)) fail("CCITT Group 4 uncompressed mode is not read");
    if (coding < 2 || coding > 4) fail("CCITT coding %ld", coding);
    const size_t stride = size_t(width + 7) / 8;
    Bits in(src, n);
    Changes ref{width, width}, cur;
    for (int y = 0; y < rows; y++) {
      if (coding == 2) {
        row_1d(in, width, cur);
        in.align();
      } else if (coding == 3) {
        in.eol();
        if ((options & 1) && in.bit() == 0) {
          row_2d(in, width, ref, cur);
        } else {
          row_1d(in, width, cur);
        }
      } else {
        row_2d(in, width, ref, cur);
      }
      fill(cur, width, out + size_t(y) * stride);
      ref = cur;
      ref.push_back(width);
      ref.push_back(width);
    }
    return 0;
  } catch (const Fail& f) {
    set_error(err, errlen, f.msg);
    return 1;
  } catch (...) {
    set_error(err, errlen, "CCITT decoder out of memory");
    return 1;
  }
}
