// The LZW and PackBits decoders of the port's GIF and TIFF readers, with a
// plain C interface bound with ctypes by utils/lzw.py:
//
//   gif_lzw_decode:  GIF's variable-length LZW (codes LSB first, 3-12 bits,
//                    clear and end codes, deferred clear) over the image
//                    descriptor's sub-blocks, written straight into the
//                    frame's rectangle of a canvas, rows in file order or in
//                    the four interlaced passes, as Pillow's GifDecode.c
//                    writes them.  Data that ends, or an end code that comes,
//                    before every pixel is written is refused (Pillow raises
//                    "image file is truncated" there); so is a code past the
//                    table's next free entry.
//   tiff_unpack:     TIFF's LZW (codes MSB first, 9-12 bits, the early
//                    change of libtiff's LZWDecode) and PackBits (TIFF
//                    compression 32773), into a buffer of the strip's or
//                    tile's expected size.  Old-style (LSB first) LZW data
//                    and codes past the next free entry are refused.
//   thunder_decode:  ThunderScan 4-bit (TIFF compression 32809) as libtiff's
//                    tif_thunder.c decodes it row by row: runs of the last
//                    pixel, 2- and 3-bit deltas, raw pixels.  A row that ends
//                    with too few or too many pixels is refused, as libtiff
//                    refuses it, and so is a run that ends exactly at the
//                    row's end (libtiff leaves that run's pixels unwritten).
//   packbits_rows:   PackBits as Pillow's PackDecode.c decodes a PSD
//                    channel: rows of a fixed size filled in turn, a packet
//                    that crosses a row's end cut there, a packet read only
//                    when all of its bytes are there.
//
// and the byte-run loops of the raster formats Pillow decodes itself, each
// writing rows in file order (the caller flips them):
//
//   tga_rle:         Targa RLE (TgaRleDecode.c): runs and literal packets of
//                    1-4 byte pixels; a run may not cross a row's end, a
//                    literal packet may.
//   pcx_rle:         PCX RLE (PcxDecode.c): 0xC0 | n runs and literal bytes,
//                    rows of the header's stride; a run past the row's end
//                    is an error.
//   sgi_rle:         SGI RLE (SgiRleDecode.c): each row of each channel from
//                    the start and length tables, 8- or 16-bit packets, one
//                    row buffer kept from row to row as Pillow keeps it.
//   sun_rle:         Sun raster RLE (SunRleDecode.c): 0x80 n v runs of n + 1
//                    bytes (a run may cross rows), 0x80 0x00 for a literal
//                    0x80.
//   qoi_decode:      QOI's op stream (QoiImagePlugin.QoiDecoder) into RGB or
//                    RGBA pixels.
//
// Every decoder reads and writes only inside the buffers it is given.
//
// Build: g++ -O2 -fPIC -std=c++17 -shared -o liblzw.so lzw.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

// The LZW string table: entry i is prefix[i] followed by suffix[i]; first[i]
// is its first byte and len[i] its length.
struct Table {
  uint16_t prefix[4096];
  uint8_t suffix[4096], first[4096];
  uint16_t len[4096];
  void init(int literals) {
    for (int i = 0; i < literals; i++) {
      prefix[i] = 0xFFFF;
      suffix[i] = first[i] = uint8_t(i);
      len[i] = 1;
    }
  }
  // write entry `code` into out[0 .. len[code])
  void emit(int code, uint8_t* out) const {
    for (int k = len[code] - 1; k >= 0; k--) {
      out[k] = suffix[code];
      code = prefix[code];
    }
  }
};

void gif_decode(const uint8_t* d, size_t n, int bits, int fw, int fh, int interlace,
                uint8_t* canvas, int stride) {
  if (bits < 1 || bits > 11) throw Error{"bad LZW minimum code size " + std::to_string(bits)};
  if (fw <= 0 || fh <= 0) throw Error{"GIF frame of no pixels"};
  Table t;
  const int clear = 1 << bits, end = clear + 1;
  t.init(clear);
  int size = bits + 1, next = clear + 2, last = -1;
  size_t pos = 0, block_left = 0;
  uint32_t acc = 0;
  int nbits = 0;
  // the rows in the order they are written: file order or the four passes
  std::vector<int> rows;
  if (interlace) {
    const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; p++)
      for (int y = start[p]; y < fh; y += step[p]) rows.push_back(y);
  } else {
    for (int y = 0; y < fh; y++) rows.push_back(y);
  }
  const int64_t total = int64_t(fw) * fh;
  int64_t written = 0;
  std::vector<uint8_t> str(4097);
  auto put = [&](const uint8_t* s, int k) {
    for (int i = 0; i < k && written < total; i++, written++) {
      int y = rows[size_t(written / fw)], x = int(written % fw);
      canvas[size_t(y) * stride + x] = s[i];
    }
  };
  while (written < total) {
    while (nbits < size) {
      if (block_left == 0) {
        if (pos >= n) throw Error{"truncated GIF file (image data ends early)"};
        block_left = d[pos++];
        if (block_left == 0) throw Error{"GIF image data ends before the frame is complete"};
      }
      if (pos >= n) throw Error{"truncated GIF file (image data ends early)"};
      acc |= uint32_t(d[pos++]) << nbits;
      nbits += 8;
      block_left--;
    }
    int code = int(acc & ((1u << size) - 1));
    acc >>= size;
    nbits -= size;
    if (code == clear) {
      size = bits + 1;
      next = clear + 2;
      last = -1;
      continue;
    }
    if (code == end) throw Error{"GIF end code before the frame is complete"};
    if (last < 0) {
      if (code > clear) throw Error{"corrupt GIF data (a string code right after a clear)"};
      uint8_t c = uint8_t(code);
      put(&c, 1);
      last = code;
      continue;
    }
    int k;
    if (code < next) {
      t.emit(code, str.data());
      k = t.len[code];
    } else if (code == next) {                    // KwKwK: last string + its first byte
      t.emit(last, str.data());
      k = t.len[last];
      str[size_t(k++)] = t.first[last];
    } else {
      throw Error{"corrupt GIF data (code " + std::to_string(code) + " past the table)"};
    }
    put(str.data(), k);
    if (next < 4096) {
      t.prefix[next] = uint16_t(last);
      t.suffix[next] = str[0];
      t.first[next] = t.first[last];
      t.len[next] = uint16_t(t.len[last] + 1);
      next++;
      if (next == (1 << size) && size < 12) size++;
    }
    last = code;
  }
}

size_t tiff_lzw(const uint8_t* d, size_t n, uint8_t* out, size_t cap) {
  if (n >= 2 && d[0] == 0 && (d[1] & 1))
    throw Error{"old-style (LSB first) TIFF LZW data is not decoded"};
  Table t;
  t.init(256);
  int size = 9, next = 258, last = -1;
  size_t pos = 0, o = 0;
  uint32_t acc = 0;
  int nbits = 0;
  std::vector<uint8_t> str(4097);
  for (;;) {
    while (nbits < size) {
      if (pos >= n) return o;                     // libtiff: data ends without an end code
      acc = (acc << 8) | d[pos++];
      nbits += 8;
    }
    int code = int((acc >> (nbits - size)) & ((1u << size) - 1));
    nbits -= size;
    if (code == 256) {
      size = 9;
      next = 258;
      last = -1;
      continue;
    }
    if (code == 257) return o;
    int k;
    if (last < 0) {
      if (code > 255) throw Error{"corrupt TIFF LZW data (a string code right after a clear)"};
      str[0] = uint8_t(code);
      k = 1;
    } else if (code < next) {
      t.emit(code, str.data());
      k = t.len[code];
    } else if (code == next) {
      t.emit(last, str.data());
      k = t.len[last];
      str[size_t(k++)] = t.first[last];
    } else {
      throw Error{"corrupt TIFF LZW data (code " + std::to_string(code) + " past the table)"};
    }
    size_t take = std::min(size_t(k), cap - o);
    std::memcpy(out + o, str.data(), take);
    o += take;
    if (last >= 0) {
      if (next >= 4096) throw Error{"corrupt TIFF LZW data (the table overflows)"};
      t.prefix[next] = uint16_t(last);
      t.suffix[next] = str[0];
      t.first[next] = t.first[last];
      t.len[next] = uint16_t(t.len[last] + 1);
      next++;
      if (next >= (1 << size) - 1 && size < 12) size++;
    }
    last = code;
    if (o == cap) return o;
  }
}

// PackBits into out[0 .. cap).  libtiff's rule (strict = false): a literal
// needs only the bytes that still fit.  Pillow's PackDecode.c (strict): a
// packet is taken only when all of it is there.  *used is the input read.
size_t packbits(const uint8_t* d, size_t n, uint8_t* out, size_t cap, size_t* used = nullptr,
                bool strict = false) {
  size_t pos = 0, o = 0;
  while (pos < n && o < cap) {
    int c = int8_t(d[pos++]);
    if (c >= 0) {
      size_t k = std::min(size_t(c) + 1, cap - o);
      if (pos + (strict ? size_t(c) + 1 : k) > n) throw Error{"truncated PackBits data"};
      std::memcpy(out + o, d + pos, k);
      pos += size_t(c) + 1;
      o += k;
    } else if (c != -128) {
      if (pos >= n) throw Error{"truncated PackBits data"};
      size_t k = std::min(size_t(1 - c), cap - o);
      std::memset(out + o, d[pos++], k);
      o += k;
    }
  }
  if (used) *used = pos;
  return o;
}

// `rows` rows of `row` bytes, each row filled by packets until it is full
void packbits_rows(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out) {
  size_t pos = 0;
  for (size_t y = 0; y < rows; y++) {
    size_t used = 0;
    if (packbits(d + pos, n - pos, out + y * row, row, &used, true) < row)
      throw Error{"image file is truncated (PackBits data ends early)"};
    pos += used;
  }
}

// Targa RLE: `rows` rows of `row` bytes of `depth`-byte pixels
void tga_rle(const uint8_t* d, size_t n, int depth, size_t row, size_t rows, uint8_t* out) {
  if (depth <= 0) throw Error{"image file is truncated (Targa RLE of 0-byte pixels)"};
  size_t pos = 0, x = 0, y = 0;
  std::vector<uint8_t> buf(row);
  size_t extra = 0;                         // literal bytes past the row's end
  while (y < rows) {
    if (pos >= n) throw Error{"image file is truncated (Targa RLE data ends early)"};
    size_t k = size_t(depth) * ((d[pos] & 0x7f) + 1);
    if (d[pos] & 0x80) {
      if (pos + 1 + size_t(depth) > n) throw Error{"image file is truncated (Targa RLE)"};
      if (x + k > row) throw Error{"Targa RLE run past the row's end"};
      for (size_t i = 0; i < k; i += size_t(depth)) std::memcpy(&buf[x + i], d + pos + 1, size_t(depth));
      pos += 1 + size_t(depth);
    } else {
      if (pos + 1 + k > n) throw Error{"image file is truncated (Targa RLE)"};
      if (x + k > row) {
        extra = k - (row - x);
        k = row - x;
      }
      std::memcpy(&buf[x], d + pos + 1, k);
      pos += 1 + k + extra;
    }
    for (;;) {
      x += k;
      if (x >= row) {
        std::memcpy(out + y * row, buf.data(), row);
        x = 0;
        if (++y >= rows) return;
      }
      if (extra == 0 || x > 0) break;
      k = std::min(extra, row);
      std::memcpy(buf.data(), d + pos - extra, k);
      extra -= k;
    }
  }
}

// PCX RLE: `rows` rows of `row` bytes
void pcx_rle(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out) {
  size_t pos = 0, x = 0, y = 0;
  std::vector<uint8_t> buf(row);
  while (y < rows) {
    if (pos >= n) throw Error{"image file is truncated (PCX data ends early)"};
    if ((d[pos] & 0xC0) == 0xC0) {
      if (pos + 2 > n) throw Error{"image file is truncated (PCX data ends early)"};
      for (int k = d[pos] & 0x3F; k > 0; k--) {
        if (x >= row) throw Error{"PCX run past the row's end"};
        buf[x++] = d[pos + 1];
      }
      pos += 2;
    } else {
      buf[x++] = d[pos++];
    }
    if (x >= row) {
      std::memcpy(out + y * row, buf.data(), row);
      x = 0;
      y++;
    }
  }
}

// SgiRleDecode.c's expandrow / expandrow2 over one channel of one row: 0 at
// the end code, 1 where Pillow stops decoding the image without an error;
// `end` is the last byte of the data (Pillow never reads past it)
int sgi_row(uint8_t* dest, const uint8_t* src, long n, int z, int xsize, const uint8_t* end,
            int bpc) {
  int x = 0;
  for (; n > 0; n--) {
    if (src + (bpc - 1) > end) return -1;
    uint8_t pixel = src[bpc - 1];
    src += bpc;
    if (n == 1 && pixel != 0) return 1;
    int count = pixel & 0x7F;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + bpc * count > end) return -1;
      while (count--) {
        std::memcpy(dest, src, size_t(bpc));
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc - 1) > end) return -1;
      while (count--) {
        std::memcpy(dest, src, size_t(bpc));
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}

// SGI RLE over the data after the 512-byte header (d[0 .. n)): `rows` rows of
// `xsize` pixels of `bands` samples of `bpc` bytes, in file order; rows
// Pillow leaves unwritten stay as they are in out
void sgi_rle(const uint8_t* d, size_t n, int xsize, int rows, int bands, int bpc, uint8_t* out) {
  const size_t tablen = size_t(bands) * size_t(rows);
  if (n < 8 * tablen) throw Error{"SGI RLE tables past the end of the file"};
  auto be32 = [&](size_t at) {
    return uint32_t(d[at]) << 24 | uint32_t(d[at + 1]) << 16 | uint32_t(d[at + 2]) << 8 | d[at + 3];
  };
  const size_t rowbytes = size_t(xsize) * size_t(bands) * size_t(bpc);
  std::vector<uint8_t> buf(rowbytes);
  for (int y = 0; y < rows; y++) {
    for (int c = 0; c < bands; c++) {
      uint32_t off = be32(4 * (size_t(y) + size_t(c) * rows));
      uint32_t len = be32(4 * (tablen + size_t(y) + size_t(c) * rows));
      if (off < 512) throw Error{"SGI RLE row before the end of the header"};
      off -= 512;
      if (off >= n) throw Error{"SGI RLE row past the end of the file"};
      // Pillow passes the length as an int: past 2^31 it is negative, no packet is read
      int status = sgi_row(&buf[size_t(c) * size_t(bpc)], d + off, long(int32_t(len)), bands,
                           xsize, d + n - 1, bpc);
      if (status == -1) throw Error{"corrupt SGI RLE row"};
      if (status == 1) return;
    }
    std::memcpy(out + size_t(y) * rowbytes, buf.data(), rowbytes);
  }
}

// Sun raster RLE: `rows` rows of `row` bytes, one stream (a run may cross
// rows; the last one is cut at the image's end)
void sun_rle(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out) {
  const size_t total = row * rows;
  size_t pos = 0, o = 0;
  while (o < total) {
    if (pos >= n) throw Error{"image file is truncated (Sun RLE data ends early)"};
    if (d[pos] == 0x80) {
      if (pos + 2 > n) throw Error{"image file is truncated (Sun RLE data ends early)"};
      if (d[pos + 1] == 0) {
        out[o++] = 0x80;
        pos += 2;
      } else {
        if (pos + 3 > n) throw Error{"image file is truncated (Sun RLE data ends early)"};
        size_t k = std::min(size_t(d[pos + 1]) + 1, total - o);
        std::memset(out + o, d[pos + 2], k);
        o += k;
        pos += 3;
      }
    } else {
      out[o++] = d[pos++];
    }
  }
}

// QOI's op stream into w * h pixels of `bands` (3 or 4) bytes
void qoi(const uint8_t* d, size_t n, size_t pixels, int bands, uint8_t* out) {
  uint8_t seen[64][4] = {}, prev[4] = {0, 0, 0, 255}, v[4];
  const size_t total = pixels * size_t(bands);
  size_t pos = 0, o = 0;
  auto need = [&](size_t k) {
    if (pos + k > n) throw Error{"image file is truncated (QOI data ends early)"};
  };
  auto put = [&](const uint8_t* px) {
    size_t k = std::min(size_t(bands), total - o);
    std::memcpy(out + o, px, k);
    o += k;
  };
  while (o < total) {
    need(1);
    const uint8_t b = d[pos++];
    if (b == 0xFE) {                               // QOI_OP_RGB
      need(3);
      v[0] = d[pos], v[1] = d[pos + 1], v[2] = d[pos + 2], v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {                        // QOI_OP_RGBA
      need(4);
      std::memcpy(v, d + pos, 4);
      pos += 4;
    } else if ((b >> 6) == 0) {                    // QOI_OP_INDEX
      std::memcpy(v, seen[b & 63], 4);
    } else if ((b >> 6) == 1) {                    // QOI_OP_DIFF
      v[0] = uint8_t(prev[0] + ((b >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((b >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (b & 3) - 2);
      v[3] = prev[3];
    } else if ((b >> 6) == 2) {                    // QOI_OP_LUMA
      need(1);
      const int dg = (b & 63) - 32, c = d[pos++];
      v[0] = uint8_t(prev[0] + dg + (c >> 4) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (c & 15) - 8);
      v[3] = prev[3];
    } else {                                       // QOI_OP_RUN: the index is not updated
      for (int k = (b & 63) + 1; k > 0 && o < total; k--) put(prev);
      continue;
    }
    std::memcpy(prev, v, 4);
    std::memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
    put(v);
  }
}

// libtiff's ThunderDecode over `rows` rows of `width` 4-bit pixels, each
// row (width + 1) / 2 bytes of out[0 .. cap)
void thunder(const uint8_t* d, size_t n, int width, int rows, uint8_t* out, size_t cap) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const size_t stride = size_t(width + 1) / 2;
  if (width <= 0 || rows <= 0 || stride * size_t(rows) > cap)
    throw Error{"ThunderScan strip larger than its buffer"};
  size_t at = 0;
  for (int y = 0; y < rows; y++) {
    uint8_t* op = out + size_t(y) * stride;
    std::memset(op, 0, stride);
    int last = 0;
    long np = 0;
    auto set = [&](int v) {
      last = v & 0xf;
      if (np < width) {
        if (np++ & 1)
          op[(np - 1) >> 1] |= uint8_t(last);
        else
          op[np >> 1] = uint8_t(last << 4);
      }
    };
    while (at < n && np < width) {
      int c = d[at++];
      switch (c & 0xc0) {
        case 0x00: {                      // a run of the last pixel, c & 63 long
          long k = c & 0x3f;
          if (np + k >= width) {
            if (np + k > width) throw Error{"too much ThunderScan data in a row"};
            throw Error{"ThunderScan run to the row's end (libtiff leaves it unwritten)"};
          }
          for (long i = 0; i < k; i++) set(last);
          break;
        }
        case 0x40:                        // three 2-bit deltas (2 skips)
          for (int sh = 4; sh >= 0; sh -= 2)
            if (((c >> sh) & 3) != 2) set(last + two[(c >> sh) & 3]);
          break;
        case 0x80:                        // two 3-bit deltas (4 skips)
          for (int sh = 3; sh >= 0; sh -= 3)
            if (((c >> sh) & 7) != 4) set(last + three[(c >> sh) & 7]);
          break;
        default:                          // a raw pixel
          set(c);
      }
    }
    if (np != width) throw Error{"not enough ThunderScan data in a row"};
  }
}

}  // namespace

extern "C" {

// Decode one GIF frame's LZW data d[0 .. n) (the sub-blocks after the
// minimum code size byte) into the fw x fh rectangle whose top-left pixel is
// canvas[0] (rows `stride` bytes apart).  0 on success.
int gif_lzw_decode(const uint8_t* d, size_t n, int bits, int fw, int fh, int interlace,
                   uint8_t* canvas, int stride, char* err, int errlen) {
  try {
    gif_decode(d, n, bits, fw, fh, interlace, canvas, stride);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "GIF decoder failed");
  }
  return 1;
}

#define CATCH(what)                     \
  catch (const Error& e) {              \
    set_error(err, errlen, e.msg);      \
  }                                     \
  catch (...) {                         \
    set_error(err, errlen, what " failed"); \
  }                                     \
  return 1;

// The raster loops: 0 on success; the message in err otherwise.
int packbits_rows_decode(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out,
                         char* err, int errlen) {
  try {
    packbits_rows(d, n, row, rows, out);
    return 0;
  }
  CATCH("PackBits decoder")
}

int tga_rle_decode(const uint8_t* d, size_t n, int depth, size_t row, size_t rows,
                   uint8_t* out, char* err, int errlen) {
  try {
    tga_rle(d, n, depth, row, rows, out);
    return 0;
  }
  CATCH("Targa RLE decoder")
}

int pcx_rle_decode(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out,
                   char* err, int errlen) {
  try {
    pcx_rle(d, n, row, rows, out);
    return 0;
  }
  CATCH("PCX decoder")
}

int sgi_rle_decode(const uint8_t* d, size_t n, int xsize, int rows, int bands, int bpc,
                   uint8_t* out, char* err, int errlen) {
  try {
    sgi_rle(d, n, xsize, rows, bands, bpc, out);
    return 0;
  }
  CATCH("SGI RLE decoder")
}

int sun_rle_decode(const uint8_t* d, size_t n, size_t row, size_t rows, uint8_t* out,
                   char* err, int errlen) {
  try {
    sun_rle(d, n, row, rows, out);
    return 0;
  }
  CATCH("Sun RLE decoder")
}

int qoi_decode(const uint8_t* d, size_t n, size_t pixels, int bands, uint8_t* out, char* err,
               int errlen) {
  try {
    qoi(d, n, pixels, bands, out);
    return 0;
  }
  CATCH("QOI decoder")
}

// Decode TIFF LZW (compression 5) or PackBits (32773) data into out[0 ..
// cap); *got is the number of bytes written.  0 on success.
int tiff_unpack(int compression, const uint8_t* d, size_t n, uint8_t* out, size_t cap,
                size_t* got, char* err, int errlen) {
  try {
    if (compression == 5)
      *got = tiff_lzw(d, n, out, cap);
    else if (compression == 32773)
      *got = packbits(d, n, out, cap);
    else
      throw Error{"unknown compression " + std::to_string(compression)};
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "TIFF decoder failed");
  }
  return 1;
}

// Decode ThunderScan (compression 32809) data into `rows` rows of `width`
// 4-bit pixels in out[0 .. cap).  0 on success.
int thunder_decode(const uint8_t* d, size_t n, int width, int rows, uint8_t* out, size_t cap,
                   char* err, int errlen) {
  try {
    thunder(d, n, width, rows, out, cap);
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (...) {
    set_error(err, errlen, "ThunderScan decoder failed");
  }
  return 1;
}

}  // extern "C"
