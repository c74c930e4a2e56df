// WebP decoder with a plain C interface, bound with ctypes by utils/webp.py.
// It gives the pixels Pillow 12.1's WebP plugin gives, which decodes through
// libwebp's animation decoder (the first frame on a transparent black
// canvas, MODE_RGBA, the decoder's defaults):
//
//   container: RIFF with VP8, VP8L, or VP8X with ALPH / ANMF (the first
//              frame of an animation at its offset);
//   VP8 lossy: the boolean decoder (RFC 6386), segments and quantizers, the
//              coefficient probabilities and their updates, intra modes
//              (16x16, 4x4, chroma), the DCT and WHT, the simple and normal
//              loop filters, then libwebp's YUV -> RGB in its 14-bit fixed
//              point with its "fancy" chroma upsampling;
//   VP8L:      prefix-code groups (the meta prefix image), the colour cache,
//              backward references, and the predictor, cross-colour,
//              subtract-green and colour-indexing (pixel-bundling)
//              transforms;
//   ALPH:      raw or VP8L-compressed, with the horizontal, vertical and
//              gradient filters.
//
// The constant tables are those of RFC 6386 and of the WebP lossless
// specification, in libwebp's order of the 4x4 modes.  Truncated and corrupt
// files raise (a chunk or RIFF size past the data, a partition or a
// lossless stream read past its end, codes that do not form a prefix code,
// references out of range), as libwebp refuses them; nothing is read or
// written out of bounds.
//
// Build: g++ -O2 -fPIC -std=c++17 -shared -o libwebp_decoder.so webp.cpp

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

// VP8 (RFC 6386) and VP8L constant tables, in libwebp's mode order.
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

const int kZigzag16[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};

// libwebp's mode numbering
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED };

inline int clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// ------------------------------------------------------------ VP8 bool decoder

// RFC 6386's boolean decoder.  `eof` follows libwebp's VP8BitReader: it is
// set when a bit is asked for after all but the last byte's worth of bits
// were consumed with the last byte loaded, i.e. when the decoder's
// look-ahead needs a byte past the end (an empty partition is at end
// already).  The bits past the end read as zeros.
struct BoolDecoder {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  int64_t consumed = 0;            // normalisation shifts so far
  bool eof = false;
  void init(const uint8_t* p, size_t len) {
    d = p;
    n = len;
    pos = 0;
    value = 0;
    range = 255;
    bit_count = 0;
    consumed = 0;
    eof = len == 0;
    value = (uint32_t(next()) << 8) | next();
  }
  uint8_t next() { return pos < n ? d[pos++] : (pos++, 0); }
  int get(int prob) {
    if (consumed > int64_t(n) * 8 - 8) eof = true;
    uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      consumed++;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v |= get(128) << bits;
    return v;
  }
  int signed_literal(int bits) {
    int v = literal(bits);
    return get(128) ? -v : v;
  }
};

// ------------------------------------------------------------------- VP8

struct VP8Frame {
  int width = 0, height = 0, mbw = 0, mbh = 0;
  std::vector<uint8_t> y, u, v;    // [mbh*16][mbw*16], [mbh*8][mbw*8]
  int ystride = 0, uvstride = 0;
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  bool is_i4x4 = false, skip = false;
  uint8_t imodes[16];
  uint8_t uvmode = 0, segment = 0;
};

// dsp/dec.c TransformOne: the inverse DCT of one 4x4 block, added to dst.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform(const int16_t* in, uint8_t* dst, int stride) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; i++) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = uint8_t(clip8(dst[0] + ((a + d) >> 3)));
    dst[1] = uint8_t(clip8(dst[1] + ((b + c) >> 3)));
    dst[2] = uint8_t(clip8(dst[2] + ((b - c) >> 3)));
    dst[3] = uint8_t(clip8(dst[3] + ((a - d) >> 3)));
    tmp++;
    dst += stride;
  }
}

// dsp/dec.c TransformWHT: the Y2 block's DCs into each luma block's coefficient 0.
void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; i++) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

inline uint8_t avg3(int a, int b, int c) { return uint8_t((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

// dsp/dec.c's 4x4 intra predictors over dst (top row at dst - bps, left
// column at dst - 1, top-right at dst - bps + 4..7).
void predict4(int mode, uint8_t* dst, int bps) {
  auto D = [&](int x, int y) -> uint8_t& { return dst[x + y * bps]; };
  const uint8_t* top = dst - bps;
  const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], Dd = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; i++) dc += top[i] + dst[-1 + i * bps];
      dc >>= 3;
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) D(x, y) = uint8_t(dc);
      break;
    }
    case B_TM_PRED:
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) D(x, y) = uint8_t(clip8(top[x] + dst[-1 + y * bps] - X));
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, Dd), avg3(C, Dd, E)};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) D(x, y) = vals[x];
      break;
    }
    case B_HE_PRED: {
      const uint8_t vals[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) D(x, y) = vals[y];
      break;
    }
    case B_RD_PRED:
      D(0, 3) = avg3(J, K, L);
      D(1, 3) = D(0, 2) = avg3(I, J, K);
      D(2, 3) = D(1, 2) = D(0, 1) = avg3(X, I, J);
      D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = avg3(A, X, I);
      D(3, 2) = D(2, 1) = D(1, 0) = avg3(B, A, X);
      D(3, 1) = D(2, 0) = avg3(C, B, A);
      D(3, 0) = avg3(Dd, C, B);
      break;
    case B_LD_PRED:
      D(0, 0) = avg3(A, B, C);
      D(1, 0) = D(0, 1) = avg3(B, C, Dd);
      D(2, 0) = D(1, 1) = D(0, 2) = avg3(C, Dd, E);
      D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = avg3(Dd, E, F);
      D(3, 1) = D(2, 2) = D(1, 3) = avg3(E, F, G);
      D(3, 2) = D(2, 3) = avg3(F, G, H);
      D(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      D(0, 0) = D(1, 2) = avg2(X, A);
      D(1, 0) = D(2, 2) = avg2(A, B);
      D(2, 0) = D(3, 2) = avg2(B, C);
      D(3, 0) = avg2(C, Dd);
      D(0, 3) = avg3(K, J, I);
      D(0, 2) = avg3(J, I, X);
      D(0, 1) = D(1, 3) = avg3(I, X, A);
      D(1, 1) = D(2, 3) = avg3(X, A, B);
      D(2, 1) = D(3, 3) = avg3(A, B, C);
      D(3, 1) = avg3(B, C, Dd);
      break;
    case B_VL_PRED:
      D(0, 0) = avg2(A, B);
      D(1, 0) = D(0, 2) = avg2(B, C);
      D(2, 0) = D(1, 2) = avg2(C, Dd);
      D(3, 0) = D(2, 2) = avg2(Dd, E);
      D(0, 1) = avg3(A, B, C);
      D(1, 1) = D(0, 3) = avg3(B, C, Dd);
      D(2, 1) = D(1, 3) = avg3(C, Dd, E);
      D(3, 1) = D(2, 3) = avg3(Dd, E, F);
      D(3, 2) = avg3(E, F, G);
      D(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      D(0, 0) = D(2, 1) = avg2(I, X);
      D(0, 1) = D(2, 2) = avg2(J, I);
      D(0, 2) = D(2, 3) = avg2(K, J);
      D(0, 3) = avg2(L, K);
      D(3, 0) = avg3(A, B, C);
      D(2, 0) = avg3(X, A, B);
      D(1, 0) = D(3, 1) = avg3(I, X, A);
      D(1, 1) = D(3, 2) = avg3(J, I, X);
      D(1, 2) = D(3, 3) = avg3(K, J, I);
      D(1, 3) = avg3(L, K, J);
      break;
    default:  // B_HU_PRED
      D(0, 0) = avg2(I, J);
      D(2, 0) = D(0, 1) = avg2(J, K);
      D(2, 1) = D(0, 2) = avg2(K, L);
      D(1, 0) = avg3(I, J, K);
      D(3, 0) = D(1, 1) = avg3(J, K, L);
      D(3, 1) = D(1, 2) = avg3(K, L, L);
      D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = uint8_t(L);
      break;
  }
}

// The 16x16 (size 16) and chroma (size 8) predictors; DC at the picture's
// edges as CheckMode picks it.
void predict_block(int mode, uint8_t* dst, int bps, int size, bool has_top, bool has_left) {
  const uint8_t* top = dst - bps;
  if (mode == B_DC_PRED) {
    int sh = size == 16 ? 4 : 3, dc;
    int st = 0, sl = 0;
    for (int i = 0; i < size; i++) {
      st += top[i];
      sl += dst[-1 + i * bps];
    }
    if (has_top && has_left) dc = (st + sl + size) >> (sh + 1);
    else if (has_top) dc = (st + (size >> 1)) >> sh;
    else if (has_left) dc = (sl + (size >> 1)) >> sh;
    else dc = 0x80;
    for (int y = 0; y < size; y++) std::memset(dst + y * bps, dc, size);
  } else if (mode == B_TM_PRED) {
    for (int y = 0; y < size; y++)
      for (int x = 0; x < size; x++)
        dst[x + y * bps] = uint8_t(clip8(top[x] + dst[-1 + y * bps] - top[-1]));
  } else if (mode == B_VE_PRED) {
    for (int y = 0; y < size; y++) std::memcpy(dst + y * bps, top, size);
  } else {  // B_HE_PRED
    for (int y = 0; y < size; y++) std::memset(dst + y * bps, dst[-1 + y * bps], size);
  }
}

// ---------------------------------------------------------- loop filters

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = uint8_t(clip8(p0 + a2));
  p[0] = uint8_t(clip8(q0 - a1));
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = uint8_t(clip8(p1 + a3));
  p[-step] = uint8_t(clip8(p0 + a2));
  p[0] = uint8_t(clip8(q0 - a1));
  p[step] = uint8_t(clip8(q1 - a3));
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = uint8_t(clip8(p2 + a3));
  p[-2 * step] = uint8_t(clip8(p1 + a2));
  p[-step] = uint8_t(clip8(p0 + a1));
  p[0] = uint8_t(clip8(q0 - a1));
  p[step] = uint8_t(clip8(q1 - a2));
  p[2 * step] = uint8_t(clip8(q2 - a3));
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int step, int along, int n, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; i++, p += along)
    if (needs_filter(p, step, t2)) do_filter2(p, step);
}

void filter_loop(uint8_t* p, int step, int along, int n, int thresh, int ithresh, int hev_t,
                 bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < n; i++, p += along) {
    if (!needs_filter2(p, step, t2, ithresh)) continue;
    if (hev(p, step, hev_t)) do_filter2(p, step);
    else if (edge) do_filter6(p, step);
    else do_filter4(p, step);
  }
}

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

// ------------------------------------------------------------ VP8 decoding

VP8Frame decode_vp8(const uint8_t* data, size_t size, int want_w, int want_h) {
  if (size < 10) throw Error{"truncated VP8 frame header"};
  uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) throw Error{"VP8 frame is not a key frame"};
  if (profile > 3) throw Error{"incorrect VP8 keyframe parameters"};
  if (!show) throw Error{"VP8 frame not displayable"};
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) throw Error{"bad VP8 code word"};
  VP8Frame f;
  f.width = (data[6] | (data[7] << 8)) & 0x3fff;
  f.height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (f.width == 0 || f.height == 0) throw Error{"VP8 frame of size 0"};
  if ((want_w && f.width != want_w) || (want_h && f.height != want_h))
    throw Error{"VP8 frame size differs from the canvas"};
  data += 10;
  size -= 10;
  if (part0 > size) throw Error{"bad VP8 partition length"};
  f.mbw = (f.width + 15) >> 4;
  f.mbh = (f.height + 15) >> 4;
  BoolDecoder br;
  br.init(data, part0);
  const uint8_t* buf = data + part0;
  size_t buf_size = size - part0;
  br.get(128);                      // colour space
  br.get(128);                      // clamping type
  // segment header
  bool use_segment = br.get(128), update_map = false, absolute_delta = false;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t seg_proba[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.get(128);
    if (br.get(128)) {
      absolute_delta = br.get(128);
      for (int s = 0; s < 4; s++) quantizer[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; s++) filter_strength[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; s++) seg_proba[s] = uint8_t(br.get(128) ? br.literal(8) : 255);
  }
  if (br.eof) throw Error{"cannot parse VP8 segment header"};
  // filter header
  const bool simple = br.get(128);
  const int level = br.literal(6), sharpness = br.literal(3);
  const bool use_lf_delta = br.get(128);
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  if (use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; i++)
      if (br.get(128)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; i++)
      if (br.get(128)) mode_lf_delta[i] = br.signed_literal(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) throw Error{"cannot parse VP8 filter header"};
  // partitions
  const int nparts = 1 << br.literal(2);
  std::vector<BoolDecoder> parts(nparts);
  {
    const uint8_t* sz = buf;
    const uint8_t* end = buf + buf_size;
    size_t left = buf_size;
    const int last = nparts - 1;
    if (left < size_t(3 * last)) throw Error{"cannot parse VP8 partitions"};
    const uint8_t* start = buf + 3 * last;
    left -= 3 * last;
    for (int p = 0; p < last; p++) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    parts[last].init(start, left);
    if (start >= end) throw Error{"cannot parse VP8 partitions (no data in the last one)"};
  }
  // quantizers
  QuantMatrix dqm[4];
  {
    const int base_q0 = br.literal(7);
    const int dqy1_dc = br.get(128) ? br.signed_literal(4) : 0;
    const int dqy2_dc = br.get(128) ? br.signed_literal(4) : 0;
    const int dqy2_ac = br.get(128) ? br.signed_literal(4) : 0;
    const int dquv_dc = br.get(128) ? br.signed_literal(4) : 0;
    const int dquv_ac = br.get(128) ? br.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; i++) {
      int q;
      if (use_segment) {
        q = quantizer[i] + (absolute_delta ? 0 : base_q0);
      } else if (i > 0) {
        dqm[i] = dqm[0];
        continue;
      } else {
        q = base_q0;
      }
      QuantMatrix& m = dqm[i];
      m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
      m.y1[1] = kAcTable[clip(q, 127)];
      m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
      if (m.y2[1] < 8) m.y2[1] = 8;
      m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
      m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }
  br.get(128);                      // update_proba, ignored for a key frame
  uint8_t proba[4][8][3][11];
  for (int t = 0; t < 4; t++)
    for (int b = 0; b < 8; b++)
      for (int c = 0; c < 3; c++)
        for (int p = 0; p < 11; p++) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          proba[t][b][c][p] =
              uint8_t(br.get(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i]);
        }
  const bool use_skip_proba = br.get(128);
  const int skip_p = use_skip_proba ? br.literal(8) : 0;
  // filter strengths per segment and 4x4-ness (PrecomputeFilterStrengths)
  FInfo fstrengths[4][2];
  if (filter_type > 0) {
    for (int s = 0; s < 4; s++) {
      int base_level = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
        FInfo& info = fstrengths[s][i4x4];
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4x4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }
  // the frame, with a one-pixel border for prediction: rows -1 and column -1
  const int W = f.mbw * 16, H = f.mbh * 16;
  f.ystride = W;
  f.uvstride = W / 2;
  f.y.assign(size_t(W) * H, 0);
  f.u.assign(size_t(W / 2) * (H / 2), 0);
  f.v.assign(size_t(W / 2) * (H / 2), 0);
  std::vector<FInfo> finfo(size_t(f.mbw) * f.mbh);
  std::vector<uint8_t> intra_t(size_t(4) * f.mbw, B_DC_PRED);
  std::vector<MBInfo> mbinfo(f.mbw + 1);   // [0] is the left neighbour
  std::vector<MBData> mbdata(f.mbw);
  const int BPS = 32;
  uint8_t work[BPS * 17 + BPS * 9 * 2];   // y: 17 rows of 32, u/v: 9 rows each
  uint8_t* ybuf = work + BPS + 8;
  uint8_t* ubuf = work + BPS * 17 + BPS + 8;
  uint8_t* vbuf = ubuf + 16;
  std::vector<uint8_t> top_y(size_t(16) * f.mbw), top_u(size_t(8) * f.mbw),
      top_v(size_t(8) * f.mbw);
  for (int mby = 0; mby < f.mbh; mby++) {
    // intra modes of the row (partition 0)
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    for (int mbx = 0; mbx < f.mbw; mbx++) {
      MBData& blk = mbdata[mbx];
      uint8_t* top = &intra_t[4 * mbx];
      blk.segment = update_map ? (!br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                                        : br.get(seg_proba[2]) + 2)
                               : 0;
      blk.skip = use_skip_proba ? br.get(skip_p) : false;
      blk.is_i4x4 = !br.get(145);
      if (!blk.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? B_TM_PRED : B_HE_PRED)
                                      : (br.get(163) ? B_VE_PRED : B_DC_PRED);
        blk.imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = blk.imodes;
        for (int y = 0; y < 4; y++) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; x++) {
            const uint8_t* prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
            ymode = !br.get(prob[0])   ? B_DC_PRED
                    : !br.get(prob[1]) ? B_TM_PRED
                    : !br.get(prob[2]) ? B_VE_PRED
                    : !br.get(prob[3])
                        ? (!br.get(prob[4]) ? B_HE_PRED : (!br.get(prob[5]) ? B_RD_PRED : B_VR_PRED))
                        : (!br.get(prob[6])   ? B_LD_PRED
                           : !br.get(prob[7]) ? B_VL_PRED
                           : !br.get(prob[8]) ? B_HD_PRED
                                              : B_HU_PRED);
            top[x] = uint8_t(ymode);
          }
          std::memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = uint8_t(ymode);
        }
      }
      blk.uvmode = !br.get(142)   ? B_DC_PRED
                   : !br.get(114) ? B_VE_PRED
                   : br.get(183)  ? B_TM_PRED
                                  : B_HE_PRED;
    }
    if (br.eof) throw Error{"premature end of VP8 partition 0"};
    // residuals (the row's token partition)
    BoolDecoder& tb = parts[mby & (nparts - 1)];
    MBInfo& left = mbinfo[0];
    left.nz = left.nz_dc = 0;
    for (int mbx = 0; mbx < f.mbw; mbx++) {
      MBData& blk = mbdata[mbx];
      MBInfo& mb = mbinfo[mbx + 1];
      bool skip = blk.skip;
      std::memset(blk.coeffs, 0, sizeof(blk.coeffs));
      if (!skip) {
        const QuantMatrix& q = dqm[blk.segment];
        int16_t* dst = blk.coeffs;
        uint32_t non_zero = 0;
        auto get_coeffs = [&](int type, int ctx, const int* dq, int n, int16_t* out) -> int {
          const uint8_t* p = proba[type][kBands[n]][ctx];
          for (; n < 16; ++n) {
            if (!tb.get(p[0])) return n;
            while (!tb.get(p[1])) {
              ++n;
              if (n == 16) return 16;
              p = proba[type][kBands[n]][0];
            }
            int v;
            const int nb = kBands[n + 1];
            if (!tb.get(p[2])) {
              v = 1;
              p = proba[type][nb][1];
            } else {
              if (!tb.get(p[3])) {
                v = !tb.get(p[4]) ? 2 : 3 + tb.get(p[5]);
              } else if (!tb.get(p[6])) {
                if (!tb.get(p[7])) {
                  v = 5 + tb.get(159);
                } else {
                  v = 7 + 2 * tb.get(165);
                  v += tb.get(145);
                }
              } else {
                const int bit1 = tb.get(p[8]);
                const int bit0 = tb.get(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.get(*tab);
                v += 3 + (8 << cat);
              }
              p = proba[type][nb][2];
            }
            out[kZigzag16[n]] = int16_t((tb.get(128) ? -v : v) * dq[n > 0]);
          }
          return 16;
        };
        int first;
        int ac_type;
        if (!blk.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = mb.nz_dc + left.nz_dc;
          const int nz = get_coeffs(1, ctx, q.y2, 0, dc);
          mb.nz_dc = left.nz_dc = nz > 0;
          transform_wht(dc, dst);
          first = 1;
          ac_type = 0;
        } else {
          first = 0;
          ac_type = 3;
        }
        uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
        for (int y = 0; y < 4; y++) {
          int l = lnz & 1;
          for (int x = 0; x < 4; x++) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(ac_type, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            if (nz > 0 || dst[0] != 0) non_zero = 1;
            dst += 16;
          }
          tnz >>= 4;
          lnz = uint8_t((lnz >> 1) | (l << 7));
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = uint8_t(mb.nz >> (4 + ch));
          lnz = uint8_t(left.nz >> (4 + ch));
          for (int y = 0; y < 2; y++) {
            int l = lnz & 1;
            for (int x = 0; x < 2; x++) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(2, ctx, q.uv, 0, dst);
              l = nz > 0;
              tnz = uint8_t((tnz >> 1) | (l << 3));
              if (nz > 0 || dst[0] != 0) non_zero = 1;
              dst += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
          }
          out_t |= uint32_t(tnz << 4) << ch;
          out_l |= uint32_t(lnz & 0xf0) << ch;
        }
        mb.nz = uint8_t(out_t);
        left.nz = uint8_t(out_l);
        skip = !non_zero;
      } else {
        left.nz = mb.nz = 0;
        if (!blk.is_i4x4) left.nz_dc = mb.nz_dc = 0;
      }
      if (filter_type > 0) {
        FInfo& fi = finfo[size_t(mby) * f.mbw + mbx];
        fi = fstrengths[blk.segment][blk.is_i4x4];
        fi.inner = fi.inner || !skip;
      }
      if (tb.eof) throw Error{"premature end of VP8 data"};
    }
    // reconstruct the row from unfiltered neighbours (frame_dec.c ReconstructRow)
    for (int j = 0; j < 16; j++) ybuf[j * BPS - 1] = 129;
    for (int j = 0; j < 8; j++) ubuf[j * BPS - 1] = vbuf[j * BPS - 1] = 129;
    if (mby > 0) {
      ybuf[-1 - BPS] = ubuf[-1 - BPS] = vbuf[-1 - BPS] = 129;
    } else {
      std::memset(ybuf - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ubuf - BPS - 1, 127, 8 + 1);
      std::memset(vbuf - BPS - 1, 127, 8 + 1);
    }
    for (int mbx = 0; mbx < f.mbw; mbx++) {
      const MBData& blk = mbdata[mbx];
      if (mbx > 0) {
        for (int j = -1; j < 16; j++) std::memcpy(&ybuf[j * BPS - 4], &ybuf[j * BPS + 12], 4);
        for (int j = -1; j < 8; j++) {
          std::memcpy(&ubuf[j * BPS - 4], &ubuf[j * BPS + 4], 4);
          std::memcpy(&vbuf[j * BPS - 4], &vbuf[j * BPS + 4], 4);
        }
      }
      if (mby > 0) {
        std::memcpy(ybuf - BPS, &top_y[16 * mbx], 16);
        std::memcpy(ubuf - BPS, &top_u[8 * mbx], 8);
        std::memcpy(vbuf - BPS, &top_v[8 * mbx], 8);
      }
      const int16_t* coeffs = blk.coeffs;
      if (blk.is_i4x4) {
        uint8_t* top_right = ybuf - BPS + 16;
        if (mby > 0) {
          if (mbx >= f.mbw - 1) std::memset(top_right, top_y[16 * mbx + 15], 4);
          else std::memcpy(top_right, &top_y[16 * (mbx + 1)], 4);
        }
        for (int r = 1; r <= 3; r++) std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; n++) {
          uint8_t* dst = ybuf + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(blk.imodes[n], dst, BPS);
          transform(coeffs + n * 16, dst, BPS);
        }
      } else {
        predict_block(blk.imodes[0], ybuf, BPS, 16, mby > 0, mbx > 0);
        for (int n = 0; n < 16; n++)
          transform(coeffs + n * 16, ybuf + (n & 3) * 4 + (n >> 2) * 4 * BPS, BPS);
      }
      predict_block(blk.uvmode, ubuf, BPS, 8, mby > 0, mbx > 0);
      predict_block(blk.uvmode, vbuf, BPS, 8, mby > 0, mbx > 0);
      for (int n = 0; n < 4; n++) {
        transform(coeffs + 256 + n * 16, ubuf + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
        transform(coeffs + 320 + n * 16, vbuf + (n & 1) * 4 + (n >> 1) * 4 * BPS, BPS);
      }
      if (mby < f.mbh - 1) {
        std::memcpy(&top_y[16 * mbx], ybuf + 15 * BPS, 16);
        std::memcpy(&top_u[8 * mbx], ubuf + 7 * BPS, 8);
        std::memcpy(&top_v[8 * mbx], vbuf + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; j++)
        std::memcpy(&f.y[size_t(mby * 16 + j) * W + mbx * 16], ybuf + j * BPS, 16);
      for (int j = 0; j < 8; j++) {
        std::memcpy(&f.u[size_t(mby * 8 + j) * (W / 2) + mbx * 8], ubuf + j * BPS, 8);
        std::memcpy(&f.v[size_t(mby * 8 + j) * (W / 2) + mbx * 8], vbuf + j * BPS, 8);
      }
    }
  }
  // the loop filter, macroblock by macroblock in raster order (frame_dec.c DoFilter)
  if (filter_type > 0) {
    const int ys = W, uvs = W / 2;
    for (int mby = 0; mby < f.mbh; mby++)
      for (int mbx = 0; mbx < f.mbw; mbx++) {
        const FInfo& fi = finfo[size_t(mby) * f.mbw + mbx];
        const int limit = fi.limit;
        if (limit == 0) continue;
        uint8_t* yd = &f.y[size_t(mby * 16) * ys + mbx * 16];
        if (filter_type == 1) {
          if (mbx > 0) simple_filter(yd, 1, ys, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; k++) simple_filter(yd + 4 * k, 1, ys, 16, limit);
          if (mby > 0) simple_filter(yd, ys, 1, 16, limit + 4);
          if (fi.inner)
            for (int k = 1; k <= 3; k++) simple_filter(yd + 4 * k * ys, ys, 1, 16, limit);
        } else {
          uint8_t* ud = &f.u[size_t(mby * 8) * uvs + mbx * 8];
          uint8_t* vd = &f.v[size_t(mby * 8) * uvs + mbx * 8];
          const int il = fi.ilevel, ht = fi.hev_thresh;
          if (mbx > 0) {
            filter_loop(yd, 1, ys, 16, limit + 4, il, ht, true);
            filter_loop(ud, 1, uvs, 8, limit + 4, il, ht, true);
            filter_loop(vd, 1, uvs, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; k++) filter_loop(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
            filter_loop(ud + 4, 1, uvs, 8, limit, il, ht, false);
            filter_loop(vd + 4, 1, uvs, 8, limit, il, ht, false);
          }
          if (mby > 0) {
            filter_loop(yd, ys, 1, 16, limit + 4, il, ht, true);
            filter_loop(ud, uvs, 1, 8, limit + 4, il, ht, true);
            filter_loop(vd, uvs, 1, 8, limit + 4, il, ht, true);
          }
          if (fi.inner) {
            for (int k = 1; k <= 3; k++)
              filter_loop(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
            filter_loop(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
            filter_loop(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
          }
        }
      }
  }
  return f;
}

// yuv.h VP8YuvToRgb: libwebp's 14-bit fixed point.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
inline void yuv_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// upsampling.c's fancy upsampler on one output row: `near` is the chroma row
// nearer to it, `far` the other (both the same row at the picture's edges).
void upsample_row(const uint8_t* yrow, const uint8_t* nu, const uint8_t* nv, const uint8_t* fu,
                  const uint8_t* fv, int width, uint8_t* out, int px) {
  // the packed-pair arithmetic of UPSAMPLE_FUNC, one channel at a time:
  // for the upper row of a pair `near` is the top sample row, for the lower the current one
  auto emit = [&](int x, int uu, int vv) { yuv_rgb(yrow[x], uu, vv, out + px * x); };
  const int last_pair = (width - 1) >> 1;
  int tl_u = nu[0], tl_v = nv[0], l_u = fu[0], l_v = fv[0];
  emit(0, (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2);
  for (int x = 1; x <= last_pair; x++) {
    const int t_u = nu[x], t_v = nv[x], c_u = fu[x], c_v = fv[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    emit(2 * x - 1, (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1);
    emit(2 * x, (d03_u + t_u) >> 1, (d03_v + t_v) >> 1);
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(width & 1)) emit(width - 1, (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2);
}

// The frame's RGB(A) as WebPDecode gives it in MODE_RGBA at its defaults.
void vp8_to_rgba(const VP8Frame& f, uint8_t* out, int stride) {
  const int W = f.width, H = f.height, uvs = f.uvstride;
  auto Y = [&](int y) { return &f.y[size_t(y) * f.ystride]; };
  auto U = [&](int y) { return &f.u[size_t(y) * uvs]; };
  auto V = [&](int y) { return &f.v[size_t(y) * uvs]; };
  std::vector<uint8_t> row(size_t(W) * 4);
  auto put = [&](int y) {
    uint8_t* o = out + size_t(y) * stride;
    for (int x = 0; x < W; x++) {
      o[4 * x] = row[4 * x];
      o[4 * x + 1] = row[4 * x + 1];
      o[4 * x + 2] = row[4 * x + 2];
      o[4 * x + 3] = 255;
    }
  };
  upsample_row(Y(0), U(0), V(0), U(0), V(0), W, row.data(), 4);
  put(0);
  for (int k = 1; 2 * k < H; k++) {          // rows 2k - 1 and 2k between chroma rows k - 1, k
    upsample_row(Y(2 * k - 1), U(k - 1), V(k - 1), U(k), V(k), W, row.data(), 4);
    put(2 * k - 1);
    upsample_row(Y(2 * k), U(k), V(k), U(k - 1), V(k - 1), W, row.data(), 4);
    put(2 * k);
  }
  if (!(H & 1)) {                            // the last row of an even height
    const int k = H / 2 - 1;
    upsample_row(Y(H - 1), U(k), V(k), U(k), V(k), W, row.data(), 4);
    put(H - 1);
  }
}

// ------------------------------------------------------------- VP8L (lossless)

// Bits read least significant first.  libwebp's VP8LBitReader keeps a 64-bit
// window, so a stream shorter than 8 bytes may be read up to bit 64 before
// it counts as over-read; past max(8 * n, 64) bits `eos` is set and the
// decode fails, as libwebp's does.
struct LBits {
  const uint8_t* d = nullptr;
  size_t n = 0;
  uint64_t pos = 0, limit = 0;
  bool eos = false;
  void init(const uint8_t* p, size_t len) {
    d = p;
    n = len;
    pos = 0;
    limit = std::max<uint64_t>(uint64_t(len) * 8, 64);
    eos = false;
  }
  uint64_t peek() const {               // the next 56 or more bits, zeros past the end
    size_t b = size_t(pos >> 3);
    uint64_t v = 0;
    if (b + 8 <= n) {
      std::memcpy(&v, d + b, 8);
    } else {
      for (size_t i = 0; i < 8 && b + i < n; i++) v |= uint64_t(d[b + i]) << (8 * i);
    }
    return v >> (pos & 7);
  }
  void skip(int k) {
    pos += uint64_t(k);
    if (pos > limit) eos = true;
  }
  uint32_t read(int k) {                // k <= 32
    if (k == 0) return 0;
    uint32_t v = uint32_t(peek() & ((uint64_t(1) << k) - 1));
    skip(k);
    return v;
  }
};

// A canonical prefix code (VP8LBuildHuffmanTable's checks: no length over
// 15, not all zero, the Kraft sum exactly one unless one symbol alone,
// which then takes no bits).
struct HCode {
  int single = -1;
  uint16_t fast[256];                   // (length << 12) | symbol for codes of <= 8 bits
  int count[16], first[16], offset[16];
  std::vector<uint16_t> sorted;
  bool build(const std::vector<int>& lengths, int size) {
    std::memset(count, 0, sizeof(count));
    int nonzero = 0;
    for (int s = 0; s < size; s++) {
      if (lengths[s] > 15) return false;
      count[lengths[s]]++;
      if (lengths[s]) nonzero++;
    }
    if (nonzero == 0) return false;
    sorted.clear();
    for (int len = 1; len <= 15; len++)
      for (int s = 0; s < size; s++)
        if (lengths[s] == len) sorted.push_back(uint16_t(s));
    if (nonzero == 1) {
      single = sorted[0];
      return true;
    }
    single = -1;
    int open = 1;
    for (int len = 1; len <= 15; len++) {
      open <<= 1;
      open -= count[len];
      if (open < 0) return false;
    }
    if (open != 0) return false;
    int code = 0, off = 0;
    std::memset(fast, 0, sizeof(fast));
    for (int len = 1; len <= 15; len++) {
      first[len] = code;
      offset[len] = off;
      for (int i = 0; i < count[len]; i++, code++, off++) {
        if (len <= 8) {
          int rev = 0;
          for (int b = 0; b < len; b++) rev |= ((code >> (len - 1 - b)) & 1) << b;
          for (int r = rev; r < 256; r += 1 << len)
            fast[r] = uint16_t((len << 12) | sorted[off]);
        }
      }
      code <<= 1;
    }
    return true;
  }
  int decode(LBits& br) const {
    if (single >= 0) return single;
    uint64_t bits = br.peek();
    uint16_t e = fast[bits & 255];
    if (e) {
      br.skip(e >> 12);
      return e & 0xfff;
    }
    int code = 0;
    for (int len = 1; len <= 15; len++) {
      code = (code << 1) | int((bits >> (len - 1)) & 1);
      if (count[len] && code >= first[len] && code - first[len] < count[len]) {
        br.skip(len);
        return sorted[offset[len] + code - first[len]];
      }
    }
    throw Error{"corrupt WebP lossless data (no prefix code matches)"};
  }
};

struct HGroup {
  HCode codes[5];                       // green+length+cache, red, blue, alpha, distance
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct LTransform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

inline int sub_size(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

void read_code(LBits& br, int alphabet, HCode& out) {
  std::vector<int> lengths(std::max(alphabet, 256), 0);
  if (br.read(1)) {                     // simple code: one or two symbols
    const int nsym = int(br.read(1)) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    lengths[br.read(first_bits)] = 1;
    if (nsym == 2) lengths[br.read(8)] = 1;
  } else {
    std::vector<int> cl(19, 0);
    const int ncodes = int(br.read(4)) + 4;
    for (int i = 0; i < ncodes; i++) cl[kCodeLengthCodeOrder[i]] = int(br.read(3));
    HCode lc;
    if (!lc.build(cl, 19)) throw Error{"corrupt WebP lossless data (code length code)"};
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * int(br.read(3));
      max_symbol = 2 + int(br.read(nbits));
      if (max_symbol > alphabet) throw Error{"corrupt WebP lossless data (too many code lengths)"};
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lc.decode(br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        const int slot = len - 16;
        const int repeat = int(br.read(extra[slot])) + base[slot];
        if (symbol + repeat > alphabet) throw Error{"corrupt WebP lossless data (code length run)"};
        const int v = len == 16 ? prev : 0;
        for (int i = 0; i < repeat; i++) lengths[symbol++] = v;
      }
    }
  }
  if (br.eos) throw Error{"truncated WebP lossless data"};
  if (!out.build(lengths, alphabet)) throw Error{"corrupt WebP lossless data (prefix code)"};
}

inline uint32_t plane_to_distance(int xsize, int code) {
  if (code > 120) return uint32_t(code - 120);
  const int dist_code = kCodeToPlane[code - 1];
  const int yoffset = dist_code >> 4, xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? uint32_t(dist) : 1u;
}

inline int copy_amount(int sym, LBits& br) {
  if (sym < 4) return sym + 1;
  const int extra = (sym - 2) >> 1;
  const int offset = (2 + (sym & 1)) << extra;
  return offset + int(br.read(extra)) + 1;
}

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<LTransform>* transforms, bool alpha = false);

// DecodeImageData: the entropy-coded ARGB pixels of one image.  `lenient`
// is libwebp's 8-bit alpha path (DecodeAlphaData, an alpha plane coded with
// colour indexing alone, no colour cache and one-symbol red, blue and alpha
// codes): reading past the end of the data is an error there only when
// pixels are still missing.
std::vector<uint32_t> decode_pixels(LBits& br, int w, int h, int cache_bits,
                                    const std::vector<HGroup>& groups,
                                    const std::vector<uint32_t>& meta, int meta_bits,
                                    bool lenient) {
  const size_t total = size_t(w) * h;
  std::vector<uint32_t> px(total);
  std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
  const int meta_w = meta_bits ? sub_size(w, meta_bits) : 0;
  size_t pos = 0, cached = 0;
  int col = 0, row = 0;
  auto advance = [&](size_t k) {
    pos += k;
    col += int(k % size_t(w));
    row += int(k / size_t(w));
    if (col >= w) {
      col -= w;
      row++;
    }
  };
  while (pos < total && !(lenient && br.eos)) {
    const HGroup& g = groups[meta.empty() ? 0
                                          : (meta[size_t(row >> meta_bits) * meta_w +
                                                  (col >> meta_bits)] >> 8) & 0xffff];
    const int code = g.codes[0].decode(br);
    if (code < 256) {
      const uint32_t red = g.codes[1].decode(br), blue = g.codes[2].decode(br),
                     alpha = g.codes[3].decode(br);
      if (br.eos && !lenient) break;
      px[pos] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
      advance(1);
    } else if (code < 256 + 24) {
      const int length = copy_amount(code - 256, br);
      const int dsym = g.codes[4].decode(br);
      const uint32_t dist = plane_to_distance(w, copy_amount(dsym, br));
      if (br.eos && !lenient) break;
      if (pos < dist || total - pos < size_t(length))
        throw Error{"corrupt WebP lossless data (backward reference out of range)"};
      for (int i = 0; i < length; i++) px[pos + i] = px[pos + i - dist];
      advance(size_t(length));
    } else if (cache_bits && code < 280 + (1 << cache_bits)) {
      while (cached < pos) {
        const uint32_t c = px[cached++];
        cache[(c * 0x1e35a7bdu) >> (32 - cache_bits)] = c;
      }
      px[pos] = cache[code - 280];
      advance(1);
    } else {
      throw Error{"corrupt WebP lossless data (symbol out of range)"};
    }
  }
  if ((br.eos && !lenient) || pos < total) throw Error{"truncated WebP lossless data"};
  return px;
}

std::vector<uint32_t> decode_stream(LBits& br, int xsize, int ysize, bool level0,
                                    std::vector<LTransform>* transforms, bool alpha) {
  int coded_x = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      LTransform t;
      t.type = int(br.read(2));
      if (seen & (1u << t.type)) throw Error{"corrupt WebP lossless data (a transform twice)"};
      seen |= 1u << t.type;
      t.xsize = coded_x;
      t.ysize = ysize;
      if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
        t.bits = int(br.read(3)) + 2;
        t.data = decode_stream(br, sub_size(coded_x, t.bits), sub_size(ysize, t.bits), false,
                               nullptr);
      } else if (t.type == COLOR_INDEXING) {
        const int ncolors = int(br.read(8)) + 1;
        t.bits = ncolors > 16 ? 0 : ncolors > 4 ? 1 : ncolors > 2 ? 2 : 3;
        std::vector<uint32_t> pal = decode_stream(br, ncolors, 1, false, nullptr);
        t.data.assign(size_t(1) << (8 >> t.bits), 0);
        // the palette is delta-coded, byte by byte
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4; i++) dst[i] = src[i];
        for (int i = 4; i < 4 * ncolors; i++) dst[i] = uint8_t(src[i] + dst[i - 4]);
        coded_x = sub_size(coded_x, t.bits);
      }
      transforms->push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) throw Error{"corrupt WebP lossless data (colour cache)"};
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, ngroups = 1;
  if (level0 && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    meta = decode_stream(br, sub_size(coded_x, meta_bits), sub_size(ysize, meta_bits), false,
                         nullptr);
    for (uint32_t& m : meta) ngroups = std::max(ngroups, int((m >> 8) & 0xffff) + 1);
  }
  if (br.eos) throw Error{"truncated WebP lossless data"};
  std::vector<HGroup> groups(ngroups);
  const int alphabets[5] = {256 + 24 + (cache_bits ? 1 << cache_bits : 0), 256, 256, 256, 40};
  for (auto& g : groups)
    for (int j = 0; j < 5; j++) read_code(br, alphabets[j], g.codes[j]);
  bool lenient = alpha && transforms->size() == 1 &&
                 (*transforms)[0].type == COLOR_INDEXING && cache_bits == 0;
  for (const HGroup& g : groups)
    lenient = lenient && g.codes[1].single >= 0 && g.codes[2].single >= 0 &&
              g.codes[3].single >= 0;
  return decode_pixels(br, coded_x, ysize, cache_bits, groups, meta, meta_bits, lenient);
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline uint32_t clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : uint32_t(a); }
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

uint32_t predict_lossless(int mode, uint32_t L, const uint32_t* top) {
  const uint32_t T = top[0], TL = top[-1], TR = top[1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {
      int pa_minus_pb = 0;
      for (int s = 0; s < 32; s += 8) {
        const int a = (T >> s) & 0xff, b = (L >> s) & 0xff, c = (TL >> s) & 0xff;
        pa_minus_pb += std::abs(b - c) - std::abs(a - c);
      }
      return pa_minus_pb <= 0 ? T : L;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= clip255(int((L >> s) & 0xff) + int((T >> s) & 0xff) - int((TL >> s) & 0xff)) << s;
      return out;
    }
    case 13: {
      const uint32_t ave = average2(L, T);
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8) {
        const int a = (ave >> s) & 0xff, b = (TL >> s) & 0xff;
        out |= clip255(a + (a - b) / 2) << s;
      }
      return out;
    }
    default: return 0xff000000u;        // 0, and 14-15 (libwebp's padding sentinels)
  }
}

// VP8LInverseTransform, one transform over the whole image; `px` holds
// t.xsize-wide rows (packed ones for colour indexing, which widens them).
void inverse_transform(const LTransform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == SUBTRACT_GREEN) {
    for (uint32_t& p : px) {
      const uint32_t g = (p >> 8) & 0xff;
      const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      p = (p & 0xff00ff00u) | rb;
    }
  } else if (t.type == PREDICTOR) {
    const int tiles = sub_size(w, t.bits);
    for (int y = 0; y < h; y++) {
      uint32_t* row = &px[size_t(y) * w];
      if (y == 0) {
        row[0] = add_pixels(row[0], 0xff000000u);
        for (int x = 1; x < w; x++) row[x] = add_pixels(row[x], row[x - 1]);
        continue;
      }
      const uint32_t* up = row - w;
      row[0] = add_pixels(row[0], up[0]);
      const uint32_t* modes = &t.data[size_t(y >> t.bits) * tiles];
      for (int x = 1; x < w; x++) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict_lossless(mode, row[x - 1], up + x));
      }
    }
  } else if (t.type == CROSS_COLOR) {
    const int tiles = sub_size(w, t.bits);
    for (int y = 0; y < h; y++) {
      uint32_t* row = &px[size_t(y) * w];
      const uint32_t* codes = &t.data[size_t(y >> t.bits) * tiles];
      for (int x = 0; x < w; x++) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = int8_t(code & 0xff), g2b = int8_t((code >> 8) & 0xff),
                     r2b = int8_t((code >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = int8_t((argb >> 8) & 0xff);
        int red = (argb >> 16) & 0xff, blue = argb & 0xff;
        red = (red + ((int(g2r) * green) >> 5)) & 0xff;
        blue += (int(g2b) * green) >> 5;
        blue += (int(r2b) * int8_t(red)) >> 5;
        blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
      }
    }
  } else {                              // COLOR_INDEXING
    const int packed_w = sub_size(w, t.bits);
    std::vector<uint32_t> out(size_t(w) * h);
    const int bpp = 8 >> t.bits;
    const uint32_t mask = (1u << bpp) - 1, count_mask = (1u << t.bits) - 1;
    for (int y = 0; y < h; y++) {
      const uint32_t* src = &px[size_t(y) * packed_w];
      uint32_t* dst = &out[size_t(y) * w];
      uint32_t packed = 0;
      for (int x = 0; x < w; x++) {
        if ((uint32_t(x) & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & mask];
        packed >>= bpp;
      }
    }
    px.swap(out);
  }
}

// A VP8L image stream of xsize x ysize -> ARGB (`alpha`: an ALPH plane's).
std::vector<uint32_t> decode_lossless(LBits& br, int xsize, int ysize, bool alpha = false) {
  std::vector<LTransform> transforms;
  std::vector<uint32_t> px = decode_stream(br, xsize, ysize, true, &transforms, alpha);
  for (int i = int(transforms.size()) - 1; i >= 0; i--) inverse_transform(transforms[i], px);
  return px;
}

// ---------------------------------------------------------------- ALPH

// alpha_dec.c: the ALPH chunk's plane of width x height, unfiltered.
std::vector<uint8_t> decode_alpha(const uint8_t* p, size_t n, int width, int height) {
  if (n < 1) throw Error{"empty WebP ALPH chunk"};
  const int method = p[0] & 3, filter = (p[0] >> 2) & 3, pre = (p[0] >> 4) & 3,
            rsrv = (p[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) throw Error{"bad WebP ALPH header"};
  const size_t npx = size_t(width) * height;
  std::vector<uint8_t> a(npx);
  if (method == 0) {
    if (n - 1 < npx) throw Error{"truncated WebP ALPH data"};
    std::memcpy(a.data(), p + 1, npx);
  } else {
    LBits br;
    br.init(p + 1, n - 1);
    std::vector<uint32_t> argb = decode_lossless(br, width, height, true);
    for (size_t i = 0; i < npx; i++) a[i] = uint8_t((argb[i] >> 8) & 0xff);
  }
  if (filter == 0) return a;
  std::vector<uint8_t> out(npx);
  for (int y = 0; y < height; y++) {
    const uint8_t* in = &a[size_t(y) * width];
    uint8_t* o = &out[size_t(y) * width];
    const uint8_t* prev = y ? o - width : nullptr;
    if (!prev || filter == 1) {          // horizontal (and every first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < width; x++) pred = o[x] = uint8_t(pred + in[x]);
    } else if (filter == 2) {            // vertical
      for (int x = 0; x < width; x++) o[x] = uint8_t(prev[x] + in[x]);
    } else {                             // gradient
      int top = prev[0], top_left = top, left = top;
      for (int x = 0; x < width; x++) {
        top = prev[x];
        const int g = left + top - top_left;
        left = uint8_t(in[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        o[x] = uint8_t(left);
      }
    }
  }
  return out;
}

// ------------------------------------------------------------ container

struct Chunk {
  uint32_t tag = 0;
  const uint8_t* p = nullptr;
  size_t n = 0;
};

inline uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | uint32_t(uint8_t(s[1])) << 8 | uint32_t(uint8_t(s[2])) << 16 |
         uint32_t(uint8_t(s[3])) << 24;
}
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}
inline int le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16); }

std::vector<Chunk> chunks(const uint8_t* p, size_t n, const char* where) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos < n) {
    if (n - pos < 8) throw Error{std::string("truncated WebP chunk header in ") + where};
    Chunk c;
    c.tag = le32(p + pos);
    c.n = le32(p + pos + 4);
    if (c.n > n - pos - 8) throw Error{std::string("truncated WebP chunk in ") + where};
    c.p = p + pos + 8;
    out.push_back(c);
    pos += 8 + c.n + (c.n & 1);
  }
  return out;
}

const int64_t kMaxPixels = 2 * int64_t(89478485);   // Pillow's decompression-bomb error

// One image (ALPH? + VP8, or VP8L) into `canvas` (RGBA, stride cw * 4) at (x0, y0).
void decode_frame(const std::vector<Chunk>& cs, int fw, int fh, uint8_t* canvas, int cw,
                  int x0, int y0) {
  const Chunk* alph = nullptr;
  const Chunk* img = nullptr;
  for (const Chunk& c : cs) {
    if (c.tag == fourcc("ALPH") && !alph && !img) alph = &c;
    if ((c.tag == fourcc("VP8 ") || c.tag == fourcc("VP8L")) && !img) img = &c;
  }
  if (!img) throw Error{"WebP file without an image chunk"};
  uint8_t* dst = canvas + (size_t(y0) * cw + x0) * 4;
  const int stride = cw * 4;
  if (img->tag == fourcc("VP8L")) {
    if (img->n < 5 || img->p[0] != 0x2f) throw Error{"bad WebP lossless signature"};
    LBits br;
    br.init(img->p, img->n);
    br.read(8);                          // the signature
    const int w = int(br.read(14)) + 1, h = int(br.read(14)) + 1;
    br.read(1);                          // alpha_is_used: a hint
    if (br.read(3) != 0) throw Error{"unknown WebP lossless version"};
    if ((fw && w != fw) || (fh && h != fh)) throw Error{"WebP lossless size differs from its frame"};
    std::vector<uint32_t> argb = decode_lossless(br, w, h);
    for (int y = 0; y < h; y++)
      for (int x = 0; x < w; x++) {
        const uint32_t c = argb[size_t(y) * w + x];
        uint8_t* o = dst + size_t(y) * stride + 4 * x;
        o[0] = uint8_t(c >> 16);
        o[1] = uint8_t(c >> 8);
        o[2] = uint8_t(c);
        o[3] = uint8_t(c >> 24);
      }
    return;
  }
  VP8Frame f = decode_vp8(img->p, img->n, fw, fh);
  vp8_to_rgba(f, dst, stride);
  if (alph) {
    std::vector<uint8_t> a = decode_alpha(alph->p, alph->n, f.width, f.height);
    for (int y = 0; y < f.height; y++)
      for (int x = 0; x < f.width; x++) dst[size_t(y) * stride + 4 * x + 3] = a[size_t(y) * f.width + x];
  }
}

struct Decoded {
  int w = 0, h = 0;
  bool alpha = false;
  std::vector<uint8_t> rgba;
};

// What Pillow's WebP plugin gives: libwebp's animation decoder's first frame
// (a still image is its own first frame) on a transparent black canvas, in
// MODE_RGBA; mode "RGBA" when the file says it has alpha, else "RGB".
Decoded decode_webp(const uint8_t* data, size_t len) {
  if (len < 12 || le32(data) != fourcc("RIFF") || le32(data + 8) != fourcc("WEBP"))
    throw Error{"not a WebP file"};
  const uint32_t riff = le32(data + 4);
  if (riff < 12) throw Error{"WebP RIFF size too small"};
  if (riff > len - 8) throw Error{"truncated WebP file (the RIFF size exceeds the data)"};
  std::vector<Chunk> cs = chunks(data + 12, riff - 4, "the RIFF body");
  if (cs.empty()) throw Error{"empty WebP file"};
  Decoded out;
  const Chunk& c0 = cs[0];
  if (c0.tag == fourcc("VP8 ")) {
    if (c0.n < 10) throw Error{"truncated WebP VP8 chunk"};
    out.w = le24(c0.p + 6) & 0x3fff;
    out.h = le24(c0.p + 8) & 0x3fff;
  } else if (c0.tag == fourcc("VP8L")) {
    if (c0.n < 5 || c0.p[0] != 0x2f) throw Error{"bad WebP lossless signature"};
    const uint32_t hdr = le32(c0.p + 1);
    out.w = int(hdr & 0x3fff) + 1;
    out.h = int((hdr >> 14) & 0x3fff) + 1;
    out.alpha = (hdr >> 28) & 1;
  } else if (c0.tag == fourcc("VP8X")) {
    if (c0.n < 10) throw Error{"truncated WebP VP8X chunk"};
    const int flags = c0.p[0];
    out.w = le24(c0.p + 4) + 1;
    out.h = le24(c0.p + 7) + 1;
    out.alpha = flags & 0x10;
  } else {
    throw Error{"WebP file without a VP8, VP8L or VP8X chunk first"};
  }
  if (out.w <= 0 || out.h <= 0 || int64_t(out.w) * out.h > kMaxPixels)
    throw Error{"WebP canvas of " + std::to_string(out.w) + "x" + std::to_string(out.h)};
  out.rgba.assign(size_t(out.w) * out.h * 4, 0);
  if (c0.tag != fourcc("VP8X")) {
    decode_frame({c0}, out.w, out.h, out.rgba.data(), out.w, 0, 0);
    return out;
  }
  std::vector<Chunk> rest(cs.begin() + 1, cs.end());
  const bool animated = c0.p[0] & 0x02;
  if (animated) {
    for (const Chunk& c : rest) {
      if (c.tag != fourcc("ANMF")) continue;
      if (c.n < 16) throw Error{"truncated WebP ANMF chunk"};
      const int x0 = 2 * le24(c.p), y0 = 2 * le24(c.p + 3);
      const int fw = le24(c.p + 6) + 1, fh = le24(c.p + 9) + 1;
      if (x0 + fw > out.w || y0 + fh > out.h) throw Error{"WebP frame outside its canvas"};
      decode_frame(chunks(c.p + 16, c.n - 16, "an ANMF chunk"), fw, fh, out.rgba.data(), out.w,
                   x0, y0);
      return out;
    }
    throw Error{"animated WebP file without a frame"};
  }
  bool has_alph = false;
  for (const Chunk& c : rest) has_alph |= c.tag == fourcc("ALPH");
  out.alpha = out.alpha || has_alph;
  decode_frame(rest, out.w, out.h, out.rgba.data(), out.w, 0, 0);
  return out;
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// Decode a WebP file's first frame: *out holds malloc'd [h, w, 4] RGBA
// (free with webp_free), *alpha says whether PIL's mode is RGBA; 0 returns.
int webp_decode(const uint8_t* data, size_t len, uint8_t** out, int* width, int* height,
                int* alpha, char* err, int errlen) {
  try {
    Decoded d = decode_webp(data, len);
    *out = static_cast<uint8_t*>(std::malloc(d.rgba.size()));
    if (!*out) throw Error{"out of memory"};
    std::memcpy(*out, d.rgba.data(), d.rgba.size());
    *width = d.w;
    *height = d.h;
    *alpha = d.alpha;
    return 0;
  } catch (const Error& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, std::string("WebP decoder failed: ") + e.what());
  }
  return 1;
}

void webp_free(void* p) { std::free(p); }

}  // extern "C"
