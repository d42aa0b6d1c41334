// JPEG decoding and encoding on the host, in integer arithmetic, giving the
// pixels of cv2.imread / cv2.imdecode (IMREAD_COLOR) and the bytes of
// cv2.imencode(".jpg") with OpenCV's libjpeg-turbo build.
//
// Decoder: baseline, extended (8-bit) and progressive Huffman files, restart
// intervals, libjpeg's marker resynchronisation, the islow IDCT
// (jidctint.c), the upsampler jdsample.c picks for each component with fancy
// upsampling on, the colour space guessed as jdapimin.c guesses it, and
// OpenCV's CMYK -> BGR rule. A file cut short decodes as libjpeg's file
// source leaves it: the rest of the scan is zeros, and a progressive file
// whose coefficients are not all known is block-smoothed as jdcoefct.c's
// decompress_smooth_data does. Refused with an error message: arithmetic
// coding, lossless and hierarchical files, and precisions other than 8
// bits.
//
// Encoder: baseline 4:2:0 YCbCr at an IJG quality, with OpenCV's defaults
// (JFIF 1.01 APP0, the IJG tables scaled with force_baseline, the standard
// Huffman tables, the islow FDCT (jfdctint.c) and libjpeg-turbo's
// reciprocal quantisation).
//
// C interface (no state, no memory owned across calls; errors are written
// into the caller's buffer `err`):
//   jpeg_info(data, n, info[4], err, errlen) -> 0 | -1
//       info = height, width, components, EXIF orientation (0 if none)
//   jpeg_decode_bgr(data, n, out (height*width*3), err, errlen)
//       -> 0 | 1 (decoded, but the data ends before its EOI marker) | -1
//   jpeg_encode_bound(height, width) -> bytes the encoder may write
//   jpeg_encode_bgr(bgr, height, width, quality, out, cap, err, errlen)
//       -> bytes written | -1

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Fail{msg}; }

std::string hex_byte(int v) {
  const char* digits = "0123456789ABCDEF";
  return std::string("0x") + digits[(v >> 4) & 15] + digits[v & 15];
}

// zigzag index -> natural index; 16 extra entries for corrupt runs past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (ITU T.81 annex K.3), bits[1..16] and values.
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The IJG quantisation tables (natural order), scaled by quality.
const int kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ------------------------------------------------------------ fixed point

const int kScaleBits = 16;  // jdcolor.c / jccolor.c
const int32_t kOneHalf = 1 << (kScaleBits - 1);
inline int32_t fix16(double x) { return (int32_t)(x * (1 << kScaleBits) + 0.5); }

const int kConstBits = 13;  // jidctint.c / jfdctint.c
const int kPass1Bits = 2;
const int32_t F_0_298631336 = 2446, F_0_390180644 = 3196, F_0_541196100 = 4433,
              F_0_765366865 = 6270, F_0_899976223 = 7373, F_1_175875602 = 9633,
              F_1_501321110 = 12299, F_1_847759065 = 15137,
              F_1_961570560 = 16069, F_2_053119869 = 16819,
              F_2_562915447 = 20995, F_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
// the post-IDCT range limit of libjpeg-turbo's SIMD IDCT (OpenCV's build):
// x + 128 saturated (jidctint.c's C table would wrap x modulo 1024, which
// only coefficients far out of range reach)
inline uint8_t idct_limit(int32_t x) { return clamp255(x + 128); }

// jidctint.c: jpeg_idct_islow, dequantising with `q` (natural order)
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int32_t dc = (int32_t)((uint32_t)((int32_t)ip[0] * qp[0]) << kPass1Bits);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = (int32_t)ip[16] * qp[16], z3 = (int32_t)ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * (-F_1_847759065);
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = (int32_t)ip[0] * qp[0];
    z3 = (int32_t)ip[32] * qp[32];
    int32_t tmp0 = (int32_t)((uint32_t)(z2 + z3) << kConstBits);
    int32_t tmp1 = (int32_t)((uint32_t)(z2 - z3) << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)ip[56] * qp[56];
    tmp1 = (int32_t)ip[40] * qp[40];
    tmp2 = (int32_t)ip[24] * qp[24];
    tmp3 = (int32_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    wp[0] = descale(tmp10 + tmp3, s);
    wp[56] = descale(tmp10 - tmp3, s);
    wp[8] = descale(tmp11 + tmp2, s);
    wp[48] = descale(tmp11 - tmp2, s);
    wp[16] = descale(tmp12 + tmp1, s);
    wp[40] = descale(tmp12 - tmp1, s);
    wp[24] = descale(tmp13 + tmp0, s);
    wp[32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int s = kConstBits + kPass1Bits + 3;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t v = idct_limit(descale(wp[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * (-F_1_847759065);
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    int32_t tmp0 = (int32_t)((uint32_t)(wp[0] + wp[4]) << kConstBits);
    int32_t tmp1 = (int32_t)((uint32_t)(wp[0] - wp[4]) << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, s));
    op[7] = idct_limit(descale(tmp10 - tmp3, s));
    op[1] = idct_limit(descale(tmp11 + tmp2, s));
    op[6] = idct_limit(descale(tmp11 - tmp2, s));
    op[2] = idct_limit(descale(tmp12 + tmp1, s));
    op[5] = idct_limit(descale(tmp12 - tmp1, s));
    op[3] = idct_limit(descale(tmp13 + tmp0, s));
    op[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

// jfdctint.c: jpeg_fdct_islow on 16-bit elements (libjpeg-turbo's SIMD
// build keeps DCTELEM at 16 bits)
void fdct_islow(int16_t* d) {
  for (int r = 0; r < 8; r++) {
    int16_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = (int16_t)((tmp10 - tmp11) * (1 << kPass1Bits));
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    const int s = kConstBits - kPass1Bits;
    p[2] = (int16_t)descale(z1 + tmp13 * F_0_765366865, s);
    p[6] = (int16_t)descale(z1 + tmp12 * (-F_1_847759065), s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int16_t)descale(tmp4 + z1 + z3, s);
    p[5] = (int16_t)descale(tmp5 + z2 + z4, s);
    p[3] = (int16_t)descale(tmp6 + z2 + z3, s);
    p[1] = (int16_t)descale(tmp7 + z1 + z4, s);
  }
  for (int c = 0; c < 8; c++) {
    int16_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)descale(tmp10 + tmp11, kPass1Bits);
    p[32] = (int16_t)descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    const int s = kConstBits + kPass1Bits;
    p[16] = (int16_t)descale(z1 + tmp13 * F_0_765366865, s);
    p[48] = (int16_t)descale(z1 + tmp12 * (-F_1_847759065), s);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int16_t)descale(tmp4 + z1 + z3, s);
    p[40] = (int16_t)descale(tmp5 + z2 + z4, s);
    p[24] = (int16_t)descale(tmp6 + z2 + z3, s);
    p[8] = (int16_t)descale(tmp7 + z1 + z4, s);
  }
}

// ================================================================ decoder

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

const int kLook = 9;  // bits of the decoding lookahead table

struct HuffDec {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol; 0: a longer code
};

HuffSpec std_spec(bool dc, int index) {
  HuffSpec s;
  s.defined = true;
  const uint8_t* bits = dc ? (index ? kDcChromBits : kDcLumBits)
                           : (index ? kAcChromBits : kAcLumBits);
  const uint8_t* vals = dc ? kDcVals : (index ? kAcChromVals : kAcLumVals);
  std::memcpy(s.bits, bits, 17);
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  std::memcpy(s.vals, vals, n);
  return s;
}

// jdhuff.c: jpeg_make_d_derived_tbl
void derive(const HuffSpec& spec, bool dc, HuffDec* t) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = spec.bits[l];
    if (p + i > 256) fail("bad Huffman table");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  const int nsym = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - (int32_t)huffcode[p];
      p += spec.bits[l];
      t->maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->vals, spec.vals, 256);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= kLook; l++) {
    for (int i = 1; i <= spec.bits[l]; i++, p++) {
      uint32_t look = huffcode[p] << (kLook - l);
      for (int c = 1 << (kLook - l); c > 0; c--) t->look[look++] = (uint16_t)((l << 8) | spec.vals[p]);
    }
  }
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (spec.vals[i] > 15) fail("bad Huffman table");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + (int)((unsigned)-1 << s) + 1 : v; }

enum Upsample { kFull, kH2V1Fancy, kH2V1Box, kH1V2Fancy, kH2V2Fancy, kH2V2Box, kInt };

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int wib = 0, hib = 0;  // blocks covering the component's samples
  int bw = 0, bh = 0;    // blocks stored (padded to whole MCUs)
  int dw = 0, dh = 0;    // downsampled width and height
  std::vector<int16_t> coef;
  uint16_t q[64] = {0};  // latched quantisation table (natural order)
  bool latched = false;
  // jdphuff.c's coef_bits: the Al of the last scan that covered each
  // (zigzag) coefficient, -1 before any; prev_bits as they stood when the
  // component's last scan started
  int bits[64], prev_bits[64];
  int dc_tbl = 0, ac_tbl = 0;
  Upsample method = kFull;
  int hexp = 1, vexp = 1;
  std::vector<uint8_t> plane;  // IDCT output, (hib * 8) x (wib * 8)
  Component() {
    std::fill(bits, bits + 64, -1);
    std::fill(prev_bits, prev_bits + 64, -1);
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Markers up to the first SOS: frame, tables, orientation.
  void read_header();
  void decode(uint8_t* out);
  // true when decoding read past the end of the data (a file cut short)
  bool cut_short() const { return pos_ > n_; }

  int height = 0, width = 0, ncomp = 0, orientation = 0;

 private:
  enum Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

  uint8_t at(size_t i) const {  // a file cut short reads as FF D9 FF D9 ...
    return i < n_ ? d_[i] : (((i - n_) & 1) ? 0xD9 : 0xFF);
  }
  uint8_t byte() {
    if (pos_ >= n_ && in_headers_) fail("the file ends inside a marker segment");
    return at(pos_++);
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(int n) {
    if (in_headers_ && pos_ + (size_t)std::max(n, 0) > n_) fail("the file ends inside a marker segment");
    if (n > 0) pos_ += n;
  }
  int first_marker() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos_ = 2;
    return 0xD8;
  }
  // jdmarker.c: next_marker (bytes before a marker are skipped)
  int next_marker() {
    for (;;) {
      uint8_t c = at(pos_++);
      while (c != 0xFF) c = at(pos_++);
      do {
        c = at(pos_++);
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }
  int read_markers();  // -> 0xDA (SOS read) or 0xD9 (EOI)
  void get_sof(int marker);
  void get_sos();
  void get_dht();
  void get_dqt();
  void get_app(int marker);
  void initial_setup();
  void start_scan();
  void decode_scan();
  void output(uint8_t* out);
  bool smoothing_ok(std::vector<int>* latch) const;
  void smooth_idct(Component& c, int ci, const std::vector<int>& latch);
  void upsample_row(const Component& c, int y, uint8_t* dst) const;

  // entropy decoding
  void bits_reset() {
    buf_ = 0;
    nbits_ = 0;
    marker_ = 0;
    insufficient_ = false;
  }
  void fill() {
    while (nbits_ <= 56) {
      if (marker_) return;
      uint8_t c = at(pos_);
      if (c == 0xFF) {
        size_t p = pos_ + 1;
        uint8_t c2;
        do {
          c2 = at(p++);
        } while (c2 == 0xFF);
        pos_ = p;
        if (c2 != 0) {
          marker_ = c2;
          return;
        }
      } else {
        pos_++;
      }
      buf_ = (buf_ << 8) | c;
      nbits_ += 8;
    }
  }
  // n bits (n <= 16); zero bits past a marker, flagging the shortfall
  int get(int n) {
    if (nbits_ < n) {
      fill();
      if (nbits_ < n) {
        insufficient_ = true;
        buf_ <<= (32 - nbits_);
        nbits_ = 32;
      }
    }
    nbits_ -= n;
    return (int)((buf_ >> nbits_) & ((1u << n) - 1));
  }
  int huff(const HuffDec& t) {
    if (nbits_ < kLook) fill();
    if (nbits_ >= kLook) {
      int e = t.look[(buf_ >> (nbits_ - kLook)) & ((1 << kLook) - 1)];
      if (e) {
        nbits_ -= e >> 8;
        return e & 0xFF;
      }
    }
    int code = get(1), l = 1;
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  void process_restart();

  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool in_headers_ = true;
  bool saw_sof_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false, seen_app1_ = false;
  int adobe_transform_ = 0;
  Space space_ = kGrey;
  int restart_interval_ = 0;
  int unread_ = 0;
  int max_h_ = 1, max_v_ = 1;
  std::vector<Component> comps_;
  HuffSpec dc_spec_[4], ac_spec_[4];
  bool q_defined_[4] = {false, false, false, false};
  uint16_t qt_[4][64];
  // the scan being read
  int scan_n_ = 0, scan_comp_[4] = {0, 0, 0, 0};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int next_rst_ = 0, restarts_to_go_ = 0;
  int scans_ = 0, last_good_row_ = 0;  // SOS markers read; jdmaster's last_good_iMCU_row
  unsigned eobrun_ = 0;
  int last_dc_[4] = {0, 0, 0, 0};
  HuffDec dc_tab_[4], ac_tab_[4];
  uint64_t buf_ = 0;
  int nbits_ = 0, marker_ = 0;
  bool insufficient_ = false;
};

int Decoder::read_markers() {
  for (;;) {
    int m = unread_ ? unread_ : (pos_ == 0 ? first_marker() : next_marker());
    unread_ = 0;
    if (in_headers_ && pos_ > n_) fail("the file ends before its image data");
    switch (m) {
      case 0xD8:
        if (pos_ != 2) fail("a second SOI marker");
        break;
      case 0xC0:
      case 0xC1:
      case 0xC2:
        get_sof(m);
        break;
      case 0xC3:
        fail("SOF3 (lossless) is not supported");
      case 0xC9:
      case 0xCA:
        fail("SOF" + std::to_string(m - 0xC0) + " (arithmetic coding) is not supported");
      case 0xCB:
        fail("SOF11 (lossless, arithmetic coding) is not supported");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail("SOF" + std::to_string(m - 0xC0) + " (hierarchical) is not supported");
      case 0xC8:
        fail("marker JPG (0xC8) is not supported");
      case 0xDA:
        get_sos();
        return 0xDA;
      case 0xD9:
        if (in_headers_) fail("no image before EOI");
        return 0xD9;
      case 0xC4:
        get_dht();
        break;
      case 0xDB:
        get_dqt();
        break;
      case 0xDD: {
        if (u16() != 4) fail("bad DRI length");
        restart_interval_ = u16();
        break;
      }
      case 0xCC:  // DAC: arithmetic conditioning, unused without SOF9-11
      case 0xDC:  // DNL
      case 0xFE:  // COM
        skip(u16() - 2);
        break;
      case 0x01:  // TEM and RSTn carry no parameters
      case 0xD0:
      case 0xD1:
      case 0xD2:
      case 0xD3:
      case 0xD4:
      case 0xD5:
      case 0xD6:
      case 0xD7:
        break;
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          get_app(m);
          break;
        }
        fail("unknown marker " + hex_byte(m));
    }
  }
}

void Decoder::get_sof(int marker) {
  if (saw_sof_) fail("a second SOF marker");
  saw_sof_ = true;
  progressive_ = marker == 0xC2;
  int len = u16();
  int prec = byte();
  height = u16();
  width = u16();
  ncomp = byte();
  if (prec != 8)
    fail("SOF" + std::to_string(marker - 0xC0) + " with " + std::to_string(prec) +
         "-bit precision is not supported (8 bits only)");
  if (height <= 0 || width <= 0 || ncomp <= 0) fail("empty image");
  if (len - 8 != ncomp * 3) fail("bad SOF length");
  if (ncomp > 10) fail("too many components");
  comps_.resize(ncomp);
  for (auto& c : comps_) {
    c.id = byte();
    int hv = byte();
    c.h = (hv >> 4) & 15;
    c.v = hv & 15;
    c.tq = byte();
  }
}

void Decoder::get_sos() {
  if (!saw_sof_) fail("SOS before SOF");
  int len = u16();
  int n = byte();
  if (len != n * 2 + 6 || n < 1 || n > 4) fail("bad SOS length");
  for (int i = 0; i < n; i++) {
    int id = byte(), t = byte();
    int ci = -1;
    for (int k = 0; k < ncomp && ci < 0; k++) {
      bool used = false;
      for (int j = 0; j < i; j++) used |= scan_comp_[j] == k;
      if (comps_[k].id == id && !used) ci = k;
    }
    if (ci < 0) fail("SOS names an unknown component");
    scan_comp_[i] = ci;
    comps_[ci].dc_tbl = (t >> 4) & 15;
    comps_[ci].ac_tbl = t & 15;
  }
  scan_n_ = n;
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = (a >> 4) & 15;
  al_ = a & 15;
  next_rst_ = 0;
  scans_++;
}

void Decoder::get_dht() {
  int len = u16() - 2;
  while (len > 16) {
    int index = byte();
    HuffSpec s;
    s.defined = true;
    int count = 0;
    for (int i = 1; i <= 16; i++) count += (s.bits[i] = byte());
    len -= 17;
    if (count > 256 || count > len) fail("bad Huffman table");
    for (int i = 0; i < count; i++) s.vals[i] = byte();
    len -= count;
    bool ac = index & 0x10;
    if (ac) index -= 0x10;
    if (index < 0 || index > 3) fail("bad DHT index");
    (ac ? ac_spec_ : dc_spec_)[index] = s;
  }
  if (len != 0) fail("bad DHT length");
}

void Decoder::get_dqt() {
  int len = u16() - 2;
  while (len > 0) {
    len--;
    int n = byte();
    int prec = n >> 4;
    n &= 15;
    if (n > 3) fail("bad DQT index");
    if (len < (prec ? 128 : 64)) fail("bad DQT length");
    for (int i = 0; i < 64; i++) qt_[n][kNatural[i]] = (uint16_t)(prec ? u16() : byte());
    len -= prec ? 128 : 64;
    q_defined_[n] = true;
  }
  if (len != 0) fail("bad DQT length");
}

// OpenCV's ExifReader on the first APP1 segment: the TIFF header six bytes
// in, IFD0's entries read until tag 0x0112 or the data runs out.
int exif_orientation(const uint8_t* p, size_t n) {
  if (n <= 6) return 0;
  p += 6;
  n -= 6;
  bool intel = p[0] == 'I' && (n < 2 || p[1] == 'I');
  auto u16 = [&](size_t o, int* v) {
    if (o + 1 >= n) return false;
    *v = intel ? p[o] | (p[o + 1] << 8) : (p[o] << 8) | p[o + 1];
    return true;
  };
  int mark, a, b;
  if (!u16(2, &mark) || mark != 0x2A) return 0;
  if (!u16(4, &a) || !u16(6, &b)) return 0;
  uint32_t ifd = intel ? (uint32_t)a | ((uint32_t)b << 16) : ((uint32_t)a << 16) | (uint32_t)b;
  int count;
  if (!u16(ifd, &count)) return 0;
  size_t off = (size_t)ifd + 2;
  for (int i = 0; i < count; i++, off += 12) {
    int tag, value;
    if (!u16(off, &tag)) return 0;
    if (tag == 0x0112) return u16(off + 8, &value) ? value : 0;
  }
  return 0;
}

void Decoder::get_app(int marker) {
  int len = u16() - 2;
  size_t start = pos_;
  if (len > 0) skip(len);
  size_t have = std::min((size_t)std::max(len, 0), n_ > start ? n_ - start : 0);
  const uint8_t* p = d_ + start;
  if (marker == 0xE0 && have >= 14 && std::memcmp(p, "JFIF\0", 5) == 0) jfif_ = true;
  if (marker == 0xEE && have >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    adobe_ = true;
    adobe_transform_ = p[11];
  }
  if (marker == 0xE1 && !seen_app1_) {
    seen_app1_ = true;
    orientation = exif_orientation(p, have);
  }
}

// jdinput.c: initial_setup and the upsampler choice of jdsample.c
void Decoder::initial_setup() {
  if (height > 65500 || width > 65500) fail("image too large");
  if (ncomp != 1 && ncomp != 3 && ncomp != 4)
    fail(std::to_string(ncomp) + " components: not a colour space OpenCV reads");
  for (auto& c : comps_) {
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors");
    max_h_ = std::max(max_h_, c.h);
    max_v_ = std::max(max_v_, c.v);
  }
  const int mcux = (width + 8 * max_h_ - 1) / (8 * max_h_);
  const int mcuy = (height + 8 * max_v_ - 1) / (8 * max_v_);
  for (auto& c : comps_) {
    c.wib = (int)(((int64_t)width * c.h + 8 * max_h_ - 1) / (8 * max_h_));
    c.hib = (int)(((int64_t)height * c.v + 8 * max_v_ - 1) / (8 * max_v_));
    c.dw = (int)(((int64_t)width * c.h + max_h_ - 1) / max_h_);
    c.dh = (int)(((int64_t)height * c.v + max_v_ - 1) / max_v_);
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    if (c.h == max_h_ && c.v == max_v_) {
      c.method = kFull;
    } else if (c.h * 2 == max_h_ && c.v == max_v_) {
      c.method = c.dw > 2 ? kH2V1Fancy : kH2V1Box;
    } else if (c.h == max_h_ && c.v * 2 == max_v_) {
      c.method = kH1V2Fancy;
    } else if (c.h * 2 == max_h_ && c.v * 2 == max_v_) {
      c.method = c.dw > 2 ? kH2V2Fancy : kH2V2Box;
    } else if (max_h_ % c.h == 0 && max_v_ % c.v == 0) {
      c.method = kInt;
      c.hexp = max_h_ / c.h;
      c.vexp = max_v_ / c.v;
    } else {
      fail("fractional sampling factors are not supported");
    }
  }
  if (ncomp == 3) {
    if (jfif_)
      space_ = kYCbCr;
    else if (adobe_)
      space_ = adobe_transform_ == 0 ? kRGB : kYCbCr;
    else if (comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B')
      space_ = kRGB;
    else
      space_ = kYCbCr;
  } else if (ncomp == 4) {
    space_ = adobe_ && adobe_transform_ != 0 ? kYCCK : kCMYK;
  } else {
    space_ = kGrey;
  }
}

void Decoder::read_header() {
  if (read_markers() != 0xDA) fail("no image");
  initial_setup();
}

// Per-scan set-up: tables latched and derived, parameters checked.
void Decoder::start_scan() {
  for (int i = 0; i < scan_n_; i++) {
    Component& c = comps_[scan_comp_[i]];
    if (!c.latched) {
      if (c.tq > 3 || !q_defined_[c.tq]) fail("a component's quantisation table is not defined");
      std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
      c.latched = true;
    }
  }
  int blocks = 0;
  for (int i = 0; i < scan_n_; i++) {
    const Component& c = comps_[scan_comp_[i]];
    blocks += scan_n_ == 1 ? 1 : c.h * c.v;
  }
  if (blocks > 10) fail("too many blocks in an MCU");
  auto table = [&](bool dc, int index, HuffDec* out) {
    if (index > 3) fail("bad Huffman table index");
    const HuffSpec& s = (dc ? dc_spec_ : ac_spec_)[index];
    if (s.defined) {
      derive(s, dc, out);
    } else {
      if (index > 1) fail("a Huffman table is not defined");
      derive(std_spec(dc, index), dc, out);
    }
  };
  if (progressive_) {
    bool dc_band = ss_ == 0;
    bool bad = false;
    if (dc_band) {
      bad |= se_ != 0;
    } else {
      bad |= ss_ > se_ || se_ > 63 || scan_n_ != 1;
    }
    if (ah_ != 0) bad |= al_ != ah_ - 1;
    bad |= al_ > 13;
    if (bad) fail("bad progression parameters");
    for (int i = 0; i < scan_n_; i++) {  // jdphuff.c: start_pass_phuff_decoder
      Component& c = comps_[scan_comp_[i]];
      for (int k = std::min(ss_, 1); k <= std::max(se_, 9); k++) c.prev_bits[k] = scans_ > 1 ? c.bits[k] : 0;
      for (int k = ss_; k <= se_; k++) c.bits[k] = al_;
    }
    for (int i = 0; i < scan_n_; i++) {
      const Component& c = comps_[scan_comp_[i]];
      if (dc_band) {
        if (ah_ == 0) table(true, c.dc_tbl, &dc_tab_[i]);
      } else {
        table(false, c.ac_tbl, &ac_tab_[i]);
      }
    }
  } else {
    for (int i = 0; i < scan_n_; i++) {
      const Component& c = comps_[scan_comp_[i]];
      table(true, c.dc_tbl, &dc_tab_[i]);
      table(false, c.ac_tbl, &ac_tab_[i]);
    }
  }
}

// jdhuff.c / jdphuff.c: process_restart and jdmarker.c's
// read_restart_marker with the default jpeg_resync_to_restart
void Decoder::process_restart() {
  buf_ = 0;
  nbits_ = 0;
  if (!marker_) marker_ = next_marker();
  if (marker_ == 0xD0 + next_rst_) {
    marker_ = 0;
  } else {
    for (;;) {
      int m = marker_, action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((next_rst_ + 1) & 7) || m == 0xD0 + ((next_rst_ + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((next_rst_ - 1) & 7) || m == 0xD0 + ((next_rst_ - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        marker_ = 0;
        break;
      }
      if (action == 3) break;
      marker_ = next_marker();
    }
  }
  next_rst_ = (next_rst_ + 1) & 7;
  for (int i = 0; i < 4; i++) last_dc_[i] = 0;
  eobrun_ = 0;
  restarts_to_go_ = restart_interval_;
  // the out-of-data flag stays set when the restart left us at a marker:
  // the next segment is then empty
  if (marker_ == 0) insufficient_ = false;
}

void Decoder::decode_scan() {
  start_scan();
  bits_reset();
  eobrun_ = 0;
  for (int i = 0; i < 4; i++) last_dc_[i] = 0;
  restarts_to_go_ = restart_interval_;
  int mcux, mcuy;
  if (scan_n_ == 1) {
    mcux = comps_[scan_comp_[0]].wib;
    mcuy = comps_[scan_comp_[0]].hib;
  } else {
    mcux = (width + 8 * max_h_ - 1) / (8 * max_h_);
    mcuy = (height + 8 * max_v_ - 1) / (8 * max_v_);
  }
  int16_t* blocks[10];
  int owner[10];
  const int p1 = 1 << al_, m1 = -1 * (1 << al_);
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      int nb = 0;
      for (int i = 0; i < scan_n_; i++) {
        Component& c = comps_[scan_comp_[i]];
        if (scan_n_ == 1) {
          owner[nb] = i;
          blocks[nb++] = &c.coef[((size_t)my * c.bw + mx) * 64];
        } else {
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++) {
              owner[nb] = i;
              blocks[nb++] = &c.coef[((size_t)(my * c.v + by) * c.bw + mx * c.h + bx) * 64];
            }
        }
      }
      if (!insufficient_) last_good_row_ = scan_n_ == 1 ? my / comps_[scan_comp_[0]].v : my;
      if (restart_interval_ && restarts_to_go_ == 0) process_restart();
      if (!progressive_) {
        if (!insufficient_) {
          for (int b = 0; b < nb; b++) {
            int16_t* blk = blocks[b];
            int s = huff(dc_tab_[owner[b]]);
            if (s) s = extend(get(s), s);
            int dc = (int)((unsigned)s + (unsigned)last_dc_[owner[b]]);
            last_dc_[owner[b]] = dc;
            blk[0] = (int16_t)dc;
            const HuffDec& at = ac_tab_[owner[b]];
            for (int k = 1; k < 64; k++) {
              int rs = huff(at);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(get(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
          }
        }
      } else if (ss_ == 0 && ah_ == 0) {  // DC first
        if (!insufficient_) {
          for (int b = 0; b < nb; b++) {
            int s = huff(dc_tab_[owner[b]]);
            if (s) s = extend(get(s), s);
            int dc = (int)((unsigned)s + (unsigned)last_dc_[owner[b]]);
            last_dc_[owner[b]] = dc;
            blocks[b][0] = (int16_t)((unsigned)dc << al_);
          }
        }
      } else if (ss_ == 0) {  // DC refinement
        for (int b = 0; b < nb; b++)
          if (get(1)) blocks[b][0] = (int16_t)(blocks[b][0] | p1);
      } else if (ah_ == 0) {  // AC first
        if (!insufficient_) {
          if (eobrun_ > 0) {
            eobrun_--;
          } else {
            int16_t* blk = blocks[0];
            for (int k = ss_; k <= se_; k++) {
              int rs = huff(ac_tab_[0]);
              int r = rs >> 4, s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)((unsigned)extend(get(s), s) << al_);
              } else if (r == 15) {
                k += 15;
              } else {
                eobrun_ = 1u << r;
                if (r) eobrun_ += get(r);
                eobrun_--;
                break;
              }
            }
          }
        }
      } else if (!insufficient_) {  // AC refinement (jdphuff.c)
        int16_t* blk = blocks[0];
        int k = ss_;
        if (eobrun_ == 0) {
          for (; k <= se_; k++) {
            int rs = huff(ac_tab_[0]);
            int r = rs >> 4, s = rs & 15;
            if (s) {
              s = get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun_ = 1u << r;
              if (r) eobrun_ += get(r);
              break;
            }
            do {
              int16_t* coef = blk + kNatural[k];
              if (*coef != 0) {
                if (get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
              } else {
                if (--r < 0) break;
              }
              k++;
            } while (k <= se_);
            if (s) blk[kNatural[k]] = (int16_t)s;
          }
        }
        if (eobrun_ > 0) {
          for (; k <= se_; k++) {
            int16_t* coef = blk + kNatural[k];
            if (*coef != 0 && get(1) && (*coef & p1) == 0) *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          }
          eobrun_--;
        }
      }
      if (restart_interval_) restarts_to_go_--;
    }
  }
  unread_ = marker_;
}

void Decoder::decode(uint8_t* out) {
  read_header();
  in_headers_ = false;
  // jdinput.c: a file of one baseline scan ends with it (what follows is
  // not read); otherwise every scan up to EOI is consumed before output
  const bool multiscan = progressive_ || scan_n_ < ncomp;
  for (;;) {
    decode_scan();
    if (!multiscan) break;
    if (read_markers() == 0xD9) break;
  }
  output(out);
}

// jdcoefct.c: smoothing_ok. Smoothing applies to a progressive file some
// of whose first nine AC coefficients are not known to full precision (a
// file cut short). `latch` gets each component's coef_bits[0..9] (at
// 20 * ci) and, at 20 * ci + 10, their values when its last scan started.
bool Decoder::smoothing_ok(std::vector<int>* latch) const {
  if (!progressive_) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  latch->assign((size_t)20 * ncomp, 0);
  bool useful = false;
  for (int ci = 0; ci < ncomp; ci++) {
    const Component& c = comps_[ci];
    if (!c.latched) return false;
    for (int k = 0; k < 10; k++)
      if (c.q[kPos[k]] == 0) return false;
    if (c.bits[0] < 0) return false;
    int* cur = latch->data() + 20 * ci;
    int* prev = cur + 10;
    cur[0] = c.bits[0];
    for (int k = 1; k < 10; k++) {
      prev[k] = scans_ > 1 ? c.prev_bits[k] : -1;
      cur[k] = c.bits[k];
      if (c.bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// jdcoefct.c: decompress_smooth_data (libjpeg-turbo's 5x5 form). Each
// block's first nine AC coefficients, where still zero and not known to
// full precision, are estimated from the DC values of the 5x5 blocks
// around it; with no AC data at all the DC is interpolated too. Rows past
// the last iMCU row decoded with data use the precision the component had
// before its last scan. Neighbours past the left and right edges repeat
// the edge block; rows follow libjpeg's buffer pointers (the row two below
// may be a dummy row of the last iMCU row).
void Decoder::smooth_idct(Component& c, int ci, const std::vector<int>& latch) {
  const int pw = c.wib * 8, last = c.wib - 1;
  const int total = (height + 8 * max_v_ - 1) / (8 * max_v_);
  const uint16_t* q = c.q;
  int16_t ws[64];
  // the estimate of one coefficient: (Qxx << 7 + num) / (Qxx << 8) in
  // magnitude, capped below 1 << Al where Al > 0
  auto estimate = [](int64_t num, int64_t qv, int al) {
    int64_t mag = ((qv << 7) + (num >= 0 ? num : -num)) / (qv << 8);
    if (al > 0 && mag >= (1 << al)) mag = (1 << al) - 1;
    return (int16_t)(num >= 0 ? mag : -mag);
  };
  for (int r = 0; r < total; r++) {
    int block_rows = c.v;
    if (r == total - 1) {
      block_rows = c.hib % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int* bits = latch.data() + 20 * ci + (r > last_good_row_ ? 10 : 0);
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc &= bits[k] == -1;
    const int image_block_rows = block_rows * total;
    for (int br = 0; br < block_rows; br++) {
      const int ibr = r * block_rows + br;
      const int row = r * c.v + br;
      int rows[5];
      rows[2] = row;
      rows[1] = ibr > 0 ? row - 1 : row;
      rows[0] = ibr > 1 ? row - 2 : rows[1];
      rows[3] = ibr < image_block_rows - 1 ? row + 1 : row;
      rows[4] = ibr < image_block_rows - 2 ? row + 2 : rows[3];
      for (int b = 0; b <= last; b++) {
        // d[1..25]: libjpeg's DC01..DC25, row by row from two rows above
        int64_t d[26];
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) {
            const int col = std::min(std::max(b + j - 2, 0), last);
            d[1 + 5 * i + j] = c.coef[((size_t)rows[i] * c.bw + col) * 64];
          }
        std::memcpy(ws, &c.coef[((size_t)row * c.bw + b) * 64], sizeof(ws));
        const int64_t q00 = q[0];
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
          ws[1] = estimate(q00 * (change_dc ? -d[1] - d[2] + d[4] + d[5] - 3 * d[6] + 13 * d[7] - 13 * d[9] +
                                                  3 * d[10] - 3 * d[11] + 38 * d[12] - 38 * d[14] + 3 * d[15] -
                                                  3 * d[16] + 13 * d[17] - 13 * d[19] + 3 * d[20] - d[21] - d[22] +
                                                  d[24] + d[25]
                                            : -7 * d[11] + 50 * d[12] - 50 * d[14] + 7 * d[15]),
                           q[1], al);
        if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
          ws[8] = estimate(q00 * (change_dc ? -d[1] - 3 * d[2] - 3 * d[3] - 3 * d[4] - d[5] - d[6] + 13 * d[7] +
                                                  38 * d[8] + 13 * d[9] - d[10] + d[16] - 13 * d[17] - 38 * d[18] -
                                                  13 * d[19] + d[20] + d[21] + 3 * d[22] + 3 * d[23] + 3 * d[24] +
                                                  d[25]
                                            : -7 * d[3] + 50 * d[8] - 50 * d[18] + 7 * d[23]),
                           q[8], al);
        if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
          ws[16] = estimate(q00 * (change_dc ? d[3] + 2 * d[7] + 7 * d[8] + 2 * d[9] - 5 * d[12] - 14 * d[13] -
                                                   5 * d[14] + 2 * d[17] + 7 * d[18] + 2 * d[19] + d[23]
                                             : -d[3] + 13 * d[8] - 24 * d[13] + 13 * d[18] - d[23]),
                            q[16], al);
        if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
          ws[9] = estimate(q00 * (change_dc ? -d[1] + d[5] + 9 * d[7] - 9 * d[9] - 9 * d[17] + 9 * d[19] + d[21] -
                                                  d[25]
                                            : d[10] + d[16] - 10 * d[17] + 10 * d[19] - d[2] - d[20] + d[22] -
                                                  d[24] + d[4] - d[6] + 10 * d[7] - 10 * d[9]),
                           q[9], al);
        if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
          ws[2] = estimate(q00 * (change_dc ? 2 * d[7] - 5 * d[8] + 2 * d[9] + d[11] + 7 * d[12] - 14 * d[13] +
                                                  7 * d[14] + d[15] + 2 * d[17] - 5 * d[18] + 2 * d[19]
                                            : -d[11] + 13 * d[12] - 24 * d[13] + 13 * d[14] - d[15]),
                           q[2], al);
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = estimate(q00 * (d[7] - d[9] + 2 * d[12] - 2 * d[14] + d[17] - d[19]), q[3], al);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = estimate(q00 * (d[7] - 3 * d[8] + d[9] - d[17] + 3 * d[18] - d[19]), q[10], al);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = estimate(q00 * (d[7] - d[9] - 3 * d[12] + 3 * d[14] + d[17] - d[19]), q[17], al);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = estimate(q00 * (d[7] + 2 * d[8] + d[9] - d[17] - 2 * d[18] - d[19]), q[24], al);
          // the DC: weights summing to 256
          ws[0] = estimate(q00 * (-2 * d[1] - 6 * d[2] - 8 * d[3] - 6 * d[4] - 2 * d[5] - 6 * d[6] + 6 * d[7] +
                                  42 * d[8] + 6 * d[9] - 6 * d[10] - 8 * d[11] + 42 * d[12] + 152 * d[13] +
                                  42 * d[14] - 8 * d[15] - 6 * d[16] + 6 * d[17] + 42 * d[18] + 6 * d[19] -
                                  6 * d[20] - 2 * d[21] - 6 * d[22] - 8 * d[23] - 6 * d[24] - 2 * d[25]),
                           q00, 0);
        }
        idct_islow(ws, q, &c.plane[(size_t)row * 8 * pw + b * 8], pw);
      }
    }
  }
}

// One output row of a component at full size (jdsample.c with fancy
// upsampling; rows past the component's last clamp to it, as jdmainct.c's
// context pointers give them).
void Decoder::upsample_row(const Component& c, int y, uint8_t* dst) const {
  const int pw = c.wib * 8;
  const uint8_t* pl = c.plane.data();
  switch (c.method) {
    case kFull:
      std::memcpy(dst, pl + (size_t)y * pw, width);
      break;
    case kH2V1Fancy:
    case kH2V1Box:
    case kH2V2Box:
    case kInt: {
      int sy = c.method == kInt ? y / c.vexp : (c.method == kH2V2Box ? y >> 1 : y);
      const uint8_t* s = pl + (size_t)sy * pw;
      if (c.method == kH2V1Fancy) {
        const int n = c.dw;
        dst[0] = s[0];
        dst[1] = (uint8_t)((s[0] * 3 + s[1] + 2) >> 2);
        for (int i = 1; i < n - 1; i++) {
          int v = s[i] * 3;
          dst[2 * i] = (uint8_t)((v + s[i - 1] + 1) >> 2);
          dst[2 * i + 1] = (uint8_t)((v + s[i + 1] + 2) >> 2);
        }
        dst[2 * n - 2] = (uint8_t)((s[n - 1] * 3 + s[n - 2] + 1) >> 2);
        dst[2 * n - 1] = s[n - 1];
      } else {
        const int e = c.method == kInt ? c.hexp : 2;
        for (int x = 0; x < width; x++) dst[x] = s[x / e];
      }
      break;
    }
    case kH1V2Fancy:
    case kH2V2Fancy: {
      const int r = y >> 1;
      const int far = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
      const uint8_t* s0 = pl + (size_t)r * pw;
      const uint8_t* s1 = pl + (size_t)far * pw;
      if (c.method == kH1V2Fancy) {
        const int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < width; x++) dst[x] = (uint8_t)((s0[x] * 3 + s1[x] + bias) >> 2);
      } else {
        const int n = c.dw;
        int last, cur = s0[0] * 3 + s1[0], next = s0[1] * 3 + s1[1];
        dst[0] = (uint8_t)((cur * 4 + 8) >> 4);
        dst[1] = (uint8_t)((cur * 3 + next + 7) >> 4);
        last = cur;
        cur = next;
        for (int i = 2; i < n; i++) {
          next = s0[i] * 3 + s1[i];
          dst[2 * i - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
          dst[2 * i - 1] = (uint8_t)((cur * 3 + next + 7) >> 4);
          last = cur;
          cur = next;
        }
        dst[2 * n - 2] = (uint8_t)((cur * 3 + last + 8) >> 4);
        dst[2 * n - 1] = (uint8_t)((cur * 4 + 7) >> 4);
      }
      break;
    }
  }
}

void Decoder::output(uint8_t* out) {
  std::vector<int> latch;
  const bool smooth = smoothing_ok(&latch);
  for (int ci = 0; ci < ncomp; ci++) {
    Component& c = comps_[ci];
    const int pw = c.wib * 8;
    c.plane.assign((size_t)pw * c.hib * 8, 0);
    if (smooth) {
      smooth_idct(c, ci, latch);
    } else {
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.q, &c.plane[(size_t)by * 8 * pw + bx * 8], pw);
    }
    std::vector<int16_t>().swap(c.coef);
  }
  // jdcolor.c's tables
  int32_t crr[256], cbb[256], crg[256], cbg[256];
  for (int i = 0; i < 256; i++) {
    int32_t x = i - 128;
    crr[i] = (fix16(1.40200) * x + kOneHalf) >> kScaleBits;
    cbb[i] = (fix16(1.77200) * x + kOneHalf) >> kScaleBits;
    crg[i] = -fix16(0.71414) * x;
    cbg[i] = -fix16(0.34414) * x + kOneHalf;
  }
  const int rowlen = std::max(width, 2 * width) + 16;
  std::vector<uint8_t> rows((size_t)ncomp * rowlen);
  for (int y = 0; y < height; y++) {
    uint8_t* r[4];
    for (int i = 0; i < ncomp; i++) {
      r[i] = &rows[(size_t)i * rowlen];
      upsample_row(comps_[i], y, r[i]);
    }
    uint8_t* o = out + (size_t)y * width * 3;
    switch (space_) {
      case kGrey:
        for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
        break;
      case kRGB:
        for (int x = 0; x < width; x++) {
          o[3 * x] = r[2][x];
          o[3 * x + 1] = r[1][x];
          o[3 * x + 2] = r[0][x];
        }
        break;
      case kYCbCr:
        for (int x = 0; x < width; x++) {
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          o[3 * x] = clamp255(yy + cbb[cb]);
          o[3 * x + 1] = clamp255(yy + ((cbg[cb] + crg[cr]) >> kScaleBits));
          o[3 * x + 2] = clamp255(yy + crr[cr]);
        }
        break;
      case kCMYK:
      case kYCCK:
        for (int x = 0; x < width; x++) {
          int c, m, ye, k = r[3][x];
          if (space_ == kYCCK) {  // jdcolor.c: ycck_cmyk_convert
            int yy = r[0][x], cb = r[1][x], cr = r[2][x];
            c = clamp255(255 - (yy + crr[cr]));
            m = clamp255(255 - (yy + ((cbg[cb] + crg[cr]) >> kScaleBits)));
            ye = clamp255(255 - (yy + cbb[cb]));
          } else {
            c = r[0][x];
            m = r[1][x];
            ye = r[2][x];
          }
          // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
          o[3 * x] = (uint8_t)(k - ((255 - ye) * k >> 8));
          o[3 * x + 1] = (uint8_t)(k - ((255 - m) * k >> 8));
          o[3 * x + 2] = (uint8_t)(k - ((255 - c) * k >> 8));
        }
        break;
    }
  }
}

// ================================================================ encoder

struct HuffEnc {
  uint16_t code[256];
  uint8_t size[256];
};

void derive_enc(const uint8_t* bits, const uint8_t* vals, HuffEnc* t) {
  std::memset(t->size, 0, sizeof(t->size));
  uint32_t code = 0;
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      t->code[vals[p]] = (uint16_t)code;
      t->size[vals[p]] = (uint8_t)l;
      code++;
    }
    code <<= 1;
  }
}

// Writes into a buffer of jpeg_encode_bound's size: no bounds checks.
class Writer {
 public:
  explicit Writer(uint8_t* out) : start_(out), p_(out) {}
  void byte(int b) { *p_++ = (uint8_t)b; }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void bits(uint32_t v, int n) {  // n <= 16
    acc_ = (acc_ << n) | (v & ((1u << n) - 1));
    nacc_ += n;
    if (nacc_ < 32) return;
    while (nacc_ >= 8) {
      nacc_ -= 8;
      uint8_t b = (uint8_t)(acc_ >> nacc_);
      *p_++ = b;
      if (b == 0xFF) *p_++ = 0;
    }
  }
  void flush() {  // whole bytes, then the partial byte filled with ones
    if (nacc_ % 8) bits(0x7F, 8 - nacc_ % 8);
    while (nacc_ >= 8) {
      nacc_ -= 8;
      uint8_t b = (uint8_t)(acc_ >> nacc_);
      *p_++ = b;
      if (b == 0xFF) *p_++ = 0;
    }
  }
  int64_t size() const { return p_ - start_; }

 private:
  uint8_t* start_;
  uint8_t* p_;
  uint64_t acc_ = 0;
  int nacc_ = 0;
};

void write_dht(Writer& w, int index, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int l = 1; l <= 16; l++) n += bits[l];
  w.byte(0xFF);
  w.byte(0xC4);
  w.u16(n + 2 + 1 + 16);
  w.byte(index);
  for (int l = 1; l <= 16; l++) w.byte(bits[l]);
  for (int i = 0; i < n; i++) w.byte(vals[i]);
}

inline int nbits_of(int v) { return v ? 32 - __builtin_clz((unsigned)v) : 0; }

void encode_block(Writer& w, const int16_t* blk, int* last_dc, const HuffEnc& dc, const HuffEnc& ac) {
  int t = blk[0] - *last_dc;
  *last_dc = blk[0];
  int a = t < 0 ? -t : t, v = t < 0 ? t - 1 : t;
  int n = nbits_of(a);
  w.bits(dc.code[n], dc.size[n]);
  if (n) w.bits((uint32_t)v, n);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int c = blk[kNatural[k]];
    if (c == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    a = c < 0 ? -c : c;
    v = c < 0 ? c - 1 : c;
    n = nbits_of(a);
    int sym = (run << 4) + n;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits((uint32_t)v, n);
    run = 0;
  }
  if (run > 0) w.bits(ac.code[0], ac.size[0]);
}

// jcdctmgr.c: compute_reciprocal for 16-bit DCT elements
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(int divisor) {
  int b = 0;
  while ((1 << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (1ull << r) / divisor, fr = (1ull << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= (uint64_t)(divisor / 2)) {
    c++;
  } else {
    fq++;
  }
  return Divisor{(uint32_t)fq, c, r};
}

void quantize(const int16_t* ws, const Divisor* div, int16_t* out) {
  for (int i = 0; i < 64; i++) {
    int t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    uint32_t q = (uint32_t)(((uint64_t)(a + div[i].corr) * div[i].recip) >> div[i].shift);
    out[i] = (int16_t)(t < 0 ? -(int)q : (int)q);
  }
}

int64_t encode(const uint8_t* bgr, int h, int w, int quality, uint8_t* out) {
  if (h < 1 || w < 1 || h > 65500 || w > 65500) fail("image size out of JPEG's range");
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qt[2][64];
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long v = ((long)(t ? kChromQuant : kLumQuant)[i] * scale + 50) / 100;
      v = std::min(std::max(v, 1L), 255L);
      qt[t][i] = (uint16_t)v;
      div[t][i] = reciprocal((int)v << 3);
    }
  HuffEnc dc[2], ac[2];
  derive_enc(kDcLumBits, kDcVals, &dc[0]);
  derive_enc(kDcChromBits, kDcVals, &dc[1]);
  derive_enc(kAcLumBits, kAcLumVals, &ac[0]);
  derive_enc(kAcChromBits, kAcChromVals, &ac[1]);

  Writer wr(out);
  const uint8_t app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01,
                          0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  for (uint8_t b : app0) wr.byte(b);
  for (int t = 0; t < 2; t++) {
    wr.byte(0xFF);
    wr.byte(0xDB);
    wr.u16(67);
    wr.byte(t);
    for (int i = 0; i < 64; i++) wr.byte(qt[t][kNatural[i]]);
  }
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 17, 8, (uint8_t)(h >> 8), (uint8_t)h, (uint8_t)(w >> 8), (uint8_t)w,
                         3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  for (uint8_t b : sof) wr.byte(b);
  write_dht(wr, 0x00, kDcLumBits, kDcVals);
  write_dht(wr, 0x10, kAcLumBits, kAcLumVals);
  write_dht(wr, 0x01, kDcChromBits, kDcVals);
  write_dht(wr, 0x11, kAcChromBits, kAcChromVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  for (uint8_t b : sos) wr.byte(b);

  // jccolor.c's tables
  int32_t tab[8][256];
  for (int i = 0; i < 256; i++) {
    tab[0][i] = fix16(0.29900) * i;
    tab[1][i] = fix16(0.58700) * i;
    tab[2][i] = fix16(0.11400) * i + kOneHalf;
    tab[3][i] = -fix16(0.16874) * i;
    tab[4][i] = -fix16(0.33126) * i;
    tab[5][i] = fix16(0.50000) * i + (128 << kScaleBits) + kOneHalf - 1;
    tab[6][i] = -fix16(0.41869) * i;
    tab[7][i] = -fix16(0.08131) * i;
  }
  const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
  const int ywib = (w + 7) / 8, yhib = (h + 7) / 8;
  const int yw = ywib * 8, cw = mcux * 8, hc = (h + 1) / 2;
  // one iMCU row: 16 rows of Y (yw wide), 8 of Cb and Cr (cw wide)
  std::vector<uint8_t> Y((size_t)16 * yw), C[2];
  C[0].resize((size_t)8 * cw);
  C[1].resize((size_t)8 * cw);
  std::vector<uint8_t> full[2];  // full-size Cb, Cr rows, 2 * cw wide
  full[0].resize((size_t)2 * 2 * cw);
  full[1].resize((size_t)2 * 2 * cw);
  int last_dc[3] = {0, 0, 0};
  int16_t ws[64], blk[6][64];
  auto fdct_block = [&](const uint8_t* src, int stride, const Divisor* dv, int16_t* dst) {
    for (int r = 0; r < 8; r++)
      for (int c = 0; c < 8; c++) ws[8 * r + c] = (int16_t)(src[(size_t)r * stride + c] - 128);
    fdct_islow(ws);
    quantize(ws, dv, dst);
  };
  for (int my = 0; my < mcuy; my++) {
    // colour conversion and 4:2:0 downsampling (jcsample.c: h2v2_downsample)
    for (int cr = 0; cr < 8; cr++) {
      const int crow = std::min(my * 8 + cr, hc - 1);
      for (int k = 0; k < 2; k++) {
        const int y = std::min(2 * crow + k, h - 1);
        const uint8_t* src = bgr + (size_t)y * w * 3;
        uint8_t* cb = &full[0][(size_t)k * 2 * cw];
        uint8_t* cr = &full[1][(size_t)k * 2 * cw];
        for (int x = 0; x < w; x++) {
          int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
          cb[x] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> kScaleBits);
          cr[x] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> kScaleBits);
        }
        for (int x = w; x < 2 * cw; x++) {  // jcsample.c: expand_right_edge
          cb[x] = cb[w - 1];
          cr[x] = cr[w - 1];
        }
      }
      for (int k = 0; k < 2; k++) {
        const uint8_t* a = full[k].data();
        const uint8_t* b = a + 2 * cw;
        uint8_t* o = &C[k][(size_t)cr * cw];
        int bias = 1;
        for (int x = 0; x < cw; x++) {
          o[x] = (uint8_t)((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int r = 0; r < 16; r++) {
      const int y = std::min(my * 16 + r, h - 1);
      const uint8_t* src = bgr + (size_t)y * w * 3;
      uint8_t* o = &Y[(size_t)r * yw];
      for (int x = 0; x < w; x++)
        o[x] = (uint8_t)((tab[0][src[3 * x + 2]] + tab[1][src[3 * x + 1]] + tab[2][src[3 * x]]) >> kScaleBits);
      for (int x = w; x < yw; x++) o[x] = o[w - 1];
    }
    for (int mx = 0; mx < mcux; mx++) {
      // jccoefct.c: dummy blocks past the right and bottom edges keep the
      // DC of the block before them and no AC
      for (int by = 0; by < 2; by++) {
        const bool row_real = my * 2 + by < yhib;
        for (int bx = 0; bx < 2; bx++) {
          int16_t* o = blk[by * 2 + bx];
          if (row_real && mx * 2 + bx < ywib) {
            fdct_block(&Y[(size_t)by * 8 * yw + mx * 16 + bx * 8], yw, div[0], o);
          } else {
            std::memset(o, 0, 64 * sizeof(int16_t));
            o[0] = row_real ? blk[by * 2 + bx - 1][0] : blk[1][0];
          }
        }
      }
      fdct_block(&C[0][(size_t)mx * 8], cw, div[1], blk[4]);
      fdct_block(&C[1][(size_t)mx * 8], cw, div[1], blk[5]);
      for (int b = 0; b < 4; b++) encode_block(wr, blk[b], &last_dc[0], dc[0], ac[0]);
      encode_block(wr, blk[4], &last_dc[1], dc[1], ac[1]);
      encode_block(wr, blk[5], &last_dc[2], dc[1], ac[1]);
    }
  }
  wr.flush();
  wr.byte(0xFF);
  wr.byte(0xD9);
  return wr.size();
}

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg.c_str(), errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

int jpeg_info(const uint8_t* data, int64_t n, int32_t* info, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.read_header();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Fail& f) {
    set_error(err, errlen, f.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

int jpeg_decode_bgr(const uint8_t* data, int64_t n, uint8_t* out, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.decode(out);
    return d.cut_short() ? 1 : 0;
  } catch (const Fail& f) {
    set_error(err, errlen, f.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

int64_t jpeg_encode_bound(int h, int w) {
  // headers, then at most 2 * 209 bytes a block (every byte stuffed)
  const int64_t mcus = (int64_t)((w + 15) / 16) * ((h + 15) / 16);
  return 1024 + mcus * 6 * 420;
}

int64_t jpeg_encode_bgr(const uint8_t* bgr, int h, int w, int quality, uint8_t* out, int64_t cap, char* err,
                        int errlen) {
  try {
    if (cap < jpeg_encode_bound(h, w)) fail("the output buffer is smaller than jpeg_encode_bound");
    return encode(bgr, h, w, quality, out);
  } catch (const Fail& f) {
    set_error(err, errlen, f.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}

}  // extern "C"
