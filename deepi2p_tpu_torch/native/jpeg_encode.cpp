// Baseline JPEG encoder that repeats libjpeg-turbo's arithmetic at the
// settings cv2.imwrite uses by default, so that its bytes are those of
// cv2.imwrite(path, bgr) / cv2.imencode(".jpg", bgr) with no OpenCV
// installed.
//
// What it repeats, stage by stage:
//   * jpeg_set_defaults + jpeg_set_quality(95, force_baseline): the
//     Annex K tables scaled as jcparam.c scales them, a JFIF 1.01 APP0
//     header (density 1:1, no unit), 4:2:0 YCbCr, the standard Huffman
//     tables, no optimisation, no restart markers;
//   * RGB -> YCbCr through the 16-bit fixed-point tables of jccolor.c;
//   * edge replication to whole blocks (jcprepct.c, jcsample.c's
//     expand_right_edge) and h2v2_downsample's alternating 1, 2 bias;
//   * dummy blocks past the image's last block row and column, zero with
//     the DC of the block before (jccoefct.c);
//   * the islow forward DCT (jfdctint.c) and the reciprocal quantisation
//     of jcdctmgr.c (16-bit DCTELEM, as in a SIMD build);
//   * the Huffman coder of jchuff.c with 0xFF stuffing, the last byte
//     padded with ones.
//
// C interface (ctypes): jpeg_encode_bound() gives an upper bound of the
// output size, jpeg_encode() writes the file into a caller's buffer and
// returns its length, or -1 with the reason in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

using std::runtime_error;

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Annex K.1, natural (row-major) order, as jcparam.c lists them
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: code counts of lengths 1..16, then the values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
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
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
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

constexpr int kQuality = 95;

// jcparam.c: jpeg_quality_scaling, then jpeg_add_quant_table with
// force_baseline (values clamped to 1..255)
void scaled_table(const int* base, int* out) {
  const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = static_cast<int>(t);
  }
}

// jcdctmgr.c: compute_reciprocal for a 16-bit DCTELEM
struct Divisor {
  uint16_t recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  Divisor d;
  if (divisor == 1) {
    d.recip = 1;
    d.corr = 0;
    d.shift = -16;
    return d;
  }
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;   // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  const uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {   // a power of two: fq would not fit in 16 bits
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  d.recip = static_cast<uint16_t>(fq);
  d.corr = static_cast<uint16_t>(c);
  d.shift = r - 16;
  return d;
}

// jfdctint.c: jpeg_fdct_islow on level-shifted samples, in place
constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
using JLONG = int64_t;
constexpr JLONG FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline JLONG descale(JLONG x, int n) { return (x + (JLONG(1) << (n - 1))) >> n; }

// One 1-D pass over the 8 values d[0], d[s], ..., d[7s]: pass 1 (rows)
// scales its output up by 2^PASS1_BITS, pass 2 (columns) removes that
// scaling and leaves an overall factor of 8.
void fdct_1d(int16_t* d, int s, bool first) {
  const int odd_bits = first ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
  JLONG tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
  JLONG tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
  JLONG tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
  JLONG tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
  const JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (first) {
    d[0] = static_cast<int16_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4 * s] = static_cast<int16_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
  } else {
    d[0] = static_cast<int16_t>(descale(tmp10 + tmp11, PASS1_BITS));
    d[4 * s] = static_cast<int16_t>(descale(tmp10 - tmp11, PASS1_BITS));
  }
  JLONG z1 = (tmp12 + tmp13) * FIX_0_541196100;
  d[2 * s] = static_cast<int16_t>(descale(z1 + tmp13 * FIX_0_765366865, odd_bits));
  d[6 * s] = static_cast<int16_t>(descale(z1 + tmp12 * -FIX_1_847759065, odd_bits));
  z1 = tmp4 + tmp7;
  JLONG z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  const JLONG z5 = (z3 + z4) * FIX_1_175875602;
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
  d[7 * s] = static_cast<int16_t>(descale(tmp4 + z1 + z3, odd_bits));
  d[5 * s] = static_cast<int16_t>(descale(tmp5 + z2 + z4, odd_bits));
  d[3 * s] = static_cast<int16_t>(descale(tmp6 + z2 + z3, odd_bits));
  d[s] = static_cast<int16_t>(descale(tmp7 + z1 + z4, odd_bits));
}

void fdct_islow(int16_t* data) {
  for (int r = 0; r < 8; ++r) fdct_1d(data + 8 * r, 1, true);
  for (int c = 0; c < 8; ++c) fdct_1d(data + c, 8, false);
}

struct HuffCodes {
  uint16_t code[256] = {};
  uint8_t size[256] = {};

  // jchuff.c: jpeg_make_c_derived_tbl (canonical codes)
  HuffCodes(const uint8_t* bits, const uint8_t* vals) {
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = static_cast<uint16_t>(c);
        size[vals[k]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

class Writer {
 public:
  std::vector<uint8_t> out;

  void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }

  // entropy-coded bits, MSB first, a zero byte stuffed after each 0xFF
  void bits(uint32_t code, int size) {
    if (size == 0) return;
    acc_ = (acc_ << size) | (code & ((uint32_t(1) << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      const int b = static_cast<int>((acc_ >> (n_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      n_ -= 8;
    }
    acc_ &= (uint64_t(1) << n_) - 1;
  }
  // jchuff.c flush_bits: fill the last byte with ones
  void flush() {
    bits(0x7F, 7);
    acc_ = 0;
    n_ = 0;
  }

 private:
  uint64_t acc_ = 0;
  int n_ = 0;
};

// jcmarker.c: emit_dht
void write_dht(Writer& w, int cls_id, const uint8_t* bits, const uint8_t* vals) {
  int n = 0;
  for (int i = 0; i < 16; ++i) n += bits[i];
  w.marker(0xC4);
  w.word(2 + 1 + 16 + n);
  w.byte(cls_id);
  for (int i = 0; i < 16; ++i) w.byte(bits[i]);
  for (int i = 0; i < n; ++i) w.byte(vals[i]);
}

// jchuff.c: encode_one_block
void encode_block(Writer& w, const int16_t* blk, int& last_dc,
                  const HuffCodes& dc, const HuffCodes& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  w.bits(dc.code[nbits], dc.size[nbits]);
  w.bits(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    const int i = (r << 4) + nbits;
    w.bits(ac.code[i], ac.size[i]);
    w.bits(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) w.bits(ac.code[0], ac.size[0]);
}

// jccolor.c: rgb_ycc_convert's tables
constexpr int SCALEBITS = 16;
constexpr int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
constexpr int32_t CBCR_OFFSET = int32_t(128) << SCALEBITS;
constexpr int32_t fix(double x) { return static_cast<int32_t>(x * (1L << SCALEBITS) + 0.5); }

struct ColorTables {
  int32_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256],
      bcr[256];
  ColorTables() {
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by[i] = fix(0.11400) * i + ONE_HALF;
      rcb[i] = -fix(0.16874) * i;
      gcb[i] = -fix(0.33126) * i;
      // Cb's B term, also Cr's R term: a rounding of 0.5 - epsilon
      bcb[i] = fix(0.5) * i + CBCR_OFFSET + ONE_HALF - 1;
      gcr[i] = -fix(0.41869) * i;
      bcr[i] = -fix(0.08131) * i;
    }
  }
};

// One 8x8 block of a plane (row stride `stride`) at (y0, x0): level shift,
// DCT, quantisation; the coefficients in natural order
void block_coefs(const uint8_t* plane, size_t stride, int y0, int x0,
                 const Divisor* div, int16_t* coef) {
  int16_t ws[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      ws[8 * r + c] = static_cast<int16_t>(plane[(y0 + r) * stride + x0 + c] - 128);
  fdct_islow(ws);
  for (int i = 0; i < 64; ++i) {
    int temp = ws[i];
    const bool neg = temp < 0;
    if (neg) temp = -temp;
    uint32_t product = static_cast<uint32_t>(temp + div[i].corr) * div[i].recip;
    product >>= div[i].shift + 16;
    temp = static_cast<int16_t>(product);
    coef[i] = static_cast<int16_t>(neg ? -temp : temp);
  }
}

std::vector<uint8_t> encode(const uint8_t* rgb, int H, int W) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535)
    throw runtime_error("image size out of the JPEG range");
  static const ColorTables ct;
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const size_t PW = size_t(mcux) * 16;   // padded full-size plane
  const int PH = mcuy * 16;
  const int yblk_w = (W + 7) / 8, yblk_h = (H + 7) / 8;

  // colour conversion of the image, edges replicated to the padded plane
  std::vector<uint8_t> Y(PH * PW), Cb(PH * PW), Cr(PH * PW);
  for (int y = 0; y < H; ++y) {
    const uint8_t* row = rgb + size_t(y) * W * 3;
    const size_t o = size_t(y) * PW;
    for (int x = 0; x < W; ++x) {
      const int r = row[3 * x], g = row[3 * x + 1], b = row[3 * x + 2];
      Y[o + x] = static_cast<uint8_t>((ct.ry[r] + ct.gy[g] + ct.by[b]) >> SCALEBITS);
      Cb[o + x] = static_cast<uint8_t>((ct.rcb[r] + ct.gcb[g] + ct.bcb[b]) >> SCALEBITS);
      Cr[o + x] = static_cast<uint8_t>((ct.bcb[r] + ct.gcr[g] + ct.bcr[b]) >> SCALEBITS);
    }
    for (auto* p : {&Y, &Cb, &Cr}) std::memset(p->data() + o + W, (*p)[o + W - 1], PW - W);
  }
  for (auto* p : {&Y, &Cb, &Cr})
    for (int y = H; y < PH; ++y)
      std::memcpy(p->data() + y * PW, p->data() + (H - 1) * PW, PW);

  // h2v2_downsample of the row pairs the image covers (the last one
  // completed by replication), then the last downsampled row replicated
  // to whole iMCU rows
  const size_t CW = size_t(mcux) * 8;
  const int CH = mcuy * 8, c_rows = (H + 1) / 2;
  std::vector<uint8_t> Cbd(CH * CW), Crd(CH * CW);
  for (int pi = 0; pi < 2; ++pi) {
    const uint8_t* src = (pi ? Cr : Cb).data();
    uint8_t* dst = (pi ? Crd : Cbd).data();
    for (int i = 0; i < CH; ++i) {
      if (i >= c_rows) {
        std::memcpy(dst + i * CW, dst + (c_rows - 1) * CW, CW);
        continue;
      }
      const uint8_t* r0 = src + 2 * i * PW;
      const uint8_t* r1 = r0 + PW;
      int bias = 1;
      for (size_t j = 0; j < CW; ++j) {
        dst[i * CW + j] = static_cast<uint8_t>(
            (r0[2 * j] + r0[2 * j + 1] + r1[2 * j] + r1[2 * j + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }

  int qt[2][64];
  scaled_table(kLumaQuant, qt[0]);
  scaled_table(kChromaQuant, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(static_cast<unsigned>(qt[t][i]) << 3);

  Writer w;
  w.out.reserve(size_t(H) * W + 1024);
  w.marker(0xD8);
  // JFIF APP0: version 1.01, no density unit, 1:1, no thumbnail
  w.marker(0xE0);
  w.word(16);
  for (int c : {0x4A, 0x46, 0x49, 0x46, 0, 1, 1, 0}) w.byte(c);   // "JFIF\0", 1.01
  w.word(1);
  w.word(1);
  w.byte(0);
  w.byte(0);
  for (int t = 0; t < 2; ++t) {
    w.marker(0xDB);
    w.word(67);
    w.byte(t);
    for (int i = 0; i < 64; ++i) w.byte(qt[t][kZigzag[i]]);
  }
  // SOF0: Y 2x2 with table 0, Cb and Cr 1x1 with table 1
  w.marker(0xC0);
  w.word(17);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(3);
  for (int c : {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1}) w.byte(c);
  write_dht(w, 0x00, kDcLumaBits, kDcVals);
  write_dht(w, 0x10, kAcLumaBits, kAcLumaVals);
  write_dht(w, 0x01, kDcChromaBits, kDcVals);
  write_dht(w, 0x11, kAcChromaBits, kAcChromaVals);
  // SOS: all three components, spectral 0..63, no approximation
  w.marker(0xDA);
  w.word(12);
  w.byte(3);
  for (int c : {1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0}) w.byte(c);

  const HuffCodes dc_l(kDcLumaBits, kDcVals), ac_l(kAcLumaBits, kAcLumaVals);
  const HuffCodes dc_c(kDcChromaBits, kDcVals), ac_c(kAcChromaBits, kAcChromaVals);
  int last_dc[3] = {0, 0, 0};
  int16_t blk[6][64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // Y: 2x2 blocks; past the last block column or row a dummy block,
      // zero with the DC of the block before it (the last block of the
      // row above, for a dummy row)
      for (int by = 0; by < 2; ++by) {
        const int gy = 2 * my + by;
        for (int bx = 0; bx < 2; ++bx) {
          const int gx = 2 * mx + bx;
          int16_t* b = blk[2 * by + bx];
          if (gy < yblk_h && gx < yblk_w) {
            block_coefs(Y.data(), PW, 8 * gy, 8 * gx, div[0], b);
          } else {
            const int prev = gy < yblk_h ? 2 * by + bx - 1 : 2 * by - 1;
            const int16_t dc = blk[prev][0];
            std::memset(b, 0, sizeof(blk[0]));
            b[0] = dc;
          }
        }
      }
      block_coefs(Cbd.data(), CW, 8 * my, 8 * mx, div[1], blk[4]);
      block_coefs(Crd.data(), CW, 8 * my, 8 * mx, div[1], blk[5]);
      for (int i = 0; i < 4; ++i) encode_block(w, blk[i], last_dc[0], dc_l, ac_l);
      encode_block(w, blk[4], last_dc[1], dc_c, ac_c);
      encode_block(w, blk[5], last_dc[2], dc_c, ac_c);
    }
  }
  w.flush();
  w.marker(0xD9);
  return std::move(w.out);
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// An upper bound of jpeg_encode's output for an (h, w) image: the headers,
// and per 16x16 MCU six blocks of at most 64 codes of 16 + 11 bits each,
// doubled for the stuffed zero bytes.
int64_t jpeg_encode_bound(int64_t h, int64_t w) {
  const int64_t mcus = ((h + 15) / 16) * ((w + 15) / 16);
  return 1024 + mcus * 6 * 64 * 27 / 8 * 2;
}

// Encode (h, w, 3) RGB into out (cap bytes); the file's length, or -1.
int64_t jpeg_encode(const uint8_t* rgb, int64_t h, int64_t w, uint8_t* out,
                    int64_t cap, char* err, int errlen) {
  try {
    const std::vector<uint8_t> bytes = encode(rgb, static_cast<int>(h), static_cast<int>(w));
    if (static_cast<int64_t>(bytes.size()) > cap) throw runtime_error("output buffer too small");
    std::memcpy(out, bytes.data(), bytes.size());
    return static_cast<int64_t>(bytes.size());
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
