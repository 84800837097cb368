// Baseline JPEG decoder that repeats libjpeg-turbo's arithmetic, so an
// image decodes to the same bits as through OpenCV's cv2.imread (which
// decodes with libjpeg-turbo at its defaults) with no OpenCV installed.
//
// What it repeats, stage by stage:
//   * baseline and extended sequential Huffman scans (SOF0, SOF1), 8-bit
//     samples, interleaved or not, DRI restart intervals;
//   * libjpeg's islow integer IDCT (jidctint.c) for 8x8 output and its
//     reduced-size IDCTs (jidctred.c: 4x4, 2x2, 1x1) for the scales 1/2,
//     1/4 and 1/8 that cv2.IMREAD_REDUCED_COLOR_2/4/8 ask for, with the
//     chroma scaled up by the IDCT rather than upsampled where the
//     sampling allows (jdmaster.c, jpeg_core_output_dimensions);
//   * fancy (triangle) upsampling with libjpeg's alternating rounding bias
//     (jdsample.c: h2v1, h1v2, h2v2; plain replication otherwise, and at
//     the 1/8 scale), edge rows and columns replicated as jdmainct.c does;
//   * YCbCr -> RGB through the 16-bit fixed-point tables of jdcolor.c;
//     a grayscale image is replicated into three channels.
// The output is ceil(size / scale_denom) on each axis.  Anything else
// (progressive or arithmetic coding, 12-bit samples, CMYK, RGB-coded
// files, an EXIF orientation other than 1, which OpenCV would apply)
// is refused with a message that names the feature.
//
// C interface (ctypes): jpeg_dims() reads the header, jpeg_decode() writes
// (H, W, 3) RGB into a caller's buffer; both return 0 or -1 with the
// reason in err.  png_unfilter() undoes the five PNG row filters of an
// inflated PNG image (data/jpeg.py reads the rest of a PNG).

#include <algorithm>
#include <cstdlib>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using std::runtime_error;

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past 63 lands here, as in libjpeg's table
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int maxcode[17] = {};   // largest code of each length, -1 if none
  int valptr[17] = {};    // index in vals of the first code of a length
  int mincode[17] = {};
  uint16_t fast[1 << 9] = {};   // 9-bit lookahead: (length << 8) | value

  void build(const uint8_t* bits, const uint8_t* v, int nvals) {
    std::memcpy(vals, v, nvals);
    int code = 0, k = 0;
    std::memset(fast, 0, sizeof(fast));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        // a code must fit in l bits before it indexes the lookahead
        // table (libjpeg's jpeg_make_d_derived_tbl)
        if (code >= (1 << l)) throw runtime_error("corrupt Huffman table");
        if (l <= 9) {
          int lo = code << (9 - l), n = 1 << (9 - l);
          for (int j = 0; j < n; ++j)
            fast[lo + j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      // nor may the last code of a length be all ones
      if (code >= (1 << l)) throw runtime_error("corrupt Huffman table");
      code <<= 1;
    }
    defined = true;
  }
};

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint8_t nx = p + 1 < end ? p[1] : 0xD9;
          if (nx == 0x00) {
            p += 2;
          } else {
            at_marker = true;   // libjpeg feeds zeros past a marker
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int n) const { return static_cast<uint32_t>(buf >> (64 - n)); }
  void skip(int n) { buf <<= n; cnt -= n; }
  int bits(int n) {   // n in 1..16
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  void reset() { buf = 0; cnt = 0; at_marker = false; }

  int decode(const Huffman& h) {
    if (cnt < 32) fill();
    int e = h.fast[peek(9)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int code = static_cast<int>(peek(l));
    while (l <= 16 && code > h.maxcode[l]) code = static_cast<int>(peek(++l));
    if (l > 16) throw runtime_error("corrupt data: bad Huffman code");
    skip(l);
    return h.vals[(h.valptr[l] + code - h.mincode[l]) & 0xFF];
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;              // coefficient blocks, padded to MCUs
  std::vector<int16_t> coef;       // bw * bh * 64, natural order
  int dc_pred = 0;
};

// ---------------------------------------------------------------------------
// IDCTs (libjpeg's jidctint.c and jidctred.c, 8-bit samples)
// ---------------------------------------------------------------------------

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
using JLONG = int64_t;

inline JLONG descale(JLONG x, int n) { return (x + (JLONG(1) << (n - 1))) >> n; }

// libjpeg's IDCT range limit: the low 10 bits of the value, as a signed
// number, plus 128, clamped to [0, 255]
inline uint8_t range_idct(JLONG x) {
  int v = static_cast<int>(x) & 1023;
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

constexpr JLONG FIX_0_211164243 = 1730, FIX_0_298631336 = 2446,
                FIX_0_390180644 = 3196, FIX_0_509795579 = 4176,
                FIX_0_541196100 = 4433, FIX_0_601344887 = 4926,
                FIX_0_720959822 = 5906, FIX_0_765366865 = 6270,
                FIX_0_850430095 = 6967, FIX_0_899976223 = 7373,
                FIX_1_061594337 = 8697, FIX_1_175875602 = 9633,
                FIX_1_272758580 = 10426, FIX_1_451774981 = 11893,
                FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                FIX_2_172734803 = 17799, FIX_2_562915447 = 20995,
                FIX_3_072711026 = 25172, FIX_3_624509785 = 29692;

void idct_8x8(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
        !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    JLONG z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    JLONG z1 = (z2 + z3) * FIX_0_541196100;
    JLONG tmp2 = z1 + z3 * -FIX_1_847759065;
    JLONG tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    JLONG tmp0 = (z2 + z3) * (JLONG(1) << CONST_BITS);
    JLONG tmp1 = (z2 - z3) * (JLONG(1) << CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS - PASS1_BITS;
    wp[0] = static_cast<int>(descale(tmp10 + tmp3, sh));
    wp[56] = static_cast<int>(descale(tmp10 - tmp3, sh));
    wp[8] = static_cast<int>(descale(tmp11 + tmp2, sh));
    wp[48] = static_cast<int>(descale(tmp11 - tmp2, sh));
    wp[16] = static_cast<int>(descale(tmp12 + tmp1, sh));
    wp[40] = static_cast<int>(descale(tmp12 - tmp1, sh));
    wp[24] = static_cast<int>(descale(tmp13 + tmp0, sh));
    wp[32] = static_cast<int>(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    JLONG z2 = wp[2], z3 = wp[6];
    JLONG z1 = (z2 + z3) * FIX_0_541196100;
    JLONG tmp2 = z1 + z3 * -FIX_1_847759065;
    JLONG tmp3 = z1 + z2 * FIX_0_765366865;
    JLONG tmp0 = (JLONG(wp[0]) + wp[4]) * (JLONG(1) << CONST_BITS);
    JLONG tmp1 = (JLONG(wp[0]) - wp[4]) * (JLONG(1) << CONST_BITS);
    JLONG tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    JLONG tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    JLONG z4 = tmp1 + tmp3;
    JLONG z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = range_idct(descale(tmp10 + tmp3, sh));
    op[7] = range_idct(descale(tmp10 - tmp3, sh));
    op[1] = range_idct(descale(tmp11 + tmp2, sh));
    op[6] = range_idct(descale(tmp11 - tmp2, sh));
    op[2] = range_idct(descale(tmp12 + tmp1, sh));
    op[5] = range_idct(descale(tmp12 - tmp1, sh));
    op[3] = range_idct(descale(tmp13 + tmp0, sh));
    op[4] = range_idct(descale(tmp13 - tmp0, sh));
  }
}

void idct_4x4(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[8 * 4];
  for (int c = 0; c < 8; ++c) {
    if (c == 4) continue;   // the second pass does not read column 4
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    JLONG tmp0 = JLONG(ip[0] * qp[0]) * (JLONG(1) << (CONST_BITS + 1));
    JLONG z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    JLONG tmp2 = z2 * FIX_1_847759065 + z3 * -FIX_0_765366865;
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = ip[56] * qp[56];
    z2 = ip[40] * qp[40];
    z3 = ip[24] * qp[24];
    JLONG z4 = ip[8] * qp[8];
    tmp0 = z1 * -FIX_0_211164243 + z2 * FIX_1_451774981 +
           z3 * -FIX_2_172734803 + z4 * FIX_1_061594337;
    tmp2 = z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887 +
           z3 * FIX_0_899976223 + z4 * FIX_2_562915447;
    const int sh = CONST_BITS - PASS1_BITS + 1;
    wp[0] = static_cast<int>(descale(tmp10 + tmp2, sh));
    wp[24] = static_cast<int>(descale(tmp10 - tmp2, sh));
    wp[8] = static_cast<int>(descale(tmp12 + tmp0, sh));
    wp[16] = static_cast<int>(descale(tmp12 - tmp0, sh));
  }
  for (int r = 0; r < 4; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    JLONG tmp0 = JLONG(wp[0]) * (JLONG(1) << (CONST_BITS + 1));
    JLONG tmp2 = JLONG(wp[2]) * FIX_1_847759065 + JLONG(wp[6]) * -FIX_0_765366865;
    JLONG tmp10 = tmp0 + tmp2, tmp12 = tmp0 - tmp2;
    JLONG z1 = wp[7], z2 = wp[5], z3 = wp[3], z4 = wp[1];
    tmp0 = z1 * -FIX_0_211164243 + z2 * FIX_1_451774981 +
           z3 * -FIX_2_172734803 + z4 * FIX_1_061594337;
    tmp2 = z1 * -FIX_0_509795579 + z2 * -FIX_0_601344887 +
           z3 * FIX_0_899976223 + z4 * FIX_2_562915447;
    const int sh = CONST_BITS + PASS1_BITS + 3 + 1;
    op[0] = range_idct(descale(tmp10 + tmp2, sh));
    op[3] = range_idct(descale(tmp10 - tmp2, sh));
    op[1] = range_idct(descale(tmp12 + tmp0, sh));
    op[2] = range_idct(descale(tmp12 - tmp0, sh));
  }
}

void idct_2x2(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[8 * 2];
  for (int c = 0; c < 8; ++c) {
    if (c == 2 || c == 4 || c == 6) continue;   // not read by pass 2
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    JLONG tmp10 = JLONG(ip[0] * qp[0]) * (JLONG(1) << (CONST_BITS + 2));
    JLONG tmp0 = JLONG(ip[56] * qp[56]) * -FIX_0_720959822 +
                 JLONG(ip[40] * qp[40]) * FIX_0_850430095 +
                 JLONG(ip[24] * qp[24]) * -FIX_1_272758580 +
                 JLONG(ip[8] * qp[8]) * FIX_3_624509785;
    const int sh = CONST_BITS - PASS1_BITS + 2;
    wp[0] = static_cast<int>(descale(tmp10 + tmp0, sh));
    wp[8] = static_cast<int>(descale(tmp10 - tmp0, sh));
  }
  for (int r = 0; r < 2; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    JLONG tmp10 = JLONG(wp[0]) * (JLONG(1) << (CONST_BITS + 2));
    JLONG tmp0 = JLONG(wp[7]) * -FIX_0_720959822 + JLONG(wp[5]) * FIX_0_850430095 +
                 JLONG(wp[3]) * -FIX_1_272758580 + JLONG(wp[1]) * FIX_3_624509785;
    const int sh = CONST_BITS + PASS1_BITS + 3 + 2;
    op[0] = range_idct(descale(tmp10 + tmp0, sh));
    op[1] = range_idct(descale(tmp10 - tmp0, sh));
  }
}

void idct_1x1(const int16_t* in, const uint16_t* q, uint8_t* out, int) {
  out[0] = range_idct(descale(JLONG(in[0] * q[0]), 3));
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  Huffman dc[4], ac[4];
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  int restart_interval = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Component comp[3];
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  uint8_t byte() {
    if (pos >= n) throw runtime_error("truncated file");
    return data[pos++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    // skip anything up to 0xFF, then fill bytes
    while (pos < n && data[pos] != 0xFF) ++pos;
    while (pos < n && data[pos] == 0xFF) ++pos;
    if (pos >= n) throw runtime_error("truncated file: no EOI");
    return data[pos++];
  }

  void parse_app1(size_t start, size_t len) {
    // EXIF: only the orientation tag of IFD0 is read
    if (len < 14 || std::memcmp(data + start, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = data + start + 6;
    size_t tn = len - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto u16 = [&](size_t o) -> unsigned {
      if (o + 2 > tn) return 0;
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto u32 = [&](size_t o) -> uint32_t {
      if (o + 4 > tn) return 0;
      return le ? uint32_t(t[o]) | uint32_t(t[o + 1]) << 8 |
                      uint32_t(t[o + 2]) << 16 | uint32_t(t[o + 3]) << 24
                : uint32_t(t[o]) << 24 | uint32_t(t[o + 1]) << 16 |
                      uint32_t(t[o + 2]) << 8 | uint32_t(t[o + 3]);
    };
    size_t ifd = u32(4);
    if (ifd + 2 > tn) return;
    unsigned count = u16(ifd);
    for (unsigned i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * size_t(i);
      if (e + 12 > tn) return;
      if (u16(e) == 0x0112) {
        unsigned o = u16(e + 8);
        if (o >= 2 && o <= 8)
          throw runtime_error("EXIF orientation " + std::to_string(o) +
                              " is not supported (OpenCV would rotate or "
                              "flip the image)");
        return;
      }
    }
  }

  void parse_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw runtime_error("corrupt DQT");
      for (int k = 0; k < 64; ++k)
        qt[tq][kNatural[k]] = static_cast<uint16_t>(pq ? word() : byte());
      qt_defined[tq] = true;
    }
  }

  void parse_dht(size_t end) {
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw runtime_error("corrupt DHT");
      uint8_t bits[17] = {};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = byte();
      if (total > 256) throw runtime_error("corrupt DHT");
      uint8_t vals[256];
      for (int i = 0; i < total; ++i) vals[i] = byte();
      (tc ? ac : dc)[th].build(bits, vals, total);
    }
  }

  void parse_sof() {
    if (have_frame) throw runtime_error("more than one frame");
    int precision = byte();
    if (precision != 8)
      throw runtime_error(std::to_string(precision) +
                          "-bit samples are not supported");
    height = word();
    width = word();
    ncomp = byte();
    if (height == 0) throw runtime_error("DNL-defined height is not supported");
    if (width == 0) throw runtime_error("corrupt SOF: zero width");
    if (ncomp == 4) throw runtime_error("CMYK/YCCK (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      throw runtime_error(std::to_string(ncomp) +
                          " components are not supported");
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw runtime_error("corrupt SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
    have_frame = true;
  }

  void restart(BitReader& br, Component** sc, int ns) {
    br.reset();
    size_t p = br.p - data;
    while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] >= 0xD0 &&
                          data[p + 1] <= 0xD7))
      ++p;
    if (p + 1 >= n) throw runtime_error("corrupt data: missing RST marker");
    br.p = data + p + 2;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    int diff = 0;
    if (s) {
      if (s > 16) throw runtime_error("corrupt data: bad DC size");
      diff = extend(br.bits(s), s);
    }
    c.dc_pred += diff;
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void parse_sos(size_t end) {
    if (!have_frame) throw runtime_error("SOS before SOF");
    int ns = byte();
    if (ns < 1 || ns > ncomp) throw runtime_error("corrupt SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* c = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) c = &comp[j];
      if (!c) throw runtime_error("corrupt SOS: unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        throw runtime_error("corrupt SOS: undefined Huffman table");
      sc[i] = c;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      throw runtime_error("corrupt SOS: spectral selection in a sequential scan");
    pos = end;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;

    BitReader br{data + pos, data + n};
    int left = restart_interval;
    if (ns == 1) {
      Component& c = *sc[0];
      int cw = (width * c.h + hmax - 1) / hmax;
      int ch = (height * c.v + vmax - 1) / vmax;
      int nbx = (cw + 7) / 8, nby = (ch + 7) / 8;
      for (int by = 0; by < nby; ++by)
        for (int bx = 0; bx < nbx; ++bx) {
          if (restart_interval) {
            if (left == 0) {
              restart(br, sc, ns);
              left = restart_interval;
            }
            --left;
          }
          decode_block(br, c, &c.coef[(size_t(by) * c.bw + bx) * 64]);
        }
    } else {
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart_interval) {
            if (left == 0) {
              restart(br, sc, ns);
              left = restart_interval;
            }
            --left;
          }
          for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            for (int v = 0; v < c.v; ++v)
              for (int h = 0; h < c.h; ++h) {
                size_t b = size_t(my * c.v + v) * c.bw + mx * c.h + h;
                decode_block(br, c, &c.coef[b * 64]);
              }
          }
        }
    }
    // continue after the entropy-coded segment
    size_t p = br.p - data;
    while (p + 1 < n && !(data[p] == 0xFF && data[p + 1] != 0x00 &&
                          !(data[p + 1] >= 0xD0 && data[p + 1] <= 0xD7)))
      ++p;
    pos = p;
  }

  // read markers; headers_only stops at the frame header
  void parse(bool headers_only) {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8)
      throw runtime_error("not a JPEG file (no SOI marker)");
    pos = 2;
    while (true) {
      int m = next_marker();
      if (m == 0xD9) break;   // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0x01) continue;
      size_t start = pos;
      size_t len = word();
      if (len < 2 || start + len > n) throw runtime_error("corrupt marker length");
      size_t end = start + len;
      size_t body = start + 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof();
          if (headers_only) return;
          break;
        case 0xC2:
        case 0xC6:
          throw runtime_error("progressive JPEG is not supported");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          throw runtime_error("lossless JPEG is not supported");
        case 0xC5:
          throw runtime_error("hierarchical JPEG is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCD:
        case 0xCE:
          throw runtime_error("arithmetic-coded JPEG is not supported");
        case 0xCC:
          throw runtime_error("arithmetic-coded JPEG (DAC) is not supported");
        case 0xC4:
          parse_dht(end);
          break;
        case 0xDB:
          parse_dqt(end);
          break;
        case 0xDD:
          restart_interval = word();
          break;
        case 0xDA:
          if (headers_only) throw runtime_error("SOS before SOF");
          parse_sos(end);
          continue;   // pos is past the scan's data
        case 0xDC:
          throw runtime_error("DNL marker is not supported");
        case 0xE0:
          if (len >= 7 && std::memcmp(data + body, "JFIF\0", 5) == 0)
            saw_jfif = true;
          break;
        case 0xE1:
          parse_app1(body, len - 2);
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(data + body, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[body + 11];
          }
          break;
        default:
          break;   // other APPn, COM
      }
      pos = end;
    }
    if (!have_frame) throw runtime_error("no frame (SOF) in the file");
  }

  void check_colour() const {
    if (ncomp != 3) return;
    bool ycc = true;
    if (saw_jfif) {
      ycc = true;
    } else if (saw_adobe) {
      ycc = adobe_transform == 1;
    } else if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') {
      ycc = false;
    }
    if (!ycc) throw runtime_error("RGB-coded JPEG (no YCbCr transform) is not supported");
  }

  void output_dims(int denom, int* oh, int* ow) const {
    *oh = (height + denom - 1) / denom;
    *ow = (width + denom - 1) / denom;
  }

  void render(int denom, uint8_t* out) {
    check_colour();
    const int min_ss = 8 / denom;
    const bool fancy = min_ss > 1;
    int oh, ow;
    output_dims(denom, &oh, &ow);
    std::vector<uint8_t> planes[3];   // upsampled to (oh, ow)
    for (int ci = 0; ci < ncomp; ++ci) {
      Component& c = comp[ci];
      if (!qt_defined[c.tq]) throw runtime_error("corrupt file: undefined quantisation table");
      // scale the chroma up in the IDCT where the sampling allows
      int ss = min_ss;
      while (ss < 8 && (hmax * min_ss) % (c.h * ss * 2) == 0 &&
             (vmax * min_ss) % (c.v * ss * 2) == 0)
        ss *= 2;
      const int pw = c.bw * ss, ph = c.bh * ss;
      std::vector<uint8_t> plane(size_t(pw) * ph);
      void (*idct)(const int16_t*, const uint16_t*, uint8_t*, int) =
          ss == 8 ? idct_8x8 : ss == 4 ? idct_4x4 : ss == 2 ? idct_2x2 : idct_1x1;
      const uint16_t* q = qt[c.tq];
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct(&c.coef[(size_t(by) * c.bw + bx) * 64], q,
               &plane[size_t(by) * ss * pw + size_t(bx) * ss], pw);
      // the component's true size at this scale
      const int dw = static_cast<int>(
          (int64_t(width) * c.h * ss + int64_t(hmax) * 8 - 1) / (int64_t(hmax) * 8));
      const int dh = static_cast<int>(
          (int64_t(height) * c.v * ss + int64_t(vmax) * 8 - 1) / (int64_t(vmax) * 8));
      const int hin = c.h * ss / min_ss, vin = c.v * ss / min_ss;
      if (hmax % hin || vmax % vin)
        throw runtime_error("unsupported sampling factors");
      const int rh = hmax / hin, rv = vmax / vin;
      std::vector<uint8_t>& up = planes[ci];
      up.resize(size_t(oh) * ow);
      auto in = [&](int y, int x) -> int { return plane[size_t(y) * pw + x]; };
      auto clamp_row = [&](int y) { return y < 0 ? 0 : (y >= dh ? dh - 1 : y); };
      if (rh == 1 && rv == 1) {
        for (int y = 0; y < oh; ++y)
          std::memcpy(&up[size_t(y) * ow], &plane[size_t(y) * pw], ow);
      } else if (rh == 2 && rv == 1 && fancy && dw > 2) {
        std::vector<uint8_t> row(size_t(2) * dw);
        for (int y = 0; y < oh; ++y) {
          const uint8_t* ip = &plane[size_t(y) * pw];
          uint8_t* op = row.data();
          int v0 = ip[0];
          op[0] = static_cast<uint8_t>(v0);
          op[1] = static_cast<uint8_t>((v0 * 3 + ip[1] + 2) >> 2);
          for (int x = 1; x < dw - 1; ++x) {
            int v = ip[x] * 3;
            op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
            op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
          }
          int vl = ip[dw - 1];
          op[2 * dw - 2] = static_cast<uint8_t>((vl * 3 + ip[dw - 2] + 1) >> 2);
          op[2 * dw - 1] = static_cast<uint8_t>(vl);
          std::memcpy(&up[size_t(y) * ow], op, ow);
        }
      } else if (rh == 1 && rv == 2 && fancy) {
        for (int y = 0; y < oh; ++y) {
          int iy = y >> 1;
          int ny = clamp_row((y & 1) ? iy + 1 : iy - 1);
          int bias = (y & 1) ? 2 : 1;
          uint8_t* op = &up[size_t(y) * ow];
          for (int x = 0; x < ow; ++x)
            op[x] = static_cast<uint8_t>((in(iy, x) * 3 + in(ny, x) + bias) >> 2);
        }
      } else if (rh == 2 && rv == 2 && fancy && dw > 2) {
        std::vector<uint8_t> row(size_t(2) * dw);
        for (int y = 0; y < oh; ++y) {
          int iy = y >> 1;
          int ny = clamp_row((y & 1) ? iy + 1 : iy - 1);
          const uint8_t* i0 = &plane[size_t(iy) * pw];
          const uint8_t* i1 = &plane[size_t(ny) * pw];
          uint8_t* op = row.data();
          int thiscol = i0[0] * 3 + i1[0];
          int nextcol = i0[1] * 3 + i1[1];
          op[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
          op[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          int lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 1; x < dw - 1; ++x) {
            nextcol = i0[x + 1] * 3 + i1[x + 1];
            op[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
            op[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          op[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
          std::memcpy(&up[size_t(y) * ow], op, ow);
        }
      } else {
        // replication (libjpeg's int_upsample, h2v1_upsample, h2v2_upsample)
        for (int y = 0; y < oh; ++y) {
          uint8_t* op = &up[size_t(y) * ow];
          const uint8_t* ip = &plane[size_t(y / rv) * pw];
          for (int x = 0; x < ow; ++x) op[x] = ip[x / rh];
        }
      }
    }
    const size_t npix = size_t(oh) * ow;
    if (ncomp == 1) {
      const uint8_t* g = planes[0].data();
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = g[i];
      return;
    }
    // jdcolor.c's tables
    constexpr int SCALEBITS = 16;
    constexpr JLONG ONE_HALF = JLONG(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<JLONG>(x * (1L << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    JLONG cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const uint8_t* Y = planes[0].data();
    const uint8_t* Cb = planes[1].data();
    const uint8_t* Cr = planes[2].data();
    for (size_t i = 0; i < npix; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

int check_denom(int d) { return d == 1 || d == 2 || d == 4 || d == 8; }

}  // namespace

extern "C" {

// Output size of a JPEG decoded at 1/scale_denom (1, 2, 4 or 8).
int jpeg_dims(const uint8_t* data, int64_t n, int scale_denom, int64_t* out_h,
              int64_t* out_w, char* err, int errlen) {
  try {
    if (!check_denom(scale_denom)) throw runtime_error("scale_denom must be 1, 2, 4 or 8");
    Decoder d(data, size_t(n));
    d.parse(true);
    int oh, ow;
    d.output_dims(scale_denom, &oh, &ow);
    *out_h = oh;
    *out_w = ow;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Decode into out, (out_h, out_w, 3) RGB as jpeg_dims gives them.
int jpeg_decode(const uint8_t* data, int64_t n, int scale_denom, uint8_t* out,
                int64_t out_h, int64_t out_w, char* err, int errlen) {
  try {
    if (!check_denom(scale_denom)) throw runtime_error("scale_denom must be 1, 2, 4 or 8");
    Decoder d(data, size_t(n));
    d.parse(false);
    int oh, ow;
    d.output_dims(scale_denom, &oh, &ow);
    if (oh != out_h || ow != out_w) throw runtime_error("output buffer of the wrong size");
    d.render(scale_denom, out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Undo the PNG row filters (None, Sub, Up, Average, Paeth) of h rows, each
// a filter-type byte and stride bytes, bpp bytes per pixel, into
// out (h * stride bytes).
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp,
                 uint8_t* out, char* err, int errlen) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1) + 1;
    const uint8_t* up = y ? out + (y - 1) * stride : nullptr;
    uint8_t* cur = out + y * stride;
    const int type = in[-1];
    if (type > 4) {
      set_err(err, errlen, ("unknown PNG filter type " +
                            std::to_string(type)).c_str());
      return -1;
    }
    for (int64_t i = 0; i < stride; ++i) {
      const int a = i >= bpp ? cur[i - bpp] : 0;
      const int b = up ? up[i] : 0;
      const int c = up && i >= bpp ? up[i - bpp] : 0;
      int pred = 0;
      if (type == 1) {
        pred = a;
      } else if (type == 2) {
        pred = b;
      } else if (type == 3) {
        pred = (a + b) >> 1;
      } else if (type == 4) {
        const int p = a + b - c;
        const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        pred = pa <= pb && pa <= pc ? a : (pb <= pc ? b : c);
      }
      cur[i] = static_cast<uint8_t>(in[i] + pred);
    }
  }
  return 0;
}

}  // extern "C"
