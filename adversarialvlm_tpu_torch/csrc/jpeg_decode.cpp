// Baseline JPEG decoder on the host, equal byte for byte to libjpeg-turbo's default decode (the
// one PIL runs): sequential Huffman, 8-bit samples, 1 or 3 components, sampling 4:4:4, 4:2:2 and
// 4:2:0, restart markers; APPn and COM segments are skipped. It reproduces libjpeg's
//   - islow integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2, the post-IDCT range table),
//   - fancy (triangle) upsampling for h2v1 and h2v2 (jdsample.c), with the edge rows and
//     columns libjpeg's context buffers give (jdmainct.c: the first row above the image, the
//     last real row below it),
//   - fixed-point YCbCr -> RGB (jdcolor.c, SCALEBITS 16).
// Progressive, lossless, hierarchical and arithmetic-coded files, precisions other than 8 bits,
// 4-component (CMYK/YCCK) and RGB-coded (Adobe transform 0) files are refused with a message
// naming what they are.
//
// Build: g++ -O3 -shared -fPIC -o libjpeg_decode.so jpeg_decode.cpp
// ABI kept C-plain for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool present = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // blocks across and down in the coefficient buffer
  int dw = 0, dh = 0;  // downsampled width and height (libjpeg's downsampled_width/height)
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool saw_sof = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
  // bit reader
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  bool hit_marker = false;

  uint8_t byte() {
    if (pos >= len) throw Error{"truncated JPEG"};
    return data[pos++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  void read_dqt(int seglen) {
    size_t end = pos + seglen - 2;
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Error{"bad quantization table id"};
      for (int k = 0; k < 64; k++) qt[tq][kZigzag[k]] = pq ? u16() : byte();
      qt_present[tq] = true;
    }
  }

  void read_dht(int seglen) {
    size_t end = pos + seglen - 2;
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) throw Error{"bad Huffman table id"};
      Huffman& t = tc ? ac[th] : dc[th];
      int counts[17];
      int total = 0;
      for (int l = 1; l <= 16; l++) total += (counts[l] = byte());
      if (total > 256) throw Error{"bad Huffman table"};
      for (int i = 0; i < total; i++) t.vals[i] = byte();
      int code = 0, k = 0;
      for (int l = 1; l <= 16; l++) {
        if (counts[l]) {
          t.valoffset[l] = k - code;
          code += counts[l];
          k += counts[l];
          t.maxcode[l] = code - 1;
        } else {
          t.maxcode[l] = -1;
        }
        code <<= 1;
      }
      t.maxcode[17] = 0x7fffffff;
      t.present = true;
    }
  }

  void read_sof(int marker, int seglen) {
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      throw Error{"progressive JPEG is not supported (baseline sequential only)"};
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      throw Error{"lossless JPEG is not supported (baseline sequential only)"};
    if (marker == 0xC5) throw Error{"hierarchical JPEG is not supported (baseline sequential only)"};
    if (marker >= 0xC9) throw Error{"arithmetic-coded JPEG is not supported (baseline sequential only)"};
    int precision = byte();
    if (precision != 8) throw Error{std::to_string(precision) + "-bit JPEG is not supported (8-bit only)"};
    height = u16();
    width = u16();
    ncomp = byte();
    if (height == 0) throw Error{"JPEG with a DNL height is not supported"};
    if (ncomp == 4) throw Error{"4-component (CMYK/YCCK) JPEG is not supported"};
    if (ncomp != 1 && ncomp != 3) throw Error{std::to_string(ncomp) + "-component JPEG is not supported"};
    if (seglen != 8 + 3 * ncomp) throw Error{"bad SOF segment"};
    for (int c = 0; c < ncomp; c++) {
      comp[c].id = byte();
      int hv = byte();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = byte();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 || comp[c].tq > 3)
        throw Error{"bad SOF component"};
      hmax = comp[c].h > hmax ? comp[c].h : hmax;
      vmax = comp[c].v > vmax ? comp[c].v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      if (ncomp == 1) {
        k.h = k.v = hmax = vmax = 1;
        mcux = (width + 7) / 8;
        mcuy = (height + 7) / 8;
      }
      int rh = hmax / k.h, rv = vmax / k.v;
      if (hmax % k.h || vmax % k.v || rh > 2 || rv > 2 || (rh == 1 && rv == 2))
        throw Error{"JPEG sampling " + std::to_string(k.h) + "x" + std::to_string(k.v) + " of " +
                    std::to_string(hmax) + "x" + std::to_string(vmax) +
                    " is not supported (4:4:4, 4:2:2 and 4:2:0 only)"};
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.dw = (int)(((long long)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((long long)height * k.v + vmax - 1) / vmax);
      k.coef.assign((size_t)k.bw * k.bh * 64, 0);
    }
    saw_sof = true;
  }

  // entropy-coded bits; a marker stops the supply and zeros follow, as libjpeg does
  int bit() {
    if (bitcnt == 0) {
      uint8_t b = 0;
      if (!hit_marker && pos < len) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t n = pos + 1 < len ? data[pos + 1] : 0;
          if (n == 0x00) {
            pos += 2;
          } else {
            hit_marker = true;
            b = 0;
          }
        } else {
          pos++;
        }
      }
      bitbuf = b;
      bitcnt = 8;
    }
    bitcnt--;
    return (bitbuf >> bitcnt) & 1;
  }
  int receive(int s) {
    int v = 0;
    for (int i = 0; i < s; i++) v = (v << 1) | bit();
    return v;
  }
  static int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }
  int decode(const Huffman& t) {
    int code = bit();
    int l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | bit();
      if (++l > 16) return 0;  // corrupt data: libjpeg warns and substitutes 0
    }
    return t.vals[code + t.valoffset[l]];
  }

  void decode_block(Component& k, int16_t* blk) {
    const Huffman& hd = dc[k.td];
    const Huffman& ha = ac[k.ta];
    int s = decode(hd);
    int diff = s ? extend(receive(s), s) : 0;
    k.pred += diff;
    blk[0] = (int16_t)k.pred;
    for (int i = 1; i < 64; i++) {
      int rs = decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        if (i > 63) break;
        blk[kZigzag[i]] = (int16_t)extend(receive(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void read_restart() {
    bitcnt = 0;
    if (!hit_marker) {
      // skip to the marker
      while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF)) pos++;
    }
    if (pos + 1 < len && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
    hit_marker = false;
    for (int c = 0; c < ncomp; c++) comp[c].pred = 0;
  }

  void read_sos() {
    if (!saw_sof) throw Error{"SOS before SOF"};
    int ns = byte();
    if (ns < 1 || ns > ncomp) throw Error{"bad SOS"};
    int idx[3];
    for (int i = 0; i < ns; i++) {
      int cid = byte(), tdta = byte();
      idx[i] = -1;
      for (int c = 0; c < ncomp; c++)
        if (comp[c].id == cid) idx[i] = c;
      if (idx[i] < 0) throw Error{"SOS names an unknown component"};
      comp[idx[i]].td = tdta >> 4;
      comp[idx[i]].ta = tdta & 15;
      if (comp[idx[i]].td > 3 || comp[idx[i]].ta > 3 || !dc[comp[idx[i]].td].present || !ac[comp[idx[i]].ta].present)
        throw Error{"SOS names a missing Huffman table"};
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) throw Error{"progressive JPEG is not supported (baseline sequential only)"};
    for (int c = 0; c < ncomp; c++) comp[c].pred = 0;
    bitcnt = 0;
    hit_marker = false;
    int todo = restart;
    if (ns == 1) {
      Component& k = comp[idx[0]];
      int nbw = (k.dw + 7) / 8, nbh = (k.dh + 7) / 8;
      for (int by = 0; by < nbh; by++)
        for (int bx = 0; bx < nbw; bx++) {
          if (restart && todo == 0) {
            read_restart();
            todo = restart;
          }
          decode_block(k, &k.coef[((size_t)by * k.bw + bx) * 64]);
          todo--;
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart && todo == 0) {
            read_restart();
            todo = restart;
          }
          for (int i = 0; i < ns; i++) {
            Component& k = comp[idx[i]];
            for (int v = 0; v < k.v; v++)
              for (int h = 0; h < k.h; h++) {
                int by = my * k.v + v, bx = mx * k.h + h;
                decode_block(k, &k.coef[((size_t)by * k.bw + bx) * 64]);
              }
          }
          todo--;
        }
    }
    // leave the reader at the next marker
    bitcnt = 0;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 && !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) && data[pos + 1] != 0xFF))
      pos++;
    hit_marker = false;
  }

  void parse(bool header_only) {
    if (len < 2 || data[0] != 0xFF || data[1] != 0xD8) throw Error{"not a JPEG (no SOI marker)"};
    pos = 2;
    while (true) {
      if (pos >= len) throw Error{"truncated JPEG (no EOI marker)"};
      if (data[pos] != 0xFF) {
        pos++;
        continue;
      }
      while (pos < len && data[pos] == 0xFF) pos++;
      int m = byte();
      if (m == 0xD9) break;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int seglen = u16();
      if (seglen < 2 || pos + seglen - 2 > len) throw Error{"truncated JPEG segment"};
      size_t seg = pos;
      if (m == 0xDB) {
        read_dqt(seglen);
      } else if (m == 0xC4) {
        read_dht(seglen);
      } else if (m == 0xCC) {
        throw Error{"arithmetic-coded JPEG is not supported (baseline sequential only)"};
      } else if (m >= 0xC0 && m <= 0xCF) {
        if (saw_sof) throw Error{"two SOF markers"};
        read_sof(m, seglen);
        check_colour();
        if (header_only) return;
      } else if (m == 0xDD) {
        restart = u16();
      } else if (m == 0xDA) {
        pos = seg;
        read_sos();
        continue;
      } else if (m == 0xE0 && seglen >= 7 && !memcmp(data + seg, "JFIF\0", 5)) {
        jfif = true;
      } else if (m == 0xEE && seglen >= 14 && !memcmp(data + seg, "Adobe", 5)) {
        adobe = true;
        adobe_transform = data[seg + 11];
      }
      pos = seg + seglen - 2;
    }
    if (!saw_sof) throw Error{"JPEG without a frame (no SOF marker)"};
  }

  // libjpeg's default colour space for 3 components (jdapimin.c default_decompress_parms)
  void check_colour() {
    if (ncomp != 3) return;
    bool rgb;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    if (rgb) throw Error{"RGB-coded JPEG (Adobe transform 0) is not supported (YCbCr only)"};
  }
};

// jidctint.c, islow
const int CONST_BITS = 13, PASS1_BITS = 2;
const long long F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995,
                F3072 = 25172;

inline long long descale(long long x, int n) { return (x + (1LL << (n - 1))) >> n; }

inline uint8_t idct_limit(long long x) {
  int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* in, const int* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dcval = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dcval;
      continue;
    }
    long long z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    long long z1 = (z2 + z3) * F0541;
    long long tmp2 = z1 + z3 * -F1847;
    long long tmp3 = z1 + z2 * F0765;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    long long tmp0 = (z2 + z3) * (1LL << CONST_BITS);
    long long tmp1 = (z2 - z3) * (1LL << CONST_BITS);
    long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long long z4 = tmp1 + tmp3;
    long long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, n);
    wp[56] = (int)descale(tmp10 - tmp3, n);
    wp[8] = (int)descale(tmp11 + tmp2, n);
    wp[48] = (int)descale(tmp11 - tmp2, n);
    wp[16] = (int)descale(tmp12 + tmp1, n);
    wp[40] = (int)descale(tmp12 - tmp1, n);
    wp[24] = (int)descale(tmp13 + tmp0, n);
    wp[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = idct_limit(descale(wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    long long z2 = wp[2], z3 = wp[6];
    long long z1 = (z2 + z3) * F0541;
    long long tmp2 = z1 + z3 * -F1847;
    long long tmp3 = z1 + z2 * F0765;
    long long tmp0 = ((long long)wp[0] + wp[4]) * (1LL << CONST_BITS);
    long long tmp1 = ((long long)wp[0] - wp[4]) * (1LL << CONST_BITS);
    long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long long z4 = tmp1 + tmp3;
    long long z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = idct_limit(descale(tmp10 + tmp3, n));
    op[7] = idct_limit(descale(tmp10 - tmp3, n));
    op[1] = idct_limit(descale(tmp11 + tmp2, n));
    op[6] = idct_limit(descale(tmp11 - tmp2, n));
    op[2] = idct_limit(descale(tmp12 + tmp1, n));
    op[5] = idct_limit(descale(tmp12 - tmp1, n));
    op[3] = idct_limit(descale(tmp13 + tmp0, n));
    op[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// one component's samples, (bh*8) x (bw*8)
std::vector<uint8_t> samples(const Decoder& d, const Component& k) {
  if (!d.qt_present[k.tq]) throw Error{"missing quantization table"};
  int sw = k.bw * 8;
  std::vector<uint8_t> out((size_t)k.bh * 8 * sw);
  for (int by = 0; by < k.bh; by++)
    for (int bx = 0; bx < k.bw; bx++)
      idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], d.qt[k.tq], &out[(size_t)by * 8 * sw + bx * 8], sw);
  return out;
}

// the component upsampled to the full (mcu-padded) width over the image's rows: jdsample.c's
// fullsize, h2v1_fancy_upsample and h2v2_fancy_upsample on libjpeg's context rows
std::vector<uint8_t> upsample(const Decoder& d, const Component& k, const std::vector<uint8_t>& in, int& out_w) {
  int sw = k.bw * 8;
  int rh = d.hmax / k.h, rv = d.vmax / k.v;
  if (rh == 1 && rv == 1) {
    out_w = sw;
    return in;
  }
  out_w = sw * 2;
  std::vector<uint8_t> out((size_t)d.height * out_w + out_w * 2);
  auto row = [&](int y) {  // rows past the last real one repeat it; the row above the first is the first
    if (y < 0) y = 0;
    if (y > k.dh - 1) y = k.dh - 1;
    return &in[(size_t)y * sw];
  };
  int n = k.dw;
  if (rv == 1) {  // h2v1
    for (int y = 0; y < d.height; y++) {
      const uint8_t* ip = row(y);
      uint8_t* op = &out[(size_t)y * out_w];
      int v = ip[0];
      op[0] = (uint8_t)v;
      op[1] = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < n - 1; x++) {
        v = ip[x] * 3;
        op[2 * x] = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        op[2 * x + 1] = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[n - 1];
      op[2 * (n - 1)] = (uint8_t)((v * 3 + ip[n - 2] + 1) >> 2);
      op[2 * (n - 1) + 1] = (uint8_t)v;
    }
    return out;
  }
  // h2v2
  for (int y = 0; y < d.height; y++) {
    int iy = y >> 1;
    const uint8_t* i0 = row(iy);
    const uint8_t* i1 = row((y & 1) ? iy + 1 : iy - 1);
    uint8_t* op = &out[(size_t)y * out_w];
    int thiscol = i0[0] * 3 + i1[0];
    int nextcol = i0[1] * 3 + i1[1];
    op[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
    op[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 2; x < n; x++) {
      nextcol = i0[x] * 3 + i1[x];
      op[2 * (x - 1)] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      op[2 * (x - 1) + 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    op[2 * (n - 1)] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
    op[2 * (n - 1) + 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
  }
  return out;
}

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

int fail(const Error& e, char* err, int err_cap) {
  if (err && err_cap > 0) snprintf(err, (size_t)err_cap, "%s", e.msg.c_str());
  return 1;
}

}  // namespace

extern "C" {

// (height, width, components) of a JPEG's frame into info[0..2]; 0, or 1 with a message in err.
int jpeg_header(const uint8_t* data, int64_t len, int* info, char* err, int err_cap) {
  try {
    Decoder d{data, (size_t)len};
    d.parse(true);
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    return 0;
  } catch (const Error& e) {
    return fail(e, err, err_cap);
  } catch (const std::exception& e) {
    return fail(Error{e.what()}, err, err_cap);
  }
}

// The image as (height, width, 3) RGB uint8 into out (gray repeated into the three channels, as
// PIL's convert("RGB") gives it); 0, or 1 with a message in err.
int jpeg_decode_rgb(const uint8_t* data, int64_t len, uint8_t* out, char* err, int err_cap) {
  try {
    Decoder d{data, (size_t)len};
    d.parse(false);
    const int w = d.width, h = d.height;
    if (d.ncomp == 1) {
      std::vector<uint8_t> s = samples(d, d.comp[0]);
      int sw = d.comp[0].bw * 8;
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
          uint8_t v = s[(size_t)y * sw + x];
          uint8_t* o = out + ((size_t)y * w + x) * 3;
          o[0] = o[1] = o[2] = v;
        }
      return 0;
    }
    std::vector<uint8_t> planes[3];
    int pw[3];
    for (int c = 0; c < 3; c++) planes[c] = upsample(d, d.comp[c], samples(d, d.comp[c]), pw[c]);
    // jdcolor.c's tables
    const int SCALEBITS = 16;
    const long long ONE_HALF = 1LL << (SCALEBITS - 1);
    auto fix = [&](double x) { return (long long)(x * (1LL << SCALEBITS) + 0.5); };
    int cr_r[256], cb_b[256];
    long long cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    for (int y = 0; y < h; y++) {
      const uint8_t* yp = &planes[0][(size_t)y * pw[0]];
      const uint8_t* cbp = &planes[1][(size_t)y * pw[1]];
      const uint8_t* crp = &planes[2][(size_t)y * pw[2]];
      uint8_t* o = out + (size_t)y * w * 3;
      for (int x = 0; x < w; x++) {
        int yy = yp[x], cb = cbp[x], cr = crp[x];
        o[3 * x] = clamp255(yy + cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
        o[3 * x + 2] = clamp255(yy + cb_b[cb]);
      }
    }
    return 0;
  } catch (const Error& e) {
    return fail(e, err, err_cap);
  } catch (const std::exception& e) {
    return fail(Error{e.what()}, err, err_cap);
  }
}

}  // extern "C"
