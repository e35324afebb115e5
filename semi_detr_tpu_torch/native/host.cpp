// Host library of the port: image decode (PNG here, JPEG through the back
// end of host.h), JPEG encode, bilinear resize, affine warp, the pixel
// loops of the colour ops, and a threaded prefetch loader.
//
// Counterpart of semi_detr_tpu/native/dataloader.cpp, plus the pixel work
// that the JAX package leaves to cv2 and Pillow. Every function reproduces
// a numpy plain version of the port (data/augment.py, data/image_io.py)
// bit for bit: the same float32 operations in the same order, each one
// rounded (the library is built with -ffp-contract=off, so no a * b + c is
// fused into an FMA), np.rint as round half to even, float -> uint8 as
// truncation.
//
// Each call writes into a buffer the caller allocates, touches no Python
// object and may run on any thread; ctypes releases the GIL for the call.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "host.h"

namespace sdt {

namespace {
thread_local std::string t_error;
}

void set_error(const std::string& msg) { t_error = msg; }

// ---------------------------------------------------------- YCbCr -> RGB
// libjpeg-turbo's jdsample.c (h2v1, h1v2 and h2v2 fancy upsampling: 3/4 of
// the nearer sample and 1/4 of the further one per dimension, with its
// rounding biases; the rows above the first and below the last repeat
// them; plain replication where a 2h plane is at most 2 samples wide) and
// jdcolor.c (ycc_rgb_convert, 16-bit fixed point).

namespace {

struct YccTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      const int x = i - 128;  // FIX(1.40200), FIX(1.77200), FIX(0.71414),
      cr_r[i] = (91881 * x + 32768) >> 16;  // FIX(0.34414) of 16 bits,
      cb_b[i] = (116130 * x + 32768) >> 16;  // ONE_HALF = 1 << 15
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + 32768;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables t;
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// one upsampled output row (w values) of a chroma plane
void upsample_row(const uint8_t* plane, int ch, int cw, int hs, int vs,
                  int y, int w, int* colsum, uint8_t* dst) {
  const int inrow = vs == 2 ? y / 2 : y;
  const uint8_t* near = plane + static_cast<long>(inrow) * cw;
  if (hs == 2 && cw <= 2) {  // libjpeg replicates planes this narrow
    for (int x = 0; x < w; ++x) dst[x] = near[x / 2];
    return;
  }
  if (vs == 2) {  // the further row: above for even rows, below for odd
    const int far_row = (y % 2 == 0) ? (inrow > 0 ? inrow - 1 : 0)
                                     : (inrow + 1 < ch ? inrow + 1 : ch - 1);
    const uint8_t* far = plane + static_cast<long>(far_row) * cw;
    for (int j = 0; j < cw; ++j) colsum[j] = near[j] * 3 + far[j];
    if (hs == 1) {  // h1v2
      const int bias = (y % 2 == 0) ? 1 : 2;
      for (int x = 0; x < w; ++x) dst[x] = (colsum[x] + bias) >> 2;
      return;
    }
    // h2v2, into 2 * cw >= w values
    dst[0] = (colsum[0] * 4 + 8) >> 4;
    for (int j = 1; j < cw; ++j)
      dst[2 * j] = (colsum[j] * 3 + colsum[j - 1] + 8) >> 4;
    for (int j = 0; j < cw - 1; ++j)
      dst[2 * j + 1] = (colsum[j] * 3 + colsum[j + 1] + 7) >> 4;
    dst[2 * cw - 1] = (colsum[cw - 1] * 4 + 7) >> 4;
    return;
  }
  if (hs == 1) {  // no subsampling
    std::memcpy(dst, near, w);
    return;
  }
  // h2v1, into 2 * cw >= w values
  dst[0] = near[0];
  for (int j = 1; j < cw; ++j)
    dst[2 * j] = (near[j] * 3 + near[j - 1] + 1) >> 2;
  for (int j = 0; j < cw - 1; ++j)
    dst[2 * j + 1] = (near[j] * 3 + near[j + 1] + 2) >> 2;
  dst[2 * cw - 1] = near[cw - 1];
}

}  // namespace

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                int h, int w, int ch, int cw, int hs, int vs, uint8_t* out) {
  const YccTables& t = ycc_tables();
  std::vector<int> colsum(cw);
  // an upsampled row holds 2 * cw values where hs is 2; w are used
  std::vector<uint8_t> cb_row(2 * cw + w), cr_row(2 * cw + w);
  for (int r = 0; r < h; ++r) {
    upsample_row(cb, ch, cw, hs, vs, r, w, colsum.data(), cb_row.data());
    upsample_row(cr, ch, cw, hs, vs, r, w, colsum.data(), cr_row.data());
    const uint8_t* yr = y + static_cast<long>(r) * w;
    uint8_t* o = out + static_cast<long>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yr[x], b = cb_row[x], c = cr_row[x];
      o[3 * x] = clamp255(yy + t.cr_r[c]);
      o[3 * x + 1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[c]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[b]);
    }
  }
}

// ---------------------------------------------------------- RGB -> YCbCr
// libjpeg-turbo's jccolor.c (rgb_ycc_convert, 16-bit fixed point) and
// jcsample.c (h2v2_downsample: the mean of each 2x2 block with the
// rounding bias 1, 2, 1, 2, ... along a row; the last column and row
// repeated where the size is odd).

namespace {

struct RgbYccTables {
  int32_t r_y[256], g_y[256], b_y[256], r_cb[256], g_cb[256], b_cb[256],
      g_cr[256], b_cr[256];
  RgbYccTables() {
    auto fix = [](double x) { return static_cast<int32_t>(x * 65536 + 0.5); };
    const int32_t half = 1 << 15, offset = 128 << 16;
    for (int32_t i = 0; i < 256; ++i) {
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + half;
      r_cb[i] = -fix(0.16874) * i;
      g_cb[i] = -fix(0.33126) * i;
      // half - 1: 255 stays 255 (also r_cr)
      b_cb[i] = fix(0.50000) * i + offset + half - 1;
      g_cr[i] = -fix(0.41869) * i;
      b_cr[i] = -fix(0.08131) * i;
    }
  }
};

}  // namespace

void rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y, uint8_t* cb,
                   uint8_t* cr) {
  static const RgbYccTables t;
  const int cw = (w + 1) / 2;
  // two full-resolution chroma rows, each one column longer where w is odd
  std::vector<uint8_t> full(4 * static_cast<size_t>(cw) * 2);
  uint8_t* fcb[2] = {full.data(), full.data() + 2 * cw};
  uint8_t* fcr[2] = {full.data() + 4 * cw, full.data() + 6 * cw};
  for (int r = 0; r < h; r += 2) {
    for (int k = 0; k < 2; ++k) {
      const int row = r + k < h ? r + k : h - 1;
      const uint8_t* p = rgb + static_cast<long>(row) * w * 3;
      uint8_t* yr = y + static_cast<long>(row) * w;
      for (int x = 0; x < w; ++x) {
        const int R = p[3 * x], G = p[3 * x + 1], B = p[3 * x + 2];
        yr[x] = static_cast<uint8_t>((t.r_y[R] + t.g_y[G] + t.b_y[B]) >> 16);
        fcb[k][x] = static_cast<uint8_t>((t.r_cb[R] + t.g_cb[G] + t.b_cb[B]) >>
                                         16);
        fcr[k][x] = static_cast<uint8_t>((t.b_cb[R] + t.g_cr[G] + t.b_cr[B]) >>
                                         16);
      }
      if (w % 2) {
        fcb[k][w] = fcb[k][w - 1];
        fcr[k][w] = fcr[k][w - 1];
      }
    }
    uint8_t* ob = cb + static_cast<long>(r / 2) * cw;
    uint8_t* orr = cr + static_cast<long>(r / 2) * cw;
    auto mean4 = [](const uint8_t* a, const uint8_t* b, int bias) {
      return static_cast<uint8_t>((a[0] + a[1] + b[0] + b[1] + bias) >> 2);
    };
    int bias = 1;
    for (int j = 0; j < cw; ++j) {
      ob[j] = mean4(fcb[0] + 2 * j, fcb[1] + 2 * j, bias);
      orr[j] = mean4(fcr[0] + 2 * j, fcr[1] + 2 * j, bias);
      bias ^= 3;
    }
  }
}

// ------------------------------------------------- JPEG check and decode
// The entropy-coded data of a sequential Huffman JPEG (SOF0, SOF1) decoded
// to its coefficients as libjpeg's jdhuff.c reads them: the DC prediction
// per component (reset at each scan and restart), the sign extension, the
// zig-zag order and interleaved or one-component scans. The check throws
// the coefficients away: a code that no table holds, a scan whose data ends
// before its last block or a restart marker out of order fails, as
// libjpeg's slow path warns (its fast path lets a bad code pass as 0).
// Other streams (progressive, arithmetic) are walked marker by marker only.
// Bytes between markers that no scan reads pass, as libjpeg passes them
// with a warning.
//
// The decode keeps the coefficients, dequantizes them by the DQT table
// each component latched at its first scan, runs libjpeg's integer IDCT
// (jidctint.c, jpeg_idct_islow) and finishes the planes with ycc_to_rgb:
// the pixels of libjpeg's default decode, which libjpeg-turbo's SIMD islow
// matches bit for bit.

namespace {

constexpr int kLook = 9;  // bits of the lookahead table

// zig-zag position -> natural (row-major) position; 16 more entries catch
// a run past the end of a block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct HuffTable {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // (length << 8) | symbol of each code of at most kLook bits, by prefix;
  // 0: a longer code, or none
  uint16_t look[1 << kLook];
};

// libjpeg's jpeg_make_d_derived_tbl: canonical codes from the counts of
// each length; false for a table that does not fit its lengths or (DC) a
// category above 15
bool make_table(const uint8_t* counts, const uint8_t* vals, int nvals,
                bool dc, HuffTable* t) {
  int size[257], code[256];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) size[p++] = l;
  size[p] = 0;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) return false;
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t->valoffset[l] = p - code[p];
      p += counts[l - 1];
      t->maxcode[l] = code[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;  // ends the search: no code is longer than 16
  std::memcpy(t->vals, vals, nvals);
  std::memset(t->look, 0, sizeof(t->look));
  for (int q = 0; q < nvals; ++q) {
    if (dc && vals[q] > 15) return false;
    if (size[q] > kLook) continue;
    const int shift = kLook - size[q];
    for (int j = 0; j < (1 << shift); ++j)
      t->look[(code[q] << shift) | j] =
          static_cast<uint16_t>((size[q] << 8) | vals[q]);
  }
  t->defined = true;
  return true;
}

// the bits of a scan's entropy-coded data: stuffed 0xFF 0x00 read as 0xFF,
// zero bits after the data's end (a marker, or the stream's end), as
// libjpeg's jpeg_fill_bit_buffer supplies them
struct Bits {
  const uint8_t* d;
  long n, pos;
  uint64_t buf = 0;
  int have = 0;  // bits held, the low ones of buf
  int pad = 0;   // of those, the zeros after the data's end
  bool ended = false;

  Bits(const uint8_t* data, long size, long start)
      : d(data), n(size), pos(start) {}

  void fill() {
    while (have <= 56) {
      int byte = 0;
      if (!ended) {
        if (pos < n && d[pos] != 0xFF) {
          byte = d[pos++];
        } else if (pos + 1 < n && d[pos + 1] == 0x00) {
          byte = 0xFF;
          pos += 2;
        } else {
          ended = true;  // pos stays at the marker's 0xFF
        }
      }
      if (ended) pad += 8;
      buf = (buf << 8) | static_cast<uint64_t>(byte);
      have += 8;
    }
  }
  uint32_t peek(int k) {  // k <= 16
    if (have < k) fill();
    return static_cast<uint32_t>(buf >> (have - k)) & ((1u << k) - 1);
  }
  uint32_t get(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    have -= k;
    return v;
  }
  bool overrun() const { return have < pad; }  // a zero past the end read
  // drops the bits held and moves to the next marker (skipping bytes no
  // block read); returns its code, or -1 at the stream's end
  int next_marker() {
    have = pad = 0;
    ended = false;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] != 0x00 && d[pos + 1] != 0xFF)
        return d[pos + 1];
      ++pos;
    }
    return -1;
  }
};

// one symbol of table t; -1 for a bad code
int decode(Bits* b, const HuffTable& t) {
  const uint32_t look = t.look[b->peek(kLook)];
  if (look) {
    b->get(look >> 8);
    return look & 0xFF;
  }
  int32_t code = static_cast<int32_t>(b->get(kLook));
  int l = kLook;
  while (code > t.maxcode[l]) {
    code = (code << 1) | static_cast<int32_t>(b->get(1));
    ++l;
  }
  if (l > 16) return -1;
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

// libjpeg's HUFF_EXTEND: s bits r as a signed value
inline int extend(uint32_t r, int s) {
  const int v = static_cast<int>(r);
  return s && v < (1 << (s - 1)) ? v + static_cast<int>(~0u << s) + 1 : v;
}

// one 8x8 block: the DC difference, then the AC run/size pairs to the EOB.
// With blk, the coefficients go there in natural order (blk zeroed by the
// caller) and *dc carries the component's DC prediction, each value cast
// to 16 bits as jdhuff.c's JCOEF.
bool read_block(Bits* b, const HuffTable& dc, const HuffTable& ac,
                int16_t* blk, int* last_dc) {
  const int s = decode(b, dc);
  if (s < 0) return false;
  const uint32_t r0 = b->get(s);
  if (blk) {
    *last_dc = static_cast<int>(static_cast<unsigned>(extend(r0, s)) +
                                static_cast<unsigned>(*last_dc));
    blk[0] = static_cast<int16_t>(*last_dc);
  }
  for (int k = 1; k < 64; ++k) {
    const int rs = decode(b, ac);
    if (rs < 0) return false;
    const int r = rs >> 4, z = rs & 15;
    if (z) {
      k += r;
      const uint32_t v = b->get(z);
      if (blk) blk[kNatural[k]] = static_cast<int16_t>(extend(v, z));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

struct Frame {
  bool seen = false, huffman_sequential = false;
  int precision = 8, width = 0, height = 0, hmax = 1, vmax = 1, ncomp = 0;
  int id[4], hs[4], vs[4], tq[4];
};

// what the decode keeps of a stream: the DQT tables as defined, each
// component's table latched at its first scan, and its coefficient blocks
// over the MCU grid (bh x bw blocks of 64, natural order)
struct Coefs {
  uint16_t dqt[4][64];
  bool dqt_defined[4] = {false, false, false, false};
  uint16_t qt[4][64];
  bool scanned[4] = {false, false, false, false};
  int bw[4], bh[4];
  std::vector<int16_t> blocks[4];
};

int damaged(const char* what) {
  set_error(std::string("JPEG: damaged data: ") + what);
  return kCorrupt;
}

// a scan's data ended before its last block: at the stream's end (a
// truncated file) or at a marker
int ran_out(const Bits& b) {
  return damaged(b.pos + 1 >= b.n ? "Premature end of JPEG file"
                                  : "premature end of data segment");
}

// the scan whose header (SOS segment body sos, len bytes) ends at data;
// on success *end is the position of the marker after the scan. With co,
// the coefficients are kept there.
int read_scan(const uint8_t* d, long n, const uint8_t* sos, long len,
              long data, const Frame& f, const HuffTable* dc,
              const HuffTable* ac, int restart, Coefs* co, long* end) {
  const int ns = len >= 1 ? sos[0] : 0;
  if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
    return damaged("bad scan header");
  int comp[4];
  for (int j = 0; j < ns; ++j) {
    const int cid = sos[1 + 2 * j], tables = sos[2 + 2 * j];
    comp[j] = -1;
    for (int i = 0; i < f.ncomp; ++i)
      if (f.id[i] == cid) comp[j] = i;
    if (comp[j] < 0 || (tables >> 4) > 3 || (tables & 15) > 3 ||
        !dc[tables >> 4].defined || !ac[tables & 15].defined)
      return damaged("scan of an unknown component or Huffman table");
  }
  if (co) {  // libjpeg's latch_quant_tables
    for (int j = 0; j < ns; ++j) {
      const int c = comp[j];
      if (co->scanned[c]) continue;
      if (!co->dqt_defined[f.tq[c]]) {
        set_error("JPEG: a scan's quantization table is not defined");
        return kCorrupt;
      }
      std::memcpy(co->qt[c], co->dqt[f.tq[c]], sizeof(co->qt[c]));
      co->scanned[c] = true;
    }
  }
  // blocks of each MCU, by component, and the MCU grid
  long mcus, mcu_w;
  int blocks[4];
  if (ns == 1) {
    const int i = comp[0];
    mcu_w = (static_cast<long>(f.width) * f.hs[i] + 8L * f.hmax - 1) /
            (8L * f.hmax);
    const long bh = (static_cast<long>(f.height) * f.vs[i] + 8L * f.vmax -
                     1) / (8L * f.vmax);
    mcus = mcu_w * bh;
    blocks[0] = 1;
  } else {
    mcu_w = (f.width + 8L * f.hmax - 1) / (8L * f.hmax);
    mcus = mcu_w * ((f.height + 8L * f.vmax - 1) / (8L * f.vmax));
    for (int j = 0; j < ns; ++j) blocks[j] = f.hs[comp[j]] * f.vs[comp[j]];
  }
  Bits b(d, n, data);
  int last_dc[4] = {0, 0, 0, 0};
  int expect = 0;  // the next restart marker, RST0 .. RST7
  for (long m = 0; m < mcus; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (b.overrun()) return ran_out(b);
      if (b.next_marker() != 0xD0 + expect)
        return damaged("restart marker missing or out of order");
      b.pos += 2;
      expect = (expect + 1) & 7;
      last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
    }
    const long my = m / mcu_w, mx = m % mcu_w;
    for (int j = 0; j < ns; ++j) {
      const int t = sos[2 + 2 * j], c = comp[j];
      for (int k = 0; k < blocks[j]; ++k) {
        int16_t* blk = nullptr;
        if (co) {  // the block's place in the component's grid
          const long by = ns == 1 ? my : my * f.vs[c] + k / f.hs[c];
          const long bx = ns == 1 ? mx : mx * f.hs[c] + k % f.hs[c];
          blk = co->blocks[c].data() + (by * co->bw[c] + bx) * 64;
        }
        if (!read_block(&b, dc[t >> 4], ac[t & 15], blk, &last_dc[j]))
          return damaged("bad Huffman code");
      }
    }
    if (b.overrun()) return ran_out(b);
  }
  if (b.next_marker() < 0)
    return damaged("Premature end of JPEG file (no EOI)");
  *end = b.pos;
  return kOk;
}

// the frame's components' block grids, each padded to whole MCUs
void size_coefs(const Frame& f, Coefs* co) {
  const long mw = (f.width + 8L * f.hmax - 1) / (8L * f.hmax);
  const long mh = (f.height + 8L * f.vmax - 1) / (8L * f.vmax);
  for (int c = 0; c < f.ncomp; ++c) {
    co->bw[c] = static_cast<int>(mw * f.hs[c]);
    co->bh[c] = static_cast<int>(mh * f.vs[c]);
    co->blocks[c].assign(static_cast<size_t>(co->bw[c]) * co->bh[c] * 64, 0);
  }
}

// The stream walked from SOI to EOI; with co (a sequential Huffman frame
// only) the coefficients kept. Also reports the frame to *fo.
int walk(const uint8_t* d, long n, Coefs* co, Frame* fo) {
  Frame f;
  HuffTable dc[4], ac[4];
  int restart = 0;
  bool scanned = false;
  long i = 2;  // after SOI
  while (i + 1 < n) {
    if (d[i] != 0xFF || d[i + 1] == 0xFF) {  // stray byte or fill byte
      ++i;
      continue;
    }
    const int m = d[i + 1];
    i += 2;
    if (m == 0xD9) {  // EOI
      if (!scanned) return damaged("no scan before EOI");
      if (fo) *fo = f;
      return kOk;
    }
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // no length
    if (i + 1 >= n) break;
    const long len = (static_cast<long>(d[i]) << 8) | d[i + 1];
    if (len < 2 || i + len > n) break;
    const uint8_t* body = d + i + 2;
    const long blen = len - 2;
    i += len;
    if (m == 0xC4) {  // DHT: one or more tables
      long q = 0;
      while (q < blen) {
        if (q + 17 > blen) return damaged("bad Huffman table");
        const int tc = body[q] >> 4, th = body[q] & 15;
        int nvals = 0;
        for (int l = 0; l < 16; ++l) nvals += body[q + 1 + l];
        if (tc > 1 || th > 3 || nvals > 256 || q + 17 + nvals > blen ||
            !make_table(body + q + 1, body + q + 17, nvals, tc == 0,
                        tc == 0 ? &dc[th] : &ac[th]))
          return damaged("bad Huffman table");
        q += 17 + nvals;
      }
    } else if (m == 0xDB && co) {  // DQT: tables in zig-zag order
      long q = 0;
      while (q < blen) {
        const int pq = body[q] >> 4, tq = body[q] & 15;
        const long size = pq ? 128 : 64;
        if (pq > 1 || tq > 3 || q + 1 + size > blen)
          return damaged("bad quantization table");
        for (int k = 0; k < 64; ++k)
          co->dqt[tq][kNatural[k]] = static_cast<uint16_t>(
              pq ? (body[q + 1 + 2 * k] << 8) | body[q + 2 + 2 * k]
                 : body[q + 1 + k]);
        co->dqt_defined[tq] = true;
        q += 1 + size;
      }
    } else if (m == 0xDD) {  // DRI
      if (blen != 2) return damaged("bad restart interval");
      restart = (body[0] << 8) | body[1];
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {  // SOFn
      const int nc = blen >= 6 ? body[5] : 0;
      if (nc < 1 || nc > 4 || blen != 6 + 3 * nc)
        return damaged("bad frame header");
      f.seen = true;
      f.precision = body[0];
      f.height = (body[1] << 8) | body[2];
      f.width = (body[3] << 8) | body[4];
      f.ncomp = nc;
      for (int c = 0; c < nc; ++c) {
        f.id[c] = body[6 + 3 * c];
        f.hs[c] = body[7 + 3 * c] >> 4;
        f.vs[c] = body[7 + 3 * c] & 15;
        f.tq[c] = body[8 + 3 * c] & 3;
        if (f.hs[c] < 1 || f.hs[c] > 4 || f.vs[c] < 1 || f.vs[c] > 4)
          return damaged("bad sampling factors");
        f.hmax = std::max(f.hmax, f.hs[c]);
        f.vmax = std::max(f.vmax, f.vs[c]);
      }
      // a height of 0 comes in a DNL segment after the scan: walk only
      f.huffman_sequential = (m == 0xC0 || m == 0xC1) && f.height > 0 &&
                             f.width > 0;
      if (co) {
        if (!f.huffman_sequential) {
          set_error("JPEG: not a sequential Huffman stream");
          return kUnsupported;
        }
        size_coefs(f, co);
      }
    } else if (m == 0xDA) {  // SOS and its entropy-coded data
      if (!f.seen) return damaged("scan before the frame header");
      scanned = true;
      if (f.huffman_sequential) {
        const int st = read_scan(d, n, body, blen, i, f, dc, ac, restart, co,
                                 &i);
        if (st) return st;
        continue;
      }
      while (i + 1 < n) {  // up to the next marker
        const void* ff = std::memchr(d + i, 0xFF, n - 1 - i);
        if (!ff) {
          i = n;
          break;
        }
        i = static_cast<const uint8_t*>(ff) - d;
        const int next = d[i + 1];
        if (next != 0x00 && !(next >= 0xD0 && next <= 0xD7)) break;
        i += 2;  // a stuffed 0xFF or a restart marker
      }
    }
  }
  return damaged("Premature end of JPEG file (no EOI)");
}

// libjpeg's sample_range_limit + CENTERJSAMPLE (jdmaster.c
// prepare_range_limit_table), read at a DESCALEd IDCT output & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};

// jidctint.c, jpeg_idct_islow: the 8x8 block (natural order) dequantized
// by q, into 8 rows of out (stride bytes apart), cropped to rows x cols
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                long stride, int rows, int cols) {
  static const RangeLimit range;
  constexpr int kConst = 13, kPass1 = 2;
  auto descale = [](int64_t x, int n) {
    return static_cast<int>((x + (int64_t{1} << (n - 1))) >> n);
  };
  // FIX(x) of CONST_BITS 13
  constexpr int64_t f0_298 = 2446, f0_390 = 3196, f0_541 = 4433,
                    f0_765 = 6270, f0_899 = 7373, f1_175 = 9633,
                    f1_501 = 12299, f1_847 = 15137, f1_961 = 16069,
                    f2_053 = 16819, f2_562 = 20995, f3_072 = 25172;
  int ws[64];
  int64_t tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13, z1, z2, z3,
      z4, z5;
  // the odd part: y7, y5, y3, y1 in tmp0..tmp3 -> tmp0..tmp3
  auto odd = [&]() {
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * f1_175;
    tmp0 = tmp0 * f0_298;
    tmp1 = tmp1 * f2_053;
    tmp2 = tmp2 * f3_072;
    tmp3 = tmp3 * f1_501;
    z1 = z1 * -f0_899;
    z2 = z2 * -f2_562;
    z3 = z3 * -f1_961;
    z4 = z4 * -f0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
  };
  // pass 1: columns, scaled up by 2 ** PASS1_BITS
  for (int c = 0; c < 8; ++c) {
    const int16_t* x = in + c;
    const uint16_t* qc = q + c;
    int* w = ws + c;
    if (!x[8] && !x[16] && !x[24] && !x[32] && !x[40] && !x[48] && !x[56]) {
      const int dcval = (x[0] * qc[0]) * (1 << kPass1);  // AC terms all 0
      for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
      continue;
    }
    z2 = x[16] * qc[16];
    z3 = x[48] * qc[48];
    z1 = (z2 + z3) * f0_541;
    tmp2 = z1 + z3 * -f1_847;
    tmp3 = z1 + z2 * f0_765;
    z2 = x[0] * qc[0];
    z3 = x[32] * qc[32];
    tmp0 = (z2 + z3) * (int64_t{1} << kConst);
    tmp1 = (z2 - z3) * (int64_t{1} << kConst);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = x[56] * qc[56];
    tmp1 = x[40] * qc[40];
    tmp2 = x[24] * qc[24];
    tmp3 = x[8] * qc[8];
    odd();
    const int n = kConst - kPass1;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  // pass 2: rows, descaled by 8 and 2 ** PASS1_BITS, level-shifted and
  // clamped by the range table
  uint8_t px[8];
  for (int r = 0; r < rows; ++r) {
    const int* w = ws + 8 * r;
    const int n = kConst + kPass1 + 3;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      std::memset(px, range.t[descale(w[0], kPass1 + 3) & 1023], 8);
    } else {
      z2 = w[2];
      z3 = w[6];
      z1 = (z2 + z3) * f0_541;
      tmp2 = z1 + z3 * -f1_847;
      tmp3 = z1 + z2 * f0_765;
      tmp0 = (int64_t{w[0]} + w[4]) * (int64_t{1} << kConst);
      tmp1 = (int64_t{w[0]} - w[4]) * (int64_t{1} << kConst);
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      odd();
      px[0] = range.t[descale(tmp10 + tmp3, n) & 1023];
      px[7] = range.t[descale(tmp10 - tmp3, n) & 1023];
      px[1] = range.t[descale(tmp11 + tmp2, n) & 1023];
      px[6] = range.t[descale(tmp11 - tmp2, n) & 1023];
      px[2] = range.t[descale(tmp12 + tmp1, n) & 1023];
      px[5] = range.t[descale(tmp12 - tmp1, n) & 1023];
      px[3] = range.t[descale(tmp13 + tmp0, n) & 1023];
      px[4] = range.t[descale(tmp13 - tmp0, n) & 1023];
    }
    std::memcpy(out + r * stride, px, cols);
  }
}

// a segment's body by marker code, before the first SOS (nullptr if none)
const uint8_t* find_segment(const uint8_t* d, long n, int marker,
                            long* blen) {
  long i = 2;
  while (i + 3 < n) {
    if (d[i] != 0xFF || d[i + 1] == 0xFF) {
      ++i;
      continue;
    }
    const int m = d[i + 1];
    i += 2;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xDA || m == 0xD9) return nullptr;
    const long len = (static_cast<long>(d[i]) << 8) | d[i + 1];
    if (len < 2 || i + len > n) return nullptr;
    if (m == marker) {
      *blen = len - 2;
      return d + i + 2;
    }
    i += len;
  }
  return nullptr;
}

}  // namespace

int jpeg_check(const uint8_t* d, long n) {
  return walk(d, n, nullptr, nullptr);
}

bool jpeg_sequential(const uint8_t* d, long n) {
  long len = 0;
  const uint8_t* sof = nullptr;
  int kind = -1;
  for (int m : {0xC0, 0xC1}) {
    if ((sof = find_segment(d, n, m, &len))) {
      kind = m;
      break;
    }
  }
  // any other SOFn before the first scan makes the stream another kind
  for (int m = 0xC2; m <= 0xCF && kind >= 0; ++m) {
    long l2;
    if (m != 0xC4 && m != 0xC8 && m != 0xCC && find_segment(d, n, m, &l2))
      return false;
  }
  if (kind < 0 || len < 6 || sof[0] != 8) return false;
  const int h = (sof[1] << 8) | sof[2], w = (sof[3] << 8) | sof[4];
  const int nc = sof[5];
  if (h == 0 || w == 0 || len != 6 + 3 * nc) return false;
  if (nc == 1) return true;
  if (nc != 3) return false;
  // libjpeg's colour space guess (jdapimin.c): RGB without a JFIF marker
  // where an Adobe marker says transform 0 or the ids are 'R', 'G', 'B'
  long al = 0;
  const uint8_t* adobe = find_segment(d, n, 0xEE, &al);
  long jl = 0;
  const uint8_t* jfif = find_segment(d, n, 0xE0, &jl);
  const bool is_jfif = jfif && jl >= 5 && std::memcmp(jfif, "JFIF\0", 5) == 0;
  const bool is_adobe = adobe && al >= 12 && std::memcmp(adobe, "Adobe", 5) == 0;
  if (!is_jfif) {
    if (is_adobe ? adobe[11] == 0
                 : (sof[6] == 'R' && sof[9] == 'G' && sof[12] == 'B'))
      return false;
  }
  // luma at the largest factors, both chroma planes alike, each factor
  // 1 or 2 times the chroma's (the upsamplings of ycc_to_rgb)
  const int hy = sof[7] >> 4, vy = sof[7] & 15;
  const int hc = sof[10] >> 4, vc = sof[10] & 15;
  if (sof[13] != sof[10] || hc < 1 || vc < 1 || hy < hc || vy < vc)
    return false;
  return (hy == hc || hy == 2 * hc) && (vy == vc || vy == 2 * vc);
}

int jpeg_decode_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                           int w) {
  if (!jpeg_sequential(d, n)) {
    set_error("JPEG: not a sequential Huffman stream of 8 bits, gray or "
              "YCbCr with chroma factors 1 or 2");
    return kUnsupported;
  }
  Coefs co;
  Frame f;
  const int st = walk(d, n, &co, &f);
  if (st) return st;
  if (f.height != h || f.width != w) {
    set_error("JPEG size differs from the size asked for");
    return kSizeMismatch;
  }
  // each component's plane, libjpeg's downsampled size
  std::vector<uint8_t> planes[3];
  int ph[3], pw[3];
  for (int c = 0; c < f.ncomp; ++c) {
    if (!co.scanned[c]) return damaged("a component no scan holds");
    ph[c] = static_cast<int>((static_cast<long>(h) * f.vs[c] + f.vmax - 1) /
                             f.vmax);
    pw[c] = static_cast<int>((static_cast<long>(w) * f.hs[c] + f.hmax - 1) /
                             f.hmax);
    planes[c].resize(static_cast<size_t>(ph[c]) * pw[c]);
    const int16_t* blocks = co.blocks[c].data();
    for (int by = 0; by * 8 < ph[c]; ++by)
      for (int bx = 0; bx * 8 < pw[c]; ++bx)
        idct_islow(blocks + (static_cast<long>(by) * co.bw[c] + bx) * 64,
                   co.qt[c],
                   planes[c].data() + static_cast<long>(by) * 8 * pw[c] +
                       bx * 8,
                   pw[c], std::min(8, ph[c] - by * 8),
                   std::min(8, pw[c] - bx * 8));
  }
  if (f.ncomp == 1) {
    const uint8_t* y = planes[0].data();
    for (long i = 0; i < static_cast<long>(h) * w; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return kOk;
  }
  ycc_to_rgb(planes[0].data(), planes[1].data(), planes[2].data(), h, w,
             ph[1], pw[1], f.hs[0] / f.hs[1], f.vs[0] / f.vs[1], out);
  return kOk;
}

// ------------------------------------------------------------------ PNG
// 8-bit gray, gray + alpha, RGB, RGBA and palette images, non-interlaced:
// data/image_io.decode_png, with zlib's inflate and the row filters here.

namespace {

const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool is_png(const uint8_t* d, long n) {
  return n >= 8 && std::memcmp(d, kPngSig, 8) == 0;
}

bool is_jpeg(const uint8_t* d, long n) {
  return n >= 3 && d[0] == 0xFF && d[1] == 0xD8 && d[2] == 0xFF;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int png_channels(int ctype) {
  switch (ctype) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

struct PngHeader {
  uint32_t w = 0, h = 0;
  int depth = 0, ctype = 0, interlace = 0;
};

std::string chunk_name(const uint8_t* t) {
  return std::string(reinterpret_cast<const char*>(t), 4);
}

// Walks the chunks (CRC checked), stopping after IHDR when header_only.
int png_chunks(const uint8_t* d, long n, bool header_only, PngHeader* hdr,
               std::vector<uint8_t>* idat, std::vector<uint8_t>* plte) {
  long pos = 8;
  bool have_header = false;
  while (pos < n) {
    if (pos + 12 > n) {
      set_error("PNG stream ends inside a chunk");
      return kCorrupt;
    }
    const uint32_t len = be32(d + pos);
    const uint8_t* type = d + pos + 4;
    const uint8_t* body = d + pos + 8;
    if (static_cast<long>(len) > n - pos - 12) {
      set_error("PNG chunk '" + chunk_name(type) +
                "' runs past the end of the stream");
      return kCorrupt;
    }
    uLong crc = crc32(0L, type, 4);
    crc = crc32(crc, body, len);
    if (crc != be32(body + len)) {
      set_error("PNG chunk '" + chunk_name(type) + "': bad CRC");
      return kCorrupt;
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13) {
        set_error("PNG IHDR of " + std::to_string(len) + " bytes");
        return kCorrupt;
      }
      hdr->w = be32(body);
      hdr->h = be32(body + 4);
      hdr->depth = body[8];
      hdr->ctype = body[9];
      hdr->interlace = body[12];
      have_header = true;
      if (header_only) break;
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      plte->assign(body, body + len);
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), body, body + len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + static_cast<long>(len);
  }
  if (!have_header) {
    set_error("PNG without IHDR");
    return kCorrupt;
  }
  if (hdr->depth != 8 || !png_channels(hdr->ctype) || hdr->interlace) {
    set_error("unsupported PNG: bit depth " + std::to_string(hdr->depth) +
              ", colour type " + std::to_string(hdr->ctype) + ", interlace " +
              std::to_string(hdr->interlace) +
              " (8-bit, non-interlaced only)");
    return kUnsupported;
  }
  if (hdr->w == 0 || hdr->h == 0 || hdr->w > 0x7fffffffu ||
      hdr->h > 0x7fffffffu) {
    set_error("PNG of " + std::to_string(hdr->h) + "x" +
              std::to_string(hdr->w) + " pixels");
    return kCorrupt;
  }
  return kOk;
}

int png_info(const uint8_t* d, long n, int* h, int* w) {
  PngHeader hdr;
  std::vector<uint8_t> idat, plte;
  const int st = png_chunks(d, n, true, &hdr, &idat, &plte);
  if (st) return st;
  *h = static_cast<int>(hdr.h);
  *w = static_cast<int>(hdr.w);
  return kOk;
}

}  // namespace

}  // namespace sdt

extern "C" {

using namespace sdt;

const char* sdt_last_error() { return t_error.c_str(); }

const char* sdt_jpeg_backend() { return jpeg_backend(); }

// Undo the per-row filters of a non-interlaced PNG (all five: None, Sub,
// Up, Average, Paeth). raw: h rows of 1 filter byte + row_bytes bytes.
// Returns 0, or y + 1 for a row y whose filter type is unknown.
int sdt_png_unfilter(const uint8_t* raw, int h, long row_bytes, int bpp,
                     uint8_t* out) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw + static_cast<long>(y) * (row_bytes + 1);
    const int ftype = src[0];
    const uint8_t* line = src + 1;
    uint8_t* cur = out + static_cast<long>(y) * row_bytes;
    const uint8_t* prev = y ? cur - row_bytes : nullptr;
    const long first = bpp < row_bytes ? bpp : row_bytes;
    switch (ftype) {
      case 0:
        std::memcpy(cur, line, row_bytes);
        break;
      case 1:  // Sub
        std::memcpy(cur, line, first);
        for (long x = bpp; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + cur[x - bpp]);
        break;
      case 2:  // Up
        for (long x = 0; x < row_bytes; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (prev ? prev[x] : 0));
        break;
      case 3:  // Average
        for (long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long x = 0; x < row_bytes; ++x) {
          const int a = x >= bpp ? cur[x - bpp] : 0;
          const int b = prev ? prev[x] : 0;
          const int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = static_cast<uint8_t>(line[x] + pred);
        }
        break;
      default:
        set_error("PNG row " + std::to_string(y) + ": unknown filter type " +
                  std::to_string(ftype));
        return y + 1;
    }
  }
  return 0;
}

int sdt_png_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  PngHeader hdr;
  std::vector<uint8_t> idat, plte;
  int st = png_chunks(d, n, false, &hdr, &idat, &plte);
  if (st) return st;
  if (static_cast<int>(hdr.h) != h || static_cast<int>(hdr.w) != w) {
    set_error("PNG size differs from the size asked for");
    return kSizeMismatch;
  }
  const int ch = png_channels(hdr.ctype);
  const long row_bytes = static_cast<long>(w) * ch;
  const size_t expected = static_cast<size_t>(h) * (row_bytes + 1);
  // one byte more than expected: a stream that inflates to more is caught
  std::vector<uint8_t> raw(expected + 1);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    set_error("zlib inflateInit failed");
    return kCorrupt;
  }
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  const int zrc = inflate(&zs, Z_FINISH);
  const size_t got = zs.total_out;
  inflateEnd(&zs);
  if (zrc != Z_STREAM_END || got != expected) {
    set_error("PNG data holds " + std::to_string(got) +
              (zrc == Z_STREAM_END ? "" : " or more (damaged or truncated)") +
              " bytes, expected " + std::to_string(expected));
    return kCorrupt;
  }
  const long npx = static_cast<long>(h) * w;
  if (ch == 3)  // RGB rows are the output
    return sdt_png_unfilter(raw.data(), h, row_bytes, ch, out) ? kCorrupt
                                                               : kOk;
  std::vector<uint8_t> px(static_cast<size_t>(h) * row_bytes);
  if (sdt_png_unfilter(raw.data(), h, row_bytes, ch, px.data()))
    return kCorrupt;
  if (hdr.ctype == 3) {
    if (plte.empty()) {
      set_error("palette PNG without PLTE");
      return kCorrupt;
    }
    const long entries = static_cast<long>(plte.size()) / 3;
    for (long i = 0; i < npx; ++i) {
      if (px[i] >= entries) {
        set_error("PNG palette index " + std::to_string(px[i]) +
                  " outside its " + std::to_string(entries) + " entries");
        return kCorrupt;
      }
      std::memcpy(out + 3 * i, plte.data() + 3 * px[i], 3);
    }
  } else if (ch <= 2) {  // gray (+ alpha): repeated over three channels
    for (long i = 0; i < npx; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = px[i * ch];
  } else {  // RGBA: alpha dropped
    for (long i = 0; i < npx; ++i) {
      out[3 * i] = px[4 * i];
      out[3 * i + 1] = px[4 * i + 1];
      out[3 * i + 2] = px[4 * i + 2];
    }
  }
  return kOk;
}

// (h, w) of a JPEG or PNG stream, by its signature.
int sdt_image_info(const uint8_t* d, long n, int* h, int* w) {
  if (is_png(d, n)) return png_info(d, n, h, w);
  if (is_jpeg(d, n)) return jpeg_info(d, n, h, w);
  set_error("neither a JPEG nor a PNG stream");
  return kUnknownFormat;
}

// Decode a JPEG or PNG stream of (h, w) pixels into out (h, w, 3) RGB.
int sdt_decode(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  if (is_png(d, n)) return sdt_png_decode(d, n, out, h, w);
  if (is_jpeg(d, n)) {
    // the back end's route for this kind of stream, chosen before any
    // decode: the sequential decoder checks as it decodes
    if (jpeg_sequential_on_host() && jpeg_sequential(d, n))
      return jpeg_decode_sequential(d, n, out, h, w);
    const int st = jpeg_check(d, n);
    return st ? st : jpeg_decode(d, n, out, h, w);
  }
  set_error("neither a JPEG nor a PNG stream");
  return kUnknownFormat;
}

int sdt_encode_jpeg(const uint8_t* rgb, int h, int w, uint8_t** out,
                    long* size) {
  return jpeg_encode(rgb, h, w, out, size);
}

void sdt_free(void* p) { std::free(p); }

// sdt::rgb_to_ycc420 for the tests
void sdt_rgb_to_ycc420(const uint8_t* rgb, int h, int w, uint8_t* y,
                       uint8_t* cb, uint8_t* cr) {
  rgb_to_ycc420(rgb, h, w, y, cb, cr);
}

// 0 for a whole JPEG stream, else kCorrupt (the fault in sdt_last_error)
int sdt_jpeg_check(const uint8_t* d, long n) { return jpeg_check(d, n); }

// 1 for a stream the sequential decoder takes (sdt::jpeg_sequential)
int sdt_jpeg_sequential(const uint8_t* d, long n) {
  return jpeg_sequential(d, n) ? 1 : 0;
}

// 1 where sdt_decode sends those streams to the sequential decoder
int sdt_jpeg_sequential_on_host() { return jpeg_sequential_on_host(); }

// the back end's own decode of any JPEG stream, after the check (the
// route sdt_decode takes for the streams jpeg_sequential refuses)
int sdt_decode_jpeg_backend(const uint8_t* d, long n, uint8_t* out, int h,
                            int w) {
  const int st = jpeg_check(d, n);
  return st ? st : jpeg_decode(d, n, out, h, w);
}

// sdt::jpeg_decode_sequential on either route, for the tests
int sdt_decode_jpeg_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                               int w) {
  return jpeg_decode_sequential(d, n, out, h, w);
}

// sdt::ycc_to_rgb for the tests: planes y (h, w), cb and cr (ch, cw)
void sdt_ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                    int h, int w, int ch, int cw, int hs, int vs,
                    uint8_t* out) {
  ycc_to_rgb(y, cb, cr, h, w, ch, cw, hs, vs, out);
}

// ------------------------------------------------------------ resize
// Bilinear, half-pixel centres, the formula of semi_detr_tpu/native/
// dataloader.cpp (sdt_resize_bilinear), for any channel count. Each source
// row's horizontal pass (top and bottom there) is computed once and kept
// while consecutive output rows read it: the same floats, fewer passes.
void sdt_resize_bilinear(const uint8_t* src, int sh, int sw, int c,
                         uint8_t* dst, int dh, int dw) {
  const float fy = static_cast<float>(sh) / dh;
  const float fx = static_cast<float>(sw) / dw;
  const long n = static_cast<long>(dw) * c;
  std::vector<int> xa(n), xb(n);
  std::vector<float> wr(n), wl(n);  // wx and 1 - wx of each output value
  for (int x = 0; x < dw; ++x) {
    float sxf = (x + 0.5f) * fx - 0.5f;
    if (sxf < 0) sxf = 0;
    int x0 = static_cast<int>(sxf);
    if (x0 > sw - 1) x0 = sw - 1;
    const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    const float wx = sxf - x0;
    for (int k = 0; k < c; ++k) {
      xa[x * c + k] = x0 * c + k;
      xb[x * c + k] = x1 * c + k;
      wr[x * c + k] = wx;
      wl[x * c + k] = 1 - wx;
    }
  }
  // the horizontal passes of the two source rows last used
  std::vector<float> rows[2] = {std::vector<float>(n), std::vector<float>(n)};
  int held[2] = {-1, -1};
  auto pass = [&](int r) -> const float* {
    if (held[0] == r) return rows[0].data();
    if (held[1] == r) return rows[1].data();
    // replace the older row: rows come in order and y1 is y0 or y0 + 1,
    // so the older one is never the y0 that a y1 is fetched beside
    const int slot = held[0] < held[1] ? 0 : 1;
    const uint8_t* s_row = src + static_cast<long>(r) * sw * c;
    float* h = rows[slot].data();
    for (long i = 0; i < n; ++i)
      h[i] = s_row[xa[i]] * wl[i] + s_row[xb[i]] * wr[i];
    held[slot] = r;
    return h;
  };
  for (int y = 0; y < dh; ++y) {
    float syf = (y + 0.5f) * fy - 0.5f;
    if (syf < 0) syf = 0;
    int y0 = static_cast<int>(syf);
    if (y0 > sh - 1) y0 = sh - 1;
    const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    const float wy = syf - y0;
    const float* top = pass(y0);
    const float* bot = pass(y1);
    uint8_t* drow = dst + static_cast<long>(y) * n;
    const float wt = 1 - wy;
    for (long i = 0; i < n; ++i)
      drow[i] = static_cast<uint8_t>(top[i] * wt + bot[i] * wy + 0.5f);
  }
}

}  // extern "C"

// -------------------------------------------------------------- warp

namespace sdt {
namespace {

// floor(v), exact: a float of magnitude 2**23 or more is an integer
inline float floor_exact(float v) {
  if (!(std::fabs(v) < 8388608.0f)) return v;
  const float t = static_cast<float>(static_cast<int>(v));
  return t > v ? t - 1.0f : t;
}

// np.rint (half to even) of |v| < 2**22: adding and removing 1.5 * 2**23
// leaves the float grid at integers, and IEEE round-to-nearest-even puts
// v on the nearest one (without -ffast-math the compiler keeps both adds)
inline float rint_small(float v) {
  const float magic = 12582912.0f;
  const float t = v + magic;
  return t - magic;
}

}  // namespace
}  // namespace sdt

extern "C" {

// data/augment.warp_affine: destination pixel (x, y) samples the source at
// m @ (x, y, 1) (m: the destination -> source map, float32), taps outside
// the image read `fill`.
void sdt_warp_affine(const uint8_t* src, int h, int w, int c, const float* m,
                     int fill, uint8_t* dst) {
  const float fillf = static_cast<float>(fill);
  const float wf = static_cast<float>(w), hf = static_cast<float>(h);
  const long stride = static_cast<long>(w) * c;
  auto clip_tap = [](float t, float hi) {
    return static_cast<int>(t < -1.0f ? -1.0f : (t > hi ? hi : t));
  };
  // taps and fill lie in [0, 255], and so does the interpolation
  auto lerp2 = [](float v00, float v01, float v10, float v11, float fx,
                  float fy) {
    const float top = v00 + fx * (v01 - v00);
    const float bot = v10 + fx * (v11 - v10);
    const float out = rint_small(top + fy * (bot - top));
    return static_cast<uint8_t>(out < 0.0f ? 0.0f
                                           : (out > 255.0f ? 255.0f : out));
  };
  for (int y = 0; y < h; ++y) {
    const float yf = static_cast<float>(y);
    const float bx = m[1] * yf + m[2];
    const float by = m[4] * yf + m[5];
    uint8_t* drow = dst + static_cast<long>(y) * stride;
    for (int x = 0; x < w; ++x) {
      const float xf = static_cast<float>(x);
      const float sx = m[0] * xf + bx;
      const float sy = m[3] * xf + by;
      const float x0 = floor_exact(sx), y0 = floor_exact(sy);
      const float fx = sx - x0, fy = sy - y0;
      uint8_t* o = drow + static_cast<long>(x) * c;
      if (x0 >= 0.0f && x0 < wf - 1.0f && y0 >= 0.0f && y0 < hf - 1.0f) {
        // all four taps inside the image
        const uint8_t* p = src + static_cast<long>(y0) * stride +
                           static_cast<long>(x0) * c;
        const uint8_t* q = p + stride;
        for (int k = 0; k < c; ++k)
          o[k] = lerp2(p[k], p[k + c], q[k], q[k + c], fx, fy);
        continue;
      }
      const int xi[2] = {clip_tap(x0, wf), clip_tap(x0 + 1.0f, wf)};
      const int yi[2] = {clip_tap(y0, hf), clip_tap(y0 + 1.0f, hf)};
      const uint8_t* tap[2][2];
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b)
          tap[a][b] = (yi[a] < 0 || yi[a] >= h || xi[b] < 0 || xi[b] >= w)
                          ? nullptr
                          : src + yi[a] * stride +
                                static_cast<long>(xi[b]) * c;
      for (int k = 0; k < c; ++k) {
        float v[2][2];
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b)
            v[a][b] = tap[a][b] ? static_cast<float>(tap[a][b][k]) : fillf;
        o[k] = lerp2(v[0][0], v[0][1], v[1][0], v[1][1], fx, fy);
      }
    }
  }
}


// ------------------------------------------------------------ colour
// The pixel loops of data/augment.apply_color_op (Pillow's algorithms).

// per-channel histograms: hist[k * 256 + v] counts value v of channel k
void sdt_histogram(const uint8_t* img, long n, int c, int64_t* hist) {
  std::memset(hist, 0, sizeof(int64_t) * 256 * c);
  for (long i = 0; i < n; ++i)
    for (int k = 0; k < c; ++k) ++hist[k * 256 + img[i * c + k]];
}

// out = lut[k][img] per channel k (lut: c tables of 256 entries)
void sdt_apply_lut(const uint8_t* img, long n, int c, const uint8_t* lut,
                   uint8_t* out) {
  for (long i = 0; i < n; ++i)
    for (int k = 0; k < c; ++k) out[i * c + k] = lut[k * 256 + img[i * c + k]];
}

// RGB -> L: ITU-R 601-2 luma in 16-bit fixed point, rounded
void sdt_gray(const uint8_t* img, long n, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint32_t v = img[3 * i] * 19595u + img[3 * i + 1] * 38470u +
                       img[3 * i + 2] * 7471u + 0x8000u;
    out[i] = static_cast<uint8_t>(v >> 16);
  }
}

// Image.blend(degenerate, img, alpha): d + alpha * (img - d) in single
// precision, clipped to [0, 255] and truncated. The degenerate value of
// pixel i, channel k is deg[i * deg_px + k * deg_ch] (strides 0 broadcast).
void sdt_blend(const uint8_t* deg, long deg_px, long deg_ch,
               const uint8_t* img, long n, int c, float alpha, uint8_t* out) {
  auto one = [alpha](int d, int v) {
    float r = static_cast<float>(d) + alpha * static_cast<float>(v - d);
    r = r < 0.0f ? 0.0f : (r > 255.0f ? 255.0f : r);
    return static_cast<uint8_t>(r);
  };
  const long count = n * c;
  if (deg_px == c && deg_ch == 1) {  // a full image
    for (long i = 0; i < count; ++i) out[i] = one(deg[i], img[i]);
  } else if (deg_px == 0 && deg_ch == 0) {  // one value
    const int d = deg[0];
    for (long i = 0; i < count; ++i) out[i] = one(d, img[i]);
  } else {
    for (long i = 0; i < n; ++i)
      for (int k = 0; k < c; ++k)
        out[i * c + k] = one(deg[i * deg_px + k * deg_ch], img[i * c + k]);
  }
}

// ImageFilter.SMOOTH (1 1 1 / 1 5 1 / 1 1 1, / 13): float32 sums in
// Filter.c's order, + 0.5, clipped and truncated; border pixels kept.
void sdt_smooth(const uint8_t* img, int h, int w, int c, uint8_t* out) {
  std::memcpy(out, img, static_cast<size_t>(h) * w * c);
  if (h < 3 || w < 3) return;
  const float k1 = 1.0f / 13.0f, k5 = 5.0f / 13.0f;
  const long stride = static_cast<long>(w) * c;
  // within a row, the values of the interior pixels are one run of bytes:
  // value i has its left and right neighbours at i - c and i + c
  const long first = c, last = stride - c;
  for (int y = 1; y < h - 1; ++y) {
    const uint8_t* up = img + (y - 1) * stride;
    const uint8_t* mid = up + stride;
    const uint8_t* dn = mid + stride;
    uint8_t* o = out + y * stride;
    for (long i = first; i < last; ++i) {
      float ss = 0.5f + ((static_cast<float>(dn[i - c]) * k1 +
                          static_cast<float>(dn[i]) * k1) +
                         static_cast<float>(dn[i + c]) * k1);
      ss = ss + ((static_cast<float>(mid[i - c]) * k1 +
                  static_cast<float>(mid[i]) * k5) +
                 static_cast<float>(mid[i + c]) * k1);
      ss = ss + ((static_cast<float>(up[i - c]) * k1 +
                  static_cast<float>(up[i]) * k1) +
                 static_cast<float>(up[i + c]) * k1);
      ss = ss < 0.0f ? 0.0f : (ss > 255.0f ? 255.0f : ss);
      o[i] = static_cast<uint8_t>(ss);
    }
  }
}

// values below thr kept, the others inverted
void sdt_solarize(const uint8_t* img, long count, int thr, uint8_t* out) {
  for (long i = 0; i < count; ++i)
    out[i] = img[i] < thr ? img[i] : static_cast<uint8_t>(255 - img[i]);
}

void sdt_posterize(const uint8_t* img, long count, int mask, uint8_t* out) {
  const uint8_t m = static_cast<uint8_t>(mask);
  for (long i = 0; i < count; ++i) out[i] = img[i] & m;
}

}  // extern "C"

// ---------------------------------------------------- prefetch loader
// Read, decode and resize in a pool of threads, results in completion order
// (semi_detr_tpu/native/dataloader.cpp's Loader).

namespace sdt {
namespace {

struct Task {
  long index;
  std::string path;
  int target_h, target_w;  // 0: keep the decoded size
};

struct Result {
  long index = -1;
  std::vector<uint8_t> pixels;
  int h = 0, w = 0, src_h = 0, src_w = 0;
  int status = kOk;
  std::string message;
};

int read_file(const std::string& path, std::vector<uint8_t>* buf) {
  std::FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    set_error("cannot open the file");
    return kOpen;
  }
  int st = kOk;
  if (std::fseek(f, 0, SEEK_END) != 0) st = kRead;
  const long size = st ? -1 : std::ftell(f);
  if (size < 0 || std::fseek(f, 0, SEEK_SET) != 0) st = kRead;
  if (!st) {
    buf->resize(size);
    if (std::fread(buf->data(), 1, size, f) != static_cast<size_t>(size))
      st = kRead;
  }
  std::fclose(f);
  if (st) set_error("cannot read the file to its end");
  return st;
}

struct Loader {
  std::vector<std::thread> workers;
  std::deque<Task> tasks;
  std::deque<Result> results;
  Result current;  // the result sdt_loader_next handed out last
  std::mutex mu;
  std::condition_variable cv_task, cv_result;
  bool stop = false;
  long max_pixels;

  Loader(int n_threads, long max_px) : max_pixels(max_px) {
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { run(); });
  }

  void load(const Task& t, std::vector<uint8_t>* raw,
            std::vector<uint8_t>* decoded, Result* r) {
    r->status = read_file(t.path, raw);
    if (r->status) return;
    const uint8_t* d = raw->data();
    const long n = static_cast<long>(raw->size());
    r->status = sdt_image_info(d, n, &r->src_h, &r->src_w);
    if (r->status) return;
    if (static_cast<long>(r->src_h) * r->src_w > max_pixels) {
      set_error("image of " + std::to_string(r->src_h) + "x" +
                std::to_string(r->src_w) + " pixels, more than allowed");
      r->status = kTooLarge;
      return;
    }
    decoded->resize(static_cast<size_t>(r->src_h) * r->src_w * 3);
    r->status = sdt_decode(d, n, decoded->data(), r->src_h, r->src_w);
    if (r->status) return;
    r->h = t.target_h > 0 ? t.target_h : r->src_h;
    r->w = t.target_w > 0 ? t.target_w : r->src_w;
    if (r->h == r->src_h && r->w == r->src_w) {
      r->pixels.swap(*decoded);
    } else {
      r->pixels.resize(static_cast<size_t>(r->h) * r->w * 3);
      sdt_resize_bilinear(decoded->data(), r->src_h, r->src_w, 3,
                          r->pixels.data(), r->h, r->w);
    }
  }

  void run() {
    std::vector<uint8_t> raw, decoded;
    while (true) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_task.wait(lk, [this] { return stop || !tasks.empty(); });
        if (stop) break;
        t = std::move(tasks.front());
        tasks.pop_front();
      }
      Result r;
      r.index = t.index;
      load(t, &raw, &decoded, &r);
      if (r.status) r.message = t_error;
      {
        std::lock_guard<std::mutex> lk(mu);
        results.push_back(std::move(r));
      }
      cv_result.notify_one();
    }
  }
};

}  // namespace
}  // namespace sdt

extern "C" {

void* sdt_loader_create(int n_threads, long max_pixels) {
  return new Loader(n_threads, max_pixels);
}

void sdt_loader_submit(void* loader, long index, const char* path,
                       int target_h, int target_w) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->tasks.push_back(Task{index, path, target_h, target_w});
  }
  l->cv_task.notify_one();
}

// Blocks for the next finished task (the caller knows one is outstanding)
// and keeps it as the current result: its index, size, source size and
// status; on failure the message (at most cap - 1 bytes) in msg.
int sdt_loader_next(void* loader, long* index, int* h, int* w, int* src_h,
                    int* src_w, char* msg, int cap) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_result.wait(lk, [l] { return !l->results.empty(); });
    l->current = std::move(l->results.front());
    l->results.pop_front();
  }
  const Result& r = l->current;
  *index = r.index;
  *h = r.h;
  *w = r.w;
  *src_h = r.src_h;
  *src_w = r.src_w;
  std::snprintf(msg, cap, "%s", r.message.c_str());
  return r.status;
}

// Copies the current result's pixels (h * w * 3 bytes) and releases them.
void sdt_loader_copy(void* loader, uint8_t* out) {
  Loader* l = static_cast<Loader*>(loader);
  std::memcpy(out, l->current.pixels.data(), l->current.pixels.size());
  std::vector<uint8_t>().swap(l->current.pixels);
}

// Drops the tasks not yet started, waits for the running ones and frees
// the loader.
void sdt_loader_destroy(void* loader) {
  Loader* l = static_cast<Loader*>(loader);
  {
    std::lock_guard<std::mutex> lk(l->mu);
    l->stop = true;
    l->tasks.clear();
  }
  l->cv_task.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
