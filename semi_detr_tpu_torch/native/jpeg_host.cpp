// The host library's own JPEG decoders: libjpeg-turbo 2.1's default decode
// (output JCS_RGB, JDCT_ISLOW, fancy upsampling, block smoothing on) to
// the bit, for every stream of 8 bits that libjpeg decodes that way, and
// the check that runs before the back end's decode (host.h).
//
// Entropy decoding fills one buffer of quantized coefficients per
// component (natural order, the MCU grid's blocks):
// * sequential Huffman (SOF0, SOF1) as jdhuff.c reads it;
// * progressive Huffman (SOF2) as jdphuff.c reads it: DC first and
//   refinement scans, AC first scans with end-of-band runs, AC refinement
//   scans with correction bits, into buffers that live across the scans;
// * arithmetic, sequential (SOF9) and progressive (SOF10), as jdarith.c
//   reads it: the QM coder of jaricom.c's table, the DC and AC statistics
//   bins with the DAC conditioning (defaults L 0, U 1, Kx 5), the four
//   progressive scan types, the statistics reset at each restart.
// The back half is shared: block smoothing where a progressive script
// leaves the DC or AC 1-9 short of its last bit (jdcoefct.c,
// decompress_smooth_data, libjpeg-turbo 2.1's ten saved coefficients; for
// CMYK and YCCK, which reach cv2, 3.1's neighbourhood, found by probing
// cv2.imread against 2.1 on cut streams of every vertical sampling),
// dequantization by the table each component latched at its first scan,
// jidctint.c's jpeg_idct_islow, each component's upsampling as jdsample.c
// chooses it against the frame's largest factors, and the colour
// conversion of libjpeg's colour space guess (jdapimin.c): gray, YCbCr
// (jdcolor.c's fixed-point tables), RGB (none), and CMYK or YCCK (YCCK ->
// CMYK as jdcolor.c converts it) turned to RGB as cv2.imread turns them
// (OpenCV's icvCvt_CMYK2BGR_8u_C4C3R on Adobe's inverted CMYK, then the
// EXIF orientation): libjpeg cannot give RGB for these, and the JAX
// package's loader falls back to cv2 for them.
//
// Lossless streams (SOF3), which the JAX loader's libjpeg-turbo 2.1
// refuses and hands to cv2 (libjpeg-turbo 3.1, which converts no colour in
// lossless mode), decode as cv2.imread gives them where it gives them at
// all: 2-8 bits, three components libjpeg's guess calls RGB or four CMYK
// ones (cv2's CMYK conversion), the samples shifted back by the point
// transform, then the EXIF orientation. jpeg_refusal names what cv2
// refuses too: another lossless stream, and every DCT frame of 12 bits.
//
// Wherever libjpeg warns of damaged data (a code no table holds, a bad
// arithmetic code, data that ends early, a restart marker out of order, a
// bogus progression) the decode fails with the fault; it never returns a
// filled-in image. Bytes between markers that no scan reads pass, as
// libjpeg passes them with a warning.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "host.h"

namespace sdt {

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
  int max_symbol = 0;  // a DC table's largest category: 16 only lossless
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // (length << 8) | symbol of each code of at most kLook bits, by prefix;
  // 0: a longer code, or none
  uint16_t look[1 << kLook];
};

// libjpeg's jpeg_make_d_derived_tbl: canonical codes from the counts of
// each length; false for a table that does not fit its lengths or (DC) a
// category above 16 (a DCT scan refuses 16 where it uses the table)
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
  t->max_symbol = 0;
  for (int q = 0; q < nvals; ++q) {
    if (dc && vals[q] > 16) return false;
    t->max_symbol = std::max<int>(t->max_symbol, vals[q]);
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
  bool seen = false, huffman_sequential = false, progressive = false,
       arithmetic = false;
  bool decodable = false;  // 8 bits, a size, SOF0, 1, 2, 9 or 10
  int frames = 0;          // SOFn markers after the first (libjpeg: error)
  int precision = 8, width = 0, height = 0, hmax = 1, vmax = 1, ncomp = 0;
  int id[4], hs[4], vs[4], tq[4];
  // a progressive frame's script so far: the successive approximation bit
  // each component's coefficient has reached (-1: no scan yet), as
  // libjpeg's coef_bits
  int8_t coef_bits[4][64];
  bool bogus = false;  // a scan out of order (libjpeg warns)
  // lossless (SOF3): the first scan's predictor (its Ss), 0 before it
  bool lossless = false;
  int predictor = 0;
  int sof = 0;  // the first SOFn marker
  // the markers of libjpeg's colour space guess (before the first scan)
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
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
  // a lossless frame's samples (height x width) and point transform
  std::vector<uint16_t> samples[4];
  int point[4] = {0, 0, 0, 0};
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


// libjpeg's latch_quant_tables: each component of the scan keeps the DQT
// table its frame names as it stands at the component's first scan
int latch_tables(const Frame& f, const int* comp, int ns, Coefs* co) {
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
  return kOk;
}

// the scan's MCU grid (*mcus MCUs, *mcu_w to a row) and the blocks of each
// component in an MCU, as jdinput.c's per_scan_setup lays them out
int mcu_layout(const Frame& f, const int* comp, int ns, long* mcus,
               long* mcu_w, int* blocks) {
  if (ns == 1) {  // one component: its own block grid
    const int i = comp[0];
    *mcu_w = (static_cast<long>(f.width) * f.hs[i] + 8L * f.hmax - 1) /
             (8L * f.hmax);
    const long bh = (static_cast<long>(f.height) * f.vs[i] + 8L * f.vmax -
                     1) / (8L * f.vmax);
    *mcus = *mcu_w * bh;
    blocks[0] = 1;
    return kOk;
  }
  *mcu_w = (f.width + 8L * f.hmax - 1) / (8L * f.hmax);
  *mcus = *mcu_w * ((f.height + 8L * f.vmax - 1) / (8L * f.vmax));
  int total = 0;
  for (int j = 0; j < ns; ++j) {
    blocks[j] = f.hs[comp[j]] * f.vs[comp[j]];
    total += blocks[j];
  }
  if (total > 10)  // D_MAX_BLOCKS_IN_MCU: an error in libjpeg
    return damaged("an MCU of more than 10 blocks");
  return kOk;
}

// The progressive scan parameters as jdphuff.c / jdarith.c check them
// (errors), and the frame's script updated (jpeg's coef_bits; a scan out
// of order makes it bogus, which libjpeg warns of).
int progression(Frame* f, const int* comp, int ns, int ss, int se, int ah,
                int al) {
  if ((ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1)) ||
      (ah != 0 && al != ah - 1) || al > 13)
    return damaged("bad progressive scan parameters");
  for (int j = 0; j < ns; ++j) {
    int8_t* bits = f->coef_bits[comp[j]];
    if (ss != 0 && bits[0] < 0) f->bogus = true;
    for (int k = ss; k <= se; ++k) {
      if (ah != (bits[k] < 0 ? 0 : bits[k])) f->bogus = true;
      bits[k] = static_cast<int8_t>(al);
    }
  }
  return kOk;
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
    if (dc[tables >> 4].max_symbol > 15) return damaged("bad Huffman table");
  }
  if (co) {
    const int st = latch_tables(f, comp, ns, co);
    if (st) return st;
  }
  long mcus, mcu_w;
  int blocks[4];
  const int st = mcu_layout(f, comp, ns, &mcus, &mcu_w, blocks);
  if (st) return st;
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

// The progressive scan whose header (SOS body sos, len bytes) ends at
// data, as jdphuff.c reads it. The scan's parameters are checked and the
// frame's script updated (*f) in either mode; with co the entropy-coded
// data is decoded into co's blocks and *end is the position of the marker
// after it, without co the caller skips the data.
int read_progressive_scan(const uint8_t* d, long n, const uint8_t* sos,
                          long len, long data, Frame* f,
                          const HuffTable* dc, const HuffTable* ac,
                          int restart, Coefs* co, long* end) {
  const int ns = len >= 1 ? sos[0] : 0;
  if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
    return damaged("bad scan header");
  const int ss = sos[1 + 2 * ns], se = sos[2 + 2 * ns];
  const int ah = sos[3 + 2 * ns] >> 4, al = sos[3 + 2 * ns] & 15;
  const bool dc_band = ss == 0;
  int comp[4];
  for (int j = 0; j < ns; ++j) {
    const int cid = sos[1 + 2 * j], tables = sos[2 + 2 * j];
    comp[j] = -1;
    for (int i = 0; i < f->ncomp; ++i)
      if (f->id[i] == cid) comp[j] = i;
    if (comp[j] < 0) return damaged("scan of an unknown component");
    // a DC refinement needs no table
    const bool need = dc_band ? ah == 0 : true;
    const int t = dc_band ? tables >> 4 : tables & 15;
    if (need && (t > 3 || !(dc_band ? dc : ac)[t].defined))
      return damaged("scan of an unknown Huffman table");
    if (need && dc_band && dc[t].max_symbol > 15)
      return damaged("bad Huffman table");
  }
  int st = progression(f, comp, ns, ss, se, ah, al);
  if (st || !co) return st;
  if (f->bogus) return damaged("bogus progression (a scan out of order)");
  st = latch_tables(*f, comp, ns, co);
  if (st) return st;
  long mcus, mcu_w;
  int blocks[4];
  st = mcu_layout(*f, comp, ns, &mcus, &mcu_w, blocks);
  if (st) return st;
  const int p1 = 1 << al;           // 1 in the bit being coded
  const int m1 = -(1 << al);        // -1 in the bit being coded
  Bits b(d, n, data);
  int last_dc[4] = {0, 0, 0, 0};
  long eobrun = 0;
  int expect = 0;
  for (long m = 0; m < mcus; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      if (b.overrun()) return ran_out(b);
      if (b.next_marker() != 0xD0 + expect)
        return damaged("restart marker missing or out of order");
      b.pos += 2;
      expect = (expect + 1) & 7;
      last_dc[0] = last_dc[1] = last_dc[2] = last_dc[3] = 0;
      eobrun = 0;
    }
    const long my = m / mcu_w, mx = m % mcu_w;
    for (int j = 0; j < ns; ++j) {
      const int c = comp[j], t = sos[2 + 2 * j];
      for (int k = 0; k < blocks[j]; ++k) {
        const long by = ns == 1 ? my : my * f->vs[c] + k / f->hs[c];
        const long bx = ns == 1 ? mx : mx * f->hs[c] + k % f->hs[c];
        int16_t* blk = co->blocks[c].data() + (by * co->bw[c] + bx) * 64;
        if (dc_band && ah == 0) {  // decode_mcu_DC_first
          const int s = decode(&b, dc[t >> 4]);
          if (s < 0) return damaged("bad Huffman code");
          const int diff = s ? extend(b.get(s), s) : 0;
          last_dc[j] = static_cast<int>(static_cast<unsigned>(diff) +
                                        static_cast<unsigned>(last_dc[j]));
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[j])
                                        << al);
        } else if (dc_band) {  // decode_mcu_DC_refine
          if (b.get(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        } else if (ah == 0) {  // decode_mcu_AC_first
          if (eobrun > 0) {
            --eobrun;
            continue;
          }
          for (int q = ss; q <= se; ++q) {
            const int rs = decode(&b, ac[t & 15]);
            if (rs < 0) return damaged("bad Huffman code");
            const int r = rs >> 4, s = rs & 15;
            if (s) {
              q += r;
              const int v = extend(b.get(s), s);
              blk[kNatural[q]] = static_cast<int16_t>(
                  static_cast<unsigned>(v) << al);
            } else if (r == 15) {
              q += 15;
            } else {
              eobrun = 1L << r;
              if (r) eobrun += b.get(r);
              --eobrun;
              break;
            }
          }
        } else {  // decode_mcu_AC_refine
          int q = ss;
          // a correction bit for an already nonzero coefficient: 1 adds
          // the bit to its magnitude, once
          auto correct = [&](int16_t* coef) {
            if (b.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
          };
          if (eobrun == 0) {
            for (; q <= se; ++q) {
              const int rs = decode(&b, ac[t & 15]);
              if (rs < 0) return damaged("bad Huffman code");
              int r = rs >> 4, s = rs & 15;
              if (s) {
                if (s != 1) return damaged("bad Huffman code");
                s = b.get(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = 1L << r;
                if (r) eobrun += b.get(r);
                break;
              }
              // past the nonzero coefficients (each gets its correction
              // bit) and r zero ones, to the new coefficient's place
              do {
                int16_t* coef = blk + kNatural[q];
                if (*coef != 0) {
                  correct(coef);
                } else if (--r < 0) {
                  break;
                }
                ++q;
              } while (q <= se);
              if (s) blk[kNatural[q]] = static_cast<int16_t>(s);
            }
          }
          if (eobrun > 0) {
            for (; q <= se; ++q) {
              int16_t* coef = blk + kNatural[q];
              if (*coef != 0) correct(coef);
            }
            --eobrun;
          }
        }
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

// ---------------------------------------------------- arithmetic decoding
// jaricom.c's jpeg_aritab (ITU-T T.81 Table D.2, entry 113 the fixed
// probability bin): Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 |
// Next_Index_LPS
const uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder state and arith_decode. Past a marker the data reads
// as zeros (legal in arithmetic coding, and no warning); past the stream's
// end too, where libjpeg's memory source warns and inserts an EOI.
struct Arith {
  const uint8_t* d;
  long n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;        // -16: two bytes to read into C first
  int marker = 0;      // the marker code the data ran into, 0 none yet
  long marker_pos = 0;  // the position of its 0xFF
  bool past_end = false;

  Arith(const uint8_t* data, long size, long start)
      : d(data), n(size), pos(start) {}

  void restart() {
    c = a = 0;
    ct = -16;
    marker = 0;
  }
  int next_byte() {
    if (marker) return 0;
    if (pos >= n) {
      past_end = true;
      marker = 0xD9;
      marker_pos = n;
      return 0;
    }
    int data = d[pos++];
    if (data != 0xFF) return data;
    do {
      if (pos >= n) {
        past_end = true;
        marker = 0xD9;
        marker_pos = n;
        return 0;
      }
      data = d[pos++];
    } while (data == 0xFF);
    if (data == 0) return 0xFF;  // a stuffed zero
    marker = data;
    marker_pos = pos - 2;
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and input, T.81 D.2.6
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two bytes in: A becomes 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional LPS exchange
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {  // conditional MPS exchange
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // the marker after the data read: the one the data ran into, else the
  // next one (skipping bytes no decode read); -1 at the stream's end
  int next_marker(long* at) {
    if (marker) {
      *at = marker_pos;
      return marker;
    }
    for (long p = pos; p + 1 < n; ++p) {
      if (d[p] == 0xFF && d[p + 1] != 0x00 && d[p + 1] != 0xFF) {
        *at = p;
        return d[p + 1];
      }
    }
    return -1;
  }
};

// the DAC conditioning of each of the 16 arithmetic tables (jdmarker.c's
// defaults: L 0, U 1, Kx 5)
struct ArithConds {
  int dc_l[16], dc_u[16], ac_k[16];
  ArithConds() {
    for (int t = 0; t < 16; ++t) {
      dc_l[t] = 0;
      dc_u[t] = 1;
      ac_k[t] = 5;
    }
  }
};

// An arithmetic-coded scan (SOF9 or SOF10 frame) whose header (SOS body
// sos, len bytes) ends at data, as jdarith.c decodes it; the scan's
// parameters are checked and a progressive frame's script updated in
// either mode. With co the data is decoded into co's blocks and *end is
// the position of the marker after it; without co the caller skips the
// data.
int read_arith_scan(const uint8_t* d, long n, const uint8_t* sos, long len,
                    long data, Frame* f, const ArithConds& cond, int restart,
                    Coefs* co, long* end) {
  const int ns = len >= 1 ? sos[0] : 0;
  if (ns < 1 || ns > 4 || len != 4 + 2 * ns)
    return damaged("bad scan header");
  const int ss = sos[1 + 2 * ns], se = sos[2 + 2 * ns];
  const int ah = sos[3 + 2 * ns] >> 4, al = sos[3 + 2 * ns] & 15;
  int comp[4], td[4], ta[4];
  for (int j = 0; j < ns; ++j) {
    comp[j] = -1;
    for (int i = 0; i < f->ncomp; ++i)
      if (f->id[i] == sos[1 + 2 * j]) comp[j] = i;
    if (comp[j] < 0) return damaged("scan of an unknown component");
    td[j] = sos[2 + 2 * j] >> 4;
    ta[j] = sos[2 + 2 * j] & 15;
  }
  const bool prog = f->progressive;
  // the statistics a scan uses: DC bins for a sequential or DC first
  // scan, AC bins for a sequential or AC scan
  const bool use_dc = !prog || (ss == 0 && ah == 0), use_ac = !prog || ss;
  if (prog) {
    const int st = progression(f, comp, ns, ss, se, ah, al);
    if (st) return st;
  } else if (ss != 0 || ah != 0 || al != 0 || se != 63) {
    return damaged("a sequential scan with progressive parameters");
  }
  if (!co) return kOk;
  if (f->bogus) return damaged("bogus progression (a scan out of order)");
  int st = latch_tables(*f, comp, ns, co);
  if (st) return st;
  long mcus, mcu_w;
  int blocks[4];
  st = mcu_layout(*f, comp, ns, &mcus, &mcu_w, blocks);
  if (st) return st;
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed = 113;  // the fixed probability bin
  int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
  auto reset = [&]() {
    for (int j = 0; j < ns; ++j) {
      if (use_dc) {
        std::memset(dc_stats[td[j]], 0, 64);
        last_dc[j] = dc_ctx[j] = 0;
      }
      if (use_ac) std::memset(ac_stats[ta[j]], 0, 256);
    }
  };
  reset();
  Arith ar(d, n, data);
  // T.81 F.19-F.24: a DC difference of component j; false for a bad code
  auto dc_diff = [&](int j, int* out) {
    const int tbl = td[j];
    uint8_t* s = dc_stats[tbl] + dc_ctx[j];
    if (ar.decode(s) == 0) {
      dc_ctx[j] = 0;
      *out = 0;
      return true;
    }
    const int sign = ar.decode(s + 1);
    s += 2 + sign;
    int m = ar.decode(s);
    if (m) {
      s = dc_stats[tbl] + 20;
      while (ar.decode(s)) {
        if ((m <<= 1) == 0x8000) return false;
        s += 1;
      }
    }
    if (m < ((1 << cond.dc_l[tbl]) >> 1))
      dc_ctx[j] = 0;
    else if (m > ((1 << cond.dc_u[tbl]) >> 1))
      dc_ctx[j] = 12 + sign * 4;
    else
      dc_ctx[j] = 4 + sign * 4;
    int v = m;
    s += 14;
    while (m >>= 1)
      if (ar.decode(s)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  };
  // T.81 F.21-F.24: the value of a nonzero AC coefficient k of table tbl,
  // s at its bins; false for a bad code
  auto ac_value = [&](int tbl, int k, uint8_t* s, int* out) {
    const int sign = ar.decode(&fixed);
    s += 2;
    int m = ar.decode(s);
    if (m && ar.decode(s)) {
      m <<= 1;
      s = ac_stats[tbl] + (k <= cond.ac_k[tbl] ? 189 : 217);
      while (ar.decode(s)) {
        if ((m <<= 1) == 0x8000) return false;
        s += 1;
      }
    }
    int v = m;
    s += 14;
    while (m >>= 1)
      if (ar.decode(s)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  };
  // a bad code in the zeros read past the stream's end: libjpeg warned
  // of the end first
  auto bad_code = [&]() {
    return damaged(ar.past_end ? "Premature end of JPEG file"
                               : "bad arithmetic code");
  };
  const int p1 = 1 << al, m1 = -(1 << al);
  int expect = 0;
  for (long m = 0; m < mcus; ++m) {
    if (restart > 0 && m > 0 && m % restart == 0) {
      long at;
      if (ar.next_marker(&at) != 0xD0 + expect)
        return damaged("restart marker missing or out of order");
      ar.pos = at + 2;
      ar.restart();
      expect = (expect + 1) & 7;
      reset();
    }
    const long my = m / mcu_w, mx = m % mcu_w;
    for (int j = 0; j < ns; ++j) {
      const int c = comp[j];
      for (int k = 0; k < blocks[j]; ++k) {
        const long by = ns == 1 ? my : my * f->vs[c] + k / f->hs[c];
        const long bx = ns == 1 ? mx : mx * f->hs[c] + k % f->hs[c];
        int16_t* blk = co->blocks[c].data() + (by * co->bw[c] + bx) * 64;
        if (!prog || (ss == 0 && ah == 0)) {  // a DC value
          int v;
          if (!dc_diff(j, &v)) return bad_code();
          last_dc[j] = static_cast<int>(static_cast<unsigned>(last_dc[j]) +
                                        static_cast<unsigned>(v));
          blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[j])
                                        << (prog ? al : 0));
        } else if (ss == 0) {  // DC refinement: the next bit
          if (ar.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        }
        if (!prog || (ss > 0 && ah == 0)) {  // AC values, to the EOB
          const int tbl = ta[j];
          const int first = prog ? ss : 1, last = prog ? se : 63;
          for (int q = first; q <= last; ++q) {
            uint8_t* s = ac_stats[tbl] + 3 * (q - 1);
            if (ar.decode(s)) break;  // EOB
            while (ar.decode(s + 1) == 0) {
              s += 3;
              if (++q > last) return bad_code();
            }
            int v;
            if (!ac_value(tbl, q, s, &v))
              return bad_code();
            blk[kNatural[q]] = static_cast<int16_t>(
                static_cast<unsigned>(v) << (prog ? al : 0));
          }
        } else if (ss > 0) {  // AC refinement
          const int tbl = ta[j];
          int kex = se;  // the previous stage's end of block
          for (; kex > 0; --kex)
            if (blk[kNatural[kex]]) break;
          for (int q = ss; q <= se; ++q) {
            uint8_t* s = ac_stats[tbl] + 3 * (q - 1);
            if (q > kex && ar.decode(s)) break;  // EOB
            for (;;) {
              int16_t* coef = blk + kNatural[q];
              if (*coef) {  // a correction bit
                if (ar.decode(s + 2))
                  *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
                break;
              }
              if (ar.decode(s + 1)) {  // newly nonzero
                *coef = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
                break;
              }
              s += 3;
              if (++q > se) return bad_code();
            }
          }
        }
      }
    }
  }
  if (ar.past_end) return damaged("Premature end of JPEG file");
  if (ar.next_marker(end) < 0)
    return damaged("Premature end of JPEG file (no EOI)");
  return kOk;
}


// A lossless scan (SOF3) whose header ends at data, as libjpeg-turbo 3's
// jdlhuff.c and jddiffct.c read it: per MCU one difference per component
// (DC-style Huffman categories 0-16, 16 meaning 32768), undone by the
// scan's predictor (Ss, 1-7) on the point-transformed samples modulo 2^16;
// the first row of the image (and of each restart interval, which must
// hold whole rows) predicts from the left, its first sample from
// 2^(P - Pt - 1), and the first column from above.
int read_lossless_scan(const uint8_t* d, long n, const uint8_t* sos, long len,
                       long data, Frame* f, const HuffTable* dc, int restart,
                       Coefs* co, long* end) {
  const int ns = len >= 1 ? sos[0] : 0;
  if (ns < 1 || ns > 4 || len != 4 + 2 * ns) return damaged("bad scan header");
  const int pred = sos[1 + 2 * ns], al = sos[3 + 2 * ns] & 15;
  if (pred < 1 || pred > 7 || sos[2 + 2 * ns] != 0 || (sos[3 + 2 * ns] >> 4))
    return damaged("bad lossless scan parameters");
  if (al >= f->precision) return damaged("a point transform past the precision");
  int comp[4];
  for (int j = 0; j < ns; ++j) {
    const int cid = sos[1 + 2 * j], t = sos[2 + 2 * j] >> 4;
    comp[j] = -1;
    for (int i = 0; i < f->ncomp; ++i)
      if (f->id[i] == cid) comp[j] = i;
    if (comp[j] < 0 || t > 3 || !dc[t].defined)
      return damaged("scan of an unknown component or Huffman table");
  }
  if (f->predictor == 0) f->predictor = pred;
  if (!co) return kOk;
  const long W = f->width, H = f->height;
  if (restart > 0 && restart % W) {
    set_error("JPEG: a lossless restart interval of part of a row");
    return kUnsupported;
  }
  Bits b(d, n, data);
  const int rows_per_restart = restart > 0 ? static_cast<int>(restart / W) : 0;
  int expect = 0;
  long first_row = 0;
  for (int j = 0; j < ns; ++j) {
    co->scanned[comp[j]] = true;
    co->point[comp[j]] = al;
  }
  for (long y = 0; y < H; ++y) {
    if (rows_per_restart && y > 0 && y % rows_per_restart == 0) {
      if (b.overrun()) return ran_out(b);
      if (b.next_marker() != 0xD0 + expect)
        return damaged("restart marker missing or out of order");
      b.pos += 2;
      expect = (expect + 1) & 7;
      first_row = y;
    }
    for (long x = 0; x < W; ++x) {
      for (int j = 0; j < ns; ++j) {
        const int c = comp[j];
        uint16_t* row = co->samples[c].data() + y * W;
        const int s = decode(&b, dc[sos[2 + 2 * j] >> 4]);
        if (s < 0 || s > 16) return damaged("bad Huffman code");
        int diff = s == 16 ? 32768 : s ? extend(b.get(s), s) : 0;
        int p;
        if (y == first_row) {
          p = x == 0 ? 1 << (f->precision - al - 1) : row[x - 1];
        } else if (x == 0) {
          p = row[x - W];
        } else {
          const int ra = row[x - 1], rb = row[x - W], rc = row[x - W - 1];
          switch (pred) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1;
          }
        }
        row[x] = static_cast<uint16_t>((p + diff) & 0xFFFF);
      }
      if (b.overrun()) return ran_out(b);
    }
  }
  if (b.next_marker() < 0) return damaged("Premature end of JPEG file (no EOI)");
  *end = b.pos;
  return kOk;
}

// The stream walked from SOI to EOI, or to its first scan header where
// header_only; with co (a frame the host decoders take: 8 bits, SOF0, 1,
// 2, 9 or 10) the coefficients kept. Reports the frame, a progressive
// frame's scan script and the markers of the colour space guess to *fo.
int walk(const uint8_t* d, long n, Coefs* co, Frame* fo,
         bool header_only = false) {
  Frame f;
  HuffTable dc[4], ac[4];
  ArithConds cond;
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
    if (m == 0xDA && header_only) {
      if (!f.seen) return damaged("scan before the frame header");
      if (f.lossless && blen >= 1 && blen == 4 + 2 * body[0])
        f.predictor = body[1 + 2 * body[0]];
      if (fo) *fo = f;
      return kOk;
    }
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
    } else if (m == 0xCC) {  // DAC: DC tables 0-15, AC tables 16-31
      if (blen % 2) return damaged("bad arithmetic conditioning");
      for (long q = 0; q < blen; q += 2) {
        const int t = body[q], v = body[q + 1];
        if (t > 31 || (t < 16 && (v & 15) > (v >> 4)))
          return damaged("bad arithmetic conditioning");
        if (t >= 16) {
          cond.ac_k[t - 16] = v;
        } else {
          cond.dc_l[t] = v & 15;
          cond.dc_u[t] = v >> 4;
        }
      }
    } else if (m == 0xE0 && !scanned) {  // jdmarker.c's examine_app0
      if (blen >= 14 && std::memcmp(body, "JFIF\0", 5) == 0) f.jfif = true;
    } else if (m == 0xEE && !scanned) {  // examine_app14
      if (blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
        f.adobe = true;
        f.adobe_transform = body[11];
      }
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {  // SOFn
      const int nc = blen >= 6 ? body[5] : 0;
      if (nc < 1 || nc > 4 || blen != 6 + 3 * nc)
        return damaged("bad frame header");
      if (f.seen) f.frames += 1;
      if (!f.seen) f.sof = m;
      f.seen = true;
      f.precision = body[0];
      f.height = (body[1] << 8) | body[2];
      f.width = (body[3] << 8) | body[4];
      f.ncomp = nc;
      f.hmax = f.vmax = 1;
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
      const bool sized = f.height > 0 && f.width > 0;
      f.huffman_sequential = (m == 0xC0 || m == 0xC1) && sized;
      f.progressive = (m == 0xC2 || m == 0xCA) && sized;
      f.arithmetic = (m == 0xC9 || m == 0xCA) && sized;
      f.lossless = m == 0xC3 && sized;
      f.decodable = (f.huffman_sequential || f.progressive || f.arithmetic) &&
                    f.precision == 8;
      std::memset(f.coef_bits, -1, sizeof(f.coef_bits));
      if (co) {
        if (f.lossless && !f.frames && f.precision >= 2 && f.precision <= 16) {
          for (int c = 0; c < nc; ++c)
            co->samples[c].assign(static_cast<size_t>(f.height) * f.width, 0);
        } else if (!f.decodable || f.frames) {
          set_error("JPEG: not a sequential or progressive frame of 8 bits "
                    "(Huffman or arithmetic)");
          return kUnsupported;
        } else {
          size_coefs(f, co);
        }
      }
    } else if (m == 0xDA) {  // SOS and its entropy-coded data
      if (!f.seen) return damaged("scan before the frame header");
      scanned = true;
      int st = kOk;
      if (f.lossless) {
        st = read_lossless_scan(d, n, body, blen, i, &f, dc, restart, co, &i);
        if (!st && co) continue;
      } else if (f.arithmetic) {
        st = read_arith_scan(d, n, body, blen, i, &f, cond, restart, co, &i);
      } else if (f.huffman_sequential) {
        st = read_scan(d, n, body, blen, i, f, dc, ac, restart, co, &i);
        if (!st) continue;
      } else if (f.progressive) {
        st = read_progressive_scan(d, n, body, blen, i, &f, dc, ac, restart,
                                   co, &i);
      }
      if (st) return st;
      if (co) continue;
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

// ------------------------------------------------------ block smoothing
// jdcoefct.c (libjpeg-turbo 2.1, and 3.1's rows and columns for the
// streams cv2 decodes for the JAX loader): smoothing_ok and
// decompress_smooth_data.
// The first nine AC coefficients of a block still short of their last
// bit, where zero, are estimated from the DC values of the block and its
// 24 neighbours, and where no AC data came at all the DC itself; the
// neighbourhood's rows follow libjpeg's iMCU-row buffer, edges repeated.

constexpr int kSaved = 10;  // SAVED_COEFS: the DC and AC 1-9
// natural positions of AC 1-9 in zig-zag order
const int kSmoothPos[kSaved] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

// smoothing_ok: whether libjpeg smooths this frame's blocks; the final
// coef_bits decide (a non-buffered decode reads to EOI first)
bool smoothing_ok(const Coefs& co, const Frame& f) {
  if (!f.progressive) return false;
  bool useful = false;
  for (int c = 0; c < f.ncomp; ++c) {
    if (!co.scanned[c]) return false;  // no table latched
    for (int k = 0; k < kSaved; ++k)
      if (co.qt[c][kSmoothPos[k]] == 0) return false;
    if (f.coef_bits[c][0] < 0) return false;
    for (int k = 1; k < kSaved; ++k)
      if (f.coef_bits[c][k] != 0) useful = true;
  }
  return useful;
}

// one estimate: Q00 * num rounded to a multiple of q, clamped below 2^al
// where al > 0 (the coefficient's bits still to come)
inline int16_t estimate(int64_t q00, int64_t q, int64_t dcs, int al) {
  const int64_t num = q00 * dcs;
  int pred;
  if (num >= 0) {
    pred = static_cast<int>(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = static_cast<int>(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return static_cast<int16_t>(pred);
}

// component c's plane (ph x pw samples) from its blocks: smoothed where
// smooth, dequantized and through jpeg_idct_islow. rows_31 takes the 5 x 5
// neighbourhood as libjpeg-turbo 3.1 (cv2 5.0's) does for the streams the
// JAX loader hands to cv2: the rows two away where 2.1 repeats a nearer
// one under vertical subsampling, and columns clamped to the row (2.1
// repeats the first column on a row of two blocks).
void component_plane(const Coefs& co, const Frame& f, int c, bool smooth,
                     bool rows_31, uint8_t* plane, int ph, int pw) {
  const int16_t* blocks = co.blocks[c].data();
  const uint16_t* qt = co.qt[c];
  const int wib = (pw + 7) / 8, hib = (ph + 7) / 8;
  const long bw = co.bw[c];
  if (!smooth) {
    for (int by = 0; by < hib; ++by)
      for (int bx = 0; bx < wib; ++bx)
        idct_islow(blocks + (by * bw + bx) * 64, qt,
                   plane + static_cast<long>(by) * 8 * pw + bx * 8, pw,
                   std::min(8, ph - by * 8), std::min(8, pw - bx * 8));
    return;
  }
  const int8_t* bits = f.coef_bits[c];
  const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                         bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                         bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
  const int64_t q00 = qt[0], q01 = qt[1], q10 = qt[8], q20 = qt[16],
                q11 = qt[9], q02 = qt[2], q03 = qt[3], q12 = qt[10],
                q21 = qt[17], q30 = qt[24];
  const int v = f.vs[c];
  const int rows_total = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
  const int last_row = rows_total - 1;  // of iMCU rows
  int16_t ws[64];
  for (int r = 0; r < hib; ++r) {
    const int imcu = r / v, br = r % v;
    const int block_rows = imcu < last_row ? v : hib - last_row * v;
    const int prev = (br > 0 || imcu > 0) ? r - 1 : r;
    int pprev = (br > 1 || imcu > 1) ? r - 2 : prev;
    const int next = (br < block_rows - 1 || imcu < last_row) ? r + 1 : r;
    int nnext = (br < block_rows - 2 || imcu + 1 < last_row) ? r + 2 : next;
    if (rows_31) {
      // libjpeg-turbo 3.1: the rows two away wherever the component's
      // buffer holds them (a dummy row of the last iMCU row below too),
      // but a short last iMCU row keeps 2.1's row above
      if (imcu < last_row || block_rows == v) pprev = r >= 2 ? r - 2 : prev;
      nnext = r + 2 < (hib + v - 1) / v * v ? r + 2 : next;
    }
    const int16_t* rp[5] = {blocks + pprev * bw * 64, blocks + prev * bw * 64,
                            blocks + r * bw * 64, blocks + next * bw * 64,
                            blocks + nnext * bw * 64};
    // DC[row][col]: the 5 x 5 neighbourhood, columns as a sliding window
    int dcv[5][5];
    for (int y = 0; y < 5; ++y)
      for (int x = 0; x < 5; ++x) dcv[y][x] = rp[y][0];
    const int last_col = wib - 1;
    for (int b = 0; b < wib; ++b) {
      std::memcpy(ws, rp[2] + b * 64, sizeof(ws));
      if (rows_31) {  // the columns two away clamped to the row's blocks
        for (int y = 0; y < 5; ++y)
          for (int x = 0; x < 5; ++x)
            dcv[y][x] = rp[y][std::min(std::max(b + x - 2, 0), last_col) * 64];
      } else {
        if (b == 0 && b < last_col)
          for (int y = 0; y < 5; ++y) dcv[y][3] = rp[y][64];
        if (b + 1 < last_col)
          for (int y = 0; y < 5; ++y) dcv[y][4] = rp[y][(b + 2) * 64];
      }
      const int DC01 = dcv[0][0], DC02 = dcv[0][1], DC03 = dcv[0][2],
                DC04 = dcv[0][3], DC05 = dcv[0][4], DC06 = dcv[1][0],
                DC07 = dcv[1][1], DC08 = dcv[1][2], DC09 = dcv[1][3],
                DC10 = dcv[1][4], DC11 = dcv[2][0], DC12 = dcv[2][1],
                DC13 = dcv[2][2], DC14 = dcv[2][3], DC15 = dcv[2][4],
                DC16 = dcv[3][0], DC17 = dcv[3][1], DC18 = dcv[3][2],
                DC19 = dcv[3][3], DC20 = dcv[3][4], DC21 = dcv[4][0],
                DC22 = dcv[4][1], DC23 = dcv[4][2], DC24 = dcv[4][3],
                DC25 = dcv[4][4];
      int al;
      if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
        ws[1] = estimate(
            q00, q01,
            change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                         38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                      : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15),
            al);
      if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
        ws[8] = estimate(
            q00, q10,
            change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                         DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                         DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                         DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                      : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23),
            al);
      if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
        ws[16] = estimate(
            q00, q20,
            change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                         14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                         2 * DC19 + DC23)
                      : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23),
            al);
      if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
        ws[9] = estimate(
            q00, q11,
            change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                         9 * DC19 + DC21 - DC25)
                      : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                         DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09),
            al);
      if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
        ws[2] = estimate(
            q00, q02,
            change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                         2 * DC19)
                      : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15),
            al);
      if (change_dc) {
        if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
          ws[3] = estimate(q00, q03,
                           DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19,
                           al);
        if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
          ws[10] = estimate(q00, q12,
                            DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19,
                            al);
        if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
          ws[17] = estimate(q00, q21,
                            DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19,
                            al);
        if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
          ws[24] = estimate(q00, q30,
                            DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19,
                            al);
        // the DC: a Gaussian-like kernel, no clamp
        ws[0] = estimate(
            q00, q00,
            -2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 - 8 * DC15 -
                6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25,
            0);
      }
      idct_islow(ws, qt, plane + static_cast<long>(r) * 8 * pw + b * 8, pw,
                 std::min(8, ph - r * 8), std::min(8, pw - b * 8));
      for (int y = 0; y < 5; ++y)  // the window moves one column right
        for (int x = 0; x < 4; ++x) dcv[y][x] = dcv[y][x + 1];
    }
  }
}

// ----------------------------------------------------------- upsampling
// jdsample.c as jinit_upsampler chooses per component, against the
// frame's largest factors: full size; h2v1 fancy (plain replication where
// the plane is at most 2 samples wide); h1v2 fancy (libjpeg-turbo 2.0+);
// h2v2 fancy (plain where at most 2 wide); int_upsample replication for
// any other integer ratio. Fancy upsampling takes 3/4 of the nearer sample
// and 1/4 of the further one per dimension, with its rounding biases; the
// rows above the first and below the last repeat them (jdmainct.c).

// output row y (w values) of a plane of ph x pw samples, upsampled by
// (he, ve); dst holds at least pw * he values
void upsample_row(const uint8_t* plane, int ph, int pw, int he, int ve,
                  int y, int w, int* colsum, uint8_t* dst) {
  const int inrow = y / ve;
  const uint8_t* near = plane + static_cast<long>(inrow) * pw;
  const bool fancy_v = ve == 2 && (he == 1 || (he == 2 && pw > 2));
  const bool fancy_h = he == 2 && ve <= 2 && pw > 2;
  if (!fancy_v && !fancy_h) {  // replication (full size, plain, int)
    if (he == 1) {
      std::memcpy(dst, near, w);
    } else {
      for (int x = 0; x < w; ++x) dst[x] = near[x / he];
    }
    return;
  }
  if (fancy_v) {  // the further row: above for even rows, below for odd
    const int far_row = (y % 2 == 0) ? (inrow > 0 ? inrow - 1 : 0)
                                     : (inrow + 1 < ph ? inrow + 1 : ph - 1);
    const uint8_t* far = plane + static_cast<long>(far_row) * pw;
    for (int j = 0; j < pw; ++j) colsum[j] = near[j] * 3 + far[j];
    if (he == 1) {  // h1v2
      const int bias = (y % 2 == 0) ? 1 : 2;
      for (int x = 0; x < w; ++x) dst[x] = (colsum[x] + bias) >> 2;
      return;
    }
    // h2v2, into 2 * pw >= w values
    dst[0] = (colsum[0] * 4 + 8) >> 4;
    for (int j = 1; j < pw; ++j)
      dst[2 * j] = (colsum[j] * 3 + colsum[j - 1] + 8) >> 4;
    for (int j = 0; j < pw - 1; ++j)
      dst[2 * j + 1] = (colsum[j] * 3 + colsum[j + 1] + 7) >> 4;
    dst[2 * pw - 1] = (colsum[pw - 1] * 4 + 7) >> 4;
    return;
  }
  // h2v1, into 2 * pw >= w values
  dst[0] = near[0];
  for (int j = 1; j < pw; ++j)
    dst[2 * j] = (near[j] * 3 + near[j - 1] + 1) >> 2;
  for (int j = 0; j < pw - 1; ++j)
    dst[2 * j + 1] = (near[j] * 3 + near[j + 1] + 2) >> 2;
  dst[2 * pw - 1] = near[pw - 1];
}

// jdapimin.c's guess of the colour space, and what comes out of each
enum Colour { kGray, kYCbCr, kRGB, kCMYK, kYCCK, kNoColour,
              kRaw };  // kRaw: the components as they are, ncomp to a pixel
const char* const kColourNames[] = {"gray", "YCbCr", "RGB", "CMYK", "YCCK"};

int colour_of(const Frame& f) {
  if (f.ncomp == 1) return kGray;
  if (f.ncomp == 3) {
    if (f.jfif) return kYCbCr;
    if (f.adobe) return f.adobe_transform == 0 ? kRGB : kYCbCr;
    if (f.id[0] == 1 && f.id[1] == 2 && f.id[2] == 3) return kYCbCr;
    if (f.id[0] == 'R' && f.id[1] == 'G' && f.id[2] == 'B') return kRGB;
    return kYCbCr;
  }
  if (f.ncomp == 4) {
    if (f.adobe) return f.adobe_transform == 0 ? kCMYK : kYCCK;
    return kCMYK;
  }
  return kNoColour;
}

// cv2.imread's EXIF orientation of a stream it decodes itself (CMYK and
// YCCK here): tag 0x0112 of IFD0 in the first APP1 segment, read 6 bytes
// in as OpenCV's JpegDecoder reads it; 1 where there is none
int exif_orientation(const uint8_t* d, long n) {
  long i = 2;
  while (i + 3 < n) {
    if (d[i] != 0xFF || d[i + 1] == 0xFF) {
      ++i;
      continue;
    }
    const int m = d[i + 1];
    i += 2;
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (m == 0xDA || m == 0xD9) return 1;
    const long len = (static_cast<long>(d[i]) << 8) | d[i + 1];
    if (len < 2 || i + len > n) return 1;
    if (m == 0xE1) {
      const uint8_t* t = d + i + 2 + 6;  // the TIFF header
      const long tn = len - 2 - 6;
      if (tn < 8) return 1;
      const bool le = t[0] == 'I' && t[1] == 'I';
      if (!le && !(t[0] == 'M' && t[1] == 'M')) return 1;
      auto u16 = [&](long p) {
        return le ? t[p] | (t[p + 1] << 8) : (t[p] << 8) | t[p + 1];
      };
      auto u32 = [&](long p) {
        return le ? static_cast<long>(u16(p)) | (static_cast<long>(u16(p + 2))
                                                  << 16)
                  : (static_cast<long>(u16(p)) << 16) | u16(p + 2);
      };
      const long ifd = u32(4);
      if (ifd < 8 || ifd + 2 > tn) return 1;
      const int entries = u16(ifd);
      for (int e = 0; e < entries; ++e) {
        const long p = ifd + 2 + 12L * e;
        if (p + 12 > tn) return 1;
        if (u16(p) == 0x0112) {
          const int o = u16(p + 8);
          return o >= 1 && o <= 8 ? o : 1;
        }
      }
      return 1;
    }
    i += len;
  }
  return 1;
}

// the frame's components through libjpeg's back half into out (h, w, 3)
// RGB: smoothing, IDCT, upsampling, colour conversion (and for CMYK and
// YCCK cv2's conversion and orientation, orientation o). by_cv2: a stream
// the JAX loader hands to cv2 (CMYK, YCCK, a TIFF's JPEG strips), smoothed
// as cv2's libjpeg-turbo 3.1 smooths
int finish(const Coefs& co, const Frame& f, int o, uint8_t* out, int h,
           int w, int colour, bool by_cv2) {
  int oh, ow;
  oriented_size(colour >= kCMYK ? o : 1, f.height, f.width, &oh, &ow);
  if (oh != h || ow != w) {
    set_error("JPEG size differs from the size asked for");
    return kSizeMismatch;
  }
  const int oc = colour == kRaw ? f.ncomp : 3;  // output channels
  if (colour == kNoColour) {
    set_error("JPEG: a colour space libjpeg does not convert to RGB");
    return kUnsupported;
  }
  const int H = f.height, W = f.width;
  for (int c = 0; c < f.ncomp; ++c)
    if (!co.scanned[c]) return damaged("a component no scan holds");
  const bool smooth = smoothing_ok(co, f);
  std::vector<uint8_t> planes[4];
  int ph[4], pw[4];
  for (int c = 0; c < f.ncomp; ++c) {
    ph[c] = static_cast<int>((static_cast<long>(H) * f.vs[c] + f.vmax - 1) /
                             f.vmax);
    pw[c] = static_cast<int>((static_cast<long>(W) * f.hs[c] + f.hmax - 1) /
                             f.hmax);
    planes[c].resize(static_cast<size_t>(ph[c]) * pw[c]);
    component_plane(co, f, c, smooth, by_cv2, planes[c].data(), ph[c],
                    pw[c]);
  }
  // one output row of every component at a time
  std::vector<uint8_t> rows[4];
  int he[4], ve[4];
  for (int c = 0; c < f.ncomp; ++c) {
    he[c] = f.hmax / f.hs[c];
    ve[c] = f.vmax / f.vs[c];
    rows[c].resize(static_cast<size_t>(pw[c]) * he[c] + W);
  }
  std::vector<int> colsum(*std::max_element(pw, pw + f.ncomp));
  std::vector<uint8_t> rgb;
  uint8_t* dst = out;
  if (colour >= kCMYK && o != 1) {
    rgb.resize(static_cast<size_t>(H) * W * 3);
    dst = rgb.data();
  }
  const YccTables& t = ycc_tables();
  const uint8_t* p[4];
  for (int y = 0; y < H; ++y) {
    for (int c = 0; c < f.ncomp; ++c) {
      upsample_row(planes[c].data(), ph[c], pw[c], he[c], ve[c], y, W,
                   colsum.data(), rows[c].data());
      p[c] = rows[c].data();
    }
    uint8_t* px = dst + static_cast<long>(y) * W * oc;
    for (int x = 0; x < W; ++x, px += oc) {
      switch (colour) {
        case kRaw:
          for (int c = 0; c < oc; ++c) px[c] = p[c][x];
          break;
        case kGray:
          px[0] = px[1] = px[2] = p[0][x];
          break;
        case kRGB:
          px[0] = p[0][x];
          px[1] = p[1][x];
          px[2] = p[2][x];
          break;
        case kYCbCr: {
          const int yy = p[0][x], b = p[1][x], r = p[2][x];
          px[0] = clamp255(yy + t.cr_r[r]);
          px[1] = clamp255(yy + ((t.cb_g[b] + t.cr_g[r]) >> 16));
          px[2] = clamp255(yy + t.cb_b[b]);
          break;
        }
        default: {  // CMYK, YCCK
          int cmy[3];
          const int k = p[3][x];
          if (colour == kYCCK) {  // jdcolor.c's ycck_cmyk_convert
            const int yy = p[0][x], b = p[1][x], r = p[2][x];
            cmy[0] = clamp255(255 - (yy + t.cr_r[r]));
            cmy[1] = clamp255(255 - (yy + ((t.cb_g[b] + t.cr_g[r]) >> 16)));
            cmy[2] = clamp255(255 - (yy + t.cb_b[b]));
          } else {
            cmy[0] = p[0][x];
            cmy[1] = p[1][x];
            cmy[2] = p[2][x];
          }
          // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, in RGB order
          for (int q = 0; q < 3; ++q)
            px[q] = static_cast<uint8_t>(k - (((255 - cmy[q]) * k) >> 8));
        }
      }
    }
  }
  if (dst != out) orient(dst, H, W, o, out);
  return kOk;
}

// the header's test of the host decoders: one frame of 8 bits with a
// size, SOF0, 1, 2, 9 or 10, a colour space libjpeg gives RGB for (or
// CMYK / YCCK, which cv2 turns to RGB), integer sampling ratios
int host_kind(const Frame& f) {
  // lossless: what cv2 5.0 reads of it (libjpeg-turbo 3.1 converts no
  // colour in lossless mode): 3 components of at most 8 bits that
  // libjpeg's guess calls RGB, at full resolution
  if (f.seen && f.lossless && !f.frames && f.precision >= 2 &&
      f.precision <= 8 &&
      ((f.ncomp == 3 && colour_of(f) == kRGB) ||
       (f.ncomp == 4 && colour_of(f) == kCMYK)) &&
      f.predictor >= 1 && f.predictor <= 7 && f.hmax == 1 && f.vmax == 1)
    return kLossless;
  if (!f.seen || !f.decodable || f.frames || colour_of(f) == kNoColour)
    return kOther;
  for (int c = 0; c < f.ncomp; ++c)
    if (f.hmax % f.hs[c] || f.vmax % f.vs[c]) return kOther;
  if (f.arithmetic) return f.progressive ? kProgressiveArith
                                         : kSequentialArith;
  return f.progressive ? kProgressive : kSequential;
}

// the host decode of a stream of kind `want` (kOther: any the host
// decoders take; kSequentialArith: either arithmetic kind)
int decode_kind(const uint8_t* d, long n, int want, const char* what,
                uint8_t* out, int h, int w) {
  Frame f;
  const int kind = walk(d, n, nullptr, &f, true) ? kOther : host_kind(f);
  if (kind == kOther ||
      (want != kOther && kind != want &&
       !(want == kSequentialArith && kind == kProgressiveArith))) {
    set_error(std::string("JPEG: not a ") + what + " stream of 8 bits "
              "that libjpeg decodes (gray, YCbCr, RGB, CMYK or YCCK; "
              "integer sampling ratios)");
    return kUnsupported;
  }
  Coefs co;
  const int st = walk(d, n, &co, &f);
  if (st) return st;
  if (kind == kLossless) {
    // the samples shifted back by Pt: RGB, or CMYK turned to RGB as
    // cv2.imread turns it; then cv2's EXIF orientation (cv2 decodes every
    // lossless stream for the JAX loader)
    const int o = exif_orientation(d, n);
    int oh, ow;
    oriented_size(o, f.height, f.width, &oh, &ow);
    if (oh != h || ow != w) {
      set_error("JPEG size differs from the size asked for");
      return kSizeMismatch;
    }
    for (int c = 0; c < f.ncomp; ++c)
      if (!co.scanned[c]) return damaged("a component no scan holds");
    const long px = static_cast<long>(f.height) * f.width;
    std::vector<uint8_t> rgb(o == 1 ? 0 : px * 3);
    uint8_t* dst = o == 1 ? out : rgb.data();
    for (long i = 0; i < px; ++i) {
      int v[4];
      for (int c = 0; c < f.ncomp; ++c)
        v[c] = static_cast<uint8_t>(co.samples[c][i] << co.point[c]);
      for (int c = 0; c < 3; ++c)  // icvCvt_CMYK2BGR_8u_C4C3R for CMYK
        dst[3 * i + c] = static_cast<uint8_t>(
            f.ncomp == 3 ? v[c] : v[3] - (((255 - v[c]) * v[3]) >> 8));
    }
    if (o != 1) orient(rgb.data(), f.height, f.width, o, out);
    return kOk;
  }
  return finish(co, f, exif_orientation(d, n), out, h, w, colour_of(f),
                colour_of(f) >= kCMYK);
}

}  // namespace

// (h, w) of the decoded picture after the orientation o
void oriented_size(int o, int h, int w, int* oh, int* ow) {
  *oh = o >= 5 ? w : h;
  *ow = o >= 5 ? h : w;
}

// the RGB picture (h, w, 3) turned as OpenCV's ApplyExifOrientation turns
// it (flips, and for 5-8 a transpose first) into out
void orient(const uint8_t* img, int h, int w, int o, uint8_t* out) {
  int oh, ow;
  oriented_size(o, h, w, &oh, &ow);
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sy, sx;
      switch (o) {
        case 2: sy = y; sx = w - 1 - x; break;
        case 3: sy = h - 1 - y; sx = w - 1 - x; break;
        case 4: sy = h - 1 - y; sx = x; break;
        case 5: sy = x; sx = y; break;
        case 6: sy = h - 1 - x; sx = y; break;
        case 7: sy = h - 1 - x; sx = w - 1 - y; break;
        case 8: sy = x; sx = w - 1 - y; break;
        default: sy = y; sx = x; break;
      }
      std::memcpy(out + (static_cast<long>(y) * ow + x) * 3,
                  img + (static_cast<long>(sy) * w + sx) * 3, 3);
    }
}

int jpeg_check(const uint8_t* d, long n) {
  return walk(d, n, nullptr, nullptr);
}

int jpeg_host_kind(const uint8_t* d, long n) {
  Frame f;
  return walk(d, n, nullptr, &f, true) ? kOther : host_kind(f);
}

const char* jpeg_host_colour(const uint8_t* d, long n) {
  Frame f;
  if (walk(d, n, nullptr, &f, true) || host_kind(f) == kOther)
    return nullptr;
  return kColourNames[colour_of(f)];
}

int jpeg_host_info(const uint8_t* d, long n, int* h, int* w) {
  Frame f;
  if (walk(d, n, nullptr, &f, true) || host_kind(f) == kOther)
    return kUnsupported;
  oriented_size(colour_of(f) >= kCMYK || host_kind(f) == kLossless
                    ? exif_orientation(d, n) : 1,
                f.height, f.width, h, w);
  return kOk;
}

int jpeg_decode_sequential(const uint8_t* d, long n, uint8_t* out, int h,
                           int w) {
  return decode_kind(d, n, kSequential, "sequential Huffman", out, h, w);
}

int jpeg_decode_progressive(const uint8_t* d, long n, uint8_t* out, int h,
                            int w) {
  return decode_kind(d, n, kProgressive, "progressive Huffman", out, h, w);
}

int jpeg_decode_arithmetic(const uint8_t* d, long n, uint8_t* out, int h,
                           int w) {
  return decode_kind(d, n, kSequentialArith, "arithmetic-coded", out, h, w);
}

const char* jpeg_refusal(const uint8_t* d, long n) {
  thread_local std::string msg;
  Frame f;
  if (walk(d, n, nullptr, &f, true) || !f.seen || host_kind(f) != kOther)
    return nullptr;
  char sof[8];
  std::snprintf(sof, sizeof(sof), "0x%02x", f.sof);
  if (f.lossless && (f.predictor < 1 || f.predictor > 7))
    msg = "JPEG: damaged data: bad lossless scan parameters (SOF type " +
          std::string(sof) + ", predictor " + std::to_string(f.predictor) +
          ")";
  else if (f.lossless)
    msg = "JPEG: lossless (SOF type " + std::string(sof) + ") of " +
          std::to_string(f.precision) + " bits, " +
          std::to_string(f.ncomp) + " component(s), libjpeg's colour guess " +
          (colour_of(f) == kNoColour ? std::string("none")
                                     : kColourNames[colour_of(f)]) +
          ": cv2 refuses it too (it reads lossless streams of at most 8 "
          "bits that need no colour conversion: RGB)";
  else if (f.precision != 8)
    msg = "JPEG: " + std::to_string(f.precision) + "-bit precision (SOF type " +
          sof + "): cv2 refuses it too";
  else
    return nullptr;
  return msg.c_str();
}

int jpeg_decode_host(const uint8_t* d, long n, uint8_t* out, int h, int w) {
  return decode_kind(d, n, kOther, "host-decodable", out, h, w);
}

int jpeg_decode_tiff(const uint8_t* d, long n, bool ycbcr,
                     std::vector<uint8_t>* out, int* h, int* w, int* ncomp,
                     int* h0, int* v0) {
  Frame f;
  int st = walk(d, n, nullptr, &f, true);
  if (st) return st;
  bool integral = f.seen && f.decodable && !f.frames;
  for (int c = 0; integral && c < f.ncomp; ++c)
    integral = f.hmax % f.hs[c] == 0 && f.vmax % f.vs[c] == 0;
  if (!integral || (ycbcr && f.ncomp != 3)) {
    set_error("TIFF: a JPEG strip the host decoders do not take (8 bits, "
              "integer sampling ratios; YCbCr of three components)");
    return kUnsupported;
  }
  *h = f.height;
  *w = f.width;
  *ncomp = f.ncomp;
  *h0 = f.hs[0];
  *v0 = f.vs[0];
  for (int c = 1; c < f.ncomp; ++c)
    if (f.hs[c] != 1 || f.vs[c] != 1) *h0 = *v0 = 0;  // improper factors
  out->resize(static_cast<size_t>(f.height) * f.width * (ycbcr ? 3 : f.ncomp));
  Coefs co;
  st = walk(d, n, &co, &f);
  return st ? st : finish(co, f, 1, out->data(), f.height, f.width,
                          ycbcr ? kYCbCr : kRaw, true);
}

// ycc_to_rgb: libjpeg's output stage on YCbCr planes (the nvJPEG back end's
// planes), chroma planes of ch x cw subsampled by hs x vs
void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                int h, int w, int ch, int cw, int hs, int vs, uint8_t* out) {
  const YccTables& t = ycc_tables();
  std::vector<int> colsum(cw);
  std::vector<uint8_t> cb_row(static_cast<size_t>(hs) * cw + w),
      cr_row(static_cast<size_t>(hs) * cw + w);
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

}  // namespace sdt
