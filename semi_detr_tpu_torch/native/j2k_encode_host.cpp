// JPEG 2000 encoder of the host library: an (h, w, 3) RGB picture to the
// .jp2 file cv2.imwrite writes for it (cv2 5.0 writes it through OpenJPEG
// 2.5.3 and passes the R, G, B planes of its BGR picture), byte for byte.
// Each rule below was found by holding this file's output to cv2's.
//
// * What cv2 asks of OpenJPEG: opj_set_default_encoder_parameters, then
//   one quality layer at rate 4 (cp_disto_alloc 1, tcp_rates[0] = 4) and
//   the multiple component transform; codec JP2, colour space sRGB.
// * The file: the signature box, ftyp (brand 'jp2 ', minor 0, compatible
//   'jp2 '), jp2h (ihdr: h, w, 3 components, bpc 7, compression 7; colr:
//   method 1, enumerated sRGB = 16), then jp2c holding the codestream:
//   SOC, SIZ (Rsiz 0, one tile of the picture's size at the origin, 3
//   unsigned 8-bit components, no sub-sampling), COD (LRCP, 1 layer, MCT,
//   5 decomposition levels, 64 x 64 code-blocks, style 0, the 5/3
//   wavelet, one precinct per resolution), QCD (no quantisation, 2 guard
//   bits, exponents 8 / 9 / 9 / 10 for LL / HL / LH / HH), COM (Rcom 1,
//   "Created by OpenJPEG version 2.5.3"), one tile-part (SOT with Psot,
//   TNsot 1; SOD), its packets and EOC.
// * Below 32 pixels on a side OpenJPEG cannot make 5 decomposition levels
//   ("Number of resolutions is too high in comparison to the size of
//   tiles"), cv2.imwrite returns False and the file holds the 77 bytes
//   written before the codestream: the signature, ftyp and jp2h boxes.
//   jp2_encode gives those bytes and kUnsupported with cv2's reason.
// * The tile: the DC level shift (-128), the RCT ((r + 2g + b) >> 2,
//   b - g, r - g), and 5 levels of the 5/3 forward wavelet in integer
//   lifting (opj_dwt_encode: columns, then rows, each level; symmetric
//   extension at both ends), which the decoder (j2k_host.cpp) inverts.
// * Tier-1 (opj_t1_encode_cblk): the samples at 64 times their magnitude
//   (T1_NMSEDEC_FRACBITS 6), the MQ coder started with C = 0, A = 0x8000,
//   CT = 12 over a fake byte 0, the significance, refinement and cleanup
//   passes (with the cleanup's run mode) over the contexts of
//   j2k_tables.h, one segment ended by the MQ FLUSH after the last pass.
//   A pass's rate is the bytes written so far, plus 3 for a pass not
//   terminated; the rates are then made non-increasing from the last
//   pass's bytes down, and a rate whose last byte is 0xFF loses it. A
//   pass's distortion decrease is t1.c's: the nmsedec tables
//   (t1_generate_luts.c's formulas) summed over the pass, weighted by
//   (mct norm x dwt norm x 2^bpno)^2 / 8192 in double, and summed over the
//   passes in order.
// * Rate allocation (opj_tcd_rateallocate): the budget is
//   float(24 w h / 32) less the bytes before the first tile-part (the JP2
//   boxes, the jp2c box header and the main header: opj_j2k_update_rates'
//   l_sot_remove), rounded up (at least 558 bytes from 32 x 32 up, so
//   OpenJPEG's floor of 30 never applies). The threshold on the
//   distortion-rate slope is bisected between the least and greatest slope
//   of any pass; each try makes the layer (opj_tcd_makelayer: a pass is
//   taken when its slope from the last pass taken reaches the threshold,
//   within DBL_EPSILON; a pass adding no bytes is taken only if it adds
//   distortion) and runs tier-2 against the budget; the search stops after
//   128 tries or when the midpoint moves by no more than 5e-6 of the
//   threshold. The last threshold that fitted makes the layer (the last
//   one tried where none did), and the final tier-2 is held only to the
//   tile's buffer. A picture that fits is written whole but for trailing
//   passes that add neither bytes nor distortion.
// * Tier-2 (opj_t2_encode_packet): one packet per resolution and
//   component in LRCP order, each starting with a 1 bit, then per band and
//   code-block the inclusion tag tree (or bit), the zero bit-plane tag
//   tree, the pass count code, the Lblock increment as a comma code and
//   the segment length; header bits stuffed after 0xFF, no SOP or EPH;
//   then the code-blocks' bytes.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "host.h"
#include "j2k_tables.h"

namespace sdt {

namespace {

using namespace j2k;

constexpr int kLevels = 5;         // decomposition levels (6 resolutions)
constexpr int kCblk = 6;           // log2 of the code-block size
constexpr int kFracBits = 6;       // T1_NMSEDEC_FRACBITS
constexpr int kMinSide = 1 << kLevels;
constexpr char kComment[] = "Created by OpenJPEG version 2.5.3";
// cv2's reason when a side is below kMinSide
constexpr char kRefusal[] =
    "Number of resolutions is too high in comparison to the size of tiles";

// opj_dwt_norms (dwt.c) by orientation and level
constexpr double kDwtNorms[4][6] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01}};

// t1_luts.h's nmsedec tables, from t1_generate_luts.c's formulas: the
// decrease of the squared error (x 8192) when a sample turns significant
// (sig) or is refined (ref), indexed by its magnitude's 7 bits from the
// bit-plane coded; the *0 tables are those of bit-plane 0
struct Nmsedec {
  int16_t sig[128], sig0[128], ref[128], ref0[128];
  Nmsedec() {
    auto q = [](double v) {
      return static_cast<int16_t>(std::max(
          0, static_cast<int>(std::floor(v * 64.0 + 0.5) / 64.0 * 8192.0)));
    };
    for (int i = 0; i < 128; ++i) {
      const double t = i / 64.0;
      double u = t, v = t - 1.5;
      sig[i] = q(u * u - v * v);
      sig0[i] = q(u * u);
      u = t - 1.0;
      v = (i & 64) ? t - 1.5 : t - 0.5;
      ref[i] = q(u * u - v * v);
      ref0[i] = q(u * u);
    }
  }
};
const Nmsedec kNmsedec;

void put16(std::vector<uint8_t>* f, uint32_t v) {
  f->push_back(static_cast<uint8_t>(v >> 8));
  f->push_back(static_cast<uint8_t>(v));
}
void put32(std::vector<uint8_t>* f, uint32_t v) {
  put16(f, v >> 16);
  put16(f, v & 0xFFFF);
}
void put_type(std::vector<uint8_t>* f, const char* t) {
  f->insert(f->end(), t, t + 4);
}

int ceilpow2(int a, int b) { return (a + (1 << b) - 1) >> b; }

int floorlog2(uint32_t v) {
  int l = 0;
  while (v > 1) {
    v >>= 1;
    ++l;
  }
  return l;
}

// ------------------------------------------------------------- tier-1

struct MqEnc {  // opj_mqc's encoder (C.2)
  std::vector<uint8_t> buf;  // buf[0] is the fake byte before the data
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[19], mps[19];

  void init() {
    std::memset(state, 0, sizeof(state));
    std::memset(mps, 0, sizeof(mps));
    state[kCtxUni] = 46;
    state[kCtxAgg] = 3;
    state[kCtxZc] = 4;
    buf.assign(1, 0);
    bp = 0;
    a = 0x8000;
    c = 0;
    ct = 12;
  }
  uint32_t numbytes() const { return static_cast<uint32_t>(bp - 1); }
  void put(uint8_t v) {  // ++bp; *bp = v
    ++bp;
    if (bp == buf.size()) buf.push_back(v);
    else buf[bp] = v;
  }
  void byteout() {
    if (buf[bp] == 0xFF) {
      put(static_cast<uint8_t>(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(static_cast<uint8_t>(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++buf[bp];
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        put(static_cast<uint8_t>(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        put(static_cast<uint8_t>(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, int d) {
    const MqState& s = kMq[state[cx]];
    a -= s.qe;
    if (d == mps[cx]) {
      if ((a & 0x8000) == 0) {
        if (a < s.qe) a = s.qe;
        else c += s.qe;
        state[cx] = s.nmps;
        renorm();
      } else {
        c += s.qe;
      }
    } else {
      if (a < s.qe) c += s.qe;
      else a = s.qe;
      if (s.sw) mps[cx] = !mps[cx];
      state[cx] = s.nlps;
      renorm();
    }
  }
  void flush() {  // opj_mqc_flush: SETBITS, two bytes out, no final 0xFF
    const uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xFF) ++bp;
  }
};

struct Pass {
  uint32_t rate = 0, len = 0;
  double dist = 0;  // cumulative distortion decrease
  bool term = false;
};

struct Cblk {
  int x0, y0, x1, y1;  // in the band
  int numbps = 0;
  std::vector<uint8_t> data;  // the coded bytes
  std::vector<Pass> passes;
  // the layer (opj_tcd_makelayer) and tier-2's state
  int lay_passes = 0, t2_passes = 0, numlenbits = 0;
  uint32_t lay_len = 0;
};

struct T1Enc {
  int w = 0, h = 0, stride = 0, orient = 0;
  std::vector<uint32_t> st;   // flags, (h + 2) x (w + 2) with a border
  std::vector<uint32_t> mag;  // |sample| << kFracBits
  std::vector<uint8_t> neg;
  MqEnc mq;
  int nmsedec = 0;

  uint32_t* at(int x, int y) { return &st[(y + 1) * stride + x + 1]; }
  int zc(uint32_t f) const { return kLuts.zc[orient][(f >> 4) & 0xFF]; }
  void set_sig(int x, int y) {
    const bool n = neg[y * w + x];
    uint32_t* f = at(x, y);
    *f |= kSig | (n ? kNeg : 0);
    f[-1] |= kE | (n ? kENeg : 0);
    f[1] |= kW | (n ? kWNeg : 0);
    f[-stride] |= kS | (n ? kSNeg : 0);
    f[stride] |= kN | (n ? kNNeg : 0);
    f[-stride - 1] |= kSE;
    f[-stride + 1] |= kSW;
    f[stride - 1] |= kNE;
    f[stride + 1] |= kNW;
  }
  int sig_nmsedec(uint32_t m, int bpno) const {
    return bpno > 0 ? kNmsedec.sig[(m >> bpno) & 127]
                    : kNmsedec.sig0[m & 127];
  }
  int ref_nmsedec(uint32_t m, int bpno) const {
    return bpno > 0 ? kNmsedec.ref[(m >> bpno) & 127]
                    : kNmsedec.ref0[m & 127];
  }
  void encode_sign(int x, int y, uint32_t f, int bpno) {
    const int k = ((f >> 4) & 0xF) | (((f >> 12) & 0xF) << 4);
    nmsedec += sig_nmsedec(mag[y * w + x], bpno);
    mq.encode(kLuts.sc[k], neg[y * w + x] ^ kLuts.xr[k]);
    set_sig(x, y);
  }

  void sigpass(int bpno) {
    const int sh = bpno + kFracBits;
    nmsedec = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t* f = at(x, y);
          if ((*f & (kSig | kVisited)) || !(*f & kNeighbours)) continue;
          const int v = (mag[y * w + x] >> sh) & 1;
          mq.encode(zc(*f), v);
          if (v) encode_sign(x, y, *f, bpno);
          *f |= kVisited;
        }
  }

  void refpass(int bpno) {
    const int sh = bpno + kFracBits;
    nmsedec = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x)
        for (int y = y0; y < std::min(y0 + 4, h); ++y) {
          uint32_t* f = at(x, y);
          if ((*f & (kSig | kVisited)) != kSig) continue;
          const uint32_t m = mag[y * w + x];
          nmsedec += ref_nmsedec(m, bpno);
          mq.encode((*f & kRefined) ? kCtxMag + 2
                    : (*f & kNeighbours) ? kCtxMag + 1 : kCtxMag,
                    (m >> sh) & 1);
          *f |= kRefined;
        }
  }

  void clnpass(int bpno) {
    const int sh = bpno + kFracBits;
    nmsedec = 0;
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; ++x) {
        const int rows = std::min(4, h - y0);
        int i = 0;
        bool partial = false;
        if (rows == 4) {
          bool run = true;
          for (int k = 0; k < 4 && run; ++k)
            run = !(*at(x, y0 + k) & (kSig | kVisited | kNeighbours));
          if (run) {
            int r = 0;
            while (r < 4 && !((mag[(y0 + r) * w + x] >> sh) & 1)) ++r;
            mq.encode(kCtxAgg, r != 4);
            if (r == 4) continue;
            mq.encode(kCtxUni, r >> 1);
            mq.encode(kCtxUni, r & 1);
            i = r;
            partial = true;
          }
        }
        for (; i < rows; ++i) {
          const int y = y0 + i;
          const uint32_t f = *at(x, y);
          if (!partial) {
            if (f & (kSig | kVisited)) continue;
            const int v = (mag[y * w + x] >> sh) & 1;
            mq.encode(zc(f), v);
            if (!v) continue;
          }
          partial = false;
          encode_sign(x, y, f, bpno);
        }
        for (int k = 0; k < rows; ++k) *at(x, y0 + k) &= ~kVisited;
      }
  }
};

// opj_t1_encode_cblk on the samples of cb (w x h at src, row stride ss) in
// a band of orientation orient at decomposition level level
void encode_cblk(const int32_t* src, long ss, int orient, int level,
                 Cblk* cb, T1Enc* t1) {
  const int w = cb->x1 - cb->x0, h = cb->y1 - cb->y0;
  t1->w = w;
  t1->h = h;
  t1->stride = w + 2;
  t1->orient = orient;
  t1->st.assign(static_cast<size_t>(h + 2) * (w + 2), 0);
  t1->mag.resize(static_cast<size_t>(w) * h);
  t1->neg.resize(static_cast<size_t>(w) * h);
  uint32_t max = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int32_t v = src[y * ss + x];
      const uint32_t m = static_cast<uint32_t>(v < 0 ? -v : v) << kFracBits;
      t1->mag[y * w + x] = m;
      t1->neg[y * w + x] = v < 0;
      max = std::max(max, m);
    }
  cb->numbps = max ? floorlog2(max) + 1 - kFracBits : 0;
  cb->passes.clear();
  cb->data.clear();
  if (!cb->numbps) return;
  MqEnc& mq = t1->mq;
  mq.init();
  // w1 * w2 * stepsize of opj_t1_getwmsedec: no MCT, so w1 = 1, and the
  // 5/3 wavelet's step size is 1
  const double norm = kDwtNorms[orient][level];
  double cum = 0;
  int passtype = 2;
  for (int bpno = cb->numbps - 1; bpno >= 0;) {
    if (passtype == 0) t1->sigpass(bpno);
    else if (passtype == 1) t1->refpass(bpno);
    else t1->clnpass(bpno);
    double wmsedec = norm * (1 << bpno);
    wmsedec *= wmsedec * t1->nmsedec / 8192.0;
    cum += wmsedec;
    Pass p;
    p.dist = cum;
    if (passtype == 2 && bpno == 0) {
      mq.flush();
      p.term = true;
      p.rate = mq.numbytes();
    } else {
      p.rate = mq.numbytes() + 3;
    }
    cb->passes.push_back(p);
    if (++passtype == 3) {
      passtype = 0;
      --bpno;
    }
  }
  cb->data.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + mq.numbytes());
  // the rates made non-increasing from the last, then no pass ending on
  // 0xFF, and each pass's length
  uint32_t last = mq.numbytes();
  for (size_t k = cb->passes.size(); k-- > 0;) {
    Pass& p = cb->passes[k];
    if (p.rate > last) p.rate = last;
    else last = p.rate;
  }
  for (size_t k = 0; k < cb->passes.size(); ++k) {
    Pass& p = cb->passes[k];
    if (p.rate > 0 && mq.buf[p.rate] == 0xFF) --p.rate;
    p.len = p.rate - (k ? cb->passes[k - 1].rate : 0);
  }
}

// ------------------------------------------------------------- tier-2

struct BioEnc {  // opj_bio's writer: bits MSB first, 7 bits after 0xFF
  uint8_t* start;
  uint8_t* bp;
  uint8_t* end;
  uint32_t buf = 0;
  int ct = 8;
  BioEnc(uint8_t* s, long len) : start(s), bp(s), end(s + len) {}
  bool byteout() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return false;
    *bp++ = static_cast<uint8_t>(buf >> 8);
    return true;
  }
  void putbit(uint32_t b) {
    if (ct == 0) byteout();
    --ct;
    buf |= b << ct;
  }
  void write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) putbit((v >> i) & 1);
  }
  bool flush() {
    if (!byteout()) return false;
    if (ct == 7 && !byteout()) return false;
    return true;
  }
};

struct TagTreeEnc {  // opj_tgt
  struct Node {
    int parent, value, low;
    bool known;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    std::vector<int> lw{w}, lh{h};
    int total = 0;
    for (;;) {
      const int k = lw.back() * lh.back();
      total += k;
      if (k <= 1) break;
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    nodes.assign(total, Node{-1, 999, 0, false});
    int base = 0;
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      const int next = base + lw[l] * lh[l];
      for (int j = 0; j < lh[l]; ++j)
        for (int i = 0; i < lw[l]; ++i)
          nodes[base + j * lw[l] + i].parent =
              next + (j / 2) * lw[l + 1] + i / 2;
      base = next;
    }
  }
  void reset() {
    for (Node& n : nodes) {
      n.value = 999;
      n.low = 0;
      n.known = false;
    }
  }
  void setvalue(int leaf, int value) {
    for (int n = leaf; n >= 0 && nodes[n].value > value; n = nodes[n].parent)
      nodes[n].value = value;
  }
  void encode(BioEnc* bio, int leaf, int threshold) {
    int stk[32], sp = 0, n = leaf;
    while (nodes[n].parent >= 0) {
      stk[sp++] = n;
      n = nodes[n].parent;
    }
    int low = 0;
    for (;;) {
      Node& node = nodes[n];
      if (low > node.low) node.low = low;
      else low = node.low;
      while (low < threshold) {
        if (low >= node.value) {
          if (!node.known) {
            bio->putbit(1);
            node.known = true;
          }
          break;
        }
        bio->putbit(0);
        ++low;
      }
      node.low = low;
      if (!sp) break;
      n = stk[--sp];
    }
  }
};

void putnumpasses(BioEnc* bio, int n) {
  if (n == 1) bio->putbit(0);
  else if (n == 2) bio->write(2, 2);
  else if (n <= 5) bio->write(0xC | (n - 3), 4);
  else if (n <= 36) bio->write(0x1E0 | (n - 6), 9);
  else bio->write(0xFF80 | (n - 37), 16);
}

// ------------------------------------------------------------- the tile

struct Band {
  int bandno, w, h, numbps;
  int xoff, yoff;  // where the band lies in the transformed plane
  int cw, ch;
  std::vector<Cblk> cblks;
  TagTreeEnc incl, imsb;
};

struct Res {
  int w, h;
  std::vector<Band> bands;
};

struct Tile {
  int w, h;
  std::vector<int32_t> planes[3];
  std::vector<Res> res[3];
};

// opj_tcd_init_tile's resolutions, bands and code-blocks for a tile at
// the origin with one precinct per resolution
void init_geometry(Tile* t) {
  for (int c = 0; c < 3; ++c) {
    t->res[c].resize(kLevels + 1);
    for (int r = 0; r <= kLevels; ++r) {
      Res& res = t->res[c][r];
      const int level = kLevels - r;
      res.w = ceilpow2(t->w, level);
      res.h = ceilpow2(t->h, level);
      const int nb = r == 0 ? 1 : 3;
      res.bands.resize(nb);
      for (int b = 0; b < nb; ++b) {
        Band& band = res.bands[b];
        band.bandno = r == 0 ? 0 : b + 1;
        if (r == 0) {
          band.w = res.w;
          band.h = res.h;
        } else {  // every band starts at 0: the tile lies at the origin
          const int xob = band.bandno & 1, yob = band.bandno >> 1;
          band.w = ceilpow2(t->w - (xob << level), level + 1);
          band.h = ceilpow2(t->h - (yob << level), level + 1);
        }
        const Res* lower = r ? &t->res[c][r - 1] : nullptr;
        band.xoff = (band.bandno & 1) ? lower->w : 0;
        band.yoff = (band.bandno & 2) ? lower->h : 0;
        // QCD's exponent (prec + gain) + guard bits - 1
        const int gain = band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        band.numbps = 8 + gain + 2 - 1;
        band.cw = ceilpow2(band.w, kCblk);
        band.ch = ceilpow2(band.h, kCblk);
        band.cblks.resize(static_cast<size_t>(band.cw) * band.ch);
        for (int k = 0; k < band.cw * band.ch; ++k) {
          Cblk& cb = band.cblks[k];
          cb.x0 = (k % band.cw) << kCblk;
          cb.y0 = (k / band.cw) << kCblk;
          cb.x1 = std::min(cb.x0 + (1 << kCblk), band.w);
          cb.y1 = std::min(cb.y0 + (1 << kCblk), band.h);
        }
        band.incl.init(band.cw, band.ch);
        band.imsb.init(band.cw, band.ch);
      }
    }
  }
}

// the forward 5/3 of one line of n samples (x[k * step]), low first after
// it; tmp holds n + n / 2 samples
void fdwt53(int32_t* x, int n, long step, int32_t* tmp) {
  if (n < 2) return;
  const int sn = (n + 1) / 2, dn = n / 2;
  for (int k = 0; k < n; ++k) tmp[k] = x[k * step];
  int32_t* d = tmp + n;
  auto S = [&](int i) { return tmp[2 * std::clamp(i, 0, sn - 1)]; };
  for (int i = 0; i < dn; ++i)
    d[i] = tmp[2 * i + 1] - ((S(i) + S(i + 1)) >> 1);
  auto D = [&](int i) { return d[std::clamp(i, 0, dn - 1)]; };
  for (int i = 0; i < sn; ++i)
    x[i * step] = tmp[2 * i] + ((D(i - 1) + D(i) + 2) >> 2);
  for (int i = 0; i < dn; ++i) x[(sn + i) * step] = d[i];
}

// opj_dwt_encode: each level, the columns and then the rows of the
// resolution it splits
void fdwt_plane(int32_t* p, int w, int h) {
  std::vector<int32_t> tmp(std::max(w, h) * 3 / 2 + 1);
  for (int level = 0; level < kLevels; ++level) {
    const int rw = ceilpow2(w, level), rh = ceilpow2(h, level);
    for (int x = 0; x < rw; ++x) fdwt53(p + x, rh, w, tmp.data());
    for (int y = 0; y < rh; ++y) fdwt53(p + static_cast<long>(y) * w, rw, 1,
                                        tmp.data());
  }
}

struct Job {
  int level, orient;
  const int32_t* src;
  Cblk* cb;
};

// tier-1 over every code-block, on up to 8 threads
void encode_cblks(Tile* t) {
  std::vector<Job> jobs;
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r <= kLevels; ++r)
      for (Band& band : t->res[c][r].bands)
        for (Cblk& cb : band.cblks)
          jobs.push_back(Job{kLevels - r, band.bandno,
                             t->planes[c].data() +
                                 static_cast<long>(band.yoff + cb.y0) * t->w +
                                 band.xoff + cb.x0,
                             &cb});
  std::atomic<size_t> next{0};
  auto work = [&]() {
    T1Enc t1;
    for (size_t k; (k = next++) < jobs.size();) {
      const Job& j = jobs[k];
      encode_cblk(j.src, t->w, j.orient, j.level, j.cb, &t1);
    }
  };
  const unsigned n =
      std::max(1u, std::min(8u, std::thread::hardware_concurrency()));
  std::vector<std::thread> pool;
  for (unsigned i = 1; i < n; ++i) pool.emplace_back(work);
  work();
  for (std::thread& th : pool) th.join();
}

template <typename F>
void each_cblk(Tile* t, F f) {
  for (int c = 0; c < 3; ++c)
    for (int r = 0; r <= kLevels; ++r)
      for (Band& band : t->res[c][r].bands)
        for (Cblk& cb : band.cblks) f(cb);
}

// opj_tcd_makelayer for layer 0: the passes each code-block puts in the
// layer at threshold thresh
void makelayer(Tile* t, double thresh) {
  each_cblk(t, [&](Cblk& cb) {
    int n = 0;
    for (size_t k = 0; k < cb.passes.size(); ++k) {
      const Pass& p = cb.passes[k];
      uint32_t dr;
      double dd;
      if (n == 0) {
        dr = p.rate;
        dd = p.dist;
      } else {
        dr = p.rate - cb.passes[n - 1].rate;
        dd = p.dist - cb.passes[n - 1].dist;
      }
      if (!dr) {
        if (dd != 0) n = static_cast<int>(k) + 1;
        continue;
      }
      if (thresh - dd / dr < DBL_EPSILON) n = static_cast<int>(k) + 1;
    }
    cb.lay_passes = n;
    cb.lay_len = n ? cb.passes[n - 1].rate : 0;
  });
}

// opj_t2_encode_packets for layer 0 into out (at most maxlen bytes);
// false where the packets do not fit. Bodies are copied only when copy.
bool encode_packets(Tile* t, std::vector<uint8_t>* out, long maxlen,
                    bool copy) {
  out->resize(static_cast<size_t>(maxlen));
  uint8_t* c = out->data();
  long left = maxlen;
  for (int r = 0; r <= kLevels; ++r)
    for (int comp = 0; comp < 3; ++comp) {
      std::vector<Band>& bands = t->res[comp][r].bands;
      for (Band& band : bands) {
        band.incl.reset();
        band.imsb.reset();
        for (size_t k = 0; k < band.cblks.size(); ++k) {
          band.cblks[k].t2_passes = 0;
          band.imsb.setvalue(static_cast<int>(k),
                             band.numbps - band.cblks[k].numbps);
        }
      }
      BioEnc bio(c, left);
      bio.putbit(1);
      for (Band& band : bands) {
        for (size_t k = 0; k < band.cblks.size(); ++k)
          if (!band.cblks[k].t2_passes && band.cblks[k].lay_passes)
            band.incl.setvalue(static_cast<int>(k), 0);
        for (size_t k = 0; k < band.cblks.size(); ++k) {
          Cblk& cb = band.cblks[k];
          const int leaf = static_cast<int>(k);
          if (!cb.t2_passes) band.incl.encode(&bio, leaf, 1);
          else bio.putbit(cb.lay_passes != 0);
          if (!cb.lay_passes) continue;
          if (!cb.t2_passes) {
            cb.numlenbits = 3;
            band.imsb.encode(&bio, leaf, 999);
          }
          putnumpasses(&bio, cb.lay_passes);
          // one segment: every pass up to the layer's last
          const int end = cb.t2_passes + cb.lay_passes;
          int increment = 0, nump = 0;
          uint32_t len = 0;
          for (int k2 = cb.t2_passes; k2 < end; ++k2) {
            ++nump;
            len += cb.passes[k2].len;
            if (cb.passes[k2].term || k2 == end - 1) {
              increment = std::max(
                  increment, floorlog2(len) + 1 -
                                 (cb.numlenbits + floorlog2(nump)));
              len = 0;
              nump = 0;
            }
          }
          for (int i = 0; i < increment; ++i) bio.putbit(1);
          bio.putbit(0);
          cb.numlenbits += increment;
          for (int k2 = cb.t2_passes; k2 < end; ++k2) {
            ++nump;
            len += cb.passes[k2].len;
            if (cb.passes[k2].term || k2 == end - 1) {
              bio.write(len, cb.numlenbits + floorlog2(nump));
              len = 0;
              nump = 0;
            }
          }
        }
      }
      if (!bio.flush()) return false;
      const long hdr = bio.bp - bio.start;
      c += hdr;
      left -= hdr;
      for (Band& band : bands)
        for (Cblk& cb : band.cblks) {
          if (!cb.lay_passes) continue;
          if (cb.lay_len > static_cast<uint32_t>(left)) return false;
          if (copy) std::memcpy(c, cb.data.data(), cb.lay_len);
          cb.t2_passes += cb.lay_passes;
          c += cb.lay_len;
          left -= cb.lay_len;
        }
    }
  out->resize(static_cast<size_t>(c - out->data()));
  return true;
}

// opj_tcd_rateallocate for the one layer, then the final tier-2, which is
// held only to the tile's buffer (a layer that never fitted the budget is
// written all the same, at the last threshold tried)
void rate_allocate(Tile* t, long budget, std::vector<uint8_t>* packets) {
  double lo = DBL_MAX, hi = 0;
  each_cblk(t, [&](Cblk& cb) {
    for (size_t k = 0; k < cb.passes.size(); ++k) {
      const Pass& p = cb.passes[k];
      int32_t dr;
      double dd;
      if (k == 0) {
        dr = static_cast<int32_t>(p.rate);
        dd = p.dist;
      } else {
        dr = static_cast<int32_t>(p.rate - cb.passes[k - 1].rate);
        dd = p.dist - cb.passes[k - 1].dist;
      }
      if (dr == 0) continue;
      const double slope = dd / dr;
      lo = std::min(lo, slope);
      hi = std::max(hi, slope);
    }
  });
  double thresh = 0, stable = 0;
  for (int i = 0; i < 128; ++i) {
    const double mid = (lo + hi) / 2;
    if (std::fabs(mid - thresh) <= 0.5 * 1e-5 * thresh) break;
    thresh = mid;
    makelayer(t, thresh);
    if (!encode_packets(t, packets, budget, false)) {
      lo = thresh;
    } else {
      hi = thresh;
      stable = thresh;
    }
  }
  makelayer(t, stable != 0 ? stable : thresh);
  long all = 4096;
  each_cblk(t, [&](Cblk& cb) { all += cb.lay_len + 64; });
  if (!encode_packets(t, packets, all, true))
    throw std::string("the packets overflow the tile's buffer");
}

// the JP2 boxes before the codestream (what cv2 leaves when it refuses)
void jp2_header(int h, int w, std::vector<uint8_t>* f) {
  put32(f, 12);
  put_type(f, "jP  ");
  put32(f, 0x0D0A870A);
  put32(f, 20);
  put_type(f, "ftyp");
  put_type(f, "jp2 ");
  put32(f, 0);
  put_type(f, "jp2 ");
  put32(f, 45);
  put_type(f, "jp2h");
  put32(f, 22);
  put_type(f, "ihdr");
  put32(f, h);
  put32(f, w);
  put16(f, 3);
  f->push_back(7);  // bits per component less one
  f->push_back(7);  // compression type: JPEG 2000
  f->push_back(0);
  f->push_back(0);
  put32(f, 15);
  put_type(f, "colr");
  f->push_back(1);  // enumerated colour space
  f->push_back(0);
  f->push_back(0);
  put32(f, 16);  // sRGB
}

void main_header(int h, int w, std::vector<uint8_t>* f) {
  put16(f, 0xFF4F);  // SOC
  put16(f, 0xFF51);  // SIZ
  put16(f, 38 + 3 * 3);
  put16(f, 0);
  for (uint32_t v : {uint32_t(w), uint32_t(h), 0u, 0u, uint32_t(w),
                     uint32_t(h), 0u, 0u})
    put32(f, v);
  put16(f, 3);
  for (int c = 0; c < 3; ++c) {
    f->push_back(7);
    f->push_back(1);
    f->push_back(1);
  }
  put16(f, 0xFF52);  // COD
  put16(f, 12);
  f->push_back(0);      // Scod
  f->push_back(0);      // LRCP
  put16(f, 1);          // layers
  f->push_back(0);      // no MCT
  f->push_back(kLevels);
  f->push_back(kCblk - 2);
  f->push_back(kCblk - 2);
  f->push_back(0);      // code-block style
  f->push_back(1);      // 5/3
  put16(f, 0xFF5C);  // QCD
  put16(f, 3 + 3 * kLevels + 1);
  f->push_back(2 << 5);  // 2 guard bits, no quantisation
  f->push_back(8 << 3);
  for (int l = 0; l < kLevels; ++l) {
    f->push_back(9 << 3);
    f->push_back(9 << 3);
    f->push_back(10 << 3);
  }
  const size_t n = sizeof(kComment) - 1;
  put16(f, 0xFF64);  // COM
  put16(f, static_cast<uint32_t>(4 + n));
  put16(f, 1);
  f->insert(f->end(), kComment, kComment + n);
}

// (h, w, 3) RGB -> the .jp2 file cv2.imwrite writes; kUnsupported with
// cv2's 77-byte file where cv2 refuses the picture
int jp2_encode(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* f) {
  f->clear();
  jp2_header(h, w, f);
  if (h < kMinSide || w < kMinSide) {
    set_error(kRefusal);
    return kUnsupported;
  }
  const size_t box_at = f->size();
  put32(f, 0);
  put_type(f, "jp2c");
  main_header(h, w, f);
  // opj_j2k_update_rates: the layer's bytes at rate 4, less everything
  // written so far
  float rate = static_cast<float>(24.0 * static_cast<uint32_t>(w) *
                                  static_cast<uint32_t>(h) / (4.0f * 8.0f));
  rate -= static_cast<float>(f->size());
  const long budget = static_cast<long>(std::ceil(rate));

  Tile t;
  t.w = w;
  t.h = h;
  const size_t n = static_cast<size_t>(w) * h;
  for (int c = 0; c < 3; ++c) t.planes[c].resize(n);
  for (size_t i = 0; i < n; ++i) {
    const int32_t r = rgb[3 * i] - 128, g = rgb[3 * i + 1] - 128,
                  b = rgb[3 * i + 2] - 128;
    t.planes[0][i] = r;
    t.planes[1][i] = g;
    t.planes[2][i] = b;
  }
  for (int c = 0; c < 3; ++c) fdwt_plane(t.planes[c].data(), w, h);
  init_geometry(&t);
  encode_cblks(&t);
  std::vector<uint8_t> packets;
  try {
    rate_allocate(&t, budget, &packets);
  } catch (const std::string& m) {
    set_error("JPEG 2000 encode: " + m);
    return kCorrupt;
  }
  put16(f, 0xFF90);  // SOT
  put16(f, 10);
  put16(f, 0);
  put32(f, static_cast<uint32_t>(14 + packets.size()));
  f->push_back(0);
  f->push_back(1);
  put16(f, 0xFF93);  // SOD
  f->insert(f->end(), packets.begin(), packets.end());
  put16(f, 0xFFD9);  // EOC
  const uint32_t len = static_cast<uint32_t>(f->size() - box_at);
  for (int k = 0; k < 4; ++k)
    (*f)[box_at + k] = static_cast<uint8_t>(len >> (24 - 8 * k));
  return kOk;
}

}  // namespace

}  // namespace sdt

extern "C" {

// (h, w, 3) RGB -> the .jp2 file cv2.imwrite writes (see jp2_encode);
// *out, freed with sdt_free, is set on success and on cv2's refusal
int sdt_encode_jp2(const uint8_t* rgb, int h, int w, uint8_t** out,
                   long* size) {
  std::vector<uint8_t> f;
  const int st = sdt::jp2_encode(rgb, h, w, &f);
  if (st != sdt::kOk && st != sdt::kUnsupported) return st;
  *out = static_cast<uint8_t*>(std::malloc(f.size()));
  if (!*out) {
    sdt::set_error("out of memory");
    return sdt::kTooLarge;
  }
  std::memcpy(*out, f.data(), f.size());
  *size = static_cast<long>(f.size());
  return st;
}

}  // extern "C"
