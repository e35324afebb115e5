// The AV1 still-picture encoder of the host library: the key frame
// cv2.imwrite's libavif (over libaom 3.14.1) writes for an 8-bit RGB
// picture at its defaults, with libaom's sequence header and frame
// quantizer, written by a search of the library's own.
//
// * Colour: libyuv's ARGBToJ420 as libavif runs it for BT.601 full range:
//   Y = (77 R + 150 G + 29 B + 128) >> 8 of each pixel; U and V of the sums
//   of each 2x2 cell's samples, (sum + 2) >> 2, then (127 B - 84 G - 43 R +
//   0x8000) >> 8 and (127 R - 107 G - 20 B + 0x8000) >> 8, the picture's
//   last row and column repeated where a cell runs past them.
// * Headers: the reduced still-picture sequence header libaom writes
//   (level by the picture's size, 64x64 superblocks, filter intra, intra
//   edge filter and CDEF on, loop restoration off, BT.601 full range), and a
//   frame header of cv2's quantizer: base_q_idx 148, chroma delta q -16 for
//   DC and AC, quantizer matrix level 8, deblocking at level 15 (sharpness
//   1) and CDEF of one strength (damping 5, luma 2 / 1, chroma 0 / 0), as
//   cv2 writes them; TX_MODE_LARGEST; delta q per superblock in steps of
//   4, each superblock's qindex by libaom's variance boost.
// * Tiles as libaom lays them out: uniform spacing, the fewest the limits
//   allow (at most 64 superblocks across and 2304 in all: 2x1 above 4096
//   wide, 1x2 for a 12 MP photo), one frame OBU of one tile group;
//   context_update_tile_id the largest tile, TileSizeBytes the fewest that
//   hold its size (as cv2's files show). Each tile is searched and written
//   from its own start (CDFs, contexts, qindex), as the decoder reads it.
// * Each tile: partitions from 64x64 down to 8x8 (split at the frame's
//   edges), each block's luma mode, then its chroma mode, the one of least
//   SATD plus the symbol's cost, DCT_DCT throughout; a block coded whole
//   is held against its four quarters by rate (the symbols' costs at the
//   present CDFs) plus lambda-weighted distortion. Each such trial runs
//   the decoder's own tile syntax of av1_intra.cpp (prediction, the inverse
//   transforms, the contexts) with a counting SymbolWriter; the chosen tree
//   is then written by the same code with the writing one, and the
//   decoder's in-loop filters finish the reconstruction. So the encoder's
//   reconstruction is the decoder's by construction.
// * The forward transforms are the least-squares inverses of the decoder's
//   one-dimensional inverse transforms (their impulse responses, scaled to
//   integers), quantized with a dead zone. Every step is integer
//   arithmetic: the same bytes on every machine.
#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "av1_state.h"
#include "av1_tables.h"
#include "host.h"

namespace sdt {
namespace av1 {

namespace {

// ------------------------------------------------------------ bits

struct BitWriter {
  std::vector<uint8_t> out;
  int used = 0;  // bits of the last byte
  void f(int bits, uint32_t v) {
    for (int i = bits - 1; i >= 0; i--) {
      if (used == 0) out.push_back(0);
      out.back() |= static_cast<uint8_t>(((v >> i) & 1) << (7 - used));
      used = (used + 1) & 7;
    }
  }
  void su(int bits, int v) { f(bits, static_cast<uint32_t>(v) & ((1u << bits) - 1)); }
  // trailing_bits: a one, then zeros to the byte
  void trailing() {
    f(1, 1);
    while (used) f(1, 0);
  }
  void byte_align() {
    while (used) f(1, 0);
  }
};

int bits_for(uint32_t v) {  // the bits of v, at least 1
  int n = 1;
  while (n < 32 && (v >> n)) n++;
  return n;
}

void leb128(std::vector<uint8_t>* out, uint64_t v) {
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    if (v) b |= 0x80;
    out->push_back(b);
  } while (v);
}

void obu(std::vector<uint8_t>* out, int type, const std::vector<uint8_t>& body) {
  out->push_back(static_cast<uint8_t>((type << 3) | 2));  // obu_has_size_field
  leb128(out, body.size());
  out->insert(out->end(), body.begin(), body.end());
}

// seq_level_idx: the smallest level whose MaxPicSize, MaxHSize and
// MaxVSize (Annex A) hold the picture
int level_of(int w, int h) {
  static const struct { int idx; long pic; int hs, vs; } kLevels[] = {
      {0, 147456, 2048, 1152},    {1, 278784, 2816, 1584},
      {4, 665856, 4352, 2448},    {5, 1065024, 5504, 3096},
      {8, 2359296, 6144, 3456},   {12, 8912896, 8192, 4352},
      {16, 35651584, 16384, 8704}};
  for (const auto& l : kLevels)
    if (static_cast<long>(w) * h <= l.pic && w <= l.hs && h <= l.vs) return l.idx;
  return 31;
}

// ------------------------------------------------------------ transforms

// the forward bases: F_k = T_k * 2^32 / |T_k|^2, T_k the decoder's inverse
// transform of an impulse of 2^14 at k (kind 0 DCT of 4 to 64 points, 1
// ADST of 4 to 16)
struct Bases {
  std::vector<int32_t> f[2][7];
  Bases() {
    for (int kind = 0; kind < 2; kind++)
      for (int lg = 2; lg <= (kind ? 4 : 6); lg++) {
        const int n = 1 << lg;
        std::vector<int32_t>& F = f[kind][lg];
        F.assign(static_cast<size_t>(n) * n, 0);
        int32_t in[64], out[64];
        for (int k = 0; k < n; k++) {
          std::fill(in, in + n, 0);
          in[k] = 1 << 14;
          inverse_1d(kind, in, out, n);
          int64_t norm = 0;
          for (int m = 0; m < n; m++) norm += static_cast<int64_t>(out[m]) * out[m];
          for (int m = 0; m < n; m++) {
            const int64_t v = (static_cast<int64_t>(out[m]) << 32);
            F[k * n + m] = static_cast<int32_t>(
                (v >= 0 ? v + norm / 2 : v - norm / 2) / norm);
          }
        }
      }
  }
};

const Bases& bases() {
  static const Bases b;
  return b;
}

inline int64_t round_shift(int64_t v, int s) {
  if (s <= 0) return v << -s;
  return v >= 0 ? (v + (int64_t{1} << (s - 1))) >> s
                : -((-v + (int64_t{1} << (s - 1))) >> s);
}

constexpr int kVtxKind[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
constexpr int kHtxKind[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};

// the coefficients d (min(32, h) x min(32, w), the dequantised values the
// decoder's inverse takes) whose inverse best matches the residual r (h x
// w)
void forward_2d(const int32_t* r, int tx, int type, int64_t* d) {
  const int lw = kTxWidthLog2[tx], lh = kTxHeightLog2[tx];
  const int w = 1 << lw, h = 1 << lh;
  const int tw = std::min(w, 32), th = std::min(h, 32);
  const int32_t* fh = bases().f[kHtxKind[type]][lw].data();
  const int32_t* fv = bases().f[kVtxKind[type]][lh].data();
  static thread_local int64_t a[64 * 32];
  for (int n = 0; n < h; n++)
    for (int j = 0; j < tw; j++) {
      int64_t acc = 0;
      const int32_t* row = r + n * w;
      const int32_t* b = fh + j * w;
      for (int m = 0; m < w; m++) acc += static_cast<int64_t>(row[m]) * b[m];
      a[n * tw + j] = acc;
    }
  const int shift = 32 - kTransformRowShift[tx];
  const bool rect = std::abs(lw - lh) == 1;
  for (int i = 0; i < th; i++)
    for (int j = 0; j < tw; j++) {
      int64_t acc = 0;
      const int32_t* b = fv + i * h;
      for (int n = 0; n < h; n++) acc += b[n] * a[n * tw + j];
      int64_t v = round_shift(acc, shift);
      if (rect) v = round_shift(v * 5793, 12);
      d[i * tw + j] = v;
    }
}

// ------------------------------------------------------------ source

struct Source {
  int stride[3], w[3], h[3];
  std::vector<int16_t> p[3];
  int at(int plane, int y, int x) const {
    return p[plane][static_cast<size_t>(y) * stride[plane] + x];
  }
};

// libyuv's ARGBToJ420 (see the file's head), each plane over the frame's
// area with the last row and column repeated
void to_yuv(const uint8_t* rgb, int h, int w, const State& s, Source* src) {
  const int cw = (w + 1) >> 1, ch = (h + 1) >> 1;
  const int pw[3] = {w, cw, cw}, ph[3] = {h, ch, ch};
  for (int p = 0; p < 3; p++) {
    src->stride[p] = s.stride[p];
    src->w[p] = pw[p];
    src->h[p] = ph[p];
    src->p[p].assign(static_cast<size_t>(s.stride[p]) * s.rows[p], 0);
  }
  auto px = [&](int y, int x, int c) {
    return static_cast<int>(rgb[(static_cast<size_t>(std::min(y, h - 1)) * w +
                                 std::min(x, w - 1)) * 3 + c]);
  };
  for (int y = 0; y < h; y++)
    for (int x = 0; x < w; x++)
      src->p[0][static_cast<size_t>(y) * s.stride[0] + x] = static_cast<int16_t>(
          (77 * px(y, x, 0) + 150 * px(y, x, 1) + 29 * px(y, x, 2) + 128) >> 8);
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++) {
      int sum[3];
      for (int c = 0; c < 3; c++)
        sum[c] = (px(2 * y, 2 * x, c) + px(2 * y, 2 * x + 1, c) +
                  px(2 * y + 1, 2 * x, c) + px(2 * y + 1, 2 * x + 1, c) + 2) >> 2;
      const size_t at = static_cast<size_t>(y) * s.stride[1] + x;
      src->p[1][at] = static_cast<int16_t>(
          (127 * sum[2] - 84 * sum[1] - 43 * sum[0] + 0x8000) >> 8);
      src->p[2][at] = static_cast<int16_t>(
          (127 * sum[0] - 107 * sum[1] - 20 * sum[2] + 0x8000) >> 8);
    }
  for (int p = 0; p < 3; p++)  // repeat the last column, then the last row
    for (int y = 0; y < s.rows[p]; y++) {
      int16_t* row = src->p[p].data() + static_cast<size_t>(y) * s.stride[p];
      if (y >= ph[p]) std::memcpy(row, row - s.stride[p], s.stride[p] * sizeof(int16_t));
      else
        for (int x = pw[p]; x < s.stride[p]; x++) row[x] = row[pw[p] - 1];
    }
}

// ------------------------------------------------------------ search

// what the encoder chose for a block, by its top-left 4x4 unit
struct Choice {
  uint8_t y_mode = DC_PRED, uv_mode = DC_PRED;
};

// the state a trial of a block changes, saved before it and put back
struct Snapshot {
  int r = 0, c = 0, w4 = 0, h4 = 0;
  std::vector<uint16_t> px[3];
  std::vector<MiInfo> mi;
  std::vector<uint8_t> above[3], left[3], lf[3], types;
  uint8_t decoded[3][34][34];
  int8_t cdef = -1;

  // the rectangle of 4x4 units (x4, y4, w, h) of plane p
  void rect(const State& s, int p, int* x4, int* y4, int* w, int* h) const {
    const int sx = s.sub_x(p), sy = s.sub_y(p);
    *x4 = c >> sx;
    *y4 = r >> sy;
    *w = std::max(1, w4 >> sx);
    *h = std::max(1, h4 >> sy);
  }
  void save(State& s, int r0, int c0, int bsize) {
    r = r0;
    c = c0;
    w4 = kNum4x4W[bsize];
    h4 = kNum4x4H[bsize];
    for (int p = 0; p < s.planes; p++) {
      int x4, y4, w, h;
      rect(s, p, &x4, &y4, &w, &h);
      px[p].resize(static_cast<size_t>(w) * h * 16);
      for (int y = 0; y < 4 * h; y++)
        std::memcpy(px[p].data() + static_cast<size_t>(y) * 4 * w,
                    s.px(p, 4 * y4 + y, 4 * x4), 4 * w * sizeof(uint16_t));
      above[p].resize(2 * w);
      left[p].resize(2 * h);
      for (int i = 0; i < w; i++) {
        above[p][2 * i] = s.above_level[p][x4 + i];
        above[p][2 * i + 1] = s.above_dc[p][x4 + i];
      }
      for (int i = 0; i < h; i++) {
        left[p][2 * i] = s.left_level[p][y4 + i];
        left[p][2 * i + 1] = s.left_dc[p][y4 + i];
      }
      lf[p].resize(static_cast<size_t>(w) * h);
      for (int y = 0; y < h; y++)
        std::memcpy(lf[p].data() + y * w,
                    s.lf_tx[p].data() + static_cast<size_t>(y4 + y) * s.lf_cols[p] + x4, w);
    }
    types.resize(static_cast<size_t>(w4) * h4);
    for (int y = 0; y < h4; y++)
      std::memcpy(types.data() + y * w4,
                  s.tx_types.data() + static_cast<size_t>(r + y) * s.lf_cols[0] + c, w4);
    const int mh = std::min(h4, s.mi_rows - r), mw = std::min(w4, s.mi_cols - c);
    mi.resize(static_cast<size_t>(mw) * mh);
    for (int y = 0; y < mh; y++)
      for (int x = 0; x < mw; x++) mi[y * mw + x] = s.at(r + y, c + x);
    std::memcpy(decoded, s.block_decoded, sizeof(decoded));
    cdef = s.cdef_idx[static_cast<size_t>(r >> 4) * s.cdef_cols + (c >> 4)];
  }
  void restore(State& s) const {
    for (int p = 0; p < s.planes; p++) {
      int x4, y4, w, h;
      rect(s, p, &x4, &y4, &w, &h);
      for (int y = 0; y < 4 * h; y++)
        std::memcpy(s.px(p, 4 * y4 + y, 4 * x4),
                    px[p].data() + static_cast<size_t>(y) * 4 * w, 4 * w * sizeof(uint16_t));
      for (int i = 0; i < w; i++) {
        s.above_level[p][x4 + i] = above[p][2 * i];
        s.above_dc[p][x4 + i] = above[p][2 * i + 1];
      }
      for (int i = 0; i < h; i++) {
        s.left_level[p][y4 + i] = left[p][2 * i];
        s.left_dc[p][y4 + i] = left[p][2 * i + 1];
      }
      for (int y = 0; y < h; y++)
        std::memcpy(s.lf_tx[p].data() + static_cast<size_t>(y4 + y) * s.lf_cols[p] + x4,
                    lf[p].data() + y * w, w);
    }
    for (int y = 0; y < h4; y++)
      std::memcpy(s.tx_types.data() + static_cast<size_t>(r + y) * s.lf_cols[0] + c,
                  types.data() + y * w4, w4);
    const int mh = std::min(h4, s.mi_rows - r), mw = std::min(w4, s.mi_cols - c);
    for (int y = 0; y < mh; y++)
      for (int x = 0; x < mw; x++) s.at(r + y, c + x) = mi[y * mw + x];
    std::memcpy(s.block_decoded, decoded, sizeof(decoded));
    s.cdef_idx[static_cast<size_t>(r >> 4) * s.cdef_cols + (c >> 4)] = cdef;
  }
};

// the 4x4 Hadamard SATD of a - b over w x h (multiples of 4)
int64_t satd(const Source& src, int plane, const State& s, int x0, int y0, int w,
             int h) {
  int64_t total = 0;
  const int vw = src.w[plane], vh = src.h[plane];
  for (int by = y0; by < y0 + h; by += 4)
    for (int bx = x0; bx < x0 + w; bx += 4) {
      if (by >= vh || bx >= vw) continue;
      int d[16];
      for (int i = 0; i < 4; i++) {
        const uint16_t* pr = const_cast<State&>(s).px(plane, by + i, bx);
        for (int j = 0; j < 4; j++) d[i * 4 + j] = src.at(plane, by + i, bx + j) - pr[j];
      }
      for (int i = 0; i < 4; i++) {
        int* v = d + 4 * i;
        const int a = v[0] + v[1], b = v[0] - v[1], c = v[2] + v[3], e = v[2] - v[3];
        v[0] = a + c;
        v[1] = b + e;
        v[2] = a - c;
        v[3] = b - e;
      }
      for (int j = 0; j < 4; j++) {
        const int a = d[j] + d[4 + j], b = d[j] - d[4 + j];
        const int c = d[8 + j] + d[12 + j], e = d[8 + j] - d[12 + j];
        total += std::abs(a + c) + std::abs(b + e) + std::abs(a - c) + std::abs(b - e);
      }
    }
  return total >> 1;
}

class Av1Encoder : public Encoder {
 public:
  Av1Encoder(State& s, const Source& src) : s_(s), src_(src) {
    const int n = s.mi_rows * s.mi_cols;
    for (auto& p : part_) p.assign(n, PARTITION_NONE);
    choice_.assign(n, Choice());
    sb_cols_ = (s.mi_cols + 15) >> 4;
    sb_q_.assign(static_cast<size_t>(sb_cols_) * ((s.mi_rows + 15) >> 4), s.fh->base_q_idx);
  }

  // the superblock's qindex (variance_boost) and the lambda of its
  // quantizer: the search runs at both
  void start(int r, int c) {
    const int q = sb_q_[static_cast<size_t>(r >> 4) * sb_cols_ + (c >> 4)] =
        variance_boost(r, c);
    s_.current_qindex = q;
    s_.read_deltas = false;
    // lambda per bit on squared error: a fifth of the DC step in pixels
    // (dc_q / 8), squared
    const int dc_q = kDcQlookup[0][q];
    lambda_ = std::max<int64_t>(1, int64_t{dc_q} * dc_q / 5 / 64);
  }

  int superblock_qindex(State& s, int r, int c) override {
    (void)s;
    return sb_q_[static_cast<size_t>(r >> 4) * sb_cols_ + (c >> 4)];
  }

  int partition(State& s, int r, int c, int bsize) override {
    const int half = kNum4x4W[bsize] >> 1;
    if (r + half >= s.mi_rows || c + half >= s.mi_cols) return PARTITION_SPLIT;
    return part_[kMiWidthLog2[bsize]][r * s.mi_cols + c];
  }

  void mode_info(State& s) override {
    const Choice& ch = choice_[s.mi_row * s.mi_cols + s.mi_col];
    s.skip = 0;
    s.y_mode = ch.y_mode;
    s.uv_mode = ch.uv_mode;
    s.angle_y = s.angle_uv = 0;
    s.use_filter_intra = false;
  }

  int quantize(State& s, int plane, int x, int y, int tx, int type,
               int32_t* coef) override {
    const int lw = kTxWidthLog2[tx], lh = kTxHeightLog2[tx];
    const int w = 1 << lw, h = 1 << lh;
    const int tw = std::min(w, 32), th = std::min(h, 32);
    if (type < 0) type = DCT_DCT;  // luma
    static thread_local int32_t r[64 * 64];
    for (int i = 0; i < h; i++) {
      const uint16_t* pr = s.px(plane, y + i, x);
      for (int j = 0; j < w; j++) r[i * w + j] = src_.at(plane, y + i, x + j) - pr[j];
    }
    static thread_local int64_t d[32 * 32];
    forward_2d(r, tx, type, d);
    int steps[32 * 32], shift;
    quantizer_steps(s, plane, tx, type, steps, &shift);
    for (int i = 0; i < th; i++)
      for (int j = 0; j < tw; j++) {
        const int k = i * tw + j;
        const int64_t a = std::abs(d[k]) << shift;
        // DC rounded to the nearest level, AC with a dead zone (rounding
        // at 0.4 of the step)
        const int64_t round = k == 0 ? steps[k] / 2 : steps[k] * 2 / 5;
        const int64_t level = std::min<int64_t>((a + round) / steps[k], (1 << 19));
        coef[k] = static_cast<int32_t>(d[k] < 0 ? -level : level);
      }
    return type;
  }

  // the partition tree and modes of the superblock at (r, c): the state is
  // left as after coding the chosen tree (with a counting writer)
  void search_superblock(int r, int c) { search(r, c, s_.sb_size); }

 private:
  int64_t sse(int r, int c, int bsize) {
    int64_t total = 0;
    for (int p = 0; p < s_.planes; p++) {
      const int sx = s_.sub_x(p), sy = s_.sub_y(p);
      const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy;
      const int x1 = std::min(src_.w[p], x0 + std::max(4, (kNum4x4W[bsize] * 4) >> sx));
      const int y1 = std::min(src_.h[p], y0 + std::max(4, (kNum4x4H[bsize] * 4) >> sy));
      for (int y = y0; y < y1; y++) {
        const uint16_t* pr = s_.px(p, y, 0);
        for (int x = x0; x < x1; x++) {
          const int e = src_.at(p, y, x) - pr[x];
          total += e * e;
        }
      }
    }
    return total;
  }

  // the cost of coding the block at (r, c) as decided: lambda-weighted bits
  // plus 256 x the squared error
  int64_t trial(int r, int c, int bsize) {
    SymbolWriter* sw = s_.sw;
    sw->reset_cost();
    code_partition(s_, r, c, bsize);
    return lambda_ * sw->cost() + 256 * sse(r, c, bsize);
  }

  int64_t mode_cost(uint16_t* cdf, int v) {
    return symbol_cost((v > 0 ? cdf[v - 1] : 32768) - cdf[v]);
  }

  // the modes of the block at (r, c) coded whole (PARTITION_NONE) into
  // choice_: the luma mode of least SATD plus lambda-weighted symbol cost,
  // then the chroma mode so; the state is left as set up for the block
  void choose_modes(int r, int c, int bsize) {
    setup_block(s_, r, c, bsize);
    s_.angle_y = s_.angle_uv = 0;
    s_.use_filter_intra = false;
    const int bw = kNum4x4W[bsize] * 4, bh = kNum4x4H[bsize] * 4;
    const int above = s_.avail_u ? s_.at(r - 1, c).y_mode : DC_PRED;
    const int left = s_.avail_l ? s_.at(r, c - 1).y_mode : DC_PRED;
    uint16_t* ycdf = s_.cdf.kf_y_mode[kIntraModeContext[above]][kIntraModeContext[left]];
    const int64_t lsad = isqrt(lambda_);
    const int ytx = plane_tx_size(s_, 0);
    Choice& ch = choice_[r * s_.mi_cols + c];
    int64_t best = INT64_MAX;
    for (int m = 0; m < 13; m++) {
      predict_transform_block(s_, 0, ytx, m);
      const int64_t score =
          256 * satd(src_, 0, s_, c * 4, r * 4, bw, bh) + lsad * mode_cost(ycdf, m);
      if (score < best) {
        best = score;
        ch.y_mode = static_cast<uint8_t>(m);
      }
    }
    s_.y_mode = ch.y_mode;
    const int uvtx = plane_tx_size(s_, 1);
    uint16_t* uvcdf = std::max(bw, bh) <= 32 ? s_.cdf.uv_mode_cfl_allowed[ch.y_mode]
                                             : s_.cdf.uv_mode_cfl_not_allowed[ch.y_mode];
    best = INT64_MAX;
    for (int m = 0; m < 13; m++) {
      int64_t score = lsad * mode_cost(uvcdf, m);
      for (int p = 1; p < 3; p++) {
        predict_transform_block(s_, p, uvtx, m);
        score += 256 * satd(src_, p, s_, (c * 4) >> 1, (r * 4) >> 1,
                            std::max(4, bw >> 1), std::max(4, bh >> 1));
      }
      if (score < best) {
        best = score;
        ch.uv_mode = static_cast<uint8_t>(m);
      }
    }
  }

  static int64_t isqrt(int64_t v) {
    int64_t x = 0;
    while ((x + 1) * (x + 1) <= v) x++;
    return x;
  }

  // the cost of the best tree of the block at (r, c), the state left as
  // after coding it: the block coded whole against its four quarters
  // searched alike (split at the frame's edges, where the symbol costs the
  // same either way)
  int64_t search(int r, int c, int bsize) {
    if (r >= s_.mi_rows || c >= s_.mi_cols) return 0;
    const int bsl = kMiWidthLog2[bsize], half = kNum4x4W[bsize] >> 1;
    const int sub = kSubsize[PARTITION_SPLIT][bsl];
    const int rs[4] = {r, r, r + half, r + half}, cs[4] = {c, c + half, c, c + half};
    if (r + half >= s_.mi_rows || c + half >= s_.mi_cols) {
      int64_t j = 0;
      for (int k = 0; k < 4; k++) j += search(rs[k], cs[k], sub);
      return j;
    }
    const int idx = r * s_.mi_cols + c;
    part_[bsl][idx] = PARTITION_NONE;
    Snapshot snap;
    snap.save(s_, r, c, bsize);
    choose_modes(r, c, bsize);
    const Choice none = choice_[idx];
    snap.restore(s_);
    const int64_t j_none = trial(r, c, bsize);
    if (bsize == BLOCK_8X8) return j_none;
    snap.restore(s_);
    int n;
    int64_t j_split = lambda_ * mode_cost(partition_cdf(s_, r, c, bsize, &n), PARTITION_SPLIT);
    for (int k = 0; k < 4 && j_split < j_none; k++) j_split += search(rs[k], cs[k], sub);
    if (j_split < j_none) {
      part_[bsl][idx] = PARTITION_SPLIT;
      return j_split;
    }
    snap.restore(s_);
    part_[bsl][idx] = PARTITION_NONE;
    choice_[idx] = none;
    return trial(r, c, bsize);
  }

  // libaom's variance boost in its still-picture form: the 8x8 luma
  // variances of the superblock (in the frame, the picture's edge
  // repeated) sorted, the one at five eighths taken; a quantizer step
  // smaller by 1 + 0.45 (10 - log2 variance) where that is over 1, as a
  // qindex offset of at most 35 below the frame's, to a multiple of 4
  int variance_boost(int r, int c) const {
    const int base = s_.fh->base_q_idx;
    std::vector<int64_t> v;
    for (int y = r * 4; y < std::min(r * 4 + 64, s_.mi_rows * 4); y += 8)
      for (int x = c * 4; x < std::min(c * 4 + 64, s_.mi_cols * 4); x += 8) {
        int64_t sum = 0, sq = 0;
        for (int i = 0; i < 8; i++)
          for (int j = 0; j < 8; j++) {
            const int p = src_.at(0, y + i, x + j);
            sum += p;
            sq += p * p;
          }
        v.push_back((sq - (sum * sum >> 6)) >> 6);
      }
    std::sort(v.begin(), v.end());
    const int64_t var = std::max<int64_t>(1, v[v.size() * 5 / 8]);
    // 256 log2(var), by repeated squaring
    int k = 0;
    while ((var >> (k + 1)) > 0) k++;
    uint64_t x = static_cast<uint64_t>(var) << (16 - std::min(k, 16)) >> std::max(k - 16, 0);
    int frac = 0;
    for (int i = 0; i < 8; i++) {
      x = (x * x) >> 16;
      frac <<= 1;
      if (x >= (1u << 17)) {
        x >>= 1;
        frac |= 1;
      }
    }
    const int log2_q8 = (k << 8) | frac;
    const int ratio_q8 = 256 + 115 * (10 * 256 - log2_q8) / 256;
    if (ratio_q8 <= 256) return base;
    const int target = kDcQlookup[0][base] * 256 / ratio_q8;
    int q = base;
    while (q > base - 35 && kDcQlookup[0][q] > target) q--;
    const int off = q - base;  // to the nearest multiple of 4
    return base - ((-off + 2) / 4) * 4;
  }

  State& s_;
  const Source& src_;
  std::vector<uint8_t> part_[6];
  std::vector<Choice> choice_;
  std::vector<int> sb_q_;
  int sb_cols_ = 0;
  int64_t lambda_ = 1;
};

// ------------------------------------------------------------ headers

int tile_log2(int blk, int target) {
  int k = 0;
  while ((blk << k) < target) k++;
  return k;
}

// cv2's frame: its quantizer, loop filter, CDEF and tiles (see the file's
// head)
void frame_params(int w, int h, FrameHeader* fh) {
  fh->width = w;
  fh->height = h;
  fh->mi_cols = 2 * ((w + 7) >> 3);
  fh->mi_rows = 2 * ((h + 7) >> 3);
  fh->base_q_idx = 148;
  const int dq[5] = {0, -16, -16, -16, -16};
  std::memcpy(fh->delta_q, dq, sizeof(dq));
  fh->using_qmatrix = true;
  fh->qm[0] = fh->qm[1] = fh->qm[2] = 8;
  fh->lossless = false;
  fh->delta_q_present = true;
  fh->delta_q_res = 2;
  fh->lf_level[0] = fh->lf_level[1] = fh->lf_level[2] = fh->lf_level[3] = 15;
  fh->lf_sharpness = 1;
  fh->lf_delta_enabled = true;
  fh->cdef = true;
  fh->cdef_damping = 5;
  fh->cdef_bits = 0;
  fh->cdef_y_pri[0] = 2;
  fh->cdef_y_sec[0] = 1;
  fh->cdef_uv_pri[0] = 0;
  fh->cdef_uv_sec[0] = 0;
  fh->tx_mode_select = false;
  fh->reduced_tx_set = false;
  // tile_info as libaom writes it: uniform spacing, the fewest tiles
  // MaxTileWidthSb (64) and MaxTileAreaSb (2304) allow
  const int sb_cols = (fh->mi_cols + 15) >> 4, sb_rows = (fh->mi_rows + 15) >> 4;
  const int min_cols = tile_log2(64, sb_cols);
  const int min_tiles = std::max(min_cols, tile_log2(2304, sb_rows * sb_cols));
  fh->tile_cols_log2 = min_cols;
  fh->tile_rows_log2 = std::max(min_tiles - min_cols, 0);
  const int tw = (sb_cols + (1 << fh->tile_cols_log2) - 1) >> fh->tile_cols_log2;
  const int th = (sb_rows + (1 << fh->tile_rows_log2) - 1) >> fh->tile_rows_log2;
  fh->mi_col_starts.clear();
  fh->mi_row_starts.clear();
  for (int start = 0; start < sb_cols; start += tw) fh->mi_col_starts.push_back(start << 4);
  for (int start = 0; start < sb_rows; start += th) fh->mi_row_starts.push_back(start << 4);
  fh->tile_cols = static_cast<int>(fh->mi_col_starts.size());
  fh->tile_rows = static_cast<int>(fh->mi_row_starts.size());
  fh->mi_col_starts.push_back(fh->mi_cols);
  fh->mi_row_starts.push_back(fh->mi_rows);
}

void sequence_params(int w, int h, SequenceHeader* s) {
  s->profile = 0;
  s->reduced = true;
  s->frame_width_bits = bits_for(static_cast<uint32_t>(w - 1));
  s->frame_height_bits = bits_for(static_cast<uint32_t>(h - 1));
  s->max_width = w;
  s->max_height = h;
  s->sb128 = false;
  s->filter_intra = true;
  s->intra_edge_filter = true;
  s->enable_cdef = true;
  s->enable_restoration = false;
  s->bit_depth = 8;
  s->mono = false;
  s->matrix = 6;
  s->full_range = true;
  s->ssx = s->ssy = 1;
}

std::vector<uint8_t> sequence_header(const SequenceHeader& s) {
  BitWriter b;
  b.f(3, 0);  // seq_profile
  b.f(1, 1);  // still_picture
  b.f(1, 1);  // reduced_still_picture_header
  b.f(5, level_of(s.max_width, s.max_height));
  b.f(4, s.frame_width_bits - 1);
  b.f(4, s.frame_height_bits - 1);
  b.f(s.frame_width_bits, s.max_width - 1);
  b.f(s.frame_height_bits, s.max_height - 1);
  b.f(1, 0);  // use_128x128_superblock
  b.f(1, 1);  // enable_filter_intra
  b.f(1, 1);  // enable_intra_edge_filter
  b.f(1, 0);  // enable_superres
  b.f(1, 1);  // enable_cdef
  b.f(1, 0);  // enable_restoration
  b.f(1, 0);  // high_bitdepth
  b.f(1, 0);  // mono_chrome
  b.f(1, 1);  // color_description_present_flag
  b.f(8, 1);  // BT.709 primaries
  b.f(8, 13);  // sRGB transfer
  b.f(8, 6);  // BT.601 matrix
  b.f(1, 1);  // color_range: full
  b.f(2, 0);  // chroma_sample_position
  b.f(1, 0);  // separate_uv_delta_q
  b.f(1, 0);  // film_grain_params_present
  b.trailing();
  return b.out;
}

// the uncompressed header of the key frame, byte-aligned (a frame OBU's
// header, its tile group following)
std::vector<uint8_t> frame_header(const FrameHeader& fh) {
  BitWriter b;
  b.f(1, 0);  // disable_cdf_update
  b.f(1, 0);  // allow_screen_content_tools
  b.f(1, 0);  // render_and_frame_size_different
  // tile_info: uniform spacing at frame_params' log2 sizes, no increment
  const int sb_cols = (fh.mi_cols + 15) >> 4, sb_rows = (fh.mi_rows + 15) >> 4;
  b.f(1, 1);
  if (fh.tile_cols_log2 < tile_log2(1, std::min(sb_cols, 64))) b.f(1, 0);
  if (fh.tile_rows_log2 < tile_log2(1, std::min(sb_rows, 64))) b.f(1, 0);
  if (fh.tile_cols_log2 || fh.tile_rows_log2) {
    b.f(fh.tile_cols_log2 + fh.tile_rows_log2, fh.context_update_tile_id);
    b.f(2, fh.tile_size_bytes - 1);
  }
  b.f(8, fh.base_q_idx);
  b.f(1, 0);  // DeltaQYDc
  for (int i = 1; i < 3; i++) {  // DeltaQUDc, DeltaQUAc
    b.f(1, 1);
    b.su(7, fh.delta_q[i]);
  }
  b.f(1, 1);  // using_qmatrix
  b.f(4, fh.qm[0]);
  b.f(4, fh.qm[1]);
  b.f(1, 0);  // segmentation_enabled
  b.f(1, 1);  // delta_q_present
  b.f(2, fh.delta_q_res);
  b.f(1, 0);  // delta_lf_present
  for (int i = 0; i < 4; i++) b.f(6, fh.lf_level[i]);
  b.f(3, fh.lf_sharpness);
  b.f(1, 1);  // loop_filter_delta_enabled
  b.f(1, 0);  // loop_filter_delta_update
  b.f(2, fh.cdef_damping - 3);
  b.f(2, fh.cdef_bits);
  b.f(4, fh.cdef_y_pri[0]);
  b.f(2, fh.cdef_y_sec[0]);
  b.f(4, fh.cdef_uv_pri[0]);
  b.f(2, fh.cdef_uv_sec[0]);
  b.f(1, 0);  // tx_mode_select: TX_MODE_LARGEST
  b.f(1, 0);  // reduced_tx_set
  b.byte_align();
  return b.out;
}

}  // namespace

void encode_picture(const uint8_t* rgb, int h, int w, std::vector<uint8_t>* obus,
                    Planes* recon) {
  struct TallyOff {  // the decoder's code counts nothing while it encodes
    bool was = t_tally;
    TallyOff() { t_tally = false; }
    ~TallyOff() { t_tally = was; }
  } off;
  SequenceHeader seq;
  sequence_params(w, h, &seq);
  FrameHeader fh;
  frame_params(w, h, &fh);
  std::unique_ptr<State> owner(new State());
  State& s = *owner;
  init_frame(s, seq, fh);
  Source src;
  to_yuv(rgb, h, w, s, &src);
  Av1Encoder enc(s, src);
  const int num_tiles = fh.tile_cols * fh.tile_rows;
  // the search, counting, leaves its decisions in enc; each tile from its
  // own start, as the decoder takes it
  SymbolWriter counter;
  counter.init(false, true);
  s.sw = &counter;
  s.enc = &enc;
  for (int tile = 0; tile < num_tiles; tile++) {
    start_tile(s, tile);
    for (int r = s.mi_row_start; r < s.mi_row_end; r += s.sb4) {
      start_sb_row(s);
      for (int c = s.mi_col_start; c < s.mi_col_end; c += s.sb4) {
        start_superblock(s, r, c);
        enc.start(r, c);
        enc.search_superblock(r, c);
      }
    }
  }
  // each tile written from a fresh state by the same decisions, with its
  // own symbol writer
  std::unique_ptr<State> fresh(new State());
  State& t = *fresh;
  init_frame(t, seq, fh);
  t.enc = &enc;
  std::vector<std::vector<uint8_t>> tiles(num_tiles);
  for (int tile = 0; tile < num_tiles; tile++) {
    start_tile(t, tile);
    SymbolWriter writer;
    writer.init(fh.disable_cdf_update, false);
    t.sw = &writer;
    for (int r = t.mi_row_start; r < t.mi_row_end; r += t.sb4) {
      start_sb_row(t);
      for (int c = t.mi_col_start; c < t.mi_col_end; c += t.sb4) {
        start_superblock(t, r, c);
        code_partition(t, r, c, t.sb_size);
      }
    }
    tiles[tile] = writer.finish();
  }
  t.sw = nullptr;
  t.enc = nullptr;
  filter_frame(t, kFiltersAll);
  if (recon) take_planes(t, recon);
  // libaom's tile sizes: context_update_tile_id the (first) largest tile,
  // TileSizeBytes the fewest bytes that hold the largest tile's size
  size_t largest = 0;
  for (int tile = 0; tile < num_tiles; tile++)
    if (tiles[tile].size() > largest) {
      largest = tiles[tile].size();
      fh.context_update_tile_id = tile;
    }
  fh.tile_size_bytes = largest >> 24 ? 4 : largest >> 16 ? 3 : largest >> 8 ? 2 : 1;
  obus->clear();
  obu(obus, 2, {});  // temporal delimiter
  obu(obus, 1, sequence_header(seq));
  std::vector<uint8_t> frame = frame_header(fh);
  if (num_tiles > 1) {  // tile_start_and_end_present_flag 0, byte-aligned
    frame.push_back(0);
  }
  for (int tile = 0; tile < num_tiles; tile++) {
    if (tile != num_tiles - 1)
      for (int i = 0; i < fh.tile_size_bytes; i++)
        frame.push_back(static_cast<uint8_t>((tiles[tile].size() - 1) >> (8 * i)));
    frame.insert(frame.end(), tiles[tile].begin(), tiles[tile].end());
  }
  obu(obus, 6, frame);
}

}  // namespace av1
}  // namespace sdt
