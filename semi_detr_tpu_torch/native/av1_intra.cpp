// The tile syntax of an AV1 key frame: the superblock loop (5.11.2),
// partitions (5.11.4), intra frame mode info (5.11.7) with CDEF indices,
// delta q (5.11.56, 5.11.11), palette (5.11.46, 5.11.49, 7.11.4's color
// context) and intra block copy (its reference vector stack, 7.10.2, and
// the vector, 5.11.32), the transform size (5.11.15-16) and type
// (5.11.47), the coefficients of every transform size (5.11.39) at 4:4:4,
// 4:2:0 or monochrome, and the loop restoration units (5.11.57-58). A
// lossless frame's every transform is the 4x4 Walsh-Hadamard one and no
// transform type is coded. decode_picture then runs the in-loop filters.
#include <algorithm>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <string>

#include "av1_state.h"
#include "av1_tables.h"

namespace sdt {
namespace av1 {

namespace {

inline bool directional(int mode) { return mode >= V_PRED && mode <= D67_PRED; }

// a symbol (literal) of the tile: read, or v written when encoding
inline int sym(State& s, uint16_t* cdf, int n, int v) {
  if (!s.sw) return s.sr.symbol(cdf, n);
  s.sw->symbol(cdf, n, v);
  return v;
}
inline int lit(State& s, int bits, int v) {
  if (!s.sw) return s.sr.literal(bits);
  s.sw->literal(bits, v);
  return v;
}

// ------------------------------------------------------------ palette

int palette_cache(State& s, int plane, uint16_t* cache) {
  int above_n = 0, left_n = 0;
  if (((s.mi_row * 4) % 64) && s.avail_u)
    above_n = s.at(s.mi_row - 1, s.mi_col).palette_size[plane];
  if (s.avail_l) left_n = s.at(s.mi_row, s.mi_col - 1).palette_size[plane];
  const uint16_t* above = above_n ? s.at(s.mi_row - 1, s.mi_col).palette[plane] : nullptr;
  const uint16_t* left = left_n ? s.at(s.mi_row, s.mi_col - 1).palette[plane] : nullptr;
  int ai = 0, li = 0, n = 0;
  while (ai < above_n && li < left_n) {
    const uint16_t a = above[ai], l = left[li];
    if (l < a) {
      if (n == 0 || l != cache[n - 1]) cache[n++] = l;
      li++;
    } else {
      if (n == 0 || a != cache[n - 1]) cache[n++] = a;
      ai++;
      if (l == a) li++;
    }
  }
  for (; ai < above_n; ai++)
    if (n == 0 || above[ai] != cache[n - 1]) cache[n++] = above[ai];
  for (; li < left_n; li++)
    if (n == 0 || left[li] != cache[n - 1]) cache[n++] = left[li];
  if (n) count(kToolPaletteCache);
  return n;
}

int ceil_log2(int x) {
  if (x < 2) return 0;
  int i = 1, p = 2;
  while (p < x) {
    i++;
    p <<= 1;
  }
  return i;
}

// the colours of the y (plane 0) or u (plane 1) palette: from the cache,
// then a literal and ascending deltas; sorted
void palette_colors(State& s, int plane, int n) {
  SymbolReader& sr = s.sr;
  const int bd = s.bit_depth;
  uint16_t cache[16];
  const int cache_n = palette_cache(s, plane, cache);
  uint16_t* colors = s.palette[plane];
  int idx = 0;
  for (int i = 0; i < cache_n && idx < n; i++)
    if (sr.literal(1)) colors[idx++] = cache[i];
  if (idx < n) {
    colors[idx++] = static_cast<uint16_t>(sr.literal(bd));
    if (idx < n) {
      int bits = bd - 3 + sr.literal(2);
      int range = (1 << bd) - colors[idx - 1] - (plane == 0 ? 1 : 0);
      for (; idx < n; idx++) {
        const int delta = sr.literal(bits) + (plane == 0 ? 1 : 0);
        colors[idx] = static_cast<uint16_t>(
            std::min(colors[idx - 1] + delta, (1 << bd) - 1));
        range -= colors[idx] - colors[idx - 1];
        bits = std::min(bits, ceil_log2(range));
      }
    }
  }
  std::sort(colors, colors + n);
}

void palette_mode_info(State& s) {
  SymbolReader& sr = s.sr;
  const int bsize_ctx = kMiWidthLog2[s.mi_size] + kMiHeightLog2[s.mi_size] - 2;
  if (s.y_mode == DC_PRED) {
    const int ctx =
        (s.avail_u && s.at(s.mi_row - 1, s.mi_col).palette_size[0] > 0) +
        (s.avail_l && s.at(s.mi_row, s.mi_col - 1).palette_size[0] > 0);
    if (sr.symbol(s.cdf.palette_y_mode[bsize_ctx][ctx], 2)) {
      s.palette_size_y = sr.symbol(s.cdf.palette_y_size[bsize_ctx], 7) + 2;
      palette_colors(s, 0, s.palette_size_y);
      count(kToolPaletteY);
    }
  }
  if (s.has_chroma && s.uv_mode == DC_PRED) {
    if (sr.symbol(s.cdf.palette_uv_mode[s.palette_size_y > 0], 2)) {
      const int n = s.palette_size_uv =
          sr.symbol(s.cdf.palette_uv_size[bsize_ctx], 7) + 2;
      palette_colors(s, 1, n);
      uint16_t* v = s.palette[2];
      const int bd = s.bit_depth;
      if (sr.literal(1)) {  // delta_encode_palette_colors_v
        count(kToolPaletteDeltaV);
        const int max_val = 1 << bd;
        const int bits = bd - 4 + sr.literal(2);
        v[0] = static_cast<uint16_t>(sr.literal(bd));
        for (int idx = 1; idx < n; idx++) {
          int delta = sr.literal(bits);
          if (delta && sr.literal(1)) delta = -delta;
          int val = v[idx - 1] + delta;
          if (val < 0) val += max_val;
          if (val >= max_val) val -= max_val;
          v[idx] = static_cast<uint16_t>(std::min(std::max(val, 0), max_val - 1));
        }
      } else {
        for (int idx = 0; idx < n; idx++)
          v[idx] = static_cast<uint16_t>(sr.literal(bd));
      }
      count(kToolPaletteUV);
    }
  }
}

// 7.11.4 get_palette_color_context, and the color index map in wavefront
// order (5.11.49)
void color_map(State& s, uint8_t (*map)[64], int n, uint16_t (*cdfs)[9],
               int block_w, int block_h, int onscreen_w, int onscreen_h) {
  SymbolReader& sr = s.sr;
  map[0][0] = static_cast<uint8_t>(sr.ns(n));
  for (int i = 1; i < onscreen_h + onscreen_w - 1; i++) {
    for (int j = std::min(i, onscreen_w - 1); j >= std::max(0, i - onscreen_h + 1); j--) {
      const int r = i - j, c = j;
      int scores[8] = {}, order[8] = {0, 1, 2, 3, 4, 5, 6, 7};
      if (c > 0) scores[map[r][c - 1]] += 2;
      if (r > 0 && c > 0) scores[map[r - 1][c - 1]] += 1;
      if (r > 0) scores[map[r - 1][c]] += 2;
      for (int a = 0; a < 3; a++) {
        int max_score = scores[a], max_idx = a;
        for (int b = a + 1; b < n; b++)
          if (scores[b] > max_score) {
            max_score = scores[b];
            max_idx = b;
          }
        if (max_idx != a) {
          const int ms = scores[max_idx], mo = order[max_idx];
          for (int k = max_idx; k > a; k--) {
            scores[k] = scores[k - 1];
            order[k] = order[k - 1];
          }
          scores[a] = ms;
          order[a] = mo;
        }
      }
      const int hash = scores[0] * kPaletteColorHashMultipliers[0] +
                       scores[1] * kPaletteColorHashMultipliers[1] +
                       scores[2] * kPaletteColorHashMultipliers[2];
      const int ctx = kPaletteColorContext[hash];
      if (ctx < 0) corrupt("AV1 palette colour context out of range");
      map[r][c] = static_cast<uint8_t>(order[sr.symbol(cdfs[ctx], n)]);
    }
  }
  for (int i = 0; i < onscreen_h; i++)
    for (int j = onscreen_w; j < block_w; j++) map[i][j] = map[i][onscreen_w - 1];
  for (int i = onscreen_h; i < block_h; i++)
    for (int j = 0; j < block_w; j++) map[i][j] = map[onscreen_h - 1][j];
}

void palette_tokens(State& s) {
  const int bh = kNum4x4H[s.mi_size] * 4, bw = kNum4x4W[s.mi_size] * 4;
  const int on_h = std::min(bh, (s.mi_rows - s.mi_row) * 4);
  const int on_w = std::min(bw, (s.mi_cols - s.mi_col) * 4);
  if (on_h < bh || on_w < bw) count(kToolFrameEdge);
  if (s.palette_size_y)
    color_map(s, s.color_map_y, s.palette_size_y,
              s.cdf.palette_y_color[s.palette_size_y - 2], bw, bh, on_w, on_h);
  if (s.palette_size_uv) {
    // the chroma of a 16x4 or 4x16 block at 4:2:0 is 2 high (wide): its
    // map takes 2 more rows (columns)
    int cw = bw >> s.ssx, ch = bh >> s.ssy, con_w = on_w >> s.ssx, con_h = on_h >> s.ssy;
    if (cw < 4) {
      cw += 2;
      con_w += 2;
    }
    if (ch < 4) {
      ch += 2;
      con_h += 2;
    }
    color_map(s, s.color_map_uv, s.palette_size_uv,
              s.cdf.palette_uv_color[s.palette_size_uv - 2], cw, ch, con_w, con_h);
  }
}

// ------------------------------------------------------------ intra bc

struct MvStack {
  int n = 0;
  int mv[8][2];
  int weight[8];
};

void add_candidate(State& s, MvStack& st, int r, int c, int weight) {
  const MiInfo& m = s.at(r, c);
  if (!m.is_inter) return;  // only intra block copies in a key frame
  int cand[2] = {m.mv[0], m.mv[1]};
  for (int i = 0; i < 2; i++) {  // lower_mv_precision with force_integer_mv
    const int a = (std::abs(cand[i]) + 3) >> 3;
    cand[i] = cand[i] > 0 ? a << 3 : -(a << 3);
  }
  for (int i = 0; i < st.n; i++)
    if (st.mv[i][0] == cand[0] && st.mv[i][1] == cand[1]) {
      st.weight[i] += weight;
      return;
    }
  if (st.n < 8) {
    st.mv[st.n][0] = cand[0];
    st.mv[st.n][1] = cand[1];
    st.weight[st.n] = weight;
    st.n++;
  }
}

void scan_row(State& s, MvStack& st, int delta_row) {
  const int bw4 = kNum4x4W[s.mi_size];
  const int end4 = std::min(std::min(bw4, s.mi_cols - s.mi_col), 16);
  int delta_col = 0;
  const bool step16 = bw4 >= 16;
  if (std::abs(delta_row) > 1) {
    delta_row += s.mi_row & 1;
    delta_col = 1 - (s.mi_col & 1);
  }
  for (int i = 0; i < end4;) {
    const int r = s.mi_row + delta_row, c = s.mi_col + delta_col + i;
    if (!s.inside(r, c)) break;
    int len = std::min(bw4, static_cast<int>(kNum4x4W[s.at(r, c).size]));
    if (std::abs(delta_row) > 1) len = std::max(2, len);
    if (step16) len = std::max(4, len);
    add_candidate(s, st, r, c, len * 2);
    i += len;
  }
}

void scan_col(State& s, MvStack& st, int delta_col) {
  const int bh4 = kNum4x4H[s.mi_size];
  const int end4 = std::min(std::min(bh4, s.mi_rows - s.mi_row), 16);
  int delta_row = 0;
  const bool step16 = bh4 >= 16;
  if (std::abs(delta_col) > 1) {
    delta_row = 1 - (s.mi_row & 1);
    delta_col += s.mi_col & 1;
  }
  for (int i = 0; i < end4;) {
    const int r = s.mi_row + delta_row + i, c = s.mi_col + delta_col;
    if (!s.inside(r, c)) break;
    int len = std::min(bh4, static_cast<int>(kNum4x4H[s.at(r, c).size]));
    if (std::abs(delta_col) > 1) len = std::max(2, len);
    if (step16) len = std::max(4, len);
    add_candidate(s, st, r, c, len * 2);
    i += len;
  }
}

void scan_point(State& s, MvStack& st, int delta_row, int delta_col) {
  const int r = s.mi_row + delta_row, c = s.mi_col + delta_col;
  if (s.inside(r, c) && s.at(r, c).decoded) add_candidate(s, st, r, c, 4);
}

void sort_stack(MvStack& st, int start, int end) {
  while (end > start) {
    int new_end = start;
    for (int i = start + 1; i < end; i++)
      if (st.weight[i - 1] < st.weight[i]) {
        std::swap(st.weight[i - 1], st.weight[i]);
        std::swap(st.mv[i - 1][0], st.mv[i][0]);
        std::swap(st.mv[i - 1][1], st.mv[i][1]);
        new_end = i;
      }
    end = new_end;
  }
}

int mv_component(State& s, int comp) {
  SymbolReader& sr = s.sr;
  MvCdfs::Comp& c = s.cdf.mv[1].comp[comp];  // MV_INTRABC_CONTEXT
  const int sign = sr.symbol(c.sign, 2);
  const int cls = sr.symbol(c.classes, 11);
  int mag;
  if (cls == 0) {
    const int bit = sr.symbol(c.class0, 2);
    mag = ((bit << 3) | (3 << 1) | 1) + 1;  // force_integer_mv: fr 3, hp 1
  } else {
    int d = 0;
    for (int i = 0; i < cls; i++) d |= sr.symbol(c.bits[i], 2) << i;
    mag = (2 << (cls + 2)) + ((d << 3) | (3 << 1) | 1) + 1;
  }
  return sign ? -mag : mag;
}

// find_mv_stack (7.10.2) as a key frame's intra block copy uses it, then
// assign_mv and read_mv (5.11.26, 5.11.32)
void intrabc_vector(State& s) {
  const int bw4 = kNum4x4W[s.mi_size], bh4 = kNum4x4H[s.mi_size];
  MvStack st;
  scan_row(s, st, -1);
  scan_col(s, st, -1);
  if (std::max(bw4, bh4) <= 16) scan_point(s, st, -1, bw4);
  const int nearest = st.n;
  for (int i = 0; i < nearest; i++) st.weight[i] += 640;  // REF_CAT_LEVEL
  scan_point(s, st, -1, -1);
  scan_row(s, st, -3);
  scan_col(s, st, -3);
  if (bh4 > 1) scan_row(s, st, -5);
  if (bw4 > 1) scan_col(s, st, -5);
  sort_stack(st, 0, nearest);
  sort_stack(st, nearest, st.n);
  // extra_search finds nothing in a key frame: the global vector (0, 0)
  for (int i = st.n; i < 2; i++) st.mv[i][0] = st.mv[i][1] = 0;
  // context_and_clamping
  for (int i = 0; i < std::max(st.n, 2); i++) {
    const int top = -(s.mi_row * 4 * 8), left = -(s.mi_col * 4 * 8);
    const int bottom = (s.mi_rows - bh4 - s.mi_row) * 4 * 8;
    const int right = (s.mi_cols - bw4 - s.mi_col) * 4 * 8;
    const int border_r = 128 + bh4 * 4 * 8, border_c = 128 + bw4 * 4 * 8;
    st.mv[i][0] = std::min(std::max(st.mv[i][0], top - border_r), bottom + border_r);
    st.mv[i][1] = std::min(std::max(st.mv[i][1], left - border_c), right + border_c);
  }
  int pred[2] = {st.mv[0][0], st.mv[0][1]};
  if (pred[0] == 0 && pred[1] == 0) {
    pred[0] = st.mv[1][0];
    pred[1] = st.mv[1][1];
  }
  if (pred[0] == 0 && pred[1] == 0) {
    const int sb4 = s.sb4;
    if (s.mi_row - sb4 < s.mi_row_start) {
      pred[0] = 0;
      pred[1] = -(sb4 * 4 + 256) * 8;  // INTRABC_DELAY_PIXELS
    } else {
      pred[0] = -(sb4 * 4 * 8);
      pred[1] = 0;
    }
    count(kToolIntrabcDefaultDv);
  }
  for (int i = 0; i < 2; i++) pred[i] = (pred[i] >> 3) * 8;
  const int joint = s.sr.symbol(s.cdf.mv[1].joints, 4);
  int diff[2] = {0, 0};
  if (joint == 2 || joint == 3) diff[0] = mv_component(s, 0);
  if (joint == 1 || joint == 3) diff[1] = mv_component(s, 1);
  s.mv[0] = pred[0] + diff[0];
  s.mv[1] = pred[1] + diff[1];
  if ((s.mv[0] & 7) || (s.mv[1] & 7))
    corrupt("AV1 intra block copy vector of a fraction of a pixel");
}

// ------------------------------------------------------------ sizes

inline int tx_w(int tx) { return 1 << kTxWidthLog2[tx]; }
inline int tx_h(int tx) { return 1 << kTxHeightLog2[tx]; }

// Max_Tx_Size_Rect (by block size), Split_Tx_Size
constexpr int kMaxTxSizeRect[22] = {
    TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8, TX_16X16, TX_16X32,
    TX_32X16, TX_32X32, TX_32X64, TX_64X32, TX_64X64, TX_64X64, TX_64X64,
    TX_64X64, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16};
constexpr int kSplitTxSize[19] = {
    TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4,
    TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8,
    TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16};

// the block size of 2^wl x 2^hl 4x4 units (BLOCK_INVALID where none)
int block_of(int wl, int hl) {
  for (int b = 0; b < BLOCK_INVALID; b++)
    if (kMiWidthLog2[b] == wl && kMiHeightLog2[b] == hl) return b;
  return BLOCK_INVALID;
}

// get_plane_residual_size: the block's size in a plane
int plane_size(const State& s, int bsize, int plane) {
  if (!plane) return bsize;
  const int wl = std::max(0, kMiWidthLog2[bsize] - s.ssx);
  const int hl = std::max(0, kMiHeightLog2[bsize] - s.ssy);
  return block_of(wl, hl);
}

}  // namespace

// get_tx_size: the transform size of a plane (chroma at most 32 wide and
// high)
int plane_tx_size(const State& s, int plane) {
  if (!plane) return s.tx_size;
  const int uv = kMaxTxSizeRect[plane_size(s, s.mi_size, plane)];
  if (tx_w(uv) == 64 || tx_h(uv) == 64) {
    if (tx_w(uv) == 16) return TX_16X32;
    if (tx_h(uv) == 16) return TX_32X16;
    return TX_32X32;
  }
  return uv;
}

namespace {

int tx_sqr(int tx) { return std::min(kTxWidthLog2[tx], kTxHeightLog2[tx]) - 2; }
int tx_sqr_up(int tx) { return std::max(kTxWidthLog2[tx], kTxHeightLog2[tx]) - 2; }

// the transform class: 0 two-dimensional, 1 horizontal (H_*: a transform
// along rows only), 2 vertical (V_*)
int tx_class(int type) {
  if (type == V_DCT || type == V_ADST || type == V_FLIPADST) return 2;
  if (type == H_DCT || type == H_ADST || type == H_FLIPADST) return 1;
  return 0;
}

// get_tx_set for an intra block: 0 DCT only, 1 TX_SET_INTRA_1, 2
// TX_SET_INTRA_2
int tx_set(const State& s, int tx) {
  if (s.is_inter) {  // an intra block copy: 1 TX_SET_INTER_1 (all 16), 2
                     // _INTER_2, 3 _INTER_3 (DCT and the identity)
    if (tx_sqr_up(tx) > TX_32X32) return 0;
    if (s.fh->reduced_tx_set || tx_sqr_up(tx) == TX_32X32) return 3;
    return tx_sqr(tx) == TX_16X16 ? 2 : 1;
  }
  if (tx_sqr_up(tx) >= TX_32X32) return 0;
  if (s.fh->reduced_tx_set || tx_sqr(tx) == TX_16X16) return 2;
  return 1;
}

// is_tx_type_in_set
bool in_set(const State& s, int set, int type) {
  if (set == 0) return type == DCT_DCT;
  if (!s.is_inter) return true;  // the intra sets hold every Mode_To_Txfm type
  if (set == 3) return type == DCT_DCT || type == IDTX;
  return set == 1 || type <= H_DCT;
}

// Mode_To_Txfm, Filter_Intra_Mode_To_Intra_Dir, the inverse maps of the
// two intra sets
constexpr int kModeToTxfm[14] = {
    DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
constexpr int kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED,
                                               D157_PRED, DC_PRED};
constexpr int kTxTypeIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT,
                                        ADST_ADST, ADST_DCT, DCT_ADST};
constexpr int kTxTypeIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT,
                                        DCT_ADST};
constexpr int kTxTypeInterInvSet1[16] = {
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
    ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
constexpr int kTxTypeInterInvSet2[12] = {
    IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
    DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
constexpr int kTxTypeInterInvSet3[2] = {IDTX, DCT_DCT};

// ------------------------------------------------------------ mode info

// read_cdef (5.11.56): one index for each 64x64, read at its first coded
// block
void read_cdef(State& s) {
  if (s.skip || !s.fh->cdef) return;
  const int r = s.mi_row & ~15, c = s.mi_col & ~15;
  int8_t& idx = s.cdef_idx[static_cast<size_t>(r >> 4) * s.cdef_cols + (c >> 4)];
  if (idx == -1) idx = static_cast<int8_t>(lit(s, s.fh->cdef_bits, 0));
  // a 128x128 block sets the indices of every 64x64 it covers
  const int w4 = kNum4x4W[s.mi_size], h4 = kNum4x4H[s.mi_size];
  for (int y = r; y < r + h4; y += 16)
    for (int x = c; x < c + w4; x += 16)
      if ((y >> 4) < (s.mi_rows + 15) >> 4 && (x >> 4) < s.cdef_cols)
        s.cdef_idx[static_cast<size_t>(y >> 4) * s.cdef_cols + (x >> 4)] = idx;
}

// read_delta_qindex (5.11.11); encoding, the delta to the encoder's
// qindex of the superblock
void read_delta_qindex(State& s) {
  if (s.mi_size == s.sb_size && s.skip) return;
  if (!s.read_deltas) return;
  int want = 0;
  if (s.sw) {
    const int r = s.mi_row & ~(s.sb4 - 1), c = s.mi_col & ~(s.sb4 - 1);
    want = (s.enc->superblock_qindex(s, r, c) - s.current_qindex) >> s.fh->delta_q_res;
  }
  const int want_abs = std::abs(want);
  int abs = sym(s, s.cdf.delta_q, 4, std::min(want_abs, 3));
  if (abs == 3) {  // DELTA_Q_SMALL
    int rem = 1;  // encoding: abs - 1 in rem bits past its top one
    while (((want_abs - 1) >> (rem + 1)) > 0) rem++;
    const int rem_bits = lit(s, 3, rem - 1) + 1;
    abs = lit(s, rem_bits, (want_abs - 1) - (1 << rem_bits)) + (1 << rem_bits) + 1;
  }
  if (abs) {
    const int reduced = lit(s, 1, want < 0) ? -abs : abs;
    s.current_qindex = std::min(std::max(
        s.current_qindex + (reduced << s.fh->delta_q_res), 1), 255);
    count(kToolDeltaQ);
  }
}

void intra_frame_mode_info(State& s) {
  const bool enc = s.sw != nullptr;
  if (enc) s.enc->mode_info(s);  // the encoder's choices, written below
  Cdfs& cdf = s.cdf;
  const int r = s.mi_row, c = s.mi_col;
  const int skip_ctx = (s.avail_u ? s.at(r - 1, c).skip : 0) +
                       (s.avail_l ? s.at(r, c - 1).skip : 0);
  s.skip = sym(s, cdf.skip[skip_ctx], 2, s.skip);
  if (s.skip) count(kToolSkip);
  read_cdef(s);
  if (s.fh->delta_q_present) read_delta_qindex(s);
  s.read_deltas = false;
  s.is_inter = s.fh->intrabc && sym(s, cdf.intrabc, 2, 0);
  s.palette_size_y = s.palette_size_uv = 0;
  if (!enc) {
    s.use_filter_intra = false;
    s.angle_y = s.angle_uv = 0;
  }
  if (s.is_inter) {  // use_intrabc
    count(kToolIntrabc);
    s.y_mode = s.uv_mode = DC_PRED;
    intrabc_vector(s);
    return;
  }
  const int above = s.avail_u ? s.at(r - 1, c).y_mode : DC_PRED;
  const int left = s.avail_l ? s.at(r, c - 1).y_mode : DC_PRED;
  s.y_mode = sym(s, cdf.kf_y_mode[kIntraModeContext[above]][kIntraModeContext[left]],
                 13, s.y_mode);
  if (s.mi_size >= BLOCK_8X8 && directional(s.y_mode))
    s.angle_y = sym(s, cdf.angle_delta[s.y_mode - V_PRED], 7, s.angle_y + 3) - 3;
  const int bw = kNum4x4W[s.mi_size] * 4, bh = kNum4x4H[s.mi_size] * 4;
  if (s.has_chroma) {
    const bool cfl_allowed =
        s.fh->lossless ? plane_size(s, s.mi_size, 1) == BLOCK_4X4
                       : std::max(bw, bh) <= 32;
    if (cfl_allowed)
      s.uv_mode = sym(s, cdf.uv_mode_cfl_allowed[s.y_mode], 14, s.uv_mode);
    else
      s.uv_mode = sym(s, cdf.uv_mode_cfl_not_allowed[s.y_mode], 13, s.uv_mode);
    if (s.uv_mode == UV_CFL_PRED) {  // decoding only: the encoder takes no CFL
      SymbolReader& sr = s.sr;
      const int signs = sr.symbol(cdf.cfl_sign, 8);
      const int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
      s.cfl_alpha_u = s.cfl_alpha_v = 0;
      if (sign_u) {
        s.cfl_alpha_u = 1 + sr.symbol(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16);
        if (sign_u == 1) s.cfl_alpha_u = -s.cfl_alpha_u;
      }
      if (sign_v) {
        s.cfl_alpha_v = 1 + sr.symbol(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16);
        if (sign_v == 1) s.cfl_alpha_v = -s.cfl_alpha_v;
      }
      count(kToolCfl);
    }
    if (s.mi_size >= BLOCK_8X8 && directional(s.uv_mode))
      s.angle_uv = sym(s, cdf.angle_delta[s.uv_mode - V_PRED], 7, s.angle_uv + 3) - 3;
  } else {
    s.uv_mode = DC_PRED;
  }
  if (s.angle_y || s.angle_uv) count(kToolAngleDelta);
  if (s.mi_size >= BLOCK_8X8 && bw <= 64 && bh <= 64 && s.fh->screen_content)
    palette_mode_info(s);
  if (s.seq->filter_intra && s.y_mode == DC_PRED && s.palette_size_y == 0 &&
      std::max(bw, bh) <= 32) {
    s.use_filter_intra = sym(s, cdf.filter_intra[s.mi_size], 2, s.use_filter_intra);
    if (s.use_filter_intra) {
      s.filter_intra_mode = sym(s, cdf.filter_intra_mode, 5, s.filter_intra_mode);
      count(kToolFilterIntra);
    }
  } else if (enc) {
    s.use_filter_intra = false;
  }
}

// read_tx_size (5.11.16): the block's one transform size, a depth under
// TX_MODE_SELECT where allowed
void read_tx_size(State& s, bool allow_select) {
  const int max_rect = kMaxTxSizeRect[s.mi_size];
  s.tx_size = max_rect;
  if (!s.fh->tx_mode_select) {
    count(kToolTxModeLargest);
    return;
  }
  count(kToolTxModeSelect);
  if (s.mi_size == BLOCK_4X4 || !allow_select) return;
  const int max_depth = kMaxTxDepth[s.mi_size];
  const int r = s.mi_row, c = s.mi_col;
  int above_w = 0, left_h = 0;
  if (s.avail_u) {
    const MiInfo& m = s.at(r - 1, c);
    above_w = m.is_inter ? kNum4x4W[m.size] * 4 : tx_w(m.tx_size);
  }
  if (s.avail_l) {
    const MiInfo& m = s.at(r, c - 1);
    left_h = m.is_inter ? kNum4x4H[m.size] * 4 : tx_h(m.tx_size);
  }
  const int ctx = (above_w >= tx_w(max_rect)) + (left_h >= tx_h(max_rect));
  const int depth = s.sr.symbol(s.cdf.tx_size[max_depth - 1][ctx],
                                std::min<int>(max_depth, 2) + 1);
  for (int i = 0; i < depth; i++) s.tx_size = kSplitTxSize[s.tx_size];
  if (depth) count(kToolTxDepth);
}

// get_above_tx_width and get_left_tx_height: inside the block, the
// sizes its transform tree has already read
int above_tx_w(State& s, int row, int col) {
  if (row == s.mi_row) {
    if (!s.avail_u) return 64;
    const MiInfo& m = s.at(row - 1, col);
    if (m.skip && m.is_inter) return kNum4x4W[m.size] * 4;
  }
  return tx_w(s.at(row - 1, col).tx_size);
}

int left_tx_h(State& s, int row, int col) {
  if (col == s.mi_col) {
    if (!s.avail_l) return 64;
    const MiInfo& m = s.at(row, col - 1);
    if (m.skip && m.is_inter) return kNum4x4H[m.size] * 4;
  }
  return tx_h(s.at(row, col - 1).tx_size);
}

// read_var_tx_size (5.11.17): an intra block copy's transform tree, its
// leaves kept per 4x4 unit (InterTxSizes)
void read_var_tx_size(State& s, int row, int col, int tx, int depth) {
  if (row >= s.mi_rows || col >= s.mi_cols) return;
  bool split = false;
  if (tx != TX_4X4 && depth < 2) {
    const int above = above_tx_w(s, row, col) < tx_w(tx);
    const int left = left_tx_h(s, row, col) < tx_h(tx);
    const int side = std::min(64, 4 * std::max(kNum4x4W[s.mi_size], kNum4x4H[s.mi_size]));
    int max_sq = 0;
    while ((4 << max_sq) < side) max_sq++;
    const int ctx = (tx_sqr_up(tx) != max_sq) * 3 + (TX_64X64 - max_sq) * 6 + above + left;
    split = s.sr.symbol(s.cdf.txfm_split[ctx], 2);
  }
  const int w4 = tx_w(tx) >> 2, h4 = tx_h(tx) >> 2;
  if (split) {
    count(kToolVarTx);
    const int sub = kSplitTxSize[tx];
    for (int i = 0; i < h4; i += tx_h(sub) >> 2)
      for (int j = 0; j < w4; j += tx_w(sub) >> 2)
        read_var_tx_size(s, row + i, col + j, sub, depth + 1);
    return;
  }
  for (int i = 0; i < h4 && row + i < s.mi_rows; i++)
    for (int j = 0; j < w4 && col + j < s.mi_cols; j++)
      s.at(row + i, col + j).tx_size = static_cast<uint8_t>(tx);
  s.tx_size = tx;
}

// read_block_tx_size (5.11.15): 4x4 in a lossless frame; the transform
// tree of a coded intra block copy under TX_MODE_SELECT; else one size
void read_block_tx_size(State& s) {
  s.var_tx = false;
  if (s.fh->lossless) {
    s.tx_size = TX_4X4;
    return;
  }
  if (s.fh->tx_mode_select && s.mi_size > BLOCK_4X4 && s.is_inter && !s.skip) {
    const int max = kMaxTxSizeRect[s.mi_size];
    const int bw4 = kNum4x4W[s.mi_size], bh4 = kNum4x4H[s.mi_size];
    for (int row = s.mi_row; row < s.mi_row + bh4; row += tx_h(max) >> 2)
      for (int col = s.mi_col; col < s.mi_col + bw4; col += tx_w(max) >> 2)
        read_var_tx_size(s, row, col, max, 0);
    s.var_tx = true;
    count(kToolTxModeSelect);
    return;
  }
  read_tx_size(s, !s.skip || !s.is_inter);
}

// ------------------------------------------------------------ residual

// get_scan: the scan of the transform block's size and type
const uint16_t* scan_of(int tx, int type) {
  if (tx == TX_16X64) return kDefaultScan16x32;
  if (tx == TX_64X16) return kDefaultScan32x16;
  if (tx_sqr_up(tx) == TX_64X64) return kDefaultScan32x32;
  const int cls = tx_class(type);
  switch (tx) {
#define SCANS(T, N)                                            \
  case T:                                                      \
    return cls == 2 ? kMrowScan##N : cls == 1 ? kMcolScan##N   \
                                              : kDefaultScan##N;
    SCANS(TX_4X4, 4x4)
    SCANS(TX_8X8, 8x8)
    SCANS(TX_16X16, 16x16)
    SCANS(TX_4X8, 4x8)
    SCANS(TX_8X4, 8x4)
    SCANS(TX_8X16, 8x16)
    SCANS(TX_16X8, 16x8)
    SCANS(TX_4X16, 4x16)
    SCANS(TX_16X4, 16x4)
#undef SCANS
    case TX_32X32: return kDefaultScan32x32;
    case TX_16X32: return kDefaultScan16x32;
    case TX_32X16: return kDefaultScan32x16;
    case TX_8X32: return kDefaultScan8x32;
    default: return kDefaultScan32x8;
  }
}

// the index of a type in an inverse set
int set_index(const int* inv, int n, int type) {
  for (int i = 0; i < n; i++)
    if (inv[i] == type) return i;
  return 0;
}

// transform_type (5.11.47) of a luma transform block, kept in TxTypes
// (encoding: `type` written where the set codes one)
void read_tx_type(State& s, int x4, int y4, int tx, int type) {
  const int set = tx_set(s, tx);
  if (!s.sw) type = DCT_DCT;
  if (set > 0 && s.fh->base_q_idx > 0 && s.is_inter) {
    // an intra block copy's: decoding only (the encoder takes none)
    uint16_t* cdf = s.cdf.inter_ext_tx[set][tx_sqr(tx)];
    if (set == 1) type = kTxTypeInterInvSet1[s.sr.symbol(cdf, 16)];
    else if (set == 2) type = kTxTypeInterInvSet2[s.sr.symbol(cdf, 12)];
    else type = kTxTypeInterInvSet3[s.sr.symbol(cdf, 2)];
    count(kToolTxTypeInter);
  } else if (set > 0 && s.fh->base_q_idx > 0) {
    const int dir = s.use_filter_intra
                        ? kFilterIntraModeToIntraDir[s.filter_intra_mode]
                        : s.y_mode;
    uint16_t* cdf = s.cdf.intra_ext_tx[set][tx_sqr(tx)][dir];
    if (set == 1) {
      type = kTxTypeIntraInvSet1[sym(s, cdf, 7, set_index(kTxTypeIntraInvSet1, 7, type))];
      count(kToolTxTypeSet1);
    } else {
      type = kTxTypeIntraInvSet2[sym(s, cdf, 5, set_index(kTxTypeIntraInvSet2, 5, type))];
      count(kToolTxTypeSet2);
    }
  } else {
    type = DCT_DCT;
  }
  const int cols = s.lf_cols[0];
  for (int i = 0; i < tx_h(tx) >> 2; i++)
    for (int j = 0; j < tx_w(tx) >> 2; j++)
      s.tx_types[static_cast<size_t>(y4 + i) * cols + x4 + j] = static_cast<uint8_t>(type);
}

// compute_tx_type
int compute_tx_type(State& s, int plane, int tx, int x4, int y4) {
  if (s.fh->lossless || tx_sqr_up(tx) > TX_32X32) return DCT_DCT;
  const int cols = s.lf_cols[0];
  if (plane == 0) return s.tx_types[static_cast<size_t>(y4) * cols + x4];
  if (s.is_inter) {  // the luma type at the chroma block's position
    const int lx = std::max(s.mi_col, x4 << s.ssx), ly = std::max(s.mi_row, y4 << s.ssy);
    const int type = s.tx_types[static_cast<size_t>(ly) * cols + lx];
    return in_set(s, tx_set(s, tx), type) ? type : DCT_DCT;
  }
  const int type = kModeToTxfm[s.uv_mode];
  return in_set(s, tx_set(s, tx), type) ? type : DCT_DCT;
}

// 5.11.39: the coefficients of one transform block; returns eob, leaves
// the coefficients in quant (positions row * min(32, width) + column).
// Encoding, the Encoder's quantized coefficients are written and left in
// quant as the decoder reads them.
int coeffs(State& s, int plane, int start_x, int start_y, int tx, int32_t* quant) {
  Cdfs& cdf = s.cdf;
  const bool enc = s.sw != nullptr;
  const int x4 = start_x >> 2, y4 = start_y >> 2;
  const int w4 = tx_w(tx) >> 2, h4 = tx_h(tx) >> 2;
  const int tx_ctx = (tx_sqr(tx) + tx_sqr_up(tx) + 1) >> 1;
  const int ptype = plane > 0;
  const int seg_eob = (tx == TX_16X64 || tx == TX_64X16)
                          ? 512 : std::min(1024, tx_w(tx) * tx_h(tx));
  // encoding: the coefficients to write, their type and end of block
  int32_t coef[1024];
  int enc_type = DCT_DCT, enc_eob = 0;
  if (enc) {
    const int given = plane == 0 ? -1 : compute_tx_type(s, plane, tx, x4, y4);
    std::memset(coef, 0, seg_eob * sizeof(int32_t));
    enc_type = s.enc->quantize(s, plane, start_x, start_y, tx, given, coef);
    const uint16_t* scan = s.fh->lossless ? kDefaultScan4x4 : scan_of(tx, enc_type);
    for (int c = 0; c < seg_eob; c++)
      if (coef[scan[c]]) enc_eob = c + 1;
  }
  std::memset(quant, 0, seg_eob * sizeof(int32_t));
  const int max_x4 = s.mi_cols >> s.sub_x(plane), max_y4 = s.mi_rows >> s.sub_y(plane);
  const int bsize = plane_size(s, s.mi_size, plane);
  const int bw = kNum4x4W[bsize] * 4, bh = kNum4x4H[bsize] * 4;
  int ctx;
  if (plane == 0) {
    int top = 0, left = 0;
    for (int k = 0; k < w4; k++)
      if (x4 + k < max_x4) top = std::max(top, static_cast<int>(s.above_level[0][x4 + k]));
    for (int k = 0; k < h4; k++)
      if (y4 + k < max_y4) left = std::max(left, static_cast<int>(s.left_level[0][y4 + k]));
    if (bw == tx_w(tx) && bh == tx_h(tx)) ctx = 0;
    else if (top == 0 && left == 0) ctx = 1;
    else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
    else if (std::max(top, left) <= 3) ctx = 4;
    else if (std::min(top, left) <= 3) ctx = 5;
    else ctx = 6;
  } else {
    int above = 0, left = 0;
    for (int k = 0; k < w4; k++)
      if (x4 + k < max_x4) above |= s.above_level[plane][x4 + k] | s.above_dc[plane][x4 + k];
    for (int k = 0; k < h4; k++)
      if (y4 + k < max_y4) left |= s.left_level[plane][y4 + k] | s.left_dc[plane][y4 + k];
    ctx = 7 + (above != 0) + (left != 0);
    if (bw * bh > tx_w(tx) * tx_h(tx)) ctx += 3;
  }
  int eob = 0, cul_level = 0, dc_category = 0;
  if (sym(s, cdf.txb_skip[tx_ctx][ctx], 2, enc_eob == 0)) {
    if (plane == 0)
      for (int i = 0; i < h4; i++)
        for (int j = 0; j < w4; j++)
          s.tx_types[static_cast<size_t>(y4 + i) * s.lf_cols[0] + x4 + j] = DCT_DCT;
  } else {
    count(kToolCoefficients);
    if (plane == 0) read_tx_type(s, x4, y4, tx, enc_type);
    const int type = s.plane_tx_type = compute_tx_type(s, plane, tx, x4, y4);
    const int cls = tx_class(type);
    const uint16_t* scan = s.fh->lossless ? kDefaultScan4x4 : scan_of(tx, type);
    const int multisize = std::min(kTxWidthLog2[tx], 5) + std::min(kTxHeightLog2[tx], 5) - 4;
    const int ectx = cls == 0 ? 0 : 1;
    // encoding: eob_pt from the end of block, 1 + the bits of eob - 1
    int enc_pt = 0;
    for (int e = enc_eob - 1; e > 0; e >>= 1) enc_pt++;
    int eob_pt;
    switch (multisize) {
      case 0: eob_pt = sym(s, cdf.eob_pt_16[ptype][ectx], 5, enc_pt); break;
      case 1: eob_pt = sym(s, cdf.eob_pt_32[ptype][ectx], 6, enc_pt); break;
      case 2: eob_pt = sym(s, cdf.eob_pt_64[ptype][ectx], 7, enc_pt); break;
      case 3: eob_pt = sym(s, cdf.eob_pt_128[ptype][ectx], 8, enc_pt); break;
      case 4: eob_pt = sym(s, cdf.eob_pt_256[ptype][ectx], 9, enc_pt); break;
      case 5: eob_pt = sym(s, cdf.eob_pt_512[ptype][0], 10, enc_pt); break;
      default: eob_pt = sym(s, cdf.eob_pt_1024[ptype][0], 11, enc_pt); break;
    }
    eob_pt += 1;
    if (eob_pt > 6) count(kToolEobLong);
    eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
    if (eob_pt >= 3) {
      const int rest = enc_eob - eob;  // the offset to write
      if (sym(s, cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2, (rest >> (eob_pt - 3)) & 1))
        eob += 1 << (eob_pt - 3);
      for (int i = 1; i < eob_pt - 2; i++)
        if (lit(s, 1, (rest >> (eob_pt - 3 - i)) & 1)) eob += 1 << (eob_pt - 3 - i);
    }
    // Adjusted_Tx_Size: the coefficients of a 64 side lie in 32
    const int bwl = std::min(kTxWidthLog2[tx], 5);
    const int txh = std::min(tx_h(tx), 32), txw = 1 << bwl;
    const int shape = kTxWidthLog2[tx] == kTxHeightLog2[tx] ? 0
                      : kTxWidthLog2[tx] > kTxHeightLog2[tx] ? 1 : 2;
    const int area = txh << bwl;
    for (int c = eob - 1; c >= 0; c--) {
      const int pos = scan[c];
      const int row = pos >> bwl, col = pos - (row << bwl);
      // encoding: the level to write, its base (to 3) and range coded
      const int want = enc ? std::min(std::abs(coef[pos]), 15) : 0;
      int level;
      if (c == eob - 1) {
        const int e = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
        level = sym(s, cdf.coeff_base_eob[tx_ctx][ptype][e], 3, std::min(want, 3) - 1) + 1;
      } else {
        int mag = 0;
        for (int k = 0; k < 5; k++) {
          const int rr = row + kSigRefDiffOffset[cls][k][0];
          const int cc = col + kSigRefDiffOffset[cls][k][1];
          if (rr < txh && cc < txw)
            mag += std::min(std::abs(quant[(rr << bwl) + cc]), 3);
        }
        int bctx = std::min((mag + 1) >> 1, 4);
        if (cls == 0) {
          bctx = pos == 0 ? 0
                          : bctx + kCoeffBaseCtxOffset[shape][std::min(row, 4)][std::min(col, 4)];
        } else {
          const int idx = cls == 2 ? row : col;
          bctx += kCoeffBasePosCtxOffset[std::min(idx, 2)];
        }
        level = sym(s, cdf.coeff_base[tx_ctx][ptype][bctx], 4, std::min(want, 3));
      }
      if (level > 2) {
        int mag = 0;
        for (int k = 0; k < 3; k++) {
          const int rr = row + kMagRefOffset[cls][k][0];
          const int cc = col + kMagRefOffset[cls][k][1];
          if (rr < txh && cc < txw) mag += std::min(quant[rr * txw + cc], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        int brctx;
        if (pos == 0) brctx = mag;
        else if (cls == 0) brctx = (row < 2 && col < 2) ? mag + 7 : mag + 14;
        else if (cls == 1) brctx = col == 0 ? mag + 7 : mag + 14;
        else brctx = row == 0 ? mag + 7 : mag + 14;
        for (int idx = 0; idx < 4; idx++) {
          const int br = sym(s, cdf.coeff_br[std::min(tx_ctx, 3)][ptype][brctx], 4,
                             std::min(want - level, 3));
          level += br;
          if (br < 3) break;
        }
      }
      quant[pos] = level;
    }
    for (int c = 0; c < eob; c++) {
      const int pos = scan[c];
      const int neg = enc && coef[pos] < 0;
      int sign = 0;
      if (quant[pos] != 0) {
        if (c == 0) {
          int dc_sign = 0;
          for (int k = 0; k < w4; k++)
            if (x4 + k < max_x4) {
              const int a = s.above_dc[plane][x4 + k];
              dc_sign += a == 1 ? -1 : a == 2 ? 1 : 0;
            }
          for (int k = 0; k < h4; k++)
            if (y4 + k < max_y4) {
              const int l = s.left_dc[plane][y4 + k];
              dc_sign += l == 1 ? -1 : l == 2 ? 1 : 0;
            }
          const int sctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
          sign = sym(s, cdf.dc_sign[ptype][sctx], 2, neg);
          count(kToolDcSign);
        } else {
          sign = lit(s, 1, neg);
        }
      }
      if (quant[pos] > 14) {
        if (enc) {  // the Golomb code of |coef| - 14: its length in zeros,
                    // a one, then its bits below the top one
          const int x = std::abs(coef[pos]) - 14;
          int length = 0;
          for (int v = x; v; v >>= 1) length++;
          lit(s, length - 1, 0);
          lit(s, 1, 1);
          lit(s, length - 1, x);
          quant[pos] = x + 14;
        } else {
          int length = 0, bit;
          do {
            length++;
            bit = s.sr.literal(1);
            if (length > 20) corrupt("AV1 coefficient Golomb code longer than 20");
          } while (!bit);
          int x = 1;
          for (int i = length - 2; i >= 0; i--) x = (x << 1) | s.sr.literal(1);
          quant[pos] = x + 14;
        }
        count(kToolGolomb);
      }
      if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
      quant[pos] &= 0xFFFFF;
      cul_level += quant[pos];
      if (sign) quant[pos] = -quant[pos];
    }
    cul_level = std::min(63, cul_level);
  }
  for (int i = 0; i < w4; i++) {
    s.above_level[plane][x4 + i] = static_cast<uint8_t>(cul_level);
    s.above_dc[plane][x4 + i] = static_cast<uint8_t>(dc_category);
  }
  for (int i = 0; i < h4; i++) {
    s.left_level[plane][y4 + i] = static_cast<uint8_t>(cul_level);
    s.left_dc[plane][y4 + i] = static_cast<uint8_t>(dc_category);
  }
  return eob;
}

// the intra prediction of a transform block (5.11.35) by `mode` (the
// block's mode, or DC_PRED under CFL), its edges as BlockDecoded has them
void predict_tx(State& s, int plane, int start_x, int start_y, int tx, int x,
                int y, int mode) {
  const int subx = s.sub_x(plane), suby = s.sub_y(plane);
  const int row = (start_y << suby) >> 2, col = (start_x << subx) >> 2;
  const int sb_mask = s.sb4 - 1;
  const int sub_row = (row & sb_mask) >> suby, sub_col = (col & sb_mask) >> subx;
  const int step_x = tx_w(tx) >> 2, step_y = tx_h(tx) >> 2;
  predict_intra(s, plane, start_x, start_y,
                (plane == 0 ? s.avail_l : s.avail_l_chroma) || x > 0,
                (plane == 0 ? s.avail_u : s.avail_u_chroma) || y > 0,
                s.decoded(plane, sub_row - 1, sub_col + step_x),
                s.decoded(plane, sub_row + step_y, sub_col - 1), mode,
                kTxWidthLog2[tx], kTxHeightLog2[tx]);
}

// transform_block (5.11.35): x, y the block's 4x4 index in its (plane)
// block
void transform_block(State& s, int plane, int base_x, int base_y, int tx,
                     int x, int y) {
  const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
  const int subx = s.sub_x(plane), suby = s.sub_y(plane);
  const int row = (start_y << suby) >> 2, col = (start_x << subx) >> 2;
  const int sb_mask = s.sb4 - 1;
  const int sub_row = (row & sb_mask) >> suby, sub_col = (col & sb_mask) >> subx;
  const int step_x = tx_w(tx) >> 2, step_y = tx_h(tx) >> 2;
  const int max_x = (s.mi_cols * 4) >> subx, max_y = (s.mi_rows * 4) >> suby;
  if (start_x >= max_x || start_y >= max_y) return;
  if (!s.is_inter) {
    const int psize = plane == 0 ? s.palette_size_y : s.palette_size_uv;
    if (psize) {
      predict_palette(s, plane, start_x, start_y, x, y, tx);
    } else {
      const bool cfl = plane > 0 && s.uv_mode == UV_CFL_PRED;
      predict_tx(s, plane, start_x, start_y, tx, x, y,
                 plane == 0 ? s.y_mode : cfl ? DC_PRED : s.uv_mode);
      if (cfl) predict_cfl(s, plane, start_x, start_y, tx);
    }
    if (plane == 0) {
      s.max_luma_w = start_x + step_x * 4;
      s.max_luma_h = start_y + step_y * 4;
    }
  }
  if (!s.skip) {
    int32_t quant[1024];
    if (coeffs(s, plane, start_x, start_y, tx, quant) > 0)
      reconstruct(s, plane, start_x, start_y, tx, quant);
  }
  const int cols = s.lf_cols[plane];
  for (int i = 0; i < step_y; i++)
    for (int j = 0; j < step_x; j++) {
      s.block_decoded[plane][sub_row + i + 1][sub_col + j + 1] = 1;
      s.lf_tx[plane][static_cast<size_t>((start_y >> 2) + i) * cols + (start_x >> 2) + j] =
          static_cast<uint8_t>(tx);
    }
}

// transform_tree: the luma transform blocks of an intra block copy's
// tree from (x, y), a transform of size tx or its splits
void transform_tree(State& s, int x, int y, int tx) {
  if (x >= s.mi_cols * 4 || y >= s.mi_rows * 4) return;
  if (s.at(y >> 2, x >> 2).tx_size == tx) {
    transform_block(s, 0, 0, 0, tx, x >> 2, y >> 2);
    return;
  }
  const int sub = kSplitTxSize[tx];
  for (int i = 0; i < tx_h(tx); i += tx_h(sub))
    for (int j = 0; j < tx_w(tx); j += tx_w(sub)) transform_tree(s, x + j, y + i, sub);
}

// residual (5.11.34): in 64x64 chunks, each plane's transform blocks
void residual(State& s) {
  const int bw4 = kNum4x4W[s.mi_size], bh4 = kNum4x4H[s.mi_size];
  const int width_chunks = std::max(1, bw4 >> 4), height_chunks = std::max(1, bh4 >> 4);
  for (int cy = 0; cy < height_chunks; cy++)
    for (int cx = 0; cx < width_chunks; cx++)
      for (int plane = 0; plane < (s.has_chroma ? 3 : 1); plane++) {
        if (s.is_inter && !s.fh->lossless && plane == 0) {
          const int max = kMaxTxSizeRect[s.mi_size];
          const int x0 = (s.mi_col + (cx << 4)) * 4, y0 = (s.mi_row + (cy << 4)) * 4;
          for (int y = y0; y < std::min(y0 + 64, (s.mi_row + bh4) * 4); y += tx_h(max))
            for (int x = x0; x < std::min(x0 + 64, (s.mi_col + bw4) * 4); x += tx_w(max))
              transform_tree(s, x, y, max);
          continue;
        }
        const int tx = s.fh->lossless ? TX_4X4 : plane_tx_size(s, plane);
        const int step_x = tx_w(tx) >> 2, step_y = tx_h(tx) >> 2;
        const int psize = plane_size(s, s.mi_size, plane);
        const int n4w = kNum4x4W[psize], n4h = kNum4x4H[psize];
        const int subx = s.sub_x(plane), suby = s.sub_y(plane);
        const int base_x = (s.mi_col >> subx) * 4, base_y = (s.mi_row >> suby) * 4;
        for (int y = 0; y < std::min(n4h, 16 >> suby); y += step_y)
          for (int x = 0; x < std::min(n4w, 16 >> subx); x += step_x)
            transform_block(s, plane, base_x, base_y, tx, x + ((cx << 4) >> subx),
                            y + ((cy << 4) >> suby));
      }
}

// ------------------------------------------------------------ restoration

// decode_subexp_bool and its recentring (5.11.58)
int inverse_recenter(int r, int v) {
  if (v > 2 * r) return v;
  return (v & 1) ? r - ((v + 1) >> 1) : r + (v >> 1);
}

int subexp_with_ref(SymbolReader& sr, int low, int high, int k, int ref) {
  const int mx = high - low, r = ref - low;
  int v = 0;
  for (int i = 0, mk = 0;;) {
    const int b2 = i ? k + i - 1 : k, a = 1 << b2;
    if (mx <= mk + 3 * a) {
      v = sr.ns(mx - mk) + mk;
      break;
    }
    if (!sr.literal(1)) {
      v = sr.literal(b2) + mk;
      break;
    }
    i++;
    mk += a;
  }
  const int x = (r << 1) <= mx ? inverse_recenter(r, v)
                               : mx - 1 - inverse_recenter(mx - 1 - r, v);
  return x + low;
}

// read_lr_unit (5.11.58)
void read_lr_unit(State& s, int plane, int unit_row, int unit_col) {
  SymbolReader& sr = s.sr;
  LrUnit& u = s.lr[plane][static_cast<size_t>(unit_row) * s.lr_cols[plane] + unit_col];
  const int frame_type = s.fh->lr_type[plane];
  if (frame_type == RESTORE_WIENER) {
    u.type = sr.symbol(s.cdf.wiener_restore, 2) ? RESTORE_WIENER : RESTORE_NONE;
  } else if (frame_type == RESTORE_SGRPROJ) {
    u.type = sr.symbol(s.cdf.sgrproj_restore, 2) ? RESTORE_SGRPROJ : RESTORE_NONE;
  } else {
    static const int kSwitchable[3] = {RESTORE_NONE, RESTORE_WIENER, RESTORE_SGRPROJ};
    u.type = kSwitchable[sr.symbol(s.cdf.switchable_restore, 3)];
    count(kToolLrSwitchable);
  }
  if (u.type == RESTORE_WIENER) {
    for (int pass = 0; pass < 2; pass++) {
      const int first = plane ? 1 : 0;
      if (plane) u.wiener[pass][0] = 0;
      for (int j = first; j < 3; j++) {
        const int v = subexp_with_ref(sr, kWienerTapsMin[j], kWienerTapsMax[j] + 1,
                                      kWienerTapsK[j], s.ref_lr_wiener[plane][pass][j]);
        u.wiener[pass][j] = s.ref_lr_wiener[plane][pass][j] = v;
      }
    }
  } else if (u.type == RESTORE_SGRPROJ) {
    u.sgr_set = sr.literal(4);
    for (int i = 0; i < 2; i++) {
      const int radius = kSgrParams[u.sgr_set][i * 2];
      int v;
      if (radius) {
        v = subexp_with_ref(sr, kSgrprojXqdMin[i], kSgrprojXqdMax[i] + 1, 4, s.ref_sgr_xqd[plane][i]);
      } else {
        v = 0;
        if (i == 1)
          v = std::min(std::max((1 << 7) - s.ref_sgr_xqd[plane][0], int{kSgrprojXqdMin[i]}),
                       int{kSgrprojXqdMax[i]});
      }
      u.sgr_xqd[i] = s.ref_sgr_xqd[plane][i] = v;
    }
  }
}

int lr_units(int unit, int size) { return std::max((size + (unit >> 1)) / unit, 1); }

// read_lr (5.11.57): the units whose top-left corner the superblock holds
void read_lr(State& s, int r, int c) {
  if (s.fh->intrabc) return;
  for (int plane = 0; plane < s.planes; plane++) {
    if (s.fh->lr_type[plane] == RESTORE_NONE) continue;
    const int subx = s.sub_x(plane), suby = s.sub_y(plane);
    const int unit = s.fh->lr_size[plane];
    const int row_start = (r * (4 >> suby) + unit - 1) / unit;
    const int row_end = std::min(s.lr_rows[plane], ((r + s.sb4) * (4 >> suby) + unit - 1) / unit);
    const int col_start = (c * (4 >> subx) + unit - 1) / unit;
    const int col_end = std::min(s.lr_cols[plane], ((c + s.sb4) * (4 >> subx) + unit - 1) / unit);
    for (int ur = row_start; ur < row_end; ur++)
      for (int uc = col_start; uc < col_end; uc++) read_lr_unit(s, plane, ur, uc);
  }
}

// ------------------------------------------------------------ blocks

}  // namespace

void setup_block(State& s, int r, int c, int size) {
  s.mi_row = r;
  s.mi_col = c;
  s.mi_size = size;
  const int bw4 = kNum4x4W[size], bh4 = kNum4x4H[size];
  s.has_chroma = s.planes > 1 &&
                 !(s.ssx && bw4 == 1 && (c & 1) == 0) &&
                 !(s.ssy && bh4 == 1 && (r & 1) == 0);
  s.avail_u = s.inside(r - 1, c);
  s.avail_l = s.inside(r, c - 1);
  s.avail_u_chroma = s.avail_u;
  s.avail_l_chroma = s.avail_l;
  if (s.has_chroma) {
    if (s.ssy && bh4 == 1) s.avail_u_chroma = s.inside(r - 2, c);
    if (s.ssx && bw4 == 1) s.avail_l_chroma = s.inside(r, c - 2);
  }
}

uint16_t* partition_cdf(State& s, int r, int c, int bsize, int* n) {
  const bool avail_u = s.inside(r - 1, c), avail_l = s.inside(r, c - 1);
  const int bsl = kMiWidthLog2[bsize];
  const int above = avail_u && kMiWidthLog2[s.at(r - 1, c).size] < bsl;
  const int left = avail_l && kMiHeightLog2[s.at(r, c - 1).size] < bsl;
  *n = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
  return s.cdf.partition[(bsl - 1) * 4 + left * 2 + above];
}

void predict_transform_block(State& s, int plane, int tx, int mode) {
  const int subx = s.sub_x(plane), suby = s.sub_y(plane);
  predict_tx(s, plane, (s.mi_col >> subx) * 4, (s.mi_row >> suby) * 4, tx, 0, 0,
             mode);
}

namespace {

void decode_block(State& s, int r, int c, int size) {
  setup_block(s, r, c, size);
  const int bw4 = kNum4x4W[size], bh4 = kNum4x4H[size];
  intra_frame_mode_info(s);
  palette_tokens(s);
  read_block_tx_size(s);
  if (s.skip) {  // reset_block_context
    for (int plane = 0; plane < (s.has_chroma ? 3 : 1); plane++) {
      const int subx = s.sub_x(plane), suby = s.sub_y(plane);
      for (int i = c >> subx; i <= (c + bw4 - 1) >> subx; i++)
        s.above_level[plane][i] = s.above_dc[plane][i] = 0;
      for (int i = r >> suby; i <= (r + bh4 - 1) >> suby; i++)
        s.left_level[plane][i] = s.left_dc[plane][i] = 0;
    }
  }
  for (int y = r; y < std::min(r + bh4, s.mi_rows); y++)
    for (int x = c; x < std::min(c + bw4, s.mi_cols); x++) {
      MiInfo& m = s.at(y, x);
      m.size = static_cast<uint8_t>(size);
      m.y_mode = static_cast<uint8_t>(s.y_mode);
      m.uv_mode = static_cast<uint8_t>(s.uv_mode);
      m.skip = s.skip;
      m.is_inter = s.is_inter;
      m.decoded = 1;
      if (!s.var_tx) m.tx_size = static_cast<uint8_t>(s.tx_size);
      m.palette_size[0] = static_cast<uint8_t>(s.palette_size_y);
      m.palette_size[1] = static_cast<uint8_t>(s.palette_size_uv);
      std::memcpy(m.palette[0], s.palette[0], sizeof(m.palette[0]));
      std::memcpy(m.palette[1], s.palette[1], sizeof(m.palette[1]));
      m.mv[0] = static_cast<int16_t>(s.is_inter ? s.mv[0] : 0);
      m.mv[1] = static_cast<int16_t>(s.is_inter ? s.mv[1] : 0);
    }
  if (s.is_inter) predict_intrabc(s);
  residual(s);
}

}  // namespace

void code_partition(State& s, int r, int c, int bsize) {
  if (r >= s.mi_rows || c >= s.mi_cols) return;
  const int num4 = kNum4x4W[bsize], half = num4 >> 1, quarter = half >> 1;
  const bool has_rows = (r + half) < s.mi_rows, has_cols = (c + half) < s.mi_cols;
  const int bsl = kMiWidthLog2[bsize];
  int partition;
  if (bsize < BLOCK_8X8) {
    partition = PARTITION_NONE;
  } else {
    int n;
    uint16_t* cdf = partition_cdf(s, r, c, bsize, &n);
    const int want = s.sw ? s.enc->partition(s, r, c, bsize) : 0;
    auto prob = [cdf](int e) { return (e > 0 ? cdf[e - 1] : 32768) - cdf[e]; };
    if (has_rows && has_cols) {
      partition = sym(s, cdf, n, want);
    } else if (has_cols) {  // split_or_horz
      int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) +
                 prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                 prob(PARTITION_VERT_B);
      if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
      uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
      partition = sym(s, tmp, 2, want == PARTITION_SPLIT) ? PARTITION_SPLIT
                                                            : PARTITION_HORZ;
      count(kToolSplitOrHorz);
    } else if (has_rows) {  // split_or_vert
      int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) +
                 prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                 prob(PARTITION_VERT_A);
      if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
      uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
      partition = sym(s, tmp, 2, want == PARTITION_SPLIT) ? PARTITION_SPLIT
                                                            : PARTITION_VERT;
      count(kToolSplitOrVert);
    } else {
      partition = PARTITION_SPLIT;
    }
  }
  count(static_cast<Tool>(kToolPartitionNone + partition));
  if (!has_rows || !has_cols) count(kToolFrameEdge);
  const int sub = kSubsize[partition][bsl];
  const int split = kSubsize[PARTITION_SPLIT][bsl];
  switch (partition) {
    case PARTITION_NONE:
      decode_block(s, r, c, sub);
      break;
    case PARTITION_HORZ:
      decode_block(s, r, c, sub);
      if (has_rows) decode_block(s, r + half, c, sub);
      break;
    case PARTITION_VERT:
      decode_block(s, r, c, sub);
      if (has_cols) decode_block(s, r, c + half, sub);
      break;
    case PARTITION_SPLIT:
      code_partition(s, r, c, sub);
      code_partition(s, r, c + half, sub);
      code_partition(s, r + half, c, sub);
      code_partition(s, r + half, c + half, sub);
      break;
    case PARTITION_HORZ_A:
      decode_block(s, r, c, split);
      decode_block(s, r, c + half, split);
      decode_block(s, r + half, c, sub);
      break;
    case PARTITION_HORZ_B:
      decode_block(s, r, c, sub);
      decode_block(s, r + half, c, split);
      decode_block(s, r + half, c + half, split);
      break;
    case PARTITION_VERT_A:
      decode_block(s, r, c, split);
      decode_block(s, r + half, c, split);
      decode_block(s, r, c + half, sub);
      break;
    case PARTITION_VERT_B:
      decode_block(s, r, c, sub);
      decode_block(s, r, c + half, split);
      decode_block(s, r + half, c + half, split);
      break;
    case PARTITION_HORZ_4:
      for (int i = 0; i < 4; i++)
        if (i < 3 || r + quarter * 3 < s.mi_rows)
          decode_block(s, r + quarter * i, c, sub);
      break;
    default:  // PARTITION_VERT_4
      for (int i = 0; i < 4; i++)
        if (i < 3 || c + quarter * 3 < s.mi_cols)
          decode_block(s, r, c + quarter * i, sub);
      break;
  }
}

namespace {

void clear_block_decoded(State& s, int r, int c) {
  for (int plane = 0; plane < s.planes; plane++) {
    const int subx = s.sub_x(plane), suby = s.sub_y(plane);
    const int w4 = (s.mi_col_end - c) >> subx, h4 = (s.mi_row_end - r) >> suby;
    for (int y = -1; y <= (s.sb4 >> suby); y++)
      for (int x = -1; x <= (s.sb4 >> subx); x++) {
        uint8_t v = 0;
        if (y < 0 && x < w4) v = 1;
        else if (x < 0 && y < h4) v = 1;
        s.block_decoded[plane][y + 1][x + 1] = v;
      }
    s.block_decoded[plane][(s.sb4 >> suby) + 1][0] = 0;
  }
}

}  // namespace

void init_frame(State& s, const SequenceHeader& seq, const FrameHeader& fh) {
  s.seq = &seq;
  s.fh = &fh;
  s.mi_rows = fh.mi_rows;
  s.mi_cols = fh.mi_cols;
  s.planes = seq.mono ? 1 : 3;
  s.ssx = seq.mono ? 0 : seq.ssx;
  s.ssy = seq.mono ? 0 : seq.ssy;
  s.bit_depth = seq.bit_depth;
  s.sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
  s.sb4 = seq.sb128 ? 32 : 16;
  count(seq.sb128 ? kToolSb128 : kToolSb64);
  count(seq.bit_depth == 8 ? kToolDepth8 : seq.bit_depth == 10 ? kToolDepth10 : kToolDepth12);
  if (seq.mono) count(kToolMonochrome);
  if (!fh.lossless) count(kToolLossy);
  if (s.ssx && s.ssy) count(kToolChroma420);
  if (s.ssx && !s.ssy) count(kToolChroma422);
  if (s.planes > 1 && !s.ssx && !fh.lossless) count(kToolLossy444);
  if (s.ssx && fh.lossless) count(kToolLosslessSubsampled);
  if (fh.using_qmatrix && !fh.lossless) count(kToolQmatrix);
  const int sb_px = s.sb4 * 4;
  const int luma_stride = (s.mi_cols * 4 + sb_px - 1) / sb_px * sb_px;
  const int luma_rows = (s.mi_rows * 4 + sb_px - 1) / sb_px * sb_px;
  for (int p = 0; p < s.planes; p++) {
    s.stride[p] = luma_stride >> s.sub_x(p);
    s.rows[p] = luma_rows >> s.sub_y(p);
    s.frame[p].assign(static_cast<size_t>(s.stride[p]) * s.rows[p], 0);
    s.above_level[p].assign(s.stride[p] / 4 + 32, 0);
    s.above_dc[p].assign(s.stride[p] / 4 + 32, 0);
    s.left_level[p].assign(s.rows[p] / 4 + 32, 0);
    s.left_dc[p].assign(s.rows[p] / 4 + 32, 0);
    s.lf_cols[p] = s.stride[p] / 4;
    s.lf_tx[p].assign(static_cast<size_t>(s.lf_cols[p]) * (s.rows[p] / 4), TX_4X4);
  }
  s.tx_types.assign(static_cast<size_t>(s.lf_cols[0]) * (s.rows[0] / 4), DCT_DCT);
  s.cdef_cols = (s.mi_cols + 15) >> 4;
  s.cdef_idx.assign(static_cast<size_t>(s.cdef_cols) * ((s.mi_rows + 15) >> 4), -1);
  for (int p = 0; p < s.planes; p++) {
    if (fh.lr_type[p] == RESTORE_NONE) continue;
    const int unit = fh.lr_size[p];
    const int ph = (fh.height + s.sub_y(p)) >> s.sub_y(p);
    const int pw = (fh.width + s.sub_x(p)) >> s.sub_x(p);
    s.lr_rows[p] = lr_units(unit, ph);
    s.lr_cols[p] = lr_units(unit, pw);
    s.lr[p].assign(static_cast<size_t>(s.lr_rows[p]) * s.lr_cols[p], LrUnit());
  }
  s.mi.assign(static_cast<size_t>(s.mi_rows) * s.mi_cols, MiInfo());
}

void start_tile(State& s, int tile) {
  const FrameHeader& fh = *s.fh;
  const int row = tile / fh.tile_cols, col = tile % fh.tile_cols;
  s.mi_row_start = fh.mi_row_starts[row];
  s.mi_row_end = fh.mi_row_starts[row + 1];
  s.mi_col_start = fh.mi_col_starts[col];
  s.mi_col_end = fh.mi_col_starts[col + 1];
  // decode_tile: the above contexts cleared, the loop restoration
  // references at their middles; init_symbol: the frame's CDFs;
  // CurrentQIndex at the frame's
  for (int p = 0; p < s.planes; p++) {
    std::fill(s.above_level[p].begin(), s.above_level[p].end(), 0);
    std::fill(s.above_dc[p].begin(), s.above_dc[p].end(), 0);
    for (int pass = 0; pass < 2; pass++)
      for (int j = 0; j < 3; j++) s.ref_lr_wiener[p][pass][j] = kWienerTapsMid[j];
    s.ref_sgr_xqd[p][0] = kSgrprojXqdMid[0];
    s.ref_sgr_xqd[p][1] = kSgrprojXqdMid[1];
  }
  s.current_qindex = fh.base_q_idx;
  init_cdfs(&s.cdf, fh.base_q_idx);
}

void start_sb_row(State& s) {
  for (int p = 0; p < s.planes; p++) {
    std::fill(s.left_level[p].begin(), s.left_level[p].end(), 0);
    std::fill(s.left_dc[p].begin(), s.left_dc[p].end(), 0);
  }
}

void start_superblock(State& s, int r, int c) {
  clear_block_decoded(s, r, c);
  s.read_deltas = s.fh->delta_q_present;
}

void filter_frame(State& s, int filters) {
  // the in-loop filters (7.14, 7.15, 7.17); loop restoration reads the
  // deblocked frame above and below each stripe of 64 rows
  const FrameHeader& fh = *s.fh;
  if (filters & kFilterDeblock) deblock_frame(s);
  std::vector<uint16_t> deblocked[3];
  if (fh.uses_lr && (filters & kFilterRestoration))
    for (int p = 0; p < s.planes; p++) deblocked[p] = s.frame[p];
  if (fh.cdef && (filters & kFilterCdef)) cdef_frame(s);
  if (fh.uses_lr && (filters & kFilterRestoration)) restore_frame(s, deblocked);
}

void take_planes(State& s, Planes* out) {
  const FrameHeader& fh = *s.fh;
  out->width = fh.width;
  out->height = fh.height;
  out->bit_depth = s.bit_depth;
  out->count = s.planes;
  out->ssx = s.ssx;
  out->ssy = s.ssy;
  for (int p = 0; p < s.planes; p++) {
    const int w = (fh.width + s.sub_x(p)) >> s.sub_x(p);
    const int h = (fh.height + s.sub_y(p)) >> s.sub_y(p);
    out->plane[p].resize(static_cast<size_t>(w) * h);
    for (int y = 0; y < h; y++)
      std::memcpy(out->plane[p].data() + static_cast<size_t>(y) * w,
                  s.px(p, y, 0), w * sizeof(uint16_t));
  }
}

void decode_picture(const Picture& pic, Planes* out, int filters) {
  const SequenceHeader& seq = pic.seq;
  const FrameHeader& fh = pic.frame;
  std::unique_ptr<State> owner(new State());
  State& s = *owner;
  init_frame(s, seq, fh);
  for (size_t t = 0; t < pic.tiles.size(); t++) {
    start_tile(s, static_cast<int>(t));
    s.sr.init(pic.tiles[t].data, pic.tiles[t].size, fh.disable_cdf_update);
    for (int r = s.mi_row_start; r < s.mi_row_end; r += s.sb4) {
      start_sb_row(s);
      for (int c = s.mi_col_start; c < s.mi_col_end; c += s.sb4) {
        start_superblock(s, r, c);
        read_lr(s, r, c);
        code_partition(s, r, c, s.sb_size);
        if (s.sr.overrun())
          corrupt("AV1 tile " + std::to_string(t) + " data ends before its last superblock");
      }
    }
  }
  filter_frame(s, filters);
  take_planes(s, out);
}

}  // namespace av1
}  // namespace sdt
