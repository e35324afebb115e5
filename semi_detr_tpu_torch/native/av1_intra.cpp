// The tile syntax of a lossless AV1 key frame: the superblock loop
// (5.11.2), partitions (5.11.4), intra frame mode info (5.11.7) with
// palette (5.11.46, 5.11.49, 7.11.4's color context) and intra block copy
// (its reference vector stack, 7.10.2, and the vector, 5.11.32), and the
// coefficients of 4x4 blocks (5.11.39). Every transform of a lossless
// frame is the 4x4 Walsh-Hadamard one and no transform type is coded.
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
  if (s.palette_size_uv)  // 4:4:4: the chroma block is the luma block
    color_map(s, s.color_map_uv, s.palette_size_uv,
              s.cdf.palette_uv_color[s.palette_size_uv - 2], bw, bh, on_w, on_h);
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

// ------------------------------------------------------------ mode info

void intra_frame_mode_info(State& s) {
  SymbolReader& sr = s.sr;
  Cdfs& cdf = s.cdf;
  const int r = s.mi_row, c = s.mi_col;
  const int skip_ctx = (s.avail_u ? s.at(r - 1, c).skip : 0) +
                       (s.avail_l ? s.at(r, c - 1).skip : 0);
  s.skip = sr.symbol(cdf.skip[skip_ctx], 2);
  if (s.skip) count(kToolSkip);
  s.is_inter = s.fh->intrabc && sr.symbol(cdf.intrabc, 2);
  s.palette_size_y = s.palette_size_uv = 0;
  s.use_filter_intra = false;
  s.angle_y = s.angle_uv = 0;
  if (s.is_inter) {  // use_intrabc
    count(kToolIntrabc);
    s.y_mode = s.uv_mode = DC_PRED;
    intrabc_vector(s);
    return;
  }
  const int above = s.avail_u ? s.at(r - 1, c).y_mode : DC_PRED;
  const int left = s.avail_l ? s.at(r, c - 1).y_mode : DC_PRED;
  s.y_mode = sr.symbol(
      cdf.kf_y_mode[kIntraModeContext[above]][kIntraModeContext[left]], 13);
  if (s.mi_size >= BLOCK_8X8 && directional(s.y_mode))
    s.angle_y = sr.symbol(cdf.angle_delta[s.y_mode - V_PRED], 7) - 3;
  if (s.has_chroma) {
    // lossless: CfL only where the chroma block is 4x4
    if (s.mi_size == BLOCK_4X4)
      s.uv_mode = sr.symbol(cdf.uv_mode_cfl_allowed[s.y_mode], 14);
    else
      s.uv_mode = sr.symbol(cdf.uv_mode_cfl_not_allowed[s.y_mode], 13);
    if (s.uv_mode == UV_CFL_PRED) {
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
      s.angle_uv = sr.symbol(cdf.angle_delta[s.uv_mode - V_PRED], 7) - 3;
  } else {
    s.uv_mode = DC_PRED;
  }
  if (s.angle_y || s.angle_uv) count(kToolAngleDelta);
  const int bw = kNum4x4W[s.mi_size] * 4, bh = kNum4x4H[s.mi_size] * 4;
  if (s.mi_size >= BLOCK_8X8 && bw <= 64 && bh <= 64 && s.fh->screen_content)
    palette_mode_info(s);
  if (s.seq->filter_intra && s.y_mode == DC_PRED && s.palette_size_y == 0 &&
      std::max(bw, bh) <= 32) {
    s.use_filter_intra = sr.symbol(cdf.filter_intra[s.mi_size], 2);
    if (s.use_filter_intra) {
      s.filter_intra_mode = sr.symbol(cdf.filter_intra_mode, 5);
      count(kToolFilterIntra);
    }
  }
}

// ------------------------------------------------------------ residual

// 5.11.39 for a 4x4 transform block (every block of a lossless frame);
// returns eob, leaves the coefficients in quant
int coeffs(State& s, int plane, int start_x, int start_y, int32_t* quant) {
  SymbolReader& sr = s.sr;
  Cdfs& cdf = s.cdf;
  const int x4 = start_x >> 2, y4 = start_y >> 2;
  const int ptype = plane > 0;
  std::memset(quant, 0, 16 * sizeof(int32_t));
  int ctx;
  const int bsize = s.mi_size;  // 4:4:4 or monochrome
  if (plane == 0) {
    int top = x4 < s.mi_cols ? s.above_level[0][x4] : 0;
    int left = y4 < s.mi_rows ? s.left_level[0][y4] : 0;
    if (bsize == BLOCK_4X4) ctx = 0;
    else if (top == 0 && left == 0) ctx = 1;
    else if (top == 0 || left == 0) ctx = 2 + (std::max(top, left) > 3);
    else if (std::max(top, left) <= 3) ctx = 4;
    else if (std::min(top, left) <= 3) ctx = 5;
    else ctx = 6;
  } else {
    int above = 0, left = 0;
    if (x4 < s.mi_cols) above = s.above_level[plane][x4] | s.above_dc[plane][x4];
    if (y4 < s.mi_rows) left = s.left_level[plane][y4] | s.left_dc[plane][y4];
    ctx = 7 + (above != 0) + (left != 0);
    if (bsize != BLOCK_4X4) ctx += 3;
  }
  int eob = 0, cul_level = 0, dc_category = 0;
  if (!sr.symbol(cdf.txb_skip[0][ctx], 2)) {
    count(kToolCoefficients);
    const int eob_pt = sr.symbol(cdf.eob_pt_16[ptype][0], 5) + 1;
    eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
    if (eob_pt >= 3) {
      if (sr.symbol(cdf.eob_extra[0][ptype][eob_pt - 3], 2))
        eob += 1 << (eob_pt - 3);
      for (int i = 1; i < eob_pt - 2; i++)
        if (sr.literal(1)) eob += 1 << (eob_pt - 3 - i);
    }
    for (int c = eob - 1; c >= 0; c--) {
      const int pos = kDefaultScan4x4[c];
      const int row = pos >> 2, col = pos & 3;
      int level;
      if (c == eob - 1) {
        const int e = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
        level = sr.symbol(cdf.coeff_base_eob[0][ptype][e], 3) + 1;
      } else {
        int mag = 0;
        static const int kRef[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
        for (int k = 0; k < 5; k++) {
          const int rr = row + kRef[k][0], cc = col + kRef[k][1];
          if (rr < 4 && cc < 4) mag += std::min(std::abs(quant[rr * 4 + cc]), 3);
        }
        int bctx = std::min((mag + 1) >> 1, 4);
        bctx = pos == 0 ? 0 : bctx + kCoeffBaseCtxOffset4x4[row][col];
        level = sr.symbol(cdf.coeff_base[0][ptype][bctx], 4);
      }
      if (level > 2) {
        int mag = 0;
        static const int kRef[3][2] = {{0, 1}, {1, 0}, {1, 1}};
        for (int k = 0; k < 3; k++) {
          const int rr = row + kRef[k][0], cc = col + kRef[k][1];
          if (rr < 4 && cc < 4) mag += std::min(quant[rr * 4 + cc], 15);
        }
        mag = std::min((mag + 1) >> 1, 6);
        const int brctx = pos == 0 ? mag : (row < 2 && col < 2) ? mag + 7 : mag + 14;
        for (int idx = 0; idx < 4; idx++) {
          const int br = sr.symbol(cdf.coeff_br[0][ptype][brctx], 4);
          level += br;
          if (br < 3) break;
        }
      }
      quant[pos] = level;
    }
    for (int c = 0; c < eob; c++) {
      const int pos = kDefaultScan4x4[c];
      int sign = 0;
      if (quant[pos] != 0) {
        if (c == 0) {
          int dc_sign = 0;
          if (x4 < s.mi_cols) {
            const int a = s.above_dc[plane][x4];
            dc_sign += a == 1 ? -1 : a == 2 ? 1 : 0;
          }
          if (y4 < s.mi_rows) {
            const int l = s.left_dc[plane][y4];
            dc_sign += l == 1 ? -1 : l == 2 ? 1 : 0;
          }
          const int sctx = dc_sign < 0 ? 1 : dc_sign > 0 ? 2 : 0;
          sign = sr.symbol(cdf.dc_sign[ptype][sctx], 2);
          count(kToolDcSign);
        } else {
          sign = sr.literal(1);
        }
      }
      if (quant[pos] > 14) {
        int length = 0, bit;
        do {
          length++;
          bit = sr.literal(1);
          if (length > 20) corrupt("AV1 coefficient Golomb code longer than 20");
        } while (!bit);
        int x = 1;
        for (int i = length - 2; i >= 0; i--) x = (x << 1) | sr.literal(1);
        quant[pos] = x + 14;
        count(kToolGolomb);
      }
      if (pos == 0 && quant[pos] > 0) dc_category = sign ? 1 : 2;
      quant[pos] &= 0xFFFFF;
      cul_level += quant[pos];
      if (sign) quant[pos] = -quant[pos];
    }
    cul_level = std::min(63, cul_level);
  }
  s.above_level[plane][x4] = static_cast<uint8_t>(cul_level);
  s.above_dc[plane][x4] = static_cast<uint8_t>(dc_category);
  s.left_level[plane][y4] = static_cast<uint8_t>(cul_level);
  s.left_dc[plane][y4] = static_cast<uint8_t>(dc_category);
  return eob;
}

// transform_block (5.11.35) at 4x4: x, y the block's 4x4 index in its
// (plane) block
void transform_block(State& s, int plane, int base_x, int base_y, int x, int y) {
  const int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
  const int sb_mask = s.sb4 - 1;
  const int sub_row = (start_y >> 2) & sb_mask, sub_col = (start_x >> 2) & sb_mask;
  if (start_x >= s.mi_cols * 4 || start_y >= s.mi_rows * 4) return;
  if (!s.is_inter) {
    const int psize = plane == 0 ? s.palette_size_y : s.palette_size_uv;
    if (psize) {
      predict_palette(s, plane, start_x, start_y, x, y);
    } else {
      const bool cfl = plane > 0 && s.uv_mode == UV_CFL_PRED;
      const int mode = plane == 0 ? s.y_mode : cfl ? DC_PRED : s.uv_mode;
      predict_intra(s, plane, start_x, start_y, s.avail_l || x > 0,
                    s.avail_u || y > 0, s.decoded(plane, sub_row - 1, sub_col + 1),
                    s.decoded(plane, sub_row + 1, sub_col - 1), mode);
      if (cfl) predict_cfl(s, plane, start_x, start_y);
    }
    if (plane == 0) {
      s.max_luma_w = start_x + 4;
      s.max_luma_h = start_y + 4;
    }
  }
  if (!s.skip) {
    int32_t quant[16];
    if (coeffs(s, plane, start_x, start_y, quant) > 0)
      reconstruct(s, plane, start_x, start_y, quant);
  }
  s.block_decoded[plane][sub_row + 1][sub_col + 1] = 1;
}

void residual(State& s) {
  const int bw = kNum4x4W[s.mi_size], bh = kNum4x4H[s.mi_size];
  const int width_chunks = std::max(1, bw >> 4), height_chunks = std::max(1, bh >> 4);
  for (int cy = 0; cy < height_chunks; cy++)
    for (int cx = 0; cx < width_chunks; cx++)
      for (int plane = 0; plane < (s.has_chroma ? 3 : 1); plane++) {
        const int base_x = s.mi_col * 4, base_y = s.mi_row * 4;
        for (int y = 0; y < std::min(bh, 16); y++)
          for (int x = 0; x < std::min(bw, 16); x++)
            transform_block(s, plane, base_x, base_y, x + (cx << 4), y + (cy << 4));
      }
}

// ------------------------------------------------------------ blocks

void decode_block(State& s, int r, int c, int size) {
  s.mi_row = r;
  s.mi_col = c;
  s.mi_size = size;
  const int bw4 = kNum4x4W[size], bh4 = kNum4x4H[size];
  s.has_chroma = s.planes > 1;
  s.avail_u = s.inside(r - 1, c);
  s.avail_l = s.inside(r, c - 1);
  intra_frame_mode_info(s);
  palette_tokens(s);
  if (s.skip) {  // reset_block_context
    for (int plane = 0; plane < (s.has_chroma ? 3 : 1); plane++) {
      for (int i = c; i < std::min(c + bw4, s.mi_cols); i++)
        s.above_level[plane][i] = s.above_dc[plane][i] = 0;
      for (int i = r; i < std::min(r + bh4, s.mi_rows); i++)
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

void decode_partition(State& s, int r, int c, int bsize) {
  if (r >= s.mi_rows || c >= s.mi_cols) return;
  const bool avail_u = s.inside(r - 1, c), avail_l = s.inside(r, c - 1);
  const int num4 = kNum4x4W[bsize], half = num4 >> 1, quarter = half >> 1;
  const bool has_rows = (r + half) < s.mi_rows, has_cols = (c + half) < s.mi_cols;
  const int bsl = kMiWidthLog2[bsize];
  int partition;
  if (bsize < BLOCK_8X8) {
    partition = PARTITION_NONE;
  } else {
    const int above = avail_u && kMiWidthLog2[s.at(r - 1, c).size] < bsl;
    const int left = avail_l && kMiHeightLog2[s.at(r, c - 1).size] < bsl;
    uint16_t* cdf = s.cdf.partition[(bsl - 1) * 4 + left * 2 + above];
    const int n = bsl == 1 ? 4 : bsl == 5 ? 8 : 10;
    auto prob = [cdf](int e) { return (e > 0 ? cdf[e - 1] : 32768) - cdf[e]; };
    if (has_rows && has_cols) {
      partition = s.sr.symbol(cdf, n);
    } else if (has_cols) {  // split_or_horz
      int psum = prob(PARTITION_VERT) + prob(PARTITION_SPLIT) +
                 prob(PARTITION_HORZ_A) + prob(PARTITION_VERT_A) +
                 prob(PARTITION_VERT_B);
      if (bsize != BLOCK_128X128) psum += prob(PARTITION_VERT_4);
      uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
      partition = s.sr.symbol(tmp, 2) ? PARTITION_SPLIT : PARTITION_HORZ;
      count(kToolSplitOrHorz);
    } else if (has_rows) {  // split_or_vert
      int psum = prob(PARTITION_HORZ) + prob(PARTITION_SPLIT) +
                 prob(PARTITION_HORZ_A) + prob(PARTITION_HORZ_B) +
                 prob(PARTITION_VERT_A);
      if (bsize != BLOCK_128X128) psum += prob(PARTITION_HORZ_4);
      uint16_t tmp[3] = {static_cast<uint16_t>(psum), 0, 0};
      partition = s.sr.symbol(tmp, 2) ? PARTITION_SPLIT : PARTITION_VERT;
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
      decode_partition(s, r, c, sub);
      decode_partition(s, r, c + half, sub);
      decode_partition(s, r + half, c, sub);
      decode_partition(s, r + half, c + half, sub);
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

void clear_block_decoded(State& s, int r, int c) {
  for (int plane = 0; plane < s.planes; plane++) {
    const int w4 = s.mi_col_end - c, h4 = s.mi_row_end - r;
    for (int y = -1; y <= s.sb4; y++)
      for (int x = -1; x <= s.sb4; x++) {
        uint8_t v = 0;
        if (y < 0 && x < w4) v = 1;
        else if (x < 0 && y < h4) v = 1;
        s.block_decoded[plane][y + 1][x + 1] = v;
      }
    s.block_decoded[plane][s.sb4 + 1][0] = 0;
  }
}

}  // namespace

void decode_picture(const Picture& pic, Planes* out) {
  const SequenceHeader& seq = pic.seq;
  if (!seq.mono && (seq.ssx || seq.ssy))
    not_ported("lossless AV1 with subsampled chroma (4:2:0 or 4:2:2)");
  std::unique_ptr<State> owner(new State());
  State& s = *owner;
  s.seq = &seq;
  s.fh = &pic.frame;
  s.mi_rows = pic.frame.mi_rows;
  s.mi_cols = pic.frame.mi_cols;
  s.planes = seq.mono ? 1 : 3;
  s.bit_depth = seq.bit_depth;
  s.sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
  s.sb4 = seq.sb128 ? 32 : 16;
  count(seq.sb128 ? kToolSb128 : kToolSb64);
  count(seq.bit_depth == 8 ? kToolDepth8 : seq.bit_depth == 10 ? kToolDepth10 : kToolDepth12);
  if (seq.mono) count(kToolMonochrome);
  const int sb_px = s.sb4 * 4;
  s.stride = (s.mi_cols * 4 + sb_px - 1) / sb_px * sb_px;
  s.rows = (s.mi_rows * 4 + sb_px - 1) / sb_px * sb_px;
  for (int p = 0; p < s.planes; p++) {
    s.frame[p].assign(static_cast<size_t>(s.stride) * s.rows, 0);
    s.above_level[p].assign(s.mi_cols + 32, 0);
    s.above_dc[p].assign(s.mi_cols + 32, 0);
    s.left_level[p].assign(s.mi_rows + 32, 0);
    s.left_dc[p].assign(s.mi_rows + 32, 0);
  }
  s.mi.assign(static_cast<size_t>(s.mi_rows) * s.mi_cols, MiInfo());
  s.mi_row_start = 0;
  s.mi_row_end = s.mi_rows;
  s.mi_col_start = 0;
  s.mi_col_end = s.mi_cols;
  init_cdfs(&s.cdf, pic.frame.base_q_idx);
  s.sr.init(pic.tile_data, pic.tile_size, pic.frame.disable_cdf_update);
  for (int r = 0; r < s.mi_rows; r += s.sb4) {
    for (int p = 0; p < s.planes; p++) {
      std::fill(s.left_level[p].begin(), s.left_level[p].end(), 0);
      std::fill(s.left_dc[p].begin(), s.left_dc[p].end(), 0);
    }
    for (int c = 0; c < s.mi_cols; c += s.sb4) {
      clear_block_decoded(s, r, c);
      decode_partition(s, r, c, s.sb_size);
      if (s.sr.overrun())
        corrupt("AV1 tile data ends before its last superblock");
    }
  }
  out->width = pic.frame.width;
  out->height = pic.frame.height;
  out->bit_depth = s.bit_depth;
  out->count = s.planes;
  for (int p = 0; p < s.planes; p++) {
    out->plane[p].resize(static_cast<size_t>(out->width) * out->height);
    for (int y = 0; y < out->height; y++)
      std::memcpy(out->plane[p].data() + static_cast<size_t>(y) * out->width,
                  s.px(p, y, 0), out->width * sizeof(uint16_t));
  }
}

}  // namespace av1
}  // namespace sdt
