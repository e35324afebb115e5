// Prediction in an AV1 key frame: every intra predictor at every
// transform size to 64x64 (7.11.2: DC, the directional modes with the
// intra edge filter, its corner and upsampling, smooth, Paeth, the
// recursive filter-intra predictor), palette (7.11.4), chroma from luma at
// 4:4:4 and 4:2:0 (7.11.5) and the intra block copy (7.11.3 with an
// integer vector), at 8, 10 and 12 bits.
#include <algorithm>
#include <cstdlib>
#include <vector>

#include "av1_state.h"
#include "av1_tables.h"

namespace sdt {
namespace av1 {

namespace {

inline int round2(int x, int n) { return n ? (x + (1 << (n - 1))) >> n : x; }
inline int round2_signed(int x, int n) {
  return x >= 0 ? round2(x, n) : -round2(-x, n);
}

bool is_smooth(State& s, int r, int c, int plane) {
  const MiInfo& m = s.at(r, c);
  const int mode = plane == 0 ? m.y_mode : m.uv_mode;
  return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
}

// get_filter_type: a smooth neighbour (the chroma one of a 4:2:0 block)
int filter_type(State& s, int plane) {
  bool above = false, left = false;
  if (plane == 0 ? s.avail_u : s.avail_u_chroma) {
    int r = s.mi_row - 1, c = s.mi_col;
    if (plane > 0) {
      if (s.ssx && !(s.mi_col & 1)) c++;
      if (s.ssy && (s.mi_row & 1)) r--;
    }
    above = is_smooth(s, r, c, plane);
  }
  if (plane == 0 ? s.avail_l : s.avail_l_chroma) {
    int r = s.mi_row, c = s.mi_col - 1;
    if (plane > 0) {
      if (s.ssx && (s.mi_col & 1)) c--;
      if (s.ssy && !(s.mi_row & 1)) r++;
    }
    left = is_smooth(s, r, c, plane);
  }
  return above || left;
}

// 7.11.2.9 intra_edge_filter_strength_selection
int edge_strength(int w, int h, int filter, int delta) {
  const int d = std::abs(delta), wh = w + h;
  int st = 0;
  if (filter == 0) {
    if (wh <= 8) { if (d >= 56) st = 1; }
    else if (wh <= 16) { if (d >= 40) st = 1; }
    else if (wh <= 24) { if (d >= 8) st = 1; if (d >= 16) st = 2; if (d >= 32) st = 3; }
    else if (wh <= 32) { if (d >= 1) st = 1; if (d >= 4) st = 2; if (d >= 32) st = 3; }
    else { if (d >= 1) st = 3; }
  } else {
    if (wh <= 8) { if (d >= 40) st = 1; if (d >= 64) st = 2; }
    else if (wh <= 16) { if (d >= 20) st = 1; if (d >= 48) st = 2; }
    else if (wh <= 24) { if (d >= 4) st = 3; }
    else { if (d >= 1) st = 3; }
  }
  return st;
}

// 7.11.2.10 use_intra_edge_upsample
bool use_upsample(int w, int h, int filter, int delta) {
  const int d = std::abs(delta);
  if (d <= 0 || d >= 40) return false;
  return filter ? w + h <= 8 : w + h <= 16;
}

// 7.11.2.12 on edge[-1 .. sz - 2]
void filter_edge(int* edge, int sz, int strength) {
  if (!strength) return;
  static const int kKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
  int copy[288];
  for (int i = 0; i < sz; i++) copy[i] = edge[i - 1];
  for (int i = 1; i < sz; i++) {
    int sum = 0;
    for (int j = 0; j < 5; j++) {
      const int k = std::min(std::max(i + j - 2, 0), sz - 1);
      sum += kKernel[strength - 1][j] * copy[k];
    }
    edge[i - 1] = (sum + 8) >> 4;
  }
}

// 7.11.2.11 on buf[-1 .. num_px - 1], into buf[-2 .. 2 * num_px - 2]
void upsample_edge(int* buf, int num_px, int bd) {
  int dup[288];
  dup[0] = buf[-1];
  for (int i = -1; i < num_px; i++) dup[i + 2] = buf[i];
  dup[num_px + 2] = buf[num_px - 1];
  buf[-2] = dup[0];
  const int mx = (1 << bd) - 1;
  for (int i = 0; i < num_px; i++) {
    int sum = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
    sum = std::min(std::max(round2(sum, 4), 0), mx);
    buf[2 * i - 1] = sum;
    buf[2 * i] = dup[i + 2];
  }
}

}  // namespace


void predict_intra(State& s, int plane, int x, int y, bool have_left,
                   bool have_above, bool have_above_rt, bool have_below_lft,
                   int mode, int log2w, int log2h) {
  const int w = 1 << log2w, h = 1 << log2h;
  const int bd = s.bit_depth;
  const int max_x = ((s.mi_cols * 4) >> s.sub_x(plane)) - 1;
  const int max_y = ((s.mi_rows * 4) >> s.sub_y(plane)) - 1;
  const int mid = 1 << (bd - 1), mx = (1 << bd) - 1;
  int above_buf[288], left_buf[288];
  int* above = above_buf + 16;
  int* left = left_buf + 16;
  const int n = w + h;
  for (int i = 0; i < n; i++) {
    if (!have_above && have_left) above[i] = *s.px(plane, y, x - 1);
    else if (!have_above) above[i] = mid - 1;
    else {
      const int limit = std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
      above[i] = *s.px(plane, y - 1, std::min(limit, x + i));
    }
    if (!have_left && have_above) left[i] = *s.px(plane, y - 1, x);
    else if (!have_left) left[i] = mid + 1;
    else {
      const int limit = std::min(max_y, y + (have_below_lft ? 2 * h : h) - 1);
      left[i] = *s.px(plane, std::min(limit, y + i), x - 1);
    }
  }
  if (have_above && have_left) above[-1] = *s.px(plane, y - 1, x - 1);
  else if (have_above) above[-1] = *s.px(plane, y - 1, x);
  else if (have_left) above[-1] = *s.px(plane, y, x - 1);
  else above[-1] = mid;
  left[-1] = above[-1];

  int pred_buf[64 * 64];
  auto pred = [&](int i, int j) -> int& { return pred_buf[i * w + j]; };
  if (plane == 0 && s.use_filter_intra) {  // 7.11.2.3
    const int mode_fi = s.filter_intra_mode;
    for (int i2 = 0; i2 < (h >> 1); i2++)
      for (int j4 = 0; j4 < (w >> 2); j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
            else p[i] = pred((i2 << 1) - 1, (j4 << 2) + i - 1);
          } else {
            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
            else p[i] = pred((i2 << 1) + i - 5, (j4 << 2) - 1);
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[mode_fi][i][j] * p[j];
          pred((i2 << 1) + (i >> 2), (j4 << 2) + (i & 3)) =
              std::min(std::max(round2_signed(pr, 4), 0), mx);
        }
      }
  } else if (mode >= V_PRED && mode <= D67_PRED) {  // 7.11.2.4
    const int p_angle = kModeToAngle[mode] +
                        (plane == 0 ? s.angle_y : s.angle_uv) * 3;
    int up_above = 0, up_left = 0;
    if (p_angle == 90 || p_angle == 180) {
      count(p_angle == 90 ? kToolVPred : kToolHPred);
    } else {
      count(kToolDirectional);
    }
    if (s.seq->intra_edge_filter) {
      const int ft = filter_type(s, plane);
      if (p_angle != 90 && p_angle != 180) {
        if (p_angle > 90 && p_angle < 180 && w + h >= 24) {
          // the corner (7.11.2.7)
          const int c = round2(left[0] * 5 + above[-1] * 6 + above[0] * 5, 4);
          above[-1] = left[-1] = c;
        }
        if (have_above) {
          const int st = edge_strength(w, h, ft, p_angle - 90);
          const int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
          if (st) count(kToolEdgeFilter);
          filter_edge(above, num, st);
        }
        if (have_left) {
          const int st = edge_strength(w, h, ft, p_angle - 180);
          const int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
          if (st) count(kToolEdgeFilter);
          filter_edge(left, num, st);
        }
      }
      up_above = use_upsample(w, h, ft, p_angle - 90);
      if (up_above) {
        upsample_edge(above, w + (p_angle < 90 ? h : 0), bd);
        count(kToolEdgeUpsample);
      }
      up_left = use_upsample(w, h, ft, p_angle - 180);
      if (up_left) {
        upsample_edge(left, h + (p_angle > 180 ? w : 0), bd);
        count(kToolEdgeUpsample);
      }
    }
    int dx = 0, dy = 0;
    if (p_angle < 90) dx = kDrIntraDerivative[p_angle];
    else if (p_angle > 90 && p_angle < 180) dx = kDrIntraDerivative[180 - p_angle];
    if (p_angle > 90 && p_angle < 180) dy = kDrIntraDerivative[p_angle - 90];
    else if (p_angle > 180) dy = kDrIntraDerivative[270 - p_angle];
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        int v;
        if (p_angle == 90) {
          v = above[j];
        } else if (p_angle == 180) {
          v = left[i];
        } else if (p_angle < 90) {
          const int idx = (i + 1) * dx;
          const int base = (idx >> (6 - up_above)) + (j << up_above);
          const int shift = ((idx << up_above) >> 1) & 0x1F;
          const int max_base = (w + h - 1) << up_above;
          v = base < max_base
                  ? round2(above[base] * (32 - shift) + above[base + 1] * shift, 5)
                  : above[max_base];
        } else if (p_angle < 180) {
          int idx = (j << 6) - (i + 1) * dx;
          int base = idx >> (6 - up_above);
          if (base >= -(1 << up_above)) {
            const int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
            v = round2(above[base] * (32 - shift) + above[base + 1] * shift, 5);
          } else {
            idx = (i << 6) - (j + 1) * dy;
            base = idx >> (6 - up_left);
            const int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
            v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
          }
        } else {
          const int idx = (j + 1) * dy;
          const int base = (idx >> (6 - up_left)) + (i << up_left);
          const int shift = ((idx << up_left) >> 1) & 0x1F;
          v = round2(left[base] * (32 - shift) + left[base + 1] * shift, 5);
        }
        pred(i, j) = v;
      }
  } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
    // the weights of each size follow those of the sizes below it
    const uint8_t* wx = kSmoothWeights + w - 4;
    const uint8_t* wy = kSmoothWeights + h - 4;
    count(mode == SMOOTH_PRED ? kToolSmooth : mode == SMOOTH_V_PRED ? kToolSmoothV : kToolSmoothH);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        if (mode == SMOOTH_PRED) {
          const int sum = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                          wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
          pred(i, j) = round2(sum, 9);
        } else if (mode == SMOOTH_V_PRED) {
          pred(i, j) = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
        } else {
          pred(i, j) = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
        }
      }
  } else if (mode == DC_PRED) {
    count(kToolDcPred);
    int avg;
    if (have_left && have_above) {
      int sum = 0;
      for (int k = 0; k < w; k++) sum += above[k];
      for (int k = 0; k < h; k++) sum += left[k];
      avg = (sum + ((w + h) >> 1)) / (w + h);
    } else if (have_left) {
      int sum = 0;
      for (int k = 0; k < h; k++) sum += left[k];
      avg = std::min(std::max((sum + (h >> 1)) >> log2h, 0), mx);
    } else if (have_above) {
      int sum = 0;
      for (int k = 0; k < w; k++) sum += above[k];
      avg = std::min(std::max((sum + (w >> 1)) >> log2w, 0), mx);
    } else {
      avg = mid;
    }
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) pred(i, j) = avg;
  } else {  // PAETH_PRED
    count(kToolPaeth);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int base = above[j] + left[i] - above[-1];
        const int p_left = std::abs(base - left[i]);
        const int p_top = std::abs(base - above[j]);
        const int p_top_left = std::abs(base - above[-1]);
        if (p_left <= p_top && p_left <= p_top_left) pred(i, j) = left[i];
        else if (p_top <= p_top_left) pred(i, j) = above[j];
        else pred(i, j) = above[-1];
      }
  }
  for (int i = 0; i < h; i++) {
    uint16_t* row = s.px(plane, y + i, x);
    for (int j = 0; j < w; j++) row[j] = static_cast<uint16_t>(pred(i, j));
  }
}

void predict_palette(State& s, int plane, int start_x, int start_y, int x,
                     int y, int tx) {
  const int w = 1 << kTxWidthLog2[tx], h = 1 << kTxHeightLog2[tx];
  const uint16_t* palette = s.palette[plane];
  uint8_t (*map)[64] = plane == 0 ? s.color_map_y : s.color_map_uv;
  for (int i = 0; i < h; i++) {
    uint16_t* row = s.px(plane, start_y + i, start_x);
    for (int j = 0; j < w; j++) row[j] = palette[map[y * 4 + i][x * 4 + j]];
  }
}

void predict_cfl(State& s, int plane, int start_x, int start_y, int tx) {
  const int w = 1 << kTxWidthLog2[tx], h = 1 << kTxHeightLog2[tx];
  const int subx = s.ssx, suby = s.ssy;
  const int alpha = plane == 1 ? s.cfl_alpha_u : s.cfl_alpha_v;
  const int mx = (1 << s.bit_depth) - 1;
  int luma[32 * 32];  // CfL blocks are 32x32 or less
  int avg = 0;
  for (int i = 0; i < h; i++) {
    const int ly = std::min((start_y + i) << suby, s.max_luma_h - (1 << suby));
    for (int j = 0; j < w; j++) {
      const int lx = std::min((start_x + j) << subx, s.max_luma_w - (1 << subx));
      int t = 0;
      for (int dy = 0; dy <= suby; dy++)
        for (int dx = 0; dx <= subx; dx++) t += *s.px(0, ly + dy, lx + dx);
      const int v = t << (3 - subx - suby);
      luma[i * w + j] = v;
      avg += v;
    }
  }
  avg = round2(avg, kTxWidthLog2[tx] + kTxHeightLog2[tx]);
  for (int i = 0; i < h; i++) {
    uint16_t* row = s.px(plane, start_y + i, start_x);
    for (int j = 0; j < w; j++) {
      const int v = row[j] + round2_signed(alpha * (luma[i * w + j] - avg), 6);
      row[j] = static_cast<uint16_t>(std::min(std::max(v, 0), mx));
    }
  }
}

void predict_intrabc(State& s) {
  // the block inter prediction of 7.11.3.4 with the current frame as the
  // reference and the bilinear filter: an integer vector copies luma (and
  // 4:4:4 chroma); 4:2:0 chroma takes half a sample where the vector is
  // odd. One prediction for the whole chroma block (an intra block copy
  // counts as intra for 7.11.3.1's someUseIntra).
  const int bd = s.bit_depth, mx = (1 << bd) - 1;
  const int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
  for (int plane = 0; plane < (s.has_chroma ? s.planes : 1); plane++) {
    const int subx = s.sub_x(plane), suby = s.sub_y(plane);
    const int w = std::max(4, (kNum4x4W[s.mi_size] * 4) >> subx);
    const int h = std::max(4, (kNum4x4H[s.mi_size] * 4) >> suby);
    const int x0 = (s.mi_col >> subx) * 4, y0 = (s.mi_row >> suby) * 4;
    const int last_x = ((s.fh->width + subx) >> subx) - 1;
    const int last_y = ((s.fh->height + suby) >> suby) - 1;
    // positions in sixteenths of a sample
    const int dx = (2 * s.mv[1]) >> subx, dy = (2 * s.mv[0]) >> suby;
    const int fx = dx & 15, fy = dy & 15;
    const int ix = x0 + (dx >> 4), iy = y0 + (dy >> 4);
    if (fx || fy) count(kToolIntrabcSubpel);
    std::vector<int> inter(static_cast<size_t>(h + 1) * w);
    for (int r = 0; r <= h; r++) {
      const uint16_t* row = s.px(plane, std::min(std::max(iy + r, 0), last_y), 0);
      for (int c = 0; c < w; c++) {
        const int a = row[std::min(std::max(ix + c, 0), last_x)];
        const int b = row[std::min(std::max(ix + c + 1, 0), last_x)];
        inter[static_cast<size_t>(r) * w + c] =
            ((128 - 8 * fx) * a + 8 * fx * b + (1 << (round0 - 1))) >> round0;
      }
    }
    for (int r = 0; r < h; r++)
      for (int c = 0; c < w; c++) {
        const int v = ((128 - 8 * fy) * inter[static_cast<size_t>(r) * w + c] +
                       8 * fy * inter[static_cast<size_t>(r + 1) * w + c] +
                       (1 << (round1 - 1))) >> round1;
        *s.px(plane, y0 + r, x0 + c) = static_cast<uint16_t>(std::min(std::max(v, 0), mx));
      }
  }
}

}  // namespace av1
}  // namespace sdt
