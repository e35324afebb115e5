// Prediction and reconstruction of a lossless AV1 key frame: every intra
// predictor at the 4x4 transform blocks a lossless frame predicts, where
// the edge filter and upsampling take their 4x4 strengths (7.11.2:
// DC, the directional modes with the intra edge filter and upsampling,
// smooth, Paeth, the recursive filter-intra predictor), palette (7.11.4),
// chroma from luma (7.11.5), the intra block copy (7.11.3 with an integer
// vector) and the lossless dequantisation and inverse Walsh-Hadamard
// transform (7.12.3, 7.13.3), at 8, 10 and 12 bits.
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

bool is_smooth(const MiInfo& m, int plane) {
  const int mode = plane == 0 ? m.y_mode : m.uv_mode;
  return mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED;
}

int filter_type(State& s, int plane) {
  bool above = false, left = false;
  if (s.avail_u) above = is_smooth(s.at(s.mi_row - 1, s.mi_col), plane);
  if (s.avail_l) left = is_smooth(s.at(s.mi_row, s.mi_col - 1), plane);
  return above || left;
}

// 7.11.2.9 and 7.11.2.10 for a 4x4 block (w + h = 8)
int edge_strength(int filter, int delta) {
  const int d = std::abs(delta);
  if (filter == 0) return d >= 56 ? 1 : 0;
  return d >= 64 ? 2 : d >= 40 ? 1 : 0;
}

bool use_upsample(int delta) {
  const int d = std::abs(delta);
  return d > 0 && d < 40;
}

// 7.11.2.12 on edge[-1 .. sz - 2]
void filter_edge(int* edge, int sz, int strength) {
  if (!strength) return;
  static const int kKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};
  int copy[80];
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
  int dup[80];
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
                   int mode) {
  constexpr int w = 4, h = 4, log2w = 2, log2h = 2;
  const int bd = s.bit_depth;
  const int max_x = s.mi_cols * 4 - 1, max_y = s.mi_rows * 4 - 1;
  const int mid = 1 << (bd - 1), mx = (1 << bd) - 1;
  int above_buf[96], left_buf[96];
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

  int pred[4][4];
  if (plane == 0 && s.use_filter_intra) {  // 7.11.2.3
    const int mode_fi = s.filter_intra_mode;
    for (int i2 = 0; i2 < (h >> 1); i2++)
      for (int j4 = 0; j4 < (w >> 2); j4++) {
        int p[7];
        for (int i = 0; i < 7; i++) {
          if (i < 5) {
            if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
            else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
            else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
          } else {
            if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
            else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
          }
        }
        for (int i = 0; i < 8; i++) {
          int pr = 0;
          for (int j = 0; j < 7; j++) pr += kFilterIntraTaps[mode_fi][i][j] * p[j];
          pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] =
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
        if (have_above) {
          const int st = edge_strength(ft, p_angle - 90);
          const int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
          if (st) count(kToolEdgeFilter);
          filter_edge(above, num, st);
        }
        if (have_left) {
          const int st = edge_strength(ft, p_angle - 180);
          const int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
          if (st) count(kToolEdgeFilter);
          filter_edge(left, num, st);
        }
      }
      up_above = use_upsample(p_angle - 90);
      if (up_above) {
        upsample_edge(above, w + (p_angle < 90 ? h : 0), bd);
        count(kToolEdgeUpsample);
      }
      up_left = use_upsample(p_angle - 180);
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
        pred[i][j] = v;
      }
  } else if (mode == SMOOTH_PRED || mode == SMOOTH_V_PRED || mode == SMOOTH_H_PRED) {
    const uint8_t* wx = kSmoothWeights;  // the weights of size 4
    const uint8_t* wy = kSmoothWeights;
    count(mode == SMOOTH_PRED ? kToolSmooth : mode == SMOOTH_V_PRED ? kToolSmoothV : kToolSmoothH);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        if (mode == SMOOTH_PRED) {
          const int sum = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] +
                          wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
          pred[i][j] = round2(sum, 9);
        } else if (mode == SMOOTH_V_PRED) {
          pred[i][j] = round2(wy[i] * above[j] + (256 - wy[i]) * left[h - 1], 8);
        } else {
          pred[i][j] = round2(wx[j] * left[i] + (256 - wx[j]) * above[w - 1], 8);
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
      for (int j = 0; j < w; j++) pred[i][j] = avg;
  } else {  // PAETH_PRED
    count(kToolPaeth);
    for (int i = 0; i < h; i++)
      for (int j = 0; j < w; j++) {
        const int base = above[j] + left[i] - above[-1];
        const int p_left = std::abs(base - left[i]);
        const int p_top = std::abs(base - above[j]);
        const int p_top_left = std::abs(base - above[-1]);
        if (p_left <= p_top && p_left <= p_top_left) pred[i][j] = left[i];
        else if (p_top <= p_top_left) pred[i][j] = above[j];
        else pred[i][j] = above[-1];
      }
  }
  for (int i = 0; i < h; i++) {
    uint16_t* row = s.px(plane, y + i, x);
    for (int j = 0; j < w; j++) row[j] = static_cast<uint16_t>(pred[i][j]);
  }
}

void predict_palette(State& s, int plane, int start_x, int start_y, int x, int y) {
  const uint16_t* palette = s.palette[plane];
  uint8_t (*map)[64] = plane == 0 ? s.color_map_y : s.color_map_uv;
  for (int i = 0; i < 4; i++) {
    uint16_t* row = s.px(plane, start_y + i, start_x);
    for (int j = 0; j < 4; j++) row[j] = palette[map[y * 4 + i][x * 4 + j]];
  }
}

void predict_cfl(State& s, int plane, int start_x, int start_y) {
  const int alpha = plane == 1 ? s.cfl_alpha_u : s.cfl_alpha_v;
  const int mx = (1 << s.bit_depth) - 1;
  int luma[4][4], avg = 0;
  for (int i = 0; i < 4; i++) {
    const int ly = std::min(start_y + i, s.max_luma_h - 1);
    for (int j = 0; j < 4; j++) {
      const int lx = std::min(start_x + j, s.max_luma_w - 1);
      luma[i][j] = *s.px(0, ly, lx) << 3;
      avg += luma[i][j];
    }
  }
  avg = round2(avg, 4);
  for (int i = 0; i < 4; i++) {
    uint16_t* row = s.px(plane, start_y + i, start_x);
    for (int j = 0; j < 4; j++) {
      const int v = row[j] + round2_signed(alpha * (luma[i][j] - avg), 6);
      row[j] = static_cast<uint16_t>(std::min(std::max(v, 0), mx));
    }
  }
}

void predict_intrabc(State& s) {
  const int bw = kNum4x4W[s.mi_size] * 4, bh = kNum4x4H[s.mi_size] * 4;
  const int x0 = s.mi_col * 4, y0 = s.mi_row * 4;
  const int dy = s.mv[0] >> 3, dx = s.mv[1] >> 3;
  const int last_x = s.fh->width - 1, last_y = s.fh->height - 1;
  std::vector<uint16_t> tmp(static_cast<size_t>(bw) * bh);
  for (int plane = 0; plane < s.planes; plane++) {
    for (int i = 0; i < bh; i++)
      for (int j = 0; j < bw; j++) {
        const int yy = std::min(std::max(y0 + i + dy, 0), last_y);
        const int xx = std::min(std::max(x0 + j + dx, 0), last_x);
        tmp[i * bw + j] = *s.px(plane, yy, xx);
      }
    for (int i = 0; i < bh && y0 + i < s.rows; i++)
      for (int j = 0; j < bw && x0 + j < s.stride; j++)
        *s.px(plane, y0 + i, x0 + j) = tmp[i * bw + j];
  }
}

void reconstruct(State& s, int plane, int x, int y, const int32_t* quant) {
  count(kToolWht);
  const int bd = s.bit_depth, mx = (1 << bd) - 1;
  const int lim = 1 << (7 + bd);
  int t[16];
  for (int k = 0; k < 16; k++) {
    // dequantisation at qindex 0: 4 for the DC and every AC coefficient
    int64_t dq = static_cast<int64_t>(std::abs(quant[k])) * 4;
    dq &= 0xFFFFFF;
    if (quant[k] < 0) dq = -dq;
    t[k] = static_cast<int>(std::min<int64_t>(std::max<int64_t>(dq, -lim), lim - 1));
  }
  auto wht = [](int* v, int step, int shift) {
    int a = v[0] >> shift, c = v[step] >> shift, d = v[2 * step] >> shift,
        b = v[3 * step] >> shift;
    a += c;
    d -= b;
    const int e = (a - d) >> 1;
    b = e - b;
    c = e - c;
    a -= b;
    d += c;
    v[0] = a;
    v[step] = b;
    v[2 * step] = c;
    v[3 * step] = d;
  };
  for (int i = 0; i < 4; i++) wht(t + 4 * i, 1, 2);  // rows
  for (int j = 0; j < 4; j++) wht(t + j, 4, 0);      // columns
  for (int i = 0; i < 4; i++) {
    uint16_t* row = s.px(plane, y + i, x);
    for (int j = 0; j < 4; j++)
      row[j] = static_cast<uint16_t>(std::min(std::max(row[j] + t[4 * i + j], 0), mx));
  }
}

}  // namespace av1
}  // namespace sdt
