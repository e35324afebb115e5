// CDEF, the constrained directional enhancement filter of an AV1 key frame
// (7.15): each 8x8 luma block (4x4 chroma at 4:2:0) of a 64x64 whose
// cdef_idx is set and that is not all skipped takes its direction from the
// deblocked luma (7.15.2), then the primary taps along it and the
// secondary taps at 45 degrees, each difference constrained by its
// strength and damping (7.15.3). Every tap reads the deblocked frame, never
// a filtered sample; samples outside the frame's 4x4 units are not taken.
#include <algorithm>
#include <cstdlib>
#include <vector>

#include "av1_state.h"
#include "av1_tables.h"

namespace sdt {
namespace av1 {

namespace {

int floor_log2(int x) {
  int s = 0;
  while (x > 1) {
    x >>= 1;
    s++;
  }
  return s;
}

// 7.15.2: the direction of the 8x8 luma block at (x0, y0) and its variance
void direction(const std::vector<uint16_t>& src, int stride, int x0, int y0,
               int bd, int* dir, int* var) {
  int cost[8] = {}, partial[8][15] = {};
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 8; j++) {
      const int x = (src[static_cast<size_t>(y0 + i) * stride + x0 + j] >> (bd - 8)) - 128;
      partial[0][i + j] += x;
      partial[1][i + j / 2] += x;
      partial[2][i] += x;
      partial[3][3 + i - j / 2] += x;
      partial[4][7 + i - j] += x;
      partial[5][3 - i / 2 + j] += x;
      partial[6][j] += x;
      partial[7][i / 2 + j] += x;
    }
  for (int i = 0; i < 8; i++) {
    cost[2] += partial[2][i] * partial[2][i];
    cost[6] += partial[6][i] * partial[6][i];
  }
  cost[2] *= kCdefDivTable[8];
  cost[6] *= kCdefDivTable[8];
  for (int i = 0; i < 7; i++) {
    cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) *
               kCdefDivTable[i + 1];
    cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) *
               kCdefDivTable[i + 1];
  }
  cost[0] += partial[0][7] * partial[0][7] * kCdefDivTable[8];
  cost[4] += partial[4][7] * partial[4][7] * kCdefDivTable[8];
  for (int i = 1; i < 8; i += 2) {
    for (int j = 0; j < 5; j++) cost[i] += partial[i][3 + j] * partial[i][3 + j];
    cost[i] *= kCdefDivTable[8];
    for (int j = 0; j < 3; j++)
      cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) *
                 kCdefDivTable[2 * j + 2];
  }
  int best = 0, best_dir = 0;
  for (int d = 0; d < 8; d++)
    if (cost[d] > best) {
      best = cost[d];
      best_dir = d;
    }
  *dir = best_dir;
  *var = (best - cost[(best_dir + 4) & 7]) >> 10;
}

// Cdef_Uv_Dir: the chroma direction of a luma one, by subsampling x and y
constexpr int kCdefUvDir[2][2][8] = {
    {{0, 1, 2, 3, 4, 5, 6, 7}, {1, 2, 2, 2, 3, 4, 6, 0}},
    {{7, 0, 2, 4, 5, 6, 6, 6}, {0, 1, 2, 3, 4, 5, 6, 7}}};

int constrain(int diff, int threshold, int damping) {
  if (!threshold) return 0;
  const int adj = std::max(0, damping - floor_log2(threshold));
  const int val = std::min(std::abs(diff), std::max(0, threshold - (std::abs(diff) >> adj)));
  return diff < 0 ? -val : val;
}

// 7.15.3 on the block of a plane at mi (r, c)
void filter_block(State& s, const std::vector<uint16_t>& src, int plane, int r,
                  int c, int pri, int sec, int damping, int dir) {
  const int subx = s.sub_x(plane), suby = s.sub_y(plane);
  const int x0 = (c * 4) >> subx, y0 = (r * 4) >> suby;
  const int w = 8 >> subx, h = 8 >> suby;
  const int stride = s.stride[plane];
  const int shift = s.bit_depth - 8;
  const int max_y = (s.mi_rows * 4) >> suby, max_x = (s.mi_cols * 4) >> subx;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int x = src[static_cast<size_t>(y0 + i) * stride + x0 + j];
      int sum = 0, mx = x, mn = x;
      auto tap = [&](int di, int dj, bool* ok) {
        const int y = y0 + i + di, xx = x0 + j + dj;
        *ok = y >= 0 && y < max_y && xx >= 0 && xx < max_x;
        return *ok ? static_cast<int>(src[static_cast<size_t>(y) * stride + xx]) : 0;
      };
      for (int k = 0; k < 2; k++)
        for (int sign = -1; sign <= 1; sign += 2) {
          bool ok;
          const int p = tap(sign * kCdefDirections[dir][k][0], sign * kCdefDirections[dir][k][1], &ok);
          if (ok) {
            sum += kCdefPriTaps[(pri >> shift) & 1][k] * constrain(p - x, pri, damping);
            mx = std::max(p, mx);
            mn = std::min(p, mn);
          }
          for (int off = -2; off <= 2; off += 4) {
            const int d2 = (dir + off) & 7;
            const int q = tap(sign * kCdefDirections[d2][k][0], sign * kCdefDirections[d2][k][1], &ok);
            if (ok) {
              sum += kCdefSecTaps[(pri >> shift) & 1][k] * constrain(q - x, sec, damping);
              mx = std::max(q, mx);
              mn = std::min(q, mn);
            }
          }
        }
      const int v = x + ((8 + sum - (sum < 0)) >> 4);
      *s.px(plane, y0 + i, x0 + j) = static_cast<uint16_t>(std::min(std::max(v, mn), mx));
    }
}

}  // namespace

void cdef_frame(State& s) {
  const FrameHeader& fh = *s.fh;
  const int bd = s.bit_depth, shift = bd - 8;
  std::vector<uint16_t> src[3];  // the deblocked frame every tap reads
  for (int p = 0; p < s.planes; p++) src[p] = s.frame[p];
  for (int r = 0; r < s.mi_rows; r += 2)
    for (int c = 0; c < s.mi_cols; c += 2) {
      const int idx = s.cdef_idx[static_cast<size_t>(r >> 4) * s.cdef_cols + (c >> 4)];
      if (idx < 0) continue;  // no coded block in the 64x64
      if (s.at(r, c).skip && s.at(r + 1, c).skip && s.at(r, c + 1).skip &&
          s.at(r + 1, c + 1).skip)
        continue;
      count(kToolCdef);
      int y_dir, var;
      direction(src[0], s.stride[0], c * 4, r * 4, bd, &y_dir, &var);
      int pri = fh.cdef_y_pri[idx] << shift, sec = fh.cdef_y_sec[idx] << shift;
      int dir = pri ? y_dir : 0;
      const int var_str = (var >> 6) ? std::min(floor_log2(var >> 6), 12) : 0;
      pri = var ? (pri * (4 + var_str) + 8) >> 4 : 0;
      int damping = fh.cdef_damping + shift;
      if (pri || sec) filter_block(s, src[0], 0, r, c, pri, sec, damping, dir);
      if (s.planes > 1) {
        pri = fh.cdef_uv_pri[idx] << shift;
        sec = fh.cdef_uv_sec[idx] << shift;
        dir = pri ? kCdefUvDir[s.ssx][s.ssy][y_dir] : 0;
        damping = fh.cdef_damping + shift - 1;
        if (pri || sec)
          for (int p = 1; p < 3; p++) filter_block(s, src[p], p, r, c, pri, sec, damping, dir);
      }
    }
}

}  // namespace av1
}  // namespace sdt
