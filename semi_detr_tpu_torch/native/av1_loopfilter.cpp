// The deblocking filter of an AV1 key frame (7.14): every transform edge of
// each plane, first the vertical edges of the whole plane, then the
// horizontal ones; the filter length from the smaller of the two transform
// sizes (4, 8 or 14 taps for luma, 4 or 6 for chroma), the level from the
// frame's levels with the reference delta of INTRA_FRAME, the limits from
// the sharpness; the masks, the narrow filter and the wide filters of
// 7.14.6, at 8, 10 and 12 bits.
#include <algorithm>
#include <cstdlib>

#include "av1_state.h"

namespace sdt {
namespace av1 {

namespace {

struct Limits {
  int lvl, limit, blimit, thresh;
};

// 7.14.4: the filter level of a plane and pass, and its limits. Without
// segmentation or delta loop filter levels every intra block of the frame
// shares them.
Limits limits(const State& s, int plane, int pass) {
  const FrameHeader& fh = *s.fh;
  const int i = plane == 0 ? pass : plane + 1;
  int lvl = std::min(std::max(fh.lf_level[i], 0), 63);
  if (fh.lf_delta_enabled) {
    const int shift = lvl >> 5;
    lvl = std::min(std::max(lvl + fh.lf_ref_deltas[0] * (1 << shift), 0), 63);
  }
  const int sh = fh.lf_sharpness;
  const int shift = sh > 4 ? 2 : sh > 0 ? 1 : 0;
  int limit = sh > 0 ? std::min(std::max(lvl >> shift, 1), 9 - sh)
                     : std::max(1, lvl >> shift);
  return {lvl, limit, 2 * (lvl + 2) + limit, lvl >> 4};
}

// 7.14.6: the filters across one sample of the edge; at(k) is the sample
// k from the edge (k < 0 before it, p_{-k-1}; k >= 0 after it, q_k)
template <typename At>
void sample_filter(At at, int size, const Limits& l, int bd, int plane) {
  const int shift = bd - 8;
  const int limit = l.limit << shift, blimit = l.blimit << shift,
            thresh = l.thresh << shift, flat_th = 1 << shift;
  const int q0 = at(0), q1 = at(1), p0 = at(-1), p1 = at(-2);
  const bool hev = std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
  bool mask = std::abs(p1 - p0) <= limit && std::abs(q1 - q0) <= limit &&
              std::abs(p0 - q0) * 2 + std::abs(p1 - q1) / 2 <= blimit;
  bool flat = false, flat2 = false;
  // a chroma edge of 8 or more takes the 6-tap filter
  const int taps = size == 4 ? 4 : plane > 0 ? 6 : size == 8 ? 8 : 16;
  if (taps >= 6) {
    const int q2 = at(2), p2 = at(-3);
    mask = mask && std::abs(p2 - p1) <= limit && std::abs(q2 - q1) <= limit;
    flat = std::abs(p1 - p0) <= flat_th && std::abs(q1 - q0) <= flat_th &&
           std::abs(p2 - p0) <= flat_th && std::abs(q2 - q0) <= flat_th;
  }
  if (taps >= 8) {
    const int q3 = at(3), p3 = at(-4);
    mask = mask && std::abs(p3 - at(-3)) <= limit && std::abs(q3 - at(2)) <= limit;
    flat = flat && std::abs(p3 - p0) <= flat_th && std::abs(q3 - q0) <= flat_th;
  }
  if (taps == 16) {
    flat2 = true;
    for (int k = 4; k <= 6; k++)
      flat2 = flat2 && std::abs(at(-k - 1) - p0) <= flat_th &&
              std::abs(at(k) - q0) <= flat_th;
  }
  if (!mask) return;
  if (taps == 4 || !flat) {  // 7.14.6.3, the narrow filter
    const int half = 0x80 << shift;
    const int lo = -(1 << (bd - 1)), hi = (1 << (bd - 1)) - 1;
    auto c = [&](int v) { return std::min(std::max(v, lo), hi); };
    const int ps1 = p1 - half, ps0 = p0 - half, qs0 = q0 - half, qs1 = q1 - half;
    int f = hev ? c(ps1 - qs1) : 0;
    f = c(f + 3 * (qs0 - ps0));
    const int f1 = c(f + 4) >> 3, f2 = c(f + 3) >> 3;
    at(0) = c(qs0 - f1) + half;
    at(-1) = c(ps0 + f2) + half;
    if (!hev) {
      f = (f1 + 1) >> 1;
      at(1) = c(qs1 - f) + half;
      at(-2) = c(ps1 + f) + half;
    }
    count(kToolDeblock4);
    return;
  }
  // 7.14.6.4, the wide filters: log2 size 3 (n 3, or 2 for chroma) or 4
  const int log2 = taps == 16 && flat2 ? 4 : 3;
  const int n = log2 == 4 ? 6 : taps == 6 ? 2 : 3;
  const int n2 = log2 == 3 && plane == 0 ? 0 : 1;
  int f[12];
  for (int i = -n; i < n; i++) {
    int t = 0;
    for (int j = -n; j <= n; j++) {
      const int p = std::min(std::max(i + j, -(n + 1)), n);
      t += (std::abs(j) <= n2 ? 2 : 1) * at(p);
    }
    f[i + n] = (t + (1 << (log2 - 1))) >> log2;
  }
  for (int i = -n; i < n; i++) at(i) = f[i + n];
  count(log2 == 4 ? kToolDeblock14 : taps == 6 ? kToolDeblock6 : kToolDeblock8);
}

// 7.14.2: the edges of one 4x4 unit (luma units; chroma ones at every
// other row and column of a 4:2:0 frame)
void edge(State& s, int plane, int pass, int row, int col, const Limits& l) {
  const int subx = s.sub_x(plane), suby = s.sub_y(plane);
  const int dx = pass == 0, dy = pass == 1;
  const int x = col * 4, y = row * 4;
  if (x >= s.fh->width || y >= s.fh->height) return;
  if ((pass == 0 && x == 0) || (pass == 1 && y == 0)) return;
  const int xp = x >> subx, yp = y >> suby;
  const int cols = s.lf_cols[plane];
  const int tx = s.lf_tx[plane][static_cast<size_t>(yp >> 2) * cols + (xp >> 2)];
  const int prev_tx = s.lf_tx[plane][static_cast<size_t>((yp >> 2) - dy) * cols +
                                     (xp >> 2) - dx];
  // every edge of a transform block is filtered in an intra frame (no
  // skipped inter block)
  const int tsize = pass == 0 ? 1 << kTxWidthLog2[tx] : 1 << kTxHeightLog2[tx];
  if ((pass == 0 ? xp : yp) % tsize) return;
  const int base = pass == 0 ? std::min(1 << kTxWidthLog2[prev_tx], 1 << kTxWidthLog2[tx])
                             : std::min(1 << kTxHeightLog2[prev_tx], 1 << kTxHeightLog2[tx]);
  const int size = plane == 0 ? std::min(16, base) : std::min(8, base);
  if (!l.lvl) return;
  const int bd = s.bit_depth;
  for (int i = 0; i < 4; i++) {
    uint16_t* q = s.px(plane, yp + dx * i, xp + dy * i);
    const long step = pass == 0 ? 1 : s.stride[plane];
    sample_filter([q, step](int k) -> uint16_t& { return q[k * step]; }, size,
                  l, bd, plane);
  }
}

}  // namespace

void deblock_frame(State& s) {
  const FrameHeader& fh = *s.fh;
  // libaom's rule: no luma levels, no deblocking at all; a chroma plane of
  // level 0 is left as it is
  if (!fh.lf_level[0] && !fh.lf_level[1]) return;
  count(kToolDeblock);
  for (int plane = 0; plane < s.planes; plane++) {
    if (plane > 0 && !fh.lf_level[plane + 1]) continue;
    for (int pass = 0; pass < 2; pass++) {
      const Limits l = limits(s, plane, pass);
      const int row_step = plane == 0 ? 1 : 1 << s.ssy;
      const int col_step = plane == 0 ? 1 : 1 << s.ssx;
      for (int row = 0; row < s.mi_rows; row += row_step)
        for (int col = 0; col < s.mi_cols; col += col_step)
          edge(s, plane, pass, row, col, l);
    }
  }
}

}  // namespace av1
}  // namespace sdt
