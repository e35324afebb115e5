// Loop restoration of an AV1 key frame (7.17): each 4x4 luma unit (2x2
// chroma at 4:2:0) of the visible frame takes the filter of its
// restoration unit (units offset 8 luma rows up, as the stripes are):
// the separable 7-tap Wiener filter (7.17.4) or the self-guided filter of
// one or two box radii blended by the unit's projection (7.17.3). Samples
// come from the frame after CDEF inside the unit's stripe of 64 luma rows
// (offset by 8), and from the deblocked frame (before CDEF) for at most two
// rows above and below it (7.17.6).
#include <algorithm>
#include <cstdint>
#include <vector>

#include "av1_state.h"
#include "av1_tables.h"

namespace sdt {
namespace av1 {

namespace {

inline int64_t round2(int64_t x, int n) { return n ? (x + (int64_t(1) << (n - 1))) >> n : x; }

struct Block {
  const uint16_t* cdef;       // after CDEF
  const uint16_t* deblocked;  // before it
  int stride, end_x, end_y, stripe_start, stripe_end;

  // get_source_sample (7.17.6)
  int sample(int x, int y) const {
    x = std::max(0, std::min(end_x, x));
    y = std::max(0, std::min(end_y, y));
    if (y < stripe_start) {
      y = std::max(stripe_start - 2, y);
      return deblocked[static_cast<size_t>(y) * stride + x];
    }
    if (y > stripe_end) {
      y = std::min(stripe_end + 2, y);
      return deblocked[static_cast<size_t>(y) * stride + x];
    }
    return cdef[static_cast<size_t>(y) * stride + x];
  }
};

void wiener(const Block& b, const LrUnit& u, int x, int y, int w, int h, int bd,
            uint16_t* out) {
  const int round0 = bd == 12 ? 5 : 3, round1 = bd == 12 ? 9 : 11;
  int filter[2][7];
  for (int pass = 0; pass < 2; pass++) {
    filter[pass][3] = 128;
    for (int i = 0; i < 3; i++) {
      const int c = u.wiener[pass][i];
      filter[pass][i] = filter[pass][6 - i] = c;
      filter[pass][3] -= 2 * c;
    }
  }
  const int offset = 1 << (bd + 7 - round0 - 1);
  const int limit = (1 << (bd + 1 + 7 - round0)) - 1;
  int inter[10][4];
  for (int r = 0; r < h + 6; r++)
    for (int c = 0; c < w; c++) {
      int64_t s = 0;
      for (int t = 0; t < 7; t++) s += filter[1][t] * b.sample(x + c + t - 3, y + r - 3);
      const int64_t v = round2(s, round0);
      inter[r][c] = static_cast<int>(std::min<int64_t>(std::max<int64_t>(v, -offset), limit - offset));
    }
  const int mx = (1 << bd) - 1;
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      int64_t s = 0;
      for (int t = 0; t < 7; t++) s += filter[0][t] * inter[r + t][c];
      const int64_t v = round2(s, round1);
      out[static_cast<size_t>(y + r) * b.stride + x + c] =
          static_cast<uint16_t>(std::min<int64_t>(std::max<int64_t>(v, 0), mx));
    }
}

// box_filter (7.17.3) of one radius into f[h][w]
void box_filter(const Block& b, int x, int y, int w, int h, int set, int pass,
                int bd, int f[4][4]) {
  // the table holds each radius's scale s, 2^20 / (n^2 eps) rounded
  const int r = kSgrParams[set][pass * 2], s = kSgrParams[set][pass * 2 + 1];
  const int n = (2 * r + 1) * (2 * r + 1);
  const int64_t one_over_n = ((1 << 12) + n / 2) / n;
  int64_t A[6][6], B[6][6];
  for (int i = -1; i < h + 1; i++)
    for (int j = -1; j < w + 1; j++) {
      int64_t a = 0, sum = 0;
      for (int dy = -r; dy <= r; dy++)
        for (int dx = -r; dx <= r; dx++) {
          const int64_t c = b.sample(x + j + dx, y + i + dy);
          a += c * c;
          sum += c;
        }
      a = round2(a, 2 * (bd - 8));
      const int64_t d = round2(sum, bd - 8);
      const int64_t p = std::max<int64_t>(0, a * n - d * d);
      const int64_t z = round2(p * s, 20);
      int64_t a2;
      if (z >= 255) a2 = 256;
      else if (z == 0) a2 = 1;
      else a2 = ((z << 8) + (z / 2)) / (z + 1);
      const int64_t b2 = ((1 << 8) - a2) * sum * one_over_n;
      A[i + 1][j + 1] = a2;
      B[i + 1][j + 1] = round2(b2, 12);
    }
  for (int i = 0; i < h; i++) {
    // radius 2 takes A and B of odd rows only (y is even)
    const int shift = pass == 0 && (i & 1) ? 4 : 5;
    for (int j = 0; j < w; j++) {
      int64_t a = 0, bb = 0;
      for (int dy = -1; dy <= 1; dy++)
        for (int dx = -1; dx <= 1; dx++) {
          int weight;
          if (pass == 0) weight = ((i + dy) & 1) ? (dx == 0 ? 6 : 5) : 0;
          else weight = (dx == 0 || dy == 0) ? 4 : 3;
          a += weight * A[i + dy + 1][j + dx + 1];
          bb += weight * B[i + dy + 1][j + dx + 1];
        }
      const int64_t v = a * b.cdef[static_cast<size_t>(y + i) * b.stride + x + j] + bb;
      f[i][j] = static_cast<int>(round2(v, 8 + shift - 4));
    }
  }
}

void self_guided(const Block& b, const LrUnit& u, int x, int y, int w, int h,
                 int bd, uint16_t* out) {
  const int set = u.sgr_set;
  const int r0 = kSgrParams[set][0], r1 = kSgrParams[set][2];
  int f0[4][4] = {}, f1[4][4] = {};
  if (r0) box_filter(b, x, y, w, h, set, 0, bd, f0);
  if (r1) box_filter(b, x, y, w, h, set, 1, bd, f1);
  const int w0 = u.sgr_xqd[0], w1 = u.sgr_xqd[1], w2 = (1 << 7) - w0 - w1;
  const int mx = (1 << bd) - 1;
  for (int i = 0; i < h; i++)
    for (int j = 0; j < w; j++) {
      const int64_t px = int64_t(b.cdef[static_cast<size_t>(y + i) * b.stride + x + j]) << 4;
      int64_t v = w1 * px;
      v += r0 ? int64_t(w0) * f0[i][j] : w0 * px;
      v += r1 ? int64_t(w2) * f1[i][j] : w2 * px;
      const int64_t s = round2(v, 4 + 7);
      out[static_cast<size_t>(y + i) * b.stride + x + j] =
          static_cast<uint16_t>(std::min<int64_t>(std::max<int64_t>(s, 0), mx));
    }
}

}  // namespace

void restore_frame(State& s, const std::vector<uint16_t>* deblocked) {
  const FrameHeader& fh = *s.fh;
  const int bd = s.bit_depth;
  for (int plane = 0; plane < s.planes; plane++) {
    if (fh.lr_type[plane] == RESTORE_NONE) continue;
    const int subx = s.sub_x(plane), suby = s.sub_y(plane);
    const std::vector<uint16_t> cdef = s.frame[plane];
    Block b{cdef.data(), deblocked[plane].data(), s.stride[plane],
            ((fh.width + subx) >> subx) - 1, ((fh.height + suby) >> suby) - 1, 0, 0};
    const int unit = fh.lr_size[plane];
    uint16_t* out = s.frame[plane].data();
    for (int y4 = 0; y4 < fh.height; y4 += 4)
      for (int x4 = 0; x4 < fh.width; x4 += 4) {
        const int row = y4 >> 2, col = x4 >> 2;
        const int stripe = (row * 4 + 8) / 64;
        b.stripe_start = (-8 + stripe * 64) >> suby;
        b.stripe_end = b.stripe_start + (64 >> suby) - 1;
        const int unit_row = std::min(s.lr_rows[plane] - 1, ((row * 4 + 8) >> suby) / unit);
        const int unit_col = std::min(s.lr_cols[plane] - 1, ((col * 4) >> subx) / unit);
        // each luma 4x4 unit: a 2x2 of 4:2:0 chroma
        const int x = (col * 4) >> subx, y = (row * 4) >> suby;
        const int w = std::min(4 >> subx, b.end_x - x + 1);
        const int h = std::min(4 >> suby, b.end_y - y + 1);
        const LrUnit& u = s.lr[plane][static_cast<size_t>(unit_row) * s.lr_cols[plane] + unit_col];
        if (u.type == RESTORE_WIENER) {
          wiener(b, u, x, y, w, h, bd, out);
          count(kToolLrWiener);
        } else if (u.type == RESTORE_SGRPROJ) {
          self_guided(b, u, x, y, w, h, bd, out);
          count(kToolLrSgrproj);
        }
      }
  }
}

}  // namespace av1
}  // namespace sdt
