// Dequantisation (7.12.3) and the inverse transforms (7.13) of an AV1
// transform block: the DCT of 4 to 64 points, the ADST of 4, 8 and 16, the
// flipped ADST, the identity of 4 to 32 and the lossless 4x4 Walsh-
// Hadamard transform, with the rectangular 1/sqrt(2) scaling, the row
// shifts and the intermediate clamps, at 8, 10 and 12 bits.
//
// The one-dimensional transforms are the butterfly networks the
// specification defines (and libaom 3.14.1 runs): each rotation rounds
// once, w0 * a + w1 * b shifted by 12 with cos128 weights, and the
// additions are exact. The DCT of N points takes the DCT of its N / 2 even
// inputs and an odd half: a first rotation of each input pair by
// 64 - k * 64 / N (k the input's index), then additions in groups of 2, 4,
// ..., N / 4, each followed by rotations of the inner pairs by the angles
// of the next smaller odd half.
#include <algorithm>
#include <cstdint>
#include <cstdlib>

#include "av1_state.h"
#include "av1_tables.h"

namespace sdt {
namespace av1 {

namespace {

// cos128 of an angle in 0..64 (the weights of a rotation)
inline int cosp(int a) { return kCos128[a]; }

// half_btf: one rounding of w0 * a + w1 * b
inline int32_t btf(int w0, int32_t a, int w1, int32_t b) {
  const int64_t r = static_cast<int64_t>(w0) * a + static_cast<int64_t>(w1) * b;
  return static_cast<int32_t>((r + 2048) >> 12);
}

int brev(int bits, int x) {
  int r = 0;
  for (int i = 0; i < bits; i++) r |= ((x >> i) & 1) << (bits - 1 - i);
  return r;
}

int log2i(int n) {
  int l = 0;
  while ((1 << l) < n) l++;
  return l;
}

// the first-rotation angle of pair p of the odd half of m points (the DCT
// of 2m points): 64 - k * 64 / (2m), k the pair's input index
int odd_angle_of(int m, int p) {
  if (m == 1) return 32;
  const int k = brev(log2i(2 * m), m + p);
  return 64 - k * 64 / (2 * m);
}

// odd_angle_of for m of 1 to 32, tabled
struct OddAngles {
  int8_t v[6][32];
  OddAngles() {
    for (int l = 0; l < 6; l++)
      for (int p = 0; p < (1 << l); p++) v[l][p] = static_cast<int8_t>(odd_angle_of(1 << l, p));
  }
};

int odd_angle(int m, int p) {
  static const OddAngles t;
  return t.v[log2i(m)][p];
}

// the odd half y[0 .. m-1] of a DCT of 2m points (inputs in bit-reversed
// order)
void idct_odd(int32_t* y, int m) {
  for (int i = 0; i < m / 2; i++) {
    const int t = odd_angle(m, i);
    const int32_t a = y[i], b = y[m - 1 - i];
    y[i] = btf(cosp(t), a, -cosp(64 - t), b);
    y[m - 1 - i] = btf(cosp(64 - t), a, cosp(t), b);
  }
  for (int g = 2; g <= m / 2; g <<= 1) {
    // additions in groups of g, the odd groups mirrored
    for (int g0 = 0; g0 < m; g0 += g) {
      const bool odd = (g0 / g) & 1;
      for (int i = 0; i < g / 2; i++) {
        const int32_t a = y[g0 + i], b = y[g0 + g - 1 - i];
        if (!odd) {
          y[g0 + i] = a + b;
          y[g0 + g - 1 - i] = a - b;
        } else {
          y[g0 + i] = b - a;
          y[g0 + g - 1 - i] = a + b;
        }
      }
    }
    // rotations of the inner pairs (i, m - 1 - i): r = i mod 2g in
    // [g / 2, g) by R1, in [g, 3g / 2) by R2, at the angles of the odd
    // half of m / 2g points
    for (int i = 0; i < m / 2; i++) {
      const int r = i % (2 * g);
      if (r < g / 2 || r >= 3 * g / 2) continue;
      const int t = odd_angle(m / (2 * g), i / (2 * g));
      const int32_t a = y[i], b = y[m - 1 - i];
      if (r < g) {
        y[i] = btf(-cosp(64 - t), a, cosp(t), b);
        y[m - 1 - i] = btf(cosp(t), a, cosp(64 - t), b);
      } else {
        y[i] = btf(-cosp(t), a, -cosp(64 - t), b);
        y[m - 1 - i] = btf(-cosp(64 - t), a, cosp(t), b);
      }
    }
  }
}

// the DCT of n points on x in bit-reversed order, in place
void idct_core(int32_t* x, int n) {
  if (n == 2) {
    const int32_t a = x[0], b = x[1];
    x[0] = btf(cosp(32), a, cosp(32), b);
    x[1] = btf(cosp(32), a, -cosp(32), b);
    return;
  }
  idct_core(x, n / 2);
  idct_odd(x + n / 2, n / 2);
  for (int i = 0; i < n / 2; i++) {
    const int32_t a = x[i], b = x[n - 1 - i];
    x[i] = a + b;
    x[n - 1 - i] = a - b;
  }
}

void idct(const int32_t* in, int32_t* out, int n) {
  const int bits = log2i(n);
  for (int i = 0; i < n; i++) out[i] = in[brev(bits, i)];
  idct_core(out, n);
}

void iadst4(const int32_t* in, int32_t* out) {
  const int64_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3];
  int64_t s0 = kSinpi[1] * x0, s1 = kSinpi[2] * x0, s2 = kSinpi[3] * x1;
  int64_t s3 = kSinpi[4] * x2;
  const int64_t s4 = kSinpi[1] * x2, s5 = kSinpi[2] * x3, s6 = kSinpi[4] * x3;
  const int64_t s7 = (x0 - x2) + x3;
  s0 = s0 + s3;
  s1 = s1 - s4;
  s3 = s2;
  s2 = kSinpi[3] * s7;
  s0 = s0 + s5;
  s1 = s1 - s6;
  const int64_t o0 = s0 + s3, o1 = s1 + s3, o2 = s2, o3 = s0 + s1 - s3;
  out[0] = static_cast<int32_t>((o0 + 2048) >> 12);
  out[1] = static_cast<int32_t>((o1 + 2048) >> 12);
  out[2] = static_cast<int32_t>((o2 + 2048) >> 12);
  out[3] = static_cast<int32_t>((o3 + 2048) >> 12);
}

// the ADST of 8 and 16 points: the inputs interleaved from both ends,
// each pair rotated by 2 + 8j (16 points) or 4 + 16j (8 points), then
// levels of butterflies between the halves of groups of n, n / 2, ... 4,
// each followed by rotations of the pairs of each group's upper half
// (angles 128 / g * (1 + 4k), the second half of the pairs mirrored); the
// outputs taken back in libaom's order with alternating signs
void iadst_n(const int32_t* in, int32_t* out, int n) {
  int32_t x[16];
  for (int j = 0; j < n / 2; j++) {
    x[2 * j] = in[n - 1 - 2 * j];
    x[2 * j + 1] = in[2 * j];
  }
  for (int j = 0; j < n / 2; j++) {
    const int a = n == 16 ? 2 + 8 * j : 4 + 16 * j;
    const int32_t p = x[2 * j], q = x[2 * j + 1];
    x[2 * j] = btf(cosp(a), p, cosp(64 - a), q);
    x[2 * j + 1] = btf(cosp(64 - a), p, -cosp(a), q);
  }
  for (int g = n; g >= 4; g >>= 1) {
    for (int g0 = 0; g0 < n; g0 += g)
      for (int i = 0; i < g / 2; i++) {
        const int32_t a = x[g0 + i], b = x[g0 + g / 2 + i];
        x[g0 + i] = a + b;
        x[g0 + g / 2 + i] = a - b;
      }
    const int pairs = g / 4;
    for (int g0 = 0; g0 < n; g0 += g)
      for (int k = 0; k < pairs; k++) {
        const int i = g0 + g / 2 + 2 * k;
        const bool mirrored = pairs > 1 && k >= pairs / 2;
        const int ang = 128 / g * (1 + 4 * (mirrored ? k - pairs / 2 : k));
        const int32_t p = x[i], q = x[i + 1];
        if (!mirrored) {
          x[i] = btf(cosp(ang), p, cosp(64 - ang), q);
          x[i + 1] = btf(cosp(64 - ang), p, -cosp(ang), q);
        } else {
          x[i] = btf(-cosp(64 - ang), p, cosp(ang), q);
          x[i + 1] = btf(cosp(ang), p, cosp(64 - ang), q);
        }
      }
  }
  static const int kOut8[8] = {0, 4, 6, 2, 3, 7, 5, 1};
  static const int kOut16[16] = {0, 8, 12, 4, 6, 14, 10, 2,
                                 3, 11, 15, 7, 5, 13, 9, 1};
  const int* order = n == 8 ? kOut8 : kOut16;
  for (int i = 0; i < n; i++) out[i] = (i & 1) ? -x[order[i]] : x[order[i]];
}

void iidentity(const int32_t* in, int32_t* out, int n) {
  for (int i = 0; i < n; i++) {
    const int64_t v = in[i];
    if (n == 4) out[i] = static_cast<int32_t>((v * 5793 + 2048) >> 12);
    else if (n == 8) out[i] = static_cast<int32_t>(v * 2);
    else if (n == 16) out[i] = static_cast<int32_t>((v * 11586 + 2048) >> 12);
    else out[i] = static_cast<int32_t>(v * 4);
  }
}

// the one-dimensional transform kinds of each type: vertical (columns)
// and horizontal (rows); 0 DCT, 1 ADST, 2 flipped ADST, 3 identity
constexpr int kVtx[16] = {0, 1, 0, 1, 2, 0, 2, 1, 2, 3, 0, 3, 1, 3, 2, 3};
constexpr int kHtx[16] = {0, 0, 1, 1, 0, 2, 2, 2, 1, 3, 3, 0, 3, 1, 3, 2};

void transform_1d(int kind, const int32_t* in, int32_t* out, int n) {
  if (kind == 3) {
    iidentity(in, out, n);
    count(kToolIdentity);
  } else if (kind == 0) {
    idct(in, out, n);
    count(kToolDct);
  } else {
    if (n == 4) iadst4(in, out);
    else iadst_n(in, out, n);
    count(kToolAdst);
  }
}

inline int32_t clamp_bits(int64_t v, int bits) {
  const int64_t lo = -(int64_t(1) << (bits - 1)), hi = (int64_t(1) << (bits - 1)) - 1;
  return static_cast<int32_t>(std::min(std::max(v, lo), hi));
}


// the offset of each size's matrix in a level of kQuantizerMatrix (by
// the size of 32 or less that a 64 side reads)
int qm_offset(int w, int h) {
  static const int kSizes[14][3] = {
      {4, 4, 0},      {8, 8, 16},     {16, 16, 80},   {32, 32, 336},
      {4, 8, 1360},   {8, 4, 1392},   {8, 16, 1424},  {16, 8, 1552},
      {16, 32, 1680}, {32, 16, 2192}, {4, 16, 2704},  {16, 4, 2768},
      {8, 32, 2832},  {32, 8, 3088}};
  for (const auto& e : kSizes)
    if (e[0] == w && e[1] == h) return e[2];
  return 0;
}

void reconstruct_lossless(State& s, int plane, int x, int y, const int32_t* quant) {
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

}  // namespace

void inverse_1d(int kind, const int32_t* in, int32_t* out, int n) {
  if (kind == 3) iidentity(in, out, n);
  else if (kind == 0) idct(in, out, n);
  else if (n == 4) iadst4(in, out);
  else iadst_n(in, out, n);
}

void quantizer_steps(const State& s, int plane, int tx, int type, int* steps,
                     int* shift) {
  const int w = 1 << kTxWidthLog2[tx], h = 1 << kTxHeightLog2[tx];
  const int tw = std::min(w, 32), th = std::min(h, 32);
  // the quantizers of the block's qindex, the matrix of the plane's level
  // (two-dimensional types only)
  const int qidx = s.current_qindex;
  const int* dq = s.fh->delta_q;
  const int dc_delta = plane == 0 ? dq[0] : plane == 1 ? dq[1] : dq[3];
  const int ac_delta = plane == 0 ? 0 : plane == 1 ? dq[2] : dq[4];
  const int depth_row = (s.bit_depth - 8) >> 1;
  const int dc_q = kDcQlookup[depth_row][std::min(std::max(qidx + dc_delta, 0), 255)];
  const int ac_q = kAcQlookup[depth_row][std::min(std::max(qidx + ac_delta, 0), 255)];
  const int level = s.fh->qm[plane];
  const uint8_t* qm = level < 15 && type < IDTX
                          ? kQuantizerMatrix[level][plane > 0] + qm_offset(tw, th)
                          : nullptr;
  for (int i = 0; i < th; i++)
    for (int j = 0; j < tw; j++) {
      int q = (i == 0 && j == 0) ? dc_q : ac_q;
      if (qm) q = (q * qm[i * tw + j] + 16) >> 5;
      steps[i * tw + j] = q;
    }
  const int area = w * h;
  *shift = (area > 256) + (area > 1024);
}

void reconstruct(State& s, int plane, int x, int y, int tx, int32_t* quant) {
  if (s.fh->lossless) {
    reconstruct_lossless(s, plane, x, y, quant);
    return;
  }
  const int bd = s.bit_depth, mx = (1 << bd) - 1;
  const int log2w = kTxWidthLog2[tx], log2h = kTxHeightLog2[tx];
  const int w = 1 << log2w, h = 1 << log2h;
  const int tw = std::min(w, 32), th = std::min(h, 32);
  const int type = s.plane_tx_type;
  int steps[32 * 32], dq_shift;
  quantizer_steps(s, plane, tx, type, steps, &dq_shift);
  const int64_t lim = int64_t(1) << (7 + bd);
  int32_t buf[64 * 64];
  std::fill(buf, buf + w * h, 0);
  for (int i = 0; i < th; i++)
    for (int j = 0; j < tw; j++) {
      const int32_t v = quant[i * tw + j];
      if (!v) continue;
      int64_t d = (static_cast<int64_t>(std::abs(v)) * steps[i * tw + j]) & 0xFFFFFF;
      d >>= dq_shift;
      if (v < 0) d = -d;
      buf[i * w + j] = static_cast<int32_t>(std::min(std::max(d, -lim), lim - 1));
    }
  count(w == 4 || h == 4 ? kToolTx4 : kToolTx8);
  if (std::max(w, h) == 16) count(kToolTx16);
  if (std::max(w, h) == 32) count(kToolTx32);
  if (std::max(w, h) == 64) count(kToolTx64);
  if (w != h) count(std::min(w, h) == 4 ? kToolTxRect4 : kToolTxRect);
  // 7.13.3: rows, then columns
  const int vt = kVtx[type], ht = kHtx[type];
  const bool rect = std::abs(log2w - log2h) == 1;
  const int row_shift = kTransformRowShift[tx];
  int32_t in[64], out[64];
  for (int i = 0; i < std::min(h, 32); i++) {
    int32_t* row = buf + i * w;
    bool any = false;
    for (int j = 0; j < w; j++) {
      int64_t v = row[j];
      if (rect) v = (v * 2896 + 2048) >> 12;
      in[j] = clamp_bits(v, bd + 8);
      any = any || in[j];
    }
    if (!any) continue;
    transform_1d(ht == 2 ? 1 : ht, in, out, w);
    for (int j = 0; j < w; j++) {
      const int32_t v = ht == 2 ? out[w - 1 - j] : out[j];
      row[j] = row_shift ? (v + (1 << (row_shift - 1))) >> row_shift : v;
    }
  }
  for (int j = 0; j < w; j++) {
    for (int i = 0; i < h; i++)
      in[i] = clamp_bits(buf[i * w + j], std::max(bd + 6, 16));
    transform_1d(vt == 2 ? 1 : vt, in, out, h);
    for (int i = 0; i < h; i++) {
      const int32_t r = (vt == 2 ? out[h - 1 - i] : out[i]);
      const int v = (r + 8) >> 4;
      uint16_t* p = s.px(plane, y + i, x + j);
      *p = static_cast<uint16_t>(std::min(std::max(*p + v, 0), mx));
    }
  }
}

}  // namespace av1
}  // namespace sdt
