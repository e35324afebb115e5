// Multi-scale deformable attention (MSDA) forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in
// semi_detr_tpu/ops/ms_deform_attn_pallas.py (launched by
// `ms_deform_attn_pallas`). It computes
//
//   out[n, q, m*D + c] = sum over l, p of attn[n,q,m,l,p] *
//       bilinear(value_l[n, :, m, c], loc[n,q,m,l,p] * (W_l, H_l) - 0.5)
//
// with grid_sample's zeros padding (align_corners=False): a corner that
// lies outside its level's map adds 0.
//
// Bound: bytes, on paper. Every tap reads four D-wide value rows and does
// about 8*D flops for them, far below the card's ~300 flops per byte of
// device memory; the least data to move is value + loc + attn + out, each
// once. The gathered rows (4 per tap) hit the 50 MB L2, since value is
// ~11 MB at the main path's shapes, so what limits a simple kernel is the
// number of instructions and dependent loads per gathered byte.
//
// Design (ms_deform_attn_common.cuh has the lane layout): a warp per
// (n, q, head), row groups of G lanes with 16-byte channel chunks, so a
// warp has 32 / G taps in flight (8 at bf16, D = 32). Each group computes
// its tap's geometry once; each lane issues the corner loads of its
// `taps_per_lane` taps together (8 x 16 bytes in flight at bf16, LP = 16),
// read-only path, and sums its VEC channels in float32. The groups' sums
// combine once, after all taps, and group 0 stores the output row with
// 16-byte stores.
//
// Sum order. The bf16 vector instances sum the attention-scaled corner
// products of their taps with fused multiply-adds and combine the groups
// by __shfl_xor_sync over offsets G .. 16: the bf16 rounding of the output
// hides the order. The float32 and element instances keep one sum per
// corner of the rounded products value * (attn * bilinear weight), group
// g over taps g, g + NG, ..., add the groups' sums in group order and then
// the corners as (0 + 2) + (1 + 3). At NG = 4 (float32, D = 32) and
// L * P >= 16 that is, bit for bit, the order of the plain version's
// reduction on the card (ops/ms_deform_attn.py: torch sums the 4 * L * P
// products of an output in 4 warps, one per corner, each with 4
// interleaved partial sums over the taps, and adds the warps as a tree),
// so a float32 output equals the plain version's. A tree over the taps
// instead moved float32 outputs by a few roundings, and the model's
// decoder carries such a difference far into its parameter gradients
// (chip_smoke.py phase 5b). Offsets into value and out are 64-bit. No
// shared-memory staging, TMA or wgmma.

#include "ms_deform_attn_common.cuh"

namespace {

using namespace msda;

// meta: int32 [L][3] = (H_l, W_l, level start) on the device.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const int* __restrict__ meta,
                const float* __restrict__ loc,
                const float* __restrict__ attn, T* __restrict__ out,
                int64_t n_warps, int S, int M, int D, int Lq, int L, int P) {
  constexpr int NG = 32 / G;                      // taps in flight per warp
  constexpr int U = taps_per_lane<VEC, G, 4>();
  // one sum per corner in the plain version's order (file comment), but
  // for the bf16 vector instances, which sum the corners in the lane
  constexpr bool kPerCorner = VEC != 8;
  constexpr int NC = kPerCorner ? 4 : 1;          // sums per channel
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= n_warps) return;                   // uniform per warp
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, lig = lane % G;
  // warp = (n * Lq + q) * M + m, the row-major index of (N, Lq, M)
  const int m = static_cast<int>(warp % M);
  const int64_t n = warp / M / Lq;
  const int LP = L * P;
  const float inv_p = 1.f / static_cast<float>(P);
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  const int64_t row = static_cast<int64_t>(M) * D;   // token stride
  const T* v_nm = value + n * S * row + static_cast<int64_t>(m) * D;
  T* out_w = out + warp * D;

  // vector instances: D == G * VEC, one pass; element instance: G == 32
  // lanes over channels, a pass per 32 channels
  const int passes = VEC > 1 ? 1 : (D + 31) / 32;
  for (int pass = 0; pass < passes; ++pass) {
    const int c0 = (pass * G + lig) * VEC;
    const bool active = c0 < D;
    float acc[NC][VEC];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

    // group grp takes taps grp, grp + NG, ... in order
    for (int t0 = grp; t0 < LP; t0 += NG * U) {
      int tok[U][4];
      float wgt[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = t0 + u * NG;
        Tap tp = no_tap();
        float a = 0.f;
        if (t < LP) {
          const int l = level_of(t, inv_p);
          tp = tap_corners<false>(__ldg(loc_w + 2 * t),
                                  __ldg(loc_w + 2 * t + 1),
                                  __ldg(meta + 3 * l), __ldg(meta + 3 * l + 1),
                                  __ldg(meta + 3 * l + 2));
          a = __ldg(attn_w + t);
        }
        const float hh = 1.f - tp.lh, hw = 1.f - tp.lw;
        // attn * bilinear weight, rounded as the plain version forms it
        const float w4[4] = {__fmul_rn(__fmul_rn(hw, hh), a),
                             __fmul_rn(__fmul_rn(tp.lw, hh), a),
                             __fmul_rn(__fmul_rn(hw, tp.lh), a),
                             __fmul_rn(__fmul_rn(tp.lw, tp.lh), a)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          tok[u][c] = active ? tp.tok[c] : -1;
          wgt[u][c] = tok[u][c] >= 0 ? w4[c] : 0.f;
        }
      }
      Chunk<T, VEC> v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (tok[u][c] >= 0)
            v[u][c].load(v_nm + static_cast<int64_t>(tok[u][c]) * row + c0);
          else
            v[u][c].clear();
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            if constexpr (kPerCorner)
              acc[c][k] = __fadd_rn(acc[c][k],
                                    __fmul_rn(v[u][c][k], wgt[u][c]));
            else
              acc[0][k] = fmaf(wgt[u][c], v[u][c][k], acc[0][k]);
          }
    }
    float o[VEC];
    if constexpr (kPerCorner) {
      // group 0 adds the other groups' sums in group order, per corner,
      // then the corners as (0 + 2) + (1 + 3)
      float tot[4][VEC];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          tot[c][k] = acc[c][k];
#pragma unroll
          for (int g = 1; g < NG; ++g)
            tot[c][k] = __fadd_rn(
                tot[c][k], __shfl_sync(kFullMask, acc[c][k], g * G + lig));
        }
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o[k] = __fadd_rn(__fadd_rn(tot[0][k], tot[2][k]),
                         __fadd_rn(tot[1][k], tot[3][k]));
    } else {
      // the groups hold partial sums of the same channels: combine once
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o[k] = acc[0][k];
#pragma unroll
        for (int off = G; off < 32; off <<= 1)
          o[k] += __shfl_xor_sync(kFullMask, o[k], off);
      }
    }
    if (grp == 0 && active) Chunk<T, VEC>::store(out_w + c0, o);
  }
}

template <typename T, int VEC, int G>
int launch_instance(const T* value, const int* meta, const float* loc,
                    const float* attn, T* out, int64_t n_warps, int S, int M,
                    int D, int Lq, int L, int P, cudaStream_t stream) {
  const int64_t blocks = (n_warps * 32 + kThreads - 1) / kThreads;
  msda_fwd_kernel<T, VEC, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          value, meta, loc, attn, out, n_warps, S, M, D, Lq, L, P);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// width: channels per lane chosen by the wrapper, 1 (element instance) or
// 16 bytes of T (vector instances, G = D / width lanes per row).
template <typename T>
int launch(const T* value, const int* meta, const float* loc,
           const float* attn, T* out, int N, int S, int M, int D, int Lq,
           int L, int P, int width, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t n_warps = static_cast<int64_t>(N) * Lq * M;
  if (width == 1) {
    if (n_warps == 0) return 0;
    return launch_instance<T, 1, 32>(value, meta, loc, attn, out, n_warps, S,
                                     M, D, Lq, L, P, stream);
  }
  if (width != kVec || D % kVec != 0 || !aligned16(value) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_warps == 0) return 0;
  switch (D / kVec) {
#define MSDA_FWD_CASE(G)                                                    \
  case G:                                                                   \
    return launch_instance<T, kVec, G>(value, meta, loc, attn, out, n_warps,\
                                       S, M, D, Lq, L, P, stream);
    MSDA_FWD_CASE(1)
    MSDA_FWD_CASE(2)
    MSDA_FWD_CASE(4)
    MSDA_FWD_CASE(8)
    MSDA_FWD_CASE(16)
    MSDA_FWD_CASE(32)
#undef MSDA_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int msda_fwd_f32(const void* value, const void* meta,
                            const void* loc, const void* attn, void* out,
                            int N, int S, int M, int D, int Lq, int L, int P,
                            int width, void* stream) {
  return launch(static_cast<const float*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn), static_cast<float*>(out),
                N, S, M, D, Lq, L, P, width,
                static_cast<cudaStream_t>(stream));
}

extern "C" int msda_fwd_bf16(const void* value, const void* meta,
                             const void* loc, const void* attn, void* out,
                             int N, int S, int M, int D, int Lq, int L, int P,
                             int width, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn),
                static_cast<__nv_bfloat16*>(out),
                N, S, M, D, Lq, L, P, width,
                static_cast<cudaStream_t>(stream));
}
