// Multi-scale deformable attention (MSDA) backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in
// semi_detr_tpu/ops/ms_deform_attn_pallas.py (launched by
// `ms_deform_attn_bwd_pallas`). Given the cotangent g (N, Lq, M*D) of the
// forward's output, for every tap (n, q, m, l, p) and each of its four
// corners c, with bilinear weight w_c and validity v_c:
//
//   d_attn   = sum_c v_c * w_c * <g, V_c>
//   d_loc_x  = W_l * attn * sum_c v_c * (dw_c/dx) * <g, V_c>   (dw/dx = +-wy)
//   d_loc_y  = H_l * attn * sum_c v_c * (dw_c/dy) * <g, V_c>   (dw/dy = +-wx)
//   d_value[corner row] += attn * w_c * g
//
// which is what autograd of the plain version (ops/ms_deform_attn.py)
// computes, one-sided derivatives at pixel edges included. A tap whose
// location is NaN, infinite or far off its map gets exactly 0 in all three
// gradients (autograd of the plain version gives NaN in d_loc for a NaN
// location).
//
// Bound: bytes, on paper. Per tap and channel the kernel does about 16
// flops on 4 value reads and 4 scatter adds, far below the card's ~300
// flops per byte of device memory. The least data to move: value, loc,
// attn and g read once, d_loc and d_attn written once, and d_value written
// once. What limits it is the scatter: every tap adds to four D-wide rows
// of d_value in float32, in the L2.
//
// Design (ms_deform_attn_common.cuh has the lane layout): a warp per
// (n, q, head), row groups of G lanes with 16-byte channel chunks, 32 / G
// taps in flight per warp. Each lane loads its chunk of g once and keeps
// it in float32. Per tap, the group computes the geometry once; each lane
// issues the four corners' 16-byte loads together, accumulates four
// partial dots <g, V_c> over its channels and scatters attn * w_c * g into
// d_value with 16-byte float4 atomics (one per 4 channels, laid out so
// that a group's atomic instruction covers whole 32-byte sectors). The dots
// reduce within the group only (log2 G shuffle levels, every lane taking
// part: a tap that is off the map contributes zero dots), and the group's
// first lane writes d_attn and d_loc. d_value is summed into a float32
// buffer that the launch zeroes first (the order of the atomic adds is
// not fixed, so float32 d_value is reproducible only to rounding); for
// bfloat16 a second kernel casts that buffer into the output. Offsets are
// 64-bit. No shared-memory staging, TMA or wgmma.

#include "ms_deform_attn_common.cuh"

namespace {

using namespace msda;

// meta: int32 [L][3] = (H_l, W_l, level start) on the device.
template <typename T, int VEC, int G>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ value, const int* __restrict__ meta,
                const float* __restrict__ loc,
                const float* __restrict__ attn,
                const T* __restrict__ grad_out, float* __restrict__ d_value,
                float* __restrict__ d_loc, float* __restrict__ d_attn,
                int64_t n_warps, int S, int M, int D, int Lq, int L, int P) {
  constexpr int NG = 32 / G;                      // taps in flight per warp
  constexpr int U = taps_per_lane<VEC, G, 2>();
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  // uniform per warp: every lane of a live warp takes part in the shuffles
  if (warp >= n_warps) return;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G, lig = lane % G;
  // warp = (n * Lq + q) * M + m, the row-major index of (N, Lq, M)
  const int m = static_cast<int>(warp % M);
  const int64_t n = warp / M / Lq;
  const int LP = L * P;
  const float inv_p = 1.f / static_cast<float>(P);
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  float* dloc_w = d_loc + warp * LP * 2;
  float* dattn_w = d_attn + warp * LP;
  const T* g_w = grad_out + warp * D;            // (N, Lq, M*D) row of (n,q,m)
  const int64_t row = static_cast<int64_t>(M) * D;   // token stride
  const int64_t base = n * S * row + static_cast<int64_t>(m) * D;
  const T* v_nm = value + base;
  float* dv_nm = d_value + base;

  // vector instances: D == G * VEC, one pass, g loaded once; element
  // instance: G == 32 lanes over channels, a pass per 32 channels
  const int passes = VEC > 1 ? 1 : (D + 31) / 32;
  Chunk<T, VEC> gch;        // g at the lane's loaded channels (the dots)
  float gs[VEC];            // g at the lane's scattered channels
  if (VEC > 1) {
    gch.load(g_w + lig * VEC);
    load_scatter_g<T, VEC, G>(g_w, lig, gs);
  }
  // rounds of NG taps, the same count for every group of the warp
  const int rounds = (LP + NG - 1) / NG;
  for (int r0 = 0; r0 < rounds; r0 += U) {
    Tap tp[U];
    float a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = (r0 + u) * NG + grp;
      tp[u] = no_tap();
      a[u] = 0.f;
      if (t < LP) {
        const int l = level_of(t, inv_p);
        tp[u] = tap_corners<true>(__ldg(loc_w + 2 * t),
                                  __ldg(loc_w + 2 * t + 1),
                                  __ldg(meta + 3 * l),
                                  __ldg(meta + 3 * l + 1),
                                  __ldg(meta + 3 * l + 2));
        a[u] = __ldg(attn_w + t);
      }
    }
    float dot[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) dot[u][c] = 0.f;

    for (int pass = 0; pass < passes; ++pass) {
      const int c0 = (pass * G + lig) * VEC;
      const bool active = c0 < D;
      if (VEC == 1) {
        if (active) gch.load(g_w + c0);
        else gch.clear();
        gs[0] = gch[0];
      }
      Chunk<T, VEC> v[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (active && tp[u].tok[c] >= 0)
            v[u][c].load(v_nm + static_cast<int64_t>(tp[u].tok[c]) * row
                         + c0);
          else
            v[u][c].clear();
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float hh = 1.f - tp[u].lh, hw = 1.f - tp[u].lw;
        // attn * w_c: the scale of g scattered to corner c
        const float s4[4] = {a[u] * (hh * hw), a[u] * (hh * tp[u].lw),
                             a[u] * (tp[u].lh * hw),
                             a[u] * (tp[u].lh * tp[u].lw)};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            dot[u][c] = fmaf(gch[k], v[u][c][k], dot[u][c]);
          if (active && tp[u].tok[c] >= 0)
            scatter_add<VEC, G>(
                dv_nm + static_cast<int64_t>(tp[u].tok[c]) * row, lig, c0,
                s4[c], gs);
        }
      }
    }
    // the group's lanes hold parts of the same four dots
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dot[u][c] += __shfl_xor_sync(kFullMask, dot[u][c], off);
    if (lig == 0) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = (r0 + u) * NG + grp;
        if (t >= LP) continue;
        float da = 0.f, dx = 0.f, dy = 0.f;
        if (tp[u].live) {
          const int l = level_of(t, inv_p);
          const float lh = tp[u].lh, lw = tp[u].lw;
          const float hh = 1.f - lh, hw = 1.f - lw;
          const float d00 = dot[u][0], d01 = dot[u][1], d10 = dot[u][2],
                      d11 = dot[u][3];
          // an off-map corner's dot stayed 0, so it adds nothing below
          da = hh * hw * d00 + hh * lw * d01 + lh * hw * d10 + lh * lw * d11;
          // d w_c / d lw = (-hh, +hh, -lh, +lh); d w_c / d lh = (-hw, -lw,
          // +hw, +lw); pixel = loc * extent - 0.5
          const float gx = hh * (d01 - d00) + lh * (d11 - d10);
          const float gy = hw * (d10 - d00) + lw * (d11 - d01);
          dx = a[u] * gx * __ldg(meta + 3 * l + 1);
          dy = a[u] * gy * __ldg(meta + 3 * l);
        }
        dattn_w[t] = da;
        *reinterpret_cast<float2*>(dloc_w + 2 * t) = make_float2(dx, dy);
      }
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, int64_t n) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

template <typename T, int VEC, int G>
int launch_instance(const T* value, const int* meta, const float* loc,
                    const float* attn, const T* grad_out, float* dv_acc,
                    float* d_loc, float* d_attn, int64_t n_warps, int S,
                    int M, int D, int Lq, int L, int P, cudaStream_t stream) {
  const int64_t blocks = (n_warps * 32 + kThreads - 1) / kThreads;
  msda_bwd_kernel<T, VEC, G>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          value, meta, loc, attn, grad_out, dv_acc, d_loc, d_attn, n_warps,
          S, M, D, Lq, L, P);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// width: channels per lane chosen by the wrapper, 1 (element instance) or
// 16 bytes of T (vector instances, G = D / width lanes per row).
template <typename T>
int launch_kernel(const T* value, const int* meta, const float* loc,
                  const float* attn, const T* grad_out, float* dv_acc,
                  float* d_loc, float* d_attn, int64_t n_warps, int S, int M,
                  int D, int Lq, int L, int P, int width,
                  cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (width == 1)
    return launch_instance<T, 1, 32>(value, meta, loc, attn, grad_out,
                                     dv_acc, d_loc, d_attn, n_warps, S, M, D,
                                     Lq, L, P, stream);
  switch (D / kVec) {
#define MSDA_BWD_CASE(G)                                                   \
  case G:                                                                  \
    return launch_instance<T, kVec, G>(value, meta, loc, attn, grad_out,   \
                                       dv_acc, d_loc, d_attn, n_warps, S,  \
                                       M, D, Lq, L, P, stream);
    MSDA_BWD_CASE(1)
    MSDA_BWD_CASE(2)
    MSDA_BWD_CASE(4)
    MSDA_BWD_CASE(8)
    MSDA_BWD_CASE(16)
    MSDA_BWD_CASE(32)
#undef MSDA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const T* value, const int* meta, const float* loc,
           const float* attn, const T* grad_out, float* dv_acc, T* dv_out,
           float* d_loc, float* d_attn, int N, int S, int M, int D, int Lq,
           int L, int P, int width, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (width != 1
      && (width != kVec || D % kVec != 0 || !aligned16(value)
          || !aligned16(grad_out) || !aligned16(dv_acc)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t dv_elems = static_cast<int64_t>(N) * S * M * D;
  cudaError_t err = cudaMemsetAsync(dv_acc, 0, dv_elems * sizeof(float),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_warps = static_cast<int64_t>(N) * Lq * M;
  if (n_warps > 0) {
    const int rc = launch_kernel(value, meta, loc, attn, grad_out, dv_acc,
                                 d_loc, d_attn, n_warps, S, M, D, Lq, L, P,
                                 width, stream);
    if (rc != 0) return rc;
  }
  if (static_cast<void*>(dv_out) != static_cast<void*>(dv_acc)
      && dv_elems > 0) {
    int64_t blocks = (dv_elems + kThreads - 1) / kThreads;
    if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
    cast_to_bf16<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        dv_acc, reinterpret_cast<__nv_bfloat16*>(dv_out), dv_elems);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// d_value: the float32 output itself (dv_acc == dv_out).
extern "C" int msda_bwd_f32(const void* value, const void* meta,
                            const void* loc, const void* attn,
                            const void* grad_out, void* dv_acc, void* dv_out,
                            void* d_loc, void* d_attn, int N, int S, int M,
                            int D, int Lq, int L, int P, int width,
                            void* stream) {
  if (dv_acc != dv_out) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn),
                static_cast<const float*>(grad_out),
                static_cast<float*>(dv_acc), static_cast<float*>(dv_out),
                static_cast<float*>(d_loc), static_cast<float*>(d_attn),
                N, S, M, D, Lq, L, P, width,
                static_cast<cudaStream_t>(stream));
}

// d_value: accumulated in the float32 scratch dv_acc, cast into the
// bfloat16 output dv_out.
extern "C" int msda_bwd_bf16(const void* value, const void* meta,
                             const void* loc, const void* attn,
                             const void* grad_out, void* dv_acc,
                             void* dv_out, void* d_loc, void* d_attn, int N,
                             int S, int M, int D, int Lq, int L, int P,
                             int width, void* stream) {
  if (dv_acc == dv_out) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const __nv_bfloat16*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn),
                static_cast<const __nv_bfloat16*>(grad_out),
                static_cast<float*>(dv_acc),
                static_cast<__nv_bfloat16*>(dv_out),
                static_cast<float*>(d_loc), static_cast<float*>(d_attn),
                N, S, M, D, Lq, L, P, width,
                static_cast<cudaStream_t>(stream));
}
