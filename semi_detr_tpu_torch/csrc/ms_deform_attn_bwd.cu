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
// Bound: bytes. Per tap and channel the kernel does about 16 flops on 4
// value reads and 4 scatter adds, far below the card's ~300 flops per byte
// of device memory. The least data to move: value, loc, attn and g read
// once, d_loc and d_attn written once, and the float32 d_value zeroed and
// written once.
//
// Design, simple first, mirroring the forward: one warp owns one
// (n, q, m) and its lanes cover the D channels (lanes loop for D > 32).
// Each tap's pixel coordinate is computed exactly as the forward does
// (multiply, then subtract, each rounded, no fused multiply-add), with the
// bounds tested on floats before any float->int conversion. Each lane
// keeps a partial <g, V_c> for the four corners; a butterfly of
// __shfl_xor_sync sums them across the warp, and lane 0 writes d_attn and
// d_loc. d_value is scattered with float32 atomicAdd into a float32 buffer
// that the launch zeroes first (the order of the atomic adds is not fixed,
// so float32 d_value is reproducible only to rounding); for bfloat16 a
// second kernel casts that buffer into the output. Offsets are 64-bit. No
// shared-memory staging, TMA or wgmma yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// meta: int32 [L][3] = (H_l, W_l, level start) on the device.
template <typename T>
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const int* __restrict__ meta,
                                const float* __restrict__ loc,
                                const float* __restrict__ attn,
                                const T* __restrict__ grad_out,
                                float* __restrict__ d_value,
                                float* __restrict__ d_loc,
                                float* __restrict__ d_attn,
                                int64_t n_warps, int S, int M, int D,
                                int Lq, int L, int P) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // uniform per warp: every lane of a live warp takes part in the shuffles
  if (warp >= n_warps) return;
  // warp = (n * Lq + q) * M + m, the row-major index of (N, Lq, M)
  const int m = static_cast<int>(warp % M);
  const int64_t n = warp / M / Lq;
  const int LP = L * P;
  const float* loc_w = loc + warp * LP * 2;
  const float* attn_w = attn + warp * LP;
  float* dloc_w = d_loc + warp * LP * 2;
  float* dattn_w = d_attn + warp * LP;
  const T* g_w = grad_out + warp * D;            // (N, Lq, M*D) row of (n,q,m)
  const int64_t row = static_cast<int64_t>(M) * D;   // token stride
  const int64_t base = n * S * row + static_cast<int64_t>(m) * D;

  for (int l = 0; l < L; ++l) {
    const int H = meta[3 * l], W = meta[3 * l + 1];
    const int64_t start = base + static_cast<int64_t>(meta[3 * l + 2]) * row;
    const T* v_l = value + start;
    float* dv_l = d_value + start;
    for (int p = 0; p < P; ++p) {
      const int t = l * P + p;
      // the forward's coordinate, bit for bit (see ms_deform_attn_fwd.cu)
      const float w_im = __fsub_rn(__fmul_rn(loc_w[2 * t], W), 0.5f);
      const float h_im = __fsub_rn(__fmul_rn(loc_w[2 * t + 1], H), 0.5f);
      // false for NaN, and for any location whose four corners are all
      // outside the map: the tap adds nothing and gets no gradient. At
      // exactly -1 (which the forward skips) the tap adds 0 to the output
      // but has the one-sided derivative toward its in-map corner at 0,
      // which the JAX oracle and autograd of the plain version give: the
      // lower bounds are >=. (Zero-initialised offsets put the border
      // taps of a model's encoder exactly there.)
      if (!(h_im >= -1.f && w_im >= -1.f && h_im < H && w_im < W)) {
        if (lane == 0) {
          dattn_w[t] = 0.f;
          dloc_w[2 * t] = 0.f;
          dloc_w[2 * t + 1] = 0.f;
        }
        continue;
      }
      const float a = attn_w[t];
      const float h_f = floorf(h_im), w_f = floorf(w_im);
      const int h0 = static_cast<int>(h_f), w0 = static_cast<int>(w_f);
      const float lh = h_im - h_f, lw = w_im - w_f;
      const float hh = 1.f - lh, hw = 1.f - lw;
      const bool v00 = h0 >= 0 && w0 >= 0;
      const bool v01 = h0 >= 0 && w0 + 1 < W;
      const bool v10 = h0 + 1 < H && w0 >= 0;
      const bool v11 = h0 + 1 < H && w0 + 1 < W;
      const int64_t o00 = (static_cast<int64_t>(h0) * W + w0) * row;
      const int64_t o01 = o00 + row;
      const int64_t o10 = o00 + static_cast<int64_t>(W) * row;
      const int64_t o11 = o10 + row;
      // attn * w_c: the scale of g scattered to corner c
      const float s00 = a * (hh * hw), s01 = a * (hh * lw);
      const float s10 = a * (lh * hw), s11 = a * (lh * lw);

      float d00 = 0.f, d01 = 0.f, d10 = 0.f, d11 = 0.f;   // <g, V_c> parts
      for (int c = lane; c - lane < D; c += 32) {
        if (c >= D) continue;
        const float gc = to_float(g_w[c]);
        if (v00) {
          d00 += gc * to_float(v_l[o00 + c]);
          atomicAdd(dv_l + o00 + c, s00 * gc);
        }
        if (v01) {
          d01 += gc * to_float(v_l[o01 + c]);
          atomicAdd(dv_l + o01 + c, s01 * gc);
        }
        if (v10) {
          d10 += gc * to_float(v_l[o10 + c]);
          atomicAdd(dv_l + o10 + c, s10 * gc);
        }
        if (v11) {
          d11 += gc * to_float(v_l[o11 + c]);
          atomicAdd(dv_l + o11 + c, s11 * gc);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        d00 += __shfl_xor_sync(kFullMask, d00, off);
        d01 += __shfl_xor_sync(kFullMask, d01, off);
        d10 += __shfl_xor_sync(kFullMask, d10, off);
        d11 += __shfl_xor_sync(kFullMask, d11, off);
      }
      if (lane == 0) {
        // an invalid corner's dot stayed 0, so it adds nothing below
        dattn_w[t] = hh * hw * d00 + hh * lw * d01 + lh * hw * d10
                     + lh * lw * d11;
        // d w_c / d lw = (-hh, +hh, -lh, +lh); d w_c / d lh = (-hw, -lw,
        // +hw, +lw); pixel = loc * extent - 0.5
        const float gx = hh * (d01 - d00) + lh * (d11 - d10);
        const float gy = hw * (d10 - d00) + lw * (d11 - d01);
        dloc_w[2 * t] = a * gx * W;
        dloc_w[2 * t + 1] = a * gy * H;
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

template <typename T>
int launch(const T* value, const int* meta, const float* loc,
           const float* attn, const T* grad_out, float* dv_acc, T* dv_out,
           float* d_loc, float* d_attn, int N, int S, int M, int D, int Lq,
           int L, int P, cudaStream_t stream) {
  const int64_t dv_elems = static_cast<int64_t>(N) * S * M * D;
  cudaError_t err = cudaMemsetAsync(dv_acc, 0, dv_elems * sizeof(float),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_warps = static_cast<int64_t>(N) * Lq * M;
  const int threads = 256;
  if (n_warps > 0) {
    const int64_t blocks = (n_warps * 32 + threads - 1) / threads;
    msda_bwd_kernel<T><<<static_cast<unsigned>(blocks), threads, 0,
                         stream>>>(value, meta, loc, attn, grad_out, dv_acc,
                                   d_loc, d_attn, n_warps, S, M, D, Lq, L,
                                   P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (static_cast<void*>(dv_out) != static_cast<void*>(dv_acc)
      && dv_elems > 0) {
    int64_t blocks = (dv_elems + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;   // grid-stride beyond this
    cast_to_bf16<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
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
                            int D, int Lq, int L, int P, void* stream) {
  if (dv_acc != dv_out) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const float*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn),
                static_cast<const float*>(grad_out),
                static_cast<float*>(dv_acc), static_cast<float*>(dv_out),
                static_cast<float*>(d_loc), static_cast<float*>(d_attn),
                N, S, M, D, Lq, L, P, static_cast<cudaStream_t>(stream));
}

// d_value: accumulated in the float32 scratch dv_acc, cast into the
// bfloat16 output dv_out.
extern "C" int msda_bwd_bf16(const void* value, const void* meta,
                             const void* loc, const void* attn,
                             const void* grad_out, void* dv_acc,
                             void* dv_out, void* d_loc, void* d_attn, int N,
                             int S, int M, int D, int Lq, int L, int P,
                             void* stream) {
  if (dv_acc == dv_out) return static_cast<int>(cudaErrorInvalidValue);
  return launch(static_cast<const __nv_bfloat16*>(value),
                static_cast<const int*>(meta),
                static_cast<const float*>(loc),
                static_cast<const float*>(attn),
                static_cast<const __nv_bfloat16*>(grad_out),
                static_cast<float*>(dv_acc),
                static_cast<__nv_bfloat16*>(dv_out),
                static_cast<float*>(d_loc), static_cast<float*>(d_attn),
                N, S, M, D, Lq, L, P, static_cast<cudaStream_t>(stream));
}
