// Shared by the MSDA forward and backward kernels (sm_90a): the lane
// layout, 16-byte channel chunks, vector atomics and the per-tap geometry.
//
// Lane layout. A warp's 32 lanes form 32 / G row groups of G lanes; a
// group covers one D-wide value row with G chunks of VEC channels. In both
// kernels a warp owns one (n, q, head) and its groups take different taps
// (group g: taps g, g + 32 / G, ...), so a warp has 32 / G taps in flight
// at once. The vector
// instances take VEC = 16 bytes of the value dtype (8 bf16 or 4 float32
// channels, one 16-byte load per corner row) and need D == G * VEC with G
// dividing 32 and 16-byte aligned rows; the element instance (VEC = 1,
// G = 32) takes any D and any alignment, lanes over channels, looping for
// D > 32. The wrapper (ops/ms_deform_attn_cuda.py, `kernel_width`) picks
// the instance; the entry points refuse a width the pointers cannot take.
//
// Geometry once per tap: each group computes its own tap's pixel
// coordinate, corner weights, validity and corner rows (G lanes, not 32).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace msda {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC channels of T held by one lane: kept as the loaded words, read as
// float32 one channel at a time.
template <typename T, int VEC>
struct Chunk;

template <typename T>
struct Chunk<T, 1> {
  T r;
  __device__ __forceinline__ void load(const T* p) { r = *p; }
  __device__ __forceinline__ void clear() { r = from_float<T>(0.f); }
  __device__ __forceinline__ float operator[](int) const {
    return to_float(r);
  }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    *p = from_float<T>(f[0]);
  }
};

template <>
struct Chunk<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void clear() {
    r = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ float operator[](int k) const {
    return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 r;   // 8 bf16, channel 2i in the low half of word i
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void clear() { r = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ float operator[](int k) const {
    const unsigned w = k < 2 ? r.x : k < 4 ? r.y : k < 6 ? r.z : r.w;
    // a bf16 is the high half of the float32 with the same value
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ __forceinline__ static unsigned pack(float lo, float hi) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo)))
           | (static_cast<unsigned>(
                  __bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* f) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                   pack(f[6], f[7]));
  }
};

// The channels a lane scatters into a float32 d_value row: VEC of them, as
// VEC / 4 float4s, the k-th at channel k * 4G + 4 * lig, so that one atomic
// instruction of a row group covers 4G contiguous floats (whole 32-byte
// sectors of the L2). At VEC = 4 these are the lane's loaded channels; at
// VEC = 8 (bf16) they interleave with the other lanes' (two 16-byte
// atomics over the lane's own 8 loaded channels would update every sector
// in two halves); the element instance scatters its channel c0.
template <int VEC, int G>
__device__ __forceinline__ int scatter_channel(int k, int lig, int c0) {
  return VEC == 1 ? c0 : k * 4 * G + 4 * lig;
}

// g at the channels this lane scatters (see scatter_channel), as float32.
template <typename T, int VEC, int G>
__device__ __forceinline__ void load_scatter_g(const T* g_row, int lig,
                                               float* f) {
  if constexpr (VEC == 8) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(
          g_row + scatter_channel<VEC, G>(k, lig, 0)));
      f[4 * k] = __uint_as_float(w.x << 16);
      f[4 * k + 1] = __uint_as_float(w.x & 0xffff0000u);
      f[4 * k + 2] = __uint_as_float(w.y << 16);
      f[4 * k + 3] = __uint_as_float(w.y & 0xffff0000u);
    }
  } else {
    Chunk<T, VEC> c;
    c.load(g_row + lig * VEC);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = c[k];
  }
}

// d_value row += s * gs over the lane's scatter channels, in float32: one
// 16-byte vector atomic per 4 channels (sm_90's float4 atomicAdd on global
// memory), a scalar one for the element instance.
template <int VEC, int G>
__device__ __forceinline__ void scatter_add(float* row, int lig, int c0,
                                            float s, const float* gs) {
  if constexpr (VEC == 1) {
    atomicAdd(row + c0, s * gs[0]);
  } else {
    static_assert(VEC % 4 == 0, "vector scatter takes whole float4s");
#pragma unroll
    for (int k = 0; k < VEC / 4; ++k)
      atomicAdd(reinterpret_cast<float4*>(
                    row + scatter_channel<VEC, G>(k, lig, c0)),
                make_float4(s * gs[4 * k], s * gs[4 * k + 1],
                            s * gs[4 * k + 2], s * gs[4 * k + 3]));
  }
}

// One tap's bilinear footprint on its level.
struct Tap {
  int tok[4];     // token index (level start + h * W + w) of corners
                  // 00, 01, 10, 11; -1 where the corner is off the map
  float lh, lw;   // fractional parts of the pixel coordinate
  bool live;      // inside the bounds test: the tap touches the map
};

// A lane's slot past the last tap: touches nothing.
__device__ __forceinline__ Tap no_tap() {
  Tap k;
#pragma unroll
  for (int c = 0; c < 4; ++c) k.tok[c] = -1;
  k.lh = k.lw = 0.f;
  k.live = false;
  return k;
}

// The pixel coordinate is loc * extent - 0.5 with each step rounded (no
// fused multiply-add), so it matches the plain version bit for bit; at
// W = 168 one rounding of it moves an output by ~1e-5. The bounds test
// runs on floats before any float->int conversion, so a NaN or far
// location never converts or indexes. The forward's lower edge is > -1
// (a tap exactly on -1 adds 0); the backward's is >= -1, where the tap has
// the one-sided derivative toward its in-map corner that autograd and the
// JAX oracle give.
template <bool kLowerEdgeIncluded>
__device__ __forceinline__ Tap tap_corners(float x, float y, int H, int W,
                                           int start) {
  Tap k;
  const float w_im = __fsub_rn(__fmul_rn(x, W), 0.5f);
  const float h_im = __fsub_rn(__fmul_rn(y, H), 0.5f);
  k.live = kLowerEdgeIncluded
               ? (h_im >= -1.f && w_im >= -1.f && h_im < H && w_im < W)
               : (h_im > -1.f && w_im > -1.f && h_im < H && w_im < W);
  const float hs = k.live ? h_im : 0.f, ws = k.live ? w_im : 0.f;
  const float h_f = floorf(hs), w_f = floorf(ws);
  const int h0 = static_cast<int>(h_f), w0 = static_cast<int>(w_f);
  k.lh = hs - h_f;
  k.lw = ws - w_f;
  const bool top = k.live && h0 >= 0, bottom = k.live && h0 + 1 < H;
  const bool left = w0 >= 0, right = w0 + 1 < W;
  const int t00 = start + h0 * W + w0;
  k.tok[0] = top && left ? t00 : -1;
  k.tok[1] = top && right ? t00 + 1 : -1;
  k.tok[2] = bottom && left ? t00 + W : -1;
  k.tok[3] = bottom && right ? t00 + W + 1 : -1;
  return k;
}

// Level of tap t = l * P + p: (t + 0.5) / P rounded down, exact in float32
// for t < 2^20.
__device__ __forceinline__ int level_of(int t, float inv_p) {
  return static_cast<int>((static_cast<float>(t) + 0.5f) * inv_p);
}

// Taps per lane issued together (all their corner loads before the first
// multiply-add): enough for ~16 taps in flight per warp, at most kMax.
template <int VEC, int G, int kMax>
__host__ __device__ constexpr int taps_per_lane() {
  return VEC == 1 ? 1
                  : ((32 / G) >= 16 ? 1
                                    : (16 / (32 / G) > kMax ? kMax
                                                            : 16 / (32 / G)));
}

}  // namespace msda
