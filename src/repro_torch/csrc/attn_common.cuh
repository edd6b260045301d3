// Helpers shared by the two attention kernels (flash_attention.cu and
// paged_attention.cu): dtype conversion, warp reductions, and the online-
// softmax update of one query row against one tile of 32 keys.
//
// Layout of a tile in shared memory (float32):
//   ks[c * (D + 1) + d]  key c, dim d (row stride D + 1: lane c reads
//                        column d without bank conflicts)
//   vs[c * D + d]        value c, dim d (lane d reads row c)
// Each warp owns its query rows.  Lane c scores key c of the tile; the
// softmax statistics are reduced across the warp; lane d accumulates
// output dims d, d + 32, d + 64, d + 96 (D <= kMaxD).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace attn {

constexpr int kTile = 32;            // keys per tile: one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kNeg = -1e30f;       // the masked score, as in the Pallas kernels

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<int8_t>(int8_t v) {
  return static_cast<float>(v);   // an int8 code; the caller applies its scale
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, like astype(bfloat16)
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One query row (already scaled, float32, in shared memory) against one
// tile.  `valid` is this lane's mask bit for its key.  All 32 lanes of the
// warp must call it together.  A tile in which no key is valid leaves
// (m, l, acc) exactly as they were.
__device__ __forceinline__ void row_tile_update(
    const float* __restrict__ qrow, const float* __restrict__ ks,
    const float* __restrict__ vs, int D, bool valid, float softcap,
    float& m, float& l, float (&acc)[kDPerLane]) {
  const int lane = threadIdx.x & 31;
  const float* krow = ks + lane * (D + 1);
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
  if (softcap != 0.f) s = softcap * tanhf(s / softcap);
  s = valid ? s : kNeg;
  const float m_new = fmaxf(m, warp_max(s));
  const float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) acc[e] *= alpha;
  for (int c = 0; c < kTile; ++c) {
    const float pc = __shfl_sync(0xffffffffu, p, c);
    const float* vrow = vs + c * D;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < D) acc[e] = fmaf(pc, vrow[d], acc[e]);
    }
  }
}

// Write one finished row: acc / max(l, 1e-30).  A row that never saw a
// valid key has acc == 0 and comes out exactly 0.
template <typename T>
__device__ __forceinline__ void row_store(T* __restrict__ out, int D, float l,
                                          const float (&acc)[kDPerLane]) {
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) {
    const int d = lane + 32 * e;
    if (d < D) out[d] = from_f32<T>(acc[e] / denom);
  }
}

}  // namespace attn

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
