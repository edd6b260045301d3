// Helpers shared by the two attention kernels (flash_attention.cu and
// paged_attention.cu): dtype conversion, warp reductions, the row store,
// and (paged_attention.cu's) online-softmax update of one query row
// against one tile of 32 keys.
//
// Layout of a tile in shared memory (float32), W its width (D, or a
// compile-time width with zeros past D):
//   ks[c * (W + 4) + d]  key c, dim d (row stride W + 4: lane c reads
//                        its row as float4 without bank conflicts)
//   vs[c * W + d]        value c, dim d (lane d reads row c)
// Each warp owns its query rows.  Lane c scores key c of the tile; the
// softmax statistics are reduced across the warp; lane d accumulates
// output dims d, d + 32, ... (4 of them up to kMaxD, 8 up to 256).
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
// tile, the tile's width fixed at compile time (DT = 64, 128 or 256; 0 = D
// at run time): K rows of stride DT + 4 read as float4, the dot in four
// partial sums, so it is not one chain of D dependent FMAs.  A tile wider
// than the head dim holds zeros past it.  Lane d accumulates the N dims d,
// d + 32, ...  `valid` is this lane's mask bit for its key.  All 32 lanes
// of the warp must call it together.  A tile in which no key is valid
// leaves (m, l, acc) exactly as they were.
template <int DT, int N>
__device__ __forceinline__ void row_tile_f32(
    const float* __restrict__ qrow, const float* __restrict__ ks,
    const float* __restrict__ vs, int D, bool valid, float softcap,
    float& m, float& l, float (&acc)[N]) {
  const int Dn = DT ? DT : D;
  const int lane = threadIdx.x & 31;
  const float* krow = ks + lane * (Dn + 4);
  float s = 0.f;
  if (DT) {
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < DT; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + d);
      const float4 c = *reinterpret_cast<const float4*>(krow + d);
      s4[0] = fmaf(a.x, c.x, s4[0]);
      s4[1] = fmaf(a.y, c.y, s4[1]);
      s4[2] = fmaf(a.z, c.z, s4[2]);
      s4[3] = fmaf(a.w, c.w, s4[3]);
    }
    s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  } else {
    for (int d = 0; d < D; ++d) s = fmaf(qrow[d], krow[d], s);
  }
  if (softcap != 0.f) s = softcap * tanhf(s / softcap);
  s = valid ? s : kNeg;
  const float m_new = fmaxf(m, warp_max(s));
  const float p = valid ? expf(s - m_new) : 0.f;
  const float alpha = expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] *= alpha;
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    const float pc = __shfl_sync(0xffffffffu, p, c);
    const float* vrow = vs + c * Dn;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int d = lane + 32 * e;
      if (d < Dn) acc[e] = fmaf(pc, vrow[d], acc[e]);
    }
  }
}

// Write one finished row: acc / max(l, 1e-30).  A row that never saw a
// valid key has acc == 0 and comes out exactly 0.  Lane d holds dims d,
// d + 32, ... (N of them: kDPerLane up to kMaxD, 8 up to 256).
template <typename T, int N>
__device__ __forceinline__ void row_store(T* __restrict__ out, int D, float l,
                                          const float (&acc)[N]) {
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int d = lane + 32 * e;
    if (d < D) out[d] = from_f32<T>(acc[e] / denom);
  }
}

}  // namespace attn

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
