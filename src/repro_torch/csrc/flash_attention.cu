// Flash-attention forward for prefill: online softmax with float32
// statistics, causal / sliding-window masks, logit softcap, GQA, kv_offset.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// body _kernel), whose plain reference is kernels/ref.py:attention_ref.
//
// What bounds it on an H100: bytes, barely.  At the prefill shape (B = 1,
// Hq = 32, Hkv = 4, D = 64, S = 256, bf16) q, k, v and the output are
// ~2.4 MB, ~0.7 us at 3.35 TB/s; the causal products are ~270 MFLOP,
// ~0.3 us on the bf16 tensor cores.  This first version computes in
// float32 on the CUDA cores (67 TFLOP/s, ~4 us for the same products), so
// operations, not bytes, are what it spends.
//
// Design: one block per (batch, query head, tile of 32 query rows); the
// TPU kernel's sequential KV grid axis becomes a loop inside the block.
// Each tile of 32 keys and values is staged in shared memory as float32 and
// used by all 32 query rows of the block (4 warps x 8 rows); lane c scores
// key c, the warp reduces max and sum, lane d accumulates output dim d.
// KV tiles entirely outside a row's causal/window extent are skipped (an
// all-masked tile changes nothing).  Keys past Skv are zero-filled before
// any product, so padding never poisons a row with NaN, and a row with no
// valid key comes out exactly 0.  No tensor cores yet: wgmma/TMA are later
// work.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             int Hq, int Hkv, int Sq, int Skv, int D, float scale,
             int causal, int window, float softcap, int kv_offset) {
  using namespace attn;
  extern __shared__ float smem[];
  float* qs = smem;                          // (kBlockQ, D)
  float* ks = qs + kBlockQ * D;              // (kTile, D + 1)
  float* vs = ks + kTile * (D + 1);          // (kTile, D)

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int r0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qb = q + ((size_t)b * Hq + h) * Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Skv * D;
  T* ob = o + ((size_t)b * Hq + h) * Sq * D;

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += blockDim.x) {
    const int row = r0 + idx / D;
    qs[idx] = row < Sq ? to_f32(qb[(size_t)row * D + idx % D]) * scale : 0.f;
  }

  // KV extent any row of this block can see
  const int last_row = min(r0 + kBlockQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = max(0, min(Skv, last_row + kv_offset + 1));
  int kv_lo = 0;
  if (window) kv_lo = max(0, r0 + kv_offset - window + 1) / kTile * kTile;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[rr][e] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kTile) {
    __syncthreads();                         // previous tile consumed
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int c = idx / D, d = idx % D;
      const int col = t0 + c;
      float kk = 0.f, vv = 0.f;              // zero-fill past Skv
      if (col < Skv) {
        kk = to_f32(kb[(size_t)col * D + d]);
        vv = to_f32(vb[(size_t)col * D + d]);
      }
      ks[c * (D + 1) + d] = kk;
      vs[c * D + d] = vv;
    }
    __syncthreads();
    const int col = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int row = r0 + r;
      if (row >= Sq) continue;               // warp-uniform
      const int pos = row + kv_offset;
      if (causal && t0 > pos) continue;      // tile wholly in the future
      if (window && t0 + kTile - 1 <= pos - window) continue;  // wholly stale
      bool valid = col < Skv;
      if (causal) valid = valid && col <= pos;
      if (window) valid = valid && col > pos - window;
      row_tile_update(qs + r * D, ks, vs, D, valid, softcap, m[rr], l[rr],
                      acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int row = r0 + warp * kRowsPerWarp + rr;
    if (row < Sq) row_store(ob + (size_t)row * D, D, l[rr], acc[rr]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Skv, int D, float scale,
                   int causal, int window, float softcap, int kv_offset,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * D + (size_t)attn::kTile * (D + 1) + (size_t)attn::kTile * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + kBlockQ - 1) / kBlockQ, Hq, B);
  flash_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      scale, causal, window, softcap, kv_offset);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); o: (B, Hq, Sq, D), all of one
// dtype (0 = float32, 1 = bfloat16), contiguous.  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Hq, int Hkv, int Sq,
                               int Skv, int D, float scale, int causal,
                               int window, float softcap, int kv_offset,
                               int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > attn::kMaxD || Skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale,
                              causal, window, softcap, kv_offset, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                      scale, causal, window, softcap,
                                      kv_offset, s);
  return (int)cudaErrorInvalidValue;
}
