// Paged flash-decode: one decode query per slot attends over the slot's KV
// history, streamed page by page out of the shared pool through the online-
// softmax recurrence; the gathered (B, maxp * page, Hkv, D) view is never
// formed.
//
// Replaces: src/repro/kernels/paged_attention.py:paged_attention_kernel
// (Pallas body _pa_kernel); its plain reference is paged_attention_stream.
//
// What bounds it on an H100: bytes.  Every live K/V position is read once
// (Hkv * D * 2 values per layer); at 8 slots of ~200 positions, f32 pool,
// that is ~1.6 MB per layer, ~0.5 us at 3.35 TB/s, against ~6.5 MFLOP
// (~0.1 us at the 67 TFLOP/s float32 rate).  An int8 pool reads a quarter
// of those bytes plus one float32 scale per (page, head).
//
// Design: one block per (slot, KV head) serves the G = Hq / Hkv query rows
// that share the head; the TPU kernel's sequential page axis becomes a loop
// over tiles of 32 positions inside the block.  The block reads its slot's
// position and page ids itself and walks only positions 0..pos (pages past
// the live extent are never touched); each tile's K/V rows are gathered
// from their pages into shared memory as float32, and each warp runs the
// online-softmax update for its query rows.  An idle slot (pos = -1) runs
// no tile and writes exactly 0.  Splitting one slot's pages over several
// blocks (split-K) is later work.
//
// The int8 lane (paged_attention_i8; the int8 branch of _pa_kernel) reads
// int8 K/V codes and one float32 scale per (page, KV head), the running
// absmax scales of repro/quant/codec.py:page_scatter.  The scales of a
// tile's columns are looked up beside their page ids, and each code is
// dequantized (code * scale, in float32) as the tile is filled, so the
// shared-memory tile and everything after it are the float32 lane's.
#include "attn_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRowsPerWarp = 4;           // G <= kWarps * kMaxRowsPerWarp

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const TQ* __restrict__ q,          // (B, Hq, D)
             const TKV* __restrict__ pool_k,    // (P, page, Hkv, D)
             const TKV* __restrict__ pool_v,
             const int* __restrict__ table,     // (B, maxp)
             const int* __restrict__ positions, // (B,)
             const float* __restrict__ k_scale, // (P, Hkv), int8 lane only
             const float* __restrict__ v_scale,
             TQ* __restrict__ o,                // (B, Hq, D)
             int Hq, int Hkv, int D, int page, int maxp, int num_pages,
             float scale, float softcap) {
  using namespace attn;
  extern __shared__ float smem[];
  const int G = Hq / Hkv;
  float* qs = smem;                          // (G, D)
  float* ks = qs + G * D;                    // (kTile, D + 1)
  float* vs = ks + kTile * (D + 1);          // (kTile, D)
  __shared__ size_t colbase[kTile];          // element offset of (pos, head)
  __shared__ float colks[kTile], colvs[kTile];   // page scales (int8 lane)
  constexpr bool kQuant = sizeof(TKV) == 1;

  const int hk = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = positions[b];
  const int ncols = pos < 0 ? 0 : min(pos + 1, maxp * page);
  const TQ* qb = q + ((size_t)b * Hq + (size_t)hk * G) * D;
  TQ* ob = o + ((size_t)b * Hq + (size_t)hk * G) * D;

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x)
    qs[idx] = to_f32(qb[idx]) * scale;

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[rr][e] = 0.f;
  }

  for (int t0 = 0; t0 < ncols; t0 += kTile) {
    __syncthreads();                         // previous tile consumed
    if (threadIdx.x < kTile) {
      const int col = t0 + threadIdx.x;
      size_t base = 0;
      float ksc = 1.f, vsc = 1.f;
      if (col < ncols) {
        int pid = table[(size_t)b * maxp + col / page];
        pid = min(max(pid, 0), num_pages - 1);   // clamp like an XLA gather
        base = (((size_t)pid * page + col % page) * Hkv + hk) * D;
        if (kQuant) {
          ksc = k_scale[(size_t)pid * Hkv + hk];
          vsc = v_scale[(size_t)pid * Hkv + hk];
        }
      }
      colbase[threadIdx.x] = base;
      colks[threadIdx.x] = ksc;
      colvs[threadIdx.x] = vsc;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTile * D; idx += blockDim.x) {
      const int c = idx / D, d = idx % D;
      float kk = 0.f, vv = 0.f;              // zero-fill past the live extent
      if (t0 + c < ncols) {
        kk = to_f32(pool_k[colbase[c] + d]);
        vv = to_f32(pool_v[colbase[c] + d]);
        if (kQuant) {
          kk *= colks[c];
          vv *= colvs[c];
        }
      }
      ks[c * (D + 1) + d] = kk;
      vs[c * D + d] = vv;
    }
    __syncthreads();
    const bool valid = t0 + lane < ncols;    // col <= pos, within maxp pages
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int g = warp + kWarps * rr;
      if (g >= G) continue;                  // warp-uniform
      row_tile_update(qs + g * D, ks, vs, D, valid, softcap, m[rr], l[rr],
                      acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int g = warp + kWarps * rr;
    if (g < G) row_store(ob + (size_t)g * D, D, l[rr], acc[rr]);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* positions,
                   const float* k_scale, const float* v_scale, void* o, int B,
                   int Hq, int Hkv, int D, int page, int maxp, int num_pages,
                   float scale, float softcap, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)G * D + (size_t)attn::kTile * (D + 1) + (size_t)attn::kTile * D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hkv, B);
  paged_kernel<TQ, TKV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk),
      static_cast<const TKV*>(pv), table, positions, k_scale, v_scale,
      static_cast<TQ*>(o), Hq,
      Hkv, D, page, maxp, num_pages, scale, softcap);
  return cudaGetLastError();
}

}  // namespace

static bool bad_shape(int B, int Hq, int Hkv, int D, int page, int maxp,
                      int num_pages) {
  return B <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         Hq / Hkv > kWarps * kMaxRowsPerWarp || D <= 0 || D > attn::kMaxD ||
         page <= 0 || maxp <= 0 || num_pages <= 0;
}

// q, o: (B, Hq, D) in q_dtype; pool_k, pool_v: (P, page, Hkv, D) in
// kv_dtype (0 = float32, 1 = bfloat16); table: (B, maxp) int32;
// positions: (B,) int32.  All contiguous.  Returns a cudaError_t.
extern "C" int paged_attention(const void* q, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* positions, void* o, int B, int Hq,
                               int Hkv, int D, int page, int maxp,
                               int num_pages, float scale, float softcap,
                               int q_dtype, int kv_dtype, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, maxp, num_pages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(positions);
#define REPRO_PAGED(TQ, TKV)                                                  \
  return (int)launch<TQ, TKV>(q, pool_k, pool_v, t, p, nullptr, nullptr, o,   \
                              B, Hq, Hkv, D, page, maxp, num_pages, scale,    \
                              softcap, s)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_PAGED(float, float);
  if (q_dtype == 0 && kv_dtype == 1) REPRO_PAGED(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) REPRO_PAGED(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_PAGED
  return (int)cudaErrorInvalidValue;
}

// The int8 pool lane: pool_k, pool_v int8 codes (P, page, Hkv, D) with
// float32 scales k_scale, v_scale (P, Hkv); q, o in q_dtype (0 = float32,
// 1 = bfloat16).  Otherwise as paged_attention.
extern "C" int paged_attention_i8(const void* q, const void* pool_k,
                                  const void* pool_v, const void* k_scale,
                                  const void* v_scale, const void* table,
                                  const void* positions, void* o, int B,
                                  int Hq, int Hkv, int D, int page, int maxp,
                                  int num_pages, float scale, float softcap,
                                  int q_dtype, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, maxp, num_pages))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(positions);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (q_dtype == 0)
    return (int)launch<float, int8_t>(q, pool_k, pool_v, t, p, ks, vs, o, B,
                                      Hq, Hkv, D, page, maxp, num_pages,
                                      scale, softcap, s);
  if (q_dtype == 1)
    return (int)launch<__nv_bfloat16, int8_t>(q, pool_k, pool_v, t, p, ks, vs,
                                              o, B, Hq, Hkv, D, page, maxp,
                                              num_pages, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
