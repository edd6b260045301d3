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
// of those bytes plus one float32 scale per (page, head).  At these sizes
// what a kernel spends is latency: dependent memory round trips, a launch,
// and how many SMs share the work.
//
// Design (the plan, kernels/paged_attention.py:plan, is a pure function of
// the shapes and never reads positions, so a call can be captured in a
// CUDA graph):
// - Grid (Hkv x group tiles, B, splits).  Each block serves up to 16 of
//   the G = Hq / Hkv query rows of one (slot, KV head) over one split: a
//   range of `pps` whole pages of the slot's table.  Splits are chosen so that B * Hkv * splits comes
//   near one wave of the card's 132 SMs.  With one split the block writes
//   its rows; with more, each live split writes (m, l, acc) to float32
//   scratch and paged_combine, launched from the same exported call,
//   merges the live splits of a slot in split order (fixed, so two calls
//   agree to the bit).  A split whose first column lies past positions[b]
//   does nothing, and the combine skips it by the same rule; an idle slot
//   (positions = -1) has no live split and comes out exactly 0.
// - The split's page ids (clamped to [0, P) like an XLA gather) are read
//   from the table once, at the start of the block, into shared memory;
//   the int8 lane then reads their (page, head) scales, while the first
//   tile's loads are in flight.  No tile waits on the table.
// - Tiles of 32 keys.  A key's row of D values is contiguous in the pool,
//   so K and V rows are read in 16-byte pieces (4 float32, 8 bf16 or 16
//   int8 values).  Double buffering by register prefetch: the loads of
//   tile t+1 are issued before tile t is scored, and their values are
//   widened to float32 (int8: code * scale) on the store into the other
//   shared-memory buffer, one barrier a tile.  Register prefetch rather
//   than cp.async because every pool dtype but float32 has to be widened
//   or dequantized before the float32 tile, and cp.async would need a
//   staging buffer and a second pass over shared memory for that.  Keys
//   past the split's live extent are zero-filled, so padding never meets
//   a product.  Where D * element size is not a multiple of 16 bytes (or
//   the pool is not 16-byte aligned) a scalar path reads value by value.
// - Head dims 64 and 128 are compile-time (float4 dots over K rows of
//   stride D + 4, attn_common.cuh:row_tile_f32); other D <= 128 take the
//   run-time-D instance; 128 < D <= 256 the wide tile: K / V tiles 256
//   wide (K rows of stride 260), the columns past D zeroed once a block
//   and never written again, float4 dots over all 256 (the zeros add
//   nothing), 8 output dims a lane (4 below), only D stored; it runs on 8
//   warps.
// - Query groups: a block serves up to 16 query heads of its KV head; a
//   group G > 16 takes ceil(G / 16) blocks on grid x (Falcon-7B's 71 heads
//   over one KV head: 16, 16, 16, 16, 7), each reading the slot's pages
//   again (simple and right; sharing a page read across the tiles is
//   later work).  One warp per query row up to 8 rows (4 or 8 warps), two
//   rows a warp up to 16.
#include "attn_common.cuh"

namespace {

using attn::kNeg;
using attn::kTile;

constexpr int kMinThreads = 128;             // 4 warps
constexpr int kMaxThreads = 256;             // 8 warps
constexpr int kGroupTile = 16;               // query heads a block, at most
constexpr int kMaxRowsPerWarp = 2;           // kGroupTile rows over 8 warps
constexpr int kWideD = 256;                  // the wide tile (kMaxD < D)
constexpr int kCombineWarps = 8;

// Output dims a lane accumulates: 4 up to kMaxD, 8 in the wide tile.
__host__ __device__ constexpr int npl(int DT) {
  return DT > attn::kMaxD ? kWideD / 32 : attn::kDPerLane;
}

// 16 bytes of TKV values -> float32 (times the page scale for int8) at dst
// (16-byte aligned shared memory).
template <typename TKV>
__device__ __forceinline__ void widen16(const uint4& raw, float scale,
                                        float* dst);
template <>
__device__ __forceinline__ void widen16<float>(const uint4& raw, float,
                                               float* dst) {
  *reinterpret_cast<uint4*>(dst) = raw;
}
template <>
__device__ __forceinline__ void widen16<__nv_bfloat16>(const uint4& raw,
                                                       float, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 a = __bfloat1622float2(h[2 * i]);
    const float2 b = __bfloat1622float2(h[2 * i + 1]);
    reinterpret_cast<float4*>(dst)[i] = make_float4(a.x, a.y, b.x, b.y);
  }
}
template <>
__device__ __forceinline__ void widen16<int8_t>(const uint4& raw, float scale,
                                                float* dst) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(dst)[i] = make_float4(
        static_cast<float>(c[4 * i]) * scale,
        static_cast<float>(c[4 * i + 1]) * scale,
        static_cast<float>(c[4 * i + 2]) * scale,
        static_cast<float>(c[4 * i + 3]) * scale);
}

template <typename TQ, typename TKV, int DT>
__global__ void __launch_bounds__(kMaxThreads)
paged_kernel(const TQ* __restrict__ q,          // (B, Hq, D)
             const TKV* __restrict__ pool_k,    // (P, page, Hkv, D)
             const TKV* __restrict__ pool_v,
             const int* __restrict__ table,     // (B, maxp)
             const int* __restrict__ positions, // (B,)
             const float* __restrict__ k_scale, // (P, Hkv), int8 lane only
             const float* __restrict__ v_scale,
             TQ* __restrict__ o,                // (B, Hq, D)
             float* __restrict__ part,          // splits > 1: (m, l), acc
             int B, int Hq, int Hkv, int D, int page, int maxp,
             int num_pages, int pps, int splits, int vec_in, float scale,
             float softcap) {
  using namespace attn;
  constexpr bool kQuant = sizeof(TKV) == 1;
  constexpr bool kWide = DT > kMaxD;         // D <= DT in a zero-padded tile
  constexpr int NPL = npl(DT);
  constexpr int EPC = 16 / sizeof(TKV);      // values in 16 bytes
  // 16-byte pieces a thread prefetches for K (and again for V), at 4 warps
  // (the wide tile: at 8)
  constexpr int kThr = kWide ? kMaxThreads : kMinThreads;
  constexpr int kCh = (kTile * (DT ? DT : kMaxD) / EPC + kThr - 1) / kThr;
  // DT = 64, 128: always vectors
  const bool vec = (DT != 0 && !kWide) || vec_in != 0;
  const int Dn = DT ? DT : D;                // the tile's width; D the pool's
  const int KS = Dn + 4;                     // K row stride
  const int G = Hq / Hkv;
  const int gtiles = (G + kGroupTile - 1) / kGroupTile;
  const int hk = blockIdx.x / gtiles, b = blockIdx.y, split = blockIdx.z;
  const int g0 = (blockIdx.x % gtiles) * kGroupTile;   // the block's heads
  const int GT = min(kGroupTile, G - g0);              // g0 .. g0 + GT - 1
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                          // (GT, Dn), scaled
  float* tiles = qs + GT * Dn;               // [2][K (kTile, KS), V (kTile, Dn)]
  const int tile_f = kTile * (KS + Dn);
  int* spid = reinterpret_cast<int*>(tiles + 2 * tile_f);   // (pps)
  float* sks = reinterpret_cast<float*>(spid + pps);        // (pps), int8
  float* svs = sks + pps;

  const int tid = threadIdx.x, nthr = blockDim.x, warps = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31;
  const int p0 = split * pps;                 // first page of the split
  const int np = min(pps, maxp - p0);
  // the split's page ids: read (and clamped) once, issued beside positions
  for (int i = tid; i < np; i += nthr) {
    const int pid = table[(size_t)b * maxp + p0 + i];
    spid[i] = min(max(pid, 0), num_pages - 1);
  }
  const int pos = positions[b];
  const int ncols = pos < 0 ? 0 : min(pos + 1, maxp * page);
  const int c0 = p0 * page;                   // the split's columns [c0, c1)
  const int c1 = min(ncols, c0 + np * page);
  const bool live = c0 < ncols;
  if (!live && splits > 1) return;            // the combine skips it too
  const TQ* qb = q + ((size_t)b * Hq + (size_t)hk * G + g0) * D;
  for (int idx = tid; idx < GT * Dn; idx += nthr) {
    const int g = idx / Dn, d = idx % Dn;
    qs[idx] = d < D ? to_f32(qb[(size_t)g * D + d]) * scale : 0.f;
  }
  if (kWide) {            // the tiles' columns D .. DT - 1: zeros, never
    const int pad = Dn - D;                   // written again
    for (int idx = tid; idx < 2 * kTile * pad; idx += nthr) {
      const int c = idx / pad, d = D + idx % pad;
      float* buf = tiles + (c / kTile) * tile_f;
      buf[(c % kTile) * KS + d] = 0.f;
      buf[kTile * KS + (c % kTile) * Dn + d] = 0.f;
    }
  }
  __syncthreads();                            // page ids visible

  const int cpr = D / EPC;                    // pieces a key row
  const int nch = kTile * cpr;
  const auto key_base = [&](int col) {        // element offset of (col, hk)
    const int pg = col / page;
    return (((size_t)spid[pg - p0] * page + (col - pg * page)) * Hkv + hk) *
           D;
  };
  uint4 rk[kCh], rv[kCh];
  const auto load = [&](int t0) {             // tile at t0 -> registers
#pragma unroll
    for (int j = 0; j < kCh; ++j) {
      const int ch = tid + j * nthr;
      uint4 a = make_uint4(0u, 0u, 0u, 0u), c = a;
      const int col = t0 + ch / cpr;
      if (ch < nch && col < c1) {             // zero-fill past the extent
        const size_t off = key_base(col) + (size_t)(ch % cpr) * EPC;
        a = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
        c = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
      }
      rk[j] = a;
      rv[j] = c;
    }
  };
  const auto page_scales = [&](int col, float& ksc, float& vsc) {
    ksc = vsc = 1.f;
    if (kQuant && col < c1) {
      const int i = col / page - p0;
      ksc = sks[i];
      vsc = svs[i];
    }
  };
  const auto store = [&](float* buf, int t0) {   // registers -> float32 tile
    float* ks = buf;
    float* vs = buf + kTile * KS;
    if (vec) {
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        const int ch = tid + j * nthr;
        if (ch >= nch) continue;
        const int c = ch / cpr, d0 = (ch % cpr) * EPC;
        float ksc, vsc;
        page_scales(t0 + c, ksc, vsc);
        widen16<TKV>(rk[j], ksc, ks + c * KS + d0);
        widen16<TKV>(rv[j], vsc, vs + c * Dn + d0);
      }
      return;
    }
    for (int idx = tid; idx < kTile * D; idx += nthr) {    // scalar path
      const int c = idx / D, d = idx % D, col = t0 + c;
      float kk = 0.f, vv = 0.f;
      if (col < c1) {
        const size_t base = key_base(col);
        float ksc, vsc;
        page_scales(col, ksc, vsc);
        kk = to_f32(pool_k[base + d]) * ksc;
        vv = to_f32(pool_v[base + d]) * vsc;
      }
      ks[c * KS + d] = kk;
      vs[c * Dn + d] = vv;
    }
  };

  const int ntiles = live ? (c1 - c0 + kTile - 1) / kTile : 0;
  if (vec && ntiles > 0) load(c0);
  if (kQuant && live) {                        // scales, beside tile 0's loads
    for (int i = tid; i < np; i += nthr) {
      const size_t si = (size_t)spid[i] * Hkv + hk;
      sks[i] = k_scale[si];
      svs[i] = v_scale[si];
    }
    __syncthreads();
  }
  if (ntiles > 0) store(tiles, c0);
  if (vec && ntiles > 1) load(c0 + kTile);
  __syncthreads();

  float m[kMaxRowsPerWarp], l[kMaxRowsPerWarp], acc[kMaxRowsPerWarp][NPL];
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[rr][e] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    const float* buf = tiles + (t & 1) * tile_f;
    const int t0 = c0 + t * kTile;
    const bool valid = t0 + lane < c1;         // col <= pos, in the split
#pragma unroll
    for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
      const int g = warp + warps * rr;
      if (g >= GT) continue;                   // warp-uniform
      row_tile_f32<DT, NPL>(qs + g * Dn, buf, buf + kTile * KS, Dn, valid,
                            softcap, m[rr], l[rr], acc[rr]);
    }
    if (t + 1 < ntiles) {                      // the other buffer is free
      store(tiles + ((t + 1) & 1) * tile_f, t0 + kTile);
      if (vec && t + 2 < ntiles) load(t0 + 2 * kTile);
    }
    __syncthreads();
  }

  const size_t ml_n = (size_t)2 * splits * B * Hq;
#pragma unroll
  for (int rr = 0; rr < kMaxRowsPerWarp; ++rr) {
    const int g = warp + warps * rr;
    if (g >= GT) continue;
    const size_t row = (size_t)b * Hq + (size_t)hk * G + g0 + g;
    if (splits == 1) {
      row_store(o + row * D, D, l[rr], acc[rr]);
      continue;
    }
    const size_t slot = (size_t)split * B * Hq + row;
    if (lane == 0) {
      part[2 * slot] = m[rr];
      part[2 * slot + 1] = l[rr];
    }
    float* pa = part + ml_n + slot * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e)
      if (lane + 32 * e < D) pa[lane + 32 * e] = acc[rr][e];
  }
}

// One warp per (slot, query head): merge the slot's live splits in split
// order.  A slot with none (idle) writes exactly 0.  NPL dims a lane, as
// the kernel that wrote them.
template <typename TQ, int NPL>
__global__ void __launch_bounds__(kCombineWarps * 32)
paged_combine(const float* __restrict__ part, const int* __restrict__ positions,
              TQ* __restrict__ o, int B, int Hq, int D, int page, int maxp,
              int pps, int splits) {
  using namespace attn;
  const int w = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= B * Hq) return;
  const int pos = positions[w / Hq];
  const int ncols = pos < 0 ? 0 : min(pos + 1, maxp * page);
  const int span = pps * page;
  const int nlive = (ncols + span - 1) / span;
  const size_t stride = (size_t)B * Hq;
  float mx = kNeg;
  for (int s = 0; s < nlive; ++s) mx = fmaxf(mx, part[2 * (s * stride + w)]);
  float l = 0.f, acc[NPL];
#pragma unroll
  for (int e = 0; e < NPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < nlive; ++s) {
    const size_t slot = s * stride + w;
    const float c = expf(part[2 * slot] - mx);
    l += part[2 * slot + 1] * c;
    const float* pa = part + 2 * splits * stride + slot * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e)
      if (lane + 32 * e < D) acc[e] += pa[lane + 32 * e] * c;
  }
  row_store(o + (size_t)w * D, D, l, acc);
}

// G query heads of the KV head in tiles of kGroupTile; a tile W wide
size_t smem_bytes(int G, int W, int pps, bool quant) {
  const size_t rows = G < kGroupTile ? G : kGroupTile;
  return sizeof(float) * (rows * W + (size_t)2 * kTile * (2 * W + 4)) +
         (size_t)pps * 4 * (quant ? 3 : 1);
}

template <typename TQ, typename TKV, int DT>
cudaError_t launch_dt(const void* q, const void* pk, const void* pv,
                      const int* table, const int* positions,
                      const float* k_scale, const float* v_scale, void* o,
                      float* part, int B, int Hq, int Hkv, int D, int page,
                      int maxp, int num_pages, int pps, int splits, int warps,
                      bool vec, float scale, float softcap,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(Hq / Hkv, DT ? DT : D, pps, sizeof(TKV) == 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_kernel<TQ, TKV, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int G = Hq / Hkv;
  dim3 grid(Hkv * ((G + kGroupTile - 1) / kGroupTile), B, splits);
  paged_kernel<TQ, TKV, DT><<<grid, warps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(pk),
      static_cast<const TKV*>(pv), table, positions, k_scale, v_scale,
      static_cast<TQ*>(o), part, B, Hq, Hkv, D, page, maxp, num_pages, pps,
      splits, vec ? 1 : 0, scale, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int rows = B * Hq;
  paged_combine<TQ, npl(DT)><<<(rows + kCombineWarps - 1) / kCombineWarps,
                      kCombineWarps * 32, 0, stream>>>(
      part, positions, static_cast<TQ*>(o), B, Hq, D, page, maxp, pps,
      splits);
  return cudaGetLastError();
}

// Head dims 64 and 128 compile-time (16-byte loads); any other D <= 128 at
// run time; 128 < D <= 256 in the wide tile, zeros past D.  The last two
// read 16-byte pieces where each key row is a whole number of them and the
// pool is 16-byte aligned, else value by value.
template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const int* table, const int* positions,
                   const float* k_scale, const float* v_scale, void* o,
                   float* part, int B, int Hq, int Hkv, int D, int page,
                   int maxp, int num_pages, int pps, int splits, int warps,
                   float scale, float softcap, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(pk) | reinterpret_cast<uintptr_t>(pv)) &
       15) == 0;
  const bool vec = aligned && (D * sizeof(TKV)) % 16 == 0;
#define REPRO_PAGED_DT(DT)                                                   \
  return launch_dt<TQ, TKV, DT>(q, pk, pv, table, positions, k_scale,        \
                                v_scale, o, part, B, Hq, Hkv, D, page, maxp, \
                                num_pages, pps, splits, warps, vec, scale,   \
                                softcap, stream)
  if (vec && D == 64) REPRO_PAGED_DT(64);
  if (vec && D == 128) REPRO_PAGED_DT(128);
  if (D > attn::kMaxD) REPRO_PAGED_DT(kWideD);
  REPRO_PAGED_DT(0);
#undef REPRO_PAGED_DT
}

}  // namespace

// The plan's bounds: D <= 256, pps pages a split, `splits` splits covering
// the table's maxp pages (none empty), 4 to 8 warps (8 above kMaxD), a
// block's group tile at most kMaxRowsPerWarp rows a warp, scratch wherever
// there is more than one split.
static bool bad_shape(int B, int Hq, int Hkv, int D, int page, int maxp,
                      int num_pages, int pps, int splits, int warps,
                      const void* part) {
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0) return true;
  const int G = Hq / Hkv, rows = G < kGroupTile ? G : kGroupTile;
  return D <= 0 || D > kWideD || page <= 0 || maxp <= 0 ||
         num_pages <= 0 || pps <= 0 || splits <= 0 ||
         (size_t)splits * pps < (size_t)maxp ||
         (size_t)(splits - 1) * pps >= (size_t)maxp ||
         warps * 32 < kMinThreads || warps * 32 > kMaxThreads ||
         (D > attn::kMaxD && warps * 32 != kMaxThreads) ||
         rows > warps * kMaxRowsPerWarp || (splits > 1 && part == nullptr);
}

// q, o: (B, Hq, D) in q_dtype; pool_k, pool_v: (P, page, Hkv, D) in
// kv_dtype (0 = float32, 1 = bfloat16); table: (B, maxp) int32;
// positions: (B,) int32.  All contiguous.  Any D <= 256 and any group.
// The plan: `splits` ranges of `pps` pages, `warps` warps a block (8 where
// D > 128); with splits > 1, part is float32 scratch of
// splits * B * Hq * (D + 2).  Returns a cudaError_t.
extern "C" int paged_attention(const void* q, const void* pool_k,
                               const void* pool_v, const void* table,
                               const void* positions, void* o, void* part,
                               int B, int Hq, int Hkv, int D, int page,
                               int maxp, int num_pages, float scale,
                               float softcap, int q_dtype, int kv_dtype,
                               int pps, int splits, int warps, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, maxp, num_pages, pps, splits, warps,
                part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(positions);
  float* pa = static_cast<float*>(part);
#define REPRO_PAGED(TQ, TKV)                                                  \
  return (int)launch<TQ, TKV>(q, pool_k, pool_v, t, p, nullptr, nullptr, o,   \
                              pa, B, Hq, Hkv, D, page, maxp, num_pages, pps,  \
                              splits, warps, scale, softcap, s)
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
                                  const void* positions, void* o, void* part,
                                  int B, int Hq, int Hkv, int D, int page,
                                  int maxp, int num_pages, float scale,
                                  float softcap, int q_dtype, int pps,
                                  int splits, int warps, void* stream) {
  if (bad_shape(B, Hq, Hkv, D, page, maxp, num_pages, pps, splits, warps,
                part))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* p = static_cast<const int*>(positions);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  float* pa = static_cast<float*>(part);
  if (q_dtype == 0)
    return (int)launch<float, int8_t>(q, pool_k, pool_v, t, p, ks, vs, o, pa,
                                      B, Hq, Hkv, D, page, maxp, num_pages,
                                      pps, splits, warps, scale, softcap, s);
  if (q_dtype == 1)
    return (int)launch<__nv_bfloat16, int8_t>(
        q, pool_k, pool_v, t, p, ks, vs, o, pa, B, Hq, Hkv, D, page, maxp,
        num_pages, pps, splits, warps, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
