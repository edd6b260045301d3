// Flash-attention forward: online softmax with float32 statistics,
// causal / sliding-window masks, logit softcap, GQA, kv_offset.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention (Pallas
// body _kernel), whose plain reference is kernels/ref.py:attention_ref.
//
// What bounds it on an H100.  At the bf16 prefill shape (B = 1, Hq = 32,
// Hkv = 4, D = 64, S = 256) q, k, v and the output are ~2.4 MB, ~0.7 us at
// 3.35 TB/s, and the causal products ~270 MFLOP, ~0.3 us on the bf16
// tensor cores: bytes, barely, and in practice latency (a few tiles per
// block).  At the float32 decode shape (8 rows of one query, 231 keys)
// the bound is ~1.2 us of bytes; there too what a kernel spends is
// latency: a launch, a few 32-key tiles, and how many SMs share them.
//
// Design, two lanes:
// - bf16 (flash_bf16_kernel): one block of 4 warps per (batch, query
//   head, 64 query rows), each warp 16 rows.  Q K^T and P V run on
//   mma.sync m16n8k16 (bf16 in, float32 accumulators) with fragments
//   loaded by ldmatrix (V through ldmatrix.trans).  K/V tiles of 64 keys
//   are staged as bf16 with cp.async, double-buffered; keys past Skv are
//   zero-filled by the copy itself (src-size 0), so padding never meets a
//   product.  The online softmax runs on the accumulator fragments: a
//   row's four lanes reduce the max with two shuffles; masked scores are
//   -inf, so exp() gives exactly 0 for them; P goes to bf16 in registers
//   as the A operand of P V (FlashAttention-2), and the row sum l is
//   taken from the float32 P.  Tiles wholly masked for a warp are
//   skipped; tiles outside the block's causal / window extent are never
//   loaded.
// - float32 (flash_f32_kernel), the parity lane, on the CUDA cores: GQA
//   packing puts the G query heads of a KV head and the query rows of a
//   position together (packed row = position * G + head), up to 64 packed
//   rows a block (fewer where that leaves SMs idle: the S = 48 prefill),
//   so each K/V tile is read once for all the block's heads.  When the
//   grid would be small (decode: B * Hkv = 32 blocks at tinyllama) the
//   key range is split over blocks (flash-decoding): each split writes
//   its partial (m, l, acc) to scratch the wrapper allocates, and
//   flash_combine merges the splits in a fixed order in the same call.
//   A split or row that sees no valid key has m = -1e30, l = 0, acc = 0
//   and merges to exactly 0.  Inside a block, lane c scores key c of a
//   32-key tile (attn_common.cuh:row_tile_update's scheme), with the head
//   dim fixed at compile time for 64 and 128 (float4 dots).
// The plan (lane, splits, keys per split) is chosen in Python
// (kernels/flash_attention.py:plan), a pure function of the shapes.
#include "attn_common.cuh"

#include <math_constants.h>

namespace {

using bf16 = __nv_bfloat16;
using attn::kNeg;

// ---------------------------------------------------------------- bf16 --
constexpr int kBQ = 64;          // query rows a block (4 warps x 16)
constexpr int kBK = 64;          // keys a tile
constexpr int kMmaThreads = 128;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zeros instead where !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                  int Hkv, int Sq, int Skv, float scale, int causal,
                  int window, float softcap, int kv_offset) {
  constexpr int LD = D + 8;                  // padded row: no bank conflicts
  constexpr int CH = D / 8;                  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // (kBQ, LD)
  bf16* kvs = qs + kBQ * LD;                 // [buffer][K, V](kBK, LD)

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int r0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qb = q + ((size_t)b * Hq + h) * Sq * D;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Skv * D;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Skv * D;
  bf16* ob = o + ((size_t)b * Hq + h) * Sq * D;

  // KV extent any row of this block can see
  const int last_row = min(r0 + kBQ, Sq) - 1;
  const int kv_hi = causal ? max(0, min(Skv, last_row + kv_offset + 1)) : Skv;
  const int kv_lo =
      window ? max(0, r0 + kv_offset - window + 1) / kBK * kBK : 0;
  const int ntile = kv_hi > kv_lo ? (kv_hi - kv_lo + kBK - 1) / kBK : 0;

  for (int idx = threadIdx.x; idx < kBQ * CH; idx += kMmaThreads) {
    const int r = idx / CH, c = (idx % CH) * 8, row = r0 + r;
    cp_async16(qs + r * LD + c, qb + (size_t)(row < Sq ? row : 0) * D + c,
               row < Sq);
  }
  const auto load_kv = [&](int buf, int t0) {
    bf16* ks = kvs + buf * 2 * kBK * LD;
    bf16* vs = ks + kBK * LD;
    for (int idx = threadIdx.x; idx < kBK * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = (idx % CH) * 8, col = t0 + r;
      const size_t off = (size_t)(col < Skv ? col : 0) * D + c;
      cp_async16(ks + r * LD + c, kb + off, col < Skv);
      cp_async16(vs + r * LD + c, vb + off, col < Skv);
    }
  };
  if (ntile > 0) load_kv(0, kv_lo);
  asm volatile("cp.async.commit_group;");

  float oacc[D / 8][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  uint32_t qf[D / 16][4];
  const int wr0 = r0 + warp * 16;
  const int rows[2] = {wr0 + g, wr0 + g + 8};

  for (int it = 0; it < ntile; ++it) {
    const int t0 = kv_lo + it * kBK;
    if (it + 1 < ntile) {
      load_kv((it + 1) & 1, t0 + kBK);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::
                       : "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
    }
    const int wlast = min(wr0 + 15, Sq - 1);
    const bool skip = wr0 >= Sq || (causal && t0 > wlast + kv_offset) ||
                      (window && t0 + kBK - 1 <= wr0 + kv_offset - window);
    if (!skip) {
      const bf16* ks = kvs + (it & 1) * 2 * kBK * LD;
      const bf16* vs = ks + kBK * LD;
      float s[kBK / 8][4];
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kk], bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qf[kk], bf[2], bf[3]);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + i * 8 + 2 * t + (e & 1);
          const int pos = rows[e >> 1] + kv_offset;
          float x = s[i][e] * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          const bool valid = col < Skv && (!causal || col <= pos) &&
                             (!window || col > pos - window);
          s[i][e] = valid ? x : -CUDART_INF_F;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[i][e]);
        }
      }
      float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < kBK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - m[e >> 1]);   // masked: exp(-inf) = 0
          ls[e >> 1] += s[i][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        oacc[i][0] *= alpha[0];
        oacc[i][1] *= alpha[0];
        oacc[i][2] *= alpha[1];
        oacc[i][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(oacc[2 * dp], pa, bf[0], bf[1]);
          mma_bf16(oacc[2 * dp + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                          // buffer consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= Sq) continue;
    // a row that never saw a valid key has oacc == 0: exactly 0 out
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rows[r] * D + i * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(oacc[i][2 * r] * inv,
                                oacc[i][2 * r + 1] * inv);
  }
}

// ------------------------------------------------------------- float32 --
constexpr int kF32Warps = 8;
constexpr int kF32MaxRows = 64;              // packed rows a block, at most
constexpr int kF32RowsPerWarp = kF32MaxRows / kF32Warps;

// attn::row_tile_update for a head dim fixed at compile time (DT = 64 or
// 128; 0 = D at run time): K rows of stride D + 4 read as float4, the dot
// in four partial sums, so it is not one chain of D dependent FMAs.
template <int DT>
__device__ __forceinline__ void row_tile_f32(
    const float* __restrict__ qrow, const float* __restrict__ ks,
    const float* __restrict__ vs, int D, bool valid, float softcap,
    float& m, float& l, float (&acc)[attn::kDPerLane]) {
  using namespace attn;
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
  for (int e = 0; e < kDPerLane; ++e) acc[e] *= alpha;
#pragma unroll 8
  for (int c = 0; c < kTile; ++c) {
    const float pc = __shfl_sync(0xffffffffu, p, c);
    const float* vrow = vs + c * Dn;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d < Dn) acc[e] = fmaf(pc, vrow[d], acc[e]);
    }
  }
}

// Grid (row tiles, B * Hkv, splits), `rows` packed rows a block.  Packed
// row pr = position * G + g (query head hk * G + g).  With one split the
// rows are written to o; with more, (m, l) and acc go to part for
// flash_combine.
template <int DT>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ part, int B, int Hq, int Hkv, int Sq,
                 int Skv, int D, float scale, int causal, int window,
                 float softcap, int kv_offset, int rows, int splits,
                 int chunk) {
  using namespace attn;
  extern __shared__ __align__(16) float smem[];
  const int Dn = DT ? DT : D;
  float* qs = smem;                          // (rows, Dn)
  float* ks = qs + rows * Dn;                // (kTile, Dn + 4)
  float* vs = ks + kTile * (Dn + 4);         // (kTile, Dn)

  const int G = Hq / Hkv, NR = G * Sq;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int pr0 = blockIdx.x * rows, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* kb = k + (size_t)bh * Skv * Dn;
  const float* vb = v + (size_t)bh * Skv * Dn;
  const auto q_off = [&](int pr) {           // row pr of q / o
    return (((size_t)b * Hq + hk * G + pr % G) * Sq + pr / G) * Dn;
  };

  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int pr = pr0 + idx / Dn;
    qs[idx] = pr < NR ? q[q_off(pr) + idx % Dn] * scale : 0.f;
  }
  // keys any row of the block can see, within this split
  const int s_first = pr0 / G, s_last = (min(pr0 + rows, NR) - 1) / G;
  int hi = causal ? max(0, min(Skv, s_last + kv_offset + 1)) : Skv;
  int lo = window ? max(0, s_first + kv_offset - window + 1) / kTile * kTile
                  : 0;
  lo = max(lo, split * chunk);
  hi = min(hi, (split + 1) * chunk);

  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[rr][e] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    __syncthreads();                         // previous tile consumed
    for (int idx = threadIdx.x; idx < kTile * Dn; idx += blockDim.x) {
      const int c = idx / Dn, d = idx % Dn, col = t0 + c;
      float kk = 0.f, vv = 0.f;              // zero-fill past Skv
      if (col < Skv) {
        kk = kb[(size_t)col * Dn + d];
        vv = vb[(size_t)col * Dn + d];
      }
      ks[c * (Dn + 4) + d] = kk;
      vs[c * Dn + d] = vv;
    }
    __syncthreads();
    const int col = t0 + lane;
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      const int r = rr * kF32Warps + warp;   // rows spread over the warps
      if (r >= rows || pr0 + r >= NR) continue;   // warp-uniform
      const int pos = (pr0 + r) / G + kv_offset;
      if (causal && t0 > pos) continue;      // tile wholly in the future
      if (window && t0 + kTile - 1 <= pos - window) continue;
      bool valid = col < hi;
      if (causal) valid = valid && col <= pos;
      if (window) valid = valid && col > pos - window;
      row_tile_f32<DT>(qs + r * Dn, ks, vs, Dn, valid, softcap, m[rr],
                       l[rr], acc[rr]);
    }
  }

#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    const int r = rr * kF32Warps + warp, pr = pr0 + r;
    if (r >= rows || pr >= NR) continue;
    if (splits == 1) {
      row_store(o + q_off(pr), Dn, l[rr], acc[rr]);
      continue;
    }
    const size_t slot = ((size_t)split * B * Hkv + bh) * NR + pr;
    if (lane == 0) {
      part[2 * slot] = m[rr];
      part[2 * slot + 1] = l[rr];
    }
    float* pa = part + (size_t)2 * splits * B * Hkv * NR + slot * Dn;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e)
      if (lane + 32 * e < Dn) pa[lane + 32 * e] = acc[rr][e];
  }
}

// One warp per packed row: merge the splits' (m, l, acc) in split order.
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ part, float* __restrict__ o, int B,
              int Hq, int Hkv, int Sq, int D, int splits) {
  using namespace attn;
  const int G = Hq / Hkv, NR = G * Sq;
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B * Hkv * NR) return;
  const int bh = w / NR, pr = w % NR;
  const int b = bh / Hkv, hk = bh % Hkv;
  const size_t stride = (size_t)B * Hkv * NR;
  float mx = kNeg;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part[2 * (s * stride + w)]);
  float l = 0.f, acc[kDPerLane] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const size_t slot = s * stride + w;
    const float c = expf(part[2 * slot] - mx);
    l += part[2 * slot + 1] * c;
    const float* pa = part + 2 * splits * stride + slot * D;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e)
      if (lane + 32 * e < D) acc[e] += pa[lane + 32 * e] * c;
  }
  row_store(o + (((size_t)b * Hq + hk * G + pr % G) * Sq + pr / G) * D, D, l,
            acc);
}

cudaError_t opt_in(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, float scale,
                        int causal, int window, float softcap, int kv_offset,
                        cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * kBQ * (D + 8);   // Q + 2 x (K, V)
  cudaError_t e = opt_in((const void*)flash_bf16_kernel<D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bf16_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Sq, Skv,
      scale, causal, window, softcap, kv_offset);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_f32_dt(const float* q, const float* k, const float* v,
                          float* o, float* part, int B, int Hq, int Hkv,
                          int Sq, int Skv, int D, float scale, int causal,
                          int window, float softcap, int kv_offset, int rows,
                          int splits, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)rows * D +
                                       (size_t)attn::kTile * (2 * D + 4));
  cudaError_t e = opt_in((const void*)flash_f32_kernel<DT>, smem);
  if (e != cudaSuccess) return e;
  const int NR = (Hq / Hkv) * Sq;
  dim3 grid((NR + rows - 1) / rows, B * Hkv, splits);
  flash_f32_kernel<DT><<<grid, kF32Warps * 32, smem, stream>>>(
      q, k, v, o, part, B, Hq, Hkv, Sq, Skv, D, scale, causal, window,
      softcap, kv_offset, rows, splits, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int n = B * Hkv * NR;
  flash_combine<<<(n + 7) / 8, 256, 0, stream>>>(part, o, B, Hq, Hkv, Sq, D,
                                                 splits);
  return cudaGetLastError();
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* o, float* part, int B, int Hq, int Hkv, int Sq,
                       int Skv, int D, float scale, int causal, int window,
                       float softcap, int kv_offset, int rows, int splits,
                       int chunk, cudaStream_t stream) {
  const int NR = (Hq / Hkv) * Sq;
  if (rows < 1 || rows > kF32MaxRows || splits < 1 ||
      (splits > 1 && (part == nullptr || chunk < attn::kTile ||
                      chunk % attn::kTile != 0 ||
                      (size_t)splits * chunk < (size_t)Skv || NR > rows)))
    return cudaErrorInvalidValue;
  if (splits == 1) chunk = Skv > 0 ? Skv : 1;
  if (D == 64)
    return launch_f32_dt<64>(q, k, v, o, part, B, Hq, Hkv, Sq, Skv, D, scale,
                             causal, window, softcap, kv_offset, rows, splits,
                             chunk, stream);
  if (D == 128)
    return launch_f32_dt<128>(q, k, v, o, part, B, Hq, Hkv, Sq, Skv, D,
                              scale, causal, window, softcap, kv_offset, rows,
                              splits, chunk, stream);
  return launch_f32_dt<0>(q, k, v, o, part, B, Hq, Hkv, Sq, Skv, D, scale,
                          causal, window, softcap, kv_offset, rows, splits,
                          chunk, stream);
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); o: (B, Hq, Sq, D), all of one
// dtype (0 = float32, 1 = bfloat16), contiguous.  bfloat16 takes D = 64 or
// 128 (the tensor-core tiles) and one split; it ignores `rows`.  float32
// takes D <= 128, `rows` (<= 64) packed rows a block and `splits` key
// ranges of `chunk` keys (a multiple of 32); with splits > 1 (only where
// G * Sq <= rows) part is float32 scratch of
// splits * B * Hkv * G * Sq * (D + 2).  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* part, int B, int Hq, int Hkv,
                               int Sq, int Skv, int D, float scale,
                               int causal, int window, float softcap,
                               int kv_offset, int dtype, int rows,
                               int splits, int chunk, void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > attn::kMaxD || Skv < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(part), B, Hq, Hkv, Sq, Skv, D, scale, causal,
        window, softcap, kv_offset, rows, splits, chunk, s);
  if (dtype != 1 || splits != 1) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)launch_bf16<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale,
                                causal, window, softcap, kv_offset, s);
  if (D == 128)
    return (int)launch_bf16<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, scale,
                                 causal, window, softcap, kv_offset, s);
  return (int)cudaErrorInvalidValue;
}
