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
// block).  The float32 prefill at phi-3-vision's oracle prompt (S = 600,
// 32 / 32 heads of 96) does 2.2 GFLOP, 33 us at the 67 TFLOP/s float32
// rate of the CUDA cores: operations, unless they go to the tensor cores.
// The float32 one-row decode is bytes: at serve_phi3's last step (4 rows,
// 775 keys, 32 KV heads of 96) 76 MB of K/V, 22.8 us.  At head dim 256
// (gemma2, recurrentgemma) the same three kernels run as compile-time
// instances; what bounds them is the same (operations for the prefills,
// bytes for the one-row decode), and what limits the tensor-core kernels
// there is registers (below).
//
// Design, three kernels:
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
//   loaded.  Tiles of 32, 64, 96, 128 and 256 are compile-time instances
//   (DP): DP / 16 k-steps of Q K^T and DP / 8 output tiles of P V, a row
//   of shared memory padded to DP + 8 values (80, 144, 208, 272 and 528
//   bytes: the 8 rows an ldmatrix reads land on 8 distinct groups of 4
//   banks), and 2 x 5 x 64 x (DP + 8) bytes of shared memory (Q plus two
//   K/V buffers; 168,960 at 256, one block an SM).  Any head dim D <= 256
//   runs in the smallest tile that holds it (the smoke configs' 32 in its
//   own; phi-2's 80 in 96): the row stride in device memory is D, the
//   staging writes zeros in columns D .. DP - 1 of Q, K and V (zero
//   columns add nothing to Q K^T; P V's extra columns are never stored),
//   and only D columns are stored.  Where D is a multiple of 8 and every
//   base is 16-byte aligned the staging copies 16-byte pieces with
//   cp.async and the store writes two values at once; else both go value
//   by value.  At DP <= 128 a warp keeps its Q fragments in registers for
//   the whole key loop.  At 256 they would be 64 registers beside the 128
//   of the output accumulators and the 32 of the score tile, over the 255
//   a thread may hold: so Q stays in shared memory and each k-step of
//   Q K^T loads its fragment there with one ldmatrix (16 a tile, against
//   the 64 that load K).
// - float32 prefill (flash_f32_mma_kernel, G * Sq >= 16 packed rows, D =
//   64, 96, 128, and any D above 128 in the 256 tile, padded as the bf16
//   lane pads, value by value where D is not a multiple of 4 or a base is
//   not 16-byte aligned): the bf16 lane's FlashAttention-2 layout with the
//   GQA packing of the rows kernel (packed row = position * G + head, so a
//   K/V tile serves the G heads of its KV head): 64 packed rows a block,
//   16 a warp, 32-key tiles double-buffered with cp.async (16-byte
//   copies).  Q K^T and P V run on mma.sync m16n8k8 in TF32 with the
//   3xTF32 split (mma_tf32.cuh, as bc_fused and spectral_matmul use it):
//   hi*hi + lo*hi + hi*lo keeps float32 accuracy where one TF32 product
//   keeps three digits.  The score tile's columns are ordered (key_of) so
//   that its accumulator fragment is P's A fragment as it stands.  Row
//   tiles are launched longest causal extent first.  Its Q fragments are
//   read from shared memory at every k-step at any D, so at D = 256 a
//   thread holds the 128 accumulators, the 16 scores and one k-step's
//   fragments; shared memory 4 x (64 x 260 + 2 x 32 x 524) = 200,704 bytes.
// - float32 rows kernel (flash_f32_kernel: the one-row decode, and head
//   dims up to 128 without a tensor-core instance), on the CUDA cores.
//   GQA packing up to 64 packed rows a block (fewer where that leaves SMs
//   idle), keys in 32-key stages double-buffered with cp.async (16-byte
//   copies at compile-time D = 64, 96, 128, 256; 4-byte at a run-time D:
//   any other D, or a float32 cache not 16-byte aligned).  Where a block
//   holds fewer rows than its 8 warps (G * Sq < 8: phi-3-vision's G = 1
//   decode) the warps of a row split every stage's keys among themselves
//   (kw = 8 / rows groups, nk = 32 / kw keys each, kw lanes a key's dot)
//   and merge their (m, l, acc) in warp order at the end, so no warp
//   idles.  Lane d accumulates dims d, d + 32, ...: 4 of them up to D =
//   128, 8 above (NPL; a run-time D above 128 takes the 8-dim instance).  When the grid would still be small
//   (decode: B * Hkv = 32 blocks at tinyllama) the key range is split
//   over blocks (flash-decoding): each split writes its partial (m, l,
//   acc) to scratch the wrapper allocates, and flash_combine merges the
//   splits in a fixed order in the same call.  A split, group or row that
//   sees no valid key has m = -1e30, l = 0, acc = 0 and merges to exactly
//   0.
// - A float8 (e4m3) K/V cache under a float32 query (the dense cache of
//   kv_cache_dtype = "float8_e4m3fn", which repro reads widened to float32):
//   the rows kernel takes K and V as e4m3 (a template argument KV), four
//   values a 4-byte load, widened to float32 as they are staged (exact: an
//   e4m3 value is a float32 value), then runs as for a float32 cache.  The
//   loads are plain loads, not cp.async: a tile's widening waits for them.
//   Only decode reads a cache (repro's prefill attends over its fresh K/V),
//   so the lane has no tensor-core instance: the plan sends any e4m3 shape
//   to the rows kernel.
// The plan (kernel, rows, splits, keys per split) is chosen in Python
// (kernels/flash_attention.py:plan), a pure function of the shapes.
#include "attn_common.cuh"
#include "mma_tf32.cuh"

#include <cuda_fp8.h>
#include <math_constants.h>

#include <initializer_list>
#include <type_traits>

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

using fp8 = __nv_fp8_e4m3;

// four e4m3 values at src (4-byte aligned) widened to float32 at dst (16-
// byte aligned shared memory); zeros instead where !valid
__device__ __forceinline__ void widen4(float* dst, const fp8* src,
                                       bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(src));
    fp8 e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i].__x = (w >> (8 * i)) & 0xFF;
    v = make_float4(static_cast<float>(e[0]), static_cast<float>(e[1]),
                    static_cast<float>(e[2]), static_cast<float>(e[3]));
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// a K/V piece of 4 values into float32 shared memory: a 16-byte cp.async
// of a float32 cache, or an e4m3 cache's 4 bytes widened
__device__ __forceinline__ void kv_load4(float* dst, const float* src,
                                         bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void kv_load4(float* dst, const fp8* src,
                                         bool valid) {
  widen4(dst, src, valid);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The tile is DP wide (a compile-time instance); the head dim D <= DP is
// the run-time row stride.  Columns D .. DP - 1 are staged as zeros.  With
// vec (D a multiple of 8, every base 16-byte aligned) a row is staged in
// 16-byte cp.async pieces and stored two values a store; else value by
// value.
template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int Hq,
                  int Hkv, int Sq, int Skv, int D, int vec, float scale,
                  int causal, int window, float softcap, int kv_offset) {
  constexpr int LD = DP + 8;                 // padded row: no bank conflicts
  constexpr int CH = DP / 8;                 // 16-byte chunks a row
  constexpr bool kQRegs = DP <= 128;         // Q fragments kept in registers
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

  const bf16 zero = __float2bfloat16(0.f);
  if (vec) {
    for (int idx = threadIdx.x; idx < kBQ * CH; idx += kMmaThreads) {
      const int r = idx / CH, c = (idx % CH) * 8, row = r0 + r;
      const bool ok = row < Sq && c < D;
      cp_async16(qs + r * LD + c, qb + (ok ? (size_t)row * D + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBQ * DP; idx += kMmaThreads) {
      const int r = idx / DP, c = idx % DP, row = r0 + r;
      qs[r * LD + c] = row < Sq && c < D ? qb[(size_t)row * D + c] : zero;
    }
  }
  const auto load_kv = [&](int buf, int t0) {
    bf16* ks = kvs + buf * 2 * kBK * LD;
    bf16* vs = ks + kBK * LD;
    if (vec) {
      for (int idx = threadIdx.x; idx < kBK * CH; idx += kMmaThreads) {
        const int r = idx / CH, c = (idx % CH) * 8, col = t0 + r;
        const bool ok = col < Skv && c < D;
        const size_t off = ok ? (size_t)col * D + c : 0;
        cp_async16(ks + r * LD + c, kb + off, ok);
        cp_async16(vs + r * LD + c, vb + off, ok);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < kBK * DP; idx += kMmaThreads) {
      const int r = idx / DP, c = idx % DP, col = t0 + r;
      const bool ok = col < Skv && c < D;
      const size_t off = (size_t)col * D + c;
      ks[r * LD + c] = ok ? kb[off] : zero;
      vs[r * LD + c] = ok ? vb[off] : zero;
    }
  };
  if (ntile > 0) load_kv(0, kv_lo);
  asm volatile("cp.async.commit_group;");

  float oacc[DP / 8][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  uint32_t qf[kQRegs ? DP / 16 : 1][4];
  const bf16* qw = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
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
    if constexpr (kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) ldsm_x4(qf[kk], qw + kk * 16);
      }
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
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
        } else {
          ldsm_x4(qa, qw + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < kBK / 16; ++np) {
          uint32_t bf[4];
          ldsm_x4(bf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qa, bf[0], bf[1]);
          mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
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
      for (int i = 0; i < DP / 8; ++i) {
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
        for (int dp = 0; dp < DP / 16; ++dp) {
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
    for (int i = 0; i < DP / 8; ++i) {
      const int d = i * 8 + 2 * t;            // the pad's columns: not stored
      bf16* out = ob + (size_t)rows[r] * D + d;
      const float lo = oacc[i][2 * r] * inv, hi = oacc[i][2 * r + 1] * inv;
      if (vec && d < D) {
        *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(lo, hi);
      } else {
        if (d < D) out[0] = __float2bfloat16(lo);
        if (d + 1 < D) out[1] = __float2bfloat16(hi);
      }
    }
  }
}

// ------------------------------------------------------------- float32 --
// 16 bytes (4 bytes) global -> shared; zeros instead where !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// Tensor-core prefill: one block of 4 warps per (64 packed rows, batch x
// KV head), each warp 16 rows; 32-key tiles.
constexpr int kFR = 64;                      // packed rows a block
constexpr int kFK = 32;                      // keys a tile
constexpr int kFThreads = 128;

// The key behind column n (0..7) of an 8-key score tile.  With this order
// the scores' accumulator fragment holds, in each thread, the keys t and
// t + 4 that the A fragment of P V takes from it: no shuffle between the
// two products.
__device__ __forceinline__ int key_of(int n) { return (n >> 1) + (n & 1) * 4; }

// Grid (row tiles, B * Hkv): packed row pr = position * G + g (query head
// hk * G + g), the row tiles taken from the last (the longest causal
// extent) to the first.  Q K^T and P V on mma.sync m16n8k8, each product
// hi*hi + lo*hi + hi*lo (3xTF32, mma_tf32.cuh); Q, K and V stay float32
// in shared memory, padded rows (D + 4 for Q and K, D + 8 for V) so every
// fragment load hits 32 distinct banks.
template <int DP>
__global__ void __launch_bounds__(kFThreads)
flash_f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Hq, int Hkv, int Sq, int Skv, int D, int vec,
                     float scale, int causal, int window, float softcap,
                     int kv_offset) {
  constexpr int LQ = DP + 4, LK = DP + 4, LV = DP + 8, CH = DP / 4;
  constexpr int TILE = kFK * (LK + LV);
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                           // (kFR, LQ)
  float* kvs = qs + kFR * LQ;                // [buffer][K (kFK, LK), V (kFK, LV)]

  const int G = Hq / Hkv, NR = G * Sq;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int pr0 = (gridDim.x - 1 - blockIdx.x) * kFR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + (size_t)bh * Skv * D;
  const float* vb = v + (size_t)bh * Skv * D;
  const auto q_off = [&](int pr) {           // row pr of q / o
    return (((size_t)b * Hq + hk * G + pr % G) * Sq + pr / G) * D;
  };

  // KV extent any row of this block can see
  const int last = min(pr0 + kFR, NR) - 1;
  const int kv_hi = causal ? max(0, min(Skv, last / G + kv_offset + 1)) : Skv;
  const int kv_lo =
      window ? max(0, pr0 / G + kv_offset - window + 1) / kFK * kFK : 0;
  const int ntile = kv_hi > kv_lo ? (kv_hi - kv_lo + kFK - 1) / kFK : 0;

  // vec: 16-byte pieces (CH a row); else one value a 4-byte copy.
  // Columns D .. DP - 1 are zeros.
  if (vec) {
    for (int idx = threadIdx.x; idx < kFR * CH; idx += kFThreads) {
      const int r = idx / CH, c = (idx % CH) * 4, pr = pr0 + r;
      const bool ok = pr < NR && c < D;
      cp_async16(qs + r * LQ + c, q + (ok ? q_off(pr) + c : 0), ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kFR * DP; idx += kFThreads) {
      const int r = idx / DP, c = idx % DP, pr = pr0 + r;
      const bool ok = pr < NR && c < D;
      cp_async4(qs + r * LQ + c, q + (ok ? q_off(pr) + c : 0), ok);
    }
  }
  const auto load_kv = [&](int buf, int t0) {
    float* ks = kvs + buf * TILE;
    float* vs = ks + kFK * LK;
    if (vec) {
      for (int idx = threadIdx.x; idx < kFK * CH; idx += kFThreads) {
        const int r = idx / CH, c = (idx % CH) * 4, col = t0 + r;
        const bool ok = col < kv_hi && c < D;
        const size_t off = ok ? (size_t)col * D + c : 0;
        cp_async16(ks + r * LK + c, kb + off, ok);
        cp_async16(vs + r * LV + c, vb + off, ok);
      }
      return;
    }
    for (int idx = threadIdx.x; idx < kFK * DP; idx += kFThreads) {
      const int r = idx / DP, c = idx % DP, col = t0 + r;
      const bool ok = col < kv_hi && c < D;
      const size_t off = ok ? (size_t)col * D + c : 0;
      cp_async4(ks + r * LK + c, kb + off, ok);
      cp_async4(vs + r * LV + c, vb + off, ok);
    }
  };
  if (ntile > 0) load_kv(0, kv_lo);
  asm volatile("cp.async.commit_group;");

  float oacc[DP / 8][4], m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[i][e] = 0.f;
  const int wr0 = pr0 + warp * 16;
  const int rows[2] = {wr0 + g, wr0 + g + 8};
  const int pos[2] = {rows[0] / G + kv_offset, rows[1] / G + kv_offset};
  const int wfirst = wr0 / G + kv_offset;
  const int wlast = min(wr0 + 15, NR - 1) / G + kv_offset;
  const float* qw = qs + warp * 16 * LQ;

  for (int it = 0; it < ntile; ++it) {
    const int t0 = kv_lo + it * kFK;
    if (it + 1 < ntile) {
      load_kv((it + 1) & 1, t0 + kFK);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::
                       : "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    // tiles wholly masked for this warp's rows are skipped
    const bool skip = wr0 >= NR || (causal && t0 > wlast) ||
                      (window && t0 + kFK - 1 <= wfirst - window);
    if (!skip) {
      const float* ks = kvs + (it & 1) * TILE;
      const float* vs = ks + kFK * LK;
      float s[kFK / 8][4];
#pragma unroll
      for (int i = 0; i < kFK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const float* qa = qw + g * LQ + kk * 8 + t;
        uint32_t ah[4], al[4];
        split_tf32_alu(qa[0], ah[0], al[0]);
        split_tf32_alu(qa[8 * LQ], ah[1], al[1]);
        split_tf32_alu(qa[4], ah[2], al[2]);
        split_tf32_alu(qa[8 * LQ + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < kFK / 8; ++nt) {
          const float* kr = ks + (nt * 8 + key_of(g)) * LK + kk * 8 + t;
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32_alu(kr[0], b0h, b0l);
          split_tf32_alu(kr[4], b1h, b1l);
          mma_tf32(s[nt], al, b0h, b1h);
          mma_tf32(s[nt], ah, b0l, b1l);
          mma_tf32(s[nt], ah, b0h, b1h);
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < kFK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + i * 8 + t + 4 * (e & 1);
          const int p = pos[e >> 1];
          float x = s[i][e] * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          const bool valid = col < Skv && (!causal || col <= p) &&
                             (!window || col > p - window);
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
      for (int i = 0; i < kFK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][e] = expf(s[i][e] - m[e >> 1]);   // masked: exp(-inf) = 0
          ls[e >> 1] += s[i][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        oacc[i][0] *= alpha[0];
        oacc[i][1] *= alpha[0];
        oacc[i][2] *= alpha[1];
        oacc[i][3] *= alpha[1];
      }
#pragma unroll
      for (int kc = 0; kc < kFK / 8; ++kc) {
        // A of P V: (g, key t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        uint32_t ph[4], pl[4];
        split_tf32_alu(s[kc][0], ph[0], pl[0]);
        split_tf32_alu(s[kc][2], ph[1], pl[1]);
        split_tf32_alu(s[kc][1], ph[2], pl[2]);
        split_tf32_alu(s[kc][3], ph[3], pl[3]);
        const float* vr = vs + (kc * 8 + t) * LV + g;
#pragma unroll
        for (int nt = 0; nt < DP / 8; ++nt) {
          uint32_t b0h, b0l, b1h, b1l;
          split_tf32_alu(vr[nt * 8], b0h, b0l);
          split_tf32_alu(vr[4 * LV + nt * 8], b1h, b1l);
          mma_tf32(oacc[nt], pl, b0h, b1h);
          mma_tf32(oacc[nt], ph, b0l, b1l);
          mma_tf32(oacc[nt], ph, b0h, b1h);
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
    if (rows[r] >= NR) continue;
    // a row that never saw a valid key has oacc == 0: exactly 0 out
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = o + q_off(rows[r]);
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int d = i * 8 + 2 * t;            // the pad's columns: not stored
      const float lo = oacc[i][2 * r] * inv, hi = oacc[i][2 * r + 1] * inv;
      if (vec && d < D) {
        *reinterpret_cast<float2*>(orow + d) = make_float2(lo, hi);
      } else {
        if (d < D) orow[d] = lo;
        if (d + 1 < D) orow[d + 1] = hi;
      }
    }
  }
}

// Rows kernel (decode, and head dims without a tensor-core instance).
constexpr int kF32Warps = 8;
constexpr int kF32MaxRows = 64;              // packed rows a block, at most
constexpr int kF32RowsPerWarp = kF32MaxRows / kF32Warps;
constexpr int kWideD = 256;                  // the widest head dim

// Output dims a lane accumulates: 4 up to attn::kMaxD, 8 up to kWideD.
__host__ __device__ constexpr int npl(int D) {
  return D > attn::kMaxD ? kWideD / 32 : attn::kDPerLane;
}

// Grid (row tiles, B * Hkv, splits), `rows` (a power of two) packed rows
// a block, the split's keys in 32-key stages double-buffered with
// cp.async.  rows >= 8: a warp owns rows / 8 rows and lane c scores key c
// of a stage.  rows < 8 (the one-row decode): kw = 8 / rows warps share a
// row, warp w taking row w % rows and the keys [j nk, (j + 1) nk) of
// every stage, j = w / rows, nk = 32 / kw (so every warp of the block
// works); kw lanes split a key's dot product (lane = key * kw + part),
// and the kw partial (m, l, acc) of a row merge in warp order at the end.
// With one split the rows are written to o; with more, (m, l) and acc go
// to part for flash_combine.
template <int DT, int NPL, typename KV>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_f32_kernel(const float* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ part, int B, int Hq, int Hkv, int Sq,
                 int Skv, int D, float scale, int causal, int window,
                 float softcap, int kv_offset, int rows, int splits,
                 int chunk) {
  using namespace attn;
  extern __shared__ __align__(16) float smem[];
  const int Dn = DT ? DT : D;
  const int kw = rows < kF32Warps ? kF32Warps / rows : 1;  // key groups
  const int rpw = rows > kF32Warps ? rows / kF32Warps : 1; // rows a warp
  const int nk = kTile / kw;                 // keys a warp scores a stage
  const int KS = Dn + 4 * kw;                // K row stride: the kw lanes
                                             // of a key's dot, conflict-free
  float* qs = smem;                          // (rows, Dn), scaled
  float* tiles = qs + rows * Dn;             // [2][K (kTile, KS), V (kTile, Dn)]
  const int tile_f = kTile * (KS + Dn);

  const int G = Hq / Hkv, NR = G * Sq;
  const int bh = blockIdx.y, b = bh / Hkv, hk = bh % Hkv;
  const int pr0 = blockIdx.x * rows, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = kw > 1 ? warp % rows : warp;   // first row of this warp
  const int grp = kw > 1 ? warp / rows : 0;     // its key group
  const int key = lane / kw, prt = lane % kw;   // its key and dot part
  const KV* kb = k + (size_t)bh * Skv * Dn;
  const KV* vb = v + (size_t)bh * Skv * Dn;
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
  const int ntile = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  const auto load = [&](int buf, int t0) {   // keys past hi: zeros
    float* ks = tiles + buf * tile_f;
    float* vs = ks + kTile * KS;
    if (DT) {
      constexpr int CH = DT / 4;
      for (int idx = threadIdx.x; idx < kTile * CH; idx += blockDim.x) {
        const int c = idx / CH, d = (idx % CH) * 4, col = t0 + c;
        const size_t off = (size_t)(col < hi ? col : 0) * DT + d;
        kv_load4(ks + c * KS + d, kb + off, col < hi);
        kv_load4(vs + c * DT + d, vb + off, col < hi);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTile * Dn; idx += blockDim.x) {
        const int c = idx / Dn, d = idx % Dn, col = t0 + c;
        const size_t off = (size_t)(col < hi ? col : 0) * Dn + d;
        if constexpr (sizeof(KV) == sizeof(float)) {
          cp_async4(ks + c * KS + d, kb + off, col < hi);
          cp_async4(vs + c * Dn + d, vb + off, col < hi);
        } else {                             // an e4m3 value, widened
          ks[c * KS + d] = col < hi ? static_cast<float>(kb[off]) : 0.f;
          vs[c * Dn + d] = col < hi ? static_cast<float>(vb[off]) : 0.f;
        }
      }
    }
  };
  if (ntile > 0) load(0, lo);
  asm volatile("cp.async.commit_group;");

  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][NPL];
#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    m[rr] = kNeg;
    l[rr] = 0.f;
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[rr][e] = 0.f;
  }

  for (int it = 0; it < ntile; ++it) {
    const int t0 = lo + it * kTile;
    if (it + 1 < ntile) {
      load((it + 1) & 1, t0 + kTile);
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 1;" ::
                       : "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();
    const float* ks = tiles + (it & 1) * tile_f;
    const float* vs = ks + kTile * KS;
    const int c = grp * nk + key;            // this lane's key in the stage
    const float* krow = ks + c * KS;
#pragma unroll
    for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
      if (rr >= rpw) break;
      const int r = r0 + rr * kF32Warps;
      if (pr0 + r >= NR) continue;           // warp-uniform
      const int pos = (pr0 + r) / G + kv_offset;
      if (causal && t0 > pos) continue;      // stage wholly in the future
      if (window && t0 + kTile - 1 <= pos - window) continue;
      const float* qrow = qs + r * Dn;
      float s = 0.f;
      if (DT) {
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = 4 * prt; d < DT; d += 4 * kw) {
          const float4 a = *reinterpret_cast<const float4*>(qrow + d);
          const float4 x = *reinterpret_cast<const float4*>(krow + d);
          s4[0] = fmaf(a.x, x.x, s4[0]);
          s4[1] = fmaf(a.y, x.y, s4[1]);
          s4[2] = fmaf(a.z, x.z, s4[2]);
          s4[3] = fmaf(a.w, x.w, s4[3]);
        }
        s = (s4[0] + s4[1]) + (s4[2] + s4[3]);
      } else {
        for (int d = prt; d < Dn; d += kw) s = fmaf(qrow[d], krow[d], s);
      }
      for (int off = 1; off < kw; off <<= 1)   // the key's kw parts
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (softcap != 0.f) s = softcap * tanhf(s / softcap);
      const int col = t0 + c;
      const bool valid = col < hi && (!causal || col <= pos) &&
                         (!window || col > pos - window);
      s = valid ? s : kNeg;
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);
      float ps = p;                          // over the warp's keys, once
      for (int off = 16; off >= kw; off >>= 1)   // each (warp_sum at kw = 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[rr] = l[rr] * alpha + ps;
      m[rr] = m_new;
#pragma unroll
      for (int e = 0; e < NPL; ++e) acc[rr][e] *= alpha;
      const float* vrow = vs + grp * nk * Dn;
      for (int j = 0; j < nk; ++j) {
        const float pc = __shfl_sync(0xffffffffu, p, j * kw);
#pragma unroll
        for (int e = 0; e < NPL; ++e) {
          const int d = lane + 32 * e;
          if (d < Dn) acc[rr][e] = fmaf(pc, vrow[j * Dn + d], acc[rr][e]);
        }
      }
    }
    __syncthreads();                         // buffer consumed
  }

  if (kw > 1) {
    // the key groups of a row merge in warp order (rows < 8: one row a
    // warp), through the free tile buffers
    float* slot = tiles + warp * (Dn + 2);
    if (lane == 0) {
      slot[0] = m[0];
      slot[1] = l[0];
    }
#pragma unroll
    for (int e = 0; e < NPL; ++e)
      if (lane + 32 * e < Dn) slot[2 + lane + 32 * e] = acc[0][e];
    __syncthreads();
    if (grp != 0) return;
    float mx = kNeg;
    for (int j = 0; j < kw; ++j)
      mx = fmaxf(mx, tiles[(j * rows + r0) * (Dn + 2)]);
    float ls = 0.f, a[NPL];
#pragma unroll
    for (int e = 0; e < NPL; ++e) a[e] = 0.f;
    for (int j = 0; j < kw; ++j) {
      const float* sl = tiles + (j * rows + r0) * (Dn + 2);
      const float cj = expf(sl[0] - mx);
      ls += sl[1] * cj;
#pragma unroll
      for (int e = 0; e < NPL; ++e)
        if (lane + 32 * e < Dn) a[e] += sl[2 + lane + 32 * e] * cj;
    }
    m[0] = mx;
    l[0] = ls;
#pragma unroll
    for (int e = 0; e < NPL; ++e) acc[0][e] = a[e];
  }

#pragma unroll
  for (int rr = 0; rr < kF32RowsPerWarp; ++rr) {
    if (rr >= rpw) break;
    const int r = r0 + rr * kF32Warps, pr = pr0 + r;
    if (pr >= NR) continue;
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
    for (int e = 0; e < NPL; ++e)
      if (lane + 32 * e < Dn) pa[lane + 32 * e] = acc[rr][e];
  }
}

// One warp per packed row: merge the splits' (m, l, acc) in split order
// (NPL dims a lane, as the rows kernel that wrote them).
template <int NPL>
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
  float l = 0.f, acc[NPL];
#pragma unroll
  for (int e = 0; e < NPL; ++e) acc[e] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t slot = s * stride + w;
    const float c = expf(part[2 * slot] - mx);
    l += part[2 * slot + 1] * c;
    const float* pa = part + 2 * splits * stride + slot * D;
#pragma unroll
    for (int e = 0; e < NPL; ++e)
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

// 16-byte aligned (every base pointer of a launch)
bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return bits % 16 == 0;
}

// The smallest compile-time tile that holds D (0 where none does).
int tile_for(int D, std::initializer_list<int> tiles) {
  for (int t : tiles)
    if (D <= t) return t;
  return 0;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Hq, int Hkv, int Sq, int Skv, int D,
                        float scale, int causal, int window, float softcap,
                        int kv_offset, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * 5 * kBQ * (DP + 8);  // Q + 2 x (K, V)
  cudaError_t e = opt_in((const void*)flash_bf16_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const int vec = D % 8 == 0 && aligned16({q, k, v, o});
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_bf16_kernel<DP><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Hq, Hkv, Sq, Skv,
      D, vec, scale, causal, window, softcap, kv_offset);
  return cudaGetLastError();
}

template <int DT, int NPL, typename KV>
cudaError_t launch_f32_rows(const float* q, const KV* k, const KV* v,
                            float* o, float* part, int B, int Hq, int Hkv,
                            int Sq, int Skv, int D, float scale, int causal,
                            int window, float softcap, int kv_offset,
                            int rows, int splits, int chunk,
                            cudaStream_t stream) {
  const int kw = rows < kF32Warps ? kF32Warps / rows : 1;
  const size_t smem =
      sizeof(float) * ((size_t)rows * D +
                       (size_t)2 * attn::kTile * (2 * D + 4 * kw));
  cudaError_t e = opt_in((const void*)flash_f32_kernel<DT, NPL, KV>, smem);
  if (e != cudaSuccess) return e;
  const int NR = (Hq / Hkv) * Sq;
  dim3 grid((NR + rows - 1) / rows, B * Hkv, splits);
  flash_f32_kernel<DT, NPL, KV><<<grid, kF32Warps * 32, smem, stream>>>(
      q, k, v, o, part, B, Hq, Hkv, Sq, Skv, D, scale, causal, window,
      softcap, kv_offset, rows, splits, chunk);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const int n = B * Hkv * NR;
  flash_combine<NPL><<<(n + 7) / 8, 256, 0, stream>>>(
      part, o, B, Hq, Hkv, Sq, D, splits);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32_mma(const float* q, const float* k, const float* v,
                           float* o, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, float scale, int causal, int window,
                           float softcap, int kv_offset, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kFR * (DP + 4) + (size_t)2 * kFK * (2 * DP + 12));
  cudaError_t e = opt_in((const void*)flash_f32_mma_kernel<DP>, smem);
  if (e != cudaSuccess) return e;
  const int vec = D % 4 == 0 && aligned16({q, k, v, o});
  const int NR = (Hq / Hkv) * Sq;
  dim3 grid((NR + kFR - 1) / kFR, B * Hkv);
  flash_f32_mma_kernel<DP><<<grid, kFThreads, smem, stream>>>(
      q, k, v, o, Hq, Hkv, Sq, Skv, D, vec, scale, causal, window, softcap,
      kv_offset);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_f32(const float* q, const KV* k, const KV* v,
                       float* o, float* part, int B, int Hq, int Hkv, int Sq,
                       int Skv, int D, float scale, int causal, int window,
                       float softcap, int kv_offset, int rows, int splits,
                       int chunk, int mma, cudaStream_t stream) {
  if (mma) {                                  // float32 K/V only
    if constexpr (!std::is_same_v<KV, float>) {
      return cudaErrorInvalidValue;
    } else {
      if (rows != kFR || splits != 1) return cudaErrorInvalidValue;
#define REPRO_F32_MMA(DP)                                                    \
  return launch_f32_mma<DP>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale,       \
                            causal, window, softcap, kv_offset, stream)
      switch (tile_for(D, {64, 96, 128, kWideD})) {
        case 64: REPRO_F32_MMA(64);
        case 96: REPRO_F32_MMA(96);
        case 128: REPRO_F32_MMA(128);
        case kWideD: REPRO_F32_MMA(kWideD);
        default: return cudaErrorInvalidValue;
      }
#undef REPRO_F32_MMA
    }
  }
  const int NR = (Hq / Hkv) * Sq;
  if (rows < 1 || rows > kF32MaxRows || (rows & (rows - 1)) != 0 ||
      splits < 1 ||
      (splits > 1 && (part == nullptr || chunk < attn::kTile ||
                      chunk % attn::kTile != 0 ||
                      (size_t)splits * chunk < (size_t)Skv || NR > rows)))
    return cudaErrorInvalidValue;
  if (splits == 1) chunk = Skv > 0 ? Skv : 1;
  // the compile-time head dims stage 16-byte pieces (a float32 cache: 16-
  // byte aligned); any other D, or a float32 cache not so aligned, the
  // run-time-D instance
  const bool pieces = sizeof(KV) == 1 || aligned16({k, v});
#define REPRO_F32_ROWS(DT, NPL)                                              \
  return launch_f32_rows<DT, NPL, KV>(q, k, v, o, part, B, Hq, Hkv, Sq, Skv, \
                                      D, scale, causal, window, softcap,     \
                                      kv_offset, rows, splits, chunk, stream)
  if (pieces && D == 64) REPRO_F32_ROWS(64, npl(64));
  if (pieces && D == 96) REPRO_F32_ROWS(96, npl(96));
  if (pieces && D == 128) REPRO_F32_ROWS(128, npl(128));
  if (pieces && D == kWideD) REPRO_F32_ROWS(kWideD, npl(kWideD));
  if (D <= attn::kMaxD) REPRO_F32_ROWS(0, npl(attn::kMaxD));
  REPRO_F32_ROWS(0, npl(kWideD));
#undef REPRO_F32_ROWS
}

}  // namespace

// q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); o: (B, Hq, Sq, D), contiguous;
// q and o of `dtype` (0 = float32, 1 = bfloat16), k and v of `kv_dtype`
// (the same code, or 2 = float8 e4m3 under a float32 q, D a multiple of 4
// and 4-byte aligned).  Any 1 <= D <= 256.  bfloat16 runs in the smallest
// tile of 32, 64, 96, 128, 256 that holds D, one split; it ignores `rows`.
// float32 with mma = 1 is the tensor-core prefill, in the smallest tile of
// 64, 96, 128, 256 that holds D, rows = 64, one split.  float32 with mma =
// 0 is the rows kernel: `rows` (a power of two <= 64) packed rows a block
// and `splits` key ranges of `chunk` keys (a multiple of 32); with splits >
// 1 (only where G * Sq <= rows) part is float32 scratch of
// splits * B * Hkv * G * Sq * (D + 2).  Returns a cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* part, int B, int Hq, int Hkv,
                               int Sq, int Skv, int D, float scale,
                               int causal, int window, float softcap,
                               int kv_offset, int dtype, int kv_dtype,
                               int rows, int splits, int chunk, int mma,
                               void* stream) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || D <= 0 ||
      D > kWideD || Skv < 0 ||
      !(kv_dtype == dtype || (dtype == 0 && kv_dtype == 2)) ||
      (kv_dtype == 2 && (D % 4 != 0 ||
                         (reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v)) % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && kv_dtype == 2)
    return (int)launch_f32(
        static_cast<const float*>(q), static_cast<const fp8*>(k),
        static_cast<const fp8*>(v), static_cast<float*>(o),
        static_cast<float*>(part), B, Hq, Hkv, Sq, Skv, D, scale, causal,
        window, softcap, kv_offset, rows, splits, chunk, mma, s);
  if (dtype == 0)
    return (int)launch_f32(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<float*>(part), B, Hq, Hkv, Sq, Skv, D, scale, causal,
        window, softcap, kv_offset, rows, splits, chunk, mma, s);
  if (dtype != 1 || splits != 1 || mma) return (int)cudaErrorInvalidValue;
#define REPRO_BF16(DP)                                                       \
  return (int)launch_bf16<DP>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, scale,     \
                              causal, window, softcap, kv_offset, s)
  switch (tile_for(D, {32, 64, 96, 128, kWideD})) {
    case 32: REPRO_BF16(32);
    case 64: REPRO_BF16(64);
    case 96: REPRO_BF16(96);
    case 128: REPRO_BF16(128);
    case kWideD: REPRO_BF16(kWideD);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_BF16
}
