// Block-circulant linear in one pass: input DFT -> Gauss 3-product spectral
// MAC against the offline-FFT'd weight planes -> inverse DFT.
//
//   xb (B, q, k) --C--> X = (Xr, Xi) (B, q, 2kf)          (DFT, tensor cores)
//   t1 = sum_j (Xr+Xi) wr,  t2 = sum_j Xr ws1,  t3 = sum_j Xi ws2
//   Yr = s_wr t1 - s_ws2 t3,  Yi = s_wr t1 + s_ws1 t2   (MAC, CUDA cores)
//   y (B, p, k) = (w Yr, w Yi) C^T                        (iDFT, tensor cores)
//
// Three lanes, one exported function each: float32 planes (bc_fused, the
// scales are 1), int8 planes (bc_fused_i8) and packed-int4 planes
// (bc_fused_i4: two's-complement nibbles, low nibble first, kf padded to
// an even count, so a row of a plane is (kf + 1) / 2 bytes).  The quantized
// lanes take one float32 scale per output block row and plane (the
// per-block-row absmax scales of repro/quant/codec.py:quantize_plane).
//
// Replaces: src/repro/kernels/bc_fused.py:bc_fused_matmul (Pallas body
// _kernel) for the float32 lane.  The quantized lanes have no Pallas
// counterpart: repro runs a quantized cache through the scale-folding
// einsum of core/circulant.py:bc_matmul_spectral, their plain reference.
//
// What bounds it on an H100.  At decode (8 rows) neither bytes nor
// operations: the largest projection moves ~1 MB and does ~20 MFLOP, well
// under a microsecond either way, so latency is the limit: the launch,
// the staging of the 70 KB DFT panel, the serial chains inside a block
// and the number of SMs that share the work.  At prefill (hundreds of
// rows) the two DFTs are most of the operations (4 B q k kf + 4 B p kf k
// against 6 B p q kf for the MAC), and one block an SM (the shared memory
// a tile needs) leaves few warps to hide each phase's latency.
//
// Design.  As on the TPU, the spectra never leave the chip.
// - One DFT panel.  The irfft matrices are the rfft ones transposed and
//   scaled per bin by w_f = 1/k or 2/k (exact powers of two), so one panel
//   C (k, NC) = Cr and Ci interleaved per bin (columns 2f, 2f + 1), zero
//   past 2kf, NC = 2kf rounded up to 8, staged once per block with
//   cp.async, serves both products: the MAC writes w_f Y, and the iDFT
//   multiplies it by C^T.  Interleaving gives the MAC one 8-byte load per
//   (row, bin) for Xr, Xi and one 8-byte update for Yr, Yi.
// - A cluster of cs <= 8 blocks shares one tile of R rows.  Each block
//   computes the DFT of its share of the tile's input blocks once, and
//   the MAC reads every peer's spectra: the DFT is never recomputed per
//   output tile.  Two modes:
//   * p-split (p >= 4): block r owns output blocks [r pt, (r+1) pt).  The
//     DFT rows of a chunk of qc input blocks are split over the cluster;
//     each block copies its rows' spectra into every peer's shared memory
//     (distributed shared memory, 16-byte stores), cluster.sync(), and
//     each block runs its MAC over the chunk from its own copy.  Where a
//     tile's whole spectrum does not fit beside the rest (many rows, or
//     qwen2.5's down with q = 86), the input blocks stream through in
//     chunks, the MAC's K loop, with w Yr, w Yi summed in shared memory.
//   * q-split (p < 4, the k/v projections' p = 2): block r owns input
//     blocks [r qs, (r+1) qs), computes their DFT and a partial MAC for
//     every output block; after cluster.sync() every block sums the
//     partials of ranks 0..cs-1 in that order (no atomics: the result does
//     not change from run to run) and runs the iDFT for its share of the
//     output columns.
// - Tile products.  From 17 rows up the DFT and the iDFT run on mma.sync
//   m16n8k8 in TF32 with the 3xTF32 split (hi = tf32(a), lo = tf32(a -
//   hi); hi*hi, hi*lo and lo*hi in three float32 sums), which keeps
//   float32 accuracy: one TF32 product keeps ~3 digits and would miss the
//   1e-4 tolerance.  Warps take (16-row tile, 4 column tiles) units, or 1
//   column tile where that leaves warps idle.  Up to 16 rows (decode: a
//   row's share of input blocks, or its few output blocks) a 16-row mma
//   tile would be mostly padding and its serial k loop the latency, so
//   those products run on the CUDA cores in float32, the iDFT then from
//   the transposed panel, loaded over the panel once the DFT is done.
// - The Gauss MAC stays on the CUDA cores: a thread owns (output block,
//   bin, group of up to 8 rows) and keeps each plane value in a register
//   across the group's rows; it loads the planes of 8 input blocks before
//   their FMAs (one L2 latency per 8), and at one row a tile it splits the
//   input blocks over spare threads, whose partial sums are added in a
//   fixed order.  A quantized value is widened in a register and each of
//   t1, t2, t3 is scaled once by its plane's row scale, as repro's _fold
//   does.
// - The launch plan (rows per tile R, cluster size, mode, share, q chunk)
//   is chosen in Python (kernels/bc_fused.py:plan) as a pure function of
//   the shapes: R is as small as fills whole waves of the 15 clusters of 8
//   that an H100 runs at once; launch() checks the plan and returns
//   cudaErrorInvalidValue for one it cannot run.
// Not done here: wgmma (M is 16-86 rows a tile, where mma.sync fits), TMA,
// double-buffered chunks, planes staged in shared memory (tried for
// decode: the copies cost more than the L2 waits they saved).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;      // rows per tile
constexpr int kRowGroup = 8;      // rows per MAC thread
constexpr int kJBatch = 8;        // input blocks whose planes load together
constexpr int kScratchRounds = 2; // decode MAC: work items per thread
constexpr int kMaxCluster = 8;    // portable cluster size
constexpr int kNTG = 4;           // 8-wide column tiles per warp unit
constexpr int kSmallRows = 16;    // products of up to 16 rows: CUDA cores
constexpr int kMaxSmem = 232448;  // bytes a block can use on an H100

enum Planes { kF32 = 0, kI8 = 1, kI4 = 2 };
enum Mode { kPSplit = 0, kQSplit = 1 };

// Plane value (row, f) as float32, where row = output block * q + input
// block.  kb is the row length in elements (f32, int8) or bytes (int4).
template <int P>
__device__ __forceinline__ float plane_at(const void* __restrict__ w,
                                          size_t row, int f, int kb) {
  if (P == kF32) return static_cast<const float*>(w)[row * kb + f];
  if (P == kI8)
    return static_cast<float>(static_cast<const int8_t*>(w)[row * kb + f]);
  const uint8_t byte = static_cast<const uint8_t*>(w)[row * kb + (f >> 1)];
  const int nib = (f & 1) ? (byte >> 4) : (byte & 0xF);
  return static_cast<float>((nib ^ 8) - 8);   // sign-extend the nibble
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo with hi, lo both TF32 (lo carries the 13 bits hi drops)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// C (mrows x 8*ncols) = A (mrows x K) B (K x 8*ncols) in 3xTF32, over the
// column tiles [nt0, nt1).  A is row-major in shared memory (lda), B is
// read through b(kk, n).  The block's warps share (16-row tile, NTG
// column tiles) units.  store(row, col, v0, v1) takes columns col, col+1.
template <int NTG, typename BAt, typename Store>
__device__ __forceinline__ void tile_units(const float* __restrict__ A,
                                             int lda, int mrows, int K,
                                             int nt0, int nt1, BAt b,
                                             Store store) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nmt = (mrows + 15) / 16;
  const int ngr = (nt1 - nt0 + NTG - 1) / NTG;
  for (int u = warp; u < nmt * ngr; u += kWarps) {
    const int mt = u / ngr, c0 = nt0 + (u % ngr) * NTG;
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    // hi*hi, lo*hi and hi*lo in three sums: no product waits on another
    float acc[NTG][4], sa[NTG][4], sb[NTG][4];
#pragma unroll
    for (int j = 0; j < NTG; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = sa[j][e] = sb[j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float a[4] = {
          r0 < mrows ? A[r0 * lda + k0 + t] : 0.f,
          r1 < mrows ? A[r1 * lda + k0 + t] : 0.f,
          r0 < mrows ? A[r0 * lda + k0 + t + 4] : 0.f,
          r1 < mrows ? A[r1 * lda + k0 + t + 4] : 0.f};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[e], alo[e]);
#pragma unroll
      for (int j = 0; j < NTG; ++j) {
        if (c0 + j >= nt1) break;                  // warp-uniform
        const int n = (c0 + j) * 8 + g;
        uint32_t b0h, b0l, b1h, b1l;
        split_tf32(b(k0 + t, n), b0h, b0l);
        split_tf32(b(k0 + t + 4, n), b1h, b1l);
        mma_tf32(sa[j], alo, b0h, b1h);
        mma_tf32(sb[j], ahi, b0l, b1l);
        mma_tf32(acc[j], ahi, b0h, b1h);
      }
    }
#pragma unroll
    for (int j = 0; j < NTG; ++j) {
      if (c0 + j >= nt1) break;
      const int col = (c0 + j) * 8 + 2 * t;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[j][e] + (sa[j][e] + sb[j][e]);
      if (r0 < mrows) store(r0, col, v[0], v[1]);
      if (r1 < mrows) store(r1, col, v[2], v[3]);
    }
  }
}

// The same product on the CUDA cores in float32, for a few rows (decode):
// a thread owns two neighbouring columns of one row, over four partial
// sums a column.  Below a 16-row tile the mma's rows would be mostly
// padding and its serial k loop is the latency.
template <typename BAt, typename Store>
__device__ __forceinline__ void small_product(const float* __restrict__ A,
                                              int lda, int mrows, int K,
                                              int nt0, int nt1, BAt b,
                                              Store store) {
  const int npair = (nt1 - nt0) * 4;
  for (int idx = threadIdx.x; idx < mrows * npair; idx += kThreads) {
    const int m = idx / npair, col = nt0 * 8 + 2 * (idx % npair);
    const float* arow = A + m * lda;
    float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float av = arow[k0 + e];
        s0[e] = fmaf(av, b(k0 + e, col), s0[e]);
        s1[e] = fmaf(av, b(k0 + e, col + 1), s1[e]);
      }
    }
    store(m, col, (s0[0] + s0[1]) + (s0[2] + s0[3]),
          (s1[0] + s1[1]) + (s1[2] + s1[3]));
  }
}

// small_product (reading B through b_small) for up to kSmallRows rows
// where small_ok, else tile_units with 4 column tiles a unit where there
// are enough units for the 8 warps, else 1
template <typename BAt, typename BSm, typename Store>
__device__ __forceinline__ void tile_product(const float* __restrict__ A,
                                             int lda, int mrows, int K,
                                             int nt0, int nt1, BAt b,
                                             bool small_ok, BSm b_small,
                                             Store store) {
  const int nmt = (mrows + 15) / 16;
  if (small_ok && mrows <= kSmallRows)
    small_product(A, lda, mrows, K, nt0, nt1, b_small, store);
  else if (nmt * ((nt1 - nt0 + kNTG - 1) / kNTG) >= kWarps)
    tile_units<kNTG>(A, lda, mrows, K, nt0, nt1, b, store);
  else
    tile_units<1>(A, lda, mrows, K, nt0, nt1, b, store);
}

struct Args {
  const float* x;                       // (B, q, k)
  const void *wr, *ws1, *ws2;           // (p, q, kb)
  const float *s_wr, *s_ws1, *s_ws2;    // (p,) row scales, or null
  const float* cpan;                    // (k, NC): Cr, Ci interleaved
  const float* cpan_t;                  // (NC, k): its transpose
  float* y;                             // (B, p, k)
  int B, p, q, k;
  int R, cs, mode, share, qc;           // the launch plan
};

__host__ __device__ inline int ncols(int k) { return ((k + 2) + 7) / 8 * 8; }

// Shared-memory regions of a block, in floats (each a multiple of 4, so
// every region starts 16-byte aligned).  Mirrored by kernels/bc_fused.py.
struct Layout {
  int cs, xin, xall, ys, yred, scratch, total;
};

// An iDFT of up to kSmallRows rows (R times the output blocks a block
// owns) in a one-pass plan runs on the CUDA cores from the transposed
// panel, loaded over the panel once the DFT is done.
__host__ __device__ inline bool small_idft(const Args& a) {
  return a.R * (a.mode == kPSplit ? a.share : a.p) <= kSmallRows &&
         (a.mode == kQSplit || a.qc == a.q);
}

__host__ __device__ inline Layout layout(const Args& a) {
  const int NC = ncols(a.k);
  const bool ps = a.mode == kPSplit;
  const int dft_rows = ps ? (a.R * a.qc + a.cs - 1) / a.cs : a.R * a.share;
  Layout L;
  L.cs = 0;
  L.xin = L.cs + a.k * NC;
  L.xall = L.xin + dft_rows * (a.k + 4);
  L.ys = L.xall + (ps ? a.R * a.qc : a.R * a.share) * NC;
  L.yred = L.ys + a.R * (ps ? a.share : a.p) * (NC + 4);
  L.scratch = L.yred + (ps ? 0 : a.R * a.p * (NC + 4));
  L.total = L.scratch + 3 * kScratchRounds * kThreads;
  return L;
}

// Stage DFT rows m in [m0, m0 + ms) of a set of input blocks starting at
// jbase (row m is input row row0 + m % R, block jbase + m / R) into Xin;
// rows past the batch are zero.
__device__ __forceinline__ void stage_x(const Args& a, float* Xin, int row0,
                                        int nrow, int jbase, int m0, int ms) {
  const int k4 = a.k / 4, ldx = a.k + 4;
  for (int idx = threadIdx.x; idx < ms * k4; idx += kThreads) {
    const int m = idx / k4, c = (idx % k4) * 4;
    const int b = (m0 + m) % a.R, jl = (m0 + m) / a.R;
    float* dst = Xin + m * ldx + c;
    if (b < nrow)
      cp_async16(dst, a.x + ((size_t)(row0 + b) * a.q + jbase + jl) * a.k + c);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// t1, t2, t3 of rows [b0, b0 + nb) at (output block i, bin f) over input
// blocks [jlo, jhi) (spectra in Xall, row (j - jbase) * R + b).  The plane
// values of kJBatch input blocks load before their FMAs: one L2 latency
// per batch, not per input block.
template <int P>
__device__ __forceinline__ void mac_sums(const Args& a, const float* Xall,
                                         int i, int jbase, int jlo, int jhi,
                                         int f, int b0, int nb,
                                         float (&t1)[kRowGroup],
                                         float (&t2)[kRowGroup],
                                         float (&t3)[kRowGroup]) {
  const int kf = a.k / 2 + 1, NC = ncols(a.k);
  const int kb = P == kI4 ? (kf + 1) / 2 : kf;
#pragma unroll
  for (int b = 0; b < kRowGroup; ++b) t1[b] = t2[b] = t3[b] = 0.f;
  for (int jb = jlo; jb < jhi; jb += kJBatch) {
    float w1[kJBatch], w2[kJBatch], w3[kJBatch];
#pragma unroll
    for (int u = 0; u < kJBatch; ++u) {
      const size_t wrow = (size_t)i * a.q + min(jb + u, jhi - 1);
      w1[u] = plane_at<P>(a.wr, wrow, f, kb);
      w2[u] = plane_at<P>(a.ws1, wrow, f, kb);
      w3[u] = plane_at<P>(a.ws2, wrow, f, kb);
    }
#pragma unroll
    for (int u = 0; u < kJBatch; ++u) {
      if (jb + u >= jhi) break;
      const float* xv = Xall + ((jb + u - jbase) * a.R + b0) * NC + 2 * f;
#pragma unroll
      for (int b = 0; b < kRowGroup; ++b) {
        if (b < nb) {
          const float2 x = *reinterpret_cast<const float2*>(xv + b * NC);
          t1[b] = fmaf(x.x + x.y, w1[u], t1[b]);
          t2[b] = fmaf(x.x, w2[u], t2[b]);
          t3[b] = fmaf(x.y, w3[u], t3[b]);
        }
      }
    }
  }
}

// Scale t1, t2, t3 by their planes' row scales (quantized lanes), combine
// them (Yr = t1 - t3, Yi = t1 + t2), weight by the irfft weight of bin f
// (1/k at DC and Nyquist, 2/k between) and add to Ys row b * P_ + il.
template <int P>
__device__ __forceinline__ void mac_store(const Args& a, float* Ys, int P_,
                                          int i, int il, int f, int b0,
                                          int nb, const float (&t1)[kRowGroup],
                                          const float (&t2)[kRowGroup],
                                          const float (&t3)[kRowGroup]) {
  const int ldy = ncols(a.k) + 4;
  float g1 = 1.f, g2 = 1.f, g3 = 1.f;
  if (P != kF32) {
    g1 = a.s_wr[i];
    g2 = a.s_ws1[i];
    g3 = a.s_ws2[i];
  }
  const float wf = (f == 0 || 2 * f == a.k) ? 1.f / a.k : 2.f / a.k;
#pragma unroll
  for (int b = 0; b < kRowGroup; ++b) {
    if (b < nb) {
      const float u1 = t1[b] * g1, u2 = t2[b] * g2, u3 = t3[b] * g3;
      float2* y2 = reinterpret_cast<float2*>(
          Ys + ((b0 + b) * P_ + il) * ldy + 2 * f);
      const float2 prev = *y2;
      *y2 = make_float2(prev.x + wf * (u1 - u3), prev.y + wf * (u1 + u2));
    }
  }
}

// Gauss MAC of input blocks [jbase, jbase + nj) for output blocks
// [ibase, ibase + nout); adds w_f Yr, w_f Yi to Ys row b * P_ + il.  A
// thread owns (output block, bin, group of up to 8 rows).  At one row
// (decode) with threads to spare, the input blocks are split over jp
// threads instead (up to kScratchRounds rounds of the block), whose
// partial sums go through `scratch` and are added in jp order: no atomics.
template <int P>
__device__ __forceinline__ void mac(const Args& a, const float* Xall,
                                    float* Ys, float* scratch, int nrow,
                                    int jbase, int nj, int ibase, int nout,
                                    int P_) {
  const int kf = a.k / 2 + 1;
  const int ngrp = (nrow + kRowGroup - 1) / kRowGroup;
  const int items = nout * kf * ngrp;
  float t1[kRowGroup], t2[kRowGroup], t3[kRowGroup];
  const int jp_n = (nrow == 1 && items > 0 && items <= kThreads)
      ? min(kScratchRounds * kThreads / items, (nj + kJBatch - 1) / kJBatch)
      : 1;
  if (jp_n > 1) {                             // block-uniform
    for (int w = threadIdx.x; w < items * jp_n; w += kThreads) {
      const int it = w % items, jp = w / items;
      mac_sums<P>(a, Xall, ibase + it / kf, jbase, jbase + jp * nj / jp_n,
                  jbase + (jp + 1) * nj / jp_n, it % kf, 0, 1, t1, t2, t3);
      scratch[3 * w] = t1[0];
      scratch[3 * w + 1] = t2[0];
      scratch[3 * w + 2] = t3[0];
    }
    __syncthreads();
    const int it = threadIdx.x;
    if (it < items) {
      t1[0] = t2[0] = t3[0] = 0.f;
      for (int jp = 0; jp < jp_n; ++jp) {
        t1[0] += scratch[3 * (jp * items + it)];
        t2[0] += scratch[3 * (jp * items + it) + 1];
        t3[0] += scratch[3 * (jp * items + it) + 2];
      }
      mac_store<P>(a, Ys, P_, ibase + it / kf, it / kf, it % kf, 0, 1, t1,
                   t2, t3);
    }
    __syncthreads();                          // scratch free again
    return;
  }
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int f = it % kf;
    const int il = (it / kf) % nout;
    const int b0 = (it / (kf * nout)) * kRowGroup;
    const int nb = min(kRowGroup, nrow - b0);
    mac_sums<P>(a, Xall, ibase + il, jbase, jbase, jbase + nj, f, b0, nb, t1,
                t2, t3);
    mac_store<P>(a, Ys, P_, ibase + il, il, f, b0, nb, t1, t2, t3);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, 1) bc_fused_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = a.k, NC = ncols(k), ldx = k + 4, ldy = NC + 4;
  const int rank = static_cast<int>(cluster.block_rank());
  const int row0 = (blockIdx.x / a.cs) * a.R;
  const int nrow = min(a.R, a.B - row0);
  const Layout L = layout(a);
  float* Cs = smem + L.cs;
  float* Ct = Cs;                             // replaces the panel
  float* scratch = smem + L.scratch;
  const bool has_ct = small_idft(a);
  float* Xin = smem + L.xin;
  float* Xall = smem + L.xall;
  float* Ys = smem + L.ys;
  float* Yred = smem + L.yred;
  const auto panel = [&](int kk, int n) { return Cs[kk * NC + n]; };
  const auto panel_t = [&](int kk, int n) { return Cs[n * NC + kk]; };
  const auto ct = [&](int kk, int n) { return Ct[kk * k + n]; };

  for (int idx = threadIdx.x; idx < k * NC / 4; idx += kThreads)
    cp_async16(Cs + idx * 4, a.cpan + idx * 4);
  // after the (one) DFT: the transposed panel over the panel, in flight
  // during the MAC
  const auto load_ct = [&]() {
    if (!has_ct) return;
    for (int idx = threadIdx.x; idx < k * NC / 4; idx += kThreads)
      cp_async16(Ct + idx * 4, a.cpan_t + idx * 4);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  for (int idx = threadIdx.x; idx < L.scratch - L.ys; idx += kThreads)
    Ys[idx] = 0.f;                            // Ys (and Yred): pads stay 0

  if (a.mode == kPSplit) {
    const int i0 = rank * a.share;            // my output blocks
    const int npt = max(0, min(a.share, a.p - i0));
    cluster.sync();                           // every peer is running
    for (int c0 = 0; c0 < a.q; c0 += a.qc) {
      const int qcur = min(a.qc, a.q - c0);
      const int per = (a.R * qcur + a.cs - 1) / a.cs;
      const int m0 = rank * per;
      const int ms = max(0, min(per, a.R * qcur - m0));
      stage_x(a, Xin, row0, nrow, c0, m0, ms);
      cp_async_wait_all();                    // the panel and x
      __syncthreads();
      // this block's DFT rows, then copied into every peer's spectra
      tile_product(Xin, ldx, ms, k, 0, NC / 8, panel, true, panel,
                   [&](int m, int col, float v0, float v1) {
                     *reinterpret_cast<float2*>(Xall + (m0 + m) * NC + col) =
                         make_float2(v0, v1);
                   });
      __syncthreads();
      load_ct();
      const float4* mine = reinterpret_cast<const float4*>(Xall + m0 * NC);
      for (int s = 1; s < a.cs; ++s) {
        float4* dst = reinterpret_cast<float4*>(
            cluster.map_shared_rank(Xall, (rank + s) % a.cs) + m0 * NC);
        for (int idx = threadIdx.x; idx < ms * NC / 4; idx += kThreads)
          dst[idx] = mine[idx];
      }
      cluster.sync();                         // the chunk's spectra are in
      mac<P>(a, Xall, Ys, scratch, nrow, c0, qcur, i0, npt, a.share);
      if (c0 + a.qc < a.q) cluster.sync();    // peers done with Xall, Xin
    }
    cp_async_wait_all();
    __syncthreads();
    tile_product(Ys, ldy, nrow * a.share, NC, 0, k / 8, panel_t, has_ct, ct,
                 [&](int m, int col, float v0, float v1) {
                   const int b = m / a.share, il = m % a.share;
                   if (il < npt)
                     *reinterpret_cast<float2*>(
                         a.y + ((size_t)(row0 + b) * a.p + i0 + il) * k +
                         col) = make_float2(v0, v1);
                 });
    return;
  }

  // q-split: my input blocks, a partial MAC over them for every output
  // block, then the partials summed over the cluster in rank order
  const int j0 = rank * a.share;
  const int nj = max(0, min(a.share, a.q - j0));
  stage_x(a, Xin, row0, nrow, j0, 0, a.R * nj);
  cp_async_wait_all();                        // the panel and x
  __syncthreads();
  tile_product(Xin, ldx, a.R * nj, k, 0, NC / 8, panel, true, panel,
               [&](int m, int col, float v0, float v1) {
                 *reinterpret_cast<float2*>(Xall + m * NC + col) =
                     make_float2(v0, v1);
               });
  __syncthreads();                            // the panel is free
  load_ct();
  mac<P>(a, Xall, Ys, scratch, nrow, j0, nj, 0, a.p, a.p);
  cluster.sync();                             // every partial is done
  const int n4 = NC / 4;
  for (int idx = threadIdx.x; idx < nrow * a.p * n4; idx += kThreads) {
    const int off = (idx / n4) * ldy + (idx % n4) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < a.cs; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(Ys, s) + off);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(Yred + off) = acc;
  }
  cp_async_wait_all();
  cluster.sync();                             // peers done reading my Ys
  const int ntn = k / 8, per = (ntn + a.cs - 1) / a.cs;
  const int nt0 = min(ntn, rank * per), nt1 = min(ntn, nt0 + per);
  tile_product(Yred, ldy, nrow * a.p, NC, nt0, nt1, panel_t, has_ct, ct,
               [&](int m, int col, float v0, float v1) {
                 *reinterpret_cast<float2*>(
                     a.y + ((size_t)row0 * a.p + m) * k + col) =
                     make_float2(v0, v1);
               });
}

template <int P>
cudaError_t launch(Args a, cudaStream_t stream) {
  const bool ps = a.mode == kPSplit;
  if (a.B <= 0 || a.p <= 0 || a.q <= 0 || a.k < 8 || a.k % 8 != 0 ||
      a.R < 1 || a.R > kMaxRows || a.cs < 1 || a.cs > kMaxCluster ||
      (a.cs & (a.cs - 1)) != 0 || (a.mode != kPSplit && a.mode != kQSplit) ||
      a.share < 1 || (ps && a.share * a.cs < a.p) ||
      (!ps && a.share * a.cs < a.q) || (ps && (a.qc < 1 || a.qc > a.q)) ||
      (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.cpan) |
       reinterpret_cast<uintptr_t>(a.cpan_t)) % 16)
    return cudaErrorInvalidValue;
  if (!ps) a.qc = a.q;
  const size_t smem = sizeof(float) * (size_t)layout(a).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;            // per lane: one instantiation
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        bc_fused_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    opted = kMaxSmem;
  }
  const int tiles = (a.B + a.R - 1) / a.R;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, bc_fused_kernel<P>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

Args make_args(const void* xb, const void* wr, const void* ws1,
               const void* ws2, const void* s_wr, const void* s_ws1,
               const void* s_ws2, const void* cpan, const void* cpan_t,
               void* y, int B, int p, int q, int k, int R, int cs, int mode,
               int share, int qc) {
  return Args{static_cast<const float*>(xb), wr, ws1, ws2,
              static_cast<const float*>(s_wr),
              static_cast<const float*>(s_ws1),
              static_cast<const float*>(s_ws2),
              static_cast<const float*>(cpan),
              static_cast<const float*>(cpan_t), static_cast<float*>(y),
              B, p, q, k, R, cs, mode, share, qc};
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xb: (B, q, k); wr, ws1, ws2: (p, q, k/2 + 1); cpan: (k, NC), Cr and Ci
// interleaved per bin then zeros, NC = k + 2 rounded up to 8; cpan_t: its
// transpose (NC, k); y: (B, p, k).  All float32, contiguous,
// xb and cpan 16-byte aligned.  The plan: R rows per tile, a cluster of cs
// blocks (1, 2, 4 or 8), mode 0 (p-split: share output blocks a block, q
// chunks of qc input blocks) or 1 (q-split: share input blocks a block).
// Returns a cudaError_t (cudaErrorInvalidValue for a plan it cannot run).
extern "C" int bc_fused(const void* xb, const void* wr, const void* ws1,
                        const void* ws2, const void* cpan,
                        const void* cpan_t, void* y, int B, int p, int q,
                        int k, int R, int cs, int mode, int share, int qc,
                        void* stream) {
  return (int)launch<kF32>(
      make_args(xb, wr, ws1, ws2, nullptr, nullptr, nullptr, cpan, cpan_t, y,
                B, p, q, k, R, cs, mode, share, qc),
      static_cast<cudaStream_t>(stream));
}

// As bc_fused, with int8 planes (p, q, k/2 + 1) and their float32 row
// scales s_wr, s_ws1, s_ws2 (p,).
extern "C" int bc_fused_i8(const void* xb, const void* wr, const void* ws1,
                           const void* ws2, const void* s_wr,
                           const void* s_ws1, const void* s_ws2,
                           const void* cpan, const void* cpan_t, void* y,
                           int B, int p, int q, int k, int R, int cs,
                           int mode, int share, int qc, void* stream) {
  return (int)launch<kI8>(
      make_args(xb, wr, ws1, ws2, s_wr, s_ws1, s_ws2, cpan, cpan_t, y, B, p,
                q, k, R, cs, mode, share, qc),
      static_cast<cudaStream_t>(stream));
}

// As bc_fused_i8, with packed-int4 planes (p, q, (k/2 + 2) / 2) uint8.
extern "C" int bc_fused_i4(const void* xb, const void* wr, const void* ws1,
                           const void* ws2, const void* s_wr,
                           const void* s_ws1, const void* s_ws2,
                           const void* cpan, const void* cpan_t, void* y,
                           int B, int p, int q, int k, int R, int cs,
                           int mode, int share, int qc, void* stream) {
  return (int)launch<kI4>(
      make_args(xb, wr, ws1, ws2, s_wr, s_ws1, s_ws2, cpan, cpan_t, y, B, p,
                q, k, R, cs, mode, share, qc),
      static_cast<cudaStream_t>(stream));
}

// The most clusters of cs blocks, each with smem_bytes of dynamic shared
// memory, that the card runs at once (cudaOccupancyMaxActiveClusters), or
// minus a cudaError_t.  kernels/bc_fused.py:MAX_CLUSTERS holds the H100's.
extern "C" int bc_fused_max_active_clusters(int cs, int smem_bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      bc_fused_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, bc_fused_kernel<kF32>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
