// The weight gradient of a block-circulant projection: for output gradient
// gy (N, p, k) and blockified input xb (N, q, k), both float32,
//
//   gw[i, j, :] = irfft_k( sum_n Gf[n, i, :] * conj(Xf[n, j, :]) )   (p, q, k)
//
// with Gf, Xf the real DFTs of the rows (the paper's Eqn. 3: dL/dw_ij is
// the circular correlation g_i * x_j summed over the batch).
//
// Replaces: no Pallas kernel.  Its reference is the XLA half of
// src/repro/core/circulant.py:_bc_fft_bwd that computes gw (ur, ui, then
// irfft_planes), which repro leaves to XLA.  The port's backward of
// core/circulant.py:BCMatmulFFT calls it; the input gradient of the same
// backward is bc_fused on the adjoint planes.
//
// What bounds it on an H100: bytes.  At tinyllama's up/gate (N = 8,192,
// p = 44, q = 16, k = 128) the inputs are 252 MB, 75 us at 3.35 TB/s; the
// transforms at a real FFT's 2.5 k log2 k operations a row and the
// contraction (a Gauss complex product: 6 operations a pair, bin and row,
// as chip_smoke.py:check_bc_grad_w counts them) are ~3.4 GFLOP, 51 us at
// 67 TFLOP/s.  As dense products the DFTs would be 16 GFLOP; folded twice
// (below) they are 4, on the tensor cores.
//
// Packed spectra.  Bins 0 and k/2 of a real row are real, so they share
// slot 0 (Cr of bin 0 and Cr of bin k/2 as its two columns) and bin f in
// 1 .. k/2 - 1 takes slot f (Cr, Ci): k real columns a row.  P (k, k)
// holds them, rows in slot order (kernels/bc_grad_w.py:packed_panel_t);
// the inverse is P^T with each column weighted by 1/k (bins 0 and k/2) or
// 2/k.
//
// Folding.  With h = k/2, s_t = x_t + x_{k-t} and d_t = x_t - x_{k-t}
// (s_0 = x_0, s_h = x_h), the cosine parts are sums over s and the sine
// parts over d (cosine is even about t = h, sine odd).  About h/2 again:
// cos(2 pi (h - f) t / k) = (-1)^t cos(2 pi f t / k), and the sine the
// same up to a sign, so bins f and h - f share one product over the even
// positions (E) and one over the odd ones (O): Xr_f = E + O, Xr_{h-f} =
// E - O, Xi_f = E + O, Xi_{h-f} = O - E.  Four (k/4 x k/4) products take
// the place of one (k x k); F (kernels/bc_grad_w.py:dft_panel) holds the
// four sub-panels.  s_h joins the cosine E as (-1)^f s_h after the
// product, and bin h/2's cosine part, an alternating sum of the even s,
// is summed in the fold.
//
// Design: three kernels a call, every row transformed once.
// - dft_kernel: the packed spectra of the rows of gy and xb, written to a
//   scratch, spec[c][n / 64][b][n % 64] (packed column c, block b in 0 ..
//   p + q - 1, gy's then xb's, row n), so that a contraction stage is
//   (p + q) whole 256-byte rows a column.  Persistent blocks of 8 warps,
//   two an SM, walk tiles of 64 rows (kDftRows) of one block b:
//   each tile's raw rows arrive through a cp.async ring while the tile
//   before is worked; a row is folded in place by 1-16 threads (all read,
//   then all write); each warp then runs one (E, O) pair of m-tiles by 4
//   n-tiles on mma.sync m16n8k8 in 3xTF32 (mma_tf32.cuh; one TF32 product
//   alone keeps ~3 digits and would miss the 1e-4 tolerance), F staged in
//   shared memory once a block, and writes the butterflies' results as
//   8-byte pieces along n.
// - mac_kernel: one block per (slot, output tile, row split).  It streams
//   the slot's two spectra columns of the tile's p_rows output blocks and
//   q_rows input blocks through a cp.async ring of 64-row stages; each of
//   the 8 warps takes 8 of a stage's rows, so a (p x 8) by (8 x q) complex
//   product runs as four real ones on mma.sync in 3xTF32:
//     Ur += Gr Xr^T + Gi Xi^T,  Ui += Gi Xr^T + (-Gr) Xi^T
//   (slot 0: Ur += Gr Xr^T for bin 0, Ui += Gi Xi^T for bin k/2).  At the
//   end the warps' sums are added in warp order in shared memory and the
//   block writes (or, after the first chunk, adds to) its split's partial
//   (splits, k/2, p q, 2): no atomics, so two calls give the same bits.
// - idft_kernel: 4 (i, j) pairs a block; the splits' partials summed in
//   split order, weighted, and multiplied by P, staged in shared memory
//   64 KB at a time.
// Where the scratch would pass 256 MiB (fused up/gate at N = 8,192) the
// rows go through in chunks, the DFT and the contraction once a chunk,
// the partial sums carried over.
//
// An MoE expert stack (gy (E, C, p, k), xb (E, C, q, k) -> gw (E, p, q, k))
// is one call: each expert runs one expert's plan (the single call's at N
// = C), with the expert index on the grid of all three kernels (the DFT's
// tiles, the contraction's z beside the row splits, the iDFT's y), so
// every expert's result equals the single call on its rows bit for bit.
// The experts go through in groups of `group` whose spectra and partial
// sums each stay within the 256 MiB a single call's scratch may take
// (kernels/bc_grad_w.py:stack_group): per group, the chunks' DFT and
// contraction launches, then one iDFT.  Each expert's rows are padded to
// 128 on their own (experts are not packed into one tile), so at C = 80
// the padded rows are 48 of 128 and the DFT and contraction work on them
// is spent on zeros (their rows are not read: the DFT writes zeros).
//
// Why two passes and not one.  A single pass (a cluster of bin-tile blocks
// sharing a row tile through distributed shared memory, each contracting
// its bins) needs a row tile's raw rows, the tile's spectra of the
// cluster's bins and the panel in the cluster's blocks: at 16 rows of
// up/gate, 61 KB of raw rows and 61 KB of spectra a block, so one stage,
// one block an SM, a contraction 16 rows deep (two mma k-steps) and two
// cluster barriers every 16 rows.  The two passes keep each kernel a
// pipelined tensor-core product; their floor is the spectra's round trip
// through device memory, 3 x 252 MB at up/gate (~0.23 ms).  Smaller
// chunks that would keep the spectra in L2 ran slower on the H100
// (tools/grad_w_sweep.py --chunks; PERF.md).
// Any other block size (k < 8, or not a multiple of 8: the folds above
// need four groups of whole 8-position tiles) takes the same three passes
// with the spectra of a plain DFT: dft_any_kernel stages a tile of 64 rows
// and gives each of a block's threads one (row, packed column) dot product
// of k terms on the CUDA cores, against P read through L1 (at k = 4, P is
// 4 x 4).  An odd k has no Nyquist bin: its packed slot 0 holds bin 0 and a
// column of zeros, so it has S = (k + 1) / 2 slots and 2 S = k + 1
// columns, where an even k has S = k / 2 and k; the contraction and the
// iDFT run over S slots either way.
// Not done here: wgmma, TMA, sharing gy's DFT with the dX pass, the small-k
// spectra on the tensor cores.
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;     // every block; DFT and MAC: two an SM
constexpr int kWarps = kThreads / 32;
constexpr int kDftRows = 64;      // rows of N a DFT tile
constexpr int kDftNtg = 4;        // 8-row n-tiles a DFT warp unit
constexpr int kFoldPer = 9;       // a thread's positions of a fold
constexpr int kChunkRows = 128;   // a chunk's rows are padded to this
constexpr int kRows = 64;         // rows of N a MAC stage
constexpr int kLdm = kRows + 4;   // row stride of a staged MAC row
constexpr int kMaxUnits = 8;      // 16 x 8 output tiles a MAC warp holds
constexpr int kPairsBlock = 4;    // (i, j) pairs an iDFT block
constexpr int kIdftPanel = 16384; // floats of P an iDFT block stages
constexpr int kMaxGridY = 65535;  // the contraction's output tiles
constexpr int kMaxGridZ = 65535;  // its row splits times a group's experts
constexpr int kMaxSmem = 232448;
constexpr int kMaxK = 256;        // k / 2 + 1 <= 132 bins (MAX_BINS)

// packed slots of a block size: bins 0 and k/2 share slot 0 (an odd k's
// slot 0: bin 0 and zeros), then one slot a bin
__host__ __device__ inline int slots_of(int k) { return (k + 1) / 2; }
// the folded DFT of dft_kernel takes block sizes that are multiples of 8
__host__ __device__ inline bool folded(int k) { return k % 8 == 0; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most stages - 2 groups are in flight (stages is 2 to 4)
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
  if (stages >= 4)
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  else if (stages == 3)
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// d += a b in 3xTF32: lo*hi and hi*lo before hi*hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0h,
                                     uint32_t b1h, uint32_t b0l,
                                     uint32_t b1l) {
  mma_tf32(d, al, b0h, b1h);
  mma_tf32(d, ah, b0l, b1l);
  mma_tf32(d, ah, b0h, b1h);
}

// ---------------------------------------------------------------------------
// DFT: the packed spectra of a chunk's rows, spec[c][nb][b][64]
// ---------------------------------------------------------------------------
struct DftArgs {
  const float* gy;       // the chunk's first row: (nc, p, k) an expert
  const float* xb;       // (nc, q, k) an expert
  const float* panel;    // the folded sub-panels (4, M16, L)
  float* spec;           // (k, np / 64, p + q, 64) an expert
  int nc, np, p, q, k, stages, experts;
  size_t gy_stride, xb_stride, spec_stride;  // between experts
};

// spec's element (packed column c, block b, row n of the chunk)
__device__ __forceinline__ size_t spec_at(int c, int b, int n, int nb,
                                          int fam) {
  return (((size_t)c * nb + (n >> 6)) * fam + b) * 64 + (n & 63);
}

__global__ void __launch_bounds__(kThreads, 2) dft_kernel(DftArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, h = k / 2, hh = h / 2, fam = a.p + a.q;
  const int L = (hh + 7) / 8 * 8, M16 = (hh + 15) / 16 * 16;
  const int ld = max(k, 4 * L) + 4, ldp = L + 4, k4 = k / 4;
  const int nbk = a.np / 64;
  float* pan = smem;                         // (4, M16, ldp)
  float* raw = pan + 4 * M16 * ldp;          // stages x (kDftRows, ld)
  // a tile: (expert, block b, 64 rows), over the launch's experts
  const int rtiles = a.np / kDftRows, per_e = fam * rtiles;
  const int tiles = per_e * a.experts;
  const int mine = (int)blockIdx.x < tiles
                       ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < 4 * M16 * (L / 4); i += kThreads) {
    const int r = i / (L / 4), v = i % (L / 4);
    cp_async16(pan + r * ldp + 4 * v, a.panel + (size_t)r * L + 4 * v);
  }
  // a thread copies piece v of rows r0, r0 + rstep, ... (no division in
  // the loops)
  const int rstep = kThreads / k4, r0 = tid / k4, v = tid % k4;
  const bool copier = r0 < rstep;
  auto load = [&](int it) {
    const int tile = blockIdx.x + it * gridDim.x, ex = tile / per_e;
    const int b = tile % per_e / rtiles, n0 = (tile % rtiles) * kDftRows;
    const bool from_gy = b < a.p;
    const float* src =
        (from_gy ? a.gy + ex * a.gy_stride + (size_t)b * k
                 : a.xb + ex * a.xb_stride + (size_t)(b - a.p) * k) +
        4 * v;
    const size_t stride = (size_t)(from_gy ? a.p : a.q) * k;
    float* dst = raw + (it % a.stages) * kDftRows * ld + 4 * v;
    if (copier)
      for (int r = r0; r < kDftRows; r += rstep) {
        if (n0 + r < a.nc)
          cp_async16(dst + r * ld, src + (n0 + r) * stride);
        else
          *reinterpret_cast<float4*>(dst + r * ld) = zero;
      }
  };
  for (int s = 0; s < a.stages - 1; ++s) {
    if (s < mine) load(s);
    cp_async_commit();                       // the panel rides in group 0
  }
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int cos_pairs = M16 / 16, ngs = kDftRows / (8 * kDftNtg);
  int tpr = 1;                               // fold: threads a row
  while (tpr * kFoldPer < h + 1) tpr *= 2;
  const int per = (h + 1 + tpr - 1) / tpr, fq = tid % tpr, t0 = fq * per;
  const int units = 2 * cos_pairs * ngs;
  for (int it = 0; it < mine; ++it) {
    cp_async_wait_ring(a.stages);
    __syncthreads();                         // tile it is in; it - 1 is done
    if (it + a.stages - 1 < mine) load(it + a.stages - 1);
    cp_async_commit();
    float* const fold = raw + (it % a.stages) * kDftRows * ld;
    const int tile = blockIdx.x + it * gridDim.x, ex = tile / per_e;
    const int b = tile % per_e / rtiles, n0 = (tile % rtiles) * kDftRows;
    float* const spec = a.spec + ex * a.spec_stride;
    // fold each row in place (tpr threads a row, per positions each):
    // s_t = x_t + x_{k-t}, d_t = x_t - x_{k-t}, sorted into the groups
    // [s even | s odd | d even | d odd] of L positions (zeros past their
    // ends), s_h at 4L; bin h/2's cosine part, sum_j (-1)^j s_2j, goes
    // straight to spec (column h).  A row's threads are lanes of one warp:
    // they read everything before any of them writes.
    for (int r = tid / tpr; r < kDftRows; r += kThreads / tpr) {
      float* F = fold + r * ld;
      float sv[kFoldPer], dv[kFoldPer];
#pragma unroll
      for (int i = 0; i < kFoldPer; ++i) {
        const int tt = t0 + i;
        sv[i] = dv[i] = 0.f;
        if (i < per && tt <= h) {
          sv[i] = F[tt];
          if (tt > 0 && tt < h) {
            const float y = F[k - tt];
            dv[i] = sv[i] - y;
            sv[i] += y;
          }
        }
      }
      __syncwarp();
      float half = 0.f;
#pragma unroll
      for (int i = 0; i < kFoldPer; ++i) {
        const int tt = t0 + i, odd = tt & 1, j = tt >> 1;
        if (i >= per || tt > h) break;
        F[odd ? L + j : (tt < h ? j : 4 * L)] = sv[i];
        if (tt > 0 && tt < h) F[odd ? 3 * L + j : 2 * L + j - 1] = dv[i];
        half += odd ? 0.f : ((j & 1) ? -sv[i] : sv[i]);
      }
      if (fq == 0) {                         // the groups' tails
        for (int i = hh; i < L; ++i)
          F[i] = F[L + i] = F[3 * L + i] = 0.f;
        for (int i = 2 * L + hh - 1; i < 3 * L; ++i) F[i] = 0.f;
      }
      for (int o = 1; o < tpr; o <<= 1)      // the row's lanes, in order
        half += __shfl_xor_sync(0xffffffffu, half, o);
      if (fq == 0) spec[spec_at(h, b, n0 + r, nbk, fam)] = half;
    }
    __syncthreads();
    // a unit: one pair of m-tiles (E over an even group, O over the odd
    // one, the same 16 bins) by 4 n-tiles of rows
    for (int u = warp; u < units; u += kWarps) {
      const int pr = u / ngs, ng = u % ngs;
      const bool sine = pr >= cos_pairs;
      const int mt = sine ? pr - cos_pairs : pr;
      const float* AE = pan + ((sine ? 2 : 0) * M16 + mt * 16 + g) * ldp + t;
      const float* BE = fold + (ng * kDftNtg * 8 + g) * ld + (sine ? 2 * L : 0)
                        + t;
      float acc[2][kDftNtg][4], lo[2][kDftNtg][4];   // [E, O]
#pragma unroll
      for (int eo = 0; eo < 2; ++eo)
#pragma unroll
        for (int j = 0; j < kDftNtg; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[eo][j][e] = lo[eo][j][e] = 0.f;
#pragma unroll
      for (int eo = 0; eo < 2; ++eo) {
        const float* A0 = AE + eo * M16 * ldp;
        const float* B0 = BE + eo * L;
#pragma unroll 2
        for (int k0 = 0; k0 < L; k0 += 8) {
          uint32_t ah[4], al[4];
          split_tf32_alu(A0[k0], ah[0], al[0]);
          split_tf32_alu(A0[8 * ldp + k0], ah[1], al[1]);
          split_tf32_alu(A0[k0 + 4], ah[2], al[2]);
          split_tf32_alu(A0[8 * ldp + k0 + 4], ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < kDftNtg; ++j) {
            uint32_t b0h, b0l, b1h, b1l;
            split_tf32_alu(B0[j * 8 * ld + k0], b0h, b0l);
            split_tf32_alu(B0[j * 8 * ld + k0 + 4], b1h, b1l);
            mma_tf32(lo[eo][j], al, b0h, b1h);
            mma_tf32(lo[eo][j], ah, b0l, b1l);
            mma_tf32(acc[eo][j], ah, b0h, b1h);
          }
        }
      }
      // butterflies: cosine Xr_f = E + O, Xr_{h-f} = E - O (E with its
      // s_h term (-1)^f s_h); sine Xi_f = E + O, Xi_{h-f} = O - E (row 0
      // is bin h/2's sine part alone)
#pragma unroll
      for (int x = 0; x < 2; ++x) {          // rows g, g + 8 of the m-tile
        const int f = mt * 16 + g + 8 * x;
        if (f >= hh) continue;
        const int c1 = sine ? (f ? 2 * f + 1 : h + 1) : (f ? 2 * f : 0);
        const int c2 = sine ? 2 * (h - f) + 1 : (f ? 2 * (h - f) : 1);
        const float sgn = (f & 1) ? -1.f : 1.f;
#pragma unroll
        for (int j = 0; j < kDftNtg; ++j) {
          const int nl = ng * kDftNtg * 8 + j * 8 + 2 * t;
          float e[2], o[2];
#pragma unroll
          for (int y = 0; y < 2; ++y) {
            e[y] = acc[0][j][2 * x + y] + lo[0][j][2 * x + y];
            o[y] = acc[1][j][2 * x + y] + lo[1][j][2 * x + y];
            if (!sine) e[y] = fmaf(sgn, fold[(nl + y) * ld + 4 * L], e[y]);
          }
          const int n = n0 + nl;
          *reinterpret_cast<float2*>(spec + spec_at(c1, b, n, nbk, fam)) =
              make_float2(e[0] + o[0], e[1] + o[1]);
          if (!sine)
            *reinterpret_cast<float2*>(spec + spec_at(c2, b, n, nbk, fam)) =
                make_float2(e[0] - o[0], e[1] - o[1]);
          else if (f)
            *reinterpret_cast<float2*>(spec + spec_at(c2, b, n, nbk, fam)) =
                make_float2(o[0] - e[0], o[1] - e[1]);
        }
      }
    }
  }
  cp_async_wait_all();
}

// Packed spectra of a chunk's rows for a block size that does not fold:
// one block a tile of 64 rows of one block b (gy's, then xb's), staged in
// shared memory; thread items (row, packed column c), each a k-term dot
// product with row c of P (2 S, k) read through L1.  Rows past the chunk
// are written as zeros.
__global__ void __launch_bounds__(kThreads) dft_any_kernel(DftArgs a,
                                                           const float* P) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, C2 = 2 * slots_of(k), fam = a.p + a.q, ld = k + 1;
  const int nbk = a.np / 64, rtiles = a.np / kDftRows, per_e = fam * rtiles;
  const int tile = blockIdx.x, ex = tile / per_e;
  const int b = tile % per_e / rtiles, n0 = (tile % rtiles) * kDftRows;
  const bool from_gy = b < a.p;
  const float* src = from_gy ? a.gy + ex * a.gy_stride + (size_t)b * k
                             : a.xb + ex * a.xb_stride + (size_t)(b - a.p) * k;
  const size_t stride = (size_t)(from_gy ? a.p : a.q) * k;
  float* const spec = a.spec + ex * a.spec_stride;
  for (int i = threadIdx.x; i < kDftRows * k; i += kThreads) {
    const int r = i / k, t = i % k;
    smem[r * ld + t] = n0 + r < a.nc ? src[(n0 + r) * stride + t] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kDftRows * C2; i += kThreads) {
    const int r = i % kDftRows, c = i / kDftRows;
    const float* x = smem + r * ld;
    const float* pc = P + (size_t)c * k;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc = fmaf(x[t], __ldg(pc + t), acc);
    spec[spec_at(c, b, n0 + r, nbk, fam)] = acc;
  }
}

// ---------------------------------------------------------------------------
// MAC: the partial spectra of one slot, output tile and row split
// ---------------------------------------------------------------------------
struct MacArgs {
  const float* spec;     // (2 S, np / 64, p + q, 64) an expert
  float* part;           // (splits, S, p q, 2) an expert
  int np, p, q, slots, mt, per, stages, accumulate, splits;
  size_t spec_stride, part_stride;  // between experts
};

// the 3xTF32 A fragment of rows r0, r0 + 8 (of n valid) and columns kk + t,
// kk + t + 4 of a staged plane (row stride kLdm)
__device__ __forceinline__ void frag_a(const float* P, int r0, int n, int c,
                                       uint32_t (&h)[4], uint32_t (&l)[4]) {
  const float v[4] = {r0 < n ? P[r0 * kLdm + c] : 0.f,
                      r0 + 8 < n ? P[(r0 + 8) * kLdm + c] : 0.f,
                      r0 < n ? P[r0 * kLdm + c + 4] : 0.f,
                      r0 + 8 < n ? P[(r0 + 8) * kLdm + c + 4] : 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_alu(v[e], h[e], l[e]);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 2) mac_kernel(MacArgs a) {
  constexpr int kMt = kMaxUnits / NT;        // 16-row tiles at most
  extern __shared__ __align__(16) float smem[];
  const int slots = a.slots, fam = a.p + a.q;
  const int s = blockIdx.x;
  const int q_tiles = (a.q + 8 * NT - 1) / (8 * NT);
  const int i0 = blockIdx.y / q_tiles * 16 * a.mt;
  const int j0 = blockIdx.y % q_tiles * 8 * NT;
  const int np_ = min(16 * a.mt, a.p - i0), nq_ = min(8 * NT, a.q - j0);
  const int R = np_ + nq_;                   // staged rows a plane
  const int plane = R * kLdm, stage = 2 * plane;
  const int total = a.np / kRows;            // the chunk's stages
  const int ex = blockIdx.z / a.splits, z = blockIdx.z % a.splits;
  const int st0 = z * a.per;
  const float* const spec = a.spec + ex * a.spec_stride;
  const int mine = max(0, min(a.per, total - st0));
  const int tid = threadIdx.x;
  // a thread copies piece v (of 16) of staged rows r0, r0 + 16, ...: row
  // ri R + r is plane ri's row r (the output blocks, then the input ones)
  const int r0 = tid >> 4, v = tid & 15;
  auto load = [&](int it) {
    float* dst = smem + (it % a.stages) * stage + 4 * v;
    // spec (k, total, fam, 64): stage st0 + it of column 2 s + ri
    const float* src = spec + ((size_t)2 * s * total + st0 + it) * fam *
                                  kRows + 4 * v;
    for (int row = r0; row < 2 * R; row += kThreads / 16) {
      const int ri = row >= R, r = row - ri * R;
      const int b = r < np_ ? i0 + r : a.p + j0 + r - np_;
      cp_async16(dst + ri * plane + r * kLdm,
                 src + ((size_t)ri * total * fam + b) * kRows);
    }
  };
  for (int st = 0; st < a.stages - 1; ++st) {
    if (st < mine) load(st);
    cp_async_commit();
  }
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool packed = s == 0;
  float acc[kMt][NT][2][4];
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[m][n][e / 4][e % 4] = 0.f;
  for (int it = 0; it < mine; ++it) {
    cp_async_wait_ring(a.stages);
    __syncthreads();
    if (it + a.stages - 1 < mine) load(it + a.stages - 1);
    cp_async_commit();
    const float* Sr = smem + (it % a.stages) * stage;
    const float* Si = Sr + plane;
    const int kk = warp * 8 + t;             // this warp's 8 rows
#pragma unroll
    for (int m = 0; m < kMt; ++m) {
      if (m >= a.mt) break;                  // block-uniform
      uint32_t grh[4], grl[4], gih[4], gil[4];
      frag_a(Sr, m * 16 + g, np_, kk, grh, grl);
      frag_a(Si, m * 16 + g, np_, kk, gih, gil);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int jr = np_ + n * 8 + g;      // X row of column g
        const bool ok = n * 8 + g < nq_;
        uint32_t xr0h, xr0l, xr1h, xr1l, xi0h, xi0l, xi1h, xi1l;
        split_tf32_alu(ok ? Sr[jr * kLdm + kk] : 0.f, xr0h, xr0l);
        split_tf32_alu(ok ? Sr[jr * kLdm + kk + 4] : 0.f, xr1h, xr1l);
        split_tf32_alu(ok ? Si[jr * kLdm + kk] : 0.f, xi0h, xi0l);
        split_tf32_alu(ok ? Si[jr * kLdm + kk + 4] : 0.f, xi1h, xi1l);
        mma3(acc[m][n][0], grh, grl, xr0h, xr1h, xr0l, xr1l);
        if (packed) {
          mma3(acc[m][n][1], gih, gil, xi0h, xi1h, xi0l, xi1l);
        } else {
          uint32_t nh[4], nl[4];             // -Gr: exact sign flips
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            nh[e] = grh[e] ^ 0x80000000u;
            nl[e] = grl[e] ^ 0x80000000u;
          }
          mma3(acc[m][n][0], gih, gil, xi0h, xi1h, xi0l, xi1l);
          mma3(acc[m][n][1], gih, gil, xr0h, xr1h, xr0l, xr1l);
          mma3(acc[m][n][1], nh, nl, xi0h, xi1h, xi0l, xi1l);
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                           // the ring is free
  // the warps' sums, [warp][unit][lane][8], added in warp order
  const int units = a.mt * NT;
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    if (m >= a.mt) break;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* d = smem + (((warp * units) + m * NT + n) * 32 + lane) * 8;
      *reinterpret_cast<float4*>(d) = make_float4(
          acc[m][n][0][0], acc[m][n][1][0], acc[m][n][0][1], acc[m][n][1][1]);
      *reinterpret_cast<float4*>(d + 4) = make_float4(
          acc[m][n][0][2], acc[m][n][1][2], acc[m][n][0][3], acc[m][n][1][3]);
    }
  }
  __syncthreads();
  const int pq = a.p * a.q;
  float* out =
      a.part + ex * a.part_stride + ((size_t)z * slots + s) * pq * 2;
  for (int e = tid; e < units * 32; e += kThreads) {
    const int u = e / 32, ln = e % 32;
    float v[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) v[x] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* src = smem + ((w * units + u) * 32 + ln) * 8;
#pragma unroll
      for (int x = 0; x < 8; ++x) v[x] += src[x];
    }
    const int il = u / NT * 16 + ln / 4, jl = u % NT * 8 + 2 * (ln % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {            // rows il, il + 8
#pragma unroll
      for (int c = 0; c < 2; ++c) {          // columns jl, jl + 1
        if (il + 8 * h >= np_ || jl + c >= nq_) continue;
        float* o = out + ((size_t)(i0 + il + 8 * h) * a.q + j0 + jl + c) * 2;
        const float re = v[4 * h + 2 * c], im = v[4 * h + 2 * c + 1];
        if (a.accumulate) {
          o[0] += re;
          o[1] += im;
        } else {
          o[0] = re;
          o[1] = im;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// iDFT: the splits summed in order, weighted, times P (slot order)
// ---------------------------------------------------------------------------
struct IdftArgs {
  const float* part;     // an expert's at part_stride
  const float* panel;    // P (2 S, k): row c the packed column c's basis
  float* gw;             // (p, q, k) an expert, at pq k
  int pq, k, splits;
  size_t part_stride;
};

__global__ void __launch_bounds__(kThreads) idft_kernel(IdftArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, slots = slots_of(k), C2 = 2 * slots;
  const int rows = kIdftPanel / k;
  float* u = smem;                           // (kPairsBlock, 2 S)
  float* pan = smem + kPairsBlock * C2;      // rows x k of P at a time
  const int pr0 = blockIdx.x * kPairsBlock;
  const int npr = min(kPairsBlock, a.pq - pr0);
  const size_t zstride = (size_t)slots * a.pq * 2;
  const float* const part = a.part + blockIdx.y * a.part_stride;
  float* const gw = a.gw + (size_t)blockIdx.y * a.pq * k;
  for (int e = threadIdx.x; e < slots * 2 * kPairsBlock; e += kThreads) {
    const int s = e / (2 * kPairsBlock), pr = e / 2 % kPairsBlock,
              r = e % 2;
    float v = 0.f;
    if (pr < npr) {
      const float* src = part + ((size_t)s * a.pq + pr0 + pr) * 2 + r;
#pragma unroll 8
      for (int z = 0; z < a.splits; ++z) v += __ldg(src + z * zstride);
    }
    const int c = 2 * s + r;
    u[pr * C2 + c] = v * (c < 2 ? 1.f / k : 2.f / k);
  }
  // thread (group, t): output t of pairs group, group + groups, ...
  const int kp = (k + 31) / 32 * 32, groups = kThreads / kp;
  const int t = threadIdx.x % kp, grp = threadIdx.x / kp;
  const bool active = t < k && grp < groups;
  float y[kPairsBlock];
#pragma unroll
  for (int i = 0; i < kPairsBlock; ++i) y[i] = 0.f;
  for (int c0 = 0; c0 < C2; c0 += rows) {    // P staged a block of rows
    const int nr = min(rows, C2 - c0);
    __syncthreads();
    if (k % 4 == 0) {
      for (int i = threadIdx.x; i < nr * k / 4; i += kThreads)
        cp_async16(pan + 4 * i, a.panel + (size_t)c0 * k + 4 * i);
    } else {
      for (int i = threadIdx.x; i < nr * k; i += kThreads)
        pan[i] = a.panel[(size_t)c0 * k + i];
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (active)
      for (int c = 0; c < nr; ++c) {
        const float w = pan[c * k + t];
#pragma unroll
        for (int i = 0; i < kPairsBlock; ++i)
          if (grp + i * groups < kPairsBlock)
            y[i] = fmaf(u[(grp + i * groups) * C2 + c0 + c], w, y[i]);
      }
  }
  if (active)
#pragma unroll
    for (int i = 0; i < kPairsBlock; ++i) {
      const int pr = grp + i * groups;
      if (pr < npr) gw[(size_t)(pr0 + pr) * k + t] = y[i];
    }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& opted) {
  if (smem <= 48 * 1024 || opted) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  opted = e == cudaSuccess;
  return e;
}

template <int NT>
cudaError_t launch_mac(MacArgs m, dim3 grid, size_t smem, cudaStream_t s) {
  static bool opted = false;                 // per instantiation
  cudaError_t e = opt_in(mac_kernel<NT>, smem, opted);
  if (e != cudaSuccess) return e;
  mac_kernel<NT><<<grid, kThreads, smem, s>>>(m);
  return cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gy: (E, N, p, k); xb: (E, N, q, k); fold: the folded DFT sub-panels (4,
// M16, L), M16 = k/4 rounded up to 16, L = k/4 rounded up to 8
// (kernels/bc_grad_w.py:dft_panel; unread where k is not a multiple of 8);
// panel: P (2 S, k), the packed real DFT, rows in slot order, S = (k + 1)
// / 2; spec: scratch of group 2 S (p + q) chunk floats; part: scratch of
// group splits S p q 2 floats; gw: (E, p, q, k).  All float32, contiguous;
// fold, panel, spec and part 16-byte aligned, and gy and xb too where k is
// a multiple of 8 (1 <= k <= 256); E = 1 is one projection.  The plan
// (kernels/bc_grad_w.py:plan, one expert's): rows in chunks of `chunk` (a
// multiple of 128); the DFT in tiles of 64 rows, `dft_stages` (2 to 4)
// tiles in flight, `dft_blocks` persistent blocks; the MAC's output tile
// mt x nt (16-row by 8-column tiles, mt nt <= 8, nt in 1, 2, 4, 8; at most
// 65,535 output tiles), each chunk's rows cut into `splits` ranges,
// `mac_stages` (2 or 3); the experts in groups of `group`
// (kernels/bc_grad_w.py:stack_group).  groups x (2 chunks + 1) launches
// on `stream`.  Returns a cudaError_t (cudaErrorInvalidValue for a plan
// it cannot run).
extern "C" int bc_grad_w(const void* gy, const void* xb, const void* fold,
                         const void* panel, void* spec, void* part, void* gw,
                         int N, int p, int q, int k, int chunk,
                         int dft_stages, int dft_blocks, int mt, int nt,
                         int splits, int mac_stages, int E, int group,
                         void* stream) {
  const int fam = p + q, L = cdiv(k / 4, 8) * 8, M16 = cdiv(k / 4, 16) * 16;
  const int S = slots_of(k), C2 = 2 * S;
  if (N <= 0 || p <= 0 || q <= 0 || k < 1 || k > kMaxK ||
      chunk < kChunkRows || chunk % kChunkRows != 0 || dft_stages < 2 ||
      dft_stages > 4 || dft_blocks < 1 || mt < 1 ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || mt * nt > kMaxUnits ||
      splits < 1 || mac_stages < 2 || mac_stages > 3 || E < 1 ||
      group < 1 || group > E || (long long)splits * group > kMaxGridZ ||
      (folded(k) && (reinterpret_cast<uintptr_t>(gy) |
                     reinterpret_cast<uintptr_t>(xb)) % 16) ||
      (reinterpret_cast<uintptr_t>(fold) |
       reinterpret_cast<uintptr_t>(panel) |
       reinterpret_cast<uintptr_t>(spec) |
       reinterpret_cast<uintptr_t>(part)) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t dsmem =
      folded(k) ? sizeof(float) *
                      ((size_t)4 * M16 * (L + 4) +
                       (size_t)dft_stages * kDftRows * (max(k, 4 * L) + 4))
                : sizeof(float) * (size_t)kDftRows * (k + 1);
  const int p_rows = min(16 * mt, p), q_rows = min(8 * nt, q);
  const size_t msmem =
      sizeof(float) *
      (size_t)max(mac_stages * 2 * (p_rows + q_rows) * kLdm,
                  kWarps * mt * nt * 32 * 8);
  if (dsmem > (size_t)kMaxSmem || msmem > (size_t)kMaxSmem ||
      (long long)cdiv(p, 16 * mt) * cdiv(q, 8 * nt) > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  static bool dft_opted = false, any_opted = false;
  cudaError_t e = folded(k) ? opt_in(dft_kernel, dsmem, dft_opted)
                            : opt_in(dft_any_kernel, dsmem, any_opted);
  if (e != cudaSuccess) return (int)e;
  const int per = cdiv(chunk / kRows, splits);
  const size_t gy_e = (size_t)N * p * k, xb_e = (size_t)N * q * k;
  const size_t spec_e = (size_t)C2 * fam * chunk;
  const size_t part_e = (size_t)splits * S * p * q * 2;
  const size_t ismem = sizeof(float) * (kPairsBlock * C2 + kIdftPanel);
  static bool idft_opted = false;
  if ((e = opt_in(idft_kernel, ismem, idft_opted)) != cudaSuccess)
    return (int)e;
  for (int e0 = 0; e0 < E; e0 += group) {
    const int ge = min(group, E - e0);
    const dim3 mgrid(S, cdiv(p, 16 * mt) * cdiv(q, 8 * nt), splits * ge);
    for (int n0 = 0; n0 < N; n0 += chunk) {
      const int nc = min(chunk, N - n0);
      const int np = cdiv(nc, kChunkRows) * kChunkRows;
      DftArgs d{static_cast<const float*>(gy) + e0 * gy_e + (size_t)n0 * p * k,
                static_cast<const float*>(xb) + e0 * xb_e + (size_t)n0 * q * k,
                static_cast<const float*>(fold), static_cast<float*>(spec),
                nc, np, p, q, k, dft_stages, ge, gy_e, xb_e, spec_e};
      const int tiles = ge * fam * (np / kDftRows);
      if (folded(k))
        dft_kernel<<<min(dft_blocks, tiles), kThreads, dsmem, s>>>(d);
      else
        dft_any_kernel<<<tiles, kThreads, dsmem, s>>>(
            d, static_cast<const float*>(panel));
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      MacArgs m{static_cast<const float*>(spec), static_cast<float*>(part),
                np, p, q, S, mt, per, mac_stages, n0 > 0, splits,
                spec_e, part_e};
      switch (nt) {
        case 1: e = launch_mac<1>(m, mgrid, msmem, s); break;
        case 2: e = launch_mac<2>(m, mgrid, msmem, s); break;
        case 4: e = launch_mac<4>(m, mgrid, msmem, s); break;
        default: e = launch_mac<8>(m, mgrid, msmem, s); break;
      }
      if (e != cudaSuccess) return (int)e;
    }
    IdftArgs r{static_cast<const float*>(part),
               static_cast<const float*>(panel),
               static_cast<float*>(gw) + (size_t)e0 * p * q * k, p * q, k,
               splits, part_e};
    idft_kernel<<<dim3(cdiv(p * q, kPairsBlock), ge), kThreads, ismem, s>>>(
        r);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
