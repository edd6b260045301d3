// Frequency-domain block-circulant MAC on its own: per retained rfft bin f
// a complex product Y[f] = X[f] W[f] over the input-block axis, as three
// real products (Gauss):
//
//   t1 = (Xr + Xi) Wr,   t2 = Xr Ws1,   t3 = Xi Ws2     (Ws1 = Wi - Wr,
//   Yr = t1 - t3,        Yi = t1 + t2                    Ws2 = Wr + Wi)
//
//   xr, xi (F, N, Q);  wr, ws1, ws2 (F, Q, P)  ->  yr, yi (F, N, P)
//
// Replaces: src/repro/kernels/spectral_matmul.py:spectral_matmul (Pallas
// body _kernel); its plain reference is kernels/ref.py:spectral_matmul_ref
// with wi = ws1 + wr.  It is the kernel_fn of bc_matmul_spectral: the DFT
// and inverse DFT stay dense products outside it, and the batch engine's
// prefill (many rows sharing one set of planes) runs its MAC here.
//
// Two layouts of the same logical shapes, one kernel instance each:
// - bin-major (repro's own): every operand contiguous, (F, N, Q),
//   (F, Q, P), (F, N, P).
// - bin-minor (the hook's views, kernels/ops.py:spectral_contract): the
//   spectra (N, Q, F) and planes (P, Q, F) as the DFT and the cache hold
//   them, read through strides (1, Q F, F) and (1, F, Q F); the output is
//   written as (N, P, F), which the iDFT reads as contiguous rows.  No
//   operand is copied or permuted on the way in or out.
//
// What bounds it on an H100: bytes, at every serving shape.  Per bin it
// does 6 N Q P flops on 4 (2 N Q + 3 Q P + 2 N P) bytes: at most ~10 flops
// a byte (Q, P = 86, 16), under the ~20 of float32 FMAs against 3.35 TB/s
// and far under the tensor cores'.  At F = 65, N = 2048 the bound is
// 10.2 us at (16, 16) and 32.8 us at (86, 16).  The CUDA cores alone would
// need ~17 us of that at full rate at (86, 16), so the MAC goes to the
// tensor cores and the kernel's work is moving bytes.
//
// Design:
// - A block owns a chunk of up to fc bins (grid x; chunks of F balanced
//   to within one bin) and every row tile t = blockIdx.y + i gridDim.y of
//   16, 32 or 64 rows.  The loop over row tiles inside the block stands in
//   for the Pallas grid's sequential axis.
// - The chunk's planes (fc x Q x P, three of them) are staged in shared
//   memory once per block and reused for all its row tiles.  Q and P are
//   padded with zeros to multiples of 8 (20 -> 24, 86 -> 88).
// - The X tiles (xr and xi, fc bins x rows x Q) stream through a ring of 2
//   or 3 shared-memory stages with cp.async: tile i + stages - 1 is in
//   flight while tile i is multiplied.  Bin-major rows are whole 16-byte
//   (or 8-byte) pieces.  Bin-minor spectra take 4-byte copies with
//   neighbouring threads on neighbouring bins: a row of a bin-minor
//   spectrum starts at an odd float offset, (n Q + q) F with F = 65, and
//   its stride, 4 F bytes, is no multiple of 16, so neither 16-byte copies
//   nor a TMA tensor map can take it.  (Copies of whole 16-byte pieces,
//   for X and for Y, were tried on the H100 and were slower.)
// - The MAC: mma.sync m16n8k8 in TF32 with the 3xTF32 split
//   (mma_tf32.cuh), in integer operations: the cvt form of the split set
//   the pace of the first version.  A warp unit is (bin, 16-row tile, jn
//   8-column tiles): xr + xi is formed in registers as the A fragment is
//   built (only xr and xi are staged), and each of t1, t2, t3 keeps hi*hi
//   in one float32 sum and lo*hi + hi*lo in another, added at the end.
// - Output along its contiguous axis.  Bin-major: a warp stages its unit's
//   16 rows in its own shared tile and writes them as whole rows (16-byte
//   pieces), with no block barrier.  Bin-minor: the block stages the
//   tile's (bin, row, column) results and writes them with neighbouring
//   threads on neighbouring bins.
// - The launch plan (bins a chunk, rows a tile, stages, column tiles a
//   unit, row-tile splits) is chosen in Python
//   (kernels/spectral_matmul.py:plan) as a pure function of the shapes and
//   the layout; spectral_matmul() checks it.  One launch a call, nothing
//   read on the host, no atomics: a call can be captured in a CUDA graph,
//   and a repeated call gives the same bits.
// Not done here: wgmma (its 64-row tiles and shared-memory B want the
// planes in a layout the hook's views do not have), warp-specialised
// producers, TMA for the bin-major layout.  Tried on the H100 and slower:
// a thread-block cluster sharing one row tile's bins, so that the
// bin-minor spectra and results move as whole contiguous slabs gathered
// through distributed shared memory.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxJ = 2;           // 8-column tiles a warp unit
constexpr int kLdw = 8 * kMaxJ + 4;  // row stride of a warp's Y tile
constexpr int kMaxFc = 16;         // bins a chunk
constexpr int kMaxSmem = 232448;   // bytes a block can use on an H100

enum Layout { kBinMajor = 0, kBinMinor = 1 };

// Shapes and shared-memory geometry of one launch (all in floats).
struct Geom {
  int F, N, Q, P;
  int chunks, fc, stages, jn, rows;   // rows a tile: 16, 32 or 64
  int qp, pp;          // Q, P rounded up to 8
  int ldb;             // row stride of a staged plane and of the Y tile
  int wfs, yfs;        // bin strides of the staged planes and Y tile
  int xfs, rs;         // staged X element (bin a, row r, col q) at
                       // a xfs + r rs + q; xplane = fc xfs
  int vx, vw, vy;      // floats a copy of an X / plane / Y row piece
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int V>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
                 "l"(gmem));
  else if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s),
                 "l"(gmem));
}

// op(a0, a1, a2) over an n0 x n1 x n2 box, a0 fastest across the threads
// (the contiguous axis of the global side), with the thread's coordinates
// fixed up front: no division inside the loops.
template <class Op>
__device__ __forceinline__ void box(int n0, int n1, int n2, Op op) {
  const int c0 = min(n0, kThreads);
  const int c1 = min(n1, kThreads / c0);
  const int c2 = kThreads / (c0 * c1);
  const int t = threadIdx.x;
  const int i0 = t % c0, i1 = (t / c0) % c1, i2 = t / (c0 * c1);
  if (i2 >= c2) return;
  for (int a2 = i2; a2 < n2; a2 += c2)
    for (int a1 = i1; a1 < n1; a1 += c1)
      for (int a0 = i0; a0 < n0; a0 += c0) op(a0, a1, a2);
}

// Bin-major pieces of V floats: n2 bins of n1 rows of len floats, source
// bin stride sb and row stride len, into dst at bin stride db, row stride
// dr.
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int len, int n1, int n2, size_t sb,
                                          int db, int dr) {
  box(len / V, n1, n2, [&](int v, int r, int a) {
    cp_async<V>(dst + a * db + r * dr + V * v,
                src + a * sb + (size_t)r * len + V * v);
  });
}

__device__ __forceinline__ void copy_rows_v(int vec, float* dst,
                                            const float* src, int len, int n1,
                                            int n2, size_t sb, int db,
                                            int dr) {
  if (vec == 4)
    copy_rows<4>(dst, src, len, n1, n2, sb, db, dr);
  else if (vec == 2)
    copy_rows<2>(dst, src, len, n1, n2, sb, db, dr);
  else
    copy_rows<1>(dst, src, len, n1, n2, sb, db, dr);
}

// A warp's bin-major results, pieces of V floats: nrw rows of cw columns
// from its Y tile (yr plane, then yi 16 kLdw further) to yr / yi at o0,
// row stride P (the rows of a bin are contiguous in device memory).
template <int V>
__device__ __forceinline__ void warp_rows(float* yr, float* yi,
                                          const float* yw, size_t o0, int P,
                                          int cw, int nrw, int lane) {
  using T = typename std::conditional<
      V == 4, float4, typename std::conditional<V == 2, float2,
                                                float>::type>::type;
  const int pieces = cw / V;
  for (int e = lane; e < nrw * pieces; e += 32) {
    const int r = e / pieces, c = (e - r * pieces) * V;
    const size_t o = o0 + (size_t)r * P + c;
    *reinterpret_cast<T*>(yr + o) =
        *reinterpret_cast<const T*>(yw + r * kLdw + c);
    *reinterpret_cast<T*>(yi + o) =
        *reinterpret_cast<const T*>(yw + 16 * kLdw + r * kLdw + c);
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
spectral_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ ws1,
                const float* __restrict__ ws2, float* __restrict__ yr,
                float* __restrict__ yi, const Geom g) {
  extern __shared__ __align__(16) float smem[];
  const int f0 = (int)((long long)blockIdx.x * g.F / g.chunks);
  const int nf = (int)((long long)(blockIdx.x + 1) * g.F / g.chunks) - f0;
  const int tiles = (g.N + g.rows - 1) / g.rows;
  const int t0 = blockIdx.y, tstep = gridDim.y;
  const int mine = t0 < tiles ? (tiles - 1 - t0) / tstep + 1 : 0;
  if (mine == 0) return;                       // the whole block

  const int wplane = g.fc * g.wfs, xplane = g.fc * g.xfs;
  float* wsm = smem;                           // [3][fc] (qp x ldb)
  float* xsm = wsm + 3 * wplane;               // [stages][2] X tiles
  // bin-minor: [2][fc] (rows x ldb); bin-major: [warp][2] (16 x kLdw)
  float* ysm = xsm + g.stages * 2 * xplane;

  // zeros where the copies never write: Q..qp, P..pp (rows past N are
  // never stored, and an mma row depends on its own A row alone)
  if (g.Q != g.qp || g.P != g.pp) {
    float4* p = reinterpret_cast<float4*>(smem);
    const int n4 = (3 * wplane + g.stages * 2 * xplane) / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // the chunk's three planes, once
  const float* wp[3] = {wr, ws1, ws2};
  for (int pl = 0; pl < 3; ++pl) {
    float* dst = wsm + pl * wplane;
    if (L == kBinMinor) {                      // (p, q, f), f contiguous
      const float* src = wp[pl] + f0;
      box(nf, g.Q, g.P, [&](int a, int q, int p) {
        cp_async<1>(dst + a * g.wfs + q * g.ldb + p,
                    src + ((size_t)p * g.Q + q) * g.F + a);
      });
    } else {                                   // (f, q, p), p contiguous
      copy_rows_v(g.vw, dst, wp[pl] + (size_t)f0 * g.Q * g.P, g.P, g.Q, nf,
                  (size_t)g.Q * g.P, g.wfs, g.ldb);
    }
  }

  auto stage_x = [&](int t, int slot) {
    const int n0 = t * g.rows, nr = min(g.rows, g.N - n0);
    float* dr = xsm + slot * 2 * xplane;
    float* di = dr + xplane;
    if (L == kBinMinor) {                      // (n, q, f), f contiguous
      const size_t base = (size_t)n0 * g.Q * g.F + f0;
      box(nf, g.Q, nr, [&](int a, int q, int r) {
        const size_t s = base + ((size_t)r * g.Q + q) * g.F + a;
        const int d = a * g.xfs + r * g.rs + q;
        cp_async<1>(dr + d, xr + s);
        cp_async<1>(di + d, xi + s);
      });
    } else {                                   // (f, n, q), q contiguous
      const size_t base = ((size_t)f0 * g.N + n0) * g.Q;
      const size_t sb = (size_t)g.N * g.Q;
      copy_rows_v(g.vx, dr, xr + base, g.Q, nr, nf, sb, g.xfs, g.rs);
      copy_rows_v(g.vx, di, xi + base, g.Q, nr, nf, sb, g.xfs, g.rs);
    }
  };

  // the planes ride in the first group with tile 0
  stage_x(t0, 0);
  cp_async_commit();
  for (int s = 1; s < g.stages - 1; ++s) {
    if (s < mine) stage_x(t0 + s * tstep, s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int nt = g.pp >> 3;                    // 8-column tiles
  const int ngr = (nt + g.jn - 1) / g.jn;      // column groups
  const int mts = g.rows >> 4;                // 16-row mma tiles
  float* yw = ysm + warp * 2 * 16 * kLdw;      // bin-major: this warp's
  const int units = nf * mts * ngr;

  for (int i = 0; i < mine; ++i) {
    if (g.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();                           // tile i landed; slot free
    const int nx = i + g.stages - 1;
    if (nx < mine) stage_x(t0 + nx * tstep, nx % g.stages);
    cp_async_commit();

    const int n0 = (t0 + i * tstep) * g.rows;
    const float* xa = xsm + (i % g.stages) * 2 * xplane;
    for (int u = warp; u < units; u += kWarps) {
      const int a = u / (mts * ngr), mg = u - a * mts * ngr;
      const int mt = mg / ngr, gi = mg - mt * ngr;
      const float* A0 = xa + a * g.xfs + (16 * mt + gr) * g.rs + tq;  // xr
      const float* A1 = A0 + xplane;                         // xi
      const int nt0 = gi * g.jn, nj = min(g.jn, nt - nt0);
      const float* B0 = wsm + a * g.wfs + tq * g.ldb + nt0 * 8 + gr;
      float hh[3][kMaxJ][4], lo[3][kMaxJ][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) hh[p][j][e] = lo[p][j][e] = 0.f;
#pragma unroll 2
      for (int k0 = 0; k0 < g.qp; k0 += 8) {
        const int o1 = 8 * g.rs;               // row gr + 8
        const float r4[4] = {A0[k0], A0[o1 + k0], A0[k0 + 4],
                             A0[o1 + k0 + 4]};
        const float i4[4] = {A1[k0], A1[o1 + k0], A1[k0 + 4],
                             A1[o1 + k0 + 4]};
        uint32_t sh[4], sl[4], rh[4], rl[4], ih[4], il[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32_alu(r4[e] + i4[e], sh[e], sl[e]);
          split_tf32_alu(r4[e], rh[e], rl[e]);
          split_tf32_alu(i4[e], ih[e], il[e]);
        }
#pragma unroll
        for (int j = 0; j < kMaxJ; ++j) {
          if (j >= nj) break;                  // warp-uniform
          const float* b = B0 + k0 * g.ldb + j * 8;
          uint32_t h0, l0, h1, l1;
          // t1 = (xr + xi) wr
          split_tf32_alu(b[0], h0, l0);
          split_tf32_alu(b[4 * g.ldb], h1, l1);
          mma_tf32(lo[0][j], sl, h0, h1);
          mma_tf32(lo[0][j], sh, l0, l1);
          mma_tf32(hh[0][j], sh, h0, h1);
          // t2 = xr ws1
          split_tf32_alu(b[wplane], h0, l0);
          split_tf32_alu(b[wplane + 4 * g.ldb], h1, l1);
          mma_tf32(lo[1][j], rl, h0, h1);
          mma_tf32(lo[1][j], rh, l0, l1);
          mma_tf32(hh[1][j], rh, h0, h1);
          // t3 = xi ws2
          split_tf32_alu(b[2 * wplane], h0, l0);
          split_tf32_alu(b[2 * wplane + 4 * g.ldb], h1, l1);
          mma_tf32(lo[2][j], il, h0, h1);
          mma_tf32(lo[2][j], ih, l0, l1);
          mma_tf32(hh[2][j], ih, h0, h1);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxJ; ++j) {
        if (j >= nj) break;
        const int col = (nt0 + j) * 8 + 2 * tq;
        float vr[4], vi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t1 = hh[0][j][e] + lo[0][j][e];
          const float t2 = hh[1][j][e] + lo[1][j][e];
          const float t3 = hh[2][j][e] + lo[2][j][e];
          vr[e] = t1 - t3;
          vi[e] = t1 + t2;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {          // rows gr, gr + 8
          const int r = gr + 8 * h;
          float* d = L == kBinMinor
                         ? ysm + a * g.yfs + (16 * mt + r) * g.ldb + col
                         : yw + r * kLdw + col - 8 * nt0;
          const int plane = L == kBinMinor ? g.fc * g.yfs : 16 * kLdw;
          *reinterpret_cast<float2*>(d) = make_float2(vr[2 * h],
                                                      vr[2 * h + 1]);
          *reinterpret_cast<float2*>(d + plane) =
              make_float2(vi[2 * h], vi[2 * h + 1]);
        }
      }
      if (L == kBinMajor) {   // the unit's rows of its bin: this warp alone
        __syncwarp();
        const int cw = min(8 * nj, g.P - 8 * nt0);
        const int nrw = min(16, g.N - n0 - 16 * mt);
        const size_t o0 =
            ((size_t)(f0 + a) * g.N + n0 + 16 * mt) * g.P + 8 * nt0;
        if (g.vy == 4)
          warp_rows<4>(yr, yi, yw, o0, g.P, cw, nrw, lane);
        else if (g.vy == 2)
          warp_rows<2>(yr, yi, yw, o0, g.P, cw, nrw, lane);
        else
          warp_rows<1>(yr, yi, yw, o0, g.P, cw, nrw, lane);
        __syncwarp();
      }
    }

    if (L == kBinMinor) {   // the tile leaves along the bins, (n, p, f)
      __syncthreads();
      const int nr = min(g.rows, g.N - n0);
      const float* si = ysm + g.fc * g.yfs;
      const size_t base = (size_t)n0 * g.P * g.F + f0;
      box(nf, g.P, nr, [&](int a, int p, int r) {
        const int d = a * g.yfs + r * g.ldb + p;
        const size_t o = base + ((size_t)r * g.P + p) * g.F + a;
        yr[o] = ysm[d];
        yi[o] = si[d];
      });
    }
  }
}


int vec_width(int len, std::initializer_list<const void*> ptrs) {
  for (int v : {4, 2}) {
    bool ok = len % v == 0;
    for (const void* p : ptrs)
      ok = ok && reinterpret_cast<uintptr_t>(p) % (4 * v) == 0;
    if (ok) return v;
  }
  return 1;
}

// Shared bytes of a block (kernels/spectral_matmul.py:smem_bytes is the
// same formula): the chunk's planes, the X ring, the Y tile (bin-minor).
// Shared-memory geometry of a launch (all in floats); smem_bytes is its
// total.  kernels/spectral_matmul.py:smem_bytes is the same formula.
void geometry(Geom& g, int layout) {
  g.qp = (g.Q + 7) / 8 * 8;
  g.pp = (g.P + 7) / 8 * 8;
  g.rs = g.qp + 4;                             // = 4 mod 8: A reads
  g.ldb = g.pp % 16 == 8 ? g.pp : g.pp + 8;    // = 8 mod 16: B reads
  g.wfs = g.qp * g.ldb;
  // bin-minor copies run along the bins: a bin stride of 32 / fc (mod 32)
  // more puts the fc bins of a (row, q) on different banks
  const int spread = layout == kBinMinor ? (32 / g.fc) % 32 : 0;
  g.xfs = g.rows * g.rs + spread;
  g.yfs = g.rows * g.ldb + spread;
}

int smem_bytes(const Geom& g, int layout) {
  const int y = layout == kBinMinor ? g.fc * 2 * g.yfs : kWarps * 2 * 16 * kLdw;
  return 4 * (g.fc * (3 * g.wfs + g.stages * 2 * g.xfs) + y);
}


}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xr, xi (F, N, Q); wr, ws1, ws2 (F, Q, P); yr, yi (F, N, P); float32, in
// the given layout (0 bin-major, 1 bin-minor, as the header says).  The
// plan: chunks of at most fc bins (grid x), splits of the row tiles
// (grid y), stages of the X ring, jn column tiles a warp unit.  Returns a
// cudaError_t: cudaErrorInvalidValue for a plan or shape it cannot run.
extern "C" int spectral_matmul(const void* xr, const void* xi,
                               const void* wr, const void* ws1,
                               const void* ws2, void* yr, void* yi, int F,
                               int N, int Q, int P, int layout, int chunks,
                               int fc, int rows, int stages, int jn,
                               int splits, void* stream) {
  const bool fc_ok = fc >= 1 && fc <= kMaxFc && (fc & (fc - 1)) == 0;
  if (F <= 0 || N <= 0 || Q <= 0 || P <= 0 || !fc_ok ||
      (layout != kBinMajor && layout != kBinMinor) || chunks < 1 ||
      chunks > F || (F + chunks - 1) / chunks > fc || stages < 2 ||
      stages > 3 || jn < 1 || jn > kMaxJ || splits < 1 || splits > 65535 ||
      (rows != 16 && rows != 32 && rows != 64))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.F = F; g.N = N; g.Q = Q; g.P = P;
  g.chunks = chunks; g.fc = fc; g.stages = stages; g.jn = jn; g.rows = rows;
  geometry(g, layout);
  const int smem = smem_bytes(g, layout);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  g.vx = layout == kBinMajor ? vec_width(Q, {xr, xi}) : 1;
  g.vw = layout == kBinMajor ? vec_width(P, {wr, ws1, ws2}) : 1;
  g.vy = layout == kBinMajor ? vec_width(P, {yr, yi}) : 1;
  auto kernel = layout == kBinMajor ? spectral_kernel<kBinMajor>
                                    : spectral_kernel<kBinMinor>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(chunks, splits), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(ws1),
      static_cast<const float*>(ws2), static_cast<float*>(yr),
      static_cast<float*>(yi), g);
  return (int)cudaGetLastError();
}
