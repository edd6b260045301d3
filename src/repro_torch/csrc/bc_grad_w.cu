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
// What bounds it on an H100: operations.  At tinyllama's up/gate (N =
// 8,192, p = 44, q = 16, k = 128) the two DFTs alone are 16 GFLOP and the
// MAC 3 GFLOP, ~0.29 ms at 67 TFLOP/s in float32 against ~75 us for its
// 252 MB of input.
//
// Design (a simple one; tensor cores, TMA and sharing gy's DFT with the
// dX pass are later work):
// - Kernel 1, grid (output-block tile x input-block tile, row split).  A
//   block owns pt x qt <= 64 (i, j) pairs over one range of rows.  Rows
//   stream through in chunks of kRows: each chunk's gy rows of the tile's
//   pt output blocks and xb rows of its qt input blocks are staged in
//   shared memory, multiplied by the DFT panel bc_fused reads (Cr and Ci
//   interleaved per bin, kernels/bc_fused.py:dft_panel; 4 x 8 register
//   tiles on the CUDA cores, float32), and the MAC adds G * conj(X) for
//   each pair and bin into registers: a thread owns one pair and every
//   fourth bin.  A tile recomputes the DFT of rows other tiles also
//   transform (the input blocks once per output tile and back); the tile
//   shape is chosen in Python (kernels/bc_grad_w.py:plan) to keep that
//   small.  gy is read straight from device memory and never copied.
// - Each block writes its (pt, qt, 2 kf) partial sums to scratch.  Kernel
//   2, one block per (i, j), adds the row splits' partials in split order
//   (no atomics: two calls give the same bits), weights each bin by 1/k
//   or 2/k and runs the iDFT against the transposed panel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 64;                  // (i, j) pairs a block
constexpr int kGroups = kThreads / kPairs;  // a pair's bins split 4 ways
constexpr int kRows = 4;                    // rows of N a chunk
constexpr int kMaxSmem = 232448;

__host__ __device__ inline int ncols(int k) { return (k + 2 + 7) / 8 * 8; }

struct Layout {
  int raw, spec, total, ldr, lds;
};

// Shared memory in floats: the panel (k, NC), the chunk's raw rows
// (kRows (pt + qt), k + 4) and their spectra (kRows (pt + qt), NC).
__host__ __device__ inline Layout layout(int k, int pt, int qt) {
  Layout l;
  const int rows = kRows * (pt + qt);
  l.ldr = k + 4;
  l.lds = ncols(k);
  l.raw = k * ncols(k);
  l.spec = l.raw + rows * l.ldr;
  l.total = l.spec + rows * l.lds;
  return l;
}

struct Args {
  const float* gy;
  const float* x;
  const float* panel;
  const float* panel_t;
  float* part;
  float* gw;
  int N, p, q, k, pt, qt, splits, rows;
};

template <int MAXB>
__global__ void __launch_bounds__(kThreads, 1) grad_w_partial(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int k = a.k, nc = ncols(k), kf = k / 2 + 1;
  const Layout L = layout(k, a.pt, a.qt);
  float* panel = smem;
  float* raw = smem + L.raw;
  float* spec = smem + L.spec;
  const int tiles_q = (a.q + a.qt - 1) / a.qt;
  const int p0 = blockIdx.x / tiles_q * a.pt, q0 = blockIdx.x % tiles_q * a.qt;
  const int np = min(a.pt, a.p - p0), nq = min(a.qt, a.q - q0);
  const int nr = np + nq;                   // DFT rows for one row of N
  const int n_begin = blockIdx.y * a.rows;
  const int n_end = min(a.N, n_begin + a.rows);
  const int tid = threadIdx.x;
  for (int i = tid; i < k * nc / 4; i += kThreads)
    reinterpret_cast<float4*>(panel)[i] =
        __ldg(reinterpret_cast<const float4*>(a.panel) + i);
  const int pair = tid % kPairs, grp = tid / kPairs;
  const bool mac = pair < np * nq;
  const int pl = mac ? pair / nq : 0, ql = mac ? pair % nq : 0;
  float ur[MAXB], ui[MAXB];
#pragma unroll
  for (int j = 0; j < MAXB; ++j) ur[j] = ui[j] = 0.f;
  const int k4 = k / 4, D = kRows * nr, cgroups = nc / 8;
  const int tasks = D / 4 * cgroups;
  for (int n0 = n_begin; n0 < n_end; n0 += kRows) {
    __syncthreads();          // the panel is staged; the last MAC is done
    // raw row d = r * nr + j: gy's output block p0 + j for j < np, else
    // xb's input block q0 + j - np, of row n0 + r (zeros past the range)
    for (int i = tid; i < D * k4; i += kThreads) {
      const int d = i / k4, c = i % k4;
      const int r = d / nr, j = d % nr, n = n0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < n_end) {
        const float* src =
            j < np ? a.gy + ((size_t)n * a.p + p0 + j) * k
                   : a.x + ((size_t)n * a.q + q0 + j - np) * k;
        v = __ldg(reinterpret_cast<const float4*>(src) + c);
      }
      *reinterpret_cast<float4*>(raw + d * L.ldr + 4 * c) = v;
    }
    __syncthreads();
    // spectra = raw @ panel, 4 rows x 8 columns a thread at a time
    for (int t = tid; t < tasks; t += kThreads) {
      const int d0 = t / cgroups * 4, c0 = t % cgroups * 8;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int kk = 0; kk < k; kk += 4) {
        float av[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(raw + (d0 + i) * L.ldr + kk);
          av[i][0] = v.x;
          av[i][1] = v.y;
          av[i][2] = v.z;
          av[i][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* prow = panel + (kk + u) * nc + c0;
          const float4 b0 = *reinterpret_cast<const float4*>(prow);
          const float4 b1 = *reinterpret_cast<const float4*>(prow + 4);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(av[i][u], bv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* dst = spec + (d0 + i) * L.lds + c0;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    __syncthreads();
    // ur + i ui += G * conj(X), the rows of the chunk in order
    if (mac) {
      for (int r = 0; r < kRows; ++r) {
        const float* G = spec + (r * nr + pl) * L.lds;
        const float* X = spec + (r * nr + np + ql) * L.lds;
#pragma unroll
        for (int j = 0; j < MAXB; ++j) {
          const int f = grp + kGroups * j;
          if (f < kf) {
            const float2 g = *reinterpret_cast<const float2*>(G + 2 * f);
            const float2 x = *reinterpret_cast<const float2*>(X + 2 * f);
            ur[j] = fmaf(g.y, x.y, fmaf(g.x, x.x, ur[j]));
            ui[j] = fmaf(-g.x, x.y, fmaf(g.y, x.x, ui[j]));
          }
        }
      }
    }
  }
  if (mac) {
    float* out = a.part + (((size_t)blockIdx.y * a.p + p0 + pl) * a.q + q0 +
                           ql) * (2 * kf);
#pragma unroll
    for (int j = 0; j < MAXB; ++j) {
      const int f = grp + kGroups * j;
      if (f < kf) {
        out[2 * f] = ur[j];
        out[2 * f + 1] = ui[j];
      }
    }
  }
}

// One block per (i, j): the splits' partials summed in split order, each
// bin weighted by 1/k (bin 0 and k/2) or 2/k, then y = U C^T.
__global__ void __launch_bounds__(128) grad_w_reduce(Args a) {
  extern __shared__ __align__(16) float u[];
  const int k = a.k, kf = k / 2 + 1;
  const size_t pq = blockIdx.x, stride = (size_t)a.p * a.q * 2 * kf;
  for (int t = threadIdx.x; t < 2 * kf; t += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < a.splits; ++i)
      s += a.part[i * stride + pq * 2 * kf + t];
    const int f = t / 2;
    u[t] = s * ((f == 0 || (k % 2 == 0 && f == k / 2)) ? 1.f / k : 2.f / k);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < 2 * kf; ++c) s = fmaf(u[c], a.panel_t[c * k + t], s);
    a.gw[pq * k + t] = s;
  }
}

template <int MAXB>
cudaError_t launch(Args a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)layout(a.k, a.pt, a.qt).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  static size_t opted = 48 * 1024;          // per instantiation
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        grad_w_partial<MAXB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (e != cudaSuccess) return e;
    opted = kMaxSmem;
  }
  const int tiles = ((a.p + a.pt - 1) / a.pt) * ((a.q + a.qt - 1) / a.qt);
  grad_w_partial<MAXB><<<dim3(tiles, a.splits), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  grad_w_reduce<<<a.p * a.q, 128, sizeof(float) * (a.k + 2), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// gy: (N, p, k); xb: (N, q, k); panel: (k, NC), Cr and Ci interleaved per
// bin then zeros, NC = k + 2 rounded up to 8; panel_t: its transpose (NC,
// k); part: scratch (splits, p, q, k + 2); gw: (p, q, k).  All float32,
// contiguous, gy / xb / panel 16-byte aligned.  The plan: tiles of pt
// output blocks x qt input blocks (pt qt <= 64), the rows cut into
// `splits` ranges of `rows` (a multiple of 4).  Two launches on `stream`.
// Returns a cudaError_t (cudaErrorInvalidValue for a plan it cannot run).
extern "C" int bc_grad_w(const void* gy, const void* xb, const void* panel,
                         const void* panel_t, void* part, void* gw, int N,
                         int p, int q, int k, int pt, int qt, int splits,
                         int rows, void* stream) {
  Args a{static_cast<const float*>(gy), static_cast<const float*>(xb),
         static_cast<const float*>(panel), static_cast<const float*>(panel_t),
         static_cast<float*>(part), static_cast<float*>(gw), N, p, q, k, pt,
         qt, splits, rows};
  const int kf = k / 2 + 1;
  if (N <= 0 || p <= 0 || q <= 0 || k < 8 || k % 8 != 0 || pt < 1 ||
      qt < 1 || pt > p || qt > q || pt * qt > kPairs || splits < 1 ||
      splits > 65535 || rows < kRows || rows % kRows != 0 ||
      (long long)splits * rows < N ||
      (long long)(splits - 1) * rows >= N ||
      (reinterpret_cast<uintptr_t>(gy) | reinterpret_cast<uintptr_t>(xb) |
       reinterpret_cast<uintptr_t>(panel)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kf <= kGroups * 17) return (int)launch<17>(a, s);
  if (kf <= kGroups * 33) return (int)launch<33>(a, s);
  return (int)cudaErrorInvalidValue;
}
