// Block-circulant linear in one pass: input DFT -> Gauss 3-product spectral
// MAC against the offline-FFT'd weight planes -> inverse DFT.
//
//   xb (B, q, k) --Cr/Ci--> Xr/Xi (B, q, kf)            (phase 1, DFT)
//   Yr = sum_j (Xr+Xi) wr - Xi ws2,  Yi = sum_j (Xr+Xi) wr + Xr ws1
//                                                        (phase 2, MAC)
//   y (B, p, k) = Yr Dr + Yi Di                           (phase 3, iDFT)
//
// Replaces: src/repro/kernels/bc_fused.py:bc_fused_matmul (Pallas body
// _kernel).  Its plain reference is core/circulant.py:bc_matmul_spectral.
//
// What bounds it on an H100: at decode (8 slots) neither bytes nor
// operations: the up projection moves ~0.93 MB and does ~18 MFLOP, ~0.28 us
// either way (3.35 TB/s, 67 TFLOP/s float32), well under the cost of a
// launch; 154 launches run per decode step.  At prefill (a few hundred
// rows) the float32 operations dominate, most of them in the two DFTs.
//
// Design: the point of the TPU kernel is that the spectra never touch
// device memory, and so here Xr/Xi and Yr/Yi live only in shared memory.
// A block takes `rows` input rows (1 at decode, for more blocks; up to 4 at
// prefill) and a tile of `ptile` output blocks; the grid covers
// (B / rows, p / ptile).  Phase 1 recomputes the rows' spectra for every
// p-tile (cheap next to phase 3), phase 2 keeps each weight value in a
// register across the block's rows, phase 3 reads Dr/Di columns coalesced.
// All arithmetic is float32 FMA (no TF32).  kf = k/2 + 1 is odd (65 at
// k = 128); the loops run to kf with no padding.  The DFT matrices
// (133 KB) are read through L1/L2, not staged.  Tensor cores (wgmma) and
// TMA staging are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;

__global__ void __launch_bounds__(kThreads)
bc_fused_kernel(const float* __restrict__ x,    // (B, q, k)
                const float* __restrict__ wr,   // (p, q, kf)
                const float* __restrict__ ws1,  // wi - wr
                const float* __restrict__ ws2,  // wr + wi
                const float* __restrict__ cr,   // (k, kf)
                const float* __restrict__ ci,
                const float* __restrict__ dr,   // (kf, k)
                const float* __restrict__ di,
                float* __restrict__ y,          // (B, p, k)
                int B, int p, int q, int k, int rows, int ptile) {
  extern __shared__ float smem[];
  const int kf = k / 2 + 1;
  const int row0 = blockIdx.x * rows;
  const int i0 = blockIdx.y * ptile;
  const int nrow = min(rows, B - row0);
  const int npt = min(ptile, p - i0);
  float* xr = smem;                          // (rows, q, kf)
  float* xi = xr + rows * q * kf;
  float* yr = xi + rows * q * kf;            // (rows, ptile, kf)
  float* yi = yr + rows * ptile * kf;

  // phase 1: DFT of the block's rows, (b, j, f) -> sum_n x[b, j, n] C[n, f]
  const int nx = nrow * q * kf;
  for (int idx = threadIdx.x; idx < nx; idx += blockDim.x) {
    const int f = idx % kf;
    const int bj = idx / kf;                 // b * q + j
    const float* xv = x + ((size_t)row0 * q + bj) * k;
    float sr = 0.f, si = 0.f;
    for (int n = 0; n < k; ++n) {
      const float v = xv[n];
      sr = fmaf(v, cr[n * kf + f], sr);
      si = fmaf(v, ci[n * kf + f], si);
    }
    xr[idx] = sr;
    xi[idx] = si;
  }
  __syncthreads();

  // phase 2: Gauss MAC over the input blocks j, for each (output block, bin)
  const int nm = npt * kf;
  for (int idx = threadIdx.x; idx < nm; idx += blockDim.x) {
    const int f = idx % kf;
    const int il = idx / kf;
    const size_t wbase = (size_t)(i0 + il) * q * kf + f;
    float t1[kMaxRows], t2[kMaxRows], t3[kMaxRows];
#pragma unroll
    for (int b = 0; b < kMaxRows; ++b) t1[b] = t2[b] = t3[b] = 0.f;
    for (int j = 0; j < q; ++j) {
      const float a = wr[wbase + (size_t)j * kf];
      const float s1 = ws1[wbase + (size_t)j * kf];
      const float s2 = ws2[wbase + (size_t)j * kf];
#pragma unroll
      for (int b = 0; b < kMaxRows; ++b) {
        if (b < nrow) {
          const float vr = xr[(b * q + j) * kf + f];
          const float vi = xi[(b * q + j) * kf + f];
          t1[b] = fmaf(vr + vi, a, t1[b]);
          t2[b] = fmaf(vr, s1, t2[b]);
          t3[b] = fmaf(vi, s2, t3[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kMaxRows; ++b) {
      if (b < nrow) {
        yr[(b * ptile + il) * kf + f] = t1[b] - t3[b];
        yi[(b * ptile + il) * kf + f] = t1[b] + t2[b];
      }
    }
  }
  __syncthreads();

  // phase 3: inverse DFT, (b, i, n) -> sum_f Yr[b, i, f] Dr[f, n] + Yi Di
  const int ny = nrow * npt * k;
  for (int idx = threadIdx.x; idx < ny; idx += blockDim.x) {
    const int n = idx % k;
    const int bil = idx / k;
    const int il = bil % npt;
    const int b = bil / npt;
    const float* yrv = yr + (b * ptile + il) * kf;
    const float* yiv = yi + (b * ptile + il) * kf;
    float s = 0.f;
    for (int f = 0; f < kf; ++f) {
      s = fmaf(yrv[f], dr[f * k + n], s);
      s = fmaf(yiv[f], di[f * k + n], s);
    }
    y[((size_t)(row0 + b) * p + i0 + il) * k + n] = s;
  }
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xb: (B, q, k); wr, ws1, ws2: (p, q, k/2 + 1); cr, ci: (k, k/2 + 1);
// dr, di: (k/2 + 1, k); y: (B, p, k).  All float32, contiguous.
// rows in 1..4 input rows per block, ptile output blocks per block.
// Returns a cudaError_t.
extern "C" int bc_fused(const void* xb, const void* wr, const void* ws1,
                        const void* ws2, const void* cr, const void* ci,
                        const void* dr, const void* di, void* y, int B, int p,
                        int q, int k, int rows, int ptile, void* stream) {
  if (B <= 0 || p <= 0 || q <= 0 || k <= 0 || rows < 1 || rows > kMaxRows ||
      ptile < 1)
    return (int)cudaErrorInvalidValue;
  const int kf = k / 2 + 1;
  const size_t smem = sizeof(float) * (size_t)rows * kf * (2 * q + 2 * ptile);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + rows - 1) / rows, (p + ptile - 1) / ptile);
  bc_fused_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xb), static_cast<const float*>(wr),
      static_cast<const float*>(ws1), static_cast<const float*>(ws2),
      static_cast<const float*>(cr), static_cast<const float*>(ci),
      static_cast<const float*>(dr), static_cast<const float*>(di),
      static_cast<float*>(y), B, p, q, k, rows, ptile);
  return (int)cudaGetLastError();
}
