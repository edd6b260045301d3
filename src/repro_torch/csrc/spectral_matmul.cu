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
// What bounds it on an H100: bytes.  At the prefill shape (F = 65,
// N = 2048 rows, Q = P = 16) the planes in and out are ~34 MB, ~10 us at
// 3.35 TB/s, against ~0.2 GFLOP (~3 us at the 67 TFLOP/s float32 rate);
// at (Q, P) = (16, 44) ~64 MB against ~0.56 GFLOP.  Arithmetic intensity is
// about Q * P / (2 (Q + P)) / 4 flops per byte: far below the line.
//
// Design: one block per (tile of P columns, tile of rows, bin f).  The
// block stages its rows of Xr + Xi, Xr and Xi (rows x Q, row stride Q + 1
// against bank conflicts) and its columns of the three W planes (Q x tile)
// in shared memory: Q <= 86 on every serving path, so the whole contraction
// axis fits and each value is read from device memory once per block.
// Thread t owns column t % tile and rows t / tile + g * groups
// (g < kRowsPerThread), and keeps t1, t2, t3 for those rows in registers;
// the W values of its column are read once per q and reused across the
// rows.  The column tile is P split into near-equal parts of at most 32
// (P = 44 -> 2 x 22, P = 2 -> one tile of 2, so small P wastes no lanes);
// the row groups fill up to 256 threads, fewer where the tiles would
// overflow shared memory.  Nothing assumes a power of two or a multiple of
// a tile: F = 65, P = 2, Q = 44 and a ragged N are all plain bounds checks.
// All arithmetic is float32 FMA; no tensor cores (wgmma) or TMA yet.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kMaxTileP = 32;
constexpr size_t kSmemBudget = 200 * 1024;   // of the 227 KB a block may use

__global__ void __launch_bounds__(kMaxThreads)
spectral_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ wr, const float* __restrict__ ws1,
                const float* __restrict__ ws2, float* __restrict__ yr,
                float* __restrict__ yi, int N, int Q, int P, int tile_p,
                int groups) {
  extern __shared__ float smem[];
  const int rows = groups * kRowsPerThread;  // rows per block
  const int xstride = Q + 1;
  float* xs = smem;                          // (rows, Q + 1)  Xr + Xi
  float* xa = xs + rows * xstride;           // (rows, Q + 1)  Xr
  float* xb = xa + rows * xstride;           // (rows, Q + 1)  Xi
  float* w0 = xb + rows * xstride;           // (Q, tile_p)    Wr
  float* w1 = w0 + Q * tile_p;               // (Q, tile_p)    Ws1
  float* w2 = w1 + Q * tile_p;               // (Q, tile_p)    Ws2

  const int p0 = blockIdx.x * tile_p;
  const int n0 = blockIdx.y * rows;
  const int f = blockIdx.z;
  const int np = min(tile_p, P - p0);        // live columns of this tile
  const float* xrf = xr + (size_t)f * N * Q;
  const float* xif = xi + (size_t)f * N * Q;
  const float* wrf = wr + (size_t)f * Q * P;
  const float* w1f = ws1 + (size_t)f * Q * P;
  const float* w2f = ws2 + (size_t)f * Q * P;

  // stage the rows (zero past N) and the columns (zero past P)
  for (int idx = threadIdx.x; idx < rows * Q; idx += blockDim.x) {
    const int r = idx / Q, q = idx % Q;
    const int n = n0 + r;
    float a = 0.f, b = 0.f;
    if (n < N) {
      a = xrf[(size_t)n * Q + q];
      b = xif[(size_t)n * Q + q];
    }
    xs[r * xstride + q] = a + b;
    xa[r * xstride + q] = a;
    xb[r * xstride + q] = b;
  }
  for (int idx = threadIdx.x; idx < Q * tile_p; idx += blockDim.x) {
    const int q = idx / tile_p, c = idx % tile_p;
    const bool live = c < np;
    const size_t g = (size_t)q * P + p0 + c;
    w0[idx] = live ? wrf[g] : 0.f;
    w1[idx] = live ? w1f[g] : 0.f;
    w2[idx] = live ? w2f[g] : 0.f;
  }
  __syncthreads();

  const int c = threadIdx.x % tile_p;
  const int g0 = threadIdx.x / tile_p;       // < groups (blockDim = groups * tile_p)
  float t1[kRowsPerThread], t2[kRowsPerThread], t3[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) t1[i] = t2[i] = t3[i] = 0.f;
  for (int q = 0; q < Q; ++q) {
    const float a = w0[q * tile_p + c];
    const float b = w1[q * tile_p + c];
    const float d = w2[q * tile_p + c];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = (g0 + i * groups) * xstride + q;
      t1[i] = fmaf(xs[r], a, t1[i]);
      t2[i] = fmaf(xa[r], b, t2[i]);
      t3[i] = fmaf(xb[r], d, t3[i]);
    }
  }
  if (c >= np) return;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int n = n0 + g0 + i * groups;
    if (n < N) {
      const size_t o = ((size_t)f * N + n) * P + p0 + c;
      yr[o] = t1[i] - t3[i];
      yi[o] = t1[i] + t2[i];
    }
  }
}

size_t smem_bytes(int groups, int Q, int tile_p) {
  return sizeof(float) * ((size_t)3 * groups * kRowsPerThread * (Q + 1) +
                          (size_t)3 * Q * tile_p);
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// xr, xi: (F, N, Q); wr, ws1, ws2: (F, Q, P); yr, yi: (F, N, P).  All
// float32, contiguous.  Returns a cudaError_t.
extern "C" int spectral_matmul(const void* xr, const void* xi,
                               const void* wr, const void* ws1,
                               const void* ws2, void* yr, void* yi, int F,
                               int N, int Q, int P, void* stream) {
  if (F <= 0 || N <= 0 || Q <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (P + kMaxTileP - 1) / kMaxTileP;
  const int tile_p = (P + tiles - 1) / tiles;
  int groups = kMaxThreads / tile_p;
  while (groups > 1 && smem_bytes(groups, Q, tile_p) > kSmemBudget) --groups;
  const size_t smem = smem_bytes(groups, Q, tile_p);
  if (smem > kSmemBudget) return (int)cudaErrorInvalidValue;   // Q too large
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        spectral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = groups * kRowsPerThread;
  if ((N + rows - 1) / rows > 65535 || F > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((P + tile_p - 1) / tile_p, (N + rows - 1) / rows, F);
  spectral_kernel<<<grid, groups * tile_p, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(wr), static_cast<const float*>(ws1),
      static_cast<const float*>(ws2), static_cast<float*>(yr),
      static_cast<float*>(yi), N, Q, P, tile_p, groups);
  return (int)cudaGetLastError();
}
