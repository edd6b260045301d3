// TF32 tensor-core helpers shared by bc_fused.cu and spectral_matmul.cu:
// rounding to TF32, the 3xTF32 split, and one mma.sync m16n8k8 product.
//
// 3xTF32 keeps float32 accuracy on the TF32 tensor cores: a = hi + lo with
// hi = tf32(a) and lo = tf32(a - hi), and a b ~ hi_a hi_b + lo_a hi_b +
// hi_a lo_b (lo_a lo_b, ~2^-22 of the product, is dropped).  One TF32
// product alone keeps about three decimal digits.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

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

// The same split in integer operations, for a kernel whose TF32
// conversions would otherwise set its pace (cvt issues at a fraction of
// the ALU rate): hi rounds to nearest, ties away from zero, as cvt.rna
// does (add half of the 13 dropped bits, clear them); lo = v - hi is exact
// and goes to the tensor cores as float32 bits, of which they read the
// top 19 (lo truncated to TF32: an error of at most 2^-22 of v).
__device__ __forceinline__ void split_tf32_alu(float v, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a b on the tensor cores (TF32 inputs, float32 sums)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
