// Paged KV gather: copy each slot's pool pages, in block-table order, into
// one contiguous view, out (B, maxp * page, H, D) from pool (P, page, H, D).
// Position i of slot b is page table[b, i / page], offset i % page.
//
// Replaces: src/repro/kernels/paged.py:paged_gather_kernel (Pallas body
// _gather_kernel); its plain reference is pool[table].reshape(...).
//
// What bounds it on an H100: bytes.  Every page of the table is read once
// and written once; at 8 slots x 16 pages of 16 positions, 4 KV heads of
// 64, float32, that is 2.1 MB each way, ~1.25 us at 3.35 TB/s.  It does no
// arithmetic.
//
// Design: the TPU kernel DMAs one page per grid step with the page id from
// scalar prefetch.  Here one block copies one (slot, table column) page:
// it reads its page id itself, clamps it into the pool as an XLA gather
// would, and copies the page's bytes with 16-byte vector loads and stores
// (neighbouring threads on neighbouring addresses).  The copy is dtype-
// blind: a page of float32, bfloat16 or int8 values is just page * H * D *
// itemsize bytes.  Where that count or an address is not a multiple of 16
// it falls back to 4-byte and then 1-byte words.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename W>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const W* __restrict__ pool, const int* __restrict__ table,
              W* __restrict__ out, int maxp, int num_pages,
              size_t page_words) {
  const int col = blockIdx.x, b = blockIdx.y;
  int pid = table[(size_t)b * maxp + col];
  pid = min(max(pid, 0), num_pages - 1);
  const W* src = pool + (size_t)pid * page_words;
  W* dst = out + ((size_t)b * maxp + col) * page_words;
  for (size_t i = threadIdx.x; i < page_words; i += blockDim.x) dst[i] = src[i];
}

template <typename W>
cudaError_t launch(const void* pool, const int* table, void* out, int B,
                   int maxp, int num_pages, size_t page_bytes,
                   cudaStream_t stream) {
  dim3 grid(maxp, B);
  gather_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const W*>(pool), table, static_cast<W*>(out), maxp,
      num_pages, page_bytes / sizeof(W));
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pool: (num_pages, page_bytes) bytes; table: (B, maxp) int32;
// out: (B, maxp, page_bytes) bytes.  All contiguous.  Returns a cudaError_t.
extern "C" int paged_gather(const void* pool, const void* table, void* out,
                            int B, int maxp, int num_pages,
                            long long page_bytes, void* stream) {
  if (B <= 0 || maxp <= 0 || num_pages <= 0 || page_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  const auto addr = reinterpret_cast<uintptr_t>(pool) |
                    reinterpret_cast<uintptr_t>(out);
  const auto pb = static_cast<size_t>(page_bytes);
  const int* t = static_cast<const int*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pb % 16 == 0 && addr % 16 == 0)
    return (int)launch<uint4>(pool, t, out, B, maxp, num_pages, pb, s);
  if (pb % 4 == 0 && addr % 4 == 0)
    return (int)launch<uint32_t>(pool, t, out, B, maxp, num_pages, pb, s);
  return (int)launch<uint8_t>(pool, t, out, B, maxp, num_pages, pb, s);
}
