// Block payload compaction: copy rows[b, :block_bytes[b]] to
// flat[starts[b]:], one CTA per block.
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/compact_kernel.py
// `compact_block_rows`, which made ordered DMA copies of fixed-width rows
// to 4 KiB-aligned offsets (a Mosaic DMA granularity rule) and let each
// later copy overwrite the garbage tail of the one before.  Here the
// offsets are tight (starts = exclusive cumsum of the exact block byte
// totals, taken by the wrapper with torch.cumsum) and each CTA copies only
// its block's valid bytes, so blocks can run in any order.
//
// What bounds it on the card: pure data movement, about 2x the compressed
// bytes (read + write).  Design: consecutive threads copy consecutive
// addresses (coalesced); where source and destination are both 16-byte
// aligned the copy moves uint4 words, otherwise bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ rows,
               const int64_t* __restrict__ starts,
               const int32_t* __restrict__ block_bytes,
               uint8_t* __restrict__ flat, int64_t row_cap) {
  const int b = blockIdx.x;
  const int64_t n = min(static_cast<int64_t>(max(block_bytes[b], 0)), row_cap);
  const uint8_t* src = rows + static_cast<int64_t>(b) * row_cap;
  uint8_t* dst = flat + starts[b];
  int64_t done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15u) == 0) {
    const int64_t n16 = n >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t i = threadIdx.x; i < n16; i += kThreads) d4[i] = s4[i];
    done = n16 << 4;
  }
  for (int64_t i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

}  // namespace

extern "C" int dct_compact(const void* rows, const void* starts,
                           const void* block_bytes, void* flat, int B,
                           long long row_cap, void* stream) {
  if (B > 0) {
    compact_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), static_cast<const int64_t*>(starts),
        static_cast<const int32_t*>(block_bytes), static_cast<uint8_t*>(flat),
        static_cast<int64_t>(row_cap));
  }
  return static_cast<int>(cudaGetLastError());
}
