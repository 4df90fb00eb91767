// uint8 pass-through copy: the dispatch and memory floor of a kernel that
// reads its input once and writes its output once.
//
// Replaces the TPU kernel tools/ablate.py `copy_call` (body `copy_kernel`),
// which copied each [1, 512, 128] u8 block through VMEM with one grid step
// per block.  On the card the block structure means nothing to a copy:
// the bytes are one flat range.
//
// What bounds it on the card: bytes only (each byte read once and written
// once, 2 x 64 MiB at the profiling tool's size, about 40 us at
// 3.35 TB/s).  Design: a grid sized by the data, each CTA one contiguous
// 16 KiB tile, each of its 1024 threads one 16-byte word, loaded with an
// evict-first hint (`__ldcs`) and written with a streaming store
// (`__stcs`).  A tail of fewer than 16 bytes is copied byte by byte by the
// last CTA.
//
// Why the first version (a grid-stride loop, 8 CTAs x 256 threads per SM,
// 4 words in flight per thread, plain loads and stores) lost 7-9% to
// `Tensor.copy_` (PERF.md): on one H100, a sweep of tile shapes and cache
// hints found each of its choices slower than the one above: plain instead
// of streaming loads and stores, several words per thread (fewer, longer
// CTAs), a grid-stride or persistent grid.  A ring of shared-memory stages
// filled and drained by the bulk-copy engine (cp.async.bulk, one CTA per
// SM) was slower still.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // 16-byte words per CTA

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n16,
            const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
            int tail) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n16) __stcs(dst + i, __ldcs(src + i));
  if (blockIdx.x == gridDim.x - 1 && static_cast<int>(threadIdx.x) < tail) {
    dst_tail[threadIdx.x] = src_tail[threadIdx.x];
  }
}

}  // namespace

extern "C" int dct_copy(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes > 0) {
    const int64_t n16 = static_cast<int64_t>(nbytes) >> 4;
    const int tail = static_cast<int>(nbytes & 15);
    const int64_t tiles = (n16 + kThreads - 1) / kThreads;
    const auto* s = static_cast<const uint8_t*>(src);
    auto* d = static_cast<uint8_t*>(dst);
    copy_kernel<<<static_cast<unsigned>(tiles > 0 ? tiles : 1), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint4*>(s), reinterpret_cast<uint4*>(d), n16,
        s + (n16 << 4), d + (n16 << 4), tail);
  }
  return static_cast<int>(cudaGetLastError());
}
