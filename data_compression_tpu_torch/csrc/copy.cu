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
// 3.35 TB/s).  Design: a grid-stride loop of 16-byte `uint4` loads and
// stores, 256 threads per CTA and 8 CTAs per SM on 132 SMs (full
// occupancy), each thread issuing 4 independent loads before its 4 stores
// to keep enough bytes in flight; consecutive threads on consecutive
// 16-byte words.  A tail of fewer than 16 bytes is copied byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtasPerSm = 8;
constexpr int kSms = 132;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, int64_t n16,
            const uint8_t* __restrict__ src_tail, uint8_t* __restrict__ dst_tail,
            int tail) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n16; i += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < n16; i += stride) dst[i] = src[i];
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < tail) dst_tail[t] = src_tail[t];
}

}  // namespace

extern "C" int dct_copy(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes > 0) {
    const int64_t n16 = static_cast<int64_t>(nbytes) >> 4;
    const int tail = static_cast<int>(nbytes & 15);
    const int64_t want = (n16 + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(want < kSms * kCtasPerSm ? (want > 0 ? want : 1)
                                                               : kSms * kCtasPerSm);
    const auto* s = static_cast<const uint8_t*>(src);
    auto* d = static_cast<uint8_t*>(dst);
    copy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const uint4*>(s), reinterpret_cast<uint4*>(d), n16,
        s + (n16 << 4), d + (n16 << 4), tail);
  }
  return static_cast<int>(cudaGetLastError());
}
