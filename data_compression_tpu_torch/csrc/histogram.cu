// Per-block byte histograms: [B, S] uint8 rows, row b valid up to
// lengths[b], -> [B, 256] int64 counts.
//
// Replaces data_compression_tpu/ops/histogram.py `block_histograms` (no
// Pallas kernel: a one-hot matmul factorised for the TPU's matrix unit).
// The port first ran it as an `index_add_` of B*S int64 ones, whose
// global atomics took 1.7-2.0 ms at 64 MiB.
//
// What bounds it on the card: bytes, S per row read once and 2 KiB of
// counts written (64 MiB in: 0.0200 ms at 3.35 TB/s), if the counting
// keeps up with the loads: 13 bytes a cycle on each SM.  The SASS of a
// byte has to stay short and not depend on the data.  Design:
//   * thread-private 8-bit counters, four to a 32-bit word in shared
//     memory: thread t's counter of value v is byte (v & 3) of word
//     (v >> 2) * 64 + t, so the 32 lanes of a warp always hit 32 banks
//     and no two threads share a counter, whatever the data (text, one
//     value, a period of 16);
//   * a byte is one shared atomic add whose result is not read (`ATOMS`,
//     1 << 8 (v & 3) into the word), so no byte waits for the one
//     before it: a load, add and store of the counter ran 1.66x slower,
//     each byte's load issued after the store before it (they may
//     alias) and its add waiting out the load's latency (PERF.md);
//   * the word's address is one `prmt` per byte: per 4-byte word one
//     shift and `lop3` put v >> 2 in each byte, and the permute takes
//     t << 2 for the low byte, byte j for the next and its sign (always
//     0) for the high half; the increment's shift, 8 (v & 3), is one
//     shift and `lop3` per word and a funnel shift per byte;
//   * a CTA is two warps (16 KiB of counters); each round a thread
//     counts up to sixteen 16-byte vectors (a warp reads 512 contiguous
//     bytes a load), so a counter takes at most 255 of its 256 bytes: the
//     round's 256th byte of a thread, and the bytes before the first and
//     after the last whole vector (any row base, stride and S), go to a
//     shared 32-bit bin.  More loads in flight (2 or 4 a thread) ran no
//     faster: the shared atomics bind, about one warp-wide `ATOMS` every
//     4 cycles an SM as inferred from the readings (PERF.md);
//   * after a round the counters are flushed: thread t sums the 64
//     counter words of values 4t..4t+3 (16 conflict-free 16-byte loads,
//     the bytes added in 16-bit pairs) into four 32-bit sums it keeps in
//     registers, and zeroes them;
//   * a batch of fewer rows than SMs has each row cut into `parts` (2, 4
//     or 8): the parts of a row are one thread-block cluster, and its
//     first CTA adds the others' sums through distributed shared memory
//     and writes the row's int64 counts, with no memset and no global
//     atomic.
// No host read and no allocation: the launch goes on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;                    // thread t owns values 4t..4t+3 at the flush
constexpr int kVecs = 16;                       // 16-byte vectors a thread counts a round
constexpr int64_t kRoundVecs = kThreads * kVecs;  // 16 KiB a round
constexpr int kCounterBytes = 256 * kThreads;   // 16 KiB of 8-bit counters
constexpr int kMaxParts = 8;                    // portable cluster size
constexpr int kCtasPerSm = 12;                  // 17 KiB of shared memory a CTA

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// Count the bytes of word w from byte kFrom on; t4 = (tid << 2) in every byte.
template <int kFrom>
__device__ __forceinline__ void count_word(uint8_t* counters, uint32_t w, uint32_t t4) {
  const uint32_t hi = (w >> 2) & 0x3f3f3f3fu;  // v >> 2: address bits 8-13
  const uint32_t sh = (w << 3) & 0x18181818u;  // 8 (v & 3): the counter's bit in its word
  auto add = [&](uint32_t sel, uint32_t shift) {
    atomicAdd(reinterpret_cast<uint32_t*>(counters + prmt(t4, hi, sel)),
              __funnelshift_l(0u, 1u, shift));  // 1 << (shift & 31)
  };
  if (kFrom <= 0) add(0xCC40u, sh);
  if (kFrom <= 1) add(0xDD50u, sh >> 8);
  add(0xEE60u, sh >> 16);
  add(0xFF70u, sh >> 24);
}

// One round: vectors first + k * kThreads + tid, k < kVecs, below nvec.
template <bool kFull>
__device__ __forceinline__ void count_round(const uint4* __restrict__ vec, int64_t first,
                                            int64_t nvec, uint8_t* counters, uint32_t* extra,
                                            uint32_t t4, int tid) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int64_t i = first + k * kThreads + tid;
    if (kFull || i < nvec) {
      const uint4 a = __ldg(vec + i);
      if (k == kVecs - 1) {  // the thread's 256th byte of the round
        atomicAdd(&extra[a.x & 0xffu], 1u);
        count_word<1>(counters, a.x, t4);
      } else {
        count_word<0>(counters, a.x, t4);
      }
      count_word<0>(counters, a.y, t4);
      count_word<0>(counters, a.z, t4);
      count_word<0>(counters, a.w, t4);
    }
  }
}

// Add values 4t..4t+3's counters of every thread into sum[], zero them.
__device__ __forceinline__ void flush(uint8_t* counters, int tid, uint32_t (&sum)[4]) {
  uint4* row = reinterpret_cast<uint4*>(counters + tid * 256);
  uint32_t even = 0, odd = 0;  // 16-bit pairs: values 4t, 4t+2 / 4t+1, 4t+3
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int q = (m + tid) & 15;  // 8 lanes of a phase read 8 bank quads
    const uint4 c = row[q];
    row[q] = make_uint4(0, 0, 0, 0);
    even += (c.x & 0x00ff00ffu) + (c.y & 0x00ff00ffu) + (c.z & 0x00ff00ffu) + (c.w & 0x00ff00ffu);
    odd += ((c.x >> 8) & 0x00ff00ffu) + ((c.y >> 8) & 0x00ff00ffu) + ((c.z >> 8) & 0x00ff00ffu) +
           ((c.w >> 8) & 0x00ff00ffu);
  }
  sum[0] += even & 0xffffu;
  sum[1] += odd & 0xffffu;
  sum[2] += even >> 16;
  sum[3] += odd >> 16;
}

__global__ void __launch_bounds__(kThreads, kCtasPerSm)
histogram_kernel(const uint8_t* __restrict__ blocks, int64_t row_stride,
                 const int32_t* __restrict__ lengths, unsigned long long* __restrict__ out,
                 int64_t S, int parts, int64_t span) {
  __shared__ __align__(16) uint8_t counters[kCounterBytes];
  __shared__ __align__(16) uint32_t extra[256];
  const int tid = threadIdx.x;
  const int row = blockIdx.x / parts;
  const int part = blockIdx.x - row * parts;  // the CTA's rank in its cluster
#pragma unroll
  for (int i = tid; i < kCounterBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(counters)[i] = make_uint4(0, 0, 0, 0);
  reinterpret_cast<uint4*>(extra)[tid] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int64_t n = min(max(static_cast<int64_t>(lengths[row]), int64_t{0}), S);
  const int64_t lo = min(part * span, n);
  const int64_t hi = min(lo + span, n);
  const uint8_t* base = blocks + row * row_stride;

  // head bytes up to the first 16-byte aligned address, whole vectors, tail
  const int64_t head =
      min(static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(base + lo) & 15)) & 15), hi - lo);
  const int64_t body = lo + head;
  const int64_t nvec = (hi - body) >> 4;
  if (tid < head) atomicAdd(&extra[base[lo + tid]], 1u);
  const int64_t tail = body + (nvec << 4);
  if (tail + tid < hi) atomicAdd(&extra[base[tail + tid]], 1u);

  const uint4* vec = reinterpret_cast<const uint4*>(base + body);
  const uint32_t t4 = static_cast<uint32_t>(tid << 2) * 0x01010101u;
  uint32_t sum[4] = {0, 0, 0, 0};
  int64_t r = 0;
  for (; r + kRoundVecs <= nvec; r += kRoundVecs) {
    count_round<true>(vec, r, nvec, counters, extra, t4, tid);
    __syncthreads();
    flush(counters, tid, sum);
    __syncthreads();
  }
  if (r < nvec) {
    count_round<false>(vec, r, nvec, counters, extra, t4, tid);
    __syncthreads();
    flush(counters, tid, sum);
  }
  __syncthreads();
  uint4 mine = reinterpret_cast<const uint4*>(extra)[tid];
  mine.x += sum[0];
  mine.y += sum[1];
  mine.z += sum[2];
  mine.w += sum[3];

  if (parts > 1) {  // the cluster's first CTA adds up the row
    cg::cluster_group cluster = cg::this_cluster();
    reinterpret_cast<uint4*>(extra)[tid] = mine;  // the slot this thread read
    cluster.sync();
    if (part == 0) {
      for (int q = 1; q < parts; ++q) {
        const uint4 o = cluster.map_shared_rank(reinterpret_cast<uint4*>(extra), q)[tid];
        mine.x += o.x;
        mine.y += o.y;
        mine.z += o.z;
        mine.w += o.w;
      }
    }
    cluster.sync();  // no CTA leaves while its sums may still be read
    if (part != 0) return;
  }
  ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + static_cast<int64_t>(row) * 256 + 4 * tid);
  dst[0] = make_ulonglong2(mine.x, mine.y);
  dst[1] = make_ulonglong2(mine.z, mine.w);
}

}  // namespace

cudaError_t dct::launch_histogram(const void* blocks, int64_t row_stride, const void* lengths,
                                  void* out, int B, int64_t S, int parts, cudaStream_t stream,
                                  bool* launched) {
  if (B <= 0) return cudaGetLastError();
  if (parts < 1 || parts > kMaxParts) return cudaErrorInvalidValue;
  const int64_t span = ((S + parts - 1) / parts + 15) & ~int64_t{15};
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(parts);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * static_cast<unsigned>(parts));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, histogram_kernel, static_cast<const uint8_t*>(blocks), row_stride,
      static_cast<const int32_t*>(lengths), static_cast<unsigned long long*>(out), S, parts, span);
  if (e != cudaSuccess) return e;
  return dct::launched_if(cudaGetLastError(), launched);
}

extern "C" int dct_histogram(const void* blocks, long long row_stride, const void* lengths,
                             void* out, int B, long long S, int parts, void* stream) {
  return static_cast<int>(dct::launch_histogram(blocks, row_stride, lengths, out, B, S, parts,
                                                static_cast<cudaStream_t>(stream)));
}
