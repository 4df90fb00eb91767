// Per-block byte histograms: [B, S] uint8 rows, row b valid up to
// lengths[b], -> [B, 256] int64 counts.
//
// Replaces data_compression_tpu/ops/histogram.py `block_histograms` (no
// Pallas kernel: a one-hot matmul factorised for the TPU's matrix unit).
// The port first ran it as an `index_add_` of B*S int64 ones, whose
// global atomics took 1.7-2.0 ms at 64 MiB.
//
// What bounds it on the card: bytes, S per row read once and 2 KiB of
// counts written (64 MiB in: 0.0207 ms at 3.35 TB/s), if the counting
// keeps up with the loads.  Design:
//   * one CTA of 256 threads walks one slice of one row (grid B x slices;
//     the wrapper picks slices so that a small B still fills the card);
//   * 16-byte loads from the first 16-byte aligned address of the slice,
//     single bytes before it and after the last whole vector, so any row
//     base, row stride and S work;
//   * bins in shared memory, two copies per warp (lane l counts into copy
//     l % 2), so only the lanes of one warp that share a copy contend for
//     a bin: in text, lanes that see the same letter (a space, 'e') do.
//     The copies start 8 banks apart, so one value in two copies is two
//     banks.  One copy a warp measured slower on text, and four (34 KiB a
//     CTA) no longer fit 1024 CTAs on the card at once (PERF.md);
//   * each thread keeps the value of its last byte and a run count in
//     registers, and adds to a bin only when the value changes: a row of
//     one byte value (zero padding, a sparse file), whose increments would
//     otherwise all hit one shared address, costs one atomic per thread;
//   * the warps' copies are summed and written as int64; with several
//     slices per row the output is zeroed on the stream first and each
//     slice adds its counts with global atomics (256 per CTA).
// No host read and no allocation: the launch goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCopies = 2;  // copies of the bins per warp
constexpr int kStride = 256 + 8;  // words between copies of the bins: 8 banks of skew
constexpr uint32_t kNone = 0xffffffffu;  // no byte seen yet

struct Run {
  uint32_t value = kNone;
  uint32_t count = 0;
};

__device__ __forceinline__ void count_byte(uint32_t* bins, Run& r, uint32_t v) {
  const bool same = v == r.value;
  if (!same && r.count) atomicAdd(&bins[r.value], r.count);
  r.count = same ? r.count + 1 : 1;
  r.value = v;
}

__device__ __forceinline__ void count_word(uint32_t* bins, Run& r, uint32_t w) {
#pragma unroll
  for (int j = 0; j < 4; ++j) count_byte(bins, r, (w >> (8 * j)) & 0xffu);
}

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const uint8_t* __restrict__ blocks, int64_t row_stride,
                 const int32_t* __restrict__ lengths, unsigned long long* __restrict__ out,
                 int64_t S, int slices, int64_t span) {
  constexpr int kBins = kWarps * kCopies;
  __shared__ uint32_t bins[kBins * kStride];
  const int tid = threadIdx.x;
  const int row = blockIdx.x / slices;
  const int slice = blockIdx.x - row * slices;
  for (int i = tid; i < kBins * kStride; i += kThreads) bins[i] = 0;
  __syncthreads();

  const int64_t n = min(max(static_cast<int64_t>(lengths[row]), int64_t{0}), S);
  const int64_t lo = min(slice * span, n);
  const int64_t hi = min(lo + span, n);
  const uint8_t* base = blocks + row * row_stride;
  uint32_t* mine = bins + ((tid >> 5) * kCopies + (tid & (kCopies - 1))) * kStride;
  Run r;

  // head bytes up to the first 16-byte aligned address, whole vectors, tail
  const int64_t head =
      min(static_cast<int64_t>((16 - (reinterpret_cast<uintptr_t>(base + lo) & 15)) & 15), hi - lo);
  const int64_t body = lo + head;
  const int64_t nvec = (hi - body) >> 4;
  if (tid < head) count_byte(mine, r, base[lo + tid]);
  const uint4* vec = reinterpret_cast<const uint4*>(base + body);
  int64_t i = tid;
  for (; i + kThreads < nvec; i += 2 * kThreads) {  // two loads in flight
    const uint4 a = __ldg(vec + i);
    const uint4 b = __ldg(vec + i + kThreads);
    count_word(mine, r, a.x);
    count_word(mine, r, a.y);
    count_word(mine, r, a.z);
    count_word(mine, r, a.w);
    count_word(mine, r, b.x);
    count_word(mine, r, b.y);
    count_word(mine, r, b.z);
    count_word(mine, r, b.w);
  }
  if (i < nvec) {
    const uint4 a = __ldg(vec + i);
    count_word(mine, r, a.x);
    count_word(mine, r, a.y);
    count_word(mine, r, a.z);
    count_word(mine, r, a.w);
  }
  for (int64_t t = body + (nvec << 4) + tid; t < hi; t += kThreads) count_byte(mine, r, base[t]);
  if (r.count) atomicAdd(&mine[r.value], r.count);
  __syncthreads();

  for (int v = tid; v < 256; v += kThreads) {
    unsigned long long sum = 0;
#pragma unroll
    for (int c = 0; c < kBins; ++c) sum += bins[c * kStride + v];
    if (slices == 1) {
      out[static_cast<int64_t>(row) * 256 + v] = sum;
    } else if (sum) {
      atomicAdd(&out[static_cast<int64_t>(row) * 256 + v], sum);
    }
  }
}

}  // namespace

extern "C" int dct_histogram(const void* blocks, long long row_stride, const void* lengths,
                             void* out, int B, long long S, int slices, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  if (slices < 1) slices = 1;
  if (slices > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, static_cast<size_t>(B) * 256 * 8, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t span = ((S + slices - 1) / slices + 15) & ~int64_t{15};
  histogram_kernel<<<static_cast<unsigned>(B) * static_cast<unsigned>(slices), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(blocks), row_stride, static_cast<const int32_t*>(lengths),
      static_cast<unsigned long long*>(out), S, slices, span);
  return static_cast<int>(cudaGetLastError());
}
