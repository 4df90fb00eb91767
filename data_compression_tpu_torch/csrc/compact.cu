// Block payload compaction: rows[b, :n_b] back to back in flat, in block
// order, at tight offsets (n_b = ends[b] - ends[b-1], ends the inclusive
// cumsum of the block byte totals, taken by the wrapper).
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/compact_kernel.py
// `compact_block_rows`, which made ordered DMA copies of fixed-width rows
// to 4 KiB-aligned offsets (a Mosaic DMA granularity rule) and let each
// later copy overwrite the garbage tail of the one before.  Here the
// offsets are tight, so about 15 of 16 blocks start off the 16-byte grid
// of flat.
//
// What bounds it on the card: pure data movement, the payload bytes read
// once and written once.  Design: the output is tiled, not the blocks.
// Each CTA owns kTileWords 16-byte words of flat (16 KiB), on the 16-byte
// grid of flat's address, so every word is written once, by one thread,
// with one uint4 store, whatever the block offsets; only the two edge
// words of flat are written a byte at a time.  A word whose 16 bytes lie
// in one block reads the one or two aligned uint4 words of the row that
// cover them (__ldg; neighbouring threads share one of them through L1)
// and shifts them together in registers: the shift is constant over a
// block, so any source and destination alignment costs a few selects and
// four funnel shifts per 16 bytes.  A word that straddles block
// boundaries (about one per block, more where blocks are under 16 bytes)
// gathers its bytes one at a time.  Each thread issues the loads of its
// kUnroll words before it stores any.  A CTA finds the block of its first
// byte by a 32-way warp search of ends; each word moves forward from
// there by a galloping search, one L1 read on the main path.
//
// flat may be longer than the payload (the device pipeline hands the
// kernel its whole capacity, and zeros past the payload are its
// contract): a word wholly at or past the payload's end, ends[B-1], is
// stored as a uint4 of zeros with no search, so the tail costs its stores
// alone; only the one word that straddles the end gathers its bytes.  A
// caller that passes the exact total has no such word.
//
// Nothing is read outside an aligned 16-byte word that holds a byte of a
// block's valid row range, and nothing is written outside flat[0, total).
// Counts outside [0, row_cap] are clamped (the wrapper rejects them first
// unless the caller vouches for them); bytes with no source are 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kTileWords = kThreads * kUnroll;

// First b in [lo, hi) with ends[b] > p, or hi (ends nondecreasing), by
// the whole warp: each round samples 32 evenly spaced entries.
__device__ int warp_upper_bound(const int64_t* __restrict__ ends, int lo, int hi, int64_t p) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int span = hi - lo;
    const int step = span > 32 ? (span + 31) / 32 : 1;
    const int idx = lo + lane * step;
    const unsigned above = __ballot_sync(0xffffffffu, idx >= hi || __ldg(ends + idx) > p);
    if (span <= 32) return above ? lo + __ffs(above) - 1 : hi;
    if (above & 1u) return lo;
    if (above == 0) {
      lo += 31 * step + 1;
      continue;
    }
    const int k = __ffs(above) - 1;  // ends[lo + (k-1)*step] <= p < ends[lo + k*step]
    hi = min(hi, lo + k * step);
    lo += (k - 1) * step + 1;
  }
}

// First x >= b with ends[x] > p, or B, for an answer >= b: gallop, then bisect.
__device__ __forceinline__ int seek(const int64_t* __restrict__ ends, int b, int B, int64_t p) {
  if (b >= B || __ldg(ends + b) > p) return b;
  int lo = b + 1, hi;
  int64_t step = 1;
  for (;;) {  // ends[lo - 1] <= p
    if (step > B - lo) {
      hi = B;
      break;
    }
    hi = lo + static_cast<int>(step) - 1;
    if (__ldg(ends + hi) > p) break;
    lo = hi + 1;
    step <<= 1;
  }
  while (lo < hi) {  // the answer is in [lo, hi]
    const int mid = (lo + hi) >> 1;
    if (__ldg(ends + mid) > p) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Block b's bytes sit at flat[start, lim); its row holds them from byte 0.
__device__ __forceinline__ void block_span(const int64_t* __restrict__ ends, int b,
                                           int64_t row_cap, int64_t& start, int64_t& lim) {
  start = b ? __ldg(ends + b - 1) : 0;
  lim = start + min(max(__ldg(ends + b) - start, static_cast<int64_t>(0)), row_cap);
}

// Bytes s .. s+15 of the 32 bytes x:y (little-endian lanes).
__device__ __forceinline__ uint4 realign(uint4 x, uint4 y, int s) {
  uint32_t a0 = x.x, a1 = x.y, a2 = x.z, a3 = x.w, a4 = y.x, a5 = y.y, a6 = y.z, a7 = y.w;
  if (s & 8) {
    a0 = a2; a1 = a3; a2 = a4; a3 = a5; a4 = a6; a5 = a7;
  }
  if (s & 4) {
    a0 = a1; a1 = a2; a2 = a3; a3 = a4; a4 = a5;
  }
  const unsigned sh = 8u * (s & 3);
  return make_uint4(__funnelshift_r(a0, a1, sh), __funnelshift_r(a1, a2, sh),
                    __funnelshift_r(a2, a3, sh), __funnelshift_r(a3, a4, sh));
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint8_t* __restrict__ rows, const int64_t* __restrict__ ends,
               uint8_t* __restrict__ flat, int B, int64_t row_cap, int64_t total) {
  __shared__ int first_block;
  // word w covers flat[16w - head, 16w - head + 16)
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(flat) & 15u);
  uint4* out = reinterpret_cast<uint4*>(flat - head);
  const int64_t nwords = (total + head + 15) >> 4;
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * kTileWords;
  const int64_t payload_end = B ? __ldg(ends + B - 1) : 0;  // zeros from here on
  if (threadIdx.x < 32) {
    const int b = warp_upper_bound(ends, 0, B, max(16 * w0 - head, static_cast<int64_t>(0)));
    if (threadIdx.x == 0) first_block = b;
  }
  __syncthreads();
  const int b0 = first_block;

  // pass 1: find each word's block; a word inside one block loads its source
  uint4 lo[kUnroll], hi[kUnroll];
  int shift[kUnroll];
  bool whole[kUnroll];
  int b = b0;
  int64_t start = 0, lim = -1;  // block b's span, once looked up
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t w = w0 + u * kThreads + threadIdx.x;
    const int64_t q = 16 * w - head;
    whole[u] = false;
    shift[u] = 0;
    lo[u] = hi[u] = make_uint4(0u, 0u, 0u, 0u);
    if (q < 0 || q + 16 > total) continue;
    if (q >= payload_end) {  // past the payload: zeros
      whole[u] = true;
      continue;
    }
    if (q < start || q + 16 > lim) {  // not inside the last word's block
      b = seek(ends, b, B, q);
      if (b < B) {
        block_span(ends, b, row_cap, start, lim);
      } else {
        lim = -1;
      }
    }
    if (q >= start && q + 16 <= lim) {
      const uint8_t* src = rows + static_cast<int64_t>(b) * row_cap + (q - start);
      const int s = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15u);
      const uint4* a = reinterpret_cast<const uint4*>(src - s);
      lo[u] = __ldg(a);
      if (s) hi[u] = __ldg(a + 1);  // holds byte 15 of the word: inside the row
      shift[u] = s;
      whole[u] = true;
    }
  }

  // pass 2: store; straddling and edge words gather their bytes one at a time
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t w = w0 + u * kThreads + threadIdx.x;
    if (w >= nwords) continue;
    if (whole[u]) {
      out[w] = realign(lo[u], hi[u], shift[u]);
      continue;
    }
    const int64_t q = 16 * w - head;
    const bool edge = q < 0 || q + 16 > total;
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
    int bb = b0;
    for (int j = 0; j < 16; ++j) {
      const int64_t p = q + j;
      uint32_t byte = 0;
      if (p >= 0 && p < total) {
        bb = p < payload_end ? seek(ends, bb, B, p) : B;
        if (bb < B) {
          int64_t first, end;
          block_span(ends, bb, row_cap, first, end);
          if (p >= first && p < end) {
            byte = __ldg(rows + static_cast<int64_t>(bb) * row_cap + (p - first));
          }
        }
        if (edge) flat[p] = static_cast<uint8_t>(byte);
      }
      r0 = __funnelshift_r(r0, r1, 8);
      r1 = __funnelshift_r(r1, r2, 8);
      r2 = __funnelshift_r(r2, r3, 8);
      r3 = (r3 >> 8) | (byte << 24);
    }
    if (!edge) out[w] = make_uint4(r0, r1, r2, r3);
  }
}

}  // namespace

cudaError_t dct::launch_compact(const void* rows, const void* ends, void* flat, int B,
                                int64_t row_cap, int64_t total, cudaStream_t stream,
                                bool* launched) {
  if (total <= 0) return cudaGetLastError();
  const int64_t head = static_cast<int64_t>(reinterpret_cast<uintptr_t>(flat) & 15u);
  const int64_t tiles = ((total + head + 15) / 16 + kTileWords - 1) / kTileWords;
  compact_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(rows), static_cast<const int64_t*>(ends),
      static_cast<uint8_t*>(flat), B, row_cap, total);
  return dct::launched_if(cudaGetLastError(), launched);
}

extern "C" int dct_compact(const void* rows, const void* ends, void* flat, int B,
                           long long row_cap, long long total, void* stream) {
  return static_cast<int>(dct::launch_compact(rows, ends, flat, B, row_cap, total,
                                              static_cast<cudaStream_t>(stream)));
}
