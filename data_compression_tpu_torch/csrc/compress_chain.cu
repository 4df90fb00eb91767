// The device compress pipeline of device_api.compress_blocks_device, enqueued
// by one host call: histogram -> code lengths and encode table -> compact
// encode -> compress_finish_kernel -> compaction, on one stream.
//
// Replaces no TPU kernel.  The pipeline's host enqueue was one Python
// wrapper a kernel (a device guard, a stream lookup, the library lock,
// ctypes conversion, one to three allocations: 50-125 us each on the
// H100's host, PERF.md) and six torch ops between the kernels, so the host
// and not the card set the pace of a 64 MiB call.  Here the wrapper's
// allocations are made once, by the caller, and the launches follow one
// another in C; each kernel's grid and block choice stays in its own
// source (launch.cuh).
//
// compress_finish_kernel takes the place of the six torch ops between the
// encode and the compaction (wire_bytes' two elementwise kernels, the int64
// cumsum's cast and two scans, the total's sum, the lengths' narrowing):
//   * CTA 0 scans block_bytes into ends (inclusive, int64) and writes
//     total = ends[B-1] (0 for no blocks), the offsets the compaction
//     reads;
//   * the other CTAs write nb = ceil(digits / D), D digits a wire byte,
//     and table_rows, the code lengths narrowed to uint8 (at most 255 by
//     the table build), four to a store.
// What bounds it: a few MiB read and written (about 1 us at the HBM rate
// at 64 MiB) and the scan's latency in one CTA; B is a few thousand blocks
// at most, so one CTA scans them.
//
// The temporaries (histograms, code lengths, the encode table, digit
// counts, block offsets) lie in one scratch allocation of the caller, of
// dct_compress_scratch_bytes(B, S/C, dense_mode) bytes, which the chain
// splits itself (Scratch below, the one place that lays it out).
//
// The caller's stamps: right after each launch of the histogram, the table
// build, the encode and the compaction, the host clock `clock_id` is read
// into stamps[0..3], the ends of the call recorder's stages
// (utils/tracing.py).  The finish kernel's launch belongs to the stage
// after the compaction: stamps[3] is the encode's stamp plus the
// compaction's launch alone.  stamps[4] has bit k set if the chain
// enqueued its k-th kernel in launch order (histogram, table build, encode,
// finish, compaction; one with no work is not launched), which the
// caller's launch counters read.

#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 1024;  // one CTA scans up to kThreads * kPer block counts a round
constexpr int kPer = 4;
constexpr int kMaxFinishCtas = 264;  // two waves of the H100's 132 SMs, grid-stride beyond

__global__ void __launch_bounds__(kThreads)
compress_finish_kernel(const int32_t* __restrict__ digits, const int32_t* __restrict__ block_bytes,
                       const int32_t* __restrict__ lengths, int32_t* __restrict__ nb,
                       int64_t* __restrict__ ends, int64_t* __restrict__ total,
                       uint8_t* __restrict__ table_rows, int B, int64_t chunks,
                       int digits_per_byte) {
  if (blockIdx.x == 0) {
    __shared__ int64_t warp_sums[kThreads / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int64_t carry = 0;
    for (int64_t base = 0; base < B; base += kThreads * kPer) {
      const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kPer;
      int64_t v[kPer];
      int64_t sum = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        sum += first + k < B ? block_bytes[first + k] : 0;
        v[k] = sum;  // inclusive within the thread
      }
      int64_t scan = sum;  // inclusive over the warp's threads
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t up = __shfl_up_sync(0xffffffffu, scan, o);
        if (lane >= o) scan += up;
      }
      if (lane == 31) warp_sums[warp] = scan;
      __syncthreads();
      if (warp == 0) {
        int64_t w = warp_sums[lane];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int64_t up = __shfl_up_sync(0xffffffffu, w, o);
          if (lane >= o) w += up;
        }
        warp_sums[lane] = w;  // inclusive over the warps
      }
      __syncthreads();
      const int64_t before = carry + (warp ? warp_sums[warp - 1] : 0) + scan - sum;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (first + k < B) ends[first + k] = before + v[k];
      }
      carry += warp_sums[kThreads / 32 - 1];
      __syncthreads();  // warp_sums is rewritten by the next round
    }
    if (threadIdx.x == 0) *total = carry;
    return;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x - 1) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x - 1) * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < chunks; i += stride) {
    nb[i] = (digits[i] + digits_per_byte - 1) / digits_per_byte;
  }
  const int64_t quads = static_cast<int64_t>(B) * 64;  // 256 lengths a block, 4 a quad
  const int4* len4 = reinterpret_cast<const int4*>(lengths);
  uint32_t* rows4 = reinterpret_cast<uint32_t*>(table_rows);
  for (int64_t i = tid; i < quads; i += stride) {
    const int4 l = len4[i];
    rows4[i] = (static_cast<uint32_t>(l.x) & 0xffu) | (static_cast<uint32_t>(l.y) & 0xffu) << 8 |
               (static_cast<uint32_t>(l.z) & 0xffu) << 16 |
               (static_cast<uint32_t>(l.w) & 0xffu) << 24;
  }
}

cudaError_t launch_finish(const void* digits, const void* block_bytes, const void* lengths,
                          void* nb, void* ends, void* total, void* table_rows, int B,
                          int64_t chunks, int digits_per_byte, cudaStream_t stream,
                          bool* launched) {
  const int64_t work = chunks > static_cast<int64_t>(B) * 64 ? chunks : static_cast<int64_t>(B) * 64;
  int64_t ctas = (work + kThreads - 1) / kThreads;
  if (ctas > kMaxFinishCtas) ctas = kMaxFinishCtas;
  compress_finish_kernel<<<static_cast<unsigned>(1 + ctas), kThreads, 0, stream>>>(
      static_cast<const int32_t*>(digits), static_cast<const int32_t*>(block_bytes),
      static_cast<const int32_t*>(lengths), static_cast<int32_t*>(nb),
      static_cast<int64_t*>(ends), static_cast<int64_t*>(total),
      static_cast<uint8_t*>(table_rows), B, chunks, digits_per_byte);
  return dct::launched_if(cudaGetLastError(), launched);
}

int64_t now_ns(int clock_id) {
  timespec ts;
  clock_gettime(static_cast<clockid_t>(clock_id), &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// The temporaries' offsets in the scratch, each 16-byte aligned.
struct Scratch {
  int64_t hist, lengths, dense, digits, ends, bytes;
};

int64_t align16(int64_t n) { return (n + 15) / 16 * 16; }

Scratch scratch_layout(int64_t B, int64_t ncb, int dense_mode) {
  Scratch s;
  s.hist = 0;                                        // [B, 256] int64
  s.lengths = s.hist + align16(B * 256 * 8);         // [B, 256] int32
  s.dense = s.lengths + align16(B * 256 * 4);        // [B, 256 * dense_mode] int32
  s.digits = s.dense + align16(B * 256 * 4 * dense_mode);  // [B, ncb] int32
  s.ends = s.digits + align16(B * ncb * 4);          // [B] int64
  s.bytes = s.ends + align16(B * 8);
  return s;
}

// The chain on the current device; -> the first launch error.
cudaError_t chain(const void* blocks, const void* raw_lens, int B, int S, int C, int parts,
                  void* scratch, int arity, int len_cap, int dense_mode, int shift,
                  int bits_per_digit, void* rows, int64_t row_cap, void* block_bytes, void* nb,
                  int digits_per_byte, void* total, void* table_rows, void* flat,
                  int64_t flat_cap, int clock_id, long long* stamps, cudaStream_t stream) {
  const Scratch at = scratch_layout(B, S / C, dense_mode);
  char* base = static_cast<char*>(scratch);
  void *hist = base + at.hist, *lengths = base + at.lengths, *dense = base + at.dense,
       *digits = base + at.digits, *ends = base + at.ends;
  bool launched[5] = {false, false, false, false, false};
  stamps[4] = 0;
  cudaError_t e = dct::launch_histogram(blocks, S, raw_lens, hist, B, S, parts, stream,
                                        &launched[0]);
  if (e == cudaSuccess) {
    stamps[0] = now_ns(clock_id);
    e = dct::launch_table_build(hist, lengths, dense, B, arity, len_cap, dense_mode, shift,
                                bits_per_digit, stream, &launched[1]);
  }
  if (e == cudaSuccess) {
    stamps[1] = now_ns(clock_id);
    e = dct::launch_huffman_encode(blocks, raw_lens, dense, rows, digits, block_bytes, B, S, C,
                                   row_cap, arity, stream, &launched[2]);
  }
  if (e == cudaSuccess) {
    stamps[2] = now_ns(clock_id);
    e = launch_finish(digits, block_bytes, lengths, nb, ends, total, table_rows, B,
                      static_cast<int64_t>(B) * (S / C), digits_per_byte, stream, &launched[3]);
  }
  if (e == cudaSuccess) {
    const int64_t t = now_ns(clock_id);
    e = dct::launch_compact(rows, ends, flat, B, row_cap, flat_cap, stream, &launched[4]);
    stamps[3] = stamps[2] + (now_ns(clock_id) - t);
  }
  for (int k = 0; k < 5; ++k) {
    if (launched[k]) stamps[4] |= 1LL << k;
  }
  return e;
}

}  // namespace

// Bytes of the chain's scratch for B blocks of ncb chunks and the table
// build's dense_mode.
extern "C" long long dct_compress_scratch_bytes(int B, int ncb, int dense_mode) {
  return scratch_layout(B, ncb, dense_mode).bytes;
}

// blocks [B, S] uint8 (contiguous, 16-byte aligned), raw_lens [B] int32 ->
// rows [B, row_cap] uint8, block_bytes [B] int32, nb [B, S/C] int32, total
// [] int64, table_rows [B, 256] uint8 (nb, table_rows 16-byte aligned), flat
// [flat_cap] uint8; scratch of dct_compress_scratch_bytes(B, S/C,
// dense_mode) bytes, 16-byte aligned; stamps [5] on the host; on `device`
// (restored after), stream `stream`.
extern "C" int dct_compress_chain(const void* blocks, const void* raw_lens, int B, int S, int C,
                                  int parts, void* scratch, int arity, int len_cap,
                                  int dense_mode, int shift, int bits_per_digit, void* rows,
                                  long long row_cap, void* block_bytes, void* nb,
                                  int digits_per_byte, void* total, void* table_rows, void* flat,
                                  long long flat_cap, int device, int clock_id,
                                  long long* stamps, void* stream) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = chain(blocks, raw_lens, B, S, C, parts, scratch, arity, len_cap, dense_mode, shift,
            bits_per_digit, rows, row_cap, block_bytes, nb, digits_per_byte, total, table_rows,
            flat, flat_cap, clock_id, stamps, static_cast<cudaStream_t>(stream));
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}
