// Canonical Huffman chunk encode, n = 2, one CTA per block.
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/encode_kernel.py
// `_encode_pallas_compact` (body `_make_kernel(compact=True)`, cross-lane
// concat `_concat_stage`): per block, look each symbol up in a dense
// 256-entry table, drop positions past the block's raw length, and write
// the block's chunk payloads back to back (byte-aligned chunks) into one
// row, plus the digit count of every chunk.
//
// Wire format (n = 2): a dense entry is `code | (ndigits << 15)` with the
// code's stream digit m at bit m (MSB of the code first).  Stream digit j
// of a chunk is bit (j & 7) of byte (j >> 3); the last byte is zero-padded.
//
// What bounds it on the card: the 64 MiB input is read twice (once per
// pass) and about 0.6x of it is written, so the memory floor is tens of
// microseconds; this first version is bound instead by each thread's
// serial walk over its chunk (a dependent shared-memory lookup and a
// bit-buffer update per symbol).  Design against that: the block's table
// lives in shared memory; each thread reads its chunk 16 bytes at a time;
// 128 threads per CTA and one CTA per block put 1024 CTAs in flight at
// 64 MiB to hide the latency.  The merge trees, chunk-per-lane layout and
// max-length buckets of the TPU kernel existed for Mosaic and are gone:
// a CTA exclusive scan over chunk byte counts places each chunk directly.
//
// Pass (a): sum code lengths per chunk -> digits[b, k], byte counts.
// CTA exclusive scan of the byte counts -> byte offset of each chunk.
// Pass (b): re-walk the chunk, OR `code << nbits` into a 64-bit buffer and
// store whole bytes at the chunk's offset in rows[b, :].
//
// A second kernel, `huffman_encode_rows_kernel`, replaces the TPU kernel
// data_compression_tpu/ops/pallas/encode_kernel.py `_encode_pallas` (body
// `_make_kernel(compact=False)`): the same lookup, but chunk k of block b
// goes to its own fixed-stride row b * (S / C) + k of `mb` bytes
// (mb = max_chunk_bytes(C, 2)), the layout the sharded pipeline gathers
// across ranks.  With a fixed row per chunk no scan is needed: one pass,
// each thread owns one chunk (k = tid, tid + 128, ...), counts its digits
// and emits its bytes from the same 64-bit buffer.  It is bound the same
// way as the compact kernel (a serial walk per thread), with one read of
// the input instead of two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLenShift = 15;  // PACKED_LEN_SHIFT[2]
constexpr uint32_t kCodeMask = (1u << kLenShift) - 1u;
// Digit counts are at most 15 (ARITY_MAX_LEN[2]); masking to 4 bits keeps
// every chunk within max_chunk_bytes even for a malformed table.
constexpr uint32_t kLenMask = 0xFu;

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> ((j & 3) * 8)) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads)
huffman_encode_kernel(const uint8_t* __restrict__ blocks,
                      const int32_t* __restrict__ raw_lens,
                      const int32_t* __restrict__ dense,
                      uint8_t* __restrict__ rows,
                      int32_t* __restrict__ digits,
                      int32_t* __restrict__ block_bytes,
                      int S, int C, int64_t row_cap) {
  __shared__ uint32_t table[256];
  __shared__ int32_t scan[kThreads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    table[i] = static_cast<uint32_t>(dense[static_cast<int64_t>(b) * 256 + i]);
  }
  const int ncb = S / C;
  const int per = (ncb + kThreads - 1) / kThreads;  // chunks per thread
  const int k0 = min(tid * per, ncb);
  const int k1 = min(k0 + per, ncb);
  const int raw = raw_lens[b];
  const uint8_t* src = blocks + static_cast<int64_t>(b) * S;
  __syncthreads();

  // pass (a): digits and wire bytes of this thread's chunks
  int my_bytes = 0;
  for (int k = k0; k < k1; ++k) {
    const int cnt = max(0, min(C, raw - k * C));
    const uint8_t* p = src + static_cast<int64_t>(k) * C;
    uint32_t nd = 0;
    for (int i = 0; i < cnt; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < cnt) nd += (table[byte_of(v, j)] >> kLenShift) & kLenMask;
      }
    }
    digits[static_cast<int64_t>(b) * ncb + k] = static_cast<int32_t>(nd);
    my_bytes += static_cast<int>((nd + 7u) >> 3);
  }

  // CTA inclusive scan (Hillis-Steele) of the per-thread byte counts
  scan[tid] = my_bytes;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    const int add = tid >= d ? scan[tid - d] : 0;
    __syncthreads();
    scan[tid] += add;
    __syncthreads();
  }
  int64_t off = scan[tid] - my_bytes;  // exclusive: first byte of chunk k0
  if (tid == kThreads - 1) block_bytes[b] = scan[tid];

  // pass (b): emit the bit stream of each chunk at its byte offset
  uint8_t* dst = rows + static_cast<int64_t>(b) * row_cap;
  for (int k = k0; k < k1; ++k) {
    const int cnt = max(0, min(C, raw - k * C));
    const uint8_t* p = src + static_cast<int64_t>(k) * C;
    uint64_t acc = 0;  // pending bits, stream order from bit 0
    uint32_t nacc = 0;  // < 8 between symbols, so acc never overflows
    for (int i = 0; i < cnt; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < cnt) {
          const uint32_t e = table[byte_of(v, j)];
          acc |= static_cast<uint64_t>(e & kCodeMask) << nacc;
          nacc += (e >> kLenShift) & kLenMask;
          while (nacc >= 8u) {
            dst[off++] = static_cast<uint8_t>(acc);
            acc >>= 8;
            nacc -= 8u;
          }
        }
      }
    }
    if (nacc > 0u) dst[off++] = static_cast<uint8_t>(acc);
  }
}

__global__ void __launch_bounds__(kThreads)
huffman_encode_rows_kernel(const uint8_t* __restrict__ blocks,
                           const int32_t* __restrict__ raw_lens,
                           const int32_t* __restrict__ dense,
                           uint8_t* __restrict__ rows,
                           int32_t* __restrict__ digits,
                           int S, int C, int mb) {
  __shared__ uint32_t table[256];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < 256; i += kThreads) {
    table[i] = static_cast<uint32_t>(dense[static_cast<int64_t>(b) * 256 + i]);
  }
  const int ncb = S / C;
  const int raw = raw_lens[b];
  const uint8_t* src = blocks + static_cast<int64_t>(b) * S;
  __syncthreads();

  for (int k = tid; k < ncb; k += kThreads) {
    const int cnt = max(0, min(C, raw - k * C));
    const uint8_t* p = src + static_cast<int64_t>(k) * C;
    const int64_t row = static_cast<int64_t>(b) * ncb + k;
    uint8_t* dst = rows + row * mb;
    uint64_t acc = 0;  // pending bits, stream order from bit 0
    uint32_t nacc = 0;  // < 8 between symbols, so acc never overflows
    uint32_t nd = 0;  // digits of the chunk
    int off = 0;  // at most mb: every length is masked to <= 15 digits
    for (int i = 0; i < cnt; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < cnt) {
          const uint32_t e = table[byte_of(v, j)];
          const uint32_t len = (e >> kLenShift) & kLenMask;
          acc |= static_cast<uint64_t>(e & kCodeMask) << nacc;
          nacc += len;
          nd += len;
          while (nacc >= 8u) {
            dst[off++] = static_cast<uint8_t>(acc);
            acc >>= 8;
            nacc -= 8u;
          }
        }
      }
    }
    if (nacc > 0u) dst[off] = static_cast<uint8_t>(acc);
    digits[row] = static_cast<int32_t>(nd);
  }
}

}  // namespace

extern "C" int dct_huffman_encode(const void* blocks, const void* raw_lens,
                                  const void* dense, void* rows, void* digits,
                                  void* block_bytes, int B, int S, int C,
                                  long long row_cap, void* stream) {
  if (B > 0) {
    huffman_encode_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(raw_lens),
        static_cast<const int32_t*>(dense), static_cast<uint8_t*>(rows),
        static_cast<int32_t*>(digits), static_cast<int32_t*>(block_bytes), S, C,
        static_cast<int64_t>(row_cap));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dct_huffman_encode_rows(const void* blocks, const void* raw_lens,
                                       const void* dense, void* rows, void* digits,
                                       int B, int S, int C, int mb, void* stream) {
  if (B > 0) {
    huffman_encode_rows_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(raw_lens),
        static_cast<const int32_t*>(dense), static_cast<uint8_t*>(rows),
        static_cast<int32_t*>(digits), S, C, mb);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
