// Canonical Huffman chunk encode, n = 2, 3 and 16, one CTA per block.
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/encode_kernel.py
// `_encode_pallas_compact` (body `_make_kernel(compact=True)`, cross-lane
// concat `_concat_stage`, the n = 3 trit repack in its `arity == 3`
// branch): per block, look each symbol up in a dense 256-entry table, drop
// positions past the block's raw length, and write the block's chunk
// payloads back to back (byte-aligned chunks) into one row, plus the digit
// count of every chunk.
//
// Wire format: a chunk is a stream of base-n digits, D per byte,
// little-endian (byte = sum digit[D*j + i] * n^i), the last byte
// zero-padded; D = 8 bits at n = 2, 2 nybbles (low first) at n = 16, 5
// trits at n = 3.  The dense table holds a code with its stream digit m
// (MSB of the code first) in bit field m:
//   n = 2, 16: [B, 256] entries `code | (ndigits << kLenShift)`, 1 / 4 bits
//     per digit, shift 15 / 28.  D * bits-per-digit = 8, so the stream is
//     a plain bit stream and whole bytes leave a 64-bit buffer unchanged;
//     pending < 8 bits plus a code of <= 15 / 28 bits never overflows it.
//   n = 3: [B, 512], field-packed codes (2 bits per trit) then their field
//     bit counts.  Base-3 bytes do not compose with bit shifts, so the CTA
//     first turns each code into its value in stream order,
//     v = sum trit_m * 3^m, packed `v | (ndigits << 28)`; a thread keeps
//     a base-3 accumulator V (< 3^4 between symbols) and its trit count:
//     V += v * 3^count, then each full 5 trits leave as V % 243.
//
// What bounds it on the card: the 64 MiB input is read twice (once per
// pass) and about 0.6x of it is written, so the memory floor is tens of
// microseconds; this first version is bound instead by each thread's
// serial walk over its chunk (a dependent shared-memory lookup and a
// buffer update per symbol; at n = 3 a multiply and a division by the
// constant 243 per wire byte).  Design against that: the block's table
// lives in shared memory; each thread reads its chunk 16 bytes at a time;
// 128 threads per CTA and one CTA per block put 1024 CTAs in flight at
// 64 MiB to hide the latency.  The merge trees, chunk-per-lane layout and
// max-length buckets of the TPU kernel existed for Mosaic and are gone:
// a CTA exclusive scan over chunk byte counts places each chunk directly.
//
// Pass (a): sum code lengths per chunk -> digits[b, k], byte counts.
// CTA exclusive scan of the byte counts -> byte offset of each chunk.
// Pass (b): re-walk the chunk and store whole bytes at the chunk's offset
// in rows[b, :].
//
// A second kernel, `huffman_encode_rows_kernel`, replaces the TPU kernel
// data_compression_tpu/ops/pallas/encode_kernel.py `_encode_pallas` (body
// `_make_kernel(compact=False)`): the same lookup, but chunk k of block b
// goes to its own fixed-stride row b * (S / C) + k of `mb` bytes
// (mb = max_chunk_bytes(C, n)), the layout the sharded pipeline gathers
// across ranks.  With a fixed row per chunk no scan is needed: one pass,
// each thread owns one chunk (k = tid, tid + 128, ...), counts its digits
// and emits its bytes with the same emitter.  It is bound the same way as
// the compact kernel (a serial walk per thread), with one read of the
// input instead of two.
//
// The rows kernel also takes `kStages`, the profiling ablation of the TPU
// kernel's `stages` argument: each stage is a prefix of the full work and
// writes an observable that the plain version determines, so no stage can
// be optimised away and each can be checked:
//   1  the table lookups only; digits[row] = the chunk's digit count;
//   2  + the emitter's digit accumulation (Emitter::put and flush, at
//      n = 3 its multiply and division by 243), whose store adds each
//      wire byte to a 32-bit sum instead of writing it;
//      digits[row] = the sum of the chunk's wire bytes;
//   3  the full kernel, the only instantiation the library path runs.
// `rows` are not written at stages < 3.
//
// Both kernels are templates on the arity, instantiated for 2, 3 and 16;
// the C entry points dispatch on it (and on the stage).  Digit counts are
// masked to the length field (<= ARITY_MAX_LEN), which keeps every chunk
// within max_chunk_bytes even for a malformed table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int N>
struct Arity;

template <>
struct Arity<2> {
  static constexpr int kDenseWidth = 256;
  static constexpr int kBitsPerDigit = 1;
  static constexpr int kLenShift = 15;  // PACKED_LEN_SHIFT[2]
  static constexpr uint32_t kLenMask = 0xFu;  // ARITY_MAX_LEN[2] = 15
};

template <>
struct Arity<16> {
  static constexpr int kDenseWidth = 256;
  static constexpr int kBitsPerDigit = 4;
  static constexpr int kLenShift = 28;  // PACKED_LEN_SHIFT[16]
  static constexpr uint32_t kLenMask = 0x7u;  // ARITY_MAX_LEN[16] = 7
};

template <>
struct Arity<3> {
  static constexpr int kDenseWidth = 512;  // codes, 2 bits per trit; field-bit counts
  static constexpr int kLenShift = 28;  // of the CTA's own `v | nd << 28`
  static constexpr uint32_t kLenMask = 0xFu;  // ARITY_MAX_LEN[3] = 15
};

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> ((j & 3) * 8)) & 0xFFu;
}

// The block's packed entries, `code | ndigits << kLenShift`, into shared
// memory (at n = 3 the code becomes its base-3 value in stream order).
template <int N>
__device__ __forceinline__ void load_table(const int32_t* __restrict__ dense, int b,
                                           uint32_t* table) {
  const int32_t* row = dense + static_cast<int64_t>(b) * Arity<N>::kDenseWidth;
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    if constexpr (N == 3) {
      const uint32_t fields = static_cast<uint32_t>(row[i]);
      const uint32_t nd = (static_cast<uint32_t>(row[256 + i]) >> 1) & Arity<3>::kLenMask;
      uint32_t v = 0, w = 1;
      for (uint32_t m = 0; m < nd; ++m, w *= 3u) v += ((fields >> (2u * m)) & 3u) * w;
      table[i] = v | (nd << Arity<3>::kLenShift);  // v < 2^25 even for fields of 3
    } else {
      table[i] = static_cast<uint32_t>(row[i]);
    }
  }
}

template <int N>
__device__ __forceinline__ uint32_t digits_of(uint32_t e) {
  return (e >> Arity<N>::kLenShift) & Arity<N>::kLenMask;
}

template <int N>
__device__ __forceinline__ int wire_bytes(uint32_t nd) {
  if constexpr (N == 3) {
    return static_cast<int>((nd + 4u) / 5u);
  } else {
    return static_cast<int>((nd * Arity<N>::kBitsPerDigit + 7u) >> 3);
  }
}

// One chunk's digit stream as wire bytes.  At n = 2 / 16 `acc` holds the
// pending bits, stream order from bit 0, and `nacc` < 8 between symbols;
// at n = 3 `acc` is the base-3 accumulator of `nacc` < 5 pending trits.
template <int N>
struct Emitter {
  uint64_t acc = 0;
  uint32_t nacc = 0;

  template <typename Store>
  __device__ __forceinline__ void put(uint32_t e, Store&& store) {
    if constexpr (N == 3) {
      constexpr uint32_t kPow3[5] = {1u, 3u, 9u, 27u, 81u};
      uint32_t mul = 1u;
#pragma unroll
      for (int i = 1; i < 5; ++i) mul = nacc == static_cast<uint32_t>(i) ? kPow3[i] : mul;
      acc += static_cast<uint64_t>(e & ((1u << Arity<3>::kLenShift) - 1u)) * mul;
      nacc += digits_of<3>(e);
      while (nacc >= 5u) {
        const uint32_t a = static_cast<uint32_t>(acc);  // < 3^19 < 2^31
        store(static_cast<uint8_t>(a % 243u));
        acc = a / 243u;
        nacc -= 5u;
      }
    } else {
      acc |= static_cast<uint64_t>(e & ((1u << Arity<N>::kLenShift) - 1u)) << nacc;
      nacc += digits_of<N>(e) * Arity<N>::kBitsPerDigit;
      while (nacc >= 8u) {
        store(static_cast<uint8_t>(acc));
        acc >>= 8;
        nacc -= 8u;
      }
    }
  }

  template <typename Store>
  __device__ __forceinline__ void flush(Store&& store) {
    if (nacc > 0u) store(static_cast<uint8_t>(acc));
  }
};

template <int N>
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
  load_table<N>(dense, b, table);
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
        if (i + j < cnt) nd += digits_of<N>(table[byte_of(v, j)]);
      }
    }
    digits[static_cast<int64_t>(b) * ncb + k] = static_cast<int32_t>(nd);
    my_bytes += wire_bytes<N>(nd);
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

  // pass (b): emit the digit stream of each chunk at its byte offset
  uint8_t* dst = rows + static_cast<int64_t>(b) * row_cap;
  auto store = [&](uint8_t byte) { dst[off++] = byte; };
  for (int k = k0; k < k1; ++k) {
    const int cnt = max(0, min(C, raw - k * C));
    const uint8_t* p = src + static_cast<int64_t>(k) * C;
    Emitter<N> em;
    for (int i = 0; i < cnt; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < cnt) em.put(table[byte_of(v, j)], store);
      }
    }
    em.flush(store);
  }
}

template <int N, int kStages>
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
  load_table<N>(dense, b, table);
  const int ncb = S / C;
  const int raw = raw_lens[b];
  const uint8_t* src = blocks + static_cast<int64_t>(b) * S;
  __syncthreads();

  for (int k = tid; k < ncb; k += kThreads) {
    const int cnt = max(0, min(C, raw - k * C));
    const uint8_t* p = src + static_cast<int64_t>(k) * C;
    const int64_t row = static_cast<int64_t>(b) * ncb + k;
    uint8_t* dst = rows + row * mb;
    int off = 0;  // at most mb: every length is masked to the length field
    uint32_t wire_sum = 0;  // stage 2: the chunk's wire bytes, summed
    auto store = [&](uint8_t byte) {
      if constexpr (kStages >= 3) {
        dst[off++] = byte;
      } else {
        wire_sum += byte;
      }
    };
    Emitter<N> em;
    uint32_t nd = 0;  // digits of the chunk
    for (int i = 0; i < cnt; i += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (i + j < cnt) {
          const uint32_t e = table[byte_of(v, j)];
          nd += digits_of<N>(e);
          if constexpr (kStages >= 2) em.put(e, store);
        }
      }
    }
    if constexpr (kStages >= 2) em.flush(store);
    digits[row] = static_cast<int32_t>(kStages == 2 ? wire_sum : nd);
  }
}

template <int N>
void launch_encode(const void* blocks, const void* raw_lens, const void* dense, void* rows,
                   void* digits, void* block_bytes, int B, int S, int C, int64_t row_cap,
                   cudaStream_t stream) {
  huffman_encode_kernel<N><<<B, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(raw_lens),
      static_cast<const int32_t*>(dense), static_cast<uint8_t*>(rows),
      static_cast<int32_t*>(digits), static_cast<int32_t*>(block_bytes), S, C, row_cap);
}

template <int N, int kStages>
void launch_rows(const void* blocks, const void* raw_lens, const void* dense, void* rows,
                 void* digits, int B, int S, int C, int mb, cudaStream_t stream) {
  huffman_encode_rows_kernel<N, kStages><<<B, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(blocks), static_cast<const int32_t*>(raw_lens),
      static_cast<const int32_t*>(dense), static_cast<uint8_t*>(rows),
      static_cast<int32_t*>(digits), S, C, mb);
}

template <int N>
cudaError_t launch_rows_stages(const void* blocks, const void* raw_lens, const void* dense,
                               void* rows, void* digits, int B, int S, int C, int mb,
                               int stages, cudaStream_t stream) {
  switch (stages) {
    case 1: launch_rows<N, 1>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stream); break;
    case 2: launch_rows<N, 2>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stream); break;
    case 3: launch_rows<N, 3>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int dct_huffman_encode(const void* blocks, const void* raw_lens,
                                  const void* dense, void* rows, void* digits,
                                  void* block_bytes, int B, int S, int C,
                                  long long row_cap, int arity, void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto cap = static_cast<int64_t>(row_cap);
    switch (arity) {
      case 2: launch_encode<2>(blocks, raw_lens, dense, rows, digits, block_bytes, B, S, C, cap, s); break;
      case 3: launch_encode<3>(blocks, raw_lens, dense, rows, digits, block_bytes, B, S, C, cap, s); break;
      case 16: launch_encode<16>(blocks, raw_lens, dense, rows, digits, block_bytes, B, S, C, cap, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dct_huffman_encode_rows(const void* blocks, const void* raw_lens,
                                       const void* dense, void* rows, void* digits,
                                       int B, int S, int C, int mb, int arity,
                                       int stages, void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc;
    switch (arity) {
      case 2: rc = launch_rows_stages<2>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stages, s); break;
      case 3: rc = launch_rows_stages<3>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stages, s); break;
      case 16: rc = launch_rows_stages<16>(blocks, raw_lens, dense, rows, digits, B, S, C, mb, stages, s); break;
      default: rc = cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
