// Canonical Huffman chunk decode, n = 2: one CTA per block, one thread per
// chunk.
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/decode_kernel.py
// `_decode_pallas` (body `_kernel_body`): digit-reversed words, 15-digit
// windows, code length by limit compare, rank = bmf[len] + prefix, a
// serial boundary walk, rank compaction and a rank -> symbol gather, laid
// out 8 blocks per grid cell in a digit-major order for Mosaic.  On the
// card every chunk is an independent byte-aligned stream with a known
// symbol count, so a thread walks its chunk with a 64-bit window and the
// walk, compaction and merge trees are not needed.  This is the
// window/length/rank formulation of data_compression_tpu/ops/decode_fast.py
// with its scan replaced by the thread's own loop:
//
//   W    = next L = 15 stream digits (MSB = next digit)
//   ln   = 1 + #{l in 1..L-1 : W >= limit[l]}
//   rank = (bmf[ln] + (W >> (L - ln))) & 0xFF
//   out  = symbols[rank]; consume ln digits
//
// Stream digit j is bit (j & 7) of byte (j >> 3), so bytes enter the
// window bit-reversed.  Bits past the chunk's byte count read as 0: a
// thread never reads past chunk_off[k + 1].  Clamping the rank to 8 bits
// keeps a corrupt stream inside the table (the caller's CRC then fails).
//
// What bounds it on the card: each thread's serial loop over its chunk
// (a dependent shared-memory compare chain per symbol); the input is about
// 0.6x and the output 1x the raw bytes, far below the memory floor.
// Design against that: the block's limit, bmf and symbol tables live in
// shared memory; the window refills a byte at a time from L1; output bytes
// are gathered into 32-bit words so each store moves four symbols.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kL = 15;  // ARITY_MAX_LEN[2]

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ flat,
                      const int64_t* __restrict__ chunk_off,
                      const int32_t* __restrict__ chunk_cnt,
                      const int64_t* __restrict__ blk_start,
                      const int32_t* __restrict__ limit,
                      const int32_t* __restrict__ bmf,
                      const int32_t* __restrict__ symbols,
                      uint8_t* __restrict__ out, int C) {
  __shared__ uint32_t s_limit[kL + 1];
  __shared__ int32_t s_bmf[kL + 1];
  __shared__ uint8_t s_sym[256];

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kL + 1) {
    s_limit[tid] = static_cast<uint32_t>(limit[b * (kL + 1) + tid]);
    s_bmf[tid] = bmf[b * (kL + 1) + tid];
  }
  for (int i = tid; i < 256; i += kThreads) {
    s_sym[i] = static_cast<uint8_t>(symbols[b * 256 + i]);
  }
  __syncthreads();

  const int64_t k_end = blk_start[b + 1];
  for (int64_t k = blk_start[b] + tid; k < k_end; k += kThreads) {
    const uint8_t* p = flat + chunk_off[k];
    const int64_t nbytes = chunk_off[k + 1] - chunk_off[k];
    const int cnt = max(0, min(C, chunk_cnt[k]));
    uint8_t* o = out + k * static_cast<int64_t>(C);

    uint64_t win = 0;  // MSB = next stream digit
    int nbits = 0;  // valid bits at the top of win
    int64_t pos = 0;
    uint32_t word = 0;
    for (int i = 0; i < cnt; ++i) {
      while (nbits <= 56) {
        const uint32_t byte = pos < nbytes ? p[pos] : 0u;
        ++pos;
        win |= static_cast<uint64_t>(__brev(byte) >> 24) << (56 - nbits);
        nbits += 8;
      }
      const uint32_t W = static_cast<uint32_t>(win >> (64 - kL));
      int ln = 1;
#pragma unroll
      for (int l = 1; l < kL; ++l) ln += W >= s_limit[l] ? 1 : 0;
      const uint32_t rank =
          static_cast<uint32_t>(s_bmf[ln] + static_cast<int32_t>(W >> (kL - ln))) & 0xFFu;
      word |= static_cast<uint32_t>(s_sym[rank]) << ((i & 3) * 8);
      if ((i & 3) == 3) {
        *reinterpret_cast<uint32_t*>(o + (i - 3)) = word;
        word = 0;
      }
      win <<= ln;
      nbits -= ln;
    }
    if (cnt & 3) *reinterpret_cast<uint32_t*>(o + (cnt & ~3)) = word;
  }
}

}  // namespace

extern "C" int dct_huffman_decode(const void* flat, const void* chunk_off,
                                  const void* chunk_cnt, const void* blk_start,
                                  const void* limit, const void* bmf,
                                  const void* symbols, void* out, int B, int C,
                                  void* stream) {
  if (B > 0) {
    huffman_decode_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), static_cast<const int64_t*>(chunk_off),
        static_cast<const int32_t*>(chunk_cnt), static_cast<const int64_t*>(blk_start),
        static_cast<const int32_t*>(limit), static_cast<const int32_t*>(bmf),
        static_cast<const int32_t*>(symbols), static_cast<uint8_t*>(out), C);
  }
  return static_cast<int>(cudaGetLastError());
}
