// Canonical Huffman chunk decode, n = 2, 3 and 16: one CTA per block, one
// thread per chunk.
//
// Replaces the TPU kernel data_compression_tpu/ops/pallas/decode_kernel.py
// `_decode_pallas` (body `_kernel_body`): digit-reversed words, L-digit
// windows, code length by limit compare, rank = bmf[len] + prefix, a
// serial boundary walk, rank compaction and a rank -> symbol gather, laid
// out 8 blocks per grid cell in a digit-major order for Mosaic.  On the
// card every chunk is an independent byte-aligned stream with a known
// symbol count, so a thread walks its chunk with its own window and the
// walk, compaction and merge trees are not needed.  This is the
// window/length/rank formulation of data_compression_tpu/ops/decode_fast.py
// with its scan replaced by the thread's own loop:
//
//   W    = value of the next L stream digits, the next digit most
//          significant (L = ARITY_MAX_LEN: 15 / 15 / 7 at n = 2 / 3 / 16)
//   ln   = 1 + #{l in 1..L-1 : W >= limit[l]}
//   rank = (bmf[ln] + W / n^(L - ln)) & 0xFF
//   out  = symbols[rank]; consume ln digits
//
// Stream digit j is digit j % D of byte j / D, little-endian.
//   n = 2, 16: the window is a 64-bit buffer, next digit at the top, and
//     W its top L * bits-per-digit bits.  Bytes enter it digit-reversed:
//     bit-reversed at n = 2, nybble-swapped at n = 16.
//   n = 3: the window is kept in value space, not in the TPU kernel's
//     2-bit field space, so no limit needs clamping (every limit is at
//     most 3^15 < 2^31).  A byte enters as its 5 trits in reversed order
//     (a 256-entry table; bytes 243..255, which the encoder never writes,
//     give the trits (b / 3^i) % 3 of the host decoder), so the buffer is
//     V = V * 243 + rev(b) over `nv` pending trits; refilling while
//     nv < 15 keeps nv <= 19 and V < 3^19 < 2^31.
//     W = V / 3^(nv - 15); consuming ln trits is V %= 3^(nv - ln).
// Digits past the chunk's byte count read as 0: a thread never reads past
// chunk_off[k + 1].  Clamping the rank to 8 bits keeps a corrupt stream
// inside the table (the caller's CRC then fails).
//
// What bounds it on the card: each thread's serial loop over its chunk
// (a dependent shared-memory compare chain per symbol; at n = 3 also
// three 32-bit divisions by powers of 3); the input is about 0.6x and the
// output 1x the raw bytes, far below the memory floor.  Design against
// that: the block's limit, bmf and symbol tables live in shared memory;
// the window refills a byte at a time from L1; output bytes are gathered
// into 32-bit words so each store moves four symbols.
//
// `kStages` is the profiling ablation of the TPU kernel's `stages`.  The
// TPU's stage 2 (boundary walk) is this loop's consumption of `ln` digits
// and cannot be separated from the window, and its stage 3 (compaction)
// has no counterpart, so the stages follow this loop.  Each is a prefix of
// the full work and writes its observable, summed over the chunk, as a
// little-endian int32 into bytes 0..3 of the chunk's output row (the rest
// of the row is not written):
//   1  window + length + walk (refill, limit compares, consume ln):
//      sum of ln, the chunk's digit count;
//   2  + rank: sum of the ranks;
//   3  + rank -> symbol from s_sym: sum of the symbol bytes;
//   4  the full kernel (symbols packed into words and stored), the only
//      instantiation the library path runs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int N>
struct Arity;

template <>
struct Arity<2> {
  static constexpr int kL = 15;  // ARITY_MAX_LEN[2]
  static constexpr int kBitsPerDigit = 1;
};

template <>
struct Arity<16> {
  static constexpr int kL = 7;  // ARITY_MAX_LEN[16]
  static constexpr int kBitsPerDigit = 4;
};

template <>
struct Arity<3> {
  static constexpr int kL = 15;  // ARITY_MAX_LEN[3]
};

// A wire byte with its digits in reversed order (next digit first).
template <int N>
__device__ __forceinline__ uint32_t digit_reversed(uint32_t byte) {
  if constexpr (N == 2) {
    return __brev(byte) >> 24;
  } else {
    return ((byte & 0xFu) << 4) | (byte >> 4);
  }
}

template <int N, int kStages>
__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint8_t* __restrict__ flat,
                      const int64_t* __restrict__ chunk_off,
                      const int32_t* __restrict__ chunk_cnt,
                      const int64_t* __restrict__ blk_start,
                      const int32_t* __restrict__ limit,
                      const int32_t* __restrict__ bmf,
                      const int32_t* __restrict__ symbols,
                      uint8_t* __restrict__ out, int C) {
  constexpr int kL = Arity<N>::kL;
  __shared__ uint32_t s_limit[kL + 1];
  __shared__ int32_t s_bmf[kL + 1];
  __shared__ uint8_t s_sym[256];
  // n = 3 only: reversed trits of each byte, and 3^i for i <= 19
  __shared__ uint32_t s_rev[N == 3 ? 256 : 1];
  __shared__ uint32_t s_pow3[N == 3 ? 20 : 1];

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kL + 1) {
    s_limit[tid] = static_cast<uint32_t>(limit[b * (kL + 1) + tid]);
    s_bmf[tid] = bmf[b * (kL + 1) + tid];
  }
  for (int i = tid; i < 256; i += kThreads) {
    s_sym[i] = static_cast<uint8_t>(symbols[b * 256 + i]);
    if constexpr (N == 3) {
      uint32_t r = 0, x = static_cast<uint32_t>(i);
      for (int t = 0; t < 5; ++t, x /= 3u) r = r * 3u + x % 3u;
      s_rev[i] = r;
    }
  }
  if constexpr (N == 3) {
    if (tid < 20) {
      uint32_t p = 1;
      for (int i = 0; i < tid; ++i) p *= 3u;
      s_pow3[tid] = p;
    }
  }
  __syncthreads();

  const int64_t k_end = blk_start[b + 1];
  for (int64_t k = blk_start[b] + tid; k < k_end; k += kThreads) {
    const uint8_t* p = flat + chunk_off[k];
    const int64_t nbytes = chunk_off[k + 1] - chunk_off[k];
    const int cnt = max(0, min(C, chunk_cnt[k]));
    uint8_t* o = out + k * static_cast<int64_t>(C);

    int64_t pos = 0;
    uint32_t word = 0;  // stage 4: four output symbols, stored together
    uint32_t acc = 0;   // stages 1-3: the stage's observable, summed
    // symbol i of the chunk has rank `rank`: the stages past the length
    auto emit = [&](int i, uint32_t rank) {
      if constexpr (kStages == 2) {
        acc += rank;
      } else if constexpr (kStages == 3) {
        acc += s_sym[rank];
      } else {
        word |= static_cast<uint32_t>(s_sym[rank]) << ((i & 3) * 8);
        if ((i & 3) == 3) {
          *reinterpret_cast<uint32_t*>(o + (i - 3)) = word;
          word = 0;
        }
      }
    };
    if constexpr (N == 3) {
      uint32_t V = 0;  // pending trits, the next one most significant
      int nv = 0;
      for (int i = 0; i < cnt; ++i) {
        while (nv < kL) {
          const uint32_t byte = pos < nbytes ? p[pos] : 0u;
          ++pos;
          V = V * 243u + s_rev[byte];
          nv += 5;
        }
        const uint32_t W = V / s_pow3[nv - kL];
        int ln = 1;
#pragma unroll
        for (int l = 1; l < kL; ++l) ln += W >= s_limit[l] ? 1 : 0;
        if constexpr (kStages == 1) {
          acc += static_cast<uint32_t>(ln);
        } else {
          const uint32_t rank =
              static_cast<uint32_t>(s_bmf[ln] + static_cast<int32_t>(W / s_pow3[kL - ln])) & 0xFFu;
          emit(i, rank);
        }
        nv -= ln;
        V %= s_pow3[nv];
      }
    } else {
      constexpr int kBpd = Arity<N>::kBitsPerDigit;
      constexpr int kWinBits = kL * kBpd;
      uint64_t win = 0;  // MSB = next stream digit
      int nbits = 0;  // valid bits at the top of win
      for (int i = 0; i < cnt; ++i) {
        while (nbits <= 56) {
          const uint32_t byte = pos < nbytes ? p[pos] : 0u;
          ++pos;
          win |= static_cast<uint64_t>(digit_reversed<N>(byte)) << (56 - nbits);
          nbits += 8;
        }
        const uint32_t W = static_cast<uint32_t>(win >> (64 - kWinBits));
        int ln = 1;
#pragma unroll
        for (int l = 1; l < kL; ++l) ln += W >= s_limit[l] ? 1 : 0;
        if constexpr (kStages == 1) {
          acc += static_cast<uint32_t>(ln);
        } else {
          const uint32_t rank = static_cast<uint32_t>(
              s_bmf[ln] + static_cast<int32_t>(W >> (kBpd * (kL - ln)))) & 0xFFu;
          emit(i, rank);
        }
        win <<= kBpd * ln;
        nbits -= kBpd * ln;
      }
    }
    if constexpr (kStages == 4) {
      if (cnt & 3) *reinterpret_cast<uint32_t*>(o + (cnt & ~3)) = word;
    } else {
      *reinterpret_cast<uint32_t*>(o) = acc;  // bytes 0..3 of the row, little-endian
    }
  }
}

template <int N, int kStages>
void launch(const void* flat, const void* chunk_off, const void* chunk_cnt,
            const void* blk_start, const void* limit, const void* bmf,
            const void* symbols, void* out, int B, int C, cudaStream_t stream) {
  huffman_decode_kernel<N, kStages><<<B, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(flat), static_cast<const int64_t*>(chunk_off),
      static_cast<const int32_t*>(chunk_cnt), static_cast<const int64_t*>(blk_start),
      static_cast<const int32_t*>(limit), static_cast<const int32_t*>(bmf),
      static_cast<const int32_t*>(symbols), static_cast<uint8_t*>(out), C);
}

template <int N>
cudaError_t launch_stages(const void* flat, const void* chunk_off, const void* chunk_cnt,
                          const void* blk_start, const void* limit, const void* bmf,
                          const void* symbols, void* out, int B, int C, int stages,
                          cudaStream_t s) {
  switch (stages) {
    case 1: launch<N, 1>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, s); break;
    case 2: launch<N, 2>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, s); break;
    case 3: launch<N, 3>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, s); break;
    case 4: launch<N, 4>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int dct_huffman_decode(const void* flat, const void* chunk_off,
                                  const void* chunk_cnt, const void* blk_start,
                                  const void* limit, const void* bmf,
                                  const void* symbols, void* out, int B, int C,
                                  int arity, int stages, void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    cudaError_t rc;
    switch (arity) {
      case 2: rc = launch_stages<2>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, stages, s); break;
      case 3: rc = launch_stages<3>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, stages, s); break;
      case 16: rc = launch_stages<16>(flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out, B, C, stages, s); break;
      default: rc = cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
