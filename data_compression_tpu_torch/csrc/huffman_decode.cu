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
//   ln   = 1 + #{l in 1..L-1 : W >= limit[l]}   (unsigned compares)
//   rank = (bmf[ln] + W / n^(L - ln)) & 0xFF
//   out  = symbols[rank]; consume ln digits
//
// Stream digit j is digit j % D of byte j / D, little-endian.  Digits past
// the chunk's byte count read as 0: a thread never reads past
// chunk_off[k + 1].  Clamping the rank to 8 bits keeps a corrupt stream
// inside the table (the caller's CRC then fails).
//
// Safe on any offsets, with no check on the host: a CTA takes the chunks
// [blk_start[b], blk_start[b + 1]) clamped into [0, K] (K chunks), and
// chunk k the bytes [chunk_off[k], chunk_off[k + 1]) clamped into flat's
// size (an offset past flat gives an empty or shortened chunk), so no read
// leaves flat, the offsets or the CTA's own table row.
//
// What bounded the first version (its stage ablation, 64 MiB, one H100): issue slots,
// not bytes.  Each symbol ran a dependent chain of L - 1 shared-memory
// limit compares (about 120 issue slots per symbol at n = 2; at n = 3 also
// three 32-bit divisions by runtime powers of 3), and each thread stored
// 4 bytes at a time into its own 512-byte row, so a warp's store touched 32
// sectors, each 1/8 filled (41% / 47% of the kernel at n = 2 / 16).  The
// input is about 0.6x and the output 1x the raw bytes, far below the
// memory floor.  The design against that:
//
// * Table-driven length.  The CTA builds, in shared memory, a table indexed
//   by the top K digits of the window (K = 11 / 3 / 7 at n = 2 / 16 / 3;
//   n^K = 2048 / 4096 / 2187 entries).  ln(W) is nondecreasing in W for any
//   limit array, so the entry of prefix p is exact when the compare chain
//   gives the same ln <= K at both ends of p's range
//   [p n^(L-K), (p+1) n^(L-K) - 1]; rank then depends only on W's top ln
//   digits.  The entry packs the symbol byte (bits 0-7), the rank (8-15),
//   ln (16-19) and W's top ln digits (20-31).  Any other prefix holds 0, a
//   marker: that thread takes the compare chain above, the kernel's own
//   exact path for longer codes.  So every limit / bmf array (corrupt or
//   not canonical ones too) decodes exactly as the chain decodes it.
// * Refill a word at a time.  A lane's load touches its own chunk, so a
//   warp's load costs one L1 wavefront per lane: the bytes come in 4-byte
//   groups, one aligned 32-bit load each, loaded one group ahead.  At
//   n = 2 / 16 the window is a 64-bit buffer, the next digit at the top;
//   it takes a group's 32 digit-reversed bits whenever it holds <= 32 bits, checked
//   every second symbol: a table hit consumes at most 11 / 12 bits and the
//   chain refills before and after itself, so a lookup always sees >= K
//   digits and the chain >= L.
// * n = 3 in value space: the buffer is V = V * 243 + rev(b) over nv
//   pending trits (a byte's 5 trits reversed, by a 256-entry table; bytes
//   243..255, which the encoder never writes, give the trits (b / 3^i) % 3
//   of the host decoder), refilled a byte at a time from a 4-byte group
//   while nv < 15, so nv <= 19 and V < 3^19 < 2^31: every limit (at most
//   3^15) fits unclamped.  Divisions by 3^k are one 32 x 32 -> 64-bit
//   multiply and a shift (x < 2^31, m = ceil(2^(31 + l) / 3^k), l =
//   ceil(log2 3^k): exact for every such x); the table index is
//   V / 3^(nv - K), and consuming ln trits is V -= top * 3^(nv - ln).
// * Coalesced stores.  Each warp stages its 32 rows' next 32 symbols in
//   shared memory (row stride 9 words: the per-thread word stores hit 32
//   banks) and writes them out as 16-byte stores, two lanes per row segment,
//   so one store instruction fills 16 whole 32-byte sectors.  The loop over
//   segments runs to the warp's largest count (__reduce_max_sync) so the
//   __syncwarp around each flush is reached by every lane; a lane past its
//   own count decodes zeros or garbage it never stores (bytes past a
//   chunk's count stay undefined, pieces past it are not written).
//
// `kStages` is the profiling ablation of the TPU kernel's `stages`.  The
// TPU's stage 2 (boundary walk) is this loop's consumption of `ln` digits
// and cannot be separated from the window, and its stage 3 (compaction)
// has no counterpart, so the stages follow this loop.  Each is a prefix of
// the full work and writes its observable, summed over the chunk's first
// `cnt` symbols, as a little-endian int32 into bytes 0..3 of the chunk's
// output row (the rest of the row is not written):
//   1  window + length + walk (refill, table read or compare chain,
//      consume ln): sum of ln, the chunk's digit count;
//   2  + rank: sum of the ranks;
//   3  + rank -> symbol: sum of the symbol bytes;
//   4  the full kernel (symbols staged and stored), the only instantiation
//      the library path runs.
// With the table, rank and symbol come out of the same read as ln, so
// stages 2 and 3 cost about what stage 1 costs; stage 4 adds the stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 32;                 // symbols per staged row segment
constexpr int kSegWords = kSeg / 4 + 1;  // staging row stride in words (odd)
constexpr int kPieces = kSeg / 16;       // 16-byte stores per row segment
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr uint32_t ipow(uint32_t b, int e) { return e == 0 ? 1u : b * ipow(b, e - 1); }

template <int N>
struct Arity;

template <>
struct Arity<2> {
  static constexpr int kL = 15;  // ARITY_MAX_LEN[2]
  static constexpr int kK = 11;  // table digits
  static constexpr int kBitsPerDigit = 1;
};

template <>
struct Arity<16> {
  static constexpr int kL = 7;  // ARITY_MAX_LEN[16]
  static constexpr int kK = 3;
  static constexpr int kBitsPerDigit = 4;
};

template <>
struct Arity<3> {
  static constexpr int kL = 15;  // ARITY_MAX_LEN[3]
  static constexpr int kK = 7;
};

// The block's tables in shared memory.
template <int N>
struct Tables {
  static constexpr int kL = Arity<N>::kL;
  uint32_t limit[kL + 1];
  int32_t bmf[kL + 1];
  uint32_t lut[ipow(N, Arity<N>::kK)];
  uint8_t sym[256];
  // n = 3 only: reversed trits of each byte, 3^k and its magic divisor
  uint32_t rev[N == 3 ? 256 : 1];
  uint32_t pow3[N == 3 ? 20 : 1];
  uint2 div3[N == 3 ? 20 : 1];
};

template <int L>
__device__ __forceinline__ int code_length(uint32_t W, const uint32_t* limit) {
  int ln = 1;
#pragma unroll
  for (int l = 1; l < L; ++l) ln += W >= limit[l] ? 1 : 0;
  return ln;
}

__device__ __forceinline__ uint32_t entry(uint32_t sym, uint32_t rank, int ln, uint32_t top) {
  return top << 20 | static_cast<uint32_t>(ln) << 16 | rank << 8 | sym;
}

// x / 3^k for x < 2^31, with d = div3[k]
__device__ __forceinline__ uint32_t div_pow3(uint32_t x, uint2 d) {
  return static_cast<uint32_t>((static_cast<uint64_t>(x) * d.x) >> d.y);
}

// A chunk's bytes, four at a time, little-endian; bytes past its end read
// as 0.  Each group is one aligned 32-bit load (a chunk starts at any byte:
// a funnel shift of two aligned words), loaded one group ahead, with no
// branch: past its last word a chunk re-reads that word and masks it out.
// Only words holding at least one of the chunk's bytes are read (an empty
// chunk reads a zero word), so no read leaves flat's allocation, whose
// start and size the CUDA allocator aligns to far more than 4 bytes.
__device__ const uint32_t kZeroWord = 0;

struct Bytes {
  const uint32_t* words;  // the aligned word holding the chunk's first byte
  int next, last;         // the next word to load; the last with a chunk byte
  uint32_t cur, pend;     // the aligned words holding the next unread bytes
  int shift;              // 8 * (chunk start & 3)
  int left;               // chunk bytes not yet returned

  __device__ __forceinline__ uint32_t load() { return __ldg(words + min(next++, last)); }
  __device__ __forceinline__ void init(const uint8_t* p, int nbytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    words = nbytes > 0 ? reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3}) : &kZeroWord;
    last = nbytes > 0 ? (static_cast<int>(a & 3) + nbytes - 1) >> 2 : 0;
    shift = 8 * static_cast<int>(a & 3);
    left = nbytes;
    next = 0;
    cur = load();
    pend = load();
  }
  __device__ __forceinline__ uint32_t next4() {
    const uint32_t r = __funnelshift_r(cur, pend, shift);
    cur = pend;
    pend = load();
    const int valid = min(max(left, 0), 4);
    left -= 4;
    return r & __funnelshift_rc(~0u, 0u, 32 - 8 * valid);  // keep `valid` low bytes
  }
};

// Four wire bytes (little-endian word) as 32 stream digits' bits, the next
// digit at the top: bit-reversed at n = 2, nybble-reversed at n = 16.
template <int N>
__device__ __forceinline__ uint32_t digit_reversed(uint32_t w) {
  if constexpr (N == 2) {
    return __brev(w);
  } else {
    const uint32_t r = __byte_perm(w, 0, 0x0123);
    return ((r >> 4) & 0x0F0F0F0Fu) | ((r & 0x0F0F0F0Fu) << 4);
  }
}

// One chunk's digit stream; step() decodes a symbol and returns its entry
// (symbol, rank, ln).  refill() keeps enough digits for two table reads.
template <int N>
struct Stream {
  static constexpr int kL = Arity<N>::kL;
  static constexpr int kK = Arity<N>::kK;
  static constexpr int kB = Arity<N>::kBitsPerDigit;
  Bytes in;
  uint64_t win;  // MSB = next stream digit
  int nbits;     // valid bits at the top of win

  __device__ __forceinline__ void init(const uint8_t* p, int nbytes, const Tables<N>& t) {
    in.init(p, nbytes);
    win = 0;
    nbits = 0;
    refill(t);
  }
  __device__ __forceinline__ void refill(const Tables<N>&) {
    if (nbits <= 32) {
      win |= static_cast<uint64_t>(digit_reversed<N>(in.next4())) << (32 - nbits);
      nbits += 32;
    }
  }
  __device__ __forceinline__ uint32_t step(const Tables<N>& t) {
    uint32_t e = t.lut[static_cast<uint32_t>(win >> (64 - kK * kB))];
    int ln = (e >> 16) & 0xF;
    if (ln == 0) {  // longer than K digits: the compare chain
      refill(t);
      const uint32_t W = static_cast<uint32_t>(win >> (64 - kL * kB));
      ln = code_length<kL>(W, t.limit);
      const uint32_t rank =
          static_cast<uint32_t>(t.bmf[ln] + static_cast<int32_t>(W >> (kB * (kL - ln)))) & 0xFFu;
      e = entry(t.sym[rank], rank, ln, 0);
      win <<= kB * ln;
      nbits -= kB * ln;
      refill(t);
      return e;
    }
    win <<= kB * ln;
    nbits -= kB * ln;
    return e;
  }
};

template <>
struct Stream<3> {
  static constexpr int kL = Arity<3>::kL;
  static constexpr int kK = Arity<3>::kK;
  Bytes in;
  uint32_t q;  // the current group's unread bytes
  int nq;      // unread bytes in q
  uint32_t V;  // pending trits, the next one most significant
  int nv;

  __device__ __forceinline__ void init(const uint8_t* p, int nbytes, const Tables<3>& t) {
    in.init(p, nbytes);
    q = 0;
    nq = 0;
    V = 0;
    nv = 0;
    refill(t);
  }
  __device__ __forceinline__ void refill(const Tables<3>& t) {
    while (nv < kL) {
      if (nq == 0) {
        q = in.next4();
        nq = 4;
      }
      V = V * 243u + t.rev[q & 0xFFu];
      q >>= 8;
      --nq;
      nv += 5;
    }
  }
  __device__ __forceinline__ uint32_t step(const Tables<3>& t) {
    uint32_t e = t.lut[div_pow3(V, t.div3[nv - kK])];
    int ln = (e >> 16) & 0xF;
    uint32_t top = e >> 20;
    if (ln == 0) {  // longer than K trits: the compare chain
      refill(t);
      const uint32_t W = div_pow3(V, t.div3[nv - kL]);
      ln = code_length<kL>(W, t.limit);
      top = div_pow3(W, t.div3[kL - ln]);
      const uint32_t rank = static_cast<uint32_t>(t.bmf[ln] + static_cast<int32_t>(top)) & 0xFFu;
      e = entry(t.sym[rank], rank, ln, 0);
      nv -= ln;
      V -= top * t.pow3[nv];
      refill(t);
      return e;
    }
    nv -= ln;
    V -= top * t.pow3[nv];
    return e;
  }
};

template <int N>
__device__ __forceinline__ void load_tables(Tables<N>& t, const int32_t* limit, const int32_t* bmf,
                                            const int32_t* symbols, int64_t b, int tid) {
  constexpr int kL = Arity<N>::kL;
  constexpr int kK = Arity<N>::kK;
  constexpr int kLut = ipow(N, kK);
  constexpr uint32_t kSpan = ipow(N, kL - kK);
  if (tid < kL + 1) {
    t.limit[tid] = static_cast<uint32_t>(limit[b * (kL + 1) + tid]);
    t.bmf[tid] = bmf[b * (kL + 1) + tid];
  }
  for (int i = tid; i < 256; i += kThreads) {
    t.sym[i] = static_cast<uint8_t>(symbols[b * 256 + i]);
    if constexpr (N == 3) {
      uint32_t r = 0, x = static_cast<uint32_t>(i);
      for (int k = 0; k < 5; ++k, x /= 3u) r = r * 3u + x % 3u;
      t.rev[i] = r;
    }
  }
  if constexpr (N == 3) {
    if (tid < 20) {
      uint32_t d = 1;
      for (int i = 0; i < tid; ++i) d *= 3u;
      const int l = d == 1 ? 0 : 32 - __clz(d - 1);  // ceil(log2 d)
      t.pow3[tid] = d;
      t.div3[tid] = make_uint2(
          static_cast<uint32_t>(((uint64_t{1} << (31 + l)) + d - 1) / d), 31u + l);
    }
  }
  __syncthreads();
  // the K-digit table: exact where ln is the same at both ends of the
  // prefix's range and at most K, else the marker 0
  for (int i = tid; i < kLut; i += kThreads) {
    const uint32_t lo = static_cast<uint32_t>(i) * kSpan;
    const int ln = code_length<kL>(lo, t.limit);
    uint32_t e = 0;
    if (ln <= kK && code_length<kL>(lo + (kSpan - 1), t.limit) == ln) {
      uint32_t top;
      if constexpr (N == 3) {
        top = lo / t.pow3[kL - ln];
      } else {
        top = lo >> (Arity<N>::kBitsPerDigit * (kL - ln));
      }
      const uint32_t rank = static_cast<uint32_t>(t.bmf[ln] + static_cast<int32_t>(top)) & 0xFFu;
      e = entry(t.sym[rank], rank, ln, top);
    }
    t.lut[i] = e;
  }
  __syncthreads();
}

template <int N, int kStages>
__global__ void __launch_bounds__(kThreads, 8)
huffman_decode_kernel(const uint8_t* __restrict__ flat,
                      const int64_t* __restrict__ chunk_off,
                      const int32_t* __restrict__ chunk_cnt,
                      const int64_t* __restrict__ blk_start,
                      const int32_t* __restrict__ limit,
                      const int32_t* __restrict__ bmf,
                      const int32_t* __restrict__ symbols,
                      uint8_t* __restrict__ out, int C, int64_t flat_bytes,
                      int64_t chunks) {
  __shared__ Tables<N> t;
  // stage 4: each warp's 32 rows x kSeg symbols, rows kSegWords words apart
  __shared__ uint32_t s_stage[kStages == 4 ? kWarps * 32 * kSegWords : 1];

  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  load_tables<N>(t, limit, bmf, symbols, b, tid);

  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t* stage = s_stage + (kStages == 4 ? warp * 32 * kSegWords : 0);
  const int64_t k_begin = min(max(blk_start[b], int64_t{0}), chunks);
  const int64_t k_end = min(max(blk_start[b + 1], k_begin), chunks);
  // a warp takes 32 consecutive chunks; every lane runs every iteration
  for (int64_t kw = k_begin + warp * 32; kw < k_end; kw += kThreads) {
    const int64_t k = kw + lane;
    const uint8_t* p = flat;
    int nbytes = 0, cnt = 0;
    if (k < k_end) {
      const int64_t off = min(max(chunk_off[k], int64_t{0}), flat_bytes);
      const int64_t end = min(max(chunk_off[k + 1], off), flat_bytes);
      p = flat + off;
      nbytes = static_cast<int>(min(end - off, int64_t{1} << 30));  // far more than a chunk reads
      cnt = max(0, min(C, chunk_cnt[k]));
    }
    const int wmax = __reduce_max_sync(kFull, cnt);
    Stream<N> st;
    st.init(p, nbytes, t);
    uint32_t acc = 0;  // stages 1-3: the stage's observable, summed
    for (int base = 0; base < wmax; base += kSeg) {
#pragma unroll 2
      for (int j = 0; j < kSeg; j += 4) {
        uint32_t word = 0;  // stage 4: four symbols, staged together
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if ((u & 1) == 0) st.refill(t);  // enough digits for two table reads
          const uint32_t e = st.step(t);
          if constexpr (kStages == 4) {
            word |= (e & 0xFFu) << (8 * u);
          } else if (base + j + u < cnt) {
            acc += kStages == 1 ? (e >> 16) & 0xFu : kStages == 2 ? (e >> 8) & 0xFFu : e & 0xFFu;
          }
        }
        if constexpr (kStages == 4) stage[lane * kSegWords + (j >> 2)] = word;
      }
      if constexpr (kStages == 4) {
        __syncwarp();
        // row r's segment in kPieces 16-byte pieces, 32 / kPieces rows per store
#pragma unroll
        for (int r0 = 0; r0 < 32; r0 += 32 / kPieces) {
          const int r = r0 + lane / kPieces;
          const int h = lane % kPieces;
          const int rcnt = __shfl_sync(kFull, cnt, r);
          if (base + 16 * h < rcnt) {
            const uint32_t* s = stage + r * kSegWords + 4 * h;
            *reinterpret_cast<uint4*>(out + (kw + r) * C + base + 16 * h) =
                make_uint4(s[0], s[1], s[2], s[3]);
          }
        }
        __syncwarp();
      }
    }
    if constexpr (kStages < 4) {
      if (k < k_end) *reinterpret_cast<uint32_t*>(out + k * C) = acc;  // bytes 0..3, little-endian
    }
  }
}

struct Args {
  const void *flat, *chunk_off, *chunk_cnt, *blk_start, *limit, *bmf, *symbols;
  void* out;
  int B, C;
  int64_t flat_bytes, chunks;
};

template <int N, int kStages>
void launch(const Args& a, cudaStream_t stream) {
  huffman_decode_kernel<N, kStages><<<a.B, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(a.flat), static_cast<const int64_t*>(a.chunk_off),
      static_cast<const int32_t*>(a.chunk_cnt), static_cast<const int64_t*>(a.blk_start),
      static_cast<const int32_t*>(a.limit), static_cast<const int32_t*>(a.bmf),
      static_cast<const int32_t*>(a.symbols), static_cast<uint8_t*>(a.out), a.C, a.flat_bytes,
      a.chunks);
}

template <int N>
cudaError_t launch_stages(const Args& a, int stages, cudaStream_t s) {
  switch (stages) {
    case 1: launch<N, 1>(a, s); break;
    case 2: launch<N, 2>(a, s); break;
    case 3: launch<N, 3>(a, s); break;
    case 4: launch<N, 4>(a, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// flat holds flat_bytes bytes; chunk_off has chunks + 1 entries, blk_start B + 1.
extern "C" int dct_huffman_decode(const void* flat, const void* chunk_off,
                                  const void* chunk_cnt, const void* blk_start,
                                  const void* limit, const void* bmf,
                                  const void* symbols, void* out, int B, int C,
                                  int arity, int stages, int64_t flat_bytes, int64_t chunks,
                                  void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const Args a{flat, chunk_off, chunk_cnt, blk_start, limit, bmf, symbols, out,
                 B,    C,         flat_bytes, chunks};
    cudaError_t rc;
    switch (arity) {
      case 2: rc = launch_stages<2>(a, stages, s); break;
      case 3: rc = launch_stages<3>(a, stages, s); break;
      case 16: rc = launch_stages<16>(a, stages, s); break;
      default: rc = cudaErrorInvalidValue;
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
