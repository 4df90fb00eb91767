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
//     a plain bit stream in little-endian bit order.
//   n = 3: [B, 512], field-packed codes (2 bits per trit) then their field
//     bit counts.  Base-3 bytes do not compose with bit shifts, so the CTA
//     first turns each code into its value in stream order,
//     v = sum trit_m * 3^m, and tabulates for each symbol and each trit
//     offset pos < 5 the base-243 digits of v * 3^pos, one per byte: a
//     symbol that starts pos trits into a pending byte adds its bytes to
//     that byte (no carry, the trits are disjoint), and the full ones leave.
//     No division runs per symbol.
//
// What bounds it on the card.  The memory floor is tens of microseconds
// (64 MiB read, about 0.6x of it written).  The first version (one thread
// per chunk) ran at 22-26x that floor, and its stage ablation
// (tools.ablate, 64 MiB, one H100) put 75-84% of the rows kernel in its
// stores: each lane stored its wire bytes one byte at a time into its own
// chunk, so one warp store instruction touched 32 rows and filled 1 byte
// of each of 32 sectors.  The rest was each thread's serial walk over its
// 512 symbols (a dependent shared-memory lookup and a buffer update per
// symbol; at n = 3 a division by 243 per wire byte).
//
// The design against that: a warp per chunk, its image in shared memory.
// A warp pass covers 512 consecutive symbols of the block, 16 per lane,
// read as one coalesced 512-byte load.  A group of g = min(32, C / 16)
// lanes holds one chunk, so a pass holds 512 / C chunks when C <= 512 and
// a 512-symbol segment of one chunk when C > 512.  A segmented warp scan
// (`__shfl_up_sync` over g lanes) of the lanes' digit counts gives each
// lane the digit offset of its symbols in its chunk; each lane then adds
// its code bits (n = 3: its partial bytes) word by word into the warp's
// shared-memory image of the pass's output, with shared atomics (lanes
// meet only in their first and last word; bits and trits are disjoint,
// so adding is exact).  The warp then writes the image with 16-byte
// stores to 16-byte-aligned addresses: fully coalesced instead of 32
// rows per instruction.  A word that holds bytes outside the range the
// warp owns (another warp's chunk or rows) is written a byte at a time,
// so no store covers a byte of another warp's range.  When a chunk spans
// several passes (C > 512), the image is a window: after each pass the
// words whose bytes are all final leave, and the word holding the
// pending partial byte moves to the front.  The image needs 512 L / D
// bytes of a pass plus a carried word (1824 bytes a warp).  Nothing is
// indexed at run time in registers: the 16 entries of a lane are
// unrolled, and the kernels use 0 bytes of stack frame and 0 bytes of
// spill (`nvcc -Xptxas -v` for sm_90a; chip_smoke.py phase 2 prints it
// and requires it).
//
// A thread per chunk that stored its bytes as 16-byte words assembled in
// registers ran 1.2-1.4x slower (PERF.md, Findings).  What bounds the warp
// per chunk is the per-symbol work (lookup, scan, shifts: stages 1-2 are
// about 80% of the rows kernel), at 4-7x the memory floor.
//
// `huffman_encode_kernel` (compact): a chunk's offset is the bytes of
// the chunks before it in the block.  The CTA's four warps take the units
// (a warp pass of 512 / C chunks, or one chunk when C > 512) in turn: a
// warp counts its unit's digits (-> digits[b, k]) from the pass it has
// loaded, waits in shared memory until the previous unit is placed, places
// its own (offset + bytes, one lane), and encodes it from the same
// registers.  So the input is read once; the wait is one neighbour's
// count, not its encode (two passes with a CTA scan between them were
// 1.2x slower).  Only a chunk that spans several passes is read twice
// (counted first, then encoded), from L2.
//
// `huffman_encode_rows_kernel` replaces the TPU kernel
// data_compression_tpu/ops/pallas/encode_kernel.py `_encode_pallas` (body
// `_make_kernel(compact=False)`): the same lookup, but chunk k of block b
// goes to its own fixed-stride row b * (S / C) + k of `mb` bytes
// (mb = max_chunk_bytes(C, n)), the layout the sharded pipeline gathers
// across ranks.  No scan is needed: one pass per unit; each group writes
// the words that hold its chunk's valid bytes.
//
// The rows kernel also takes `kStages`, the profiling ablation of the TPU
// kernel's `stages` argument: each stage is a prefix of the full work and
// writes an observable that the plain version determines, so no stage can
// be optimised away and each can be checked:
//   1  the table lookups and the digit-count scan; digits[row] = the
//      chunk's digit count;
//   2  + each lane's digit accumulation into words (at n = 3 through the
//      shifted-byte table), whose deposits into the image add each word's
//      bytes to a sum instead; digits[row] = the sum of the chunk's wire
//      bytes;
//   3  the full kernel (image deposits, 16-byte stores), the only
//      instantiation the library path runs.
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

// Shared-memory tables of a block: the packed entries, `code | ndigits <<
// kLenShift` (at n = 3 the code becomes its base-3 value v in stream
// order), and at n = 3 also `shifted[pos][s]`, the base-243 digits of
// v * 3^pos packed one per byte: the wire bytes of symbol s when it
// starts `pos` trits into a byte.
template <int N>
struct Tables {
  uint32_t entry[256];
};

template <>
struct Tables<3> {
  uint32_t entry[256];
  uint32_t shifted[5 * 256];
};

template <int N>
__device__ __forceinline__ void load_tables(const int32_t* __restrict__ dense, int b,
                                            Tables<N>& t) {
  const int32_t* row = dense + static_cast<int64_t>(b) * Arity<N>::kDenseWidth;
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    if constexpr (N == 3) {
      const uint32_t fields = static_cast<uint32_t>(row[i]);
      const uint32_t nd = (static_cast<uint32_t>(row[256 + i]) >> 1) & Arity<3>::kLenMask;
      uint32_t v = 0, w = 1;
      for (uint32_t m = 0; m < nd; ++m, w *= 3u) v += ((fields >> (2u * m)) & 3u) * w;
      t.entry[i] = v | (nd << Arity<3>::kLenShift);  // v < 2^25 even for fields of 3
      for (uint32_t pos = 0, x = v; pos < 5; ++pos, x *= 3u) {  // x < 3^19 for a valid code
        uint32_t packed = 0, y = x;
        for (uint32_t j = 0; j < 4; ++j, y /= 243u) packed |= (y % 243u) << (8u * j);
        t.shifted[pos * 256 + i] = packed;
      }
    } else {
      t.entry[i] = static_cast<uint32_t>(row[i]);
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

// The arity's digits into a sink: code bits at n = 2 / 16.  At n = 3 a
// partial byte `acc` of `pos` < 5 trits is pending; a symbol adds its
// `shifted[pos]` bytes (no carry: acc < 3^pos and the low byte's trits
// start at pos), its full bytes leave and the last one stays pending.
template <int N>
struct DigitStream {
  uint32_t acc = 0;
  uint32_t pos = 0;

  template <typename Sink>
  __device__ __forceinline__ void put(uint32_t e, uint32_t sym, const Tables<N>& t, Sink& sink) {
    if constexpr (N == 3) {
      const uint32_t x = t.shifted[pos * 256u + sym] + acc;
      const uint32_t end = pos + digits_of<3>(e);  // <= 4 + 15
      const uint32_t full = (end >= 5u) + (end >= 10u) + (end >= 15u);
      sink.put(x & ((1u << (8u * full)) - 1u), 8u * full);
      acc = (x >> (8u * full)) & 0xFFu;
      pos = end - 5u * full;
    } else {
      sink.put(e & ((1u << Arity<N>::kLenShift) - 1u),
               digits_of<N>(e) * Arity<N>::kBitsPerDigit);
    }
  }

  // After a lane's last symbol: its partial byte at n = 3 (the byte's
  // other trits are 0 or another lane's); at n = 2 / 16 the image is
  // already zero past the bits.
  template <typename Sink>
  __device__ __forceinline__ void finish(Sink& sink) {
    if constexpr (N == 3) {
      if (pos) sink.put(acc, 8u);
    }
  }
};

constexpr int kWarps = kThreads / 32;
constexpr int kPassSyms = 512;  // symbols of a warp pass, 16 per lane
// 16-byte words of a warp's image: a pass's 512 L / D <= 1792 bytes, a
// carried word and the alignment of its first byte
constexpr int kImgWords = (1792 + 32) / 16;

// One lane's digits into its warp's shared-memory image: `bits` holds the
// pending stream bits from bit 0 (`nbits` < 32 between calls), which leave
// a 32-bit word at a time, added to image word `widx`.  kStore = false
// adds each word's bytes to `sum` instead (the rows kernel's stage 2).
template <bool kStore>
struct ImageSink {
  uint64_t bits = 0;
  uint32_t nbits;
  uint32_t widx;
  uint32_t* img;
  uint32_t sum = 0;

  // The lane's first digit is at bit `bit` of image byte `byte`.
  __device__ __forceinline__ ImageSink(uint32_t* image, uint32_t byte, uint32_t bit) {
    img = image;
    widx = byte >> 2;
    nbits = (byte & 3u) * 8u + bit;
  }

  __device__ __forceinline__ void deposit(uint32_t w) {
    if constexpr (kStore) {
      if (w) atomicAdd(img + widx, w);
    } else {
      sum += __vsadu4(w, 0u);
    }
    ++widx;
  }

  // Append the low `n` bits of `x` (n <= 28; x has no bits above n).
  __device__ __forceinline__ void put(uint32_t x, uint32_t n) {
    bits |= static_cast<uint64_t>(x) << nbits;
    nbits += n;
    if (nbits >= 32u) {
      deposit(static_cast<uint32_t>(bits));
      bits >>= 32;
      nbits -= 32u;
    }
  }

  __device__ __forceinline__ void flush() {
    if (nbits) deposit(static_cast<uint32_t>(bits));
  }
};

// A lane's 16 symbols of a warp pass, their entries and digit counts.
// `excl` is the digits of the lane's chunk before its symbols in this
// pass, `total` the digits of the chunk in this pass (a scan over the g
// lanes of the chunk).
struct LanePass {
  uint4 v;
  int cnt;
  uint32_t e[16];
  uint32_t nd, excl, total;
};

template <int N>
__device__ __forceinline__ void lane_pass(LanePass& lp, const Tables<N>& t,
                                          const uint8_t* __restrict__ src, int sym0, int raw,
                                          int g, int sub) {
  lp.cnt = max(0, min(16, raw - sym0));
  lp.v = make_uint4(0, 0, 0, 0);
  if (lp.cnt > 0) lp.v = *reinterpret_cast<const uint4*>(src + sym0);
  lp.nd = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    lp.e[j] = t.entry[byte_of(lp.v, j)];
    if (j < lp.cnt) lp.nd += digits_of<N>(lp.e[j]);
  }
  uint32_t incl = lp.nd;
  for (int d = 1; d < g; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d, g);
    if (sub >= d) incl += y;
  }
  lp.total = __shfl_sync(0xffffffffu, incl, g - 1, g);
  lp.excl = incl - lp.nd;
}

// Add the lane's symbols, starting at digit `dig` of a chunk whose first
// byte is image byte `rel` (negative once a window has slid past it),
// into the image; -> the sum of the bytes added.
template <int N, bool kStore>
__device__ __forceinline__ uint32_t deposit_lane(const LanePass& lp, const Tables<N>& t,
                                                 uint32_t* img, int64_t rel, uint32_t dig) {
  DigitStream<N> ds;
  uint32_t byte, bit = 0;
  if constexpr (N == 3) {
    byte = static_cast<uint32_t>(rel + dig / 5u);
    ds.pos = dig % 5u;
  } else {
    const uint32_t b = dig * Arity<N>::kBitsPerDigit;
    byte = static_cast<uint32_t>(rel + (b >> 3));
    bit = b & 7u;
  }
  ImageSink<kStore> sink(img, byte, bit);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j < lp.cnt) ds.put(lp.e[j], byte_of(lp.v, j), t, sink);
  }
  ds.finish(sink);
  sink.flush();
  return sink.sum;
}

// Image words [w_lo, w_hi), from lane `first` with stride `stride`, to
// `out` (the global address of image byte 0, 16-byte aligned); only image
// bytes [lo, hi) are the caller's: a word with others goes a byte at a
// time.
__device__ __forceinline__ void write_words(const uint4* img, uint8_t* out, uint32_t w_lo,
                                            uint32_t w_hi, uint32_t lo, uint32_t hi, int first,
                                            int stride) {
  for (uint32_t w = w_lo + first; w < w_hi; w += stride) {
    const uint4 val = img[w];
    const uint32_t a = max(16u * w, lo), z = min(16u * w + 16u, hi);
    if (a == 16u * w && z == 16u * w + 16u) {
      *reinterpret_cast<uint4*>(out + 16u * w) = val;
    } else {
      for (uint32_t j = a; j < z; ++j) {
        const uint32_t q = j & 15u;
        const uint32_t x = q < 4u ? val.x : q < 8u ? val.y : q < 12u ? val.z : val.w;
        out[j] = static_cast<uint8_t>(x >> ((q & 3u) * 8u));
      }
    }
  }
}

__device__ __forceinline__ void zero_words(uint4* img, uint32_t w_lo, uint32_t w_hi, int first,
                                           int stride) {
  for (uint32_t w = w_lo + first; w < w_hi; w += stride) img[w] = make_uint4(0, 0, 0, 0);
}

// The whole bytes of `nd` digits: final, unlike the partial byte after.
template <int N>
__device__ __forceinline__ uint32_t final_bytes(uint32_t nd) {
  if constexpr (N == 3) {
    return nd / 5u;
  } else {
    return (nd * Arity<N>::kBitsPerDigit) >> 3;
  }
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t x, int width) {
  for (int d = width >> 1; d >= 1; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d, width);
  return x;
}

// The work of one block: kCompact selects the layout (chunks back to
// back in rows[b], `stride` = its capacity; or a row of `stride` = mb
// bytes per chunk), kStages the rows kernel's ablation stage.
template <int N, bool kCompact, int kStages>
__device__ __forceinline__ void encode_block(const uint8_t* __restrict__ blocks,
                                             const int32_t* __restrict__ raw_lens,
                                             const int32_t* __restrict__ dense,
                                             uint8_t* __restrict__ rows,
                                             int32_t* __restrict__ digits,
                                             int32_t* __restrict__ block_bytes,
                                             int S, int C, int64_t stride) {
  __shared__ Tables<N> tables;
  __shared__ uint4 images[kWarps][kImgWords];
  __shared__ int turn;  // compact: the unit whose offset is next
  __shared__ long long placed;  // compact: bytes of the units before it

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  load_tables<N>(dense, b, tables);
  uint4* img4 = images[warp];
  uint32_t* img = reinterpret_cast<uint32_t*>(img4);
  zero_words(img4, 0, kImgWords, lane, 32);
  if (tid == 0) {
    turn = 0;
    placed = 0;
  }
  const int ncb = S / C;
  const bool multi = C > kPassSyms;  // a chunk spans Q passes
  const int g = multi ? 32 : C / 16;  // lanes of a chunk
  const int P = multi ? 1 : kPassSyms / C;  // chunks of a unit
  const int Q = multi ? C / kPassSyms : 1;  // passes of a unit
  const int units = (ncb + P - 1) / P;
  const int sub = lane & (g - 1), slot = lane / g;
  const int raw = raw_lens[b];
  const uint8_t* src = blocks + static_cast<int64_t>(b) * S;
  __syncthreads();

  // a unit's first symbol of pass q, for this lane
  auto sym0_of = [&](int u, int q) { return u * P * C + q * kPassSyms + lane * 16; };

  // compact: the byte offset of unit u in the row, once unit u - 1 has
  // been placed (the warps take units in turn, so each waits at most for
  // its neighbour's count); places u, of `ub` bytes
  auto place_unit = [&](int u, uint32_t ub) -> int64_t {
    long long off = 0;
    if (lane == 0) {
      volatile int* t = &turn;
      volatile long long* p = &placed;
      while (*t != u) {
      }
      __threadfence_block();
      off = *p;
      *p = off + ub;
      __threadfence_block();
      *t = u + 1;
    }
    return __shfl_sync(0xffffffffu, off, 0);
  };

  for (int u = warp; u < units; u += kWarps) {
    const int k0 = u * P;
    const int nk = min(P, ncb - k0);
    const bool live = slot < nk;
    const int64_t row0 = static_cast<int64_t>(b) * ncb + k0;
    int64_t o_unit = kCompact ? 0 : row0 * stride;  // the unit's first byte, relative to rows
    if (kCompact && multi) {  // count the chunk's passes first
      uint32_t nd = 0;
      for (int q = 0; q < Q; ++q) {
        LanePass lp;
        lane_pass<N>(lp, tables, src, sym0_of(u, q), raw, g, sub);
        nd += lp.total;
      }
      if (lane == 0) digits[row0] = static_cast<int32_t>(nd);
      o_unit = static_cast<int64_t>(b) * stride
               + place_unit(u, static_cast<uint32_t>(wire_bytes<N>(nd)));
    }
    int64_t w0 = o_unit & ~static_cast<int64_t>(15);  // image byte 0, relative to rows
    uint32_t cdig = 0, csum = 0;  // the chunk's digits and stage-2 sum so far
    for (int q = 0; q < Q; ++q) {
      LanePass lp;
      lane_pass<N>(lp, tables, src, sym0_of(u, q), raw, g, sub);
      const uint32_t wb = static_cast<uint32_t>(wire_bytes<N>(lp.total));
      int64_t o_chunk = o_unit + (kCompact ? 0 : slot * stride);  // chunk's first byte
      uint32_t ub = 0;  // compact, C <= 512: bytes of the unit
      if (kCompact && !multi) {  // chunk offsets in the unit: a scan over group leaders
        const uint32_t val = live && sub == 0 ? wb : 0u;
        uint32_t incl = val;
        for (int d = 1; d < 32; d <<= 1) {
          const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += y;
        }
        ub = __shfl_sync(0xffffffffu, incl, 31);
        if (live && sub == 0) digits[row0 + slot] = static_cast<int32_t>(lp.total);
        o_unit = static_cast<int64_t>(b) * stride + place_unit(u, ub);
        w0 = o_unit & ~static_cast<int64_t>(15);
        o_chunk = o_unit + __shfl_sync(0xffffffffu, incl - val, slot * g);
      }
      if constexpr (kStages >= 2) {
        if (lp.cnt > 0) {
          csum += deposit_lane<N, (kStages >= 3)>(lp, tables, img, o_chunk - w0, cdig + lp.excl);
        }
      }
      cdig += lp.total;
      if constexpr (kStages >= 3) {
        __syncwarp();
        uint8_t* out = rows + w0;
        const uint32_t lo = o_unit > w0 ? static_cast<uint32_t>(o_unit - w0) : 0u;
        if (multi && q < Q - 1) {
          // the words below the pending byte are final: write them, slide
          const uint32_t nfl = static_cast<uint32_t>(o_chunk + final_bytes<N>(cdig) - w0) >> 4;
          write_words(img4, out, 0, nfl, lo, 16u * nfl, lane, 32);
          const uint4 pending = img4[nfl];
          __syncwarp();
          zero_words(img4, 0, nfl + 1, lane, 32);
          __syncwarp();
          if (lane == 0) img4[0] = pending;
          w0 += 16 * static_cast<int64_t>(nfl);
        } else if (kCompact) {
          // the unit's bytes, back to back: the whole warp
          const uint32_t end = static_cast<uint32_t>(o_unit - w0)
                               + (multi ? static_cast<uint32_t>(wire_bytes<N>(cdig)) : ub);
          const uint32_t nw = (end + 15u) >> 4;
          write_words(img4, out, 0, nw, lo, end, lane, 32);
          __syncwarp();
          zero_words(img4, 0, nw, lane, 32);
        } else {
          // each chunk's valid words, by its group; rows end at the unit's end
          const uint32_t c0 = static_cast<uint32_t>(o_chunk - w0);
          const uint32_t cw = live ? (multi ? static_cast<uint32_t>(wire_bytes<N>(cdig)) : wb) : 0u;
          const uint32_t first = multi ? 0u : c0 >> 4;
          const uint32_t nw = live ? (c0 + cw + 15u) >> 4 : first;
          const uint32_t end = static_cast<uint32_t>(o_unit + nk * stride - w0);
          write_words(img4, out, first, nw, lo, end, sub, g);
          __syncwarp();
          zero_words(img4, first, nw, sub, g);
        }
        __syncwarp();
      }
    }
    if constexpr (!kCompact) {
      uint32_t obs = cdig;
      if constexpr (kStages == 2) obs = warp_sum(csum, g);
      if (live && sub == 0) digits[row0 + slot] = static_cast<int32_t>(obs);
    }
  }
  if constexpr (kCompact) {
    __syncthreads();
    if (tid == 0) block_bytes[b] = static_cast<int32_t>(placed);
  }
}

template <int N>
__global__ void __launch_bounds__(kThreads)
huffman_encode_kernel(const uint8_t* __restrict__ blocks,
                      const int32_t* __restrict__ raw_lens,
                      const int32_t* __restrict__ dense,
                      uint8_t* __restrict__ rows,
                      int32_t* __restrict__ digits,
                      int32_t* __restrict__ block_bytes,
                      int S, int C, int64_t row_cap) {
  encode_block<N, true, 3>(blocks, raw_lens, dense, rows, digits, block_bytes, S, C, row_cap);
}

template <int N, int kStages>
__global__ void __launch_bounds__(kThreads)
huffman_encode_rows_kernel(const uint8_t* __restrict__ blocks,
                           const int32_t* __restrict__ raw_lens,
                           const int32_t* __restrict__ dense,
                           uint8_t* __restrict__ rows,
                           int32_t* __restrict__ digits,
                           int S, int C, int mb) {
  encode_block<N, false, kStages>(blocks, raw_lens, dense, rows, digits, nullptr, S, C, mb);
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
