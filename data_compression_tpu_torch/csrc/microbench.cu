// Table-lookup microbenchmark kernels: ten formulations of the encoder's
// 256-entry per-block lookup over a [B, C, 128] uint8 symbol tensor.
//
// Replaces the TPU kernels of tools/microbench.py: `run_variant.go`, with
// the bodies k0 ... k7 (passthrough, widen_i32, gather256_i32,
// gather128_i32_single, gather256_u8, gather256_u8_x3, gather256_i16,
// gather256_i32_prebroadcast, gather256_i32_vreg_loop, stage1_like).  Each
// variant computes exactly what its TPU body computes.  The TPU body's
// `take_along_axis(broadcast(t[b, r]), s & 127)` under
// `where(s < 128, lo, hi)` is the 256-entry lookup T_b[s] with
// T_b = t[b, 2r:2r+2] flattened; the result's low byte is stored.
// stage1_like then takes the logical `>> 15` and `& 0x7FFF` of the entry,
// zeroes both outside the lane/position mask
// (pos < clip(65536 - lane * C, 0, C)) and stores (w ^ l) & 0xFF;
// gather256_u8_x3 XORs the lookups of three tables.
//
// The Mosaic formulations (a broadcast operand gathered along lanes,
// pre-broadcast once per block, or one [8, 128] vreg at a time) have no
// meaning on the card.  They map to the three Hopper formulations that
// the encode kernel's redesign has to choose between:
//   gather256_* and the others  the table read through the read-only data
//                               path (`__ldg`, L1) on every lookup;
//   gather256_i32_prebroadcast  the block's table staged in shared memory
//                               once per CTA, read from there;
//   gather256_i32_vreg_loop     the table held in a warp's registers,
//                               8 entries per lane (entry 32 r + lane in
//                               register r), read with 8 `__shfl_sync`
//                               and a select per lookup (the low bytes
//                               of the 8 shuffled entries packed by byte
//                               permutes, then register x / 32's byte
//                               picked by one more).
// widen_i32 widens each byte to 32 bits and narrows it back; the compiler
// may fold that to a copy, which is what widening costs on the card.
//
// What bounds them on the card: bytes (each symbol read once, each output
// byte written once, the table read once: 16.9 MB at B = 128, C = 512,
// about 5 us at 3.35 TB/s), but one cold launch of 8 MiB takes about 11 us
// even as a plain copy (`copy_`, the copy kernel, the passthrough): the
// launch and the first loads' latency add to the bytes.  Above that floor
// a formulation pays for its lookups: with the input warm in L2 the
// register variant takes about 12 us (8 shuffles a symbol, 16k warp
// shuffles per SM over the 8 MiB), the x3 gather and stage1_like about
// 9-10 us, and a cold launch adds 4-6 us of fetch to that, since a word's
// lookups wait for its load.
//
// Design: 256 threads per CTA, each CTA one slice of one block of
// W x 4 KiB, each thread W 16-byte words, all loaded before its first
// lookup, so a word's lookups run while the thread's later words are in
// flight and its store leaves while the next word is looked up.  W is
// kWords<V>, the fastest of a sweep of 1, 2, 4, 8 and 16 (PERF.md): 4
// words a thread for the `__ldg` gathers of int32 and uint8 tables and
// stage1_like (fewer, longer threads hide more of their L1 gathers), 2
// for the others (the first version's shape: every word of the launch
// requested at once); 8 and 16 were slower for every variant.  A block
// (a whole number of 8 KiB) that a 4-word slice does not divide runs at
// 2 words; a guard for a slice past the block's end instead cost the
// 4-word variants 2-12% at C = 512 (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordBytes = kThreads * 16;  // one 16-byte word a thread

enum Variant {
  kPassthrough = 0,
  kWidenI32 = 1,
  kGather256I32 = 2,
  kGather128I32Single = 3,
  kGather256U8 = 4,
  kGather256U8x3 = 5,
  kGather256I16 = 6,
  kGather256I32Prebroadcast = 7,
  kGather256I32VregLoop = 8,
  kStage1Like = 9,
};

// Table element type and entries per block ([B, rows, 128]).
template <int V>
struct Table {
  using T = int32_t;
  static constexpr int kWidth = 256;  // [B, 2, 128] int32
};
template <>
struct Table<kPassthrough> {
  using T = uint8_t;
  static constexpr int kWidth = 0;
};
template <>
struct Table<kWidenI32> {
  using T = uint8_t;
  static constexpr int kWidth = 0;
};
template <>
struct Table<kGather256U8> {
  using T = uint8_t;
  static constexpr int kWidth = 768;  // [B, 6, 128] uint8
};
template <>
struct Table<kGather256U8x3> {
  using T = uint8_t;
  static constexpr int kWidth = 768;
};
template <>
struct Table<kGather256I16> {
  using T = int16_t;
  static constexpr int kWidth = 512;  // [B, 4, 128] int16
};

// 16-byte words per thread where a slice of them divides the block (see
// Design above).
template <int V>
constexpr int kWords = (V == kGather256I32 || V == kGather128I32Single || V == kGather256U8 ||
                        V == kStage1Like)
                           ? 4
                           : 2;

// The output byte of symbol x at byte offset `o` of its block ([C, 128]:
// position o >> 7, lane o & 127).
template <int V, typename T>
__device__ __forceinline__ uint32_t lookup(uint32_t x, int o, const T* __restrict__ tb,
                                           const int32_t* s_table, const int32_t (&reg)[8],
                                           int C) {
  if constexpr (V == kWidenI32) {
    const int32_t w = static_cast<int32_t>(x);
    return static_cast<uint32_t>(w & 0xFF);
  } else if constexpr (V == kGather256I32 || V == kGather256U8) {
    return static_cast<uint32_t>(__ldg(tb + x)) & 0xFFu;
  } else if constexpr (V == kGather128I32Single) {
    return static_cast<uint32_t>(__ldg(tb + (x & 127u))) & 0xFFu;
  } else if constexpr (V == kGather256U8x3) {
    return static_cast<uint32_t>(__ldg(tb + x) ^ __ldg(tb + 256 + x) ^ __ldg(tb + 512 + x)) &
           0xFFu;
  } else if constexpr (V == kGather256I16) {
    return static_cast<uint32_t>(static_cast<uint16_t>(__ldg(tb + x))) & 0xFFu;
  } else if constexpr (V == kGather256I32Prebroadcast) {
    return static_cast<uint32_t>(s_table[x]) & 0xFFu;
  } else if constexpr (V == kGather256I32VregLoop) {
    const int src = static_cast<int>(x & 31u);
    uint32_t g[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      g[r] = static_cast<uint32_t>(__shfl_sync(0xFFFFFFFFu, reg[r], src));
    }
    // byte r of {hi4:lo4} is the low byte of g[r]
    const uint32_t lo4 = __byte_perm(__byte_perm(g[0], g[1], 0x0040), __byte_perm(g[2], g[3], 0x0040),
                                     0x5410);
    const uint32_t hi4 = __byte_perm(__byte_perm(g[4], g[5], 0x0040), __byte_perm(g[6], g[7], 0x0040),
                                     0x5410);
    return __byte_perm(lo4, hi4, x >> 5) & 0xFFu;
  } else {  // kStage1Like
    const uint32_t p = static_cast<uint32_t>(__ldg(tb + x));
    const uint32_t l = p >> 15;
    const uint32_t w = p & 0x7FFFu;
    const int lane = o & 127;
    const int pos = o >> 7;
    const int cc = min(max(65536 - lane * C, 0), C);
    return pos < cc ? ((w ^ l) & 0xFFu) : 0u;
  }
}

// The output word of the four symbols of `w` at byte offset `o`.
template <int V, typename T>
__device__ __forceinline__ uint32_t lookup4(uint32_t w, int o, const T* __restrict__ tb,
                                            const int32_t* s_table, const int32_t (&reg)[8],
                                            int C) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r |= lookup<V, T>((w >> (8 * k)) & 0xFFu, o + k, tb, s_table, reg, C) << (8 * k);
  }
  return r;
}

// No __launch_bounds__: with it, ptxas on sm_90a spilled some
// instantiations (gather256_i32 and gather128_i32_single at 4 words);
// without it none spills and none needs more than 80 registers, which 256
// threads a CTA afford.
template <int V, int W>
__global__ void lookup_kernel(const uint8_t* __restrict__ s, const typename Table<V>::T* __restrict__ table,
              uint8_t* __restrict__ out, int C) {
  using T = typename Table<V>::T;
  constexpr int kSliceBytes = W * kWordBytes;
  __shared__ int32_t s_table[V == kGather256I32Prebroadcast ? 256 : 1];

  const int tid = threadIdx.x;
  const int slices = C * 128 / kSliceBytes;
  const int64_t b = blockIdx.x / slices;
  const int base = (blockIdx.x % slices) * kSliceBytes + tid * 16;
  const int64_t block_bytes = static_cast<int64_t>(C) * 128;
  const uint8_t* sb = s + b * block_bytes;
  uint8_t* ob = out + b * block_bytes;
  const T* tb = table + b * Table<V>::kWidth;

  // every word of the thread requested before the first lookup
  uint4 v[W];
#pragma unroll
  for (int it = 0; it < W; ++it) {
    v[it] = *reinterpret_cast<const uint4*>(sb + base + it * kWordBytes);
  }
  int32_t reg[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if constexpr (V == kGather256I32Prebroadcast) {
    for (int i = tid; i < 256; i += kThreads) s_table[i] = __ldg(tb + i);
    __syncthreads();
  }
  if constexpr (V == kGather256I32VregLoop) {
    const int lane = tid & 31;
#pragma unroll
    for (int r = 0; r < 8; ++r) reg[r] = __ldg(tb + r * 32 + lane);
  }

#pragma unroll
  for (int it = 0; it < W; ++it) {
    const int off = base + it * kWordBytes;
    uint4 o = v[it];
    if constexpr (V != kPassthrough) {
      o = make_uint4(lookup4<V, T>(o.x, off, tb, s_table, reg, C),
                     lookup4<V, T>(o.y, off + 4, tb, s_table, reg, C),
                     lookup4<V, T>(o.z, off + 8, tb, s_table, reg, C),
                     lookup4<V, T>(o.w, off + 12, tb, s_table, reg, C));
    }
    *reinterpret_cast<uint4*>(ob + off) = o;
  }
}

template <int V, int W>
void launch_at(const void* s, const void* table, void* out, int B, int C, cudaStream_t stream) {
  const int grid = B * (C * 128 / (W * kWordBytes));
  lookup_kernel<V, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(s), static_cast<const typename Table<V>::T*>(table),
      static_cast<uint8_t*>(out), C);
}

template <int V>
void launch(const void* s, const void* table, void* out, int B, int C, cudaStream_t stream) {
  if ((C * 128) % (kWords<V> * kWordBytes) == 0) {
    launch_at<V, kWords<V>>(s, table, out, B, C, stream);
  } else {
    launch_at<V, 2>(s, table, out, B, C, stream);
  }
}

}  // namespace

// C x 128 bytes, a block, must be a positive multiple of 8 KiB.
extern "C" int dct_lookup(int variant, const void* s, const void* table, void* out, int B,
                          int C, void* stream) {
  if (C <= 0 || (C * 128) % (2 * kWordBytes)) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    switch (variant) {
      case kPassthrough: launch<kPassthrough>(s, table, out, B, C, st); break;
      case kWidenI32: launch<kWidenI32>(s, table, out, B, C, st); break;
      case kGather256I32: launch<kGather256I32>(s, table, out, B, C, st); break;
      case kGather128I32Single: launch<kGather128I32Single>(s, table, out, B, C, st); break;
      case kGather256U8: launch<kGather256U8>(s, table, out, B, C, st); break;
      case kGather256U8x3: launch<kGather256U8x3>(s, table, out, B, C, st); break;
      case kGather256I16: launch<kGather256I16>(s, table, out, B, C, st); break;
      case kGather256I32Prebroadcast: launch<kGather256I32Prebroadcast>(s, table, out, B, C, st); break;
      case kGather256I32VregLoop: launch<kGather256I32VregLoop>(s, table, out, B, C, st); break;
      case kStage1Like: launch<kStage1Like>(s, table, out, B, C, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
