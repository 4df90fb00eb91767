// Nybble MTF codec lanes, one block per lane: encode [B, S] uint8 blocks
// into payload rows [B, W] with their totals, and decode payloads (one
// flat buffer, per-block offsets) into [B, S] rows.
//
// Replaces data_compression_tpu/ops/scan_codecs.py `_encode_lane` (:47,
// batch :154, driver :165) and `_decode_lane` (:115, :159, :720): one
// `lax.scan` step per byte, `vmap`ped across blocks.  They reach no
// Pallas kernel.  The lanes compute what native/libdctpu.c
// `dct_nybble_encode` / `dct_nybble_decode` (:137-209) compute, byte for
// byte, errors included.
//
// What bounds it on the card: the serial chain of one lane, not bytes.
// Each byte's context is the previous byte (bits 3-6), and the 8-byte
// move-to-front row of that context is read and rewritten before the
// next byte can look at it: 65,536 dependent steps for a 64 KiB block,
// whatever the card's bandwidth (64 MiB in and out moves in 0.04 ms).
// Design:
//   * one thread per block, 8 blocks to a CTA, so 1,024 blocks are 128
//     CTAs on 128 of the 132 SMs, every lane resident at once: the lanes
//     of a warp read and write 8 rows, not 32, so each memory
//     instruction costs the SM's load-store unit 8 line lookups, not 32
//     (32 blocks to a CTA: encode 1.09x and decode 1.46x slower at 64
//     MiB, PERF.md section 6);
//   * the lane's 16 x 8-byte table lives in shared memory, laid out
//     [context][lane] so the lanes reading one context hit distinct
//     8-byte words; a step reads its row as one 64-bit load, finds the
//     byte by a byte-wise compare of both halves (`__vcmpeq4`), and
//     writes the move-to-front row back as a masked 64-bit shift
//     (funnel shifts): load, compare, find-first, shift, store, about
//     30-40 dependent cycles;
//   * the step's input is loaded one step ahead (encode) or held as a
//     three-byte window that advances by at most one byte a step
//     (decode), so no global load sits on the chain;
//   * emissions are predicated byte stores into the lane's own row, so
//     hit and miss lanes of a warp do not diverge.
// Bounds: the encoder checks up front that its row holds the worst case
// (n + 2 bytes) and writes nothing past it; the decoder reads only
// inside its block's payload (offset, length) and writes only inside
// its output row.  Status per block: 0 ok, 1 a byte >= 0x80 (encode),
// 2 row too small (encode), 3 bad or truncated payload (decode).
// No host read and no allocation: launches go on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 8;  // blocks per CTA
constexpr uint32_t kType = 0xAF;  // NYB_TYPE
constexpr int kOk = 0, kInput = 1, kCapacity = 2, kFormat = 3;
// " etaoins", byte k = row position k (nybble_compression.c:546-562)
constexpr uint64_t kSeed = 0x736e696f61746520ull;

// Position of byte v in row r (little-endian bytes), or -1.
__device__ __forceinline__ int find_byte(uint64_t r, uint32_t v) {
  const uint32_t rep = v * 0x01010101u;
  const uint32_t lo = __vcmpeq4(static_cast<uint32_t>(r), rep);
  const uint32_t hi = __vcmpeq4(static_cast<uint32_t>(r >> 32), rep);
  const uint64_t m = (static_cast<uint64_t>(hi) << 32) | lo;
  return m ? (__ffsll(static_cast<long long>(m)) - 1) >> 3 : -1;
}

// Move-to-front of v found at pos (7 on a miss): bytes 0..pos shift up
// one place, v goes to byte 0 (update_context, nybble_compression.c:665-687).
__device__ __forceinline__ uint64_t mtf(uint64_t r, uint32_t v, int pos) {
  const uint64_t mask = (2ull << (8 * pos + 7)) - 1;  // bytes 0..pos; pos 7: all
  return (r & ~mask) | (((r << 8) | v) & mask);
}

__global__ void __launch_bounds__(kLanes)
nybble_encode_kernel(const uint8_t* __restrict__ blocks, int64_t S,
                     const int32_t* __restrict__ lengths, uint8_t* __restrict__ rows, int64_t W,
                     int32_t* __restrict__ totals, int32_t* __restrict__ status, int B) {
  __shared__ uint64_t table[16][kLanes];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kLanes + lane;
  if (b >= B) return;
#pragma unroll
  for (int c = 0; c < 16; ++c) table[c][lane] = kSeed;
  const int64_t n = min(max(static_cast<int64_t>(lengths[b]), int64_t{0}), S);
  const uint8_t* src = blocks + b * S;
  uint8_t* dst = rows + b * W;
  if (W < (n ? n + 2 : 1)) {
    totals[b] = 0;
    status[b] = kCapacity;
    return;
  }
  dst[0] = static_cast<uint8_t>(kType);
  if (n == 0) {
    totals[b] = 1;
    status[b] = kOk;
    return;
  }
  uint32_t p = __ldg(src);
  dst[1] = static_cast<uint8_t>(p);
  uint32_t high = p;  // OR of every byte: bit 7 set means a byte >= 0x80
  int64_t o = 2;
  int pending = -1;  // the compressed nybble of a half-filled byte
  uint32_t next = n > 1 ? __ldg(src + 1) : 0;
  for (int64_t i = 1; i < n; ++i) {
    const uint32_t s = next;
    if (i + 1 < n) next = __ldg(src + i + 1);
    high |= s;
    const int ctx = (p >> 3) & 15;
    const uint64_t r = table[ctx][lane];
    const int pos = find_byte(r, s);
    const bool hit = pos >= 0;
    const bool half = pending >= 0;
    const uint32_t nyb = 8u | static_cast<uint32_t>(pos);
    // hit: 0 bytes, or pending|nyb; miss: s, or p then s (re-expand)
    const int count = hit ? (half ? 1 : 0) : (half ? 2 : 1);
    const uint32_t b1 = hit ? ((static_cast<uint32_t>(pending) << 4) | nyb) : (half ? p : s);
    if (count >= 1) dst[o] = static_cast<uint8_t>(b1);
    if (count == 2) dst[o + 1] = static_cast<uint8_t>(s);
    o += count;
    pending = (hit && !half) ? static_cast<int>(nyb) : -1;
    table[ctx][lane] = mtf(r, s, hit ? pos : 7);
    p = s;
  }
  if (pending >= 0) dst[o++] = static_cast<uint8_t>(p);  // trailing odd nybble
  const bool bad = high & 0x80u;
  totals[b] = bad ? 0 : static_cast<int32_t>(o);
  status[b] = bad ? kInput : kOk;
}

// Byte i of the payload body, 0 past its end.
__device__ __forceinline__ uint32_t body_at(const uint8_t* data, int64_t dlen, int64_t i) {
  return i < dlen ? __ldg(data + i) : 0u;
}

__global__ void __launch_bounds__(kLanes)
nybble_decode_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                     const int64_t* __restrict__ offsets, const int32_t* __restrict__ plens,
                     const int32_t* __restrict__ raw_lens, uint8_t* __restrict__ out, int64_t S,
                     int32_t* __restrict__ status, int B) {
  __shared__ uint64_t table[16][kLanes];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * kLanes + lane;
  if (b >= B) return;
#pragma unroll
  for (int c = 0; c < 16; ++c) table[c][lane] = kSeed;
  const int64_t n = min(max(static_cast<int64_t>(raw_lens[b]), int64_t{0}), S);
  if (n == 0) {
    status[b] = kOk;
    return;
  }
  // the block's payload, clamped into flat
  const int64_t off = min(max(offsets[b], int64_t{0}), flat_len);
  const int64_t plen = min(max(static_cast<int64_t>(plens[b]), int64_t{0}), flat_len - off);
  const uint8_t* payload = flat + off;
  if (plen < 2 || __ldg(payload) != kType) {
    status[b] = kFormat;
    return;
  }
  uint8_t* dst = out + b * S;
  uint32_t prev = __ldg(payload + 1);
  dst[0] = static_cast<uint8_t>(prev);
  const uint8_t* data = payload + 2;
  const int64_t dlen = plen - 2;
  // window on the body: w0 = byte j >> 1, w1 and w2 the next two
  int64_t base = 0;
  uint32_t w0 = body_at(data, dlen, 0), w1 = body_at(data, dlen, 1), w2 = body_at(data, dlen, 2);
  int64_t j = 0;  // nybble cursor
  int st = kOk;
  for (int64_t k = 1; k < n; ++k) {
    const uint32_t odd = static_cast<uint32_t>(j & 1);
    const uint32_t nyb = odd ? (w0 & 15u) : (w0 >> 4);
    const bool packed = nyb & 8u;
    // a literal's second nybble: low half of w0, or high half of w1
    const uint32_t nxt = odd ? (w1 >> 4) : (w0 & 15u);
    const int64_t last = (j + (packed ? 0 : 1)) >> 1;  // last body byte this step reads
    if (last >= dlen) {
      st = kFormat;
      break;
    }
    const int ctx = (prev >> 3) & 15;
    const uint64_t r = table[ctx][lane];
    const uint32_t o = packed ? static_cast<uint32_t>(r >> (8 * (nyb & 7u))) & 0xffu
                              : ((nyb & 7u) << 4) | nxt;
    const int pos = find_byte(r, o);
    table[ctx][lane] = mtf(r, o, pos >= 0 ? pos : 7);
    dst[k] = static_cast<uint8_t>(o);
    prev = o;
    j += packed ? 1 : 2;
    if ((j >> 1) != base) {  // advanced one byte
      ++base;
      w0 = w1;
      w1 = w2;
      w2 = body_at(data, dlen, base + 2);
    }
  }
  status[b] = st;
}

}  // namespace

extern "C" int dct_nybble_encode(const void* blocks, long long S, const void* lengths, void* rows,
                                 long long W, void* totals, void* status, int B, void* stream) {
  if (B > 0) {
    nybble_encode_kernel<<<(B + kLanes - 1) / kLanes, kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blocks), static_cast<int64_t>(S),
        static_cast<const int32_t*>(lengths), static_cast<uint8_t*>(rows),
        static_cast<int64_t>(W), static_cast<int32_t*>(totals), static_cast<int32_t*>(status), B);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dct_nybble_decode(const void* flat, long long flat_len, const void* offsets,
                                 const void* plens, const void* raw_lens, void* out, long long S,
                                 void* status, int B, void* stream) {
  if (B > 0) {
    nybble_decode_kernel<<<(B + kLanes - 1) / kLanes, kLanes, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), static_cast<int64_t>(flat_len),
        static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(plens),
        static_cast<const int32_t*>(raw_lens), static_cast<uint8_t*>(out),
        static_cast<int64_t>(S), static_cast<int32_t*>(status), B);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of a nybble lane kernel resident on an SM at once (occupancy API),
// the blocks (lanes) one CTA holds, its threads and its shared bytes; as
// dct_small_occupancy.
extern "C" int dct_nybble_occupancy(int decode, void* ctas, void* lanes_per_cta, void* threads,
                                    void* smem_bytes) {
  const void* fn = decode ? reinterpret_cast<const void*>(nybble_decode_kernel)
                          : reinterpret_cast<const void*>(nybble_encode_kernel);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(lanes_per_cta) = kLanes;
  *static_cast<int*>(threads) = kLanes;
  *static_cast<int*>(smem_bytes) = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(ctas), fn, kLanes, 0));
}
