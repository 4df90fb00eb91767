// Nybble MTF codec lanes: encode [B, S] uint8 blocks into payload rows
// [B, W] with their totals, and decode payloads (one flat buffer,
// per-block offsets) into [B, S] rows.
//
// Replaces data_compression_tpu/ops/scan_codecs.py `_encode_lane` (:47,
// batch :154, driver :165) and `_decode_lane` (:115, :159, :720): one
// `lax.scan` step per byte, `vmap`ped across blocks.  They reach no
// Pallas kernel.  The lanes compute what native/libdctpu.c
// `dct_nybble_encode` / `dct_nybble_decode` (:137-205) compute, byte for
// byte, errors included.
//
// What bounds it on the card: serial chains, not bytes (64 MiB in and out
// moves in 0.04 ms).  Each byte's context is the previous byte (bits
// 3-6), and the 8-byte move-to-front row of that context is read and
// rewritten before the next byte of the same context can look at it.
//
// Encode: one warp a block, in tiles of kEncTile bytes.  The context of
// step i is the input byte i - 1, so a block is 16 independent chains,
// one per context; only they are serial.
//   * bucket: the warp counts each row of 32 steps by context (four
//     ballots of the context's bits) and scatters (tile index, byte) into
//     the context's bucket, in order;
//   * walk: lane c < 16 walks context c's bucket with the row in two
//     registers: the byte's match word by XOR with its splat and a
//     zero-byte test, the move-to-front as a masked merge of the row with
//     the row shifted one byte (two `__byte_perm`), 7 dependent integer
//     operations a step and no shared load or store on the chain; it
//     writes each step's (hit, pos) code at the step's tile index, the
//     code by a multiply (no FLO).  Hopper issues an integer instruction
//     every other cycle a scheduler, so a step's 20 or so bind, not its
//     chain;
//   * emit: warp-parallel again, a row of 32 steps at a time.  Whether a
//     compressed nybble is pending before step i (`half`) follows hits
//     and misses only: a miss clears it, a hit flips it, so it is the
//     parity of the hits since the last miss (or since the row's start,
//     after the carried state); a step's bytes (0, 1 or 2) and their
//     offsets come from two ballots and popcounts, and the stores of a
//     row are contiguous.
// Shared memory: the tile, its buckets and codes, 24 KiB a CTA, so the
// 1,026 blocks of a 64 MiB call run in one wave (9 CTAs an SM).  The
// rows carry across tiles in registers; no count is narrow, whatever S.
//
// Decode: the context of step k is the byte decoded at step k - 1, so a
// block is one chain.  What a step reads off the payload does not depend
// on the chain: nybble j + 1 starts a token if j started a packed one or
// was a literal's second half, a two-state automaton.  So a CTA of two
// warps decodes kDecBlocks = 2 blocks in tiles of their payload bodies,
// a pipeline of two stages in step by a CTA barrier a tile:
//   * the parse warp makes tile t's records while the chain walks tile
//     t - 1's: it stages each block's tile of body in shared memory (and
//     the byte after it), composes the automaton's runs, four bytes a
//     lane, by a warp scan, and writes one record a step into the tile's
//     half of a double buffer: 0x80 | pos for a packed token, the 7-bit
//     literal for a literal.  A token that would read past the body (a
//     literal on the body's last nybble) is not recorded, and a block
//     whose records run out before its raw length is FORMAT, as the C
//     returns at that step.  The records a tile takes, and so where the
//     next starts, follow from the parse alone;
//   * chain: lane g of the other warp walks block g's records at
//     addresses that do not depend on its state, without a branch: the
//     row of the context (one shared load at (prev & 0x78), the row just
//     written forwarded if the context repeats), the byte by
//     `__byte_perm` or the literal, the same move-to-front as the
//     encoder; each byte goes back over its record;
//   * the parse warp copies tile t - 2's bytes to the output rows before
//     it parses tile t into that half, and the last tile's after the
//     loop.
// Which warp walks the chain follows its warp slot, so that the chains of
// an SM's CTAs spread over the four schedulers.
// Bounds: the encoder checks up front that its row holds n + 2 bytes (the
// C's per-step check; a step emits two bytes only after one that emitted
// none, so a payload takes at most n + 1) and writes nothing past it,
// whatever its codes; the decoder reads only
// inside its block's payload (offset, length) and writes only inside its
// output row.  Status per block: 0 ok, 1 a byte >= 0x80 (encode), 2 row
// too small (encode), 3 bad or truncated payload (decode).
// No host read and no allocation: launches go on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kType = 0xAF;  // NYB_TYPE
constexpr int kOk = 0, kInput = 1, kCapacity = 2, kFormat = 3;
// " etaoins", byte k = row position k (nybble_compression.c:546-562)
constexpr uint32_t kSeedLo = 0x61746520u, kSeedHi = 0x736e696fu;
constexpr int kEncTile = 4096;  // encode: steps a tile
constexpr int kDecBlocks = 2;     // decode: blocks a CTA (chains in the chain warp's lockstep)
constexpr int kDecTile = 2048;    // decode: body bytes a tile, per block

// Move-to-front of byte v (byte 0 of v; the row's bytes and v below 0x80)
// in the row (lo, hi), little-endian: bytes 0..pos shift up one place and
// v goes to byte 0, pos being v's position or 7 on a miss
// (update_context, nybble_compression.c:665-687).  Returns the step's
// code: 8 | pos on a hit, 0 on a miss.
__device__ __forceinline__ uint32_t mtf(uint32_t& lo, uint32_t& hi, uint32_t v) {
  const uint32_t splat = __byte_perm(v, 0, 0);
  const uint32_t xl = lo ^ splat, xh = hi ^ splat;
  // bytes below 0x80: bit 7 of x + 0x7f is clear exactly where x is 0
  const uint32_t zl = ~(xl + 0x7f7f7f7fu) & 0x80808080u, zh = ~(xh + 0x7f7f7f7fu) & 0x80808080u;
  const uint64_t z = (static_cast<uint64_t>(zh) << 32) | zl;
  const uint64_t m = z ^ (z - 1);  // bytes 0..pos; every byte on a miss
  const uint32_t ml = static_cast<uint32_t>(m), mh = static_cast<uint32_t>(m >> 32);
  const uint32_t sl = __byte_perm(v, lo, 0x6540);   // (row << 8 | v), low word
  const uint32_t sh = __byte_perm(lo, hi, 0x6543);  // (row << 8), high word
  lo = (lo & ~ml) | (sl & ml);
  hi = (hi & ~mh) | (sh & mh);
  // the match bit at nybble 2 pos (pos < 4) or 2 (pos - 4) + 1: a multiply
  // moves nybble 7 - that of 0x8C9DAEBF, the code, to the top (no FLO)
  return (((zl >> 7) | (zh >> 3)) * 0x8C9DAEBFu) >> 28;
}

// Copies src[0, m) (device memory) to dst[0, m) (shared memory), dst and
// src equal mod 16, by a group of kLanes lanes (`lane` its lane): the
// aligned middle by 16-byte loads, every load issued before the first
// store, the ends (under 16 bytes each) by byte loads.  m <= kMax.  Reads
// nothing outside src[0, m).
template <int kMax, int kLanes>
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* __restrict__ src, int m,
                                      int lane) {
  constexpr int kPer = (kMax / 16 + kLanes - 1) / kLanes;
  constexpr int kEnds = (15 + kLanes - 1) / kLanes;
  const int head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15), m);
  const int chunks = (m - head) >> 4;
  const int tail = head + (chunks << 4);
  const uint4* wide = reinterpret_cast<const uint4*>(src + head);
  uint4 v[kPer];
  uint32_t hb[kEnds], tb[kEnds];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    if (lane + kLanes * t < chunks) v[t] = __ldg(wide + lane + kLanes * t);
  }
#pragma unroll
  for (int t = 0; t < kEnds; ++t) {
    const int x = lane + kLanes * t;
    hb[t] = x < head ? __ldg(src + x) : 0u;
    tb[t] = tail + x < m ? __ldg(src + tail + x) : 0u;
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int u = lane + kLanes * t;
    if (u < chunks) *reinterpret_cast<uint4*>(dst + head + 16 * u) = v[t];
  }
#pragma unroll
  for (int t = 0; t < kEnds; ++t) {
    const int x = lane + kLanes * t;
    if (x < head) dst[x] = static_cast<uint8_t>(hb[t]);
    if (tail + x < m) dst[tail + x] = static_cast<uint8_t>(tb[t]);
  }
}

// The steps of row r (tile indexes r + lane) by context, from four
// ballots: `of_lane`, the steps whose context is this lane's number
// (meaningful on lanes 0-15); `of_mine`, the steps whose context is this
// lane's step's.  `ctx` is the lane's step's context.
__device__ __forceinline__ void context_masks(const uint8_t* tile, uint32_t before, int r, int len,
                                              int lane, uint32_t& ctx, uint32_t& of_lane,
                                              uint32_t& of_mine) {
  const int i = r + lane;
  const bool valid = i < len;
  const uint32_t prev = valid ? (i ? tile[i - 1] : before) : 0u;
  ctx = (prev >> 3) & 15;
  of_lane = of_mine = __ballot_sync(kFull, valid);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t bits = __ballot_sync(kFull, (ctx >> k) & 1);
    of_lane &= ((lane >> k) & 1) ? bits : ~bits;
    of_mine &= ((ctx >> k) & 1) ? bits : ~bits;
  }
}

__global__ void __launch_bounds__(32)
nybble_encode_kernel(const uint8_t* __restrict__ blocks, int64_t S,
                     const int32_t* __restrict__ lengths, uint8_t* __restrict__ rows, int64_t W,
                     int32_t* __restrict__ totals, int32_t* __restrict__ status, int B) {
  __shared__ __align__(16) uint8_t staged[kEncTile + 32];  // the tile's bytes, at their alignment
  __shared__ uint32_t bucket[kEncTile + 4];  // (tile index << 8) | byte, by context, in order
  __shared__ uint8_t code[kEncTile];         // step i: 8 | pos on a hit, 0 on a miss
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const uint32_t below = (1u << lane) - 1;
  const int64_t n = min(max(static_cast<int64_t>(lengths[b]), int64_t{0}), S);
  const uint8_t* src = blocks + static_cast<int64_t>(b) * S;
  uint8_t* dst = rows + static_cast<int64_t>(b) * W;
  if (W < (n ? n + 2 : 1)) {
    if (lane == 0) {
      totals[b] = 0;
      status[b] = kCapacity;
    }
    return;
  }
  if (n == 0) {
    if (lane == 0) {
      dst[0] = static_cast<uint8_t>(kType);
      totals[b] = 1;
      status[b] = kOk;
    }
    return;
  }
  const uint32_t first = __ldg(src);
  if (lane == 0) {
    dst[0] = static_cast<uint8_t>(kType);
    dst[1] = static_cast<uint8_t>(first);
  }
  uint32_t lo = kSeedLo, hi = kSeedHi;  // lane c < 16: context c's row
  uint32_t high = first;                // OR of the bytes: bit 7 means a byte >= 0x80
  uint32_t p = first;                   // the byte before the tile
  uint32_t pcode = 0;                   // its step's code
  uint32_t half = 0;                    // a compressed nybble pending before the tile
  int64_t o = 2;                        // output offset of the tile's first step
  // steps 1..n-1; the tile from step t0 holds steps t0 + i, i < len
  for (int64_t t0 = 1; t0 < n; t0 += kEncTile) {
    const int len = static_cast<int>(min(static_cast<int64_t>(kEncTile), n - t0));
    const uint8_t* tile = staged + (reinterpret_cast<uintptr_t>(src + t0) & 15);
    stage<kEncTile, 32>(const_cast<uint8_t*>(tile), src + t0, len, lane);
    __syncwarp();
    // bucket: count, then scatter in order (lane c: context c's cursor)
    int count = 0;
    for (int r = 0; r < len; r += 32) {
      uint32_t ctx, of_lane, of_mine;
      context_masks(tile, p, r, len, lane, ctx, of_lane, of_mine);
      count += __popc(of_lane);
      if (r + lane < len) high |= tile[r + lane];
    }
    if (lane >= 16) count = 0;
    int start = count;  // exclusive prefix over the contexts
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, start, d);
      if (lane >= d) start += v;
    }
    start -= count;
    int cursor = start;
    for (int r = 0; r < len; r += 32) {
      uint32_t ctx, of_lane, of_mine;
      context_masks(tile, p, r, len, lane, ctx, of_lane, of_mine);
      const int at = __shfl_sync(kFull, cursor, ctx) + __popc(of_mine & below);
      const int i = r + lane;
      if (i < len) bucket[at] = (static_cast<uint32_t>(i) << 8) | tile[i];
      cursor += __popc(of_lane);
    }
    __syncwarp();
    // walk: one chain per context, its row in registers; entries read two
    // steps ahead (the bucket's 4 spare entries keep those reads inside)
    if (lane < 16 && count > 0) {
      const int end = start + count;
      uint32_t e1 = bucket[start], e2 = bucket[start + 1];
      for (int j = start; j < end; ++j) {
        const uint32_t e = e1;
        e1 = e2;
        e2 = bucket[j + 2];
        code[e >> 8] = static_cast<uint8_t>(mtf(lo, hi, e));
      }
    }
    __syncwarp();
    // emit, a row of 32 steps at a time
    for (int r = 0; r < len; r += 32) {
      const int i = r + lane;
      const bool valid = i < len;
      const uint32_t c = valid ? code[i] : 0u;
      const uint32_t s = valid ? tile[i] : 0u;
      uint32_t cp = __shfl_up_sync(kFull, c, 1), sp = __shfl_up_sync(kFull, s, 1);
      if (lane == 0) {
        cp = pcode;
        sp = p;
      }
      const bool hit = c & 8u;
      const uint32_t in_row = __ballot_sync(kFull, valid);
      const uint32_t misses = __ballot_sync(kFull, valid && !hit);
      const uint32_t before = misses & below;
      // pending before step i: parity of the hits since the last miss
      const uint32_t h = before ? ((lane - 1 - (31 - __clz(before))) & 1)
                                : (half ^ (static_cast<uint32_t>(lane) & 1));
      const uint32_t halves = __ballot_sync(kFull, valid && h);
      const int64_t at = o + __popc(before) + __popc(halves & below);
      // hit: nothing, or the pending nybble and this one; miss: s, or the
      // byte before (re-expanded) and s
      const int emit = valid ? (hit ? static_cast<int>(h) : 1 + static_cast<int>(h)) : 0;
      const uint32_t b1 = hit ? ((cp << 4) | c) : (h ? sp : s);
      if (emit >= 1) dst[at] = static_cast<uint8_t>(b1);
      if (emit == 2) dst[at + 1] = static_cast<uint8_t>(s);
      o += __popc(misses) + __popc(halves);
      const int last = 31 - __clz(in_row);
      half = __shfl_sync(kFull, hit && !h, last);
      pcode = __shfl_sync(kFull, c, last);
      p = __shfl_sync(kFull, s, last);
    }
    __syncwarp();
  }
  high = __reduce_or_sync(kFull, high);
  if (lane == 0) {
    if (half) dst[o++] = static_cast<uint8_t>(p);  // trailing odd nybble: the last byte whole
    const bool bad = high & 0x80u;
    totals[b] = bad ? 0 : static_cast<int32_t>(o);
    status[b] = bad ? kInput : kOk;
  }
}

__device__ __forceinline__ int64_t lane_value(int64_t v, int g) {
  return __shfl_sync(kFull, static_cast<long long>(v), g);
}

// A run of body bytes as the automaton reads it: bits 0-1 the function
// (bit x: the state after the run from state x; state 0: a token starts
// at the next nybble, 1: the next nybble is a literal's second half),
// bits 8-19 / 20-31 the tokens that start inside the run from state 0 /
// 1.  kRunIdentity is the empty run.
constexpr uint32_t kRunIdentity = 2;

// One byte: from state 0 a token at its high nybble, and one at its low
// nybble if the high one is packed; from state 1 one at its low nybble.
__device__ __forceinline__ uint32_t byte_run(uint32_t v) {
  const uint32_t ph = (v >> 7) & 1, pl = (v >> 3) & 1;
  return (ph & (pl ^ 1)) | ((pl ^ 1) << 1) | ((1 + ph) << 8) | (1u << 20);
}

// Run a, then run b.
__device__ __forceinline__ uint32_t then(uint32_t a, uint32_t b) {
  const uint32_t a0 = a & 1, a1 = (a >> 1) & 1;
  const uint32_t f = ((b >> a0) & 1) | (((b >> a1) & 1) << 1);
  const uint32_t k0 = ((a >> 8) & 0xfff) + (a0 ? b >> 20 : (b >> 8) & 0xfff);
  const uint32_t k1 = (a >> 20) + (a1 ? b >> 20 : (b >> 8) & 0xfff);
  return f | (k0 << 8) | (k1 << 20);
}

// Copies a tile's bytes (the chain wrote each step's byte over its
// record in `recs`) to the output rows of its busy blocks, by the parse
// warp.
__device__ __forceinline__ void flush(uint8_t (*recs)[2 * kDecTile + 4], uint32_t busy,
                                      const int* taken, const int64_t* first_step,
                                      uint8_t* __restrict__ out, int64_t S, int lane) {
  for (int g = 0; g < kDecBlocks; ++g) {
    if (!((busy >> g) & 1)) continue;
    uint8_t* gdst = out + static_cast<int64_t>(blockIdx.x * kDecBlocks + g) * S + first_step[g];
    for (int q = lane; q < taken[g]; q += 32) gdst[q] = recs[g][q];
  }
}

__global__ void __launch_bounds__(64)
nybble_decode_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                     const int64_t* __restrict__ offsets, const int32_t* __restrict__ plens,
                     const int32_t* __restrict__ raw_lens, uint8_t* __restrict__ out, int64_t S,
                     int32_t* __restrict__ status, int B) {
  // the tile's body bytes and the next one, at their alignment
  __shared__ __align__(16) uint8_t body[kDecBlocks][kDecTile + 48];
  // two tiles of records in flight (tile t in half t & 1): a step's
  // record, then its byte
  __shared__ uint8_t rec[2][kDecBlocks][2 * kDecTile + 4];
  __shared__ __align__(128) uint2 table[kDecBlocks][16];
  __shared__ uint32_t tile_busy[2];              // the blocks with records in the half's tile
  __shared__ int tile_taken[2][kDecBlocks];      // their records
  __shared__ int64_t tile_step[2][kDecBlocks];   // the step of their first record
  __shared__ int64_t setup_n[kDecBlocks], setup_dlen[kDecBlocks], setup_at[kDecBlocks];
  __shared__ uint32_t setup_prev[kDecBlocks];
  __shared__ int setup_st[kDecBlocks];
  __shared__ int chain_warp;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < kDecBlocks * 16; e += 64) {
    table[e / 16][e % 16] = make_uint2(kSeedLo, kSeedHi);
  }
  if (tid == 0) {
    // a CTA's two warps take neighbouring warp slots and slot w issues
    // from scheduler w % 4: warp (slot >> 2) & 1 spreads the chains over
    // the four (%warpid: the slot now)
    uint32_t slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    chain_warp = (slot >> 2) & 1;
    tile_busy[0] = tile_busy[1] = 0;
  }
  if (tid < kDecBlocks) {
    const int b = blockIdx.x * kDecBlocks + tid;
    int64_t n = 0, dlen = 0, at = 0;
    uint32_t prev = 0;
    int st = kOk;
    if (b < B) {
      n = min(max(static_cast<int64_t>(raw_lens[b]), int64_t{0}), S);
      if (n > 0) {
        // the block's payload, clamped into flat
        const int64_t off = min(max(offsets[b], int64_t{0}), flat_len);
        const int64_t plen = min(max(static_cast<int64_t>(plens[b]), int64_t{0}), flat_len - off);
        if (plen < 2 || __ldg(flat + off) != kType) {
          st = kFormat;
          n = 0;
        } else {
          const uint32_t first = __ldg(flat + off + 1);
          out[static_cast<int64_t>(b) * S] = static_cast<uint8_t>(first);
          prev = first & 0x7f;
          at = off + 2;
          dlen = plen - 2;
        }
      }
    }
    setup_n[tid] = n;
    setup_dlen[tid] = dlen;
    setup_at[tid] = at;
    setup_prev[tid] = prev;
    setup_st[tid] = st;
  }
  __syncthreads();
  const bool parser = (tid >> 5) != chain_warp;
  const int g0 = min(lane, kDecBlocks - 1);
  // parse warp, lane g < kDecBlocks: block g's state
  int64_t n = lane < kDecBlocks ? setup_n[g0] : 0;  // raw length; 0 once the block is done
  const int64_t dlen = setup_dlen[g0];              // payload body bytes
  const int64_t body_at = setup_at[g0];             // the body's offset in flat
  int st = setup_st[g0];
  int64_t base = 0;    // body offset of the next tile
  int64_t k = 1;       // the next tile's first step
  uint32_t carry = 0;  // the automaton's state at the next tile's first nybble
  // chain warp, lane g < kDecBlocks: block g's chain
  uint32_t prev = setup_prev[g0];  // the byte before the step, bit 7 dropped (its context is bits 3-6)
  uint32_t last = 0;               // row offset (context x 8) of the previous step's context
  uint32_t nlo = kSeedLo, nhi = kSeedHi;  // the row it wrote (stored at the next step)
  char* const rows = reinterpret_cast<char*>(table[g0]);
  for (int t = 0;; ++t) {
    const int cur = t & 1, done = cur ^ 1;
    if (parser) {
      flush(rec[cur], tile_busy[cur], tile_taken[cur], tile_step[cur], out, S, lane);  // tile t - 2
      __syncwarp();
      if (k < n && base >= dlen) {  // the body ran out before the raw length
        st = kFormat;
        n = 0;
      }
      const uint32_t busy = __ballot_sync(kFull, k < n);  // lanes past kDecBlocks have n = 0
      int taken = 0;  // lane g: block g's records in tile t
      // parse each busy block's tile into records, 128 body bytes a
      // round, four a lane
      for (int g = 0; g < kDecBlocks; ++g) {
        if (!((busy >> g) & 1)) continue;
        const int64_t gbase = lane_value(base, g), gdlen = lane_value(dlen, g);
        const uint8_t* gsrc = flat + lane_value(body_at, g) + gbase;
        const int len = static_cast<int>(min(static_cast<int64_t>(kDecTile), gdlen - gbase));
        const int cap = static_cast<int>(min(static_cast<int64_t>(2 * kDecTile), lane_value(n - k, g)));
        const bool end_tile = gbase + len >= gdlen;
        const int align = static_cast<int>(reinterpret_cast<uintptr_t>(gsrc) & 15);
        uint8_t* const tile = body[g] + align;
        uint8_t* const recs = rec[cur][g];
        stage<kDecTile + 1, 32>(tile, gsrc, len + !end_tile, lane);
        __syncwarp();
        const uint32_t* words = reinterpret_cast<const uint32_t*>(body[g]);
        const int shift = 8 * (align & 3);
        uint32_t c = __shfl_sync(kFull, carry, g);
        int made = 0, r = 0;
        for (; r < len && made < cap; r += 128) {
          const int q = r + 4 * lane;  // the lane's first byte
          const int w = (align + q) >> 2;
          const uint32_t v = q < len ? __funnelshift_r(words[w], words[w + 1], shift) : 0u;
          const uint32_t nb = q + 4 < len + !end_tile ? tile[q + 4] : 0u;
          const int have = min(max(len - q, 0), 4);
          uint32_t run = kRunIdentity;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            if (x < have) run = then(run, byte_run(v >> (8 * x)));
          }
          uint32_t incl = run;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const uint32_t e = __shfl_up_sync(kFull, incl, d);  // the runs before, composed
            if (lane >= d) incl = then(e, incl);
          }
          uint32_t excl = __shfl_up_sync(kFull, incl, 1);
          if (lane == 0) excl = kRunIdentity;
          uint32_t s = (excl >> c) & 1;
          int at = made + static_cast<int>(c ? excl >> 20 : (excl >> 8) & 0xfff);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const uint32_t byte = v >> (8 * x) & 0xff;
            const uint32_t hi = byte >> 4, lo = byte & 15;
            const uint32_t next = (x < 3 ? v >> (8 * x + 12) : nb >> 4) & 15;
            const bool on = x < have;
            const bool t0 = on && s == 0;
            const bool t1 = on && (s == 1 || (hi & 8));
            if (t0 && at < cap) recs[at] = static_cast<uint8_t>(hi & 8 ? 0x80 | (hi & 7) : ((hi & 7) << 4) | lo);
            at += t0;
            if (t1 && at < cap) recs[at] = static_cast<uint8_t>(lo & 8 ? 0x80 | (lo & 7) : ((lo & 7) << 4) | next);
            at += t1;
            if (on) s = (byte_run(byte) >> s) & 1;
          }
          const uint32_t row = __shfl_sync(kFull, incl, 31);
          made += static_cast<int>(c ? row >> 20 : (row >> 8) & 0xfff);
          c = (row >> c) & 1;
        }
        // a literal on the body's last nybble would read past the body
        if (end_tile && r >= len && c == 1) --made;
        if (lane == g) {
          taken = min(made, cap);
          carry = c;
          base += len;
        }
      }
      if ((busy >> lane) & 1) {
        tile_taken[cur][lane] = taken;
        tile_step[cur][lane] = k;
        k += taken;
      }
      if (lane == 0) tile_busy[cur] = busy;
    } else if ((tile_busy[done] >> lane) & 1) {
      // chain: lane g walks block g's records of tile t - 1
      uint8_t* const recs = rec[done][lane];
      const int taken = tile_taken[done][lane];
      uint32_t t_next = recs[0];
      for (int j = 0; j < taken; ++j) {
        const uint32_t rc = t_next;
        t_next = recs[j + 1];
        const uint32_t at = prev & 0x78;  // context x 8
        uint2 r = *reinterpret_cast<const uint2*>(rows + at);
        *reinterpret_cast<uint2*>(rows + last) = make_uint2(nlo, nhi);
        if (at == last) r = make_uint2(nlo, nhi);
        const uint32_t o = (rc & 0x80) ? __byte_perm(r.x, r.y, rc & 7) : rc;
        mtf(r.x, r.y, o);
        nlo = r.x;
        nhi = r.y;
        last = at;
        recs[j] = static_cast<uint8_t>(o);
        prev = o;
      }
    }
    __syncthreads();
    if (!tile_busy[cur]) {  // tile t is empty: every block is done
      if (parser) flush(rec[done], tile_busy[done], tile_taken[done], tile_step[done], out, S, lane);
      break;
    }
  }
  const int b = blockIdx.x * kDecBlocks + lane;
  if (parser && lane < kDecBlocks && b < B) status[b] = st;
}


}  // namespace

extern "C" int dct_nybble_encode(const void* blocks, long long S, const void* lengths, void* rows,
                                 long long W, void* totals, void* status, int B, void* stream) {
  if (B > 0) {
    nybble_encode_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
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
    nybble_decode_kernel<<<(B + kDecBlocks - 1) / kDecBlocks, 64, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(flat), static_cast<int64_t>(flat_len),
        static_cast<const int64_t*>(offsets), static_cast<const int32_t*>(plens),
        static_cast<const int32_t*>(raw_lens), static_cast<uint8_t*>(out),
        static_cast<int64_t>(S), static_cast<int32_t*>(status), B);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of a nybble lane kernel resident on an SM at once (occupancy API),
// the blocks one CTA holds, its threads and its shared bytes; as
// dct_small_occupancy.
extern "C" int dct_nybble_occupancy(int decode, void* ctas, void* blocks_per_cta, void* threads,
                                    void* smem_bytes) {
  const void* fn = decode ? reinterpret_cast<const void*>(nybble_decode_kernel)
                          : reinterpret_cast<const void*>(nybble_encode_kernel);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(blocks_per_cta) = decode ? kDecBlocks : 1;
  const int block_threads = decode ? 64 : 32;
  *static_cast<int*>(threads) = block_threads;
  *static_cast<int*>(smem_bytes) = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(ctas), fn, block_threads, 0));
}
