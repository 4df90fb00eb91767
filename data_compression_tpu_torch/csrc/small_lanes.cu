// Context-LZW "small" codec lanes, one block per lane: scheme A
// (small_byte, kNybble = false) and scheme B (small_nybble, kNybble =
// true).  Encode [B, S] uint8 blocks into payload rows [B, W] with their
// totals; decode payloads (one flat buffer, per-block offsets) into
// [B, S] rows.
//
// Replaces data_compression_tpu/ops/scan_codecs.py
// `_small_byte_encode_lane` (:297, batch :421, driver :427),
// `_small_byte_decode_lane` (:191, :268, :274),
// `_small_nybble_encode_lane` (:454, :575, :581) and
// `_small_nybble_decode_lane` (:603, :687, :693): `lax.scan` lanes, one
// step per input symbol (encode) or per payload index (decode), vmapped
// across blocks.  They reach no Pallas kernel.  The lanes compute what
// native/libdctpu.c `dct_small_{byte,nybble}_{encode,decode}` compute
// (:248-617), byte for byte; what kNybble changes: nybble coordinates
// (a symbol is a nybble, low first), literal indexes 0x10-0x1F, 256
// slots with 0x80..0xFF allocated and wrapping to 0x80 (scheme A: 127
// slots, index 0x80 + slot), the -1 prefix of the first word.
//
// What bounds it on the card: the serial chain of one lane.  Every
// encoder step searches the current context's dictionary for a child of
// the word so far, and the next step's search starts from its answer;
// every decoder step's context is the last byte of the word before.  A
// 64 KiB block is 65,536 (scheme A) or 131,072 (scheme B) dependent
// search steps; bytes are no limit (64 MiB in and out moves in 0.04 ms).
//
// Encoder: one warp per block, one warp to a CTA.
//   * the dictionary keeps only what the search compares: per context
//     and slot a 32-bit key, prefix << 8 | letter (scheme A: prefix
//     0..0xFE, letter a whole byte) or prefix << 4 | letter (scheme B:
//     the -1 prefix of the first word is 0x1FF), in dynamic
//     shared memory, 32 x 128 x 4 = 16,384 bytes a warp: 13 CTAs an SM
//     (the occupancy API on the H100), so 1,026 blocks run in one wave,
//     where 48 KiB a warp ran 4 an SM in two.  A lane's four slots (l,
//     l + 32, l + 64, l + 96) of a context sit side by side, one 16-byte
//     load;
//   * no generation counters.  The C keeps a slot's gen and each key's
//     prefix_gen so that a child whose prefix slot has been rewritten no
//     longer matches (libdctpu.c:291-303, :479-505).  Here the insert
//     into slot s drops those children at once: every key of the context
//     whose prefix is slot s becomes kNoKey (prefix field 0xFFFFFF /
//     0xFFFFFFF, which no search asks for).  A key then matches exactly
//     when the C's key and gen check both pass (gens only grow, so a
//     dropped child never matches again; the new key's own prefix is
//     current when it is written), and nothing bounds the block size: no
//     counter can wrap.  Slots whose prefix is a literal or a scheme-B
//     default below 0x80 are never dropped, as in the C;
//   * every lane reads and writes only its own four slots of each
//     context, and a context's next-slot counter sits in the register of
//     the lane of that number (taken by `__shfl_sync`): no `__syncwarp`
//     and no shared counter.  The slot's owner commits the insert;
//   * the insert comes first.  The C searches the new word, then inserts
//     the previous word + the new word's first symbol into the previous
//     word's context at its next slot s, which it bans from the search
//     when the contexts are equal (libdctpu.c:322-343).  The search then
//     never reaches slot s: the banned slot is no result, so no index
//     and no key it compares names slot s.  Inserting first gives the
//     same output, and puts the insert where the previous word fails to
//     extend: into the context whose keys the registers hold, with the
//     key that failed (its index and the symbol that ends it);
//   * one loop step a symbol: the step tries to extend the word in
//     flight with symbol i.  Lane l compares the registers of its four
//     slots with the target key and offers, for each match, the index
//     that slot gives (0x80 + slot; ~0 for the banned slot, folded into
//     those four offers when a word starts), and `__reduce_min_sync`
//     gives the least: the C's first match.  Scheme B keeps the C's
//     shortcut, a literal prefix followed by a nybble that forms a
//     non-literal default below 0x80 is that default slot.  When the
//     word fails to extend, it is emitted, the insert is made in the
//     registers and stored by the lanes whose keys changed, and a word
//     starts at i.  The keys and slot counter of the context that word
//     would have are loaded at the start of every step, and the input is
//     read one symbol ahead, so no word start waits on a load;
//   * scheme A refuses a block with a byte >= 0x80: the C checks the
//     bytes at and before each word start, and every such byte is one of
//     those (no key has a letter >= 0x80, so no word extends over one),
//     so the loop ORs the bytes together and never leaves early;
//   * one step's chain: the target key from the index, the compares and
//     offers, a three-way minimum, the warp's minimum, the test and the
//     next index (scheme B: the shortcut's select).  Nothing in shared
//     memory is on it.
// Decoder: one CTA of two warps per block: one thread runs the serial
// chain, the other warp writes the output.
//   * the chain never reads the output: a step's context is the last
//     symbol of the word before, which the dictionary entry carries in its
//     tag (scheme A: first and last byte; scheme B: first nybble and the
//     last three).  A thread that also copied would wait, for each copied
//     symbol, on a global load behind the store before it;
//   * every word is one entry: a span's, or one of fixed symbols (indexes
//     below 0x80 read a fixed row: scheme A's literals, scheme B's
//     literals and defaults; a slot holds its default, fixed symbols,
//     until its first insert).  A step: the context, the entry, its start
//     and the context's next slot loaded together, the length, first and
//     last symbol by shifts, the insert's three stores, the exit test and
//     the record, the raw entry, which the copier decodes.  The chain is
//     software-pipelined: a step makes its insert and issues the next
//     step's lookup before its own exit test and record (a lookup past a
//     failing step is dropped).  Shared memory is addressed from a base
//     held in a register, the payload read two bytes ahead;
//   * no span overlaps its destination (the KwKwK case of the C,
//     libdctpu.c:283-287, :471-476, never arises here): the entry made at
//     step k is the word of step k - 1 and the first symbol of word k, so
//     it ends at position(k) + 1, and the first step that can use it
//     starts at position(k) + length(k) or later.  So the C's check that
//     a span ends by its position cannot fail and the chain leaves it
//     out; the copier still ends its jumps on a source at or past its own
//     lane;
//   * the ring holds 8 batches of 32 records; a full batch is published
//     by an mbarrier arrive (release, CTA scope), which the copier's wait
//     acquires, and the copier's arrive on the batch's empty barrier
//     returns the slot, which the chain awaits only when it comes round
//     to it; the last batch carries its count and kDone;
//   * the copier warp takes a batch at a time, places its words by a
//     prefix sum of their lengths and writes their symbols 32 at a time,
//     one lane a position: a fixed symbol, a symbol before the round read
//     from the finished row (one load for the 32 lanes), the round's
//     previous symbol from a register (the carry), or a symbol inside the
//     round taken by `__shfl_sync` from the lane that writes it (pointer
//     jumping: sources lie strictly before their position, so at most
//     five passes).  `__syncwarp` after each round orders its stores
//     before the next round's loads.  Scheme B packs as it writes: the
//     lane of an odd nybble stores the byte it ends, so there is no
//     nybble scratch row and no pack at the end;
//   * the dictionary, 32 contexts and the fixed row of 128 slots, in
//     dynamic shared memory: meta (32 bits: tag, length, for a narrow
//     entry a fixed-symbols bit and the start's top bits) and the start.
//     Lengths: the entry of length L was made from a word of length
//     L - 1, which used an entry made from a word of length L - 2, and so
//     on, so words of lengths L - 1 down to 2 lie apart in the output:
//     L (L - 1) / 2 - 1 <= N, the symbols of a block (scheme A S, scheme
//     B 2S).  Narrow layout, N <= 2^19 (scheme A S <= 512 KiB, scheme B
//     S <= 256 KiB; L <= 1024 fits 11 bits, a start < 2^19 16 + 3): 6
//     bytes a slot, 27,696 B a CTA with the ring and the chain's warp
//     number, 8 CTAs an SM on the H100, so 1,056 blocks run in one wave.
//     Wide layout, longer blocks (S < 2^28; L <= 2^15): 8 bytes a slot,
//     36,144 B, 6 CTAs an SM.  The block size S picks one (`narrow`).
// Bounds: the encoder checks up front that its row holds the worst case
// (scheme A n + 1, scheme B 2n bytes) and writes nothing past it; the
// decoder reads only inside its block's payload and writes only inside
// its output row: an index past the payload, a slot past
// the dictionary (0xFF in scheme A) or a word past the raw length ends
// the lane with status 3.  Status per block: 0 ok, 1 a byte >= 0x80
// (scheme A encode), 2 row too small (encode), 3 bad or truncated payload
// (decode).  No host read and no allocation: launches go on the caller's
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kCtx = 32;
constexpr int kStride = 128;  // stored slots per context (scheme A uses 127)
constexpr int kOk = 0, kInput = 1, kCapacity = 2, kFormat = 3;
constexpr uint32_t kType = 8;  // EIGHT_BIT_PRUNED
constexpr uint32_t kNoKey = 0xffffffffu;  // a pad or dropped slot: its prefix field no search asks for
constexpr uint32_t kFull = 0xffffffffu;  // every lane of the warp
constexpr size_t kEncodeSmem = kCtx * kStride * sizeof(uint32_t);

template <bool kNybble>
struct Scheme {
  static constexpr int kSlots = kNybble ? 128 : 127;  // stored slots per context
  static constexpr int kMaxLen = kNybble ? 511 : 255;  // encoder match cap, in symbols
  static constexpr int kFirst = kNybble ? 2 : 1;  // symbols of the verbatim first byte
  static constexpr int kLetterBits = kNybble ? 4 : 8;
  // encoder key of (prefix index, letter): prefix 0..0xFE (scheme A) or
  // 0x10..0xFF and 0x1FF, the -1 of the first word (scheme B)
  __device__ static uint32_t key(uint32_t prefix, uint32_t letter) {
    return (prefix << kLetterBits) | letter;
  }
  // the default key of stored slot s (scheme A: ' ' + (s ? s : 'x'), the
  // pad slot 127 none; scheme B, slot 0x80 + s: its own two nybbles)
  __device__ static uint32_t default_key(int s) {
    if (kNybble) return key((s & 15) | 0x10, 8u + (s >> 4));
    return s < kSlots ? key(' ', s ? s : 'x') : kNoKey;
  }
};

__device__ __forceinline__ bool is_literal_nyb(int x) { return (x | 0xF) == 0x1F; }

template <bool kNybble>
__device__ __forceinline__ uint32_t symbol_at(const uint8_t* src, int i) {
  if (!kNybble) return __ldg(src + i);
  const uint32_t byte = __ldg(src + (i >> 1));
  return (i & 1) ? (byte >> 4) : (byte & 15u);
}

// The lane's four keys of a context, loaded where the source puts the
// load: a volatile load with a memory clobber, so that the compiler
// neither sinks it into the word-start branch, where its latency would
// sit on the chain, nor hoists it above the stores before it.
__device__ __forceinline__ uint4 load_keys(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
}

template <bool kNybble>
__global__ void __launch_bounds__(32)
small_encode_kernel(const uint8_t* __restrict__ blocks, int64_t S,
                    const int32_t* __restrict__ lengths, uint8_t* __restrict__ rows, int64_t W,
                    int32_t* __restrict__ totals, int32_t* __restrict__ status) {
  using Sc = Scheme<kNybble>;
  extern __shared__ __align__(16) unsigned char smem[];
  // keys[ctx * 32 + lane] = the keys of slots lane, lane + 32, lane + 64,
  // lane + 96 of ctx; only that lane reads or writes them
  uint4* keys = reinterpret_cast<uint4*>(smem);
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t n = min(max(static_cast<int64_t>(lengths[b]), int64_t{0}), S);
  const uint8_t* src = blocks + b * S;
  uint8_t* dst = rows + b * W;
  const int64_t need = n == 0 ? 1 : (kNybble ? 2 * n : n + 1);
  if (W < need) {
    if (lane == 0) {
      totals[b] = 0;
      status[b] = kCapacity;
    }
    return;
  }
  if (lane == 0) dst[0] = static_cast<uint8_t>(kType);
  if (n == 0) {
    if (lane == 0) {
      totals[b] = 1;
      status[b] = kOk;
    }
    return;
  }
  const uint32_t src0 = __ldg(src);
  if (lane == 0) dst[1] = static_cast<uint8_t>(src0);
  if (!kNybble && n == 1 && (src0 & 0x80u)) {  // the C checks bytes at word starts only
    if (lane == 0) {
      totals[b] = 0;
      status[b] = kInput;
    }
    return;
  }
  const uint4 init = make_uint4(Sc::default_key(lane), Sc::default_key(lane + 32),
                                Sc::default_key(lane + 64), Sc::default_key(lane + 96));
  for (int c = 0; c < kCtx; ++c) keys[c * 32 + lane] = init;

  const int N = static_cast<int>(kNybble ? 2 * n : n);  // symbols (S < 2^28)
  // The word in flight: its context (whose keys k holds), index and
  // length; s is the next slot of its context (nwi[ctx]), banned the
  // slot its search skips.  It starts as the verbatim first byte, in the
  // context of ' ', with the length cap, so that step kFirst ends it:
  // that step inserts it + symbol kFirst and starts the first word (its
  // emission lands on dst[1], which gets the first byte again at the end).
  int ctx = ' ' & 31;
  uint4 kv = keys[ctx * 32 + lane];
  uint32_t k0 = kv.x, k1 = kv.y, k2 = kv.z, k3 = kv.w;
  uint32_t idx = kNybble ? 0x1FFu : src0;
  int len = Sc::kMaxLen;
  int s = 0;
  // the index each of the lane's slots gives when it matches, ~0 for the
  // banned slot (none yet): the search takes the least
  const uint32_t own0 = 0x80u + lane, own1 = own0 + 32, own2 = own0 + 64, own3 = own0 + 96;
  uint32_t g0 = own0, g1 = own1, g2 = own2, g3 = own3;
  uint32_t nwi = 0;  // lane c: nwi[c] (stored slots; every context starts at its first)
  // symbol i and the context byte of a word starting at i, read one ahead
  // (past the end, the last symbol again: never used)
  const int last = N - 1;
  uint32_t c = symbol_at<kNybble>(src, min(Sc::kFirst, last));
  uint32_t x = src0;  // scheme A: byte i - 1; scheme B: byte (i >> 1) - 1
  // scheme A: the C refuses a block at the first word start whose byte or
  // the byte before is >= 0x80; every byte >= 0x80 is one of those (no key
  // has such a letter, so no word extends over it), so the loop only
  // gathers the bytes' top bits and runs on
  uint32_t high = src0;
  int o = 1;
#pragma unroll 2  // two steps a pass: no register copies of the read-ahead
  for (int i = Sc::kFirst; i < N; ++i) {
    const int ahead = min(i + 1, last);
    const uint32_t c_next = symbol_at<kNybble>(src, ahead);
    const uint32_t x_next = kNybble ? __ldg(src + (ahead >> 1) - 1) : c;
    high |= c;
    // what a word starting at i needs: the keys and next slot of its
    // context, loaded before the search decides
    const int nctx = x & 31;
    const uint4 nk = load_keys(keys + nctx * 32 + lane);
    const int ns = __shfl_sync(kFull, static_cast<int>(nwi), nctx);
    // extend the word in flight with symbol i: the first slot whose key
    // is the target, the banned slot aside
    const uint32_t target = Sc::key(idx, c);
    uint32_t w = __reduce_min_sync(  // the grown index, or ~0
        kFull, min(min(k0 == target ? g0 : ~0u, k1 == target ? g1 : ~0u),
                   min(k2 == target ? g2 : ~0u, k3 == target ? g3 : ~0u)));
    if (kNybble && is_literal_nyb(idx)) {
      const uint32_t d0 = (idx & 15u) | (c << 4);
      if (d0 < 0x80u && !is_literal_nyb(d0)) w = d0;
    }
    if (len < Sc::kMaxLen && w < 0x100u) {
      idx = w;
      ++len;
    } else {
      // the word ends before symbol i: emit it, insert it + symbol i into
      // ctx at slot s (the key that failed), drop the keys whose prefix is
      // slot s; the lanes whose keys changed store them
      if (lane == 0) dst[o] = static_cast<uint8_t>(idx);
      ++o;
      const uint32_t child = 0x80u + s;
      const auto patch = [&](uint32_t v, int slot) {
        return slot == s ? target : ((v >> Sc::kLetterBits) == child ? kNoKey : v);
      };
      const uint32_t p0 = patch(k0, lane), p1 = patch(k1, lane + 32), p2 = patch(k2, lane + 64),
                     p3 = patch(k3, lane + 96);
      if (p0 != k0 || p1 != k1 || p2 != k2 || p3 != k3)
        keys[ctx * 32 + lane] = make_uint4(p0, p1, p2, p3);
      const int s_next = s + 1 == Sc::kSlots ? 0 : s + 1;  // the context's next slot
      if (lane == ctx) nwi = static_cast<uint32_t>(s_next);
      // a word starts at i in nctx
      const bool same = nctx == ctx;
      k0 = same ? p0 : nk.x;
      k1 = same ? p1 : nk.y;
      k2 = same ? p2 : nk.z;
      k3 = same ? p3 : nk.w;
      // banned: slot s, when the contexts are the same
      const uint32_t ban = same ? child : 0u;
      g0 = own0 == ban ? ~0u : own0;
      g1 = own1 == ban ? ~0u : own1;
      g2 = own2 == ban ? ~0u : own2;
      g3 = own3 == ban ? ~0u : own3;
      s = same ? s_next : ns;
      ctx = nctx;
      idx = kNybble ? c | 0x10u : c;
      len = 1;
    }
    c = c_next;
    x = x_next;
  }
  const int st = !kNybble && (high & 0x80u) ? kInput : kOk;
  if (lane == 0) {
    dst[1] = static_cast<uint8_t>(src0);
    if (st == kOk && N > Sc::kFirst) dst[o] = static_cast<uint8_t>(idx);  // the word in flight
  }
  o = N > Sc::kFirst ? o + 1 : 2;
  if (lane == 0) {
    totals[b] = st == kOk ? static_cast<int32_t>(o) : 0;
    status[b] = st;
  }
}

// Decoder dictionary entries (the header's derivation): meta = tag |
// length << 16, the tag scheme A first | last << 8, scheme B first | last
// three << 4.  Narrow: length 11 bits, bit 27 set for a word of fixed
// symbols (a literal or a slot's default), start >> 16 in bits 28-30,
// and the start's low half in a u16.  Wide: length 16 bits and a u32
// start, kFixedStart for fixed symbols.  A fixed word's symbols are its
// tag's first and last.
constexpr int kNarrowSymbols = 1 << 19;  // most symbols a block of the narrow layout holds
constexpr int kFixedRow = kCtx;  // the entries of indexes below 0x80, whatever the context
constexpr int kBatch = 32;  // records a batch: one publish, one copier round of words
constexpr int kBatches = 8;  // batches in the ring
constexpr int kDone = 1 << 8;  // batch count: the chain's last batch
constexpr unsigned kSleepNs = 256;  // the copier's sleep between polls of a full barrier
constexpr int kAhead = 2;  // payload bytes the chain reads ahead
constexpr uint32_t kFixedStart = 0x80000000u;  // wide start of a word of fixed symbols

template <bool kNarrow>
struct DecodeLayout {
  using Start = typename std::conditional<kNarrow, uint16_t, uint32_t>::type;
  // ring [kBatches][kBatch] uint2 (records: an entry's meta and start),
  // full and empty mbarriers [kBatches], counts [kBatches] int32, meta
  // [kCtx + 1][kStride] u32, start [kCtx + 1][kStride], nwi [kCtx] int32
  static constexpr size_t kFull = kBatches * kBatch * sizeof(uint2);
  static constexpr size_t kEmpty = kFull + kBatches * sizeof(uint64_t);
  static constexpr size_t kCount = kEmpty + kBatches * sizeof(uint64_t);
  static constexpr size_t kMeta = kCount + kBatches * sizeof(int32_t);
  static constexpr size_t kStart = kMeta + (kCtx + 1) * kStride * sizeof(uint32_t);
  static constexpr size_t kNwi = kStart + (kCtx + 1) * kStride * sizeof(Start);
  static constexpr size_t kSmem = kNwi + kCtx * sizeof(int32_t);
  static constexpr uint32_t kLenMask = kNarrow ? 0x7FFu : 0xFFFFu;
  static constexpr uint32_t kFixed = kNarrow ? 1u << 27 : 0u;
  __device__ static uint32_t length(uint32_t m) { return (m >> 16) & kLenMask; }
  // a span's entry: start < 2^19 (narrow) or 2^29
  __device__ static uint32_t meta(uint32_t tag, uint32_t len, uint32_t start) {
    return tag | (len << 16) | (kNarrow ? (start >> 16) << 28 : 0u);
  }
  __device__ static uint32_t fixed(uint32_t tag, uint32_t len) { return tag | (len << 16) | kFixed; }
  __device__ static bool is_fixed(uint32_t m, uint32_t lo) {
    return kNarrow ? (m & kFixed) != 0 : lo == kFixedStart;
  }
  __device__ static uint32_t start(uint32_t m, uint32_t lo) {
    return kNarrow ? lo | (((m >> 28) & 7u) << 16) : lo;
  }
};

// Shared memory by 32-bit address, for the chain: the base stays in a
// register (a generic pointer's window is otherwise recomputed in the
// loop), and the accesses keep their order among themselves.
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds16(uint32_t a) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v));
}
__device__ __forceinline__ void sts16(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;" ::"r"(a), "h"(static_cast<uint16_t>(v)));
}
__device__ __forceinline__ void sts64(uint32_t a, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(a), "r"(x), "r"(y));
}
// mbarriers (release on arrive, acquire on wait, CTA scope: the defaults)
__device__ __forceinline__ void bar_init(uint32_t a, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(a) : "memory");
}
__device__ __forceinline__ bool bar_try(uint32_t a, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  return done != 0;
}
// A payload byte, loaded where the source puts it (ahead of its use).
__device__ __forceinline__ uint32_t ldg_byte(const uint8_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// Symbol s of the finished row: scheme A a byte, scheme B a nybble of the
// packed row (low first).  A plain load: this warp wrote it.
template <bool kNybble>
__device__ __forceinline__ uint32_t finished_symbol(const uint8_t* row, uint32_t s) {
  if (!kNybble) return row[s];
  const uint32_t byte = row[s >> 1];
  return (s & 1) ? (byte >> 4) : (byte & 15u);
}

// The copier warp: batch j of the ring (slot j % kBatches) once its full
// barrier completes, its words' symbols written 32 at a time from
// position base; until the chain's last batch.
template <bool kNybble, bool kNarrow>
__device__ void copy_words(const uint2* ring, uint32_t full, uint32_t empty, const int* counts,
                           uint8_t* row) {
  using Ly = DecodeLayout<kNarrow>;
  const int lane = threadIdx.x & 31;
  uint32_t base = 0, carry = 0;
  for (int j = 0;; ++j) {
    const int slot = j % kBatches;
    while (!bar_try(full + 8 * slot, (j / kBatches) & 1)) __nanosleep(kSleepNs);
    const int count = counts[slot];
    const bool here = lane < (count & (kDone - 1));
    const uint2 r = here ? ring[slot * kBatch + lane] : make_uint2(0, 0);
    // the word: its length, and its span's start or its fixed symbols
    const uint32_t wl = here ? Ly::length(r.x) : 0u;
    const bool fixed = Ly::is_fixed(r.x, r.y);
    const uint32_t from = fixed ? (kNybble ? (r.x & 15u) | ((r.x << 4) & 0xF00u) : r.x & 0xFFFFu)
                                : Ly::start(r.x, r.y);
    uint32_t incl = wl;  // the words' ends, relative to base
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const uint32_t pos = base + incl - wl;
    const uint32_t end = base + __shfl_sync(kFull, incl, 31);
    for (uint32_t c0 = base; c0 < end; c0 += 32) {
      const uint32_t p = c0 + lane;
      const bool act = p < end;
      // the word of position p: the last one starting at or before it
      const uint32_t off = pos - c0;
      const uint32_t starts = __reduce_or_sync(kFull, wl != 0 && off < 32 ? 1u << off : 0u);
      const int before = __popc(__ballot_sync(kFull, wl != 0 && pos < c0));
      const int w = min(max(before + __popc(starts & ((2u << lane) - 1u)) - 1, 0), 31);
      const uint32_t pw = __shfl_sync(kFull, pos, w);
      const uint32_t fw = __shfl_sync(kFull, from, w);
      const bool fixed_w = __shfl_sync(kFull, fixed, w);
      const uint32_t q = p - pw;
      uint32_t val = 0;
      int ref = -1;  // the lane of this round whose symbol this is
      if (act) {
        if (fixed_w) {
          val = (fw >> (8 * q)) & 0xFFu;
        } else {
          const uint32_t s = fw + q;  // < pw <= p (start + length <= position)
          if (s >= c0)
            ref = min(static_cast<int>(s - c0), lane - 1);  // min: ends the jumps on any record
          else if (s + 1 == c0)
            val = carry;
          else
            val = finished_symbol<kNybble>(row, s);
        }
      }
      while (__any_sync(kFull, ref >= 0)) {
        const int src = ref >= 0 ? ref : lane;
        const uint32_t v = __shfl_sync(kFull, val, src);
        const int further = __shfl_sync(kFull, ref, src);
        if (ref >= 0) {
          val = v;
          ref = further;
        }
      }
      if (kNybble) {
        const uint32_t prev = __shfl_up_sync(kFull, val, 1);
        if (act && (p & 1)) row[p >> 1] = static_cast<uint8_t>((lane ? prev : carry) | (val << 4));
      } else if (act) {
        row[p] = static_cast<uint8_t>(val);
      }
      carry = __shfl_sync(kFull, val, static_cast<int>(min(end - 1 - c0, 31u)));
      __syncwarp();
    }
    base = end;
    if (count & kDone) return;
    if (lane == 0) bar_arrive(empty + 8 * slot);
  }
}

template <bool kNybble, bool kNarrow>
__global__ void __launch_bounds__(64)
small_decode_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                    const int64_t* __restrict__ offsets, const int32_t* __restrict__ plens,
                    const int32_t* __restrict__ raw_lens, uint8_t* out, int64_t S,
                    int32_t* __restrict__ status) {
  using Sc = Scheme<kNybble>;
  using Ly = DecodeLayout<kNarrow>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t n = min(max(static_cast<int64_t>(raw_lens[b]), int64_t{0}), S);
  if (n == 0) {
    if (tid == 0) status[b] = kOk;
    return;
  }
  const int64_t off = min(max(offsets[b], int64_t{0}), flat_len);
  const int plen_in = static_cast<int>(
      min(max(static_cast<int64_t>(plens[b]), int64_t{0}), flat_len - off));
  const uint8_t* payload = flat + off;
  if (plen_in < 2 || __ldg(payload) != kType) {
    if (tid == 0) status[b] = kFormat;
    return;
  }
  uint32_t sb = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("" : "+r"(sb));  // held in a register from here on
  // every slot its default, and the fixed row: scheme A literal x (x <
  // 0x80), slot s ' ' + (s ? s : 'x'); scheme B index x (slot 0x80 + s)
  // its own nybbles, one for a literal 0x10-0x1F, else two
  uint32_t* meta = reinterpret_cast<uint32_t*>(smem + Ly::kMeta);
  typename Ly::Start* starts = reinterpret_cast<typename Ly::Start*>(smem + Ly::kStart);
  for (int e = tid; e < (kCtx + 1) * kStride; e += blockDim.x) {
    const uint32_t x = (e / kStride == kFixedRow ? 0u : 0x80u) + e % kStride;  // the index
    uint32_t tag, len;
    if (kNybble) {  // first | last three << 4: a literal's nybble, or (first, second)
      const bool lit = is_literal_nyb(static_cast<int>(x));
      len = lit ? 1u : 2u;
      tag = lit ? (x & 15u) * 0x11u : (x & 15u) | ((x >> 4) << 4) | ((x & 15u) << 8);
    } else {
      len = x < 0x80u ? 1u : 2u;
      tag = x < 0x80u ? x | (x << 8) : ' ' | ((x == 0x80u ? 'x' : x - 0x80u) << 8);
    }
    meta[e] = Ly::fixed(tag, len);
    if (!kNarrow) starts[e] = kFixedStart;
  }
  if (tid < kCtx) reinterpret_cast<int32_t*>(smem + Ly::kNwi)[tid] = 0;
  if (tid < kBatches) {
    bar_init(sb + Ly::kFull + 8 * tid, 1);
    bar_init(sb + Ly::kEmpty + 8 * tid, 1);
  }
  // which warp runs the chain: a CTA's two warps take neighbouring warp
  // slots of the SM and slot w issues from scheduler w % 4, so warp 0 of
  // every CTA would put all chains on two of the four schedulers; warp
  // (slot >> 2) & 1 spreads them over the four (%warpid: the slot now)
  __shared__ int chain_warp;
  if (tid == 0) {
    uint32_t slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    chain_warp = (slot >> 2) & 1;
  }
  __syncthreads();
  if ((tid >> 5) != chain_warp) {
    copy_words<kNybble, kNarrow>(reinterpret_cast<const uint2*>(smem), sb + Ly::kFull,
                                 sb + Ly::kEmpty, reinterpret_cast<const int*>(smem + Ly::kCount),
                                 out + b * S);
    return;
  }
  if ((tid & 31) != 0) return;

  // The chain: record k (an entry's meta and start) into ring slot k %
  // (kBatches x kBatch); a full batch is published on its full barrier,
  // and the next batch's slot is awaited on its empty barrier.
  int k = 0;
  int* counts = reinterpret_cast<int*>(smem + Ly::kCount);
  const auto push = [&](uint32_t m, uint32_t lo) {
    sts64(sb + 8 * (k % (kBatches * kBatch)), m, lo);
    if (++k % kBatch == 0) {
      const int j = k / kBatch - 1;  // the batch just filled
      counts[j % kBatches] = kBatch;
      bar_arrive(sb + Ly::kFull + 8 * (j % kBatches));
      const int next = j + 1;  // its slot's last batch must be copied
      while (!bar_try(sb + Ly::kEmpty + 8 * (next % kBatches), (next / kBatches + 1) & 1)) {
      }
    }
  };
  const uint32_t target = static_cast<uint32_t>(kNybble ? 2 * n : n);  // < 2^29
  const uint32_t p1 = __ldg(payload + 1);
  // the verbatim first byte: its word, the output's last symbol (scheme B:
  // last three nybbles), the previous word in the context of ' '
  uint32_t len_out, tail3;
  if (kNybble) {
    push(Ly::fixed((p1 & 15u) | ((p1 & 15u) << 8) | ((p1 >> 4) << 4), 2), kFixedStart);
    tail3 = ((p1 & 15u) << 4) | (p1 >> 4);
    len_out = 2;
  } else {
    push(Ly::fixed(p1 | (p1 << 8), 1), kFixedStart);
    tail3 = p1;
    len_out = 1;
  }
  int pctx = ' ' & 31, sl = 0;  // sl: pctx's next slot
  uint32_t ppos = 0, plen = Sc::kFirst;
  uint32_t pfirst = kNybble ? (p1 & 15u) : p1, plast = tail3;
  const uint32_t m_base = sb + Ly::kMeta, s_base = sb + Ly::kStart, n_base = sb + Ly::kNwi;
  int i = 2;  // the next step's payload index
  uint32_t ahead[kAhead];  // payload bytes i .. i + kAhead - 1 (past the end: the last again)
#pragma unroll
  for (int u = 0; u < kAhead; ++u) ahead[u] = ldg_byte(payload + min(i + u, plen_in - 1));
  // A step's lookup: its context from the output so far, its index, the
  // entry (indexes below 0x80: the fixed row), its start and the
  // context's next slot, loaded together.  It is issued as soon as the
  // step before has made its insert, ahead of that step's exit test and
  // record (a lookup past the end of the block reads a slot and is
  // dropped).
  int ctx;
  uint32_t m, lo;
  int nsl;
  bool over;
  uint32_t idx;
  const auto lookup = [&]() {
    if (kNybble) {  // the last complete output byte, from the last three nybbles
      const uint32_t byte = (len_out & 1) ? ((tail3 >> 8) & 15u) | (((tail3 >> 4) & 15u) << 4)
                                          : ((tail3 >> 4) & 15u) | ((tail3 & 15u) << 4);
      ctx = byte & 31;
    } else {
      ctx = tail3 & 31;
    }
    idx = ahead[0];
#pragma unroll
    for (int u = 0; u + 1 < kAhead; ++u) ahead[u] = ahead[u + 1];
    ahead[kAhead - 1] = ldg_byte(payload + min(i + kAhead, plen_in - 1));
    over = i >= plen_in;  // the payload ran out
    ++i;
    const uint32_t e = (idx < 0x80u ? kFixedRow : ctx) * kStride + (idx & (kStride - 1));
    m = lds32(m_base + 4 * e);
    lo = kNarrow ? lds16(s_base + 2 * e) : lds32(s_base + 4 * e);
    nsl = static_cast<int>(lds32(n_base + 4 * ctx));
  };
  int st = kOk;
  if (len_out < target) lookup();
#pragma unroll 2
  while (len_out < target) {
    const uint32_t wl = Ly::length(m);
    const uint32_t first = kNybble ? m & 15u : m & 0xFFu;
    const uint32_t last = kNybble ? (m >> 4) & 0xFFFu : (m >> 8) & 0xFFu;
    const uint32_t pos = len_out;
    const bool bad = over || (!kNybble && idx == 0xFFu) || pos + wl > target;  // 0xFF: no slot
    const uint32_t m_word = m, lo_word = lo;
    // insert the previous word + this word's first symbol into pctx
    const uint32_t elast = kNybble ? (((plast << 4) | first) & 0xFFFu) : first;
    const uint32_t tag = kNybble ? (pfirst | (elast << 4)) : (pfirst | (elast << 8));
    const uint32_t pe = static_cast<uint32_t>(pctx * kStride + sl);
    sts32(m_base + 4 * pe, Ly::meta(tag, plen + 1, ppos));
    if (kNarrow)
      sts16(s_base + 2 * pe, ppos);
    else
      sts32(s_base + 4 * pe, ppos);
    const int sl_next = sl + 1 == Sc::kSlots ? 0 : sl + 1;
    sts32(n_base + 4 * pctx, static_cast<uint32_t>(sl_next));
    sl = ctx == pctx ? sl_next : nsl;
    pctx = ctx;
    ppos = pos;
    plen = wl;
    pfirst = first;
    plast = last;
    if (kNybble) {
      tail3 = wl >= 3 ? (last & 0xFFFu)
                      : ((tail3 << (4 * wl)) | (last & ((1u << (4 * wl)) - 1u))) & 0xFFFu;
    } else {
      tail3 = last;
    }
    len_out = pos + wl;
    lookup();  // the next step's
    if (bad) {
      st = kFormat;
      break;
    }
    push(m_word, lo_word);
  }
  // the last batch, partial or empty (its slot was awaited when the one
  // before it filled)
  const int j = k / kBatch;
  counts[j % kBatches] = (k % kBatch) | kDone;
  bar_arrive(sb + Ly::kFull + 8 * (j % kBatches));
  status[b] = st;
}

template <bool kNybble>
void launch_encode(const void* blocks, int64_t S, const void* lengths, void* rows, int64_t W,
                   void* totals, void* status, int B, cudaStream_t stream) {
  small_encode_kernel<kNybble><<<B, 32, kEncodeSmem, stream>>>(
      static_cast<const uint8_t*>(blocks), S, static_cast<const int32_t*>(lengths),
      static_cast<uint8_t*>(rows), W, static_cast<int32_t*>(totals),
      static_cast<int32_t*>(status));
}

template <bool kNybble, bool kNarrow>
void launch_decode(const void* flat, int64_t flat_len, const void* offsets, const void* plens,
                   const void* raw_lens, void* out, int64_t S, void* status, int B,
                   cudaStream_t stream) {
  small_decode_kernel<kNybble, kNarrow><<<B, 64, DecodeLayout<kNarrow>::kSmem, stream>>>(
      static_cast<const uint8_t*>(flat), flat_len, static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(plens), static_cast<const int32_t*>(raw_lens),
      static_cast<uint8_t*>(out), S, static_cast<int32_t*>(status));
}

// The narrow layout holds blocks of at most kNarrowSymbols symbols.
bool narrow(bool nybble, int64_t S) { return (nybble ? 2 * S : S) <= kNarrowSymbols; }

}  // namespace

extern "C" int dct_small_encode(int nybble, const void* blocks, long long S, const void* lengths,
                                void* rows, long long W, void* totals, void* status, int B,
                                void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (nybble)
      launch_encode<true>(blocks, S, lengths, rows, W, totals, status, B, s);
    else
      launch_encode<false>(blocks, S, lengths, rows, W, totals, status, B, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dct_small_decode(int nybble, const void* flat, long long flat_len,
                                const void* offsets, const void* plens, const void* raw_lens,
                                void* out, long long S, void* status, int B, void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (nybble && narrow(true, S))
      launch_decode<true, true>(flat, flat_len, offsets, plens, raw_lens, out, S, status, B, s);
    else if (nybble)
      launch_decode<true, false>(flat, flat_len, offsets, plens, raw_lens, out, S, status, B, s);
    else if (narrow(false, S))
      launch_decode<false, true>(flat, flat_len, offsets, plens, raw_lens, out, S, status, B, s);
    else
      launch_decode<false, false>(flat, flat_len, offsets, plens, raw_lens, out, S, status, B, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of one lane kernel resident on an SM at once, by the occupancy
// API at the launch's block size and shared memory (a decoder's at block
// size S, which picks its layout); the blocks (lanes) one CTA holds, its
// threads and its shared bytes (static + dynamic): a launch of B blocks
// runs in ceil(B / (ctas x SMs x lanes)) waves.
extern "C" int dct_small_occupancy(int decode, int nybble, long long S, void* ctas,
                                   void* lanes_per_cta, void* threads, void* smem_bytes) {
  const bool nar = narrow(nybble != 0, S);
  const void* fn;
  if (decode)
    fn = nybble ? (nar ? reinterpret_cast<const void*>(small_decode_kernel<true, true>)
                       : reinterpret_cast<const void*>(small_decode_kernel<true, false>))
                : (nar ? reinterpret_cast<const void*>(small_decode_kernel<false, true>)
                       : reinterpret_cast<const void*>(small_decode_kernel<false, false>));
  else
    fn = nybble ? reinterpret_cast<const void*>(small_encode_kernel<true>)
                : reinterpret_cast<const void*>(small_encode_kernel<false>);
  const int block = decode ? 64 : 32;
  const size_t dynamic =
      decode ? (nar ? DecodeLayout<true>::kSmem : DecodeLayout<false>::kSmem) : kEncodeSmem;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(lanes_per_cta) = 1;
  *static_cast<int*>(threads) = block;
  *static_cast<int*>(smem_bytes) = static_cast<int>(attr.sharedSizeBytes + dynamic);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(ctas), fn, block, dynamic));
}
