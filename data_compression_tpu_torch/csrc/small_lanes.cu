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
// Decoder: one thread per block, one thread to a CTA.
//   * the span dictionary, one 64-bit entry per context and slot, sits
//     in dynamic shared memory (32 x 128 x 8 = 32 KiB, 6 CTAs an SM by
//     the occupancy API on the H100, so 1,024 blocks take two waves):
//     start (32 bits, all ones for a default), length (16 bits), and the
//     word's first and last symbol (scheme A: first and last byte;
//     scheme B: first nybble and the last three), so a step never reads
//     the output: the next context comes from the entry.  Widths: the
//     wrapper takes S < 2^28, so starts fit 32 bits, and an entry's
//     length L needs words of every length below it in the output, so
//     L (L - 1) / 2 <= 2S keeps L below 2^16;
//   * the copy of a span is serial in the thread, symbol by symbol, so a
//     span that overlapped its destination (the KwKwK case,
//     libdctpu.c:283-287, :471-476) would copy right; by construction an
//     entry's span ends at most at the current position, and the check
//     below (start + length <= position) keeps every read behind the
//     write on any stream;
//   * scheme B decodes into a nybble scratch row (one byte a nybble) and
//     packs it into the output row at the end.
// Bounds: the encoder checks up front that its row holds the worst case
// (scheme A n + 1, scheme B 2n bytes) and writes nothing past it; the
// decoder reads only inside its block's payload and writes only inside
// its output (and scratch) row: an index past the payload, a slot past
// the dictionary (0xFF in scheme A) or a word past the raw length ends
// the lane with status 3.  Status per block: 0 ok, 1 a byte >= 0x80
// (scheme A encode), 2 row too small (encode), 3 bad or truncated payload
// (decode).  No host read and no allocation: launches go on the caller's
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCtx = 32;
constexpr int kStride = 128;  // stored slots per context (scheme A uses 127)
constexpr int kOk = 0, kInput = 1, kCapacity = 2, kFormat = 3;
constexpr uint32_t kType = 8;  // EIGHT_BIT_PRUNED
constexpr uint32_t kNoKey = 0xffffffffu;  // a pad or dropped slot: its prefix field no search asks for
constexpr uint32_t kDefault = 0xffffffffu;  // entry start of a slot that holds its default
constexpr uint32_t kFull = 0xffffffffu;  // every lane of the warp
constexpr size_t kEncodeSmem = kCtx * kStride * sizeof(uint32_t);
constexpr size_t kDecodeSmem = kCtx * kStride * sizeof(uint64_t) + kCtx * sizeof(int32_t);

template <bool kNybble>
struct Scheme {
  static constexpr int kSlots = kNybble ? 128 : 127;  // stored slots per context
  static constexpr int kMaxLen = kNybble ? 511 : 255;  // encoder match cap, in symbols
  static constexpr int kFirst = kNybble ? 2 : 1;  // symbols of the verbatim first byte
  static constexpr int kLetterBits = kNybble ? 4 : 8;
  __device__ static int next_slot(int s) { return kNybble ? (s + 1) & 127 : (s + 1) % 127; }
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
      const int s_next = s + 1 == Sc::kSlots ? 0 : s + 1;  // next_slot, without the division
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

// Decoder entry: start | length << 32 | first << 48 | last << 56.
// Scheme B: first is a nybble (bits 48-51), last the word's last three
// nybbles, the latest lowest (bits 52-63).
__device__ __forceinline__ uint64_t make_entry(uint32_t start, uint32_t len, uint32_t first,
                                               uint32_t last, bool nybble) {
  const uint64_t tag = nybble ? (first | (last << 4)) : (first | (last << 8));
  return start | (static_cast<uint64_t>(len) << 32) | (tag << 48);
}

template <bool kNybble>
__global__ void __launch_bounds__(1)
small_decode_kernel(const uint8_t* __restrict__ flat, int64_t flat_len,
                    const int64_t* __restrict__ offsets, const int32_t* __restrict__ plens,
                    const int32_t* __restrict__ raw_lens, uint8_t* __restrict__ out, int64_t S,
                    uint8_t* __restrict__ scratch, int32_t* __restrict__ status) {
  using Sc = Scheme<kNybble>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* entries = reinterpret_cast<uint64_t*>(smem);  // [kCtx][kStride]
  int32_t* nwi = reinterpret_cast<int32_t*>(entries + kCtx * kStride);
  const int b = blockIdx.x;
  const int64_t n = min(max(static_cast<int64_t>(raw_lens[b]), int64_t{0}), S);
  if (n == 0) {
    status[b] = kOk;
    return;
  }
  const int64_t off = min(max(offsets[b], int64_t{0}), flat_len);
  const int64_t plen_in = min(max(static_cast<int64_t>(plens[b]), int64_t{0}), flat_len - off);
  const uint8_t* payload = flat + off;
  if (plen_in < 2 || __ldg(payload) != kType) {
    status[b] = kFormat;
    return;
  }
  for (int i = 0; i < kCtx * kStride; ++i) entries[i] = make_entry(kDefault, 0, 0, 0, kNybble);
  for (int c = 0; c < kCtx; ++c) nwi[c] = 0;

  // symbols: scheme A the output row, scheme B the nybble scratch row
  uint8_t* sym = kNybble ? scratch + b * 2 * S : out + b * S;
  const int64_t target = kNybble ? 2 * n : n;
  const uint32_t p1 = __ldg(payload + 1);
  // the output so far: its length and its last symbol (scheme B: last three nybbles)
  int64_t len_out;
  uint32_t tail;
  if (kNybble) {
    sym[0] = static_cast<uint8_t>(p1 & 15u);
    sym[1] = static_cast<uint8_t>(p1 >> 4);
    tail = ((p1 & 15u) << 4) | (p1 >> 4);
    len_out = 2;
  } else {
    sym[0] = static_cast<uint8_t>(p1);
    tail = p1;
    len_out = 1;
  }
  // the previous word: the verbatim first byte
  int pctx = ' ' & 31;
  int64_t ppos = 0, plen = Sc::kFirst;
  uint32_t pfirst = kNybble ? (p1 & 15u) : p1, plast = tail;
  int64_t i = 2;
  uint32_t idx_next = i < plen_in ? __ldg(payload + i) : 0;
  int st = kOk;
  while (len_out < target) {
    if (i >= plen_in) {
      st = kFormat;
      break;
    }
    const int idx = static_cast<int>(idx_next);
    ++i;
    if (i < plen_in) idx_next = __ldg(payload + i);  // one ahead
    int ctx;
    if (kNybble) {  // the last complete output byte, from the last three nybbles
      const uint32_t byte = (len_out & 1) ? ((tail >> 8) & 15u) | (((tail >> 4) & 15u) << 4)
                                          : ((tail >> 4) & 15u) | ((tail & 15u) << 4);
      ctx = byte & 31;
    } else {
      ctx = tail & 31;
    }
    int64_t wl;
    uint32_t first, last;
    const int64_t pos = len_out;
    if (kNybble ? is_literal_nyb(idx) : idx < 0x80) {
      wl = 1;
      first = last = kNybble ? (idx & 15) : idx;
      sym[pos] = static_cast<uint8_t>(first);
    } else {
      const int s = idx - 0x80;
      if (!kNybble && s >= Sc::kSlots) {  // 0xFF: no such slot
        st = kFormat;
        break;
      }
      const uint64_t e = s >= 0 ? entries[ctx * kStride + s] : make_entry(kDefault, 0, 0, 0, kNybble);
      const uint32_t start = static_cast<uint32_t>(e);
      if (start == kDefault) {  // scheme A ' ' + (s ? s : 'x'); scheme B its own two nybbles
        const uint32_t a = kNybble ? (idx & 15) : ' ';
        const uint32_t z = kNybble ? (idx >> 4) : (s ? s : 'x');
        wl = 2;
        if (pos + 2 > target) {
          st = kFormat;
          break;
        }
        sym[pos] = static_cast<uint8_t>(a);
        sym[pos + 1] = static_cast<uint8_t>(z);
        first = a;
        last = kNybble ? ((a << 4) | z) : z;
      } else {
        wl = static_cast<int64_t>((e >> 32) & 0xFFFFu);
        const uint32_t tag = static_cast<uint32_t>(e >> 48);
        first = kNybble ? (tag & 15u) : (tag & 0xFFu);
        last = kNybble ? (tag >> 4) : (tag >> 8);
        if (pos + wl > target || start + wl > pos) {
          st = kFormat;
          break;
        }
        for (int64_t q = 0; q < wl; ++q) sym[pos + q] = sym[start + q];  // serial: overlap-safe
      }
    }
    // insert the previous word + this word's first symbol into pctx
    const int s = nwi[pctx];
    const uint32_t elast = kNybble ? (((plast << 4) | first) & 0xFFFu) : first;
    entries[pctx * kStride + s] =
        make_entry(static_cast<uint32_t>(ppos), static_cast<uint32_t>(plen + 1), pfirst, elast,
                   kNybble);
    nwi[pctx] = Sc::next_slot(s);
    pctx = ctx;
    ppos = pos;
    plen = wl;
    pfirst = first;
    plast = last;
    if (kNybble) {
      tail = wl >= 3 ? (last & 0xFFFu)
                     : ((tail << (4 * wl)) | (last & ((1u << (4 * wl)) - 1u))) & 0xFFFu;
    } else {
      tail = last;
    }
    len_out = pos + wl;
  }
  if (kNybble && st == kOk) {
    uint8_t* dst = out + b * S;
    for (int64_t k = 0; k < n; ++k)
      dst[k] = static_cast<uint8_t>(sym[2 * k] | (sym[2 * k + 1] << 4));
  }
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

template <bool kNybble>
cudaError_t launch_decode(const void* flat, int64_t flat_len, const void* offsets,
                          const void* plens, const void* raw_lens, void* out, int64_t S,
                          void* scratch, void* status, int B, cudaStream_t stream) {
  small_decode_kernel<kNybble><<<B, 1, kDecodeSmem, stream>>>(
      static_cast<const uint8_t*>(flat), flat_len, static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(plens), static_cast<const int32_t*>(raw_lens),
      static_cast<uint8_t*>(out), S, static_cast<uint8_t*>(scratch),
      static_cast<int32_t*>(status));
  return cudaSuccess;
}

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
                                void* out, long long S, void* scratch, void* status, int B,
                                void* stream) {
  if (B > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    if (nybble)
      launch_decode<true>(flat, flat_len, offsets, plens, raw_lens, out, S, scratch, status, B, s);
    else
      launch_decode<false>(flat, flat_len, offsets, plens, raw_lens, out, S, scratch, status, B, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// CTAs of one lane kernel resident on an SM at once, by the occupancy
// API at the launch's block size and shared memory; the blocks (lanes)
// one CTA holds, its threads and its shared bytes (static + dynamic):
// a launch of B blocks runs in ceil(B / (ctas x SMs x lanes)) waves.
extern "C" int dct_small_occupancy(int decode, int nybble, void* ctas, void* lanes_per_cta,
                                   void* threads, void* smem_bytes) {
  const void* fn = decode ? (nybble ? reinterpret_cast<const void*>(small_decode_kernel<true>)
                                    : reinterpret_cast<const void*>(small_decode_kernel<false>))
                          : (nybble ? reinterpret_cast<const void*>(small_encode_kernel<true>)
                                    : reinterpret_cast<const void*>(small_encode_kernel<false>));
  const int block = decode ? 1 : 32;
  const size_t dynamic = decode ? kDecodeSmem : kEncodeSmem;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<int*>(lanes_per_cta) = 1;
  *static_cast<int*>(threads) = block;
  *static_cast<int*>(smem_bytes) = static_cast<int>(attr.sharedSizeBytes + dynamic);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(ctas), fn, block, dynamic));
}
