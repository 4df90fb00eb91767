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
//   * the search state sits in dynamic shared memory: per context and
//     slot a 64-bit key, prefix_gen << 32 | (prefix & 0xFFFF) << 8 |
//     letter, and a 32-bit gen; 32 x 128 x 12 bytes = 48 KiB and the 32
//     next-slot counters: 49,280 bytes a warp, 4 warps an SM.  Scheme B
//     stores slots 0x80..0xFF only: slots below 0x80 are never written
//     (their gen stays 0, their content is the default).  Widths: gen
//     counts the writes of one slot, at most 2S / 127 < 2^32 for any S.
//     start and length are not kept: the encoder never reads them (a
//     slot holds a span exactly when its gen is above 0);
//   * the child search is one pass of the warp over the slots: lane l
//     holds the keys of slots l, l + 32, l + 64, l + 96 in registers for
//     the whole word (they change only at the insert after it), compares
//     them with (want_gen, index, symbol), and four `__ballot_sync`s
//     give the matches in slot order; the banned slot's bit is cleared
//     and the first set bit is the C's first match (libdctpu.c:291-303,
//     :479-505).  Folding the gen check into the key is exact: a slot
//     whose prefix is a literal (or a default word) was written with
//     prefix_gen 0, and for those the search wants 0.  Scheme B keeps
//     the C's shortcut: a literal prefix followed by a nybble that forms
//     a non-literal default below 0x80 is that default slot;
//   * one step is a broadcast shared load (the prefix slot's gen), four
//     compares, four ballots and a find-first: about 40-60 dependent
//     cycles.
// Decoder: one thread per block, one thread to a CTA.
//   * the span dictionary, one 64-bit entry per context and slot, sits
//     in dynamic shared memory (32 x 128 x 8 = 32 KiB, 7 CTAs an SM):
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
constexpr uint64_t kNoKey = ~0ull;  // scheme A's pad slot: its letter byte 0xFF matches nothing
constexpr uint32_t kDefault = 0xffffffffu;  // entry start of a slot that holds its default
constexpr size_t kEncodeSmem = kCtx * kStride * (sizeof(uint64_t) + sizeof(uint32_t)) +
                               kCtx * sizeof(int32_t);
constexpr size_t kDecodeSmem = kCtx * kStride * sizeof(uint64_t) + kCtx * sizeof(int32_t);

template <bool kNybble>
struct Scheme {
  static constexpr int kSlots = kNybble ? 128 : 127;  // stored slots per context
  static constexpr int kMaxLen = kNybble ? 511 : 255;  // encoder match cap, in symbols
  static constexpr int kFirst = kNybble ? 2 : 1;  // symbols of the verbatim first byte
  __device__ static int next_slot(int s) { return kNybble ? (s + 1) & 127 : (s + 1) % 127; }
  // stored slot of index idx, or -1 when its gen is always 0 (a literal,
  // a scheme-B default below 0x80, the -1 prefix)
  __device__ static int slot_of(int idx) { return idx >= 0x80 ? idx - 0x80 : -1; }
};

__device__ __forceinline__ bool is_literal_nyb(int x) { return (x | 0xF) == 0x1F; }

__device__ __forceinline__ uint64_t make_key(uint32_t pgen, int prefix, uint32_t letter) {
  return (static_cast<uint64_t>(pgen) << 32) |
         (static_cast<uint64_t>(static_cast<uint32_t>(prefix) & 0xFFFFu) << 8) | letter;
}

template <bool kNybble>
__device__ __forceinline__ uint32_t symbol_at(const uint8_t* src, int64_t i) {
  if (!kNybble) return __ldg(src + i);
  const uint32_t byte = __ldg(src + (i >> 1));
  return (i & 1) ? (byte >> 4) : (byte & 15u);
}

template <bool kNybble>
__global__ void __launch_bounds__(32)
small_encode_kernel(const uint8_t* __restrict__ blocks, int64_t S,
                    const int32_t* __restrict__ lengths, uint8_t* __restrict__ rows, int64_t W,
                    int32_t* __restrict__ totals, int32_t* __restrict__ status) {
  using Sc = Scheme<kNybble>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // [kCtx][kStride]
  uint32_t* gens = reinterpret_cast<uint32_t*>(keys + kCtx * kStride);  // [kCtx][kStride]
  int32_t* nwi = reinterpret_cast<int32_t*>(gens + kCtx * kStride);  // [kCtx], stored slots
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
  for (int i = lane; i < kCtx * kStride; i += 32) {
    const int s = i % kStride;
    uint64_t key = kNoKey;
    if (kNybble) {  // stored slot s is slot 0x80 + s: default (s & 15 | 0x10, 8 + (s >> 4))
      key = make_key(0, (s & 15) | 0x10, 8u + (s >> 4));
    } else if (s < Sc::kSlots) {  // default ' ' + (s ? s : 'x')
      key = make_key(0, ' ', s ? s : 'x');
    }
    keys[i] = key;
    gens[i] = 0;
  }
  if (lane < kCtx) nwi[lane] = 0;
  __syncwarp();

  const int64_t N = kNybble ? 2 * n : n;  // symbols
  int pctx = ' ' & 31;  // previous word: the verbatim first byte
  int pidx = kNybble ? -1 : static_cast<int>(src0);
  int64_t pos = Sc::kFirst;
  int64_t o = 2;
  int st = kOk;
  while (pos < N) {
    const uint32_t before = __ldg(src + (kNybble ? (pos >> 1) - 1 : pos - 1));
    const uint32_t sym0 = symbol_at<kNybble>(src, pos);
    if (!kNybble && ((sym0 | before) & 0x80u)) {
      st = kInput;
      break;
    }
    const int ctx = before & 31;
    const int banned = ctx == pctx ? nwi[pctx] : -1;
    uint32_t bmask[4];
    uint64_t k[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bmask[q] = (banned >> 5) == q ? ~(1u << (banned & 31)) : ~0u;
      k[q] = keys[ctx * kStride + q * 32 + lane];
    }
    int idx = kNybble ? static_cast<int>(sym0 | 0x10u) : static_cast<int>(sym0);
    int64_t len = 1;
    uint32_t c = pos + 1 < N ? symbol_at<kNybble>(src, pos + 1) : 0;
    while (pos + len < N && len < Sc::kMaxLen) {
      const uint32_t cur = c;
      if (pos + len + 1 < N) c = symbol_at<kNybble>(src, pos + len + 1);  // one ahead
      int w = -1;  // slot number (scheme B: 0..0xFF; scheme A: 0..126)
      if (kNybble && is_literal_nyb(idx)) {
        const int d0 = (idx & 15) | static_cast<int>(cur << 4);
        if (d0 < 0x80 && !is_literal_nyb(d0)) w = d0;
      }
      if (w < 0) {
        const int ps = Sc::slot_of(idx);
        const uint32_t want = ps >= 0 ? gens[ctx * kStride + ps] : 0u;
        const uint64_t target = make_key(want, idx, cur);
        int found = -1;
#pragma unroll
        for (int q = 3; q >= 0; --q) {
          const uint32_t m = __ballot_sync(0xffffffffu, k[q] == target) & bmask[q];
          if (m) found = q * 32 + __ffs(m) - 1;
        }
        if (found < 0) break;
        w = kNybble ? found + 0x80 : found;
      }
      idx = kNybble ? w : 0x80 + w;
      ++len;
    }
    if (lane == 0) dst[o] = static_cast<uint8_t>(idx);
    ++o;
    // insert the previous word + this word's first symbol into pctx
    const int s = nwi[pctx];
    const int ps = Sc::slot_of(pidx);
    const uint32_t g = gens[pctx * kStride + s] + 1;
    const uint32_t pg = ps < 0 ? 0u : (ps == s ? g : gens[pctx * kStride + ps]);
    __syncwarp();
    if (lane == 0) {
      gens[pctx * kStride + s] = g;
      keys[pctx * kStride + s] = make_key(pg, pidx, sym0);
      nwi[pctx] = Sc::next_slot(s);
    }
    __syncwarp();
    pctx = ctx;
    pidx = idx;
    pos += len;
  }
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
cudaError_t launch_encode(const void* blocks, int64_t S, const void* lengths, void* rows,
                          int64_t W, void* totals, void* status, int B, cudaStream_t stream) {
  const cudaError_t rc = cudaFuncSetAttribute(small_encode_kernel<kNybble>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              static_cast<int>(kEncodeSmem));
  if (rc != cudaSuccess) return rc;
  small_encode_kernel<kNybble><<<B, 32, kEncodeSmem, stream>>>(
      static_cast<const uint8_t*>(blocks), S, static_cast<const int32_t*>(lengths),
      static_cast<uint8_t*>(rows), W, static_cast<int32_t*>(totals),
      static_cast<int32_t*>(status));
  return cudaSuccess;
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
    const cudaError_t rc =
        nybble ? launch_encode<true>(blocks, S, lengths, rows, W, totals, status, B, s)
               : launch_encode<false>(blocks, S, lengths, rows, W, totals, status, B, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
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
