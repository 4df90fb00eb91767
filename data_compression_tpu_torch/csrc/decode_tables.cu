// Canonical Huffman decode tables from wire length rows, one warp a row.
//
// Replaces data_compression_tpu/ops/table_build.py `decode_tables_device`
// (no Pallas kernel: jnp ops, a count per length, a max scan and an
// argsort), which the port's ops/table_build.py `decode_tables_device`
// transcribes into about 25 torch launches; that stays the plain version.
// In: [B, 256] uint8 code lengths, a frame's table bytes.  Out, int32, the
// layout of huffman/batched.py `decode_tensors` / `decode_rows`, with
// count[l] the symbols of length l for l = 1..L, first[1] = 0,
// first[l + 1] = (first[l] + count[l]) * n, base[l] = sum_{j<l} count[j]
// and M the row's longest length:
//   limit[l]   = (first[l] + count[l]) * n^(L - l) for 1 <= l <= L when
//                M >= 1 (the running max of the plain version: these sums
//                never decrease), else 0; limit[0] = 0;
//   bmf[l]     = base[l] - first[l] for 1 <= l <= min(M, L), else 0;
//   symbols[r] = the used symbol of rank r in (length, symbol) order, 0
//                from the row's used count on.
// Rows the encoder never writes decode as the plain version decodes them: a
// length above L is not counted in count[] but takes its place in
// `symbols` (and M > L makes every bmf[1..L] defined), and an over-full
// tree's sums, kept in 64 bits, are stored as their low 32 bits (at n = 16
// they pass 2^32), as the plain version's int64 -> int32 conversion stores
// them.
//
// What bounds it on the card: neither bytes (256 B in and 1 KiB + 8 (L + 1)
// B out per row: 1.3 MiB at B = 1024, under a microsecond at 3.35 TB/s)
// nor operations, but the launch and a chain of dependent warp steps.
// Design: one warp a row, 8 rows a CTA, no CTA barrier and no shared
// memory to clear but the warp's 1 KiB of length counts.  Lane i holds
// the lengths of symbols i + 32 j, j = 0..7, so slot j holds symbols
// 32 j .. 32 j + 31 in order: per slot, __match_any_sync on the lengths
// gives each symbol's rank among the slot's symbols of its length, and
// the count of its length in the earlier slots is read from the warp's
// counts, which the first lane of each length then advances (a stable
// counting sort over all 256 lengths, rows never written included).  A
// warp scan over the counts gives each length's base, and a symbol's rank
// is base[len] + its rank in its length.  The first codes and the powers
// of n come from one warp scan of the affine steps x -> n x + count[l]
// in 64 bits.
//
// `dct_decode_tables_floor` launches an empty kernel on the same grid: the
// launch floor its time is read against.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 256;    // alphabet
constexpr int kRows = 8;   // rows (warps) a CTA
constexpr int kSlots = kS / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t low32(uint64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}

__global__ void __launch_bounds__(kRows * 32)
decode_tables_kernel(const uint8_t* __restrict__ rows, int32_t* __restrict__ limit,
                     int32_t* __restrict__ bmf, int32_t* __restrict__ symbols, int B, int n,
                     int L) {
  __shared__ __align__(16) int s_count[kRows][kS];  // a warp's count, then base, of each length
  __shared__ int s_sym[kRows][kS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kRows + warp;
  if (b >= B) return;  // whole warps only: no CTA barrier below
  int* count = s_count[warp];
  int* sym = s_sym[warp];
  const uint8_t* row = rows + b * kS;
  int len[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) len[j] = row[32 * j + lane];
  reinterpret_cast<int4*>(count)[2 * lane] = make_int4(0, 0, 0, 0);
  reinterpret_cast<int4*>(count)[2 * lane + 1] = make_int4(0, 0, 0, 0);
  __syncwarp();

  // stable ranks within each length, slot by slot, packed 4 to a word
  // (each below 256): computed as they come, nothing deferred stays live
  const unsigned below = (1u << lane) - 1u;
  uint32_t rank[kSlots / 4] = {0, 0};
  int longest = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const unsigned same = __match_any_sync(kFull, len[j]);
    const int earlier = count[len[j]];
    rank[j / 4] |= static_cast<uint32_t>(earlier + __popc(same & below)) << (8 * (j % 4));
    __syncwarp();
    if ((same & below) == 0) count[len[j]] = earlier + __popc(same);
    __syncwarp();
    longest = max(longest, len[j]);
  }
  const int max_len = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(longest)));

  // base of every length: lane i owns lengths 8 i .. 8 i + 7 (length 0 is unused)
  const int4 c0 = reinterpret_cast<const int4*>(count)[2 * lane];
  const int4 c1 = reinterpret_cast<const int4*>(count)[2 * lane + 1];
  const int own = lane >= 1 && lane <= L ? count[lane] : 0;  // count[l] for the first codes
  int c[8] = {lane ? c0.x : 0, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
  int total = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int x = c[k];
    c[k] = total;
    total += x;
  }
  int incl = total;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const int before = incl - total;
  const int used = __shfl_sync(kFull, incl, 31);
  __syncwarp();
  reinterpret_cast<int4*>(count)[2 * lane] =
      make_int4(before + c[0], before + c[1], before + c[2], before + c[3]);
  reinterpret_cast<int4*>(count)[2 * lane + 1] =
      make_int4(before + c[4], before + c[5], before + c[6], before + c[7]);
  __syncwarp();

#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int r = (rank[j / 4] >> (8 * (j % 4))) & 0xff;
    if (len[j] > 0) sym[count[len[j]] + r] = 32 * j + lane;
  }
  const int base = lane <= L ? count[lane] : 0;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int r = 32 * j + lane;
    symbols[b * kS + r] = r < used ? sym[r] : 0;
  }

  // g[l] = first[l] + count[l] = sum_{j <= l} count[j] n^(l - j), and a[l] = n^l,
  // by an inclusive scan of the steps x -> n x + count[l] (lane 0: identity)
  uint64_t a = lane >= 1 ? static_cast<uint64_t>(n) : 1u;
  uint64_t g = static_cast<uint64_t>(own);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t pa = __shfl_up_sync(kFull, a, d);
    const uint64_t pg = __shfl_up_sync(kFull, g, d);
    if (lane >= d) {
      g = a * pg + g;
      a *= pa;
    }
  }
  const uint64_t first = static_cast<uint64_t>(n) * __shfl_up_sync(kFull, g, 1);
  const uint64_t scale = __shfl_sync(kFull, a, lane <= L ? L - lane : 0);  // n^(L - l)
  if (lane <= L) {
    const uint64_t lim = lane >= 1 && max_len >= 1 ? g * scale : 0;
    const uint64_t bm = lane >= 1 && lane <= max_len ? static_cast<uint64_t>(base) - first : 0;
    limit[b * (L + 1) + lane] = low32(lim);
    bmf[b * (L + 1) + lane] = low32(bm);
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int dct_decode_tables(const void* rows, void* limit, void* bmf, void* symbols, int B,
                                 int arity, int L, void* stream) {
  if (L < 1 || L >= 32) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    decode_tables_kernel<<<static_cast<unsigned>((B + kRows - 1) / kRows), kRows * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), static_cast<int32_t*>(limit),
        static_cast<int32_t*>(bmf), static_cast<int32_t*>(symbols), B, arity, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dct_decode_tables_floor(int B, void* stream) {
  if (B > 0) {
    empty_kernel<<<static_cast<unsigned>((B + kRows - 1) / kRows), kRows * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>();
  }
  return static_cast<int>(cudaGetLastError());
}
