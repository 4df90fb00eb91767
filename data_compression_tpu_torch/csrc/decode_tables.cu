// Canonical Huffman decode tables from wire length rows, one row per CTA.
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
// nor operations, but the launch and a few dependent shared-memory steps.
// Design: 256 threads, one per symbol, no sort and no serial loop over
// symbols.  __match_any_sync on the lengths gives each symbol's rank among
// the same-length symbols of its warp, and each warp's count of every
// length; one pass over the 8 warps per length turns those into the
// count of that length in the warps before each warp, and the row's
// count; a block scan over the 256 lengths gives each length's base.  A
// used symbol's rank is base[len] + its length's count in the earlier
// warps + its rank in its warp.  Thread l in 1..L then runs the
// first-code recurrence up to l in 64 bits (at most 15 steps).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 256;  // alphabet, and threads per CTA
constexpr int kWarps = kS / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t low32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(x)));
}

__global__ void __launch_bounds__(kS)
decode_tables_kernel(const uint8_t* __restrict__ rows, int32_t* __restrict__ limit,
                     int32_t* __restrict__ bmf, int32_t* __restrict__ symbols, int n, int L) {
  // [w][v]: warp w's count of length v, then the count of v in warps < w
  __shared__ int s_warp_count[kWarps][kS];
  __shared__ int s_count[kS];  // the row's count of length v
  __shared__ int s_base[kS];   // used symbols of lengths 1..v-1
  __shared__ int s_sym[kS];
  __shared__ int s_scan[kWarps];
  __shared__ int s_max_len;

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int len = rows[b * kS + t];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_warp_count[w][t] = 0;
  s_sym[t] = 0;
  if (t == 0) s_max_len = 0;
  __syncthreads();

  const unsigned same = __match_any_sync(kFull, len);
  const int rank_in_warp = __popc(same & ((1u << lane) - 1u));
  if (rank_in_warp == 0) s_warp_count[warp][len] = __popc(same);
  __syncthreads();

  // thread t owns length t: counts in the earlier warps, and the row's count
  int count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp_count[w][t];
    s_warp_count[w][t] = count;
    count += c;
  }
  s_count[t] = count;
  if (t > 0 && count > 0) atomicMax(&s_max_len, t);
  // exclusive scan of the counts of lengths 1..255 (length 0 is unused)
  const int mine = t > 0 ? count : 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += s_scan[w];
  s_base[t] = before + incl - mine;
  __syncthreads();

  if (len > 0) s_sym[s_base[len] + s_warp_count[warp][len] + rank_in_warp] = t;
  if (t <= L) {
    const int max_len = s_max_len;
    int64_t first = 0, base = 0, scale = 1;
    for (int j = 1; j < t; ++j) {
      first = (first + s_count[j]) * n;
      base += s_count[j];
    }
    for (int j = t; j < L; ++j) scale *= n;
    const int64_t lim = t >= 1 && max_len >= 1 ? (first + s_count[t]) * scale : 0;
    const int64_t bm = t >= 1 && t <= max_len ? base - first : 0;
    limit[b * (L + 1) + t] = low32(lim);
    bmf[b * (L + 1) + t] = low32(bm);
  }
  __syncthreads();
  symbols[b * kS + t] = s_sym[t];
}

}  // namespace

extern "C" int dct_decode_tables(const void* rows, void* limit, void* bmf, void* symbols, int B,
                                 int arity, int L, void* stream) {
  if (L < 1 || L >= kS) return static_cast<int>(cudaErrorInvalidValue);
  if (B > 0) {
    decode_tables_kernel<<<static_cast<unsigned>(B), kS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(rows), static_cast<int32_t*>(limit),
        static_cast<int32_t*>(bmf), static_cast<int32_t*>(symbols), arity, L);
  }
  return static_cast<int>(cudaGetLastError());
}
