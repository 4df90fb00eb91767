// Capped canonical Huffman code lengths, one histogram per CTA.
//
// Replaces data_compression_tpu/ops/table_build.py `huffman_lengths_device`
// (no Pallas kernel: a `lax.scan` that does one n-ary merge for all B
// blocks per step, and a `lax.while_loop` that halves the counts of the
// blocks whose tree exceeds the per-arity cap and rebuilds).  In PyTorch
// ops the same loop is about 320 merge steps of about 10 launches each,
// and the cap loop would read its condition back on every pass; here the
// whole build, cap loop included, is one launch with no host read.
//
// The lengths are bit-identical to the host builder's
// (native/libdctpu.c `dct_huffman_capped_lengths`: hl_once / hl_cmp):
// leaves are the used symbols in symbol order (their seniority) and then
// d = (n-1 - (k-1) % (n-1)) % (n-1) dummies of count 1; they are sorted by
// (count, seniority); each merge pops n nodes from the sorted leaves and
// a FIFO of internal nodes, the leaf on a tie; a symbol's length is its
// leaf's depth.  While the longest real code exceeds the cap, every
// nonzero count becomes (count + 1) / 2 and the tree is rebuilt.  One
// symbol gets length 1, none gives all 0.
//
// What bounds it on the card: not bytes (2 KiB of counts in, 1 KiB of
// lengths out per histogram) but the serial merge, about 2 x 320 dependent
// shared-memory steps per tree at n = 2.  Design: one CTA of 256 threads
// per histogram, about 14 KiB of shared memory, so a wave of 1024 CTAs
// fits the card at once.  The threads count the used symbols and their
// seniority (warp ballots), sort the leaves by a rank count (each leaf's
// place is the number of leaves before it in (count, seniority) order:
// 320 broadcast reads a thread, no qsort on the card), and after the
// merge give each leaf its depth; one thread does the two-queue merge and
// the walk of the internal nodes from the root, whose parents always have
// larger ids.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kS = 256;            // alphabet: one thread per symbol
constexpr int kMaxDummies = 64;    // d <= n - 2 <= 62
constexpr int kNL = kS + kMaxDummies;
constexpr int kThreads = kS;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
table_build_kernel(const int64_t* __restrict__ hists, int32_t* __restrict__ lengths,
                   int arity, int cap) {
  __shared__ int64_t freq[kS];
  __shared__ int64_t item_cnt[kNL];  // leaves by seniority
  __shared__ int64_t leaf_cnt[kNL];  // leaves in (count, seniority) order
  __shared__ int16_t leaf_sen[kNL];
  __shared__ int64_t node_cnt[kNL];  // internal nodes in creation order
  __shared__ int16_t parent[2 * kNL];  // leaf p at p, internal node t at nl + t
  __shared__ int16_t depth[kNL];       // internal node t's depth
  __shared__ uint8_t sym_of_sen[kS];
  __shared__ int32_t len_of_sym[kS];
  __shared__ int warp_used[kWarps];
  __shared__ int max_len;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n1 = arity - 1;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kS;
  freq[tid] = hists[row + tid];

  for (;;) {
    // seniority of each used symbol: the used symbols before it
    const bool used = freq[tid] > 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, used);
    if (lane == 0) warp_used[warp] = __popc(ballot);
    len_of_sym[tid] = 0;
    if (tid == 0) max_len = 0;
    __syncthreads();
    int sen = __popc(ballot & ((1u << lane) - 1u));
    int k = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sen += w < warp ? warp_used[w] : 0;
      k += warp_used[w];
    }
    if (k <= 1) {  // no tree: one symbol gets one digit (the same k for all threads)
      lengths[row + tid] = used ? 1 : 0;
      return;
    }
    const int nl = k + (n1 - (k - 1) % n1) % n1;
    if (used) {
      item_cnt[sen] = freq[tid];
      sym_of_sen[sen] = static_cast<uint8_t>(tid);
    }
    for (int i = k + tid; i < nl; i += kThreads) item_cnt[i] = 1;
    __syncthreads();

    // sort: a leaf's place is the number of leaves before it in
    // (count, seniority) order
    for (int i = tid; i < nl; i += kThreads) {
      const int64_t c = item_cnt[i];
      int place = 0;
      for (int j = 0; j < nl; ++j) {
        const int64_t cj = item_cnt[j];
        place += (cj < c) | ((cj == c) & (j < i));
      }
      leaf_cnt[place] = c;
      leaf_sen[place] = static_cast<int16_t>(i);
    }
    __syncthreads();

    if (tid == 0) {
      // two-queue merge: sorted leaves and the FIFO of internal nodes
      int lq = 0, nh = 0, nt = 0;
      for (int remaining = nl; remaining > 1; remaining -= n1) {
        const int16_t id = static_cast<int16_t>(nl + nt);
        int64_t total = 0;
        for (int a = 0; a < arity; ++a) {
          if (lq < nl && (nh == nt || leaf_cnt[lq] <= node_cnt[nh])) {
            total += leaf_cnt[lq];
            parent[lq++] = id;
          } else {
            total += node_cnt[nh];
            parent[nl + nh++] = id;
          }
        }
        node_cnt[nt++] = total;
      }
      // internal depths from the root (the last node made)
      depth[nt - 1] = 0;
      for (int t = nt - 2; t >= 0; --t) depth[t] = depth[parent[nl + t] - nl] + 1;
    }
    __syncthreads();

    int longest = 0;
    for (int p = tid; p < nl; p += kThreads) {
      const int s = leaf_sen[p];
      if (s < k) {  // a real symbol, not a dummy
        const int len = depth[parent[p] - nl] + 1;
        len_of_sym[sym_of_sen[s]] = len;
        longest = max(longest, len);
      }
    }
    atomicMax(&max_len, longest);
    __syncthreads();
    if (max_len <= cap) {
      lengths[row + tid] = len_of_sym[tid];
      return;
    }
    // too deep: flatten the counts and build again
    if (used) freq[tid] = (freq[tid] + 1) / 2;
    __syncthreads();
  }
}

}  // namespace

extern "C" int dct_table_build(const void* hists, void* lengths, int B, int arity, int cap,
                               void* stream) {
  if (B > 0) {
    table_build_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(hists), static_cast<int32_t*>(lengths), arity, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
