// Capped canonical Huffman code lengths, and the encode kernel's table,
// one histogram per CTA.
//
// Replaces data_compression_tpu/ops/table_build.py `huffman_lengths_device`
// and `encode_tables_device` (no Pallas kernel: a `lax.scan` that does one
// n-ary merge for all B blocks per step inside a `lax.while_loop` that
// halves the counts of the blocks whose tree exceeds the per-arity cap,
// then `jnp` ops for the codes).  In PyTorch ops the same build is about
// 320 merge steps of about 10 launches each, with a host read per cap
// pass, and the codes about 35 more launches; here it is one launch with
// no host read.
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
// The table (`dense`, the layout of ops/table_build.py
// `encode_tables_device` and huffman/batched.py `dense_rows`): the
// canonical code of a symbol of length l is first[l] + its rank among the
// symbols of length l in symbol order, first[1] = 0 and first[l + 1] =
// (first[l] + count[l]) * n; digit m of the code (most significant first)
// goes to bit field m.  At n = 2 and 16 the entry is l << shift | fields
// ([B, 256]); at n = 3 the fields, then l * 2 field bits ([B, 512]).
//
// What bounds it on the card: not bytes (2 KiB of counts in, 1 KiB of
// lengths and 1-2 KiB of table out per histogram) but the merge, a chain
// of about 2 x 255 dependent pops at n = 2.  Design:
//   * counts in 32 bits when the row's total is below 2^22 (every row that
//     comes from a block of up to 4 MiB), else in 64 bits, chosen per row;
//   * leaves sorted as packed keys count << 9 | seniority by a bitonic
//     sort in shared memory over the next power of two above the leaf
//     count;
//   * one thread merges with the heads of both queues in registers: the
//     next four sorted leaves and the next four internal nodes, refilled
//     four pops ahead, the node just made forwarded from its register, so
//     that no shared-memory load sits on the chain of compares;
//   * the internal nodes' depths by pointer jumping (about log2 of the
//     depth rounds over all threads), not a walk down from the root;
//   * a cap pass does not sort again: halving is monotone, so each leaf's
//     new place is the start of its run of equal halved counts (a binary
//     search) plus the leaves of that run with a smaller seniority;
//   * the table in the same CTA from the lengths in shared memory: warp
//     match masks give each symbol's rank within its group of 32 symbols
//     and the per-group counts of each length.
//   * 128 threads per histogram (32 and 256 measured slower on the
//     H100, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kS = 256;           // alphabet
constexpr int kMaxLeaves = 320;   // 256 symbols + at most n - 2 <= 62 dummies
constexpr int kSortSlots = 512;   // power of two >= kMaxLeaves
constexpr int kMaxNodes = 256;    // internal nodes: (leaves - 1) / (n - 1) <= 255
constexpr int kSenBits = 9;       // seniority < 512 in the leaf key
constexpr int kMaxLen = 16;       // code lengths 0..15 in the table's length arrays
constexpr int kGroups = kS / 32;  // symbol groups of one warp each
constexpr int kThreads = 128;     // threads per histogram (one CTA)
constexpr uint32_t kSmallTotal = 1u << 22;  // rows below it are built in 32 bits
// the merge reads the sorted keys up to four past the last leaf
static_assert(kSortSlots >= kMaxLeaves + 4, "leaf keys and their pads");

struct Shared {
  uint64_t key[kSortSlots];             // sorted leaf keys (a 32-bit build uses the low half)
  uint64_t key2[kSortSlots];            // a cap pass's halved keys in the old order
  uint64_t node[kMaxNodes + 8];         // internal node counts in creation order
  int16_t parent[kSortSlots + kMaxNodes];  // leaf p at p, internal node t at kSortSlots + t
  int16_t anc[kMaxNodes];               // pointer jumping: an ancestor ...
  int16_t dist[kMaxNodes];              // ... and the distance to it
  uint8_t sym_of_sen[kS];
  uint8_t len[kS];                      // code length of each symbol
  uint8_t in_rank[kS];                  // rank among its group's symbols of its length
  int grp_used[kGroups];
  unsigned long long grp_sum[kGroups];
  int grp_len[kGroups][kMaxLen];        // symbols of each length in each group
  long long first[kMaxLen + 1];         // first canonical code of each length
};

// The used symbols of a row (k) and its total, the same in every thread;
// sm.grp_used holds each group's used symbols.
__device__ __forceinline__ int used_symbols(const int64_t* h, Shared& sm,
                                            unsigned long long* total) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int g = tid >> 5; g < kGroups; g += kThreads / 32) {
    const int64_t c = h[g * 32 + lane];
    unsigned long long sum = c > 0 ? static_cast<unsigned long long>(c) : 0ull;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const unsigned ballot = __ballot_sync(0xffffffffu, c > 0);
    if (lane == 0) {
      sm.grp_used[g] = __popc(ballot);
      sm.grp_sum[g] = sum;
    }
  }
  __syncthreads();
  int k = 0;
  *total = 0;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    k += sm.grp_used[g];
    *total += sm.grp_sum[g];
  }
  return k;
}

// One (or, over the cap, several) builds of the lengths of one row, in
// counts of type T.  -> sm.len[s] for every symbol.
template <typename T>
__device__ void build_lengths(const int64_t* h, Shared& sm, int k, int arity, int cap) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n1 = arity - 1;
  T* key = reinterpret_cast<T*>(sm.key);
  T* key2 = reinterpret_cast<T*>(sm.key2);
  T* node = reinterpret_cast<T*>(sm.node);
  const T kPad = ~T(0);             // sorts after every leaf
  const T kInf = kPad >> kSenBits;  // count of a pad: above every node's total
  const T kSenMask = (T(1) << kSenBits) - 1;

  const int nl = k + (n1 - (k - 1) % n1) % n1;
  for (int s = tid; s < kS; s += kThreads) sm.len[s] = 0;
  const int slots = nl <= 2 ? 2 : 1 << (32 - __clz(nl - 1));
  // leaf keys: used symbols by seniority, dummies, pads
  for (int g = tid >> 5; g < kGroups; g += kThreads / 32) {
    const int s = g * 32 + lane;
    const int64_t c = h[s];
    const unsigned ballot = __ballot_sync(0xffffffffu, c > 0);
    int sen = __popc(ballot & ((1u << lane) - 1u));
    for (int w = 0; w < g; ++w) sen += sm.grp_used[w];
    if (c > 0) {
      key[sen] = (static_cast<T>(c) << kSenBits) | static_cast<T>(sen);
      sm.sym_of_sen[sen] = static_cast<uint8_t>(s);
    }
  }
  for (int i = k + tid; i < kSortSlots; i += kThreads) {
    key[i] = i < nl ? (T(1) << kSenBits) | static_cast<T>(i) : kPad;
  }
  __syncthreads();
  // bitonic sort of the first `slots` keys
  for (int size = 2; size <= slots; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < slots / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const T a = key[lo], b = key[hi];
        if ((a > b) == ((lo & size) == 0)) {
          key[lo] = b;
          key[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (;;) {
    for (int i = tid; i < kMaxNodes + 8; i += kThreads) node[i] = kInf;
    __syncthreads();
    if (tid == 0) {
      // two-queue merge, the heads of both queues in registers
      T l0 = key[0] >> kSenBits, l1 = key[1] >> kSenBits;
      T l2 = key[2] >> kSenBits, l3 = key[3] >> kSenBits;
      T w0 = kInf, w1 = kInf, w2 = kInf, w3 = kInf;
      int lq = 0, nh = 0, nt = 0;
      for (int remaining = nl; remaining > 1; remaining -= n1) {
        T total = 0;
        for (int a = 0; a < arity; ++a) {
          if (l0 <= w0) {
            total += l0;
            sm.parent[lq] = static_cast<int16_t>(nt);
            l0 = l1;
            l1 = l2;
            l2 = l3;
            l3 = key[lq + 4] >> kSenBits;
            ++lq;
          } else {
            total += w0;
            sm.parent[kSortSlots + nh] = static_cast<int16_t>(nt);
            w0 = w1;
            w1 = w2;
            w2 = w3;
            w3 = node[nh + 4];
            ++nh;
          }
        }
        node[nt] = total;
        const int at = nt - nh;  // the new node's place in the window
        w0 = at == 0 ? total : w0;
        w1 = at == 1 ? total : w1;
        w2 = at == 2 ? total : w2;
        w3 = at == 3 ? total : w3;
        ++nt;
      }
      sm.anc[0] = static_cast<int16_t>(nt);  // hand the node count over
    }
    __syncthreads();
    const int nt = sm.anc[0];
    const int root = nt - 1;
    __syncthreads();

    // depth of every internal node by pointer jumping
    for (int t = tid; t < nt; t += kThreads) {
      sm.anc[t] = static_cast<int16_t>(t == root ? root : sm.parent[kSortSlots + t]);
      sm.dist[t] = static_cast<int16_t>(t == root ? 0 : 1);
    }
    __syncthreads();
    constexpr int kPer = (kMaxNodes + kThreads - 1) / kThreads;
    for (;;) {
      int16_t na[kPer], nd[kPer];
      bool moved = false;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = tid + j * kThreads;
        if (t < nt) {
          const int a = sm.anc[t];
          na[j] = sm.anc[a];
          nd[j] = static_cast<int16_t>(sm.dist[t] + sm.dist[a]);
          moved |= na[j] != a;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = tid + j * kThreads;
        if (t < nt) {
          sm.anc[t] = na[j];
          sm.dist[t] = nd[j];
        }
      }
      if (!__syncthreads_or(moved)) break;
    }

    // leaf depths: the lengths of the real symbols
    bool over = false;
    for (int p = tid; p < nl; p += kThreads) {
      const int sen = static_cast<int>(key[p] & kSenMask);
      if (sen < k) {
        const int l = sm.dist[sm.parent[p]] + 1;
        sm.len[sm.sym_of_sen[sen]] = static_cast<uint8_t>(min(l, 255));
        over |= l > cap;
      }
    }
    if (!__syncthreads_or(over)) return;

    // too deep: halve every count; each leaf's new place is the start of
    // its run of equal halved counts plus the smaller seniorities in it
    for (int p = tid; p < nl; p += kThreads) {
      const T c = key[p] >> kSenBits;
      key2[p] = (((c + 1) >> 1) << kSenBits) | (key[p] & kSenMask);
    }
    __syncthreads();
    for (int p = tid; p < nl; p += kThreads) {
      const T kp = key2[p];
      const T c = kp >> kSenBits;
      int lo = 0, hi = nl;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if ((key2[mid] >> kSenBits) < c) lo = mid + 1; else hi = mid;
      }
      int place = lo;
      for (int q = lo; q < nl && (key2[q] >> kSenBits) == c; ++q) place += key2[q] < kp;
      key[place] = kp;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
table_build_kernel(const int64_t* __restrict__ hists, int32_t* __restrict__ lengths,
                   int32_t* __restrict__ dense, int arity, int cap, int dense_mode, int shift,
                   int bits_per_digit) {
  __shared__ Shared sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x;
  const int64_t* h = hists + row * kS;

  unsigned long long total;
  const int k = used_symbols(h, sm, &total);
  if (k <= 1) {  // no tree: one symbol gets one digit
    for (int s = tid; s < kS; s += kThreads) sm.len[s] = h[s] > 0 ? 1 : 0;
    __syncthreads();
  } else if (total < kSmallTotal) {
    build_lengths<uint32_t>(h, sm, k, arity, cap);
  } else {
    build_lengths<uint64_t>(h, sm, k, arity, cap);
  }
  for (int s = tid; s < kS; s += kThreads) lengths[row * kS + s] = sm.len[s];
  if (dense_mode == 0) return;

  // canonical codes: rank of each symbol among its group's symbols of its
  // length, the groups' counts of each length, the first code per length
  for (int i = tid; i < kGroups * kMaxLen; i += kThreads) (&sm.grp_len[0][0])[i] = 0;
  __syncthreads();
  for (int g = tid >> 5; g < kGroups; g += kThreads / 32) {
    const int s = g * 32 + lane;
    const int l = sm.len[s];
    const unsigned same = __match_any_sync(0xffffffffu, l);
    sm.in_rank[s] = static_cast<uint8_t>(__popc(same & ((1u << lane) - 1u)));
    if ((same & ((1u << lane) - 1u)) == 0) sm.grp_len[g][l] = __popc(same);
  }
  __syncthreads();
  if (tid == 0) {
    long long f = 0;
    sm.first[1] = 0;
    for (int l = 1; l < kMaxLen; ++l) {
      int count = 0;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) count += sm.grp_len[g][l];
      f = (f + count) * arity;
      sm.first[l + 1] = f;
    }
  }
  __syncthreads();
  const int row_width = dense_mode == 1 ? kS : 2 * kS;
  for (int s = tid; s < kS; s += kThreads) {
    const int l = sm.len[s];
    uint32_t fields = 0;
    if (l > 0) {
      const int g = s >> 5;
      long long rank = sm.in_rank[s];
      for (int w = 0; w < g; ++w) rank += sm.grp_len[w][l];
      uint32_t code = static_cast<uint32_t>(sm.first[l] + rank);
      for (int m = l - 1; m >= 0; --m) {  // least significant digit to field l - 1
        fields |= (code % static_cast<uint32_t>(arity)) << (m * bits_per_digit);
        code /= static_cast<uint32_t>(arity);
      }
    }
    int32_t* out = dense + row * row_width;
    if (dense_mode == 1) {
      out[s] = static_cast<int32_t>((static_cast<uint32_t>(l) << shift) | fields);
    } else {
      out[s] = static_cast<int32_t>(fields);
      out[kS + s] = l * bits_per_digit;
    }
  }
}

}  // namespace

// dense_mode 0: lengths only; 1: [B, 256] l << shift | fields; 2: [B, 512]
// fields then field bits.
cudaError_t dct::launch_table_build(const void* hists, void* lengths, void* dense, int B,
                                    int arity, int cap, int dense_mode, int shift,
                                    int bits_per_digit, cudaStream_t stream,
                                    bool* launched) {
  if (B <= 0) return cudaGetLastError();
  table_build_kernel<<<static_cast<unsigned>(B), kThreads, 0, stream>>>(
      static_cast<const int64_t*>(hists), static_cast<int32_t*>(lengths),
      static_cast<int32_t*>(dense), arity, cap, dense_mode, shift, bits_per_digit);
  return dct::launched_if(cudaGetLastError(), launched);
}

extern "C" int dct_table_build(const void* hists, void* lengths, void* dense, int B, int arity,
                               int cap, int dense_mode, int shift, int bits_per_digit,
                               void* stream) {
  return static_cast<int>(dct::launch_table_build(hists, lengths, dense, B, arity, cap,
                                                  dense_mode, shift, bits_per_digit,
                                                  static_cast<cudaStream_t>(stream)));
}
