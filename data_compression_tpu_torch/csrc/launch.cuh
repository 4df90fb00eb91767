// Host launch helpers of the compress pipeline's kernels, one per kernel.
// Each kernel's grid and block choice lives in its own source, in its
// helper; the per-kernel C entry points (dct_histogram, dct_table_build,
// dct_huffman_encode, dct_compact) and the chained entry point
// (compress_chain.cu, dct_compress_chain) both launch through them.  A
// helper launches on `stream` (nothing when there is no work), allocates
// nothing, reads nothing back, sets *launched (when given) once its kernel
// is enqueued, and returns the launch's error (cudaGetLastError()), or
// cudaErrorInvalidValue for an argument it cannot launch with.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dct {

// A helper's return: the launch's error `e`, with *launched set if it is none.
inline cudaError_t launched_if(cudaError_t e, bool* launched) {
  if (launched != nullptr && e == cudaSuccess) *launched = true;
  return e;
}

// histogram.cu: [B, S] rows (row stride row_stride, row b valid up to
// lengths[b]) -> [B, 256] int64 counts; parts: CTAs of one cluster a row, 1-8.
cudaError_t launch_histogram(const void* blocks, int64_t row_stride, const void* lengths,
                             void* out, int B, int64_t S, int parts, cudaStream_t stream,
                             bool* launched = nullptr);

// table_build.cu: [B, 256] int64 counts -> [B, 256] int32 code lengths and,
// unless dense_mode is 0, the encode table.
cudaError_t launch_table_build(const void* hists, void* lengths, void* dense, int B, int arity,
                               int cap, int dense_mode, int shift, int bits_per_digit,
                               cudaStream_t stream, bool* launched = nullptr);

// huffman_encode.cu: the compact encode at n = 2, 3 or 16.
cudaError_t launch_huffman_encode(const void* blocks, const void* raw_lens, const void* dense,
                                  void* rows, void* digits, void* block_bytes, int B, int S,
                                  int C, int64_t row_cap, int arity, cudaStream_t stream,
                                  bool* launched = nullptr);

// compact.cu: rows[b, :n_b] back to back into flat[0, total), zeros past
// ends[B-1]; ends the inclusive int64 cumsum of the block byte counts.
cudaError_t launch_compact(const void* rows, const void* ends, void* flat, int B,
                           int64_t row_cap, int64_t total, cudaStream_t stream,
                           bool* launched = nullptr);

}  // namespace dct
