// Packed done-prefix: the contiguous run of set bits from bit 0 of each
// word-packed bitmap row, capped by n_bits and a per-row limit.
//
// Replaces the TPU kernel src/repro/kernels/doneprefix.py:106-162
// (_done_prefix_packed_kernel under done_prefix_packed_pallas).  That
// kernel walks a row's words over a sequential grid axis and carries a
// running min in its output cell; Hopper blocks run in no order, so the
// sequential axis becomes a loop inside one warp instead.
//
// Design: one warp per bitmap row.  The warp's 32 lanes stride over the
// row's words, so neighbouring threads read neighbouring 4-byte words
// (coalesced 128-byte transactions).  A lane finds a word's trailing
// ones as __ffs(~w) - 1 (no candidate when ~w == 0, i.e. all ones), keeps
// the smallest candidate 32*j + to, and __reduce_min_sync merges the 32
// lanes.  Lane 0 writes min(run, n_bits, limit), so padding bits past
// n_bits in the last word never matter, whatever they hold.
//
// Bound on the H100 (3.35 TB/s): the kernel reads each word once and
// each limit once and writes one int32 per row.  At the sweep's shape,
// [5040, 63] words, that is about 1.3 MB, 0.4 us; one launch costs
// several microseconds, so launch latency dominates and the simple
// warp-per-row layout is enough.
//
// Plain C interface (bound with ctypes): the launcher checks nothing
// the Python wrapper already checks, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void done_prefix_packed_kernel(const uint32_t* __restrict__ words,
                                          const int32_t* __restrict__ limit,
                                          int32_t* __restrict__ out, int rows,
                                          int n_words, int n_bits) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // uniform per warp: every lane of a warp shares its row index
  if (row >= rows) return;
  const uint32_t* w = words + static_cast<size_t>(row) * n_words;
  int best = n_bits;
  for (int j = lane; j < n_words; j += 32) {
    const uint32_t x = ~w[j];
    if (x != 0u) best = min(best, 32 * j + (__ffs(static_cast<int>(x)) - 1));
  }
  best = __reduce_min_sync(0xffffffffu, best);
  if (lane == 0) out[row] = min(best, min(n_bits, limit[row]));
}

}  // namespace

extern "C" int done_prefix_packed_launch(const void* words, const void* limit,
                                         void* out, int rows, int n_words,
                                         int n_bits, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    done_prefix_packed_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(limit), static_cast<int32_t*>(out), rows,
        n_words, n_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
