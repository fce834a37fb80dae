// Batched ring done-prefix: for each of R slot rings, the length of the
// contiguous run of done slots from `start` (mod n), capped by `limit`.
// This is the paper's TAIL advance (read_batch_done, Listing 2 line 37)
// for every decode-slot ring of the serving engine in one launch.
//
// Replaces the TPU kernel src/repro/kernels/doneprefix.py:58-103
// (_done_prefix_kernel under done_prefix_batch_pallas, :81).  That
// kernel tiles each ring over a sequential grid axis, rotates by an
// index comparison and carries a running min in its output cell; Hopper
// blocks run in no order, so the sequential axis becomes a loop inside
// one warp instead.
//
// Design: one warp per ring row.  The warp walks the ring in rotated
// order, 32 offsets at a time: lane l of round i reads slot
// (start + 32 i + l) mod n.  __ballot_sync gathers the 32 "not done"
// flags of a round into one word, and the lowest set bit of the first
// non-zero word is the run length, the same for every lane, so the loop
// stops at the first not-done slot and reads nothing past it.  Lane 0
// writes min(run, n, limit).  The mask arrives as one byte per slot
// (torch.bool).  Exact for every input: limit 0, start at n - 1, an
// all-done ring (run = n), n not a multiple of 32 (offsets past n vote
// "done" and are cut by the final min with n).
//
// Bound on the H100 (3.35 TB/s): the kernel reads at most each mask byte
// and each start/limit once and writes one int32 per ring.  The serving
// engine's rings are tiny ([4, 4] at the full-width cell: 16 bytes of
// mask), so one launch (several microseconds) is all it costs; the warp
// per row layout keeps even large R (thousands of rings) one pass.
//
// Plain C interface (bound with ctypes): the launcher checks nothing
// the Python wrapper already checks, launches on the caller's stream,
// does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void done_prefix_batch_kernel(const uint8_t* __restrict__ done,
                                         const int32_t* __restrict__ start,
                                         const int32_t* __restrict__ limit,
                                         int32_t* __restrict__ out, int rows,
                                         int n) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // uniform per warp: every lane of a warp shares its row index
  if (row >= rows) return;
  const uint8_t* d = done + static_cast<size_t>(row) * n;
  int s = start[row] % n;  // floor modulo, as the reference's `%`
  if (s < 0) s += n;
  int run = n;
  for (int base = 0; base < n; base += 32) {
    const int o = base + lane;
    int slot = s + o;
    if (slot >= n) slot -= n;  // s < n and o < n, so one wrap at most
    const bool not_done = o < n && d[slot] == 0;
    const unsigned vote = __ballot_sync(0xffffffffu, not_done);
    if (vote != 0u) {  // uniform: every lane holds the same vote
      run = base + __ffs(static_cast<int>(vote)) - 1;
      break;
    }
  }
  if (lane == 0) out[row] = min(run, min(n, limit[row]));
}

}  // namespace

extern "C" int done_prefix_batch_launch(const void* done, const void* start,
                                        const void* limit, void* out, int rows,
                                        int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    done_prefix_batch_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(done), static_cast<const int32_t*>(start),
        static_cast<const int32_t*>(limit), static_cast<int32_t*>(out), rows,
        n);
  }
  return static_cast<int>(cudaGetLastError());
}
