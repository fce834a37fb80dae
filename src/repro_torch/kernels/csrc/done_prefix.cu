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
// Claim check (claim_check_launch): the same exactly-once check taken
// straight from the lane engine's [R, n] bool claim masks, with the two
// steps before it in the reference folded into the launch -- packing
// the mask into 32-bit words (src/repro/kernels/ops.py pack_bits_u32,
// called at src/repro/core/jaxplane.py:1348) and their popcount
// (:1447).  One launch returns the words, each row's popcount and its
// done prefix min(run of ones from bit 0, n_bits, limit); bit b of
// word j is slot 32*j + b and pad bits past n are 0.
//
// Design: one warp per row.  A round covers 512 slots: lane l loads the
// 16 bool bytes of slots 16*l.. (one 16-byte load where the rows allow
// it), turns each 4-byte group into 4 bits (__vcmpne4, then one
// multiply gathers the byte flags), and the 16-bit halves of two
// neighbouring lanes make one word (one shuffle).  Lanes 0-15 then hold
// the round's 16 words in order and write them coalesced, add __popc
// and keep the smallest first zero 32*j + __ffs(~w) - 1; the warp
// merges with __reduce_add_sync and __reduce_min_sync.  The popcount
// needs every slot, so no row ends early.
//
// Alignment: a 16-byte load needs every row start 16-byte aligned,
// i.e. n and the base address divisible by 16.  The wrapper picks the
// widest load, 16, 8, 4 or 1 bytes, that divides both (the serving
// grid's n = 1000 takes 8); the kernel is instantiated for each.
//
// Bound on the H100 (3.35 TB/s): bytes.  At the sweep's [5040, 2000]
// the launch reads 10,080,000 mask bytes and writes 1,270,080 bytes of
// words and 40,320 of counts, ~11.39 MB, ~3.40 us; a few integer
// operations per 4 slots leave the operations far below that.
//
// Plain C interface (bound with ctypes): the launchers check nothing
// the Python wrapper already checks, launch on the caller's stream, do
// not synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kClaimWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

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


// four bool bytes -> four bits (bit i set when byte i is not 0)
__device__ __forceinline__ uint32_t byte_flags(uint32_t x) {
  const uint32_t b = __vcmpne4(x, 0u) & 0x01010101u;
  return (b * 0x01020408u) >> 24;  // byte i's flag lands on bit 24 + i
}

// bits of the 16 slots s .. s + 15 of one row (slots >= n read as 0);
// V is the load width in bytes, and n and the row start are V-aligned,
// so a V-byte chunk lies wholly inside the row or wholly past it
template <int V>
__device__ __forceinline__ uint32_t load_half(const uint8_t* row, int s,
                                              int n) {
  uint32_t m = 0;
  if constexpr (V == 16) {
    if (s < n) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + s);
      m = byte_flags(v.x) | byte_flags(v.y) << 4 | byte_flags(v.z) << 8 |
          byte_flags(v.w) << 12;
    }
  } else if constexpr (V == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (s + 8 * h < n) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + s + 8 * h);
        m |= (byte_flags(v.x) | byte_flags(v.y) << 4) << (8 * h);
      }
    }
  } else if constexpr (V == 4) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      if (s + 4 * h < n) {
        m |= byte_flags(*reinterpret_cast<const uint32_t*>(row + s + 4 * h))
             << (4 * h);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (s + i < n && row[s + i] != 0) m |= 1u << i;
    }
  }
  return m;
}

template <int V>
__global__ void claim_check_kernel(const uint8_t* __restrict__ claimed,
                                   const int32_t* __restrict__ limit,
                                   int limit_all, int32_t* __restrict__ words,
                                   int32_t* __restrict__ popcount,
                                   int32_t* __restrict__ prefix, int rows,
                                   int n, int n_words, int n_bits) {
  const int row = blockIdx.x * kClaimWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  // uniform per warp: every lane of a warp shares its row index
  if (row >= rows) return;
  const uint8_t* src = claimed + static_cast<size_t>(row) * n;
  int32_t* dst = words + static_cast<size_t>(row) * n_words;
  int count = 0;
  int run = n;  // a row of ones runs through all n slots
#pragma unroll 2
  for (int base = 0; base < n; base += 512) {
    const uint32_t half = load_half<V>(src, base + 16 * lane, n);
    // even lane 2i: word i of the round, its high half from lane 2i + 1
    const uint32_t word = half | __shfl_down_sync(kFull, half, 1) << 16;
    // lane i < 16 takes word i, so the stores below are in order
    const uint32_t w = __shfl_sync(kFull, word, (2 * lane) & 31);
    const int j = (base >> 5) + lane;
    if (lane < 16 && j < n_words) {
      dst[j] = static_cast<int32_t>(w);
      count += __popc(w);
      if (~w != 0u) run = min(run, 32 * j + __ffs(static_cast<int>(~w)) - 1);
    }
  }
  count = __reduce_add_sync(kFull, count);
  run = __reduce_min_sync(kFull, run);
  if (lane == 0) {
    const int cap = limit != nullptr ? limit[row] : limit_all;
    popcount[row] = count;
    prefix[row] = min(run, min(n_bits, cap));
  }
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

// vec: the load width the wrapper chose (16, 8, 4 or 1 bytes; it
// divides n and the address of claimed); limit may be null, and then
// every row takes limit_all
extern "C" int claim_check_launch(const void* claimed, const void* limit,
                                  int limit_all, void* words, void* popcount,
                                  void* prefix, int rows, int n, int n_words,
                                  int n_bits, int vec, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const int blocks = (rows + kClaimWarps - 1) / kClaimWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const uint8_t*>(claimed);
  const auto* l = static_cast<const int32_t*>(limit);
  auto* w = static_cast<int32_t*>(words);
  auto* p = static_cast<int32_t*>(popcount);
  auto* r = static_cast<int32_t*>(prefix);
  switch (vec) {
    case 16:
      claim_check_kernel<16><<<blocks, 32 * kClaimWarps, 0, s>>>(
          c, l, limit_all, w, p, r, rows, n, n_words, n_bits);
      break;
    case 8:
      claim_check_kernel<8><<<blocks, 32 * kClaimWarps, 0, s>>>(
          c, l, limit_all, w, p, r, rows, n, n_words, n_bits);
      break;
    case 4:
      claim_check_kernel<4><<<blocks, 32 * kClaimWarps, 0, s>>>(
          c, l, limit_all, w, p, r, rows, n, n_words, n_bits);
      break;
    case 1:
      claim_check_kernel<1><<<blocks, 32 * kClaimWarps, 0, s>>>(
          c, l, limit_all, w, p, r, rows, n, n_words, n_bits);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
