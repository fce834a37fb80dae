// Row RMSNorm with the residual add folded in:
//   s = x + delta, in x's type (the fp32 sum rounded once, as PyTorch's
//   add gives it), and y = s * rsqrt(mean(s^2) + eps) * w, the mean of
//   squares in fp32, the product with the weight in fp32, cast back.
// With delta null it is the plain norm, y = rmsnorm(x, w), and s is not
// written.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:23-59
// (_rmsnorm_kernel under rmsnorm_pallas, :31).  That kernel holds a
// (block_rows, d) tile in VMEM and reduces it on the vector unit; here a
// row is the unit of work, held in one block's registers.  The residual
// add the TPU model leaves to XLA beside the norm is folded in, because
// on this card the norm of a decode step is launch-bound: the add and
// the norm as two launches cost two launch latencies and five passes
// over the row (the add reads two rows and writes one, the norm reads
// one and writes one), the fused kernel one launch and four passes.
//
// Design: one block per row, about d / 8 threads (rounded up to whole
// warps, 32 to 1,024), each holding PER chunks of 16 bytes of the row
// (8 bf16 or 4 fp32 values; PER = 1 for bf16, 2 for fp32 up to d =
// 8,192) in registers: the row is read once, with 16-byte loads,
// neighbouring threads on neighbouring chunks.  The sum of squares goes
// through a warp shuffle tree and one shared-memory step, after which
// every thread adds the warps' partial sums in the same order: one
// barrier, no second read of the row.  The weight does not depend on
// the kernel ahead on the stream, so it is loaded before
// grid_dep_wait(): launched with programmatic dependent launch
// (launch_pdl), the block's prologue overlaps that kernel's tail.  A
// row whose width is not a multiple of the chunk, or a pointer that is
// not 16-byte aligned, takes the same layout with scalar loads and
// stores and a bound check per element.  No kernel attribute is set.
// x and the weight are fp32 or bf16 each (the decoder passes fp32
// masters in decode and bf16-rounded weights in prefill), as template
// parameters: no cast launch.
//
// Bound on the H100 (3.35 TB/s): bytes.  x and delta read, s and y
// written, each once, the weight read once: [16, 1536] bf16 rows with
// an fp32 weight (a decode step of the full-width qwen2 cell) move
// 202,752 bytes, 0.0605 us, far below a launch; the plain norm moves
// 104,448 bytes, 0.031 us.
//
// Plain C interface (bound with ctypes): type codes 0 = fp32, 1 = bf16.
// The launcher checks nothing the Python wrapper already checks,
// launches on the caller's stream, does not synchronise, and returns
// the launch's cudaError_t (cudaErrorInvalidValue for an unknown type
// code or a row wider than the register tile).

#include "common.cuh"
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 32-bit words <-> fp32 values of a chunk: fp32 one value a word, bf16
// two (the low half first, as they lie in memory).
template <typename T, int W>
__device__ __forceinline__ void unpack(float* f, const uint32_t (&w)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T, int W>
__device__ __forceinline__ void pack(uint32_t (&w)[W], const float* f) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      w[i] = __float_as_uint(f[i]);
    } else {
      w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);  // round to nearest even
    }
  }
}

// E consecutive values of T at p (aligned to E * sizeof(T), at most 16
// bytes) as fp32: 16- or 8-byte loads.
template <typename T, int E>
__device__ __forceinline__ void load_vec(float* f, const T* p) {
  constexpr int W = E * static_cast<int>(sizeof(T)) / 4;
  static_assert(W == 2 || W % 4 == 0, "a chunk is 8 or 16k bytes");
  uint32_t w[W];
  if constexpr (W == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else {
#pragma unroll
    for (int q = 0; q < W / 4; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      w[4 * q] = u.x, w[4 * q + 1] = u.y, w[4 * q + 2] = u.z, w[4 * q + 3] = u.w;
    }
  }
  unpack<T, W>(f, w);
}

// E values of T from fp32 to p (16 bytes, aligned): one 16-byte store.
template <typename T, int E>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  constexpr int W = E * static_cast<int>(sizeof(T)) / 4;
  static_assert(W == 4, "an output chunk is 16 bytes");
  uint32_t w[W];
  pack<T, W>(w, f);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// v rounded to T and back: what a T tensor holding v reads as.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// One block per row; blockDim.x threads, thread t holding chunks t,
// t + blockDim.x, ... (PER of them) of E = 16 / sizeof(TX) values.
// vec: every pointer 16-byte aligned (the weight to its own chunk
// width) and d a multiple of E, so every chunk that starts below d is
// whole and goes by vector loads and stores.
template <typename TX, typename TW, int PER>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TX* __restrict__ delta,
                   const TW* __restrict__ w, TX* __restrict__ s,
                   TX* __restrict__ y, int d, float eps, bool vec) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  __shared__ float part[kMaxThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  const int nthr = blockDim.x;
  float wv[PER][E], v[PER][E];
  // the weight first: no kernel ahead on the stream writes it
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i0 = (threadIdx.x + k * nthr) * E;
    if (vec && i0 < d) {
      load_vec<TW, E>(wv[k], w + i0);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) wv[k][j] = i0 + j < d ? to_f(w[i0 + j]) : 0.f;
    }
  }
  grid_dep_wait();  // x and delta come from the kernels ahead
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i0 = (threadIdx.x + k * nthr) * E;
    if (vec && i0 < d) {
      load_vec<TX, E>(v[k], x + off + i0);
      if (delta != nullptr) {
        float dv[E];
        load_vec<TX, E>(dv, delta + off + i0);
#pragma unroll
        for (int j = 0; j < E; ++j) v[k][j] = round_to<TX>(v[k][j] + dv[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int i = i0 + j;
        float a = i < d ? to_f(x[off + i]) : 0.f;
        if (delta != nullptr && i < d) a = round_to<TX>(a + to_f(delta[off + i]));
        v[k][j] = a;
      }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) ss = fmaf(v[k][j], v[k][j], ss);
  }
  grid_dep_launch();  // the row is in registers: a dependent may start
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < (nthr >> 5); ++i) tot += part[i];  // same order everywhere
  const float inv = rsqrtf(tot / static_cast<float>(d) + eps);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i0 = (threadIdx.x + k * nthr) * E;
    if (i0 >= d) continue;
    float o[E];
#pragma unroll
    for (int j = 0; j < E; ++j) o[j] = v[k][j] * inv * wv[k][j];
    if (vec) {
      if (delta != nullptr) store_vec<TX, E>(s + off + i0, v[k]);
      store_vec<TX, E>(y + off + i0, o);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (i0 + j >= d) break;
        if (delta != nullptr) s[off + i0 + j] = from_f<TX>(v[k][j]);
        y[off + i0 + j] = from_f<TX>(o[j]);
      }
    }
  }
}

bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* delta, const void* w, void* s,
                   void* y, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int E = 16 / static_cast<int>(sizeof(TX));
  const int wbytes = E * static_cast<int>(sizeof(TW));
  // about d / 8 threads, in whole warps (d is below 2^31 - 255)
  const int threads =
      std::min(kMaxThreads, std::max(32, (d + 8 * 32 - 1) / (8 * 32) * 32));
  const int chunks = (d + E - 1) / E;
  const int per = (chunks + threads - 1) / threads;
  const bool vec = d % E == 0 && aligned(x, 16) && aligned(y, 16) &&
                   aligned(w, wbytes < 16 ? wbytes : 16) &&
                   (delta == nullptr || (aligned(delta, 16) && aligned(s, 16)));
  const auto* xp = static_cast<const TX*>(x);
  const auto* dp = static_cast<const TX*>(delta);
  const auto* wp = static_cast<const TW*>(w);
  auto* sp = static_cast<TX*>(s);
  auto* yp = static_cast<TX*>(y);
  if (per == 1)
    return launch_pdl(rmsnorm_kernel<TX, TW, 1>, dim3(rows), dim3(threads), 0,
                      stream, xp, dp, wp, sp, yp, d, eps, vec);
  if (per == 2)
    return launch_pdl(rmsnorm_kernel<TX, TW, 2>, dim3(rows), dim3(threads), 0,
                      stream, xp, dp, wp, sp, yp, d, eps, vec);
  return cudaErrorInvalidValue;  // wider than 2 chunks x 1,024 threads
}

}  // namespace

// delta and s null: the plain norm.  Otherwise s = x + delta is written
// beside y.
extern "C" int rmsnorm_launch(const void* x, const void* delta, const void* w,
                              void* s, void* y, int rows, int d, float eps,
                              int x_type, int w_type, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  auto st = static_cast<cudaStream_t>(stream);
  switch (2 * x_type + w_type) {
    case 0:
      err = launch<float, float>(x, delta, w, s, y, rows, d, eps, st);
      break;
    case 1:
      err = launch<float, __nv_bfloat16>(x, delta, w, s, y, rows, d, eps, st);
      break;
    case 2:
      err = launch<__nv_bfloat16, float>(x, delta, w, s, y, rows, d, eps, st);
      break;
    case 3:
      err = launch<__nv_bfloat16, __nv_bfloat16>(x, delta, w, s, y, rows, d,
                                                 eps, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
