// Row RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, the mean of squares
// in fp32, the product with the weight in fp32, cast back to x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:23-59
// (_rmsnorm_kernel under rmsnorm_pallas, :31).  That kernel holds a
// (block_rows, d) tile in VMEM and reduces it on the vector unit; here a
// row is the unit of work, because Hopper's shared memory is small and a
// d_model row (at most 8,192 values) fits one block's registers.
//
// Design: one block of 256 threads per row.  Threads stride over the row
// (neighbouring threads, neighbouring addresses: coalesced), each sums
// its squares in fp32; a warp shuffle tree and one shared-memory step
// merge the 8 warps.  The second pass reads the row again (from L1/L2,
// it was just read) and writes (x * inv) * w in the order the reference
// computes it.  x is fp32 or bf16, the weight fp32 or bf16 on its own
// (the decoder passes fp32 masters in decode and bf16-rounded weights in
// prefill), so both types are template parameters: no cast launch.
//
// Bound on the H100 (3.35 TB/s): bytes.  Each x read once, each y
// written once, the weight read once: 16 x 1,536 bf16 rows (a decode
// step of the full-width cell) move 104 KB, about 0.03 us, far below a
// launch; the kernel is launch-bound on the serving path.
//
// Plain C interface (bound with ctypes): type codes 0 = fp32, 1 = bf16.
// The launcher checks nothing the Python wrapper already checks,
// launches on the caller's stream, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unknown type code).

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TX* __restrict__ y, int d, float eps) {
  __shared__ float part[kThreads / 32];
  const size_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TX* yr = y + row * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? part[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads)
    yr[i] = from_f<TX>(to_f(xr[i]) * inv * to_f(w[i]));
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  rmsnorm_kernel<TX, TW><<<rows, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(y),
      d, eps);
}

}  // namespace

extern "C" int rmsnorm_launch(const void* x, const void* w, void* y, int rows,
                              int d, float eps, int x_type, int w_type,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const int code = 2 * x_type + w_type;
  switch (code) {
    case 0:
      launch<float, float>(x, w, y, rows, d, eps, s);
      break;
    case 1:
      launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, s);
      break;
    case 2:
      launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, s);
      break;
    case 3:
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
