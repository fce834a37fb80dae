// Helpers shared by the port's CUDA sources: fp32 <-> storage type
// conversion, a dot product in four partial sums, the walk of a packed
// lower triangle, 16-byte asynchronous copies into shared memory, and
// the dynamic shared-memory limit of a kernel.  Each source includes this header once; the build digests it
// with the source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// sum_{i < n} a[i * sa] * b[i * sb] in four independent partial sums, so
// that consecutive shared-memory loads and FMAs overlap.
__device__ __forceinline__ float dot(const float* a, int sa, const float* b,
                                     int sb, int n) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    p0 = fmaf(a[i * sa], b[i * sb], p0);
    p1 = fmaf(a[(i + 1) * sa], b[(i + 1) * sb], p1);
    p2 = fmaf(a[(i + 2) * sa], b[(i + 2) * sb], p2);
    p3 = fmaf(a[(i + 3) * sa], b[(i + 3) * sb], p3);
  }
  for (; i < n; ++i) p0 = fmaf(a[i * sa], b[i * sb], p0);
  return (p0 + p1) + (p2 + p3);
}

// The e-th pair (t, s), s <= t, of a lower triangle walked row by row.
__device__ __forceinline__ void tri_pair(int e, int& t, int& s) {
  int r = static_cast<int>((sqrtf(8.f * e + 1.f) - 1.f) * 0.5f);
  while ((r + 1) * (r + 2) / 2 <= e) ++r;
  while (r * (r + 1) / 2 > e) --r;
  t = r;
  s = e - r * (r + 1) / 2;
}

// Shared-memory address of a generic pointer, as PTX wants it.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory without passing through
// registers (cp.async, L1 bypassed).  With valid false nothing is read
// and the 16 bytes are zero-filled; src must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Close the copies issued since the last commit into one group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Let `kernel` take up to the device's opt-in maximum of dynamic shared
// memory, after checking that `bytes` fits.  The limit set is the same on
// every call: the serving engine launches from several threads at once,
// and setting each launch's own bytes lets one thread lower the limit
// between another thread's setting and its launch, which then fails.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
