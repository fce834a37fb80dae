// Device helpers shared by the port's CUDA sources: fp32 <-> storage
// type conversion, a dot product in four partial sums, and the walk of a
// packed lower triangle.  Each source includes this header once; the
// build digests it with the source, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

}  // namespace
