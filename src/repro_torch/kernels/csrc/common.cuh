// Helpers shared by the port's CUDA sources: fp32 <-> storage type
// conversion, a dot product in four partial sums, the walk of a packed
// lower triangle, 16-byte asynchronous copies into shared memory, the
// dynamic shared-memory limit of a kernel, the bf16 tensor-core
// fragments (ldmatrix, mma.sync), programmatic dependent launch, a tile
// loader and the state-passing pass of the chunked scans.  Each source
// includes this header once; the build digests it with the source, so
// an edit here rebuilds them all.

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

// Ask for the largest shared-memory carveout of the SM's unified L1 for
// `kernel`.  An SM runs blocks of two kernels at once only when both
// want the same carveout, and left to choose, the CUDA runtime may give a
// kernel a carveout that holds a single block of it; the kernels of one
// scan chain (launch_pdl) all ask for this one, so that a dependent's
// blocks can start beside its predecessor's.  The same value on every
// call, so threads launching at once cannot disagree.
template <typename Kernel>
cudaError_t prefer_max_shared(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              static_cast<int>(cudaSharedmemCarveoutMaxShared));
}

// Let `kernel` take up to the device's opt-in maximum of dynamic shared
// memory, after checking that `bytes` fits, with the largest carveout
// (prefer_max_shared).  The limit set is the same on every call: the
// serving engine launches from several threads at once, and setting each
// launch's own bytes lets one thread lower the limit between another
// thread's setting and its launch, which then fails.
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
  int device = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  if (bytes > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  return prefer_max_shared(kernel);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

typedef __nv_bfloat16 bf16;

// Four 8x8 b16 matrices from shared memory: lanes 8i..8i+7 give the row
// addresses of matrix i, register i receives it in the mma fragment
// layout (row lane / 4, columns 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}


// Programmatic dependent launch.  A kernel launched with launch_pdl may
// start before the kernel ahead of it on the stream has finished; it
// must call grid_dep_wait() before it reads anything that kernel
// writes (the wait returns once that grid has completed and its writes
// are visible).  grid_dep_launch() lets the next such kernel start
// early.  Every kernel launched with launch_pdl waits in every block,
// so its completion implies the completion of all work before it on
// the stream, whatever another thread enqueued in between.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename Kernel, typename... Args>
cudaError_t launch_pdl(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Rows [0, rows) of a [rows][cols] tile from global memory (row r at
// src + r * stride elements, its cols dense) into shared memory at
// dst + r * ld, as T.  Rows at or past `valid` are zero-filled.  With
// `vec` (src, stride and cols 16-byte aligned, ld too) the rows go by
// 16-byte cp.async copies, which the caller commits and waits for;
// otherwise element by element.  Columns past cols are not touched.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int cols, int valid, bool vec,
                                          int tid, int nthr) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int ch = cols / E;
    if (nthr % ch == 0) {  // each thread keeps its column: no division
      const int c = tid % ch, step = nthr / ch;
      for (int r = tid / ch; r < rows; r += step) {
        const bool ok = r < valid;
        const T* s = src + (ok ? r * stride + c * E : 0);
        cp_async16(dst + r * ld + c * E, s, ok);
      }
      return;
    }
    for (int i = tid; i < rows * ch; i += nthr) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r < valid;
      const T* s = src + (ok ? r * stride + c * E : 0);
      cp_async16(dst + r * ld + c * E, s, ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += nthr) {
      const int r = i / cols, c = i - r * cols;
      dst[r * ld + c] = r < valid ? src[r * stride + c] : from_f<T>(0.f);
    }
  }
}

// Zero n floats' worth of shared memory (n a multiple of 4, p 16-byte
// aligned): the padding of tiles whose width is not a multiple of 16.
__device__ __forceinline__ void zero_smem(void* p, int n_floats, int tid,
                                          int nthr) {
  float4* q = static_cast<float4*>(p);
  for (int i = tid; i < n_floats / 4; i += nthr)
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// The state-passing pass shared by the chunked scans, called by each
// source's own pass kernel (so that a profile names it by its scan):
// per (b, h) row of `per_row` state elements (a [R, Cn] state, R * Cn =
// per_row) and nc chunks in order, S_c = dec_c * S_{c-1} + delta_c,
// starting from s0.  It writes each chunk's incoming state S_{c-1} to
// s_in (what the output pass reads; store_state: fp32, or for bf16 the
// high parts and after all of them the low parts) and the last state to
// s_out, fp32.
// dec holds one factor per (row, chunk) and state row when dec_rows = R
// (WKV6's per-channel decay), or one per chunk when dec_rows = 1 (SSD's
// scalar decay).  Launched as a programmatic dependent of the
// chunk-local pass, whose delta and dec it reads.  Grid (rows,
// ceil(per_row / (V blockDim))), V consecutive elements a thread (V = 4
// where per_row % 4 == 0 and s0, s_out are 16-byte aligned): few enough
// threads that the output pass's blocks find room beside its waiting
// blocks and start early.  Elementwise: delta and s_in streamed once.
// An incoming state for the output pass, V consecutive elements: fp32
// as it is; for the bf16 tensor-core route the high parts bf16(x) at p
// and the low parts bf16(x - high) at p + lo, so that the product with
// the state keeps about 16 bits of it (two products) where one bf16
// keeps 8.  Four elements go as one 16-byte (fp32) or two 8-byte (bf16)
// stores.
template <int V>
__device__ __forceinline__ void store_state(float* p, size_t, const float* x) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = x[j];
  }
}
template <int V>
__device__ __forceinline__ void store_state(bf16* p, size_t lo, const float* x) {
  float l[V];
  bf16 h[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    h[j] = __float2bfloat16(x[j]);
    l[j] = x[j] - __bfloat162float(h[j]);
  }
  if constexpr (V == 4) {
    const __nv_bfloat162 h01 = __halves2bfloat162(h[0], h[1]);
    const __nv_bfloat162 h23 = __halves2bfloat162(h[2], h[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&h01),
                   *reinterpret_cast<const uint32_t*>(&h23));
    *reinterpret_cast<uint2*>(p + lo) =
        make_uint2(pack_bf16(l[0], l[1]), pack_bf16(l[2], l[3]));
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p[j] = h[j];
      p[lo + j] = __float2bfloat16(l[j]);
    }
  }
}

// V consecutive fp32 (one 16-byte load where V == 4), or zeros.
template <int V>
__device__ __forceinline__ void load_v(float* x, const float* p, bool ok) {
  if constexpr (V == 4) {
    const float4 v = ok ? *reinterpret_cast<const float4*>(p)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) x[j] = ok ? p[j] : 0.f;
  }
}

template <int V, typename T>
__device__ __forceinline__ void state_pass(const float* __restrict__ delta,
                                           const float* __restrict__ dec,
                                           const float* __restrict__ s0,
                                           T* __restrict__ s_in,
                                           float* __restrict__ s_out, int nc,
                                           int per_row, int Cn, int dec_rows) {
  grid_dep_launch();  // the output pass may start its own loads
  const int e = V * (blockIdx.y * blockDim.x + threadIdx.x);
  const size_t row = blockIdx.x;
  const bool live = e < per_row;
  float S[V];
  load_v<V>(S, s0 + row * per_row + e, live);
  grid_dep_wait();
  if (!live) return;
  const float* d = delta + row * nc * per_row + e;
  const float* f = dec + row * nc * dec_rows + (dec_rows > 1 ? e / Cn : 0);
  T* si = s_in + row * nc * per_row + e;
  const size_t lo = static_cast<size_t>(gridDim.x) * nc * per_row;
  // up to kBatch chunks' loads in flight at once, then their updates in
  // order: one round trip to L2 per batch, not per chunk (a row of V
  // elements shares its state row: Cn % V == 0 where V = 4)
  constexpr int kBatch = 8;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float dl[kBatch][V], fl[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (c0 + q >= nc) break;
      const size_t c = c0 + q;
      fl[q] = f[c * dec_rows];
      load_v<V>(dl[q], d + c * per_row, true);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (c0 + q >= nc) break;
      store_state<V>(si + (c0 + q) * per_row, lo, S);
#pragma unroll
      for (int j = 0; j < V; ++j) S[j] = fmaf(fl[q], S[j], dl[q][j]);
    }
  }
  store_state<V>(s_out + row * per_row + e, 0, S);
}

}  // namespace
