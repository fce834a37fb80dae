// Decode attention: one new query token per sequence against its KV
// cache, keys at positions >= lengths[b] masked, G query heads sharing
// each KV head (GQA), online softmax in fp32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:35-141
// (_decode_kernel under decode_attention_pallas, :92).  That kernel
// streams block_k tiles over a sequential grid axis and keeps the G x
// block_k score tile and the running max, sum and accumulator in VMEM
// scratch across grid steps; here one block walks its whole cache in a
// loop, so the running state lives in the block's shared memory.
//
// Layouts: the model's.  q [B, H, D] with head h = kv * G + g, the cache
// k/v [B, S, Hkv, D] (one layer's slice of the decoder's [L, B, S, Hkv,
// D] cache: contiguous), lengths [B] int32, out [B, H, D].  Reading the
// cache where it lies saves the [B, S, Hkv, D] -> [B*Hkv, S, D] copy
// that the reference's ops.decode_attention makes per layer per step.
//
// Design: one block of 128 threads per (sequence b, KV head kv).  The G
// query rows of that KV head are read once into shared memory, scaled.
// Per tile of kTileK keys: the block loads K (rows padded to D + 1
// floats, so threads on neighbouring keys hit different banks) and V
// into shared memory as fp32; each thread computes whole dot products,
// one (g, key) pair at a time, so every K value read serves G heads;
// one warp per head reduces the tile's max and sum and rescales; then
// threads over (g, d) update the G x D accumulator in shared memory.
// The loop runs to min(lengths[b], S) only: every key it reads is
// valid, so no mask is needed and no byte past the length is moved.
// A length above S is taken as S (the decoder lets an idle slot's
// length pass the cache, as the reference's clamped cache write does);
// a length of 0 reads nothing and writes zeros (acc / max(l, 1e-37)).
//
// Bound on the H100 (3.35 TB/s): bytes.  The kernel reads each valid
// K/V row once: at the full-width cell (B = 16 slots, S = 512, Hkv = 2,
// D = 128, bf16) a full cache is 8.4 MB, about 2.5 us; the FLOPs
// (4 G D per key and KV head) are 90x below the fp32 rate's line.  With
// one block per (b, kv) only B * Hkv = 32 blocks run, a quarter of the
// SMs; splitting the keys over blocks (flash-decoding) is later work.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher returns cudaGetLastError() and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileK = 64;

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
  return __float2bfloat16(x);
}

size_t smem_floats(int G, int D) {
  // q, acc: G x D; K: kTileK x (D + 1); V: kTileK x D; p: G x kTileK;
  // m, l, alpha: G each
  return static_cast<size_t>(2 * G * D + kTileK * (D + 1) + kTileK * D +
                             G * kTileK + 3 * G);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int32_t* __restrict__ lengths,
                            T* __restrict__ out, int S, int Hkv, int G, int D,
                            float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [G, D], scaled
  float* acc = q_s + G * D;               // [G, D]
  float* k_s = acc + G * D;               // [kTileK, D + 1]
  float* v_s = k_s + kTileK * (D + 1);    // [kTileK, D]
  float* p_s = v_s + kTileK * D;          // [G, kTileK]
  float* m_s = p_s + G * kTileK;          // [G]
  float* l_s = m_s + G;                   // [G]
  float* alpha_s = l_s + G;               // [G]

  const int b = blockIdx.x / Hkv;
  const int kv = blockIdx.x % Hkv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int GD = G * D;
  const size_t qbase = (static_cast<size_t>(b) * Hkv + kv) * GD;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  for (int i = tid; i < GD; i += kThreads) {
    q_s[i] = to_f(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const size_t row_stride = static_cast<size_t>(Hkv) * D;  // one key
  const T* kb = k + static_cast<size_t>(b) * S * row_stride + kv * D;
  const T* vb = v + static_cast<size_t>(b) * S * row_stride + kv * D;

  for (int t0 = 0; t0 < len; t0 += kTileK) {
    const int nk = min(kTileK, len - t0);
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < nk * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      const size_t src = static_cast<size_t>(t0 + j) * row_stride + d;
      k_s[j * (D + 1) + d] = to_f(kb[src]);
      v_s[j * D + d] = to_f(vb[src]);
    }
    __syncthreads();
    // scores: one (g, key) dot product per thread per round
    for (int i = tid; i < G * nk; i += kThreads) {
      const int g = i / nk;
      const int j = i - g * nk;
      const float* qr = q_s + g * D;
      const float* kr = k_s + j * (D + 1);
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
      p_s[g * kTileK + j] = s;
    }
    __syncthreads();
    // online softmax: one warp per head
    for (int g = warp; g < G; g += kThreads / 32) {
      float* pr = p_s + g * kTileK;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isinf(m_new) && m_new < 0.f ? 0.f : m_new;
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(pr[j] - m_safe);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha =
            isinf(m_old) && m_old < 0.f ? 0.f : expf(m_old - m_safe);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pr = p_s + g * kTileK;
      float a = acc[i] * alpha_s[g];
      for (int j = 0; j < nk; ++j) a += pr[j] * v_s[j * D + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < GD; i += kThreads) {
    const int g = i / D;
    out[qbase + i] = from_f<T>(acc[i] / fmaxf(l_s[g], 1e-37f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, int B, int S, int Hkv,
                   int G, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<T><<<B * Hkv, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), S, Hkv, G, D, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int B, int S, int Hkv, int G,
                                       int D, float scale, int dtype,
                                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * Hkv == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(q, k, v, lengths, out, B, S, Hkv, G, D, scale,
                                s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
