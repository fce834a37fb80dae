// Flash attention (prefill): causal or full GQA attention over a whole
// prompt, online softmax with fp32 running max, denominator and
// accumulator, queries placed at q_offset in the key timeline.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:35-166
// (_flash_kernel under flash_attention_pallas, :107).  That kernel puts
// the KV axis on a sequential grid dimension and carries (m, l, acc) in
// VMEM scratch from one grid step to the next; Hopper blocks run in no
// order, so one block owns a query tile and loops over the key tiles,
// with (m, l, acc) in registers.
//
// Layouts: the model's.  q [B, Sq, H, D], k/v [B, Sk, Hkv, D], out
// [B, Sq, H, D].  Query head h reads KV head h / G (G = H / Hkv): with
// rows numbered bh = b * H + h, as the reference's ops.attention folds
// them, that is KV row bh / G -- GQA with no repeated K/V.  Reading the
// model layout directly saves the reference's transposes to [B*H, S, D]
// and back.
//
// Design: one block of 256 threads per (b, h, tile of 64 queries).
// Four threads share a query row; each owns D/4 of its dimensions, in
// float4 chunks interleaved so that the four read 64 contiguous bytes of
// shared memory (no bank conflict), and all rows of a warp read the same
// key (broadcast).  Per tile of 64 keys, loaded once into shared memory
// as fp32 (zeros past the last key, so a masked column adds exactly 0):
// each thread forms its partial dot products, two xor shuffles complete
// them (bitwise the same on the four threads), the row's 64 scores stay
// in registers, then the usual rescale-and-accumulate.  Masked: keys at
// or past Sk, and with `causal` keys past qpos + q_offset; in the causal
// case the key loop stops at the tile's last admissible key.  The output
// is acc / max(l, 1e-37), so a row with no admissible key gives 0, as
// the TPU kernel's does.  D is a template parameter (32, 64, 128); the
// math is scalar fp32 FMAs.  Tensor cores (mma.sync, then wgmma with
// TMA-fed tiles) are later work.
//
// Bound on the H100.  For qwen2-1.5b's prefill (B = 1, Sq = Sk = 384,
// H = 12, Hkv = 2, D = 128, causal, bf16) the scores and the weighted
// sum take 4 D operations per admissible (query, key) pair: 0.45 GFLOP,
// 0.46 us at the bf16 tensor-core peak (989 TFLOP/s); q, k, v and out
// are 2.75 MB, 0.82 us at 3.35 TB/s, so at this shape the bound is
// bytes.  Scalar fp32 FMAs (67 TFLOP/s at best) put this design at
// several microseconds or more; the tensor cores close that gap later.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher returns cudaGetLastError() and does not synchronise.

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kRows = 64;     // queries per block
constexpr int kTileK = 64;    // keys per shared-memory tile
constexpr int kSplit = 4;     // threads per query row
constexpr int kThreads = kRows * kSplit;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int Sq, int Sk, int H, int Hkv, int q_offset,
                           int causal, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int kChunks = D / 16;  // float4 chunks per thread
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kTileK, D]
  float* v_s = k_s + kTileK * D;                 // [kTileK, D]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int r = tid / kSplit;
  const int part = tid % kSplit;
  const int qpos = q0 + r;
  const bool q_valid = qpos < Sq;

  // this thread's dimensions: chunk c covers d = 16 c + 4 part + {0..3}
  float4 qr[kChunks];
  float4 acc[kChunks];
  {
    const T* qrow = q + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 16 * c + 4 * part;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q_valid) {
        x.x = to_f(qrow[d]) * scale;
        x.y = to_f(qrow[d + 1]) * scale;
        x.z = to_f(qrow[d + 2]) * scale;
        x.w = to_f(qrow[d + 3]) * scale;
      }
      qr[c] = x;
      acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  int kend = Sk;
  if (causal) {
    const int qlast = min(q0 + kRows, Sq) - 1;
    kend = min(Sk, qlast + q_offset + 1);
  }
  const size_t row_stride = static_cast<size_t>(Hkv) * D;  // one key
  const T* kb = k + static_cast<size_t>(b) * Sk * row_stride + kvh * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * row_stride + kvh * D;

  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    const int nk = min(kTileK, kend - k0);
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const size_t src = static_cast<size_t>(k0 + j) * row_stride + d;
        kx = to_f(kb[src]);
        vx = to_f(vb[src]);
      }
      k_s[i] = kx;
      v_s[i] = vx;
    }
    __syncthreads();

    float s[kTileK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * D);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = kr[4 * c + part];
        dot += qr[c].x * kk.x;
        dot += qr[c].y * kk.y;
        dot += qr[c].z * kk.z;
        dot += qr[c].w * kk.w;
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      const bool ok =
          q_valid && j < nk && (!causal || qpos + q_offset >= kpos);
      s[j] = ok ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - m_safe);
      s[j] = p;
      sum += p;
    }
    l = l * alpha + sum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTileK; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * D);
      const float p = s[j];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vr[4 * c + part];
        acc[c].x += p * vv.x;
        acc[c].y += p * vv.y;
        acc[c].z += p * vv.z;
        acc[c].w += p * vv.w;
      }
    }
  }

  if (q_valid) {
    const float den = fmaxf(l, 1e-37f);
    T* orow = out + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 16 * c + 4 * part;
      orow[d] = from_f<T>(acc[c].x / den);
      orow[d + 1] = from_f<T>(acc[c].y / den);
      orow[d + 2] = from_f<T>(acc[c].z / den);
      orow[d + 3] = from_f<T>(acc[c].w / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                   int causal, float scale, cudaStream_t stream) {
  const size_t bytes = 2 * kTileK * D * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, q_offset,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int Hkv, int D,
                       int q_offset, int causal, float scale,
                       cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, causal,
                           scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, causal,
                           scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, q_offset, causal,
                            scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      int q_offset, int causal, float scale,
                                      int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * H == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, q_offset,
                            causal, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D,
                                    q_offset, causal, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
