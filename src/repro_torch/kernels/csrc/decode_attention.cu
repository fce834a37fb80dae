// Decode attention: one new query token per sequence against its KV
// cache, keys at positions >= lengths[b] masked, G query heads sharing
// each KV head (GQA), online softmax in fp32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:35-141
// (_decode_kernel under decode_attention_pallas, :92).  That kernel
// streams block_k tiles over a sequential grid axis and keeps the G x
// block_k score tile and the running max, sum and accumulator in VMEM
// scratch across grid steps.  Hopper blocks run in no order, so here the
// keys are split over blocks (flash-decoding) and a second pass merges
// the blocks' partial softmax states.
//
// Layouts: the model's.  q [B, H, D] with head h = kv * G + g, the cache
// k/v [B, S, Hkv, D] (one layer's slice of the decoder's [L, B, S, Hkv,
// D] cache: contiguous), lengths [B] int32, out [B, H, D].  Reading the
// cache where it lies saves the [B, S, Hkv, D] -> [B*Hkv, S, D] copy
// that the reference's ops.decode_attention makes per layer per step.
//
// Design.  The grid is (key split, KV head x block of GB query heads,
// slot b); the wrapper picks the splits (decode_splits in
// decode_attention.py) so that the grid holds about two blocks per SM
// where the cache allows it.  A block of 128 threads takes the keys
// [split * kps, min((split + 1) * kps, len)) in 64-key tiles, which
// 16-byte cp.async copies bring into a two-stage shared-memory ring, in
// the storage type (tile j + 1 lands while tile j is used).  Each warp
// copies and reads its own 16 keys of a tile, so the ring needs only
// warp barriers.  A warp's lanes split D into 16-byte chunks, so a
// group of D / 8 (bf16) or D / 4 (fp32) lanes reads one key row and a
// shuffle reduction finishes each dot product.  Every K value read
// serves all GB heads, whose queries and accumulators stay in
// registers.  Each lane group keeps its own running (m, l, acc); at the
// end the groups merge by shuffles, the warps through shared memory,
// and the block writes its partial (m, l, acc) to an fp32 workspace
// that the wrapper allocates per call (no static buffer, no counter:
// the serving engine launches from several threads at once).  The
// second kernel merges the splits per (b, h) in one pass:
//   out = sum_i acc_i 2^(m_i - M) / max(sum_i l_i 2^(m_i - M), 1e-37);
// it is a programmatic dependent launch, so its launch overlaps the
// split kernel's tail.  With one split the block writes out directly
// and the merge is not launched.  Scores are scaled by scale * log2(e) and exponentiated
// with exp2f.
//
// Edges.  A length above S counts as S (the decoder lets an idle slot's
// length pass the cache, as the reference's clamped cache write does);
// a block whose range starts at or past the length writes m = -inf and
// l = 0 (the merge skips it) and exits; a length of 0 gives zeros.  No
// byte past the length is read: the copies of the keys past it in the
// last tile are zero-filled instead.
//
// Bound on the H100 (3.35 TB/s): bytes.  Each valid K/V row is read
// once: at the full-width cell (B = 16 slots, S = 512, Hkv = 2, D = 128,
// bf16) a full cache is 8.4 MB, about 2.5 us; the FLOPs (4 G D per key
// and KV head) are 90x below the fp32 rate's line, so no tensor cores.
// The splits put 256 blocks on the 132 SMs at that cell (8 splits of 64
// keys), where one block per (b, kv) put 32.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher returns cudaGetLastError() and does not synchronise.

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 64;  // keys per shared-memory tile
constexpr int kKeysPerWarp = kKeys / kWarps;
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a block: the K/V ring, which the cross-warp merge
// reuses once the keys are done (kWarps x GB x (D + 2) floats, always
// smaller).  The wrapper's check calls this same function.
size_t smem_bytes(int D, int elem) {
  return static_cast<size_t>(kStages) * 2 * kKeys * D * elem;
}

// 16 bytes of storage as fp32 values.
__device__ __forceinline__ void unpack16(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> fp32 is exact
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int D, int GB>
__global__ void __launch_bounds__(kThreads)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ ws, int S,
                        int Hkv, int G, int n_gb, int kps, int n_splits,
                        float scale_log2) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int LPK = D / E;         // lanes per key row
  constexpr int KPW = 32 / LPK;      // keys a warp reads at once
  constexpr int NS = kKeysPerWarp / KPW;  // keys per lane group per tile
  constexpr int NB0 = GB >= 8 ? 2 : 4;    // keys scored per softmax step
  constexpr int NB = NS < NB0 ? NS : NB0;
  static_assert(LPK >= 1 && LPK <= 32 && NS % NB == 0, "bad shape");
  extern __shared__ uint4 smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // [kStages][K, V][kKeys][D]

  const int split = blockIdx.x;
  const int kv = blockIdx.y / n_gb;
  const int g0 = (blockIdx.y - kv * n_gb) * GB;  // first query head
  const int gn = min(GB, G - g0);
  const int b = blockIdx.z;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane / LPK;  // lane group: one key row at a time
  const int c = lane % LPK;    // this lane's chunk of D
  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int start = split * kps;
  const size_t bh0 = static_cast<size_t>(b) * H + kv * G + g0;
  const size_t n_bh = static_cast<size_t>(gridDim.z) * H;

  if (start >= len) {  // nothing to read
    if (n_splits == 1) {
      for (int i = tid; i < gn * D; i += kThreads)
        out[bh0 * D + i] = from_f<T>(0.f);
    } else if (tid < gn) {
      const size_t at = (bh0 + tid) * n_splits + split;
      ws[n_bh * n_splits * D + at] = -INFINITY;  // m
      ws[n_bh * n_splits * (D + 1) + at] = 0.f;  // l
    }
    return;
  }
  const int end = min(start + kps, len);
  const int ntiles = (end - start + kKeys - 1) / kKeys;

  const size_t row_stride = static_cast<size_t>(Hkv) * D;  // one key
  const T* kb = k + static_cast<size_t>(b) * S * row_stride + kv * D;
  const T* vb = v + static_cast<size_t>(b) * S * row_stride + kv * D;
  // each warp copies, and alone reads, its own 16 rows of every tile, so
  // the ring needs no block-wide barrier
  auto load_kv = [&](int t, int st) {
    T* ks = ring + st * 2 * kKeys * D;
    T* vs = ks + kKeys * D;
    const int t0 = start + t * kKeys;
    for (int i = lane; i < kKeysPerWarp * LPK; i += 32) {
      const int r = kKeysPerWarp * warp + i / LPK;
      const int ch = i % LPK;
      const bool ok = t0 + r < end;
      const size_t off = ok ? (t0 + r) * row_stride + ch * E : 0;
      cp_async16(ks + r * D + ch * E, kb + off, ok);
      cp_async16(vs + r * D + ch * E, vb + off, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this lane's chunk of the GB queries (zeros past the last head)
  float qf[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gn) {
      const uint4 u = *reinterpret_cast<const uint4*>(q + (bh0 + g) * D + c * E);
      unpack16(u, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qf[g][e] = 0.f;
    }
  }
  float m[GB], l[GB], acc[GB][E];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();  // the warp's rows of tile t have landed
    const T* ks = ring + (t % kStages) * 2 * kKeys * D;
    const T* vs = ks + kKeys * D;
    const int t0 = start + t * kKeys;
#pragma unroll
    for (int i0 = 0; i0 < NS; i0 += NB) {
      // the warp's keys of this step: j = 16 warp + KPW i + grp
      if (t0 + kKeysPerWarp * warp + KPW * i0 >= end) break;  // warp-uniform
      float s[NB][GB];
#pragma unroll
      for (int ib = 0; ib < NB; ++ib) {
        const int j = kKeysPerWarp * warp + KPW * (i0 + ib) + grp;
        float kf[E];
        unpack16(*reinterpret_cast<const uint4*>(ks + j * D + c * E), kf);
        const bool ok = t0 + j < end;
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            d += __shfl_xor_sync(0xffffffffu, d, off);
          s[ib][g] = ok ? d * scale_log2 : -INFINITY;
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float mx = s[0][g];
#pragma unroll
        for (int ib = 1; ib < NB; ++ib) mx = fmaxf(mx, s[ib][g]);
        const float m_new = fmaxf(m[g], mx);
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[g] - m_safe);  // 0 for an empty history
        m[g] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int ib = 0; ib < NB; ++ib) {
          s[ib][g] = exp2f(s[ib][g] - m_safe);
          sum += s[ib][g];
        }
        l[g] = l[g] * alpha + sum;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int ib = 0; ib < NB; ++ib) {
        const int j = kKeysPerWarp * warp + KPW * (i0 + ib) + grp;
        float vf[E];
        unpack16(*reinterpret_cast<const uint4*>(vs + j * D + c * E), vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] = fmaf(s[ib][g], vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();  // stage t % kStages is free for tile t + kStages
  }
  cp_async_wait<0>();

  // merge the lane groups of the warp (lanes c, c + LPK, ...)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float ms = mm == -INFINITY ? 0.f : mm;
      const float a = exp2f(m[g] - ms);
      const float ao = exp2f(mo - ms);
      l[g] = l[g] * a + lo * ao;
      m[g] = mm;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + x * ao;
      }
    }
  }
  // then the warps, through the ring once every warp is done with it
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(smem_raw);  // [kWarps][GB][D]
  float* red_m = red_acc + kWarps * GB * D;             // [kWarps][GB]
  float* red_l = red_m + kWarps * GB;                   // [kWarps][GB]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        red_acc[(warp * GB + g) * D + c * E + e] = acc[g][e];
      if (c == 0) {
        red_m[warp * GB + g] = m[g];
        red_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gn * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * GB + g]);
    const float ms = mm == -INFINITY ? 0.f : mm;
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(red_m[w * GB + g] - ms);
      lsum += red_l[w * GB + g] * f;
      a += red_acc[(w * GB + g) * D + d] * f;
    }
    if (n_splits == 1) {
      out[(bh0 + g) * D + d] = from_f<T>(a / fmaxf(lsum, 1e-37f));
    } else {
      const size_t at = (bh0 + g) * n_splits + split;
      ws[at * D + d] = a;
      if (d == 0) {
        ws[n_bh * n_splits * D + at] = mm;
        ws[n_bh * n_splits * (D + 1) + at] = lsum;
      }
    }
  }
}

// Merge the splits of one (b, h) row: one thread per element of D, one
// pass with a running rescale, so every split's loads are independent.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ ws,
                                    T* __restrict__ out, int n_splits, int D) {
  // launched as a programmatic dependent of the split kernel: wait here
  // until its grid has finished and its writes are visible
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const size_t n_rows = static_cast<size_t>(gridDim.x) * n_splits;
  const float* acc = ws + bh * n_splits * D + d;
  const float* m = ws + n_rows * D + bh * n_splits;
  const float* l = ws + n_rows * (D + 1) + bh * n_splits;
  float mm = -INFINITY, lsum = 0.f, a = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_splits; ++i) {
    const float mi = m[i];
    const float li = l[i];
    const float ai = acc[static_cast<size_t>(i) * D];  // unset if mi = -inf
    const float mn = fmaxf(mm, mi);
    const float ms = mn == -INFINITY ? 0.f : mn;
    const float f_old = exp2f(mm - ms);
    const float f = exp2f(mi - ms);
    const bool empty = mi == -INFINITY;  // a split with no key: skipped
    lsum = lsum * f_old + (empty ? 0.f : li * f);
    a = a * f_old + (empty ? 0.f : ai * f);
    mm = mn;
  }
  out[bh * D + d] = from_f<T>(a / fmaxf(lsum, 1e-37f));
}

template <typename T, int D, int GB>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* out, void* ws, int B, int S,
                   int Hkv, int G, int n_splits, int kps, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(D, sizeof(T));
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D, GB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const int n_gb = (G + GB - 1) / GB;
  const dim3 grid(n_splits, Hkv * n_gb, B);
  decode_split_kernel<T, D, GB><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(lengths),
      static_cast<T*>(out), static_cast<float*>(ws), S, Hkv, G, n_gb, kps,
      n_splits, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  // the merge as a programmatic dependent launch: its launch overlaps
  // the split kernel's tail instead of following its completion (about
  // 1 us of a 13 us call on the H100, PERF.md)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * G);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_merge_kernel<T>,
                           static_cast<const float*>(ws), static_cast<T*>(out),
                           n_splits, D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_gb(const void* q, const void* k, const void* v,
                        const void* lengths, void* out, void* ws, int B, int S,
                        int Hkv, int G, int gb, int n_splits, int kps,
                        float scale, cudaStream_t s) {
  switch (gb) {
    case 1:
      return launch<T, D, 1>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                             n_splits, kps, scale, s);
    case 2:
      return launch<T, D, 2>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                             n_splits, kps, scale, s);
    case 4:
      return launch<T, D, 4>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                             n_splits, kps, scale, s);
    case 6:
      return launch<T, D, 6>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                             n_splits, kps, scale, s);
    case 8:
      return launch<T, D, 8>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                             n_splits, kps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* lengths, void* out, void* ws, int B, int S,
                       int Hkv, int G, int D, int gb, int n_splits, int kps,
                       float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return dispatch_gb<T, 32>(q, k, v, lengths, out, ws, B, S, Hkv, G, gb,
                                n_splits, kps, scale, s);
    case 64:
      return dispatch_gb<T, 64>(q, k, v, lengths, out, ws, B, S, Hkv, G, gb,
                                n_splits, kps, scale, s);
    case 128:
      return dispatch_gb<T, 128>(q, k, v, lengths, out, ws, B, S, Hkv, G, gb,
                                 n_splits, kps, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a block of the split kernel takes.
extern "C" int decode_attention_smem_bytes(int D, int dtype) {
  return static_cast<int>(smem_bytes(D, dtype == 0 ? 4 : 2));
}

// ws: fp32 workspace of B * Hkv * G * n_splits * (D + 2) floats (acc,
// then m, then l), unused when n_splits == 1.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* ws, int B, int S,
                                       int Hkv, int G, int D, int gb,
                                       int n_splits, int kps, float scale,
                                       int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B * Hkv * G == 0) return static_cast<int>(cudaGetLastError());
  if (n_splits < 1 || kps < kKeys || kps % kKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, lengths, out, ws, B, S, Hkv, G, D, gb,
                            n_splits, kps, scale, s);
  else if (dtype == 1)
    err = dispatch_d<__nv_bfloat16>(q, k, v, lengths, out, ws, B, S, Hkv, G,
                                    D, gb, n_splits, kps, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
