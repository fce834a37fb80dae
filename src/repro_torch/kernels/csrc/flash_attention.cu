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
// and back.  Masked: keys at or past Sk, and with `causal` keys past
// qpos + q_offset.  The output is acc / max(l, 1e-37), so a row with no
// admissible key gives 0, as the TPU kernel's does.  D is a template
// parameter (32, 64, 128).
//
// Two instantiations, chosen by the storage type (a dispatch on dtype,
// not a fallback):
//
// * bf16 (the serving paths): tensor cores.  One block of four warps
//   per (b, h, tile of 32 queries): two row groups of 16 queries, and
//   the two warps of a row group take one half (32 keys) of every
//   64-key tile each, so a warp's chain of dependent work per tile is
//   half as long; they merge their (m, l, acc) through shared memory at
//   the end.  At qwen2-1.5b's 384-token prompt that is 144 blocks for
//   the 132 SMs (zamba2-1.2b's: 384); on the card, one or four row
//   groups, and four warps per row group, measured slower at the served
//   prompts (PERF.md).
//   The grid's slow axis walks the query tiles backwards, so the causal
//   tiles with the most keys start first.  Each warp keeps its 16
//   query rows in registers as mma A fragments for the whole key loop.
//   K/V tiles stay bf16 in shared memory, in a two-stage ring filled
//   with 16-byte cp.async (tile j + 1 lands while tile j is computed);
//   rows are padded by 16 bytes so that ldmatrix reads them without
//   bank conflicts.  S = Q K^T and O += P V run as mma.sync.m16n8k16
//   bf16 -> fp32, K fed by ldmatrix, V (stored [keys, D]) by
//   ldmatrix.trans.  The scores are scaled by scale * log2(e) in fp32
//   and exponentiated with exp2f, so Q stays exactly as stored; P is
//   rounded to bf16 in registers and reused directly as the A operand
//   of P V (the TPU kernel's fp32 dot_general at default precision also
//   rounds its operands to bf16).  Causal: keys wholly below the
//   diagonal run unmasked, a warp skips the keys past its last row's
//   admissible key, and only the diagonal and the keys' end apply a
//   mask.  Rows past Sq are computed but not stored.  The output is
//   acc times the reciprocal of max(l, 1e-37): 64 IEEE divisions a
//   thread cost about 2 us a launch.
//
// * fp32 (the parity checks): TF32 tensor cores keep about three
//   decimal digits and cannot hold the 2e-5 the fp32 comparisons ask,
//   so fp32 keeps the scalar design: one block of 256 threads per (b,
//   h, 64 queries), four threads per query row in float4 chunks, 64-key
//   fp32 K/V tiles in shared memory, fp32 FMAs.
//
// Bound on the H100.  For qwen2-1.5b's prefill (B = 1, Sq = Sk = 384,
// H = 12, Hkv = 2, D = 128, causal, bf16) the scores and the weighted
// sum take 4 D operations per admissible (query, key) pair: 0.45 GFLOP,
// 0.46 us at the bf16 tensor-core peak (989 TFLOP/s); q, k, v and out
// are 2.75 MB, 0.82 us at 3.35 TB/s, so at this shape the bound is
// bytes.  What keeps the bf16 design above it is latency: a warp walks
// up to Sk / 64 tiles in order, each an mma chain, a softmax and a
// second mma chain that depend on one another.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher returns cudaGetLastError() and does not synchronise.

#include "common.cuh"
#include <stdint.h>

namespace {

// ---------------------------------------------------------------- fp32

constexpr int kRows = 64;     // queries per block
constexpr int kTileK = 64;    // keys per shared-memory tile
constexpr int kSplit = 4;     // threads per query row
constexpr int kThreads = kRows * kSplit;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_scalar_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
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
    const float* qrow = q + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 16 * c + 4 * part;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q_valid) {
        x.x = qrow[d] * scale;
        x.y = qrow[d + 1] * scale;
        x.z = qrow[d + 2] * scale;
        x.w = qrow[d + 3] * scale;
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
  const float* kb = k + static_cast<size_t>(b) * Sk * row_stride + kvh * D;
  const float* vb = v + static_cast<size_t>(b) * Sk * row_stride + kvh * D;

  for (int k0 = 0; k0 < kend; k0 += kTileK) {
    const int nk = min(kTileK, kend - k0);
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kTileK * D; i += kThreads) {
      const int j = i / D;
      const int d = i - j * D;
      float kx = 0.f, vx = 0.f;
      if (j < nk) {
        const size_t src = static_cast<size_t>(k0 + j) * row_stride + d;
        kx = kb[src];
        vx = vb[src];
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
    float* orow = out + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int d = 16 * c + 4 * part;
      orow[d] = acc[c].x / den;
      orow[d + 1] = acc[c].y / den;
      orow[d + 2] = acc[c].z / den;
      orow[d + 3] = acc[c].w / den;
    }
  }
}

template <int D>
cudaError_t launch_scalar(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int Hkv,
                          int q_offset, int causal, float scale,
                          cudaStream_t stream) {
  const size_t bytes = 2 * kTileK * D * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_scalar_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_scalar_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, Hkv,
      q_offset, causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16

constexpr int kRowGroups = 2;  // 16 query rows each
constexpr int kKeySplit = 2;   // warps per row group, each a part of the keys
constexpr int kMmaRows = 16 * kRowGroups;  // queries per block
constexpr int kMmaThreads = 32 * kRowGroups * kKeySplit;
constexpr int kKeys = 64;  // keys per shared-memory tile
constexpr int kPad = 8;           // bf16 elements (16 bytes) of row padding
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 kernel: the Q tile and a two-stage K/V
// ring; the merge of the two key halves reuses it after the key loop.
constexpr size_t mma_smem_bytes(int D) {
  return static_cast<size_t>(kMmaRows + 2 * 2 * kKeys) * (D + kPad) *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int Sq, int Sk, int H, int Hkv, int q_offset, int causal,
                     float scale_log2) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + kPad;  // shared row stride, elements
  constexpr int KD = D / 16;    // k-steps of Q K^T
  constexpr int ND = D / 8;     // n-tiles of O
  constexpr int CH = D / 8;     // 16-byte chunks per row
  constexpr int kSub = kKeys / kKeySplit;  // keys of a tile one warp takes
  constexpr int NS = kSub / 8;      // n-tiles of a warp's S
  constexpr int rows = kMmaRows;
  constexpr int nthr = kMmaThreads;
  extern __shared__ uint4 smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [rows][LD]
  bf16* ring = q_s + rows * LD;  // [2 stages][K, V][kKeys][LD]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / Hkv);
  // the heaviest causal tiles (the last queries) first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * rows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = warp % kRowGroups;  // this warp's 16 query rows
  const int kh = warp / kRowGroups;  // and its part of every key tile

  const int qlast = min(q0 + rows, Sq) - 1;
  const int kend = causal ? min(Sk, qlast + q_offset + 1) : Sk;
  const int ntiles = (kend + kKeys - 1) / kKeys;

  const size_t q_stride = static_cast<size_t>(H) * D;  // one query row
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;  // one key row
  const bf16* qb = q + static_cast<size_t>(b) * Sq * q_stride +
                   static_cast<size_t>(h) * D;
  const bf16* kb = k + static_cast<size_t>(b) * Sk * kv_stride +
                   static_cast<size_t>(kvh) * D;
  const bf16* vb = v + static_cast<size_t>(b) * Sk * kv_stride +
                   static_cast<size_t>(kvh) * D;

  // the Q tile (zeros past Sq) and the first K/V tile: copy group 0
  for (int i = tid; i < rows * CH; i += nthr) {
    const int r = i / CH;
    const int c = i - r * CH;
    const bool ok = q0 + r < Sq;
    const bf16* src = qb + (ok ? (q0 + r) * q_stride + c * 8 : 0);
    cp_async16(q_s + r * LD + c * 8, src, ok);
  }
  // K/V tile t into ring stage st; zeros for keys at or past Sk, so a
  // masked key contributes 0 * 0 and no byte past the keys is read
  auto load_kv = [&](int t, int st) {
    bf16* ks = ring + st * 2 * kKeys * LD;
    bf16* vs = ks + kKeys * LD;
    const int k0 = t * kKeys;
    for (int i = tid; i < kKeys * CH; i += nthr) {
      const int r = i / CH;
      const int c = i - r * CH;
      const bool ok = k0 + r < Sk;
      const size_t off = ok ? (k0 + r) * kv_stride + c * 8 : 0;
      cp_async16(ks + r * LD + c * 8, kb + off, ok);
      cp_async16(vs + r * LD + c * 8, vb + off, ok);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int qw0 = q0 + 16 * rg;  // this warp's first query
  const bool live = qw0 < Sq;
  const int qw_last = min(qw0 + 15, Sq - 1);
  const int gr = lane >> 2;  // fragment row (and row + 8)
  const int tg = lane & 3;   // fragment column pair
  // the last admissible key of this thread's two rows
  const int r0 = qw0 + gr;
  const int lim0 = causal ? min(r0 + q_offset, Sk - 1) : Sk - 1;
  const int lim1 = causal ? min(r0 + 8 + q_offset, Sk - 1) : Sk - 1;

  uint32_t qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
  float l0 = 0.f, l1 = 0.f;  // this thread's part of the row sums

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile t (and Q) have landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldsm_x4(qf[kd], q_s + (16 * rg + (lane & 15)) * LD + kd * 16 +
                            (lane >> 4) * 8);
    }
    const int k0 = t * kKeys + kSub * kh;  // this warp's first key
    if (live && (!causal || k0 <= qw_last + q_offset)) {
      const bf16* ks = ring + (t & 1) * 2 * kKeys * LD + kSub * kh * LD;
      const bf16* vs = ks + kKeys * LD;
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // S = Q K^T: B fragments of keys 16 np .. + 15, dims 16 kd .. + 15
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t kf[4];
          ldsm_x4(kf, ks + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD +
                          kd * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * np], qf[kd], kf[0], kf[1]);
          mma_bf16(s[2 * np + 1], qf[kd], kf[2], kf[3]);
        }
      }
      // scale to log2 units; mask only on the diagonal and where the
      // keys end (a warp-uniform test)
      const bool masked = k0 + kSub > Sk ||
                          (causal && k0 + kSub - 1 > qw0 + q_offset);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (masked) {
            const int kp = k0 + 8 * n + 2 * tg + (e & 1);
            if (kp > (e < 2 ? lim0 : lim1)) x = -INFINITY;
          }
          s[n][e] = x;
        }
      }
      // online softmax over the warp's keys: rows gr and gr + 8, each
      // spread over the four threads of a quad
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // a row with no admissible key yet keeps m = -inf: exponentiate
      // against 0 instead, so every p and alpha is exactly 0, not NaN
      const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
      const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
      const float a0 = exp2f(m0 - ms0);  // 0 for an empty history
      const float a1 = exp2f(m1 - ms1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = exp2f(s[n][0] - ms0);
        s[n][1] = exp2f(s[n][1] - ms0);
        s[n][2] = exp2f(s[n][2] - ms1);
        s[n][3] = exp2f(s[n][3] - ms1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * a0 + sum0;
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= a0;
        o[n][1] *= a0;
        o[n][2] *= a1;
        o[n][3] *= a1;
      }
      // O += P V: P's accumulators are, pairwise, the A fragments of the
      // k-step over keys 16 kk .. + 15; V fragments by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t vf[4];
          ldsm_x4_t(vf, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD +
                            dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }
  cp_async_wait<0>();
  __syncthreads();  // no copy still lands where the merge writes

  // merge the other key parts into the first through the idle ring:
  // [row group][part][value][lane], the warps' fragments line up lane
  // by lane, and the rescale is linear in each thread's partial row sums
  constexpr int NV = 4 * ND + 4;  // o, then m0, m1, l0, l1
  float* xs =
      reinterpret_cast<float*>(smem_raw) + rg * (kKeySplit - 1) * NV * 32 + lane;
  if (kh > 0) {
    float* x = xs + (kh - 1) * NV * 32;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32] = o[n][e];
    x[(4 * ND) * 32] = m0;
    x[(4 * ND + 1) * 32] = m1;
    x[(4 * ND + 2) * 32] = l0;
    x[(4 * ND + 3) * 32] = l1;
  }
  __syncthreads();
  if (kh > 0 || !live) return;
#pragma unroll
  for (int part = 0; part < kKeySplit - 1; ++part) {
    const float* x = xs + part * NV * 32;
    const float mo0 = x[(4 * ND) * 32], mo1 = x[(4 * ND + 1) * 32];
    const float mn0 = fmaxf(m0, mo0), mn1 = fmaxf(m1, mo1);
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0;
    const float ms1 = mn1 == -INFINITY ? 0.f : mn1;
    const float a0 = exp2f(m0 - ms0), b0 = exp2f(mo0 - ms0);
    const float a1 = exp2f(m1 - ms1), b1 = exp2f(mo1 - ms1);
    l0 = l0 * a0 + x[(4 * ND + 2) * 32] * b0;
    l1 = l1 * a1 + x[(4 * ND + 3) * 32] * b1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] = o[n][0] * a0 + x[(4 * n) * 32] * b0;
      o[n][1] = o[n][1] * a0 + x[(4 * n + 1) * 32] * b0;
      o[n][2] = o[n][2] * a1 + x[(4 * n + 2) * 32] * b1;
      o[n][3] = o[n][3] * a1 + x[(4 * n + 3) * 32] * b1;
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-37f);
  const float inv1 = 1.f / fmaxf(l1, 1e-37f);
  bf16* o0 = out + (static_cast<size_t>(b) * Sq + r0) * q_stride +
             static_cast<size_t>(h) * D + 2 * tg;
  bf16* o1 = o0 + 8 * q_stride;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + 8 * n) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + 8 * n) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int Hkv, int q_offset,
                       int causal, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes(D);
  static_assert(kRowGroups * (kKeySplit - 1) * (4 * (D / 8) + 4) * 32 *
                        sizeof(float) <= bytes,
                "the merge must fit in the ring");
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * H, (Sq + kMmaRows - 1) / kMmaRows);
  flash_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk, H, Hkv,
      q_offset, causal, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int Sq, int Sk, int H, int Hkv, int D,
                     int q_offset, int causal, float scale, int dtype,
                     cudaStream_t s) {
#define FLASH_CASE(DD)                                                      \
  case DD:                                                                  \
    return dtype == 0 ? launch_scalar<DD>(q, k, v, out, B, Sq, Sk, H, Hkv,  \
                                          q_offset, causal, scale, s)       \
                      : launch_mma<DD>(q, k, v, out, B, Sq, Sk, H, Hkv,     \
                                       q_offset, causal, scale, s);
  switch (D) {
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
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
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  err = dispatch(q, k, v, out, B, Sq, Sk, H, Hkv, D, q_offset, causal, scale,
                 dtype, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}
