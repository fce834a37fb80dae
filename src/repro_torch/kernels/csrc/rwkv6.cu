// Chunked WKV6 (RWKV6 "Finch") recurrence with a data-dependent
// per-channel decay:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
// over a whole prompt, starting from a given fp32 state and returning
// the final fp32 state, all math in fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py:29-90
// (_rwkv6_kernel under rwkv6_pallas, :93).  That kernel walks the chunks
// of one (b, h) row on a sequential grid axis and carries the [N, N]
// state in VMEM scratch from one grid step to the next; Hopper blocks
// run in no order, so one block owns a row and loops over its chunks,
// with its slice of the state in shared memory.
//
// Layouts: the model's.  r, k, v [B, T, H, N] (fp32 or bf16), w
// [B, T, H, N] fp32, u [H, N] fp32, s0 and s_out [B, H, N, N] fp32 (key
// dim, value dim), o [B, T, H, N] in r's type.  Reading the model layout
// where it lies saves the reference's pad, fold to [B*H, T, N] and
// unfold per call.  A ragged last chunk is processed as its valid
// tokens only, which is what the reference's padding (w = 1, r = k = v
// = 0) computes: a padded token adds exactly 0 to every sum and leaves
// the decay sums unchanged.
//
// Design: grid (B*H, N/Vb), Vb = min(N, 16) value columns per block:
// column j of the state and of the output depends on v[:, j] only, so
// the value dim splits over blocks with no communication, and B = 1
// gives 160 blocks for rwkv6-3b's 40 heads of 64 instead of 40.  A block
// of 512 threads runs, per chunk of C <= 64 tokens (a prompt shorter
// than the chunk is one chunk of its own length):
//   1. load r, k, v[:, cols] and log(max(w, 1e-30)) into shared memory
//      as fp32 (rows padded to N + 1 floats: threads on neighbouring
//      tokens hit different banks);
//   2. inclusive cumsum of the log decays per channel: la_t;
//   3. the intra-chunk matrix A[t, s] = sum_i r_ti k_si exp(la_{t-1,i} -
//      la_si) for s < t, the bonus sum_i r_ti u_i k_ti on the diagonal
//      (the C (C + 1) / 2 pairs of the lower triangle dealt out to the
//      threads, none to the zero upper half), and rdec = r * exp(la_{t-1});
//   4. o = A v + rdec S, written out; kdec = k * exp(la_end - la);
//   5. S <- diag(exp(la_end)) S + kdec^T v.
// The reference (and the TPU kernel) split the pairwise decay of step 3
// into r exp(la_{t-1}) times k exp(-la_s); with w clipped at exp(-e^4)
// (models/rwkv.py:130) exp(-la_s) reaches e^1747 over 32 tokens and
// overflows fp32.  Here the pairwise factor exp(la_{t-1} - la_s) <= 1 is
// taken whole: the same function, no overflow, at the price of C^2 N / 2
// exponentials per chunk instead of 2 C N.  Every other factor is at
// most 1 as written.
//
// Bound on the H100.  One rwkv6-3b prefill layer (B = 1, T = 384,
// H = 40, N = 64, C = 32, bf16 r/k/v, fp32 w): 13.1 MB moved (r, k, v, o
// bf16, w fp32, both states fp32), 3.9 us at 3.35 TB/s; the causal
// chunk's products, 2 C N (C + 1) for A and A v over the lower triangle
// with its diagonal plus 4 C N^2 for (r a) S and the state update, per
// chunk and head over 480 chunk-heads, are 0.32 GFLOP, 4.7 us at the
// 67 TFLOP/s fp32 rate: operations.  This design computes A once per value block (four times
// per head) with scalar FMAs, every dot product in four independent
// partial sums so that its shared-memory loads overlap; tensor cores
// are later work.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher sets the kernel's dynamic shared-memory limit, launches
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// Shared memory, in floats, for a chunk of C tokens, N channels and Vb
// value columns: r, k (later kdec), la and rdec [C][N+1]; A [C][C+1];
// v [C][Vb]; S [N][Vb]; u [N].
__host__ __device__ inline size_t smem_floats(int C, int N, int Vb) {
  return static_cast<size_t>(4) * C * (N + 1) + C * (C + 1) + C * Vb +
         N * Vb + N;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ o, float* __restrict__ s_out, int T_len,
                 int H, int N, int C, int Vb) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* rs = smem;              // [C][ld] r
  float* ks = rs + C * ld;       // [C][ld] k, then kdec
  float* la = ks + C * ld;       // [C][ld] log decay, then its cumsum
  float* rd = la + C * ld;       // [C][ld] rdec = r exp(la_{t-1})
  float* As = rd + C * ld;       // [C][C+1] intra-chunk matrix
  float* vs = As + C * (C + 1);  // [C][Vb] v columns of this block
  float* S = vs + C * Vb;        // [N][Vb] state columns of this block
  float* us = S + N * Vb;        // [N] bonus

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int col0 = blockIdx.y * Vb;
  const int tid = threadIdx.x;
  const size_t row_stride = static_cast<size_t>(H) * N;  // one token
  const size_t base = static_cast<size_t>(b) * T_len * row_stride +
                      static_cast<size_t>(h) * N;
  const float* s0_bh = s0 + static_cast<size_t>(bh) * N * N;

  for (int e = tid; e < N * Vb; e += kThreads) {
    const int i = e / Vb, j = e % Vb;
    S[e] = s0_bh[i * N + col0 + j];
  }
  for (int i = tid; i < N; i += kThreads) us[i] = u[h * N + i];

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int Cv = min(C, T_len - t0);  // valid tokens of this chunk
    // 1. load
    for (int e = tid; e < Cv * N; e += kThreads) {
      const int t = e / N, i = e % N;
      const size_t g = base + static_cast<size_t>(t0 + t) * row_stride + i;
      rs[t * ld + i] = to_f(r[g]);
      ks[t * ld + i] = to_f(k[g]);
      la[t * ld + i] = logf(fmaxf(w[g], 1e-30f));
    }
    for (int e = tid; e < Cv * Vb; e += kThreads) {
      const int t = e / Vb, j = e % Vb;
      const size_t g = base + static_cast<size_t>(t0 + t) * row_stride;
      vs[e] = to_f(v[g + col0 + j]);
    }
    __syncthreads();
    // 2. inclusive cumsum of the log decays, one channel per thread
    for (int i = tid; i < N; i += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < Cv; ++t) {
        acc += la[t * ld + i];
        la[t * ld + i] = acc;
      }
    }
    __syncthreads();
    // 3. A over the lower triangle only (the bonus u on the diagonal,
    //    the pairwise decay below it), and rdec
    for (int e = tid; e < Cv * (Cv + 1) / 2; e += kThreads) {
      int t, s;
      tri_pair(e, t, s);
      const float* rt = rs + t * ld;
      const float* kk = ks + s * ld;
      const float* lp = la + (t > 0 ? t - 1 : 0) * ld;  // la_{t-1}
      const float* lss = la + s * ld;
      const bool diag = s == t;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
      auto term = [&](int i) {
        return rt[i] * kk[i] * (diag ? us[i] : expf(lp[i] - lss[i]));
      };
      int i = 0;
      for (; i + 4 <= N; i += 4) {
        p0 += term(i);
        p1 += term(i + 1);
        p2 += term(i + 2);
        p3 += term(i + 3);
      }
      for (; i < N; ++i) p0 += term(i);
      As[t * (C + 1) + s] = (p0 + p1) + (p2 + p3);
    }
    for (int e = tid; e < Cv * N; e += kThreads) {
      const int t = e / N, i = e % N;
      const float lprev = t > 0 ? la[(t - 1) * ld + i] : 0.f;
      rd[t * ld + i] = rs[t * ld + i] * expf(lprev);
    }
    __syncthreads();
    // 4. o = A v + rdec S; kdec = k exp(la_end - la)
    const float* la_end = la + (Cv - 1) * ld;
    for (int e = tid; e < Cv * Vb; e += kThreads) {
      const int t = e / Vb, j = e % Vb;
      const float acc = dot(As + t * (C + 1), 1, vs + j, Vb, t + 1) +
                        dot(rd + t * ld, 1, S + j, Vb, N);
      o[base + static_cast<size_t>(t0 + t) * row_stride + col0 + j] =
          from_f<T>(acc);
    }
    for (int e = tid; e < Cv * N; e += kThreads) {
      const int t = e / N, i = e % N;
      ks[t * ld + i] *= expf(la_end[i] - la[t * ld + i]);
    }
    __syncthreads();
    // 5. S <- diag(exp(la_end)) S + kdec^T v
    for (int e = tid; e < N * Vb; e += kThreads) {
      const int i = e / Vb, j = e % Vb;
      S[e] = fmaf(expf(la_end[i]), S[e], dot(ks + i, ld, vs + j, Vb, Cv));
    }
    __syncthreads();
  }
  float* so = s_out + static_cast<size_t>(bh) * N * N;
  for (int e = tid; e < N * Vb; e += kThreads) {
    const int i = e / Vb, j = e % Vb;
    so[i * N + col0 + j] = S[e];
  }
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* o, float* s_out, int B,
           int T_len, int H, int N, int C, cudaStream_t stream) {
  const int Vb = N < 16 ? N : 16;
  if (T_len > 0 && C > T_len) C = T_len;  // one ragged chunk: no more smem
  const size_t bytes = smem_floats(C, N, Vb) * sizeof(float);
  cudaError_t err = allow_dynamic_smem(rwkv6_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, N / Vb);
  rwkv6_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(o), s_out, T_len, H,
      N, C, Vb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const float* w, const float* u, const float* s0,
                            void* o, float* s_out, int B, int T_len, int H,
                            int N, int C, int type_code, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return launch<float>(r, k, v, w, u, s0, o, s_out, B, T_len, H, N, C, s);
    case 1:
      return launch<__nv_bfloat16>(r, k, v, w, u, s0, o, s_out, B, T_len, H,
                                   N, C, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
