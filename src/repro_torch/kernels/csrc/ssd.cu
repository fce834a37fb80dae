// Mamba-2 SSD (state space dual) chunk scan with a scalar decay per
// head:
//   S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// over a whole sequence, starting from a given fp32 state and returning
// the final fp32 state, all math in fp32.  The D-skip (y += D x) stays
// outside, in ops.ssd, as in the reference.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:29-84 (_ssd_kernel
// under ssd_pallas, :87).  That kernel walks the chunks of one (b, h)
// row on a sequential grid axis with the [P, N] state in VMEM scratch;
// here one block owns a row and loops over its chunks, with its slice of
// the state in shared memory.
//
// Layouts: the model's.  x [B, T, H, P] (fp32 or bf16), dt [B, T, H]
// fp32, A [H] fp32, Bm/Cm [B, T, G, N] in x's type, s0 and s_out
// [B, H, P, N] fp32, y [B, T, H, P] in x's type.  x, Bm and Cm may be
// views into the Mamba block's conv output: each takes a batch stride
// and a token stride (in elements) and needs only its last two dims
// dense.  Head h reads B/C group h / (H / G), as the reference's
// jnp.repeat over heads (ops.py:244-245) assigns them, without that
// H/G-fold copy.  A ragged last chunk is processed as its valid tokens
// only, which is what the reference's zero padding computes (dt = 0: no
// decay and no input; a padded token adds exactly 0 to every sum).
//
// Design: grid (B*H, P/Pb) with Pb head channels per block: row p of
// the state and column p of y depend on x[:, p] only, so P splits over
// blocks with no communication.  Pb is the whole head where B*H blocks
// already give two per SM (a decode step: 16 sequences x 64 heads), else
// it halves down to 16 (a prefill of one sequence: 64 heads x 4 blocks).
// A block of 512 threads runs, per chunk of C <= 64 tokens (a sequence
// shorter than the chunk is one chunk of its own length):
//   1. load x[:, cols], dt, B, C into shared memory as fp32 (B and C
//      rows padded to N + 1 floats against bank conflicts);
//   2. lcum = cumsum(A dt) (one thread), and CB[t, s] = C_t . B_s over
//      the C (C + 1) / 2 pairs s <= t, dealt out to all threads;
//   3. G[t, s] = CB[t, s] exp(lcum_t - lcum_s) dt_s (every factor of the
//      decay is <= 1), and xdec[s, p] = exp(lcum_end - lcum_s) dt_s x_sp;
//   4. y = G x + exp(lcum) (C S^T), written out;
//   5. S <- exp(lcum_end) S + xdec^T B.
//
// Bound on the H100.  One zamba2-1.2b prefill layer (B = 1, T = 384,
// H = 64, P = N = 64, G = 1, C = 64, bf16 x/B/C, fp32 dt): about 8.5 MB
// moved with B/C read by group (x, y bf16, both states fp32), 2.5 us at
// 3.35 TB/s; the causal chunk's products, C (C + 1) (N + P) for C B^T
// and G x over the lower triangle with its diagonal plus 4 C N P for
// C S^T and the state update, per chunk and head over 384 chunk-heads,
// are 0.61 GFLOP, 9.1 us at the 67 TFLOP/s fp32 rate: operations.  This design computes
// CB once per channel block (four times per head) with scalar FMAs,
// every dot product in four independent partial sums.
// In decode (T = 1) the kernel reads and writes each slot's state once
// per layer: bytes.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher sets the kernel's dynamic shared-memory limit, launches
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError().

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

// Shared memory, in floats, for a chunk of C tokens, state width N and
// Pb channels: B, C and G [C][ldn] with ldn = max(N, C) + 1; x and xdec
// [C][Pb]; S [Pb][N+1]; dt and lcum [C].
__host__ __device__ inline int ld_rows(int C, int N) {
  return (N > C ? N : C) + 1;
}
__host__ __device__ inline size_t smem_floats(int C, int N, int Pb) {
  return static_cast<size_t>(3) * C * ld_rows(C, N) + 2 * C * Pb +
         Pb * (N + 1) + 2 * C;
}

struct Strides {
  long long xb, xt;  // x: batch, token (elements)
  long long bb, bt;  // Bm
  long long cb, ct;  // Cm
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ s_out, Strides st,
               int T_len, int H, int G, int P, int N, int C, int Pb) {
  extern __shared__ float smem[];
  const int ld = ld_rows(C, N);
  float* Bs = smem;                // [C][ld] B
  float* Cs = Bs + C * ld;         // [C][ld] C
  float* Gs = Cs + C * ld;         // [C][ld] CB, then G
  float* xs = Gs + C * ld;         // [C][Pb] x channels of this block
  float* xd = xs + C * Pb;         // [C][Pb] xdec
  float* S = xd + C * Pb;          // [Pb][N+1] state rows of this block
  float* dts = S + Pb * (N + 1);   // [C] dt
  float* lc = dts + C;             // [C] lcum

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * Pb;
  const int tid = threadIdx.x;
  const float a = A[h];
  const T* xb = x + b * st.xb + static_cast<long long>(h) * P + p0;
  const T* Bb = Bm + b * st.bb + static_cast<long long>(g) * N;
  const T* Cb = Cm + b * st.cb + static_cast<long long>(g) * N;
  const float* dtb = dt + static_cast<long long>(b) * T_len * H + h;
  T* yb = y + (static_cast<long long>(b) * T_len * H + h) * P + p0;
  const long long y_t = static_cast<long long>(H) * P;
  const float* s0_bh = s0 + static_cast<size_t>(bh) * P * N;
  const int ldS = N + 1;

  for (int e = tid; e < Pb * N; e += kThreads) {
    const int p = e / N, n = e % N;
    S[p * ldS + n] = s0_bh[(p0 + p) * N + n];
  }

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const int Cv = min(C, T_len - t0);
    const int npairs = Cv * (Cv + 1) / 2;
    // 1. load
    for (int e = tid; e < Cv * N; e += kThreads) {
      const int t = e / N, n = e % N;
      Bs[t * ld + n] = to_f(Bb[(t0 + t) * st.bt + n]);
      Cs[t * ld + n] = to_f(Cb[(t0 + t) * st.ct + n]);
    }
    for (int e = tid; e < Cv * Pb; e += kThreads) {
      const int t = e / Pb, p = e % Pb;
      xs[e] = to_f(xb[(t0 + t) * st.xt + p]);
    }
    for (int t = tid; t < Cv; t += kThreads)
      dts[t] = dtb[static_cast<long long>(t0 + t) * H];
    __syncthreads();
    // 2. lcum (one thread), CB over the lower triangle
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Cv; ++t) {
        acc += a * dts[t];
        lc[t] = acc;
      }
    }
    for (int e = tid; e < npairs; e += kThreads) {
      int t, s;
      tri_pair(e, t, s);
      Gs[t * ld + s] = dot(Cs + t * ld, 1, Bs + s * ld, 1, N);
    }
    __syncthreads();
    // 3. G = CB exp(lcum_t - lcum_s) dt_s; xdec
    const float lend = lc[Cv - 1];
    for (int e = tid; e < npairs; e += kThreads) {
      int t, s;
      tri_pair(e, t, s);
      Gs[t * ld + s] *= expf(lc[t] - lc[s]) * dts[s];
    }
    for (int e = tid; e < Cv * Pb; e += kThreads) {
      const int s = e / Pb;
      xd[e] = expf(lend - lc[s]) * dts[s] * xs[e];
    }
    __syncthreads();
    // 4. y = G x + exp(lcum) (C S^T)
    for (int e = tid; e < Cv * Pb; e += kThreads) {
      const int t = e / Pb, p = e % Pb;
      const float cs = dot(Cs + t * ld, 1, S + p * ldS, 1, N);
      const float gx = dot(Gs + t * ld, 1, xs + p, Pb, t + 1);
      const float acc = fmaf(expf(lc[t]), cs, gx);
      yb[(t0 + t) * y_t + p] = from_f<T>(acc);
    }
    __syncthreads();
    // 5. S <- exp(lcum_end) S + xdec^T B
    const float dend = expf(lend);
    for (int e = tid; e < Pb * N; e += kThreads) {
      const int p = e / N, n = e % N;
      const float xb_n = dot(xd + p, Pb, Bs + n, ld, Cv);
      S[p * ldS + n] = fmaf(dend, S[p * ldS + n], xb_n);
    }
    __syncthreads();
  }
  float* so = s_out + static_cast<size_t>(bh) * P * N;
  for (int e = tid; e < Pb * N; e += kThreads) {
    const int p = e / N, n = e % N;
    so[(p0 + p) * N + n] = S[p * ldS + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* s0, void* y, float* s_out,
           Strides st, int B, int T_len, int H, int G, int P, int N, int C,
           int device, cudaStream_t stream) {
  // Pb channels per block: the whole head when the grid already has two
  // blocks per SM (a decode step's 16 sequences), else halved down to 16
  // (a prefill's single sequence), so that every SM has work
  int sms = 132;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int Pb = P;
  while (Pb > 16 && Pb % 2 == 0 &&
         static_cast<long long>(B) * H * (P / Pb) < 2LL * sms)
    Pb /= 2;
  if (T_len > 0 && C > T_len) C = T_len;  // one ragged chunk: no more smem
  const size_t bytes = smem_floats(C, N, Pb) * sizeof(float);
  err = allow_dynamic_smem(ssd_kernel<T>, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, P / Pb);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), s_out, st, T_len, H,
      G, P, N, C, Pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* s0,
                          void* y, float* s_out, long long x_sb,
                          long long x_st, long long b_sb, long long b_st,
                          long long c_sb, long long c_st, int B, int T_len,
                          int H, int G, int P, int N, int C, int type_code,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  const Strides st{x_sb, x_st, b_sb, b_st, c_sb, c_st};
  auto s = static_cast<cudaStream_t>(stream);
  switch (type_code) {
    case 0:
      return launch<float>(x, dt, A, Bm, Cm, s0, y, s_out, st, B, T_len, H, G,
                           P, N, C, device, s);
    case 1:
      return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, s0, y, s_out, st, B,
                                   T_len, H, G, P, N, C, device, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
