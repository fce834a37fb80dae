// Chunked WKV6 (RWKV6 "Finch") recurrence with a data-dependent
// per-channel decay:
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//   o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
// over a whole prompt, starting from a given fp32 state and returning
// the final fp32 state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6.py:29-90
// (_rwkv6_kernel under rwkv6_pallas, :93).  That kernel walks the chunks
// of one (b, h) row on a sequential grid axis and carries the [N, N]
// state in VMEM scratch.  A serial chunk walk in B * H blocks leaves
// Hopper latency-bound, so the scan runs in three kernels of one call:
//
//   1. chunk-local pass, grid (chunk, head, batch), 128 threads: the
//      inclusive cumulative log2 decay la_t of the chunk per channel,
//      its decay exp2(la_end) ([N]), and the chunk's own state
//      dS_c = sum_s (k_s * exp2(la_end - la_s))^T v_s ([N, N]), written
//      to an fp32 workspace [B, H, nc, N, N];
//   2. state passing (wkv_pass_kernel, state_pass in common.cuh),
//      grid (B * H, N N / 1024), four state elements a thread:
//      S_c = diag(exp2(la_end_c)) S_{c-1} + dS_c over the chunks in
//      order; each chunk's incoming state goes to a second workspace
//      (fp32, or for bf16 its high and low bf16 parts), the last state
//      to s_out, fp32;
//   3. output pass, grid (chunk, head, batch):
//      o = A v + (r * exp2(la_{t-1})) S_{c-1}, with the intra-chunk
//      matrix A built once per (b, h, chunk) for all N value columns
//      (the first design built it once per 16-column slice, four times
//      per head).
//
// Passes 2 and 3 are programmatic dependents of the pass before them
// (launch_pdl), every kernel attribute set before the first launch and
// all three asking for the same shared-memory carveout: pass 3 builds A
// before it waits and waits only before it reads the incoming state.
// (On the H100 a dependent of a dependent starts only once the first
// kernel has ended, so pass 3 overlaps pass 2, not pass 1.)  The
// wrapper allocates the workspaces per call (torch.empty) and counts one
// launch per call.
//
// Every exponential has an argument <= 0, since la does not increase
// along a chunk; with w at its clip exp(-e^4) (models/rwkv.py:130) a
// factor underflows to 0, which is the right fp32 answer.  The
// reference's split of the pairwise decay into exp(la_{t-1}) times
// exp(-la_s) (ref.py, the TPU kernel at rwkv6.py:55-56) overflows fp32
// there and is never taken.
//
// Two routes on dtype, a dispatch and not a fallback:
// * bf16 (the serving path): the products on the tensor cores,
//   mma.sync.m16n8k16 bf16 -> fp32.  The chunk is cut into four
//   sub-chunks of 16 tokens, two warps each in pass 3.  For rows t of
//   sub-chunk J and every earlier token s < 16 J, A[t, s] factors
//   through the reference token ref = 16 J - 1 (the last one before
//   the sub-chunk):
//     A[t, s] = sum_n (r_tn exp2(la_{t-1,n} - la_{ref,n}))
//                   (k_sn exp2(la_{ref,n} - la_{s,n})),
//   both factors <= |r|, |k| (t - 1 >= ref >= s), so this part of A is
//   one bf16 product, its fragments built in registers (one warp of
//   the pair).  The other warp builds the diagonal 16 x 16 block the
//   same way one level down (rows 8-15 x columns 0-7 through token 7 of
//   the sub-chunk, rows 4-7 x columns 0-3 through token 3, rows 12-15 x
//   columns 8-11 through token 11) and keeps the pairwise factor whole
//   only on its four 4 x 4 diagonal blocks, as scalar fp32 sums over
//   their 40 pairs s <= t (the bonus r . u . k on the diagonal).  The
//   two meet in A in fp32 in shared memory; each then computes half of
//   o's columns.  A v, (r exp2(la_{t-1})) S and the chunk state kdec^T
//   v of pass 1 are bf16 products too.  Rounded to bf16 are only values
//   bounded by the inputs: the decayed r and k factors; A and the
//   incoming state enter their products as high and low bf16 parts
//   (two products each, about 16 bits), which holds o to the bf16
//   tolerance where one bf16 rounding of A did not at rwkv6-3b's
//   shape; the state is carried in fp32.
// * fp32 (the parity checks): TF32 cannot hold their 2e-4, so the same
//   three passes run scalar fp32 FMAs, A over its pairs whole.
//
// Layouts: the model's.  r, k, v [B, T, H, N] (fp32 or bf16), w
// [B, T, H, N] fp32, u [H, N] fp32, s0 and s_out [B, H, N, N] fp32 (key
// dim, value dim), o [B, T, H, N] in r's type.  The kernels tile the
// prompt in chunks of 64 tokens whatever `chunk` the caller passes (the
// function does not depend on it beyond rounding).  A ragged last chunk
// is loaded as its valid tokens with r = k = v = 0 and log w = 0 past
// them, which is what the reference's padding (w = 1, r = k = v = 0)
// computes.
//
// Bound on the H100.  One rwkv6-3b prefill layer (B = 1, T = 384,
// H = 40, N = 64, bf16 r/k/v, fp32 w): r, k, v, o 7.9 MB, w 3.9 MB,
// both states 1.3 MB: 13,117,440 bytes, 3.916 us at 3.35 TB/s; its
// 0.32 GFLOP of causal products (counted over chunks of 32) take 4.72 us
// at the 67 TFLOP/s fp32 scalar rate and 0.32 us at the 989 TFLOP/s
// bf16 tensor rate, so on the bf16 route the bound is bytes.  The
// workspaces add 3.9 MB of fp32 chunk states (written by pass 1, read
// by pass 2) and 3.9 MB of incoming states as bf16 high and low parts
// (written by pass 2, read by pass 3), mostly served from the 50 MB L2;
// k, v and w are read by both passes 1 and 3 (5.9 MB more).  What
// keeps the chain above the bound is latency: pass 3 starts only as
// pass 2 ends, then loads its tiles, builds A and multiplies.
//
// Plain C interface (bound with ctypes): type code 0 = fp32, 1 = bf16.
// The launcher sets each kernel's dynamic shared-memory limit to the
// device's opt-in maximum (the same value on every call), launches on
// the caller's stream, does not synchronise, and returns the first
// error of any launch.

#include "common.cuh"
#include <stdint.h>

namespace {

constexpr int kC = 64;             // tokens per chunk tile
constexpr int kThreads = 128;      // passes 1 and 3: four warps x 16 rows
constexpr int kOutThreads = 256;   // pass 3, bf16: two warps a sub-chunk
constexpr int kPassThreads = 256;  // pass 2
constexpr int kPadH = 8;           // bf16 row padding (16 bytes)
constexpr int kDiag = 4 * 10;  // pairs s <= t of four 4 x 4 blocks

struct Dims {
  int T, H, N, nc;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

// la[t][i] = sum_{t' <= t} log2(max(w[t'][i], 1e-30)) over the chunk's
// valid tokens and channels, 0 past them (w = 1: no decay); cols = the
// tile's width.  The rows of w come by 16-byte cp.async where `vec`, so
// that their loads overlap; then thread (channel i, segment sg) takes a
// segment of kC / seg tokens into registers, logs and scans it there,
// and adds the totals of the segments before it (off: 4 * cols floats
// of scratch).  Ends with the block synchronised.
__device__ __forceinline__ void logw_cumsum(float* la, int ld, const float* w,
                            long long row_stride, int valid, int N, int cols,
                            bool vec, float* off, int tid, int nthr) {
  load_tile(la, ld, w, row_stride, kC, N, valid, vec, tid, nthr);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int seg = min(4, nthr / cols);  // 2 or 4: divides kC
  const int len = kC / seg;                 // 32 or 16
  const int i = tid % cols, sg = tid / cols;
  const bool live = sg < seg;
  float v[kC / 2];
  float acc = 0.f;
  if (live) {
#pragma unroll
    for (int j = 0; j < kC / 2; ++j) {
      if (j < len) v[j] = la[(sg * len + j) * ld + i];
    }
#pragma unroll
    for (int j = 0; j < kC / 2; ++j) {
      if (j >= len) break;
      const int t = sg * len + j;
      acc += t < valid && i < N ? log2f(fmaxf(v[j], 1e-30f)) : 0.f;
      v[j] = acc;
    }
    off[sg * cols + i] = acc;
  }
  __syncthreads();
  if (live) {
    float pre = 0.f;
    for (int q = 0; q < sg; ++q) pre += off[q * cols + i];
#pragma unroll
    for (int j = 0; j < kC / 2; ++j) {
      if (j < len) la[(sg * len + j) * ld + i] = v[j] + pre;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- bf16

__host__ __device__ inline size_t state_mma_bytes(int N) {
  const int Np = round16(N);
  return static_cast<size_t>(2) * kC * (Np + kPadH) * 2 +
         sizeof(float) * (static_cast<size_t>(kC) * (Np + 4) + 4 * Np);
}

// Pass 1: dS = kdec^T v, kdec[s, i] = k[s, i] exp2(la_end,i - la_s,i).
// Warp w owns state rows (key channels) i in [16 w, 16 w + 16); kdec^T's
// A fragments are built in registers, v's B fragments come by
// ldmatrix.trans from v stored [token][value].
__global__ void __launch_bounds__(kThreads)
    wkv_state_mma_kernel(const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ w, Dims d, bool vec,
                         bool vec_w, bool pad, float* __restrict__ delta,
                         float* __restrict__ dec) {
  extern __shared__ uint4 smem_raw[];
  const int Np = round16(d.N);
  const int LDN = Np + kPadH, LDL = Np + 4;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kC][LDN]
  bf16* vs = ks + kC * LDN;                      // [kC][LDN]
  float* la = reinterpret_cast<float*>(vs + kC * LDN);  // [kC][LDL]
  float* off = la + kC * LDL;                           // [4][Np]
  grid_dep_launch();
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  const long long rs = static_cast<long long>(d.H) * d.N;  // one token
  const long long at = (static_cast<long long>(b) * d.T + t0) * rs +
                       static_cast<long long>(h) * d.N;
  if (pad) {
    zero_smem(smem_raw, kC * LDN, tid, kThreads);
    __syncthreads();
  }
  load_tile(ks, LDN, k + at, rs, kC, d.N, valid, vec, tid, kThreads);
  load_tile(vs, LDN, v + at, rs, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  logw_cumsum(la, LDL, w + at, rs, valid, d.N, Np, vec_w, off, tid,
              kThreads);
  const float* lend = la + (kC - 1) * LDL;
  const size_t row = static_cast<size_t>(b) * d.H + h;
  for (int i = tid; i < d.N; i += kThreads)
    dec[(row * d.nc + c) * d.N + i] = exp2f(lend[i]);
  cp_async_wait<0>();
  __syncthreads();

  const int i0 = 16 * warp;
  if (i0 >= Np) return;
  const int gr = lane >> 2, tg = lane & 3;
  const int ia = i0 + gr, ib = ia + 8;
  const float ea = lend[ia], eb = lend[ib];
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    const int s0 = 16 * kk + 2 * tg;
    auto kd = [&](int s, int i, float e) {
      return __bfloat162float(ks[s * LDN + i]) * exp2f(e - la[s * LDL + i]);
    };
    uint32_t a[4];
    a[0] = pack_bf16(kd(s0, ia, ea), kd(s0 + 1, ia, ea));
    a[1] = pack_bf16(kd(s0, ib, eb), kd(s0 + 1, ib, eb));
    a[2] = pack_bf16(kd(s0 + 8, ia, ea), kd(s0 + 9, ia, ea));
    a[3] = pack_bf16(kd(s0 + 8, ib, eb), kd(s0 + 9, ib, eb));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (16 * jp >= Np) continue;
      uint32_t bf[4];
      ldsm_x4_t(bf, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                        16 * jp + (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
    }
  }
  float* out = delta + (row * d.nc + c) * static_cast<size_t>(d.N) * d.N;
  const bool pairs = d.N % 2 == 0;  // 8-byte stores: rows of even width
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = 8 * j + 2 * tg;
    if (n >= d.N) continue;
    const bool two = n + 1 < d.N;
    if (ia < d.N) {
      if (pairs) {
        *reinterpret_cast<float2*>(out + ia * d.N + n) =
            make_float2(acc[j][0], acc[j][1]);
      } else {
        out[ia * d.N + n] = acc[j][0];
        if (two) out[ia * d.N + n + 1] = acc[j][1];
      }
    }
    if (ib < d.N) {
      if (pairs) {
        *reinterpret_cast<float2*>(out + ib * d.N + n) =
            make_float2(acc[j][2], acc[j][3]);
      } else {
        out[ib * d.N + n] = acc[j][2];
        if (two) out[ib * d.N + n + 1] = acc[j][3];
      }
    }
  }
}

// Shared memory of pass 3 (bf16): r, k, v [kC][LDN]; the incoming
// state's high and low bf16 parts [2][Np][LDN]; la [kC][LDL]; A in fp32
// [kC][kC + 8]; u [Np]; the scan's scratch [4][Np]; four diagonal
// blocks [16][17].
__host__ __device__ inline size_t out_mma_bytes(int N) {
  const int Np = round16(N);
  return static_cast<size_t>(3 * kC + 2 * Np) * (Np + kPadH) * 2 +
         sizeof(float) * (static_cast<size_t>(kC) * (Np + 4) +
                          kC * (kC + 8) + 5 * Np + 4 * 16 * 17);
}

// Pass 3 (bf16): two warps per 16-token sub-chunk J.  Warp (J, 0) builds
// A over the earlier sub-chunks, warp (J, 1) the diagonal 16 x 16 block;
// they meet in A (fp32, shared memory), and each then computes half of
// the value columns of o = A v + (r exp2(la_{t-1})) S_{c-1}.
__global__ void __launch_bounds__(kOutThreads)
    wkv_out_mma_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const float* __restrict__ w,
                       const float* __restrict__ u,
                       const bf16* __restrict__ s_in, bf16* __restrict__ o,
                       Dims d, bool vec, bool vec_w, bool pad) {
  extern __shared__ uint4 smem_raw[];
  const int Np = round16(d.N);
  const int LDN = Np + kPadH, LDL = Np + 4, LDA = kC + 8;
  bf16* rs_ = reinterpret_cast<bf16*>(smem_raw);  // [kC][LDN]
  bf16* ks = rs_ + kC * LDN;                      // [kC][LDN]
  bf16* vs = ks + kC * LDN;                       // [kC][LDN]
  bf16* ss = vs + kC * LDN;                       // [2][Np][LDN]
  float* la = reinterpret_cast<float*>(ss + 2 * Np * LDN);  // [kC][LDL]
  float* As = la + kC * LDL;                                // [kC][LDA]
  float* us = As + kC * LDA;                                // [Np]
  float* off = us + Np;                                     // [4][Np]
  float* ad = off + 4 * Np;                                 // [4][16][17]
  constexpr int nthr = kOutThreads;
  const int c = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int J = (tid >> 5) & 3;  // this warp's sub-chunk: rows 16 J + 0..15
  const int half = tid >> 7;     // its part: A's, then o's columns
  const int gr = lane >> 2, tg = lane & 3;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  const long long rstr = static_cast<long long>(d.H) * d.N;  // one token
  const long long at = (static_cast<long long>(b) * d.T + t0) * rstr +
                       static_cast<long long>(hd) * d.N;
  if (pad) zero_smem(smem_raw, (3 * kC + 2 * Np) * LDN / 2, tid, nthr);
  zero_smem(ad, 4 * 16 * 17, tid, nthr);  // the upper halves stay 0
  __syncthreads();
  load_tile(rs_, LDN, r + at, rstr, kC, d.N, valid, vec, tid, nthr);
  load_tile(ks, LDN, k + at, rstr, kC, d.N, valid, vec, tid, nthr);
  load_tile(vs, LDN, v + at, rstr, kC, d.N, valid, vec, tid, nthr);
  cp_async_commit();
  for (int i = tid; i < Np; i += nthr)
    us[i] = i < d.N ? u[static_cast<size_t>(hd) * d.N + i] : 0.f;
  logw_cumsum(la, LDL, w + at, rstr, valid, d.N, Np, vec_w, off, tid, nthr);

  const int sb = 16 * J;  // the sub-chunk's first token
  const int ta = sb + gr, tb = ta + 8;
  auto rv2 = [&](int t, int i) {  // channels i, i + 1
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(rs_ + t * LDN + i));
  };
  auto kv2 = [&](int s, int i) {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(ks + s * LDN + i));
  };
  auto la2 = [&](int t, int i) {
    return *reinterpret_cast<const float2*>(la + t * LDL + i);
  };
  // x * exp2(l1 - l2), elementwise on pairs, packed to bf16
  auto fac2 = [](float2 x, float2 l1, float2 l2) {
    return pack_bf16(x.x * exp2f(l1.x - l2.x), x.y * exp2f(l1.y - l2.y));
  };
  if (half == 0) {
    // A over the earlier sub-chunks, through ref = 16 J - 1: rfac are the
    // A fragments, kfac the B fragments, built in registers
    if (J > 0) {
      float accA[6][4];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        accA[j][0] = accA[j][1] = accA[j][2] = accA[j][3] = 0.f;
      const int ref = sb - 1;
#pragma unroll
      for (int kd = 0; kd < 4; ++kd) {
        if (16 * kd >= Np) continue;
        const int i0 = 16 * kd + 2 * tg;
        const float2 r0 = la2(ref, i0), r8 = la2(ref, i0 + 8);
        uint32_t a[4];
        a[0] = fac2(rv2(ta, i0), la2(ta - 1, i0), r0);
        a[1] = fac2(rv2(tb, i0), la2(tb - 1, i0), r0);
        a[2] = fac2(rv2(ta, i0 + 8), la2(ta - 1, i0 + 8), r8);
        a[3] = fac2(rv2(tb, i0 + 8), la2(tb - 1, i0 + 8), r8);
#pragma unroll
        for (int ns = 0; ns < 6; ++ns) {
          if (ns >= 2 * J) continue;
          const int s = 8 * ns + gr;
          mma_bf16(accA[ns], a, fac2(kv2(s, i0), r0, la2(s, i0)),
                   fac2(kv2(s, i0 + 8), r8, la2(s, i0 + 8)));
        }
      }
#pragma unroll
      for (int ns = 0; ns < 6; ++ns) {
        if (ns >= 2 * J) continue;
        const int col = 8 * ns + 2 * tg;
        *reinterpret_cast<float2*>(As + ta * LDA + col) =
            make_float2(accA[ns][0], accA[ns][1]);
        *reinterpret_cast<float2*>(As + tb * LDA + col) =
            make_float2(accA[ns][2], accA[ns][3]);
      }
    }
  } else {
    // The diagonal 16 x 16 block.  Below its own diagonal blocks it
    // factors through reference tokens as the rest of A does: rows 8-15
    // x columns 0-7 through token 7 of the sub-chunk (mma1), rows 4-7 x
    // columns 0-3 through token 3 and rows 12-15 x columns 8-11 through
    // token 11 (mma2, one product, the rows and columns outside those
    // quadrants zeroed in the operands or not taken from it).  Only the
    // four 4 x 4 diagonal blocks keep the pairwise factor whole.
    float acc1[4] = {0.f, 0.f, 0.f, 0.f};
    float acc2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bool hi = gr >= 4, lo = gr < 4;  // mma2's rows and columns
    const int tq = sb + max(gr - 1, 0);  // la_{t-1} row, t = sb + gr (hi)
#pragma unroll
    for (int kd = 0; kd < 4; ++kd) {
      if (16 * kd >= Np) continue;
      const int i0 = 16 * kd + 2 * tg;
      const float2 l7a = la2(sb + 7, i0), l7b = la2(sb + 7, i0 + 8);
      // mma1: rows 8-15 (t = sb + 8 + gr), columns 0-7 (s = sb + gr)
      uint32_t a1[4];
      a1[0] = a1[2] = 0u;
      a1[1] = fac2(rv2(tb, i0), la2(tb - 1, i0), l7a);
      a1[3] = fac2(rv2(tb, i0 + 8), la2(tb - 1, i0 + 8), l7b);
      mma_bf16(acc1, a1, fac2(kv2(ta, i0), l7a, la2(ta, i0)),
               fac2(kv2(ta, i0 + 8), l7b, la2(ta, i0 + 8)));
      // mma2: rows 4-7 through token 3, rows 12-15 through token 11
      uint32_t a2[4] = {0u, 0u, 0u, 0u}, b2[4] = {0u, 0u, 0u, 0u};
      const float2 l3a = la2(sb + 3, i0), l3b = la2(sb + 3, i0 + 8);
      const float2 l11a = la2(sb + 11, i0), l11b = la2(sb + 11, i0 + 8);
      if (hi) {
        a2[0] = fac2(rv2(ta, i0), la2(tq, i0), l3a);
        a2[2] = fac2(rv2(ta, i0 + 8), la2(tq, i0 + 8), l3b);
        a2[1] = fac2(rv2(tb, i0), la2(tb - 1, i0), l11a);
        a2[3] = fac2(rv2(tb, i0 + 8), la2(tb - 1, i0 + 8), l11b);
      }
      if (lo) {
        b2[0] = fac2(kv2(ta, i0), l3a, la2(ta, i0));
        b2[1] = fac2(kv2(ta, i0 + 8), l3b, la2(ta, i0 + 8));
        b2[2] = fac2(kv2(tb, i0), l11a, la2(tb, i0));
        b2[3] = fac2(kv2(tb, i0 + 8), l11b, la2(tb, i0 + 8));
      }
      mma_bf16(acc2[0], a2, b2[0], b2[1]);
      mma_bf16(acc2[1], a2, b2[2], b2[3]);
    }
    // the four 4 x 4 diagonal blocks: the pairwise factor whole, fp32.
    // Four lanes a pair (a quarter of the channels each, 4 at a time:
    // 8-byte bf16 and 16-byte fp32 loads), eight pairs a round, 5 rounds
    // for the 40 pairs s <= t; the quad's partial sums meet by shuffles.
    float* adw = ad + J * 16 * 17;
    const int q = lane & 3, nq = Np / 4, c0 = q * nq;
    auto ld4 = [](const bf16* p) {  // four bf16 as fp32, one 8-byte load
      const uint2 u2 = *reinterpret_cast<const uint2*>(p);
      const float2 x0 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u2.x));
      const float2 x1 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u2.y));
      return make_float4(x0.x, x0.y, x1.x, x1.y);
    };
    for (int e = lane >> 2; e < kDiag; e += 8) {
      int tl, sl;
      tri_pair(e % 10, tl, sl);
      tl += 4 * (e / 10);
      sl += 4 * (e / 10);
      const int t = sb + tl, s = sb + sl;
      float acc = 0.f;
      if (t < valid) {
        const bf16* rt = rs_ + t * LDN + c0;
        const bf16* kk = ks + s * LDN + c0;
        if (sl == tl) {
          for (int cc = 0; cc < nq; cc += 4) {
            const float4 x = ld4(rt + cc), y = ld4(kk + cc);
            const float4 g = *reinterpret_cast<const float4*>(us + c0 + cc);
            acc = fmaf(x.x * g.x, y.x, acc);
            acc = fmaf(x.y * g.y, y.y, acc);
            acc = fmaf(x.z * g.z, y.z, acc);
            acc = fmaf(x.w * g.w, y.w, acc);
          }
        } else {
          const float* lp = la + (t - 1) * LDL + c0;
          const float* ls = la + s * LDL + c0;
          for (int cc = 0; cc < nq; cc += 4) {
            const float4 x = ld4(rt + cc), y = ld4(kk + cc);
            const float4 p = *reinterpret_cast<const float4*>(lp + cc);
            const float4 m = *reinterpret_cast<const float4*>(ls + cc);
            acc = fmaf(x.x * y.x, exp2f(p.x - m.x), acc);
            acc = fmaf(x.y * y.y, exp2f(p.y - m.y), acc);
            acc = fmaf(x.z * y.z, exp2f(p.z - m.z), acc);
            acc = fmaf(x.w * y.w, exp2f(p.w - m.w), acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0 && t < valid) adw[tl * 17 + sl] = acc;
    }
    __syncwarp();
    // the block into A, element (tl, sl) from its part
    auto pick = [&](int tl, int sl, float quad) {
      if (sl > tl) return 0.f;
      return tl / 4 == sl / 4 ? adw[tl * 17 + sl] : quad;
    };
    float* ra = As + ta * LDA + sb + 2 * tg;
    float* rb = As + tb * LDA + sb + 2 * tg;
    *reinterpret_cast<float2*>(ra) = make_float2(
        pick(gr, 2 * tg, acc2[0][0]), pick(gr, 2 * tg + 1, acc2[0][1]));
    *reinterpret_cast<float2*>(ra + 8) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(rb) = make_float2(acc1[2], acc1[3]);
    *reinterpret_cast<float2*>(rb + 8) =
        make_float2(pick(gr + 8, 2 * tg + 8, acc2[1][2]),
                    pick(gr + 8, 2 * tg + 9, acc2[1][3]));
  }
  __syncthreads();

  // the incoming state: written by pass 2
  grid_dep_wait();
  const size_t row = static_cast<size_t>(b) * d.H + hd;
  const size_t at_s = (row * d.nc + c) * static_cast<size_t>(d.N) * d.N;
  const size_t lo = static_cast<size_t>(gridDim.z) * d.H * d.nc * d.N * d.N;
  load_tile(ss, LDN, s_in + at_s, d.N, d.N, d.N, d.N, vec, tid, nthr);
  load_tile(ss + Np * LDN, LDN, s_in + lo + at_s, d.N, d.N, d.N, d.N, vec, tid,
            nthr);
  cp_async_commit();

  // o = A v over this warp's 32 value columns; A as its high and low bf16
  // parts, two products, v exact
  const int j0 = 32 * half;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk > J) continue;
    const int s0 = 16 * kk + 2 * tg;
    const float2 v0 = *reinterpret_cast<const float2*>(As + ta * LDA + s0);
    const float2 v1 = *reinterpret_cast<const float2*>(As + tb * LDA + s0);
    const float2 v2 = *reinterpret_cast<const float2*>(As + ta * LDA + s0 + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(As + tb * LDA + s0 + 8);
    const float av[8] = {v0.x, v0.y, v1.x, v1.y, v2.x, v2.y, v3.x, v3.y};
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(av[2 * m], av[2 * m + 1]);
      const float2 hf = __bfloat1622float2(h2);
      ahi[m] = *reinterpret_cast<const uint32_t*>(&h2);
      alo[m] = pack_bf16(av[2 * m] - hf.x, av[2 * m + 1] - hf.y);
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (j0 + 16 * jp >= Np) continue;
      uint32_t bf[4];
      ldsm_x4_t(bf, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                        j0 + 16 * jp + (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], ahi, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], ahi, bf[2], bf[3]);
      mma_bf16(acc[2 * jp], alo, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], alo, bf[2], bf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // o += (r exp2(la_{t-1})) S_{c-1}, the state as its high and low parts
#pragma unroll
  for (int kd = 0; kd < 4; ++kd) {
    if (16 * kd >= Np) continue;
    const int i0 = 16 * kd + 2 * tg;
    const float2 zero = make_float2(0.f, 0.f);  // la_{-1}: no decay yet
    const float2 pa0 = ta > 0 ? la2(ta - 1, i0) : zero;
    const float2 pa8 = ta > 0 ? la2(ta - 1, i0 + 8) : zero;
    uint32_t a[4];
    a[0] = fac2(rv2(ta, i0), pa0, zero);
    a[1] = fac2(rv2(tb, i0), la2(tb - 1, i0), zero);
    a[2] = fac2(rv2(ta, i0 + 8), pa8, zero);
    a[3] = fac2(rv2(tb, i0 + 8), la2(tb - 1, i0 + 8), zero);
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      if (j0 + 16 * jp >= Np) continue;
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // the state's high, low parts
        uint32_t bf[4];
        ldsm_x4_t(bf, ss + part * Np * LDN +
                          (16 * kd + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                          j0 + 16 * jp + (lane >> 4) * 8);
        mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
      }
    }
  }
  bf16* oa = o + (static_cast<long long>(b) * d.T + t0 + ta) * rstr +
             static_cast<long long>(hd) * d.N;
  bf16* ob = oa + 8 * rstr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = j0 + 8 * j + 2 * tg;
    if (n >= d.N) continue;
    if (d.N % 2 == 0) {
      if (ta < valid)
        *reinterpret_cast<uint32_t*>(oa + n) = pack_bf16(acc[j][0], acc[j][1]);
      if (tb < valid)
        *reinterpret_cast<uint32_t*>(ob + n) = pack_bf16(acc[j][2], acc[j][3]);
    } else {
      const bool two = n + 1 < d.N;
      if (ta < valid) {
        oa[n] = __float2bfloat16(acc[j][0]);
        if (two) oa[n + 1] = __float2bfloat16(acc[j][1]);
      }
      if (tb < valid) {
        ob[n] = __float2bfloat16(acc[j][2]);
        if (two) ob[n + 1] = __float2bfloat16(acc[j][3]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32

__host__ __device__ inline int ld32(int N) { return (N + 3) / 4 * 4 + 4; }

__host__ __device__ inline size_t state_scalar_bytes(int N) {
  return sizeof(float) * (static_cast<size_t>(3) * kC * ld32(N) + 4 * N);
}

// Pass 1, scalar: kdec in place of k, then dS[i, j] = kdec[:, i] . v[:, j].
__global__ void __launch_bounds__(kThreads)
    wkv_state_scalar_kernel(const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ w, Dims d, bool vec,
                            bool vec_w, float* __restrict__ delta,
                            float* __restrict__ dec) {
  extern __shared__ uint4 smem_raw[];
  const int LD = ld32(d.N);
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kC][LD]
  float* vs = ks + kC * LD;                        // [kC][LD]
  float* la = vs + kC * LD;                        // [kC][LD]
  float* off = la + kC * LD;                       // [4][N]
  grid_dep_launch();
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  const long long rs = static_cast<long long>(d.H) * d.N;
  const long long at = (static_cast<long long>(b) * d.T + t0) * rs +
                       static_cast<long long>(h) * d.N;
  load_tile(ks, LD, k + at, rs, kC, d.N, valid, vec, tid, kThreads);
  load_tile(vs, LD, v + at, rs, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  logw_cumsum(la, LD, w + at, rs, valid, d.N, d.N, vec_w, off, tid, kThreads);
  cp_async_wait<0>();
  __syncthreads();
  const float* lend = la + (kC - 1) * LD;
  const size_t row = static_cast<size_t>(b) * d.H + h;
  for (int i = tid; i < d.N; i += kThreads)
    dec[(row * d.nc + c) * d.N + i] = exp2f(lend[i]);
  for (int e = tid; e < valid * d.N; e += kThreads) {
    const int s = e / d.N, i = e - s * d.N;
    ks[s * LD + i] *= exp2f(lend[i] - la[s * LD + i]);
  }
  __syncthreads();
  float* out = delta + (row * d.nc + c) * static_cast<size_t>(d.N) * d.N;
  for (int e = tid; e < d.N * d.N; e += kThreads) {
    const int i = e / d.N, j = e - i * d.N;
    out[e] = dot(ks + i, LD, vs + j, LD, valid);
  }
}

__host__ __device__ inline size_t out_scalar_bytes(int N) {
  return sizeof(float) * (static_cast<size_t>(4) * kC * ld32(N) +
                          N * ld32(N) + kC * (kC + 1) + 5 * N);
}

// Pass 3, scalar: A over the causal pairs with the pairwise factor
// whole, rdec in place of r, then o[t, j] = A[t, :t+1] . v[:t+1, j] +
// rdec[t] . S[:, j].
__global__ void __launch_bounds__(kThreads)
    wkv_out_scalar_kernel(const float* __restrict__ r,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ w,
                          const float* __restrict__ u,
                          const float* __restrict__ s_in,
                          float* __restrict__ o, Dims d, bool vec,
                          bool vec_w) {
  extern __shared__ uint4 smem_raw[];
  const int LD = ld32(d.N), LDA = kC + 1;
  float* rs_ = reinterpret_cast<float*>(smem_raw);  // [kC][LD]
  float* ks = rs_ + kC * LD;                        // [kC][LD]
  float* vs = ks + kC * LD;                         // [kC][LD]
  float* la = vs + kC * LD;                         // [kC][LD]
  float* ss = la + kC * LD;                         // [N][LD]
  float* As = ss + d.N * LD;                        // [kC][LDA]
  float* us = As + kC * LDA;                        // [N]
  float* off = us + d.N;                            // [4][N]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  const long long rstr = static_cast<long long>(d.H) * d.N;
  const long long at = (static_cast<long long>(b) * d.T + t0) * rstr +
                       static_cast<long long>(h) * d.N;
  load_tile(rs_, LD, r + at, rstr, kC, d.N, valid, vec, tid, kThreads);
  load_tile(ks, LD, k + at, rstr, kC, d.N, valid, vec, tid, kThreads);
  load_tile(vs, LD, v + at, rstr, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  for (int i = tid; i < d.N; i += kThreads)
    us[i] = u[static_cast<size_t>(h) * d.N + i];
  logw_cumsum(la, LD, w + at, rstr, valid, d.N, d.N, vec_w, off, tid,
              kThreads);
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < valid * (valid + 1) / 2; e += kThreads) {
    int t, s;
    tri_pair(e, t, s);
    const float* rt = rs_ + t * LD;
    const float* kk = ks + s * LD;
    float p0 = 0.f, p1 = 0.f;
    if (s == t) {
      for (int i = 0; i < d.N; ++i) p0 = fmaf(rt[i] * us[i], kk[i], p0);
    } else {
      const float* lp = la + (t - 1) * LD;
      const float* ls = la + s * LD;
      int i = 0;
      for (; i + 2 <= d.N; i += 2) {
        p0 = fmaf(rt[i] * kk[i], exp2f(lp[i] - ls[i]), p0);
        p1 = fmaf(rt[i + 1] * kk[i + 1], exp2f(lp[i + 1] - ls[i + 1]), p1);
      }
      for (; i < d.N; ++i) p0 = fmaf(rt[i] * kk[i], exp2f(lp[i] - ls[i]), p0);
    }
    As[t * LDA + s] = p0 + p1;
  }
  __syncthreads();
  for (int e = tid; e < valid * d.N; e += kThreads) {  // rdec in place
    const int t = e / d.N, i = e - t * d.N;
    if (t > 0) rs_[t * LD + i] *= exp2f(la[(t - 1) * LD + i]);
  }
  grid_dep_wait();  // the incoming state is pass 2's
  const size_t row = static_cast<size_t>(b) * d.H + h;
  load_tile(ss, LD, s_in + (row * d.nc + c) * static_cast<size_t>(d.N) * d.N,
            d.N, d.N, d.N, d.N, vec, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < valid * d.N; e += kThreads) {
    const int t = e / d.N, j = e - t * d.N;
    o[at + t * rstr + j] = dot(As + t * LDA, 1, vs + j, LD, t + 1) +
                           dot(rs_ + t * LD, 1, ss + j, LD, d.N);
  }
}

// Pass 2: state_pass (common.cuh) under this scan's name.
template <int V, typename T>
__global__ void wkv_pass_kernel(const float* __restrict__ delta,
                                const float* __restrict__ dec,
                                const float* __restrict__ s0,
                                T* __restrict__ s_in, float* __restrict__ s_out,
                                int nc, int per_row, int Cn, int dec_rows) {
  state_pass<V>(delta, dec, s0, s_in, s_out, nc, per_row, Cn, dec_rows);
}

// ------------------------------------------------------------ launch

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const T* r, const T* k, const T* v, const float* w,
                   const float* u, const float* s0, T* o, float* s_out, int B,
                   Dims d, float* delta, T* s_in, float* dec,
                   cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);
  const bool vec = aligned16(r) && aligned16(k) && aligned16(v) &&
                   aligned16(s_in) && d.N % E == 0 && (d.H * d.N) % E == 0;
  const bool vec_w = aligned16(w) && d.N % 4 == 0 && (d.H * d.N) % 4 == 0;
  const bool pad = d.N % 16 != 0;
  const int per_row = d.N * d.N;
  // four elements a thread share one decay row where 4 | N
  const bool v4 = d.N % 4 == 0 && aligned16(s0) && aligned16(s_out);
  auto* pass = v4 ? wkv_pass_kernel<4, T> : wkv_pass_kernel<1, T>;
  const int per_thread = v4 ? 4 : 1;
  const dim3 grid(d.nc, d.H, B);
  const dim3 pgrid(B * d.H, (per_row + per_thread * kPassThreads - 1) /
                                (per_thread * kPassThreads));
  // every attribute before the first launch, so that the three launches
  // follow one another with nothing between them
  size_t bytes1, bytes3;
  cudaError_t err;
  if constexpr (kMma) {
    bytes1 = state_mma_bytes(d.N);
    bytes3 = out_mma_bytes(d.N);
    err = allow_dynamic_smem(wkv_state_mma_kernel, bytes1);
    if (err == cudaSuccess) err = allow_dynamic_smem(wkv_out_mma_kernel, bytes3);
  } else {
    bytes1 = state_scalar_bytes(d.N);
    bytes3 = out_scalar_bytes(d.N);
    err = allow_dynamic_smem(wkv_state_scalar_kernel, bytes1);
    if (err == cudaSuccess)
      err = allow_dynamic_smem(wkv_out_scalar_kernel, bytes3);
  }
  if (err == cudaSuccess) err = prefer_max_shared(pass);
  if (err != cudaSuccess) return err;
  if (d.nc > 0) {
    if constexpr (kMma)
      wkv_state_mma_kernel<<<grid, kThreads, bytes1, stream>>>(
          k, v, w, d, vec, vec_w, pad, delta, dec);
    else
      wkv_state_scalar_kernel<<<grid, kThreads, bytes1, stream>>>(
          k, v, w, d, vec, vec_w, delta, dec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float* dc = delta;
  const float* fc = dec;
  err = launch_pdl(pass, pgrid, dim3(kPassThreads), 0, stream, dc, fc, s0,
                   s_in, s_out, d.nc, per_row, d.N, d.N);
  if (err != cudaSuccess || d.nc == 0) return err;
  const T* si = s_in;
  if constexpr (kMma)
    return launch_pdl(wkv_out_mma_kernel, grid, dim3(kOutThreads), bytes3,
                      stream,
                      r, k, v, w, u, si, o, d, vec, vec_w, pad);
  else
    return launch_pdl(wkv_out_scalar_kernel, grid, dim3(kThreads), bytes3,
                      stream, r, k, v, w, u, si, o, d, vec, vec_w);
}

}  // namespace

// ws: the wrapper's workspace (repro_torch.kernels.rwkv6.rwkv6_plan):
// fp32 chunk states at delta_off, the incoming states in r's type at
// in_off, the chunks' fp32 per-channel decays at dec_off (bytes).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const float* w, const float* u, const float* s0,
                            void* o, float* s_out, int B, int T_len, int H,
                            int N, int n_chunks, void* ws, long long delta_off,
                            long long in_off, long long dec_off, int type_code,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0 || N > 64 || n_chunks != (T_len + kC - 1) / kC ||
      (type_code != 0 && type_code != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{T_len, H, N, n_chunks};
  auto* base = static_cast<unsigned char*>(ws);
  auto* delta = reinterpret_cast<float*>(base + delta_off);
  auto* dec = reinterpret_cast<float*>(base + dec_off);
  auto s = static_cast<cudaStream_t>(stream);
  if (type_code == 0)
    err = launch<float>(static_cast<const float*>(r),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), w, u, s0,
                        static_cast<float*>(o), s_out, B, d, delta,
                        reinterpret_cast<float*>(base + in_off), dec, s);
  else
    err = launch<bf16>(static_cast<const bf16*>(r), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), w, u, s0,
                       static_cast<bf16*>(o), s_out, B, d, delta,
                       reinterpret_cast<bf16*>(base + in_off), dec, s);
  return static_cast<int>(err);
}
