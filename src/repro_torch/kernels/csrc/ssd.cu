// Mamba-2 SSD (state space dual) chunk scan with a scalar decay per
// head:
//   S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t
// over a whole sequence, starting from a given fp32 state and returning
// the final fp32 state.  The D-skip (y += D x) stays outside, in
// ops.ssd, as in the reference.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:29-84 (_ssd_kernel
// under ssd_pallas, :87).  That kernel walks the chunks of one (b, h)
// row on a sequential grid axis with the [P, N] state in VMEM scratch.
// Hopper blocks run in no order and a serial chunk walk in B * H blocks
// leaves the card latency-bound, so the scan is split the way Mamba-2's
// own GPU implementation splits it (chunk state, state passing, chunk
// scan), in three kernels of one call:
//
//   1. chunk-local pass, grid (chunk, head, batch), 128 threads: the
//      cumulative log decay lcum = cumsum(A dt) of the chunk (a warp
//      scan), its decay exp(lcum_end), and the chunk's own state
//      dS_c = sum_s exp(lcum_end - lcum_s) dt_s x_s B_s^T ([P, N]),
//      written to an fp32 workspace [B, H, nc, P, N];
//   2. state passing (ssd_pass_kernel, state_pass in common.cuh),
//      grid (B * H, P N / 1024), four state elements a thread:
//      S_c = exp(lcum_end_c) S_{c-1} + dS_c over the nc chunks in order,
//      eight chunks' loads in flight at once; it writes each chunk's
//      incoming state S_{c-1} to a second workspace (fp32, or for bf16
//      its high and low bf16 parts) and the last state to s_out, fp32;
//   3. output pass, grid (chunk, block of hpb heads of one B/C group,
//      batch), a group of four warps per head, side by side: group 0
//      computes CB = C_c B_c^T once per chunk and block and hands it to
//      the other groups through shared memory (with G = 1 all 64 heads
//      of zamba2-1.2b read one B/C, so CB is computed 64 / hpb times per
//      chunk where the first design computed it 256 times), then per
//      head y = (CB . exp(lcum_t - lcum_s) dt_s for s <= t) x
//                + exp(lcum_t) (C S_{c-1}^T).
//      hpb (ssd_plan) is 2 where the grid still has a block per SM.
//
// Passes 2 and 3 are programmatic dependents of the pass before them
// (launch_pdl), every kernel attribute set before the first launch and
// all three asking for the same shared-memory carveout, so that a
// dependent can start beside its predecessor: pass 3 loads its chunk and
// computes CB before it waits, and waits only before it reads the
// incoming states.  (On the H100 a dependent of a dependent starts only
// once the first kernel has ended, so pass 3 overlaps pass 2, not pass
// 1.)  The wrapper allocates the workspaces per call (torch.empty) and
// counts one launch per call; nothing here is static, so threads
// launching at once share nothing.
//
// Two routes on dtype, a dispatch and not a fallback:
// * bf16 (the serving path): every product on the tensor cores,
//   mma.sync.m16n8k16 bf16 -> fp32, operands by ldmatrix from shared
//   tiles filled with 16-byte cp.async.  Only values bounded by their
//   inputs are rounded to bf16: the decayed xdec = exp(lcum_end -
//   lcum_s) dt_s x_s of pass 1 and G of pass 3 (built in registers from
//   the CB accumulators, which are the A fragments of G x as they lie).
//   The state is carried in fp32 and enters C S^T as its high and low
//   bf16 parts, two products.
// * fp32 (the parity checks): TF32 cannot hold their 2e-4, so the same
//   three passes run scalar fp32 FMAs from shared memory.
//
// One token (T == 1, every decode step of zamba2) is a bandwidth job,
// not a scan: the launcher dispatches it to a kernel of its own, grid
// (head, batch) of 256 threads, 16 lanes per state row, each lane 4
// columns (N <= 64) or 8 (N <= 128).  Each lane
// reads its part of a row once (16-byte loads where N % 4 == 0), forms
// S' = exp(A dt) S + dt x B^T in registers, writes it once, and the
// row's y_p = S'_p . C is reduced with warp shuffles: no shared memory,
// no block barrier.  It computes what the chunked route computes for
// one token.
//
// Widths: P <= 64 (four warps of 16 state rows in passes 1 and 3, 16 row
// slots of the decode kernel), N <= 128.  The tensor-core passes hold N
// in registers as 16-wide tiles, 4 of them up to N = 64 and 8 up to 128
// (a template argument each, so zamba2's N = 64 runs the code it ran
// before); granite-4.0-h-small's N = 128 doubles each head's fp32 state
// to 32 KB.
//
// Layouts: the model's.  x [B, T, H, P] (fp32 or bf16), dt [B, T, H]
// fp32, A [H] fp32, Bm/Cm [B, T, G, N] in x's type, s0 and s_out
// [B, H, P, N] fp32, y [B, T, H, P] in x's type.  x, Bm and Cm may be
// views into the Mamba block's conv output: each takes a batch stride
// and a token stride (in elements) and needs only its last two dims
// dense (16-byte copies where pointers and strides allow, else element
// loads).  Head h reads B/C group h / (H / G), as the reference's
// jnp.repeat over heads (ops.py:244-245) assigns them.  The kernels tile
// the sequence in chunks of 64 tokens whatever `chunk` the caller
// passes (the function does not depend on it beyond rounding); a
// ragged last chunk is zero-filled past its valid tokens, which is what
// the reference's zero padding computes (dt = 0: no decay, no input).
//
// Bound on the H100.  One zamba2-1.2b prefill layer (B = 1, T = 384,
// H = 64, P = N = 64, G = 1, bf16 x/B/C, fp32 dt): x and y 3.1 MB, B/C
// by group 0.1 MB, both states 2.1 MB: 8,585,472 bytes, 2.563 us at
// 3.35 TB/s; its 0.61 GFLOP of causal products take 9.06 us at the
// 67 TFLOP/s fp32 scalar rate but 0.61 us at the 989 TFLOP/s bf16
// tensor rate, so on the bf16 route the bound is bytes.  The
// workspaces add 6.3 MB of fp32 chunk states (written by pass 1, read
// by pass 2) and 6.3 MB of incoming states as bf16 high and low parts
// (written by pass 2, read by pass 3), mostly served from the 50 MB L2.
// What keeps the chain above the bound is latency: each pass is a
// load, a short product and a store per block, and the three follow
// one another.  A decode step (16 slots x 64 heads x 16 KB of fp32
// state read and written) moves 33.8 MB: 10.1 us, bytes; one of
// granite-4.0-h-small's (32 slots x 128 heads x 32 KB) 268.4 MB: 80.1 us.
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
constexpr int kMaxHeadsPerBlock = 2;  // pass 3: a warp group per head
constexpr int kPassThreads = 256;  // pass 2
constexpr int kDecThreads = 256;   // T == 1: 16 rows x 16 lanes
constexpr int kPadH = 8;           // bf16 row padding (16 bytes)
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long xb, xt;  // x: batch, token (elements)
  long long bb, bt;  // Bm
  long long cb, ct;  // Cm
};

struct Dims {
  int T, H, G, P, N, nc, hpb;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// lcum_t = sum_{s <= t} A dt_s over one chunk of kC tokens (dt = 0 past
// `valid`), by one warp, two tokens a lane.  Writes lcum and dt (0 past
// valid) to shared memory; returns lcum_end to every lane.
__device__ __forceinline__ float chunk_lcum(const float* dtb, int H, float a,
                                            int valid, float* lc, float* dq,
                                            int lane) {
  const int t = 2 * lane;
  const float d0 = t < valid ? dtb[static_cast<long long>(t) * H] : 0.f;
  const float d1 = t + 1 < valid ? dtb[static_cast<long long>(t + 1) * H] : 0.f;
  const float l0 = a * d0;
  const float pair = l0 + a * d1;
  float incl = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  const float base = incl - pair;
  lc[t] = base + l0;
  lc[t + 1] = incl;
  dq[t] = d0;
  dq[t + 1] = d1;
  return __shfl_sync(kFull, incl, 31);
}

// ---------------------------------------------------------------- bf16

// Pass 1: dS = xdec^T B with xdec[s, p] = exp(lcum_end - lcum_s) dt_s
// x[s, p].  Warp w owns state rows p in [16 w, 16 w + 16); A fragments
// (xdec^T) are built in registers from x in shared memory, B fragments
// by ldmatrix.trans from B stored [token][n].  kNT: 16-wide tiles of N
// the registers hold (4: N <= 64; 8: N <= 128).
template <int kNT>
__global__ void __launch_bounds__(kThreads)
    ssd_state_mma_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ A,
                         const bf16* __restrict__ Bm, Strides st, Dims d,
                         bool vec, bool pad, float* __restrict__ delta,
                         float* __restrict__ dec) {
  extern __shared__ uint4 smem_raw[];
  const int Pp = round16(d.P), Np = round16(d.N);
  const int LDX = Pp + kPadH, LDN = Np + kPadH;
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kC][LDX]
  bf16* bs = xs + kC * LDX;                      // [kC][LDN]
  float* fs = reinterpret_cast<float*>(bs + kC * LDN);  // [kC] decay dt
  float* lc = fs + kC;                                  // [kC] lcum
  grid_dep_launch();  // let the state pass get resident early
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  if (pad) {
    zero_smem(smem_raw, kC * (LDX + LDN) / 2, tid, kThreads);
    __syncthreads();
  }
  load_tile(xs, LDX, x + b * st.xb + t0 * st.xt + static_cast<long long>(h) * d.P,
            st.xt, kC, d.P, valid, vec, tid, kThreads);
  load_tile(bs, LDN, Bm + b * st.bb + t0 * st.bt + static_cast<long long>(g) * d.N,
            st.bt, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  if (warp == 0) {
    const float* dtb = dt + (static_cast<long long>(b) * d.T + t0) * d.H + h;
    const float lend = chunk_lcum(dtb, d.H, A[h], valid, lc, fs, lane);
    __syncwarp();
    fs[2 * lane] *= expf(lend - lc[2 * lane]);
    fs[2 * lane + 1] *= expf(lend - lc[2 * lane + 1]);
    if (lane == 0)
      dec[(static_cast<size_t>(b) * d.H + h) * d.nc + c] = expf(lend);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int p0 = 16 * warp;
  if (p0 >= Pp) return;
  const int gr = lane >> 2, tg = lane & 3;
  const int pa = p0 + gr, pb = pa + 8;
  float acc[2 * kNT][4];
#pragma unroll
  for (int j = 0; j < 2 * kNT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk) {
    const int s0 = 16 * kk + 2 * tg;
    const float f0 = fs[s0], f1 = fs[s0 + 1], f8 = fs[s0 + 8], f9 = fs[s0 + 9];
    auto xv = [&](int s, int p) { return __bfloat162float(xs[s * LDX + p]); };
    uint32_t a[4];
    a[0] = pack_bf16(f0 * xv(s0, pa), f1 * xv(s0 + 1, pa));
    a[1] = pack_bf16(f0 * xv(s0, pb), f1 * xv(s0 + 1, pb));
    a[2] = pack_bf16(f8 * xv(s0 + 8, pa), f9 * xv(s0 + 9, pa));
    a[3] = pack_bf16(f8 * xv(s0 + 8, pb), f9 * xv(s0 + 9, pb));
#pragma unroll
    for (int np = 0; np < kNT; ++np) {
      if (16 * np < Np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, bs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN +
                          16 * np + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], a, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
  }
  float* out = delta + ((static_cast<size_t>(b) * d.H + h) * d.nc + c) *
                           static_cast<size_t>(d.P) * d.N;
  const bool pairs = d.N % 2 == 0;  // 8-byte stores: rows of even width
#pragma unroll
  for (int j = 0; j < 2 * kNT; ++j) {
    const int n = 8 * j + 2 * tg;
    if (n >= d.N) continue;
    const bool two = n + 1 < d.N;
    if (pa < d.P) {
      if (pairs) {
        *reinterpret_cast<float2*>(out + pa * d.N + n) =
            make_float2(acc[j][0], acc[j][1]);
      } else {
        out[pa * d.N + n] = acc[j][0];
        if (two) out[pa * d.N + n + 1] = acc[j][1];
      }
    }
    if (pb < d.P) {
      if (pairs) {
        *reinterpret_cast<float2*>(out + pb * d.N + n) =
            make_float2(acc[j][2], acc[j][3]);
      } else {
        out[pb * d.N + n] = acc[j][2];
        if (two) out[pb * d.N + n + 1] = acc[j][3];
      }
    }
  }
}

// Shared memory of pass 3 (bf16): C and B [kC][LDN]; CB's accumulators
// as group 0 holds them [4 warps][32][32 lanes] fp32 (with more than one
// head a block); then per head of the block x [kC][LDX], the incoming
// state's high and low bf16 parts [2][Pp][LDN], lcum and dt.
__host__ __device__ inline size_t out_mma_head_bytes(int P, int N) {
  return static_cast<size_t>(kC) * (round16(P) + kPadH) * 2 +
         static_cast<size_t>(2) * round16(P) * (round16(N) + kPadH) * 2 +
         2 * kC * sizeof(float);
}
__host__ __device__ inline size_t out_mma_cb_bytes(int hpb) {
  return hpb > 1 ? 4 * 32 * 32 * sizeof(float) : 0;
}
__host__ __device__ inline size_t out_mma_bytes(int P, int N, int hpb) {
  return static_cast<size_t>(2) * kC * (round16(N) + kPadH) * 2 +
         out_mma_cb_bytes(hpb) + hpb * out_mma_head_bytes(P, N);
}

// Pass 3: hpb groups of four warps, one head each, run side by side;
// warp w of a group owns output rows t in [16 w, 16 w + 16).  Group 0
// computes CB (its accumulators are the A fragments of G x as they
// lie) and hands them to the other groups through shared memory; per
// head y = exp(lcum_t) (C S^T) + G x, both on the tensor cores.  kNT as
// in pass 1: C's fragments span N.
template <int kNT>
__global__ void __launch_bounds__(kMaxHeadsPerBlock * kThreads)
    ssd_out_mma_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm,
                       const bf16* __restrict__ s_in, bf16* __restrict__ y,
                       Strides st, Dims d, bool vec, bool vec_s, bool pad) {
  extern __shared__ uint4 smem_raw[];
  const int Pp = round16(d.P), Np = round16(d.N);
  const int LDX = Pp + kPadH, LDN = Np + kPadH;
  bf16* cs = reinterpret_cast<bf16*>(smem_raw);  // [kC][LDN]
  bf16* bs = cs + kC * LDN;                      // [kC][LDN]
  float* cbs = reinterpret_cast<float*>(bs + kC * LDN);  // [4][32][32]
  unsigned char* heads =
      reinterpret_cast<unsigned char*>(cbs) + out_mma_cb_bytes(d.hpb);
  const size_t head_bytes = out_mma_head_bytes(d.P, d.N);
  auto xs_of = [&](int q) {
    return reinterpret_cast<bf16*>(heads + q * head_bytes);
  };
  auto ss_of = [&](int q) { return xs_of(q) + kC * LDX; };
  auto lc_of = [&](int q) {
    return reinterpret_cast<float*>(ss_of(q) + 2 * Pp * LDN);
  };

  const int c = blockIdx.x, h0 = blockIdx.y * d.hpb, b = blockIdx.z;
  const int g = h0 / (d.H / d.G);
  const int nthr = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = (tid >> 5) & 3, grp = tid >> 7;  // grp: this warp's head
  const int gr = lane >> 2, tg = lane & 3;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  if (pad) {
    zero_smem(smem_raw, static_cast<int>(out_mma_bytes(d.P, d.N, d.hpb) / 4),
              tid, nthr);
    __syncthreads();
  }
  load_tile(cs, LDN, Cm + b * st.cb + t0 * st.ct + static_cast<long long>(g) * d.N,
            st.ct, kC, d.N, valid, vec, tid, nthr);
  load_tile(bs, LDN, Bm + b * st.bb + t0 * st.bt + static_cast<long long>(g) * d.N,
            st.bt, kC, d.N, valid, vec, tid, nthr);
  for (int q = 0; q < d.hpb; ++q)
    load_tile(xs_of(q), LDX,
              x + b * st.xb + t0 * st.xt + static_cast<long long>(h0 + q) * d.P,
              st.xt, kC, d.P, valid, vec, tid, nthr);
  cp_async_commit();
  if (warp == 0) {  // each group's first warp: its head's lcum and dt
    const float* dtb =
        dt + (static_cast<long long>(b) * d.T + t0) * d.H + h0 + grp;
    chunk_lcum(dtb, d.H, A[h0 + grp], valid, lc_of(grp), lc_of(grp) + kC,
               lane);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int tw = 16 * warp;
  const int ta = tw + gr, tb = ta + 8;
  // C's A fragments (rows ta, tb; all of N) and CB over s < tw + 16
  uint32_t ca[kNT][4];
#pragma unroll
  for (int kn = 0; kn < kNT; ++kn)
    if (16 * kn < Np)
      ldsm_x4(ca[kn], cs + (tw + (lane & 15)) * LDN + 16 * kn + (lane >> 4) * 8);
  float cb[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) cb[j][0] = cb[j][1] = cb[j][2] = cb[j][3] = 0.f;
  if (grp == 0) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (np > warp) continue;
#pragma unroll
      for (int kn = 0; kn < kNT; ++kn) {
        if (16 * kn >= Np) continue;
        uint32_t bf[4];
        ldsm_x4(bf, bs + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                        16 * kn + ((lane >> 3) & 1) * 8);
        mma_bf16(cb[2 * np], ca[kn], bf[0], bf[1]);
        mma_bf16(cb[2 * np + 1], ca[kn], bf[2], bf[3]);
      }
    }
  }
  if (d.hpb > 1) {  // CB once per block: group 0's registers to the rest
    float* mine = cbs + warp * 32 * 32 + lane;
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = cb[j][e];
    }
    __syncthreads();
    if (grp > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[j][e] = mine[(4 * j + e) * 32];
    }
  }

  // the incoming states: written by pass 2
  grid_dep_wait();
  const size_t lo = static_cast<size_t>(gridDim.z) * d.H * d.nc * d.P * d.N;
  for (int q = 0; q < d.hpb; ++q) {
    const size_t at = ((static_cast<size_t>(b) * d.H + h0 + q) * d.nc + c) *
                      static_cast<size_t>(d.P) * d.N;
    load_tile(ss_of(q), LDN, s_in + at, d.N, d.P, d.N, d.P, vec_s, tid, nthr);
    load_tile(ss_of(q) + Pp * LDN, LDN, s_in + lo + at, d.N, d.P, d.N, d.P,
              vec_s, tid, nthr);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  {
    const int q = grp;
    const int h = h0 + q;
    const bf16* xs = xs_of(q);
    const bf16* ss = ss_of(q);
    const float* lc = lc_of(q);
    const float* dq = lc + kC;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // C S^T: B fragments from the state stored [p][n], its high and its
    // low bf16 part
#pragma unroll
    for (int kn = 0; kn < kNT; ++kn) {
      if (16 * kn >= Np) continue;
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= Pp) continue;
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          uint32_t bf[4];
          ldsm_x4(bf, ss + part * Pp * LDN +
                          (16 * pp + (lane & 7) + ((lane >> 4) << 3)) * LDN +
                          16 * kn + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[2 * pp], ca[kn], bf[0], bf[1]);
          mma_bf16(acc[2 * pp + 1], ca[kn], bf[2], bf[3]);
        }
      }
    }
    const float la = lc[ta], lb = lc[tb];
    const float ea = expf(la), eb = expf(lb);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= ea;
      acc[j][1] *= ea;
      acc[j][2] *= eb;
      acc[j][3] *= eb;
    }
    // G x: G's A fragments from CB's accumulators, masked to s <= t
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) continue;
      const int s0 = 16 * kk + 2 * tg;
      auto gv = [&](float cbv, float lt, int t, int s) {
        return s <= t ? cbv * expf(lt - lc[s]) * dq[s] : 0.f;
      };
      uint32_t a[4];
      a[0] = pack_bf16(gv(cb[2 * kk][0], la, ta, s0),
                       gv(cb[2 * kk][1], la, ta, s0 + 1));
      a[1] = pack_bf16(gv(cb[2 * kk][2], lb, tb, s0),
                       gv(cb[2 * kk][3], lb, tb, s0 + 1));
      a[2] = pack_bf16(gv(cb[2 * kk + 1][0], la, ta, s0 + 8),
                       gv(cb[2 * kk + 1][1], la, ta, s0 + 9));
      a[3] = pack_bf16(gv(cb[2 * kk + 1][2], lb, tb, s0 + 8),
                       gv(cb[2 * kk + 1][3], lb, tb, s0 + 9));
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        if (16 * pp >= Pp) continue;
        uint32_t bf[4];
        ldsm_x4_t(bf, xs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                          16 * pp + (lane >> 4) * 8);
        mma_bf16(acc[2 * pp], a, bf[0], bf[1]);
        mma_bf16(acc[2 * pp + 1], a, bf[2], bf[3]);
      }
    }
    const long long y_t = static_cast<long long>(d.H) * d.P;
    bf16* ya = y + (static_cast<long long>(b) * d.T + t0 + ta) * y_t +
               static_cast<long long>(h) * d.P;
    bf16* yb = ya + 8 * y_t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = 8 * j + 2 * tg;
      if (p >= d.P) continue;
      if (d.P % 2 == 0) {
        if (ta < valid)
          *reinterpret_cast<uint32_t*>(ya + p) = pack_bf16(acc[j][0], acc[j][1]);
        if (tb < valid)
          *reinterpret_cast<uint32_t*>(yb + p) = pack_bf16(acc[j][2], acc[j][3]);
      } else {
        const bool two = p + 1 < d.P;
        if (ta < valid) {
          ya[p] = __float2bfloat16(acc[j][0]);
          if (two) ya[p + 1] = __float2bfloat16(acc[j][1]);
        }
        if (tb < valid) {
          yb[p] = __float2bfloat16(acc[j][2]);
          if (two) yb[p + 1] = __float2bfloat16(acc[j][3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- fp32

// Pass 1, scalar: xdec in shared memory, then dS[p, n] = xdec[:, p] .
// B[:, n] over the chunk's valid tokens.
__global__ void __launch_bounds__(kThreads)
    ssd_state_scalar_kernel(const float* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const float* __restrict__ Bm, Strides st, Dims d,
                            bool vec, float* __restrict__ delta,
                            float* __restrict__ dec) {
  extern __shared__ uint4 smem_raw[];
  const int LDX = round4(d.P) + 4, LDN = round4(d.N) + 4;
  float* xs = reinterpret_cast<float*>(smem_raw);  // [kC][LDX]
  float* bs = xs + kC * LDX;                       // [kC][LDN]
  float* fs = bs + kC * LDN;                       // [kC]
  float* lc = fs + kC;                             // [kC]
  grid_dep_launch();
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (d.H / d.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  load_tile(xs, LDX, x + b * st.xb + t0 * st.xt + static_cast<long long>(h) * d.P,
            st.xt, kC, d.P, valid, vec, tid, kThreads);
  load_tile(bs, LDN, Bm + b * st.bb + t0 * st.bt + static_cast<long long>(g) * d.N,
            st.bt, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  if (warp == 0) {
    const float* dtb = dt + (static_cast<long long>(b) * d.T + t0) * d.H + h;
    const float lend = chunk_lcum(dtb, d.H, A[h], valid, lc, fs, lane);
    __syncwarp();
    fs[2 * lane] *= expf(lend - lc[2 * lane]);
    fs[2 * lane + 1] *= expf(lend - lc[2 * lane + 1]);
    if (lane == 0)
      dec[(static_cast<size_t>(b) * d.H + h) * d.nc + c] = expf(lend);
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < valid * d.P; e += kThreads) {
    const int s = e / d.P, p = e - s * d.P;
    xs[s * LDX + p] *= fs[s];
  }
  __syncthreads();
  float* out = delta + ((static_cast<size_t>(b) * d.H + h) * d.nc + c) *
                           static_cast<size_t>(d.P) * d.N;
  for (int e = tid; e < d.P * d.N; e += kThreads) {
    const int p = e / d.N, n = e - p * d.N;
    out[e] = dot(xs + p, LDX, bs + n, LDN, valid);
  }
}

__host__ __device__ inline size_t out_scalar_bytes(int P, int N) {
  const int LDX = round4(P) + 4, LDN = round4(N) + 4;
  return sizeof(float) *
         (static_cast<size_t>(2) * kC * LDN + 2 * kC * (kC + 1) + kC * LDX +
          P * LDN + 2 * kC);
}

// Pass 3, scalar: CB over the causal pairs once per block, then per
// head G, and y = G x + exp(lcum_t) (C S^T), one output a thread.
__global__ void __launch_bounds__(kThreads)
    ssd_out_scalar_kernel(const float* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ s_in,
                          float* __restrict__ y, Strides st, Dims d, bool vec,
                          bool vec_s) {
  extern __shared__ uint4 smem_raw[];
  const int LDX = round4(d.P) + 4, LDN = round4(d.N) + 4, LDG = kC + 1;
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kC][LDN]
  float* bs = cs + kC * LDN;                       // [kC][LDN]
  float* cbs = bs + kC * LDN;                      // [kC][LDG]
  float* gs = cbs + kC * LDG;                      // [kC][LDG]
  float* xs = gs + kC * LDG;                       // [kC][LDX]
  float* ss = xs + kC * LDX;                       // [P][LDN]
  float* lc = ss + d.P * LDN;                      // [kC]
  float* dq = lc + kC;                             // [kC]
  const int c = blockIdx.x, h0 = blockIdx.y * d.hpb, b = blockIdx.z;
  const int g = h0 / (d.H / d.G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t0 = c * kC, valid = min(kC, d.T - t0);
  const int pairs = valid * (valid + 1) / 2;
  load_tile(cs, LDN, Cm + b * st.cb + t0 * st.ct + static_cast<long long>(g) * d.N,
            st.ct, kC, d.N, valid, vec, tid, kThreads);
  load_tile(bs, LDN, Bm + b * st.bb + t0 * st.bt + static_cast<long long>(g) * d.N,
            st.bt, kC, d.N, valid, vec, tid, kThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < pairs; e += kThreads) {
    int t, s;
    tri_pair(e, t, s);
    cbs[t * LDG + s] = dot(cs + t * LDN, 1, bs + s * LDN, 1, d.N);
  }
  grid_dep_wait();  // the incoming states are pass 2's
  for (int q = 0; q < d.hpb; ++q) {
    const int h = h0 + q;
    __syncthreads();  // the previous head's readers are done
    load_tile(xs, LDX, x + b * st.xb + t0 * st.xt + static_cast<long long>(h) * d.P,
              st.xt, kC, d.P, valid, vec, tid, kThreads);
    const size_t at = ((static_cast<size_t>(b) * d.H + h) * d.nc + c) *
                      static_cast<size_t>(d.P) * d.N;
    load_tile(ss, LDN, s_in + at, d.N, d.P, d.N, d.P, vec_s, tid, kThreads);
    cp_async_commit();
    if (warp == 0) {
      const float* dtb = dt + (static_cast<long long>(b) * d.T + t0) * d.H + h;
      chunk_lcum(dtb, d.H, A[h], valid, lc, dq, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int e = tid; e < pairs; e += kThreads) {
      int t, s;
      tri_pair(e, t, s);
      gs[t * LDG + s] = cbs[t * LDG + s] * expf(lc[t] - lc[s]) * dq[s];
    }
    __syncthreads();
    const long long y_t = static_cast<long long>(d.H) * d.P;
    float* yh = y + (static_cast<long long>(b) * d.T + t0) * y_t +
                static_cast<long long>(h) * d.P;
    for (int e = tid; e < valid * d.P; e += kThreads) {
      const int t = e / d.P, p = e - t * d.P;
      const float cs_p = dot(cs + t * LDN, 1, ss + p * LDN, 1, d.N);
      const float gx = dot(gs + t * LDG, 1, xs + p, LDX, t + 1);
      yh[t * y_t + p] = fmaf(expf(lc[t]), cs_p, gx);
    }
  }
}

// ------------------------------------------------------------ T == 1

// One token: lane l of a row's 16 owns kCols columns (4: N <= 64; 8:
// N <= 128): 64 q + 4 l .. 64 q + 4 l + 3 for each quarter q < kCols / 4
// (V4, N a multiple of 4: one 16-byte load and store per row and
// quarter), else l + 16 k.
template <typename T, bool V4, int kCols>
__global__ void __launch_bounds__(kDecThreads)
    ssd_decode_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ s0,
                      T* __restrict__ y, float* __restrict__ s_out, Strides st,
                      int H, int G, int P, int N) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int l = threadIdx.x & 15, r0 = threadIdx.x >> 4;
  const float d = dt[static_cast<size_t>(b) * H + h];
  const float dA = expf(A[h] * d);
  const T* Bb = Bm + b * st.bb + static_cast<long long>(g) * N;
  const T* Cb = Cm + b * st.cb + static_cast<long long>(g) * N;
  const T* xb = x + b * st.xb + static_cast<long long>(h) * P;
  auto col = [&](int k) { return V4 ? 64 * (k >> 2) + 4 * l + (k & 3) : l + 16 * k; };
  float bv[kCols], cv[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int n = col(k);
    bv[k] = n < N ? to_f(Bb[n]) : 0.f;
    cv[k] = n < N ? to_f(Cb[n]) : 0.f;
  }
  const size_t base = (static_cast<size_t>(b) * H + h) * P * N;
  const float* src = s0 + base;
  float* dst = s_out + base;
  constexpr int kRows = 4;  // P <= 64 rows over 16 row slots
  float s[kRows][kCols];
  float xp[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {  // every load first, then the math
    const int p = r0 + 16 * i;
    xp[i] = p < P ? to_f(xb[p]) : 0.f;
    if (V4) {
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const int n = col(4 * q);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p < P && n < N)
          v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(p) * N + n);
        s[i][4 * q] = v.x, s[i][4 * q + 1] = v.y;
        s[i][4 * q + 2] = v.z, s[i][4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int n = col(k);
        s[i][k] = p < P && n < N ? src[static_cast<size_t>(p) * N + n] : 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int p = r0 + 16 * i;
    const float coef = d * xp[i];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      s[i][k] = fmaf(dA, s[i][k], coef * bv[k]);
      part = fmaf(s[i][k], cv[k], part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(kFull, part, off);
    if (p >= P) continue;
    if (l == 0) y[(static_cast<size_t>(b) * H + h) * P + p] = from_f<T>(part);
    if (V4) {
#pragma unroll
      for (int q = 0; q < kCols / 4; ++q) {
        const int n = col(4 * q);
        if (n < N)
          *reinterpret_cast<float4*>(dst + static_cast<size_t>(p) * N + n) =
              make_float4(s[i][4 * q], s[i][4 * q + 1], s[i][4 * q + 2],
                          s[i][4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int n = col(k);
        if (n < N) dst[static_cast<size_t>(p) * N + n] = s[i][k];
      }
    }
  }
}

// Pass 2: state_pass (common.cuh) under this scan's name.
template <int V, typename T>
__global__ void ssd_pass_kernel(const float* __restrict__ delta,
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
cudaError_t launch_decode(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* s0,
                          void* y, float* s_out, Strides st, int B, int H,
                          int G, int P, int N, cudaStream_t stream) {
  const dim3 grid(H, B);
  const bool v4 = N % 4 == 0 && aligned16(s0) && aligned16(s_out);
  const bool wide = N > 64;
  auto* kernel = v4 ? (wide ? ssd_decode_kernel<T, true, 8> : ssd_decode_kernel<T, true, 4>)
                    : (wide ? ssd_decode_kernel<T, false, 8> : ssd_decode_kernel<T, false, 4>);
  kernel<<<grid, kDecThreads, 0, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), s0, static_cast<T*>(y), s_out, st, H, G, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chunked(const T* x, const float* dt, const float* A,
                           const T* Bm, const T* Cm, const float* s0, T* y,
                           float* s_out, Strides st, int B, Dims d,
                           float* delta, T* s_in, float* dec,
                           cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte copy
  const bool vec = aligned16(x) && aligned16(Bm) && aligned16(Cm) &&
                   st.xb % E == 0 && st.xt % E == 0 && st.bb % E == 0 &&
                   st.bt % E == 0 && st.cb % E == 0 && st.ct % E == 0 &&
                   d.P % E == 0 && d.N % E == 0;
  const bool vec_s = aligned16(s_in) && (d.P * d.N) % E == 0 && d.N % E == 0;
  const bool pad = d.P % 16 != 0 || d.N % 16 != 0;
  const int per_row = d.P * d.N;
  const bool v4 = per_row % 4 == 0 && aligned16(s0) && aligned16(s_out);
  auto* pass = v4 ? ssd_pass_kernel<4, T> : ssd_pass_kernel<1, T>;
  const int per_thread = v4 ? 4 : 1;
  const dim3 grid1(d.nc, d.H, B), grid3(d.nc, d.H / d.hpb, B);
  const dim3 pgrid(B * d.H, (per_row + per_thread * kPassThreads - 1) /
                                (per_thread * kPassThreads));
  // every attribute before the first launch, so that the three launches
  // follow one another with nothing between them
  size_t bytes1, bytes3;
  cudaError_t err;
  // the MMA passes' N tiles in registers: 4 up to N = 64, else 8
  const bool wide = d.N > 64;
  auto* state_mma = wide ? ssd_state_mma_kernel<8> : ssd_state_mma_kernel<4>;
  auto* out_mma = wide ? ssd_out_mma_kernel<8> : ssd_out_mma_kernel<4>;
  if constexpr (kMma) {
    bytes1 = static_cast<size_t>(kC) *
                 (round16(d.P) + round16(d.N) + 2 * kPadH) * 2 +
             2 * kC * sizeof(float);
    bytes3 = out_mma_bytes(d.P, d.N, d.hpb);
    err = allow_dynamic_smem(state_mma, bytes1);
    if (err == cudaSuccess) err = allow_dynamic_smem(out_mma, bytes3);
  } else {
    bytes1 = sizeof(float) *
             (static_cast<size_t>(kC) * (round4(d.P) + round4(d.N) + 8) +
              2 * kC);
    bytes3 = out_scalar_bytes(d.P, d.N);
    err = allow_dynamic_smem(ssd_state_scalar_kernel, bytes1);
    if (err == cudaSuccess)
      err = allow_dynamic_smem(ssd_out_scalar_kernel, bytes3);
  }
  if (err == cudaSuccess) err = prefer_max_shared(pass);
  if (err != cudaSuccess) return err;
  if (d.nc > 0) {
    if constexpr (kMma)
      state_mma<<<grid1, kThreads, bytes1, stream>>>(x, dt, A, Bm, st, d, vec,
                                                     pad, delta, dec);
    else
      ssd_state_scalar_kernel<<<grid1, kThreads, bytes1, stream>>>(
          x, dt, A, Bm, st, d, vec, delta, dec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const float* dc = delta;
  const float* fc = dec;
  err = launch_pdl(pass, pgrid, dim3(kPassThreads), 0, stream, dc, fc, s0,
                   s_in, s_out, d.nc, per_row, d.N, 1);
  if (err != cudaSuccess || d.nc == 0) return err;
  const T* si = s_in;
  if constexpr (kMma)
    return launch_pdl(out_mma, grid3, dim3(d.hpb * kThreads), bytes3, stream, x,
                      dt, A, Bm, Cm, si, y, st, d, vec, vec_s, pad);
  else
    return launch_pdl(ssd_out_scalar_kernel, grid3, dim3(kThreads), bytes3,
                      stream, x, dt, A, Bm, Cm, si, y, st, d, vec, vec_s);
}

}  // namespace

// ws: the wrapper's workspace (repro_torch.kernels.ssd.ssd_plan): fp32
// chunk states at delta_off, the incoming states in x's type at in_off,
// the chunks' fp32 decays at dec_off (bytes); unused when T == 1.
extern "C" int ssd_launch(const void* x, const float* dt, const float* A,
                          const void* Bm, const void* Cm, const float* s0,
                          void* y, float* s_out, long long x_sb,
                          long long x_st, long long b_sb, long long b_st,
                          long long c_sb, long long c_st, int B, int T_len,
                          int H, int G, int P, int N, int n_chunks,
                          int heads_per_block, void* ws, long long delta_off,
                          long long in_off, long long dec_off, int type_code,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (G <= 0 || H % G || P <= 0 || P > 64 || N <= 0 || N > 128 ||
      (type_code != 0 && type_code != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{x_sb, x_st, b_sb, b_st, c_sb, c_st};
  auto s = static_cast<cudaStream_t>(stream);
  if (T_len == 1) {  // a decode step: the one-token kernel
    err = type_code == 0
              ? launch_decode<float>(x, dt, A, Bm, Cm, s0, y, s_out, st, B, H,
                                     G, P, N, s)
              : launch_decode<bf16>(x, dt, A, Bm, Cm, s0, y, s_out, st, B, H,
                                    G, P, N, s);
    return static_cast<int>(err);
  }
  const int hpb = heads_per_block;
  if (n_chunks != (T_len + kC - 1) / kC || hpb < 1 ||
      hpb > kMaxHeadsPerBlock || (H / G) % hpb)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{T_len, H, G, P, N, n_chunks, hpb};
  auto* base = static_cast<unsigned char*>(ws);
  auto* delta = reinterpret_cast<float*>(base + delta_off);
  auto* dec = reinterpret_cast<float*>(base + dec_off);
  if (type_code == 0)
    err = launch_chunked<float>(
        static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), s0, static_cast<float*>(y), s_out, st,
        B, d, delta, reinterpret_cast<float*>(base + in_off), dec, s);
  else
    err = launch_chunked<bf16>(
        static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), s0, static_cast<bf16*>(y), s_out, st, B,
        d, delta, reinterpret_cast<bf16*>(base + in_off), dec, s);
  return static_cast<int>(err);
}
