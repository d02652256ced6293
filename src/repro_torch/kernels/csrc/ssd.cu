// Mamba-2 SSD scan for Hopper, sm_90a.
//
// Replaces repro/kernels/ssd.py::ssd (the Pallas TPU kernel `_ssd_kernel`).
// Same function, per batch row b and head h, from a zero (P, Ns) fp32
// state H, with B_t and C_t shared across heads (n_groups = 1):
//     a_t = exp(-dt_t exp(A_log[h]))
//     H[p, s] <- a_t H[p, s] + dt_t x_t[p] B_t[s]
//     y_t[p] = sum_s H[p, s] C_t[s] + D[h] x_t[p]
// returning y and the final state. Two deliberate differences from the TPU
// kernel: y comes out in fp32, as the model's chunked form
// (repro/models/mamba.py::ssd_chunked) returns it, and there is no
// initial-state argument (every prefill of the model starts at zero).
//
// Bound on an H100: three fp32 operations per state value and step (the
// product dt x B, the decay FMA, the y FMA), 5 P Ns flops per head and step;
// at zamba2-2.7b's prefill (H 80, P 64, Ns 64, B 1, S 152) that is 0.0037 ms
// at 67 TFLOP/s, over ten times the time to read the inputs and write y and
// the state. The tensor cores do not bound it: a step is a rank-1 update
// and a matrix-vector product, with nothing to reuse across a step.
//
// What the first design (one CTA of P threads per (head, row), a state row
// in each thread) lost: at that shape 80 CTAs of two warps ran, 52 SMs
// idle and 2 of 64 warp slots busy on the rest, and every 32 steps the CTA
// stopped at a barrier to load the next steps from memory (0.0595 ms on an
// H100 80GB HBM3 at 700 W, as every time below).
//
// This design spreads each head's rows over P / RB CTAs, and each row's
// state over Ns / 4 threads:
//   * A thread holds a 2 x 4 block of the state: 2 rows by a run of 4 s
//     values; the Ns / 4 threads of a row pair are adjacent lanes, and a CTA
//     of 64 threads holds RB = 8 rows of one head at Ns = 64. At zamba2's
//     layout: 640 CTAs of 2 warps at B = 1, 4 or 5 on each SM.
//   * An SM's shared memory hands out 32 words a cycle, so a step's words
//     per FMA matter: a block reads 4 B_, 4 C_ (bf16: one 8-byte read
//     each, straight from the copy buffer), 2 dt x and a_t, 7 words for 24
//     FMAs. A thread holding a run of one row reads as many words for a
//     third of the FMAs (0.030 ms); one holding 4 rows halves the warps
//     and was no faster (0.027 ms; this layout: 0.023 ms).
//   * Steps go in tiles of TS = 16 (32 was slower). B_, C_ and the CTA's x
//     rows of the next tile are copied with 16-byte cp.async into the other
//     half of a double buffer while the current tile runs, and dt by plain
//     loads into registers; a thread's copies are the same rows and chunks
//     in every tile, so their sources are set once. One pass forms a_t and
//     dt x once per CTA. Within the tile each step's operands are read a
//     step ahead, and the next tile's copies and the last tile's y are
//     issued among the steps.
//   * The state update is one FMA per value and step. The y sums of the
//     tile's steps are buffered in registers and reduced across the Ns / 4
//     lanes of a row pair in one reduce-scatter (N (1 - 4 / Ns) shuffles
//     for N = 2 TS sums), then written through a double-buffered shared
//     tile as coalesced 16-byte stores during the next tile.
//   * A tile past the end is padded with a_t = 1 and zero inputs, so the
//     state passes through it unchanged.
//   * What holds it at ~6x its bound: at B = 1 a GPU's worth of state gives
//     only 4-5 CTAs of 2 warps an SM, so the chains of each step (shared
//     read, FMAs, shuffles) are poorly hidden, and a step takes about twice
//     the instructions of its FMAs (bf16 widening, the reduce-scatter, the
//     tile's copies and conversion).
//   * The recurrence runs step by step in fp32: no exp(-la) or
//     exp(la_i - la_j) is ever formed, so it does not overflow where the
//     chunked form does. That chunked tensor-core form (the TPU kernel's)
//     was not taken: at the served S <= 152 it has at most two chunks of
//     128 to run in parallel, and it needs that factorisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_common.cuh"

namespace {

using attn::to_f;

template <typename T, int P, int NS>
struct Cfg {
  static constexpr int TS = 16;               // steps per tile
  static constexpr int R = 2;                 // rows per thread
  static constexpr int K = NS / 4;            // runs of 4 s values a row is cut into
  static constexpr int RB = R * (K >= 8 ? 4 : 32 / K);  // rows per CTA
  static constexpr int NT = RB / R * K;       // threads per CTA: K lanes a row block
  static constexpr int CTAS = P / RB;         // CTAs per head
  static constexpr int XPT = TS * RB / NT;    // x entries per thread a tile
  static_assert(R == 2 && P % RB == 0 && NT % 32 == 0 && TS * RB % NT == 0, "shape");
};

template <typename T, int P, int NS>
__global__ void __launch_bounds__(Cfg<T, P, NS>::NT, 1) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A_log,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    float* __restrict__ y, float* __restrict__ state, int S, int H,
    int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
    int64_t sBb, int64_t sBs, int64_t sCb, int64_t sCs) {
  using C = Cfg<T, P, NS>;
  constexpr int TS = C::TS;
  constexpr int NT = C::NT, R = C::R, K = C::K, RB = C::RB;
  // cp.async double buffer, in the input type; B_ and C_ are read from it
  __shared__ __align__(16) T Braw[2][TS][NS];
  __shared__ __align__(16) T Craw[2][TS][NS];
  __shared__ __align__(16) T Xraw[2][TS][RB];
  __shared__ __align__(16) float Xf[TS][RB];   // x
  __shared__ __align__(16) float DXf[TS][RB];  // dt x
  __shared__ float Af[TS];                     // a_t
  __shared__ __align__(16) float Ys[2][TS][RB];  // a tile's y, written out during the next tile

  const int tid = threadIdx.x;
  const int h = blockIdx.x / C::CTAS;
  const int p0 = (blockIdx.x % C::CTAS) * RB;
  const int b = blockIdx.y;
  const int run = tid % K, r0 = R * (tid / K);  // s in [4 run, 4 run + 4), rows r0 ..
  const T* xb = x + b * sxb + h * sxh + p0;
  const float* db = dt + b * sdb + h * sdh;
  const T* Bb = Bm + b * sBb;
  const T* Cb = Cm + b * sCb;
  const float neg_a = -expf(A_log[h]);
  const float Dh = D[h];
  float* yb = y + ((int64_t)b * S * H + h) * P + p0;  // y (B, S, H, P) contiguous

  const scan::RowCopies<NT, TS, NS, T> copyB(Bb, sBs), copyC(Cb, sCs);
  const scan::RowCopies<NT, TS, RB, T> copyX(xb, sxs);
  // the next tile's copies and dt; a tile past the end copies nothing
  auto issue = [&](int stage, int t0, float (&dtv)[C::XPT]) {
    copyB.issue(Braw[stage], sBs, t0, S);
    copyC.issue(Craw[stage], sCs, t0, S);
    copyX.issue(Xraw[stage], sxs, t0, S);
    attn::cp_async_commit();
    // dt of this thread's x entries (0 past S: a_t = 1 and dt x = 0 there,
    // so a padded step leaves the state as it is)
#pragma unroll
    for (int q = 0; q < C::XPT; ++q) {
      const int t = t0 + (tid + q * NT) / RB;
      dtv[q] = t < S ? db[(int64_t)t * sds] : 0.f;
    }
  };
  // y of tile t0 from Ys[buf] (nothing for t0 < 0): rows of RB floats,
  // four to a store, coalesced
  auto write_y = [&](int t0, int buf) {
    constexpr int Q = RB / 4;  // stores a row
    if (TS * Q % NT == 0 || tid < TS * Q) {
#pragma unroll
      for (int e = 0; e < (TS * Q + NT - 1) / NT; ++e) {
        const int i = (tid + e * NT) / Q, c = 4 * ((tid + e * NT) % Q);
        if (t0 + i >= 0 && t0 + i < S)
          scan::store4(yb + (int64_t)(t0 + i) * H * P + c, scan::load4(&Ys[buf][i][c]));
      }
    }
  };

  float st[R][4];  // H[p0 + r0 + rho, 4 run + e]
#pragma unroll
  for (int rho = 0; rho < R; ++rho) st[rho][0] = st[rho][1] = st[rho][2] = st[rho][3] = 0.f;

  float dt_next[C::XPT];  // dt of this thread's x entries, a tile ahead
  issue(0, 0, dt_next);
  const int ntiles = (S + TS - 1) / TS;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TS, stage = it & 1;
    attn::cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's readers are done
#pragma unroll
    for (int q = 0; q < C::XPT; ++q) {
      const int i = (tid + q * NT) / RB, r = (tid + q * NT) % RB;
      const float xv = to_f(Xraw[stage][i][r]);
      Xf[i][r] = xv;
      DXf[i][r] = dt_next[q] * xv;
      if (r == 0) Af[i] = expf(dt_next[q] * neg_a);
    }
    __syncthreads();

    // the steps of the tile, each step's operands read one step ahead so
    // that shared-memory latency overlaps the previous step's arithmetic;
    // the next tile's copies and the last tile's y are issued among them
    const T* Bt = &Braw[stage][0][4 * run];
    const T* Ct = &Craw[stage][0][4 * run];
    float yp[R * TS];  // partial y of (row r0 + rho, step i) at rho TS + i
    float a_n = Af[0];
    float2 dx_n = *reinterpret_cast<const float2*>(&DXf[0][r0]);
    float4 b_n = scan::load4(Bt), c_n = scan::load4(Ct);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const float a = a_n;
      const float dx[2] = {dx_n.x, dx_n.y};
      const float4 b4 = b_n, c4 = c_n;
      if (i + 1 < TS) {
        a_n = Af[i + 1];
        dx_n = *reinterpret_cast<const float2*>(&DXf[i + 1][r0]);
        b_n = scan::load4(Bt + (i + 1) * NS);
        c_n = scan::load4(Ct + (i + 1) * NS);
      }
      if (i == 1) {
        issue(stage ^ 1, t0 + TS, dt_next);
        write_y(t0 - TS, stage ^ 1);
      }
#pragma unroll
      for (int rho = 0; rho < R; ++rho) {
        float* h4 = st[rho];
        h4[0] = fmaf(a, h4[0], dx[rho] * b4.x);
        h4[1] = fmaf(a, h4[1], dx[rho] * b4.y);
        h4[2] = fmaf(a, h4[2], dx[rho] * b4.z);
        h4[3] = fmaf(a, h4[3], dx[rho] * b4.w);
        yp[rho * TS + i] = fmaf(h4[0], c4.x, h4[1] * c4.y) + fmaf(h4[2], c4.z, h4[3] * c4.w);
      }
    }
    scan::reduce_scatter<K>(yp, run);
#pragma unroll
    for (int j = 0; j < R * TS / K; ++j) {
      const int idx = run * (R * TS / K) + j;
      const int i = idx % TS, r = r0 + idx / TS;
      Ys[stage][i][r] = fmaf(Dh, Xf[i][r], yp[j]);
    }
  }
  attn::cp_async_wait<0>();  // the copies of the tile past the end
  __syncthreads();
  write_y((ntiles - 1) * TS, (ntiles - 1) & 1);
  // state (B, H, P, Ns) contiguous: this thread's 4 x R block
  float* sb = state + (((int64_t)b * H + h) * P + p0 + r0) * NS + 4 * run;
#pragma unroll
  for (int rho = 0; rho < R; ++rho)
    scan::store4(sb + rho * NS, make_float4(st[rho][0], st[rho][1], st[rho][2], st[rho][3]));
}

template <typename T, int P, int NS>
int launch(const void* x, const float* dt, const float* A_log, const void* Bm,
           const void* Cm, const float* D, float* y, float* state, int B, int S, int H,
           const int64_t* st, cudaStream_t stream) {
  dim3 grid(H * Cfg<T, P, NS>::CTAS, B);
  ssd_kernel<T, P, NS><<<grid, Cfg<T, P, NS>::NT, 0, stream>>>(
      static_cast<const T*>(x), dt, A_log, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, y, state, S, H, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int P, int NS, const void* x, const float* dt, const float* A_log,
             const void* Bm, const void* Cm, const float* D, float* y, float* state,
             int B, int S, int H, const int64_t* st, cudaStream_t stream) {
#define SSD_CASE(PP, NN)                                                          \
  if (P == PP && NS == NN)                                                        \
    return launch<T, PP, NN>(x, dt, A_log, Bm, Cm, D, y, state, B, S, H, st, stream);
  SSD_CASE(32, 16)
  SSD_CASE(32, 32)
  SSD_CASE(32, 64)
  SSD_CASE(64, 16)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B_, C_): 0 = float32, 1 = bfloat16. dt, A_log and D are
// float32. x (B, S, H, P) by element strides (b, s, h); dt (B, S, H) by
// (b, s, h); B_, C_ (B, S, Ns) by (b, s); last dims contiguous; x, B_ and
// C_ 16-byte aligned (data pointers and the strides of dims above 1); A_log,
// D (H,) contiguous. Writes y (B, S, H, P) float32 contiguous and the final
// state (B, H, P, Ns) float32 contiguous. Returns the launch's cudaError_t
// (0 = success).
extern "C" int ssd_fwd(
    const void* x, const void* dt, const void* A_log, const void* Bm, const void* Cm,
    const void* D, void* y, void* state, int dtype, int B, int S, int H, int P, int NS,
    int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
    int64_t sBb, int64_t sBs, int64_t sCb, int64_t sCs, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int64_t st[10] = {sxb, sxs, sxh, sdb, sds, sdh, sBb, sBs, sCb, sCs};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A_log);
  const float* df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, NS, x, dtf, af, Bm, Cm, df, yf, sf, B, S, H, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, NS, x, dtf, af, Bm, Cm, df, yf, sf, B, S, H, st, s);
  return (int)cudaErrorInvalidValue;
}
