// RWKV6 (wkv6) recurrence for Hopper, sm_90a.
//
// Replaces repro/kernels/rwkv6.py::wkv6 (the Pallas TPU kernel
// `_wkv6_kernel`). Same function, per batch row b and head h, from a zero
// (N, N) fp32 state S:
//     y_t[m] = sum_n r_t[n] S[n, m] + (sum_n r_t[n] u[n] k_t[n]) v_t[m]
//     S[n, m] <- exp(w_t[n]) S[n, m] + k_t[n] v_t[m]
// returning y and the final state. Two deliberate differences from the TPU
// kernel: y comes out in fp32, as the model's chunked form
// (repro/models/rwkv.py::wkv6_chunked) returns it to the group norm, and
// there is no initial-state argument (every prefill starts at zero).
//
// Bound on an H100: three fp32 operations per state value and step (the
// product k v, the decay FMA, the y FMA) plus the bonus term, 5 N^2 + 5 N
// flops per head and step; at rwkv6-3b's prefill (H 40, N 64, B 1, S 152)
// that is 0.0019 ms at 67 TFLOP/s, above the time to move its bytes. The
// tensor cores do not bound it: a step is a rank-1 update and a
// vector-matrix product, with nothing to reuse across a step.
//
// What the first design (one CTA of N threads per (head, row), a state
// column in each thread) lost: at that shape 40 CTAs of two warps ran, 92
// SMs idle; each thread read four staged rows a step and recomputed the
// bonus sum_n r u k once per column; every 32 steps the CTA stopped at a
// barrier to load the next steps from memory (0.0524 ms on an H100 80GB
// HBM3 at 700 W).
//
// This design spreads each head's columns over N / CB CTAs, and each
// column's state over N / 4 threads:
//   * A thread holds a 4 x 2 block of the state: a run of 4 n values by 2
//     columns; the N / 4 threads of a column pair are adjacent lanes, and
//     a CTA of 64 threads holds CB = 8 columns of one head at N = 64. At
//     rwkv6-3b's layout: 320 CTAs of 2 warps at B = 1.
//   * An SM's shared memory hands out 32 words a cycle, so a step's words
//     per FMA matter: a block reads 4 r, 4 k (bf16: one 8-byte read each,
//     straight from the copy buffer), 4 exp(w) and 2 v, 10 words for 24
//     FMAs, where a thread holding a run of one column reads as many words
//     for half the FMAs.
//   * Steps go in tiles of TS = 16. r, k, w and the CTA's v columns of the
//     next tile are copied with 16-byte cp.async into the other half of a
//     double buffer while the current tile runs; a thread's copies are the
//     same rows and chunks in every tile, so their sources are set once.
//     One pass forms exp(w) and the bonus sum_n r u k once per step and
//     CTA, not once per column. Within the tile each step's operands are
//     read a step ahead, and the next tile's copies and the last tile's y
//     are issued among the steps.
//   * The state update is one FMA per value and step. The y sums of the
//     tile's steps are buffered in registers and reduced across the N / 4
//     lanes of a column pair in one reduce-scatter (N (1 - 4 / N) shuffles
//     for N = 2 TS sums), then written through a double-buffered shared
//     tile as coalesced 16-byte stores during the next tile.
//   * A tile past the end is zero-filled: exp(0) = 1 and k = 0 leave the
//     state unchanged.
//   * What holds it at ~12x its bound: at B = 1 there are only 2-3 CTAs of
//     2 warps an SM, so the chains of each step are poorly hidden, and the
//     once-per-CTA pass (exp(w), the bonus) and the reduce-scatter cost
//     about as much as the steps' FMAs.
//   * The recurrence runs step by step in fp32: no exp(-la) is formed, so it
//     does not overflow where the chunked form's k exp(-la) does. That
//     chunked tensor-core form (the TPU kernel's) was not taken: at the
//     served S <= 152 it has at most two chunks of 128 to run in parallel,
//     and the per-channel decay needs that factorisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "scan_common.cuh"

namespace {

using attn::to_f;

template <typename T, int N>
struct Cfg {
  static constexpr int TS = 16;               // steps per tile
  static constexpr int CM = 2;                // columns per thread
  static constexpr int K = N / 4;             // runs of 4 n values a column is cut into
  static constexpr int CB = K >= 8 ? 8 : 16;  // columns per CTA
  static constexpr int NT = CB / CM * K;      // threads per CTA: K lanes a column pair
  static constexpr int CTAS = N / CB;         // CTAs per head
  static constexpr int VPT = TS * CB / NT;    // v entries per thread a tile
  static constexpr int TPS = NT / TS;         // threads a step in the exp(w) / bonus pass
  static constexpr int NQ = N / TPS;          // n per thread in that pass
  static_assert(CM == 2 && N % CB == 0 && NT % 32 == 0 && NT % TS == 0 &&
                TS * CB % NT == 0 && NQ % 4 == 0, "shape");
};

template <typename T, int N>
__global__ void __launch_bounds__(Cfg<T, N>::NT, 1) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state, int S, int H,
    int64_t srb, int64_t srs, int64_t srh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t swb, int64_t sws, int64_t swh) {
  using C = Cfg<T, N>;
  constexpr int TS = C::TS;
  constexpr int NT = C::NT, CM = C::CM, K = C::K, CB = C::CB;
  // cp.async double buffer, in the input types; r and k are read from it
  __shared__ __align__(16) T Rraw[2][TS][N];
  __shared__ __align__(16) T Kraw[2][TS][N];
  __shared__ __align__(16) T Vraw[2][TS][CB];
  __shared__ __align__(16) float Wraw[2][TS][N];
  __shared__ __align__(16) float Wf[TS][N];   // exp(w)
  __shared__ __align__(16) float Vf[TS][CB];  // v
  __shared__ __align__(16) float Uf[N];
  __shared__ float Bon[TS];                   // sum_n r u k
  __shared__ __align__(16) float Ys[2][TS][CB];  // a tile's y, written out during the next tile

  const int tid = threadIdx.x;
  const int h = blockIdx.x / C::CTAS;
  const int m0 = (blockIdx.x % C::CTAS) * CB;
  const int b = blockIdx.y;
  const int run = tid % K, c0 = CM * (tid / K);  // n in [4 run, 4 run + 4), columns c0 ..
  const T* rb = r + b * srb + h * srh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh + m0;
  const float* wb = w + b * swb + h * swh;
  float* yb = y + ((int64_t)b * S * H + h) * N + m0;  // y (B, S, H, N) contiguous

  const scan::RowCopies<NT, TS, N, T> copyR(rb, srs), copyK(kb, sks);
  const scan::RowCopies<NT, TS, CB, T> copyV(vb, svs);
  const scan::RowCopies<NT, TS, N, float> copyW(wb, sws);
  // the next tile's copies; steps past S are zero-filled (exp(0) = 1 and
  // k = 0 leave the state as it is), and a tile past the end copies nothing
  auto issue = [&](int stage, int t0) {
    copyR.issue(Rraw[stage], srs, t0, S);
    copyK.issue(Kraw[stage], sks, t0, S);
    copyV.issue(Vraw[stage], svs, t0, S);
    copyW.issue(Wraw[stage], sws, t0, S);
    attn::cp_async_commit();
  };
  // y of tile t0 from Ys[buf] (nothing for t0 < 0): rows of CB floats,
  // four to a store, coalesced
  auto write_y = [&](int t0, int buf) {
    constexpr int Q = CB / 4;  // stores a row
    if (TS * Q % NT == 0 || tid < TS * Q) {
#pragma unroll
      for (int e = 0; e < (TS * Q + NT - 1) / NT; ++e) {
        const int i = (tid + e * NT) / Q, c = 4 * ((tid + e * NT) % Q);
        if (t0 + i >= 0 && t0 + i < S)
          scan::store4(yb + (int64_t)(t0 + i) * H * N + c, scan::load4(&Ys[buf][i][c]));
      }
    }
  };

  for (int n = tid; n < N; n += NT) Uf[n] = u[h * N + n];
  float st[CM][4];  // S[4 run + e, m0 + c0 + c]
#pragma unroll
  for (int c = 0; c < CM; ++c) st[c][0] = st[c][1] = st[c][2] = st[c][3] = 0.f;

  issue(0, 0);
  const int ntiles = (S + TS - 1) / TS;
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TS, stage = it & 1;
    attn::cp_async_wait<0>();
    __syncthreads();  // tile it landed; tile it-1's readers are done
    // exp(w) and the bonus, once per step and CTA: TPS threads a step
    {
      const int i = tid / C::TPS, part = tid % C::TPS;
      float bon = 0.f;
#pragma unroll
      for (int e = 0; e < C::NQ / 4; ++e) {
        const int n = part * C::NQ + 4 * e;
        const float4 r4 = scan::load4(&Rraw[stage][i][n]);
        const float4 k4 = scan::load4(&Kraw[stage][i][n]);
        const float4 w4 = scan::load4(&Wraw[stage][i][n]);
        const float4 u4 = scan::load4(&Uf[n]);
        scan::store4(&Wf[i][n], make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w)));
        bon = fmaf(r4.x * u4.x, k4.x, bon);
        bon = fmaf(r4.y * u4.y, k4.y, bon);
        bon = fmaf(r4.z * u4.z, k4.z, bon);
        bon = fmaf(r4.w * u4.w, k4.w, bon);
      }
#pragma unroll
      for (int o = C::TPS / 2; o >= 1; o /= 2) bon += __shfl_xor_sync(0xffffffffu, bon, o);
      if (part == 0) Bon[i] = bon;
    }
#pragma unroll
    for (int e = 0; e < C::VPT; ++e) {
      const int i = (tid + e * NT) / CB, c = (tid + e * NT) % CB;
      Vf[i][c] = to_f(Vraw[stage][i][c]);
    }
    __syncthreads();

    // the steps of the tile, each step's operands read one step ahead so
    // that shared-memory latency overlaps the previous step's arithmetic;
    // the next tile's copies and the last tile's y are issued among them
    const T* Rt = &Rraw[stage][0][4 * run];
    const T* Kt = &Kraw[stage][0][4 * run];
    float yp[CM * TS];  // partial y of (column c0 + c, step i) at c TS + i
    float4 r_n = scan::load4(Rt), k_n = scan::load4(Kt), w_n = scan::load4(&Wf[0][4 * run]);
    float2 v_n = *reinterpret_cast<const float2*>(&Vf[0][c0]);
#pragma unroll
    for (int i = 0; i < TS; ++i) {
      const float4 r4 = r_n, k4 = k_n, w4 = w_n;
      const float vm[2] = {v_n.x, v_n.y};
      if (i + 1 < TS) {
        r_n = scan::load4(Rt + (i + 1) * N);
        k_n = scan::load4(Kt + (i + 1) * N);
        w_n = scan::load4(&Wf[i + 1][4 * run]);
        v_n = *reinterpret_cast<const float2*>(&Vf[i + 1][c0]);
      }
      if (i == 1) {
        issue(stage ^ 1, t0 + TS);
        write_y(t0 - TS, stage ^ 1);
      }
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        float* s4 = st[c];
        yp[c * TS + i] = fmaf(r4.x, s4[0], r4.y * s4[1]) + fmaf(r4.z, s4[2], r4.w * s4[3]);
        s4[0] = fmaf(w4.x, s4[0], k4.x * vm[c]);
        s4[1] = fmaf(w4.y, s4[1], k4.y * vm[c]);
        s4[2] = fmaf(w4.z, s4[2], k4.z * vm[c]);
        s4[3] = fmaf(w4.w, s4[3], k4.w * vm[c]);
      }
    }
    scan::reduce_scatter<K>(yp, run);
#pragma unroll
    for (int j = 0; j < CM * TS / K; ++j) {
      const int idx = run * (CM * TS / K) + j;
      const int i = idx % TS, c = c0 + idx / TS;
      Ys[stage][i][c] = fmaf(Bon[i], Vf[i][c], yp[j]);
    }
  }
  attn::cp_async_wait<0>();  // the copies of the tile past the end
  __syncthreads();
  write_y((ntiles - 1) * TS, (ntiles - 1) & 1);
  // state (B, H, N, N) contiguous, S[n, m] at n N + m
  float* sb = state + ((int64_t)b * H + h) * N * N + (int64_t)(4 * run) * N + m0 + c0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int c = 0; c < CM; ++c) sb[e * N + c] = st[c][e];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           float* y, float* state, int B, int S, int H, const int64_t* st,
           cudaStream_t stream) {
  dim3 grid(H * Cfg<T, N>::CTAS, B);
  wkv6_kernel<T, N><<<grid, Cfg<T, N>::NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), w, u,
      y, state, S, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v, const float* w,
               const float* u, float* y, float* state, int B, int S, int H,
               const int64_t* st, cudaStream_t stream) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, state, B, S, H, st, stream);
    case 32: return launch<T, 32>(r, k, v, w, u, y, state, B, S, H, st, stream);
    case 64: return launch<T, 64>(r, k, v, w, u, y, state, B, S, H, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (of r, k, v): 0 = float32, 1 = bfloat16. w (log decay) and u are
// float32. r, k, v, w are (B, S, H, N) with element strides (b, s, h) in
// that order, last dim contiguous, 16-byte aligned (data pointers and the
// strides of dims above 1); u (H, N) contiguous. Writes y (B, S, H, N)
// float32 contiguous and the final state (B, H, N, N) float32 contiguous.
// Returns the launch's cudaError_t (0 = success).
extern "C" int wkv6_fwd(
    const void* r, const void* k, const void* v, const void* w, const void* u, void* y,
    void* state, int dtype, int B, int S, int H, int N,
    int64_t srb, int64_t srs, int64_t srh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t swb, int64_t sws, int64_t swh,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {srb, srs, srh, skb, sks, skh, svb, svs, svh, swb, sws, swh};
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_n<float>(N, r, k, v, wf, uf, yf, sf, B, S, H, st, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, wf, uf, yf, sf, B, S, H, st, s);
  return (int)cudaErrorInvalidValue;
}
