// One decode step of the Mamba-2 recurrence for Hopper, sm_90a, updating
// the state in place.
//
// Replaces no TPU kernel: the JAX package steps its state with plain jnp
// (repro/models/mamba.py::ssd_step), and so did the port, as five passes
// over the state (the decay product, the broadcast outer product, their
// sum, the einsum with C, the cache's copy). Same function as that step,
// per batch row b and head h, with B and C of the head's group
// g = h / (H / G):
//     a = exp(-dt exp(A_log[h]))
//     H[p, s] <- a H[p, s] + dt x[p] B_g[s]
//     y[p] = sum_s H[p, s] C_g[s] + D[h] x[p]
// all in fp32, the state read once and written back to the same memory.
//
// Bound on an H100: the bytes of the state. A (P, Ns) fp32 state is read
// and written once for 4 flops a value; at Nemotron-H-47B's decode (B 16,
// H 256, P 64, Ns 256) that is 2 x 268 MB a layer, 0.160 ms at 3.35 TB/s,
// against 0.016 ms for its flops at 67 TFLOP/s fp32. x, dt, B and C are a
// few KB.
//
// Design: a pure stream over the state.
//   * A CTA takes one (b, h) and its rows. A row of Ns values is spread
//     over L = min(32, Ns / 4) lanes, each holding V4 = Ns / (4 L) float4
//     runs of it, so a warp pass covers R = 32 / L rows and every load and
//     store is 16 bytes a lane, neighbouring lanes on neighbouring
//     addresses. The CTA has as many warps as cover the head's rows in one
//     iteration, up to 16: at Nemotron-H-47B's decode 16 warps take 32 rows
//     an iteration, which ran at 0.1837 ms (87.5% of the bound) where 4
//     warps ran at 0.1927 and 8 at 0.1884 (an H100 80GB HBM3 at 700 W,
//     timed side by side).
//   * Each lane loads the B_g and C_g values of its columns once, into
//     registers; the CTA's rows all use them.
//   * A warp loads U passes (4 float4 a lane) before it computes any, so
//     enough loads are in flight to cover the memory's latency. The state
//     is read with __ldcs and written with __stcs (evict-first): 6.4 GB a
//     step cannot stay in the 50 MB L2.
//   * y[p] is the sum over the row's L lanes, by xor shuffles.
//   * At a small batch (B H CTAs too few to fill the card) a head's rows
//     are split over more CTAs, as long as each gets an iteration.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using attn::to_f;

constexpr int kMaxWarps = 16;   // warps a CTA at most
constexpr int kMinCtas = 1024;  // split heads' rows over CTAs up to this many

template <int NS>
struct Cfg {
  static constexpr int L = NS / 4 < 32 ? NS / 4 : 32;  // lanes a row
  static constexpr int V4 = NS / (4 * L);             // float4 runs a lane holds of a row
  static constexpr int R = 32 / L;                     // rows a warp pass
  static constexpr int U = V4 >= 4 ? 1 : 4 / V4;       // passes loaded before computing
  static constexpr int WROWS = R * U;                  // rows a warp iteration
  static_assert(NS % 4 == 0 && L * R == 32 && L * 4 * V4 == NS, "shape");
};

template <typename T, int NS>
__global__ void __launch_bounds__(kMaxWarps * 32) ssd_step_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A_log,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    float* __restrict__ y, float* __restrict__ state, int H, int HPG, int P, int64_t sxb,
    int64_t sxh, int64_t sdb, int64_t sdh, int64_t sBb, int64_t sBg, int64_t sCb,
    int64_t sCg) {
  using C = Cfg<NS>;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H, g = h / HPG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = (blockDim.x >> 5) * C::WROWS;  // rows a CTA iteration
  const int sub = lane / C::L, col4 = lane % C::L;  // row in the pass, float4 column

  const float dtv = dt[b * sdb + h * sdh];
  const float a = expf(-dtv * expf(A_log[h]));
  const float Dh = D[h];
  const T* xp = x + b * sxb + h * sxh;
  const T* bp = Bm + b * sBb + g * sBg;
  const T* cp = Cm + b * sCb + g * sCg;
  float4 bv[C::V4], cv[C::V4];
#pragma unroll
  for (int k = 0; k < C::V4; ++k) {
    const int c = 4 * (col4 + k * C::L);
    bv[k] = make_float4(to_f(bp[c]), to_f(bp[c + 1]), to_f(bp[c + 2]), to_f(bp[c + 3]));
    cv[k] = make_float4(to_f(cp[c]), to_f(cp[c + 1]), to_f(cp[c + 2]), to_f(cp[c + 3]));
  }
  float4* st = reinterpret_cast<float4*>(state + (int64_t)bh * P * NS);
  float* yp = y + (int64_t)bh * P;

  for (int r0 = blockIdx.y * rows + warp * C::WROWS; r0 < P; r0 += gridDim.y * rows) {
    float4 s[C::U][C::V4];
    float xv[C::U];
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int row = r0 + u * C::R + sub;
      const bool ok = row < P;
      xv[u] = ok ? to_f(xp[row]) : 0.f;
#pragma unroll
      for (int k = 0; k < C::V4; ++k)
        s[u][k] = ok ? __ldcs(st + row * (NS / 4) + col4 + k * C::L) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < C::U; ++u) {
      const int row = r0 + u * C::R + sub;
      const float dtx = dtv * xv[u];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < C::V4; ++k) {
        float4 v = s[u][k];
        v.x = fmaf(a, v.x, dtx * bv[k].x);
        v.y = fmaf(a, v.y, dtx * bv[k].y);
        v.z = fmaf(a, v.z, dtx * bv[k].z);
        v.w = fmaf(a, v.w, dtx * bv[k].w);
        acc = fmaf(v.x, cv[k].x, acc);
        acc = fmaf(v.y, cv[k].y, acc);
        acc = fmaf(v.z, cv[k].z, acc);
        acc = fmaf(v.w, cv[k].w, acc);
        if (row < P) __stcs(st + row * (NS / 4) + col4 + k * C::L, v);
      }
#pragma unroll
      for (int off = C::L / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (col4 == 0 && row < P) yp[row] = acc + Dh * xv[u];
    }
  }
}

template <typename T, int NS>
int launch(const void* x, const float* dt, const float* A_log, const void* Bm,
           const void* Cm, const float* D, float* y, float* state, int B, int H, int HPG,
           int P, const int64_t* st, cudaStream_t stream) {
  const int64_t heads = (int64_t)B * H;
  if (heads > 0x7fffffff) return (int)cudaErrorInvalidValue;
  constexpr int wrows = Cfg<NS>::WROWS;
  const int warps = std::min(kMaxWarps, (P + wrows - 1) / wrows);
  const int rows = warps * wrows;
  int splits = 1;
  while ((splits * 2 - 1) * rows < P && heads * splits < kMinCtas) splits *= 2;
  dim3 grid((unsigned)heads, splits);
  ssd_step_kernel<T, NS><<<grid, warps * 32, 0, stream>>>(
      static_cast<const T*>(x), dt, A_log, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, y, state, H, HPG, P, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int NS, const void* x, const float* dt, const float* A_log, const void* Bm,
             const void* Cm, const float* D, float* y, float* state, int B, int H, int HPG,
             int P, const int64_t* st, cudaStream_t stream) {
#define SSD_STEP_CASE(NN) \
  if (NS == NN) return launch<T, NN>(x, dt, A_log, Bm, Cm, D, y, state, B, H, HPG, P, st, stream);
  SSD_STEP_CASE(16)
  SSD_STEP_CASE(32)
  SSD_STEP_CASE(64)
  SSD_STEP_CASE(128)
  SSD_STEP_CASE(256)
#undef SSD_STEP_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B_, C_): 0 = float32, 1 = bfloat16. dt, A_log and D are
// float32. x (B, H, P) by element strides (b, h), its last dim contiguous;
// dt (B, H) by (b, h); B_, C_ (B, G, Ns) by (b, g), last dims contiguous,
// G dividing H, head h reading group h / (H / G); A_log, D (H,)
// contiguous. state (B, H, P, Ns) float32 contiguous and 16-byte aligned,
// updated in place; y (B, H, P) float32 contiguous, written. Returns the
// launch's cudaError_t (0 = success).
extern "C" int ssd_step_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                            const void* Cm, const void* D, void* y, void* state, int dtype,
                            int B, int H, int G, int P, int NS, int64_t sxb, int64_t sxh,
                            int64_t sdb, int64_t sdh, int64_t sBb, int64_t sBg, int64_t sCb,
                            int64_t sCg, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || P <= 0 || H % G) return (int)cudaErrorInvalidValue;
  const int64_t st[8] = {sxb, sxh, sdb, sdh, sBb, sBg, sCb, sCg};
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A_log);
  const float* df = static_cast<const float*>(D);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(state);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hpg = H / G;
  if (dtype == 0) return dispatch<float>(NS, x, dtf, af, Bm, Cm, df, yf, sf, B, H, hpg, P, st, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(NS, x, dtf, af, Bm, Cm, df, yf, sf, B, H, hpg, P, st, s);
  return (int)cudaErrorInvalidValue;
}
