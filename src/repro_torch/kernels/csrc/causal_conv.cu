// The Mamba-2 mixer's depthwise causal conv over K = 4 taps, its bias and
// SiLU, in one pass, for Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package convolves with plain jnp
// (repro/models/mamba.py::_causal_conv), and so did the port, in plain
// PyTorch over (B, S, CH): a concatenation of the carry and the strided
// input, then for each tap a copy of a shifted slice to fp32, a product and
// a sum into an fp32 accumulator, then the bias, SiLU and a copy back to
// the served dtype. At Nemotron-H-47B's prefill (B 16, S 1,549, CH 20,480,
// bf16) that took 28.2 ms a layer. Same function here, per batch row b,
// step t and channel c, the sum in the plain version's order and rounding
// (each product rounded, then added, no fused multiply-add):
//     a = (((x[t-3] w0 + x[t-2] w1) + x[t-1] w2) + x[t] w3) + b
//     y[t, c] = a / (1 + exp(-a))
// x[t < 0] taken from the carry `prev` (B, 3, CH), or zeros without one,
// all in fp32, y in x's dtype; and the new carry, the last 3 rows of
// [prev, x]. exp is the accurate expf and the division correctly rounded,
// as PyTorch's SiLU computes them, so y is the plain conv's bit for bit.
//
// Bound on an H100: the bytes. x is read once and y written once, 2 x 1.0
// GB a layer at that shape in bf16, 0.61 ms at 3.35 TB/s. Its ~12 fp32
// operations a value are a seventh of that at 67 TFLOP/s, but the
// instructions around them (conversions, exp, the division, addressing)
// are not far below it, so the loads must not wait on the arithmetic.
//
// Design: a stream, its loads decoupled from its arithmetic.
//   * A thread owns 8 channels (one 16-byte vector in bf16, two in fp32)
//     over a tile of kTile steps; a CTA's threads take neighbouring
//     channels, so a warp reads and writes whole 512-byte (bf16) runs of a
//     row. CTAs walk a channel range's tiles in order, so a tile's 3 rows
//     of halo were read by its neighbour just before (from L2).
//   * The thread copies its rows into its own slots of a shared-memory
//     ring with cp.async, kBatch rows a stage and kStages stages, and
//     computes a stage while the next ones load: no other thread reads its
//     slots, so nothing but its own cp.async waits orders them. Holding
//     the rows in registers instead (8 at a time) kept too few loads in
//     flight: 1.48 ms.
//   * A full batch of kBatch rows, every one but a tile's last, runs
//     without bound checks, its pointers advanced by a stride: 0.756 ms
//     against 0.812 ms with a check and an index product a row.
//   * The 3 earlier inputs stay in registers and slide along the tile;
//     the taps and the bias are loaded once a thread.
//   * x and the carry are read through their strides (the model's column
//     slice of the in_proj output, used in place); the launcher refuses an
//     x whose pointer or row strides are not 16-byte aligned (the model's
//     are). The carry's 3 rows are read element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using attn::from_f;
using attn::to_f;

constexpr int kK = 4;          // taps
constexpr int kC = 8;          // channels a thread
constexpr int kThreads = 128;  // threads a CTA, along the channels
constexpr int kTile = 64;      // steps a thread
constexpr int kBatch = 4;      // rows a stage of the ring
constexpr int kStages = 3;     // stages of the ring
// (kStages, kBatch) (2, 8), (3, 4), (4, 4), (4, 2) all ran within 0.3% at
// the cell's shape; 64-step tiles against 32 1.5% faster

// 8 values of T, 16-byte aligned: one uint4 in bf16, two in fp32
template <typename T>
struct alignas(16) Pack {
  T v[kC];
};

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[kC]) {
  Pack<T> out;
#pragma unroll
  for (int i = 0; i < kC; ++i) from_f(&out.v[i], v[i]);
  *reinterpret_cast<Pack<T>*>(p) = out;
}

// x[t - 3], x[t - 2], x[t - 1] and x[t] (in h and x) through the taps,
// the bias and SiLU
__device__ __forceinline__ float conv_silu(const float (&h)[kK - 1][kC],
                                           const float (&w)[kK][kC], const float (&b)[kC],
                                           float x, int i) {
  float a = __fmul_rn(h[0][i], w[0][i]);
#pragma unroll
  for (int k = 1; k < kK - 1; ++k) a = __fadd_rn(a, __fmul_rn(h[k][i], w[k][i]));
  a = __fadd_rn(a, __fmul_rn(x, w[kK - 1][i]));
  a = __fadd_rn(a, b[i]);
  return a / (1.f + expf(-a));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) causal_conv_kernel(
    const T* __restrict__ x, const T* __restrict__ prev, const float* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ y, T* __restrict__ carry, int S, int CH,
    int tiles, int64_t sxb, int64_t sxs, int64_t spb, int64_t sps) {
  __shared__ Pack<T> ring[kStages][kBatch][kThreads];
  const int tile = blockIdx.x % tiles;
  const int c = ((blockIdx.x / tiles) * kThreads + threadIdx.x) * kC;
  if (c >= CH) return;
  const int b = blockIdx.y;
  const int t0 = tile * kTile;
  const int t1 = min(S, t0 + kTile);
  const T* xb = x + b * sxb + c;

  // the tile's next rows, n of them (kBatch but at the tile's end), into
  // stage st of this thread's slots
  const T* next = xb + t0 * sxs;
  auto copy = [&](int n, int st) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u >= n) break;
      const uint4* src = reinterpret_cast<const uint4*>(next);
      uint4* dst = reinterpret_cast<uint4*>(&ring[st][u][threadIdx.x]);
#pragma unroll
      for (int q = 0; q < (int)sizeof(Pack<T>) / 16; ++q) attn::cp_async16(dst + q, src + q, true);
      next += sxs;
    }
  };
  int tn = t0;  // the first row not yet copied
  auto stage = [&](int st) {
    if (tn + kBatch <= t1) {
      copy(kBatch, st);  // unrolled with n known: no check
    } else {
      copy(t1 - tn, st);
    }
    tn += kBatch;
    attn::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) stage(st);

  float wv[kK][kC], bv[kC];
#pragma unroll
  for (int k = 0; k < kK; ++k)
#pragma unroll
    for (int i = 0; i < kC; ++i) wv[k][i] = w[k * CH + c + i];
#pragma unroll
  for (int i = 0; i < kC; ++i) bv[i] = bias[c + i];
  // h[k] holds x[t - (kK - 1) + k] for the step t about to be computed
  float h[kK - 1][kC];
#pragma unroll
  for (int k = 0; k < kK - 1; ++k) {
    const int t = t0 - (kK - 1) + k;
    const T* src = t >= 0 ? xb + t * sxs
                          : prev != nullptr ? prev + b * spb + (kK - 1 + t) * sps + c : nullptr;
#pragma unroll
    for (int i = 0; i < kC; ++i) h[k][i] = src != nullptr ? to_f(src[i]) : 0.f;
  }

  T* yd = y + ((int64_t)b * S + t0) * CH + c;
  // n rows of stage st through the taps, y written, the window slid
  auto rows = [&](int n, int st) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u >= n) break;
      const Pack<T> p = ring[st][u][threadIdx.x];
      float xt[kC], out[kC];
#pragma unroll
      for (int i = 0; i < kC; ++i) {
        xt[i] = to_f(p.v[i]);
        out[i] = conv_silu(h, wv, bv, xt[i], i);
      }
      store8<T>(yd, out);
      yd += CH;
#pragma unroll
      for (int i = 0; i < kC; ++i) {
#pragma unroll
        for (int k = 0; k < kK - 2; ++k) h[k][i] = h[k + 1][i];
        h[kK - 2][i] = xt[i];
      }
    }
  };
  int st = 0;
  for (int t = t0; t < t1; t += kBatch) {
    stage((st + kStages - 1) % kStages);
    attn::cp_async_wait<kStages - 1>();
    if (t + kBatch <= t1) {
      rows(kBatch, st);
    } else {
      rows(t1 - t, st);
    }
    st = (st + 1) % kStages;
  }
  if (t1 == S) {  // the last tile: its window is the last kK - 1 rows of [prev, x]
    T* cb = carry + (int64_t)b * (kK - 1) * CH + c;
#pragma unroll
    for (int k = 0; k < kK - 1; ++k) store8<T>(cb + (int64_t)k * CH, h[k]);
  }
}

template <typename T>
int launch(const void* x, const void* prev, const float* w, const float* bias, void* y,
           void* carry, int B, int S, int CH, const int64_t* st, cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  const int64_t ctas = (int64_t)((CH / kC + kThreads - 1) / kThreads) * tiles;
  if (ctas > 0x7fffffff || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)ctas, B);
  causal_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(prev), w, bias, static_cast<T*>(y),
      static_cast<T*>(carry), S, CH, tiles, st[0], st[1], st[2], st[3]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, prev, y and carry): 0 = float32, 1 = bfloat16. x (B, S, CH)
// by element strides (b, s), its channels contiguous, its pointer and
// strides 16-byte aligned; prev (B, K - 1, CH) by (b, k), its channels
// contiguous, or null for zeros; w (K, CH) and bias (CH,) float32
// contiguous; y (B, S, CH) and carry (B, K - 1, CH) contiguous and 16-byte
// aligned, written. K must be 4, CH a multiple of 8,
// S at least 1. Returns the launch's cudaError_t (0 = success).
extern "C" int causal_conv_fwd(const void* x, const void* prev, const void* w, const void* bias,
                               void* y, void* carry, int dtype, int B, int S, int CH, int K,
                               int64_t sxb, int64_t sxs, int64_t spb, int64_t sps,
                               void* stream) {
  if (B <= 0 || S <= 0 || CH <= 0 || CH % kC || K != kK) return (int)cudaErrorInvalidValue;
  const int64_t st[4] = {sxb, sxs, spb, sps};
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, prev, wf, bf, y, carry, B, S, CH, st, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, prev, wf, bf, y, carry, B, S, CH, st, s);
  return (int)cudaErrorInvalidValue;
}
