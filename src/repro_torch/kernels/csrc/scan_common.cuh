// Pieces shared by the two prefill scans (ssd.cu, wkv6.cu) for Hopper,
// sm_90a: the tile of steps, its cp.async copies, and four-wide reads and
// writes of staged rows.
//
// Both kernels spread a head's state over CTAs and within a CTA over
// threads. A thread holds a 4 x R block of its head's state: 4 values along
// the reduced index (s for ssd, n for wkv6) for each of R state rows
// (ssd) or columns (wkv6). Shared memory hands a warp 32 words a cycle, so
// what bounds a step is the words a thread reads per FMA: a block reads the
// 4 staged values of its run once for all R rows or columns. The partial y
// sums of a tile are reduced across the lanes that share a row or column
// once per tile, by a reduce-scatter, not by a shuffle tree every step.
// Steps go a tile of TS at a time: the next tile's inputs are copied with
// cp.async while the current one runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace scan {

// four staged values from p (16-byte aligned for fp32, 8-byte for bf16:
// one 8-byte shared read, widened by shifts, exact)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// The cp.async copies of one input's rows, a tile of TS steps at a time: W
// elements of type T a step, from `base` (the CTA's row at step 0) with a
// step stride of `stride` elements, into dst[i][0 .. W) for step t0 + i.
// W * sizeof(T) is a power-of-two multiple of 16. Each thread's copies are
// the same steps and chunks in every tile, so their sources are set once
// and a tile adds t0 * stride, the same for every thread. Steps at or past
// S are zero-filled (and read nothing), so a tile past the end is harmless.
template <int NT, int TS, int W, typename T>
struct RowCopies {
  static constexpr int E = 16 / sizeof(T), CPS = W / E, TOTAL = TS * CPS;
  static constexpr int PER = (TOTAL + NT - 1) / NT;  // copies per thread a tile
  static_assert(W % E == 0 && (CPS & (CPS - 1)) == 0, "row width");
  const T* src[PER];

  __device__ __forceinline__ RowCopies(const T* base, int64_t stride) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * NT;
      src[k] = base + (idx / CPS) * stride + (idx % CPS) * E;
    }
  }

  __device__ __forceinline__ void issue(T (*dst)[W], int64_t stride, int t0, int S) const {
    const int64_t off = t0 * stride;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = threadIdx.x + k * NT;
      if (TOTAL % NT == 0 || idx < TOTAL) {
        const bool ok = t0 + idx / CPS < S;
        attn::cp_async16(&dst[idx / CPS][(idx % CPS) * E], ok ? src[k] + off : src[k], ok);
      }
    }
  }
};

// Reduce-scatter of N partial sums over the L lanes that share them (L a
// power of two dividing N and 32, lanes adjacent in the warp, `lane` = warp
// lane mod L): each level halves the values a lane keeps and adds its
// partner's half, so it costs N (1 - 1/L) shuffles in all instead of
// N log2 L. After it, v[j] for j < N / L holds the full sum of entry
// lane * (N / L) + j.
template <int N, int C, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float (&v)[N], int lane) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float lo = v[i], hi = v[i + C / 2];
      const float give = upper ? lo : hi;
      const float keep = upper ? hi : lo;
      v[i] = keep + __shfl_xor_sync(0xffffffffu, give, O);
    }
    ReduceScatter<N, C / 2, O / 2>::run(v, lane);
  }
};
template <int N, int C>
struct ReduceScatter<N, C, 0> {
  static __device__ __forceinline__ void run(float (&)[N], int) {}
};

template <int L, int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  static_assert(L >= 1 && (L & (L - 1)) == 0 && N % L == 0 && 32 % L == 0, "lanes");
  ReduceScatter<N, N, L / 2>::run(v, lane);
}

}  // namespace scan
