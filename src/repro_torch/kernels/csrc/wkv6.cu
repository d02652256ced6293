// RWKV6 (wkv6) recurrence for Hopper, sm_90a.
//
// Replaces repro/kernels/rwkv6.py::wkv6 (the Pallas TPU kernel
// `_wkv6_kernel`). Same function, per batch row b and head h, from a zero
// (N, N) fp32 state S:
//     y_t[m] = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
//     S[n, m] <- exp(w_t[n]) S[n, m] + k_t[n] v_t[m]
// returning y and the final state. The TPU kernel walks the sequence in
// chunks with a decay factorisation for its matrix unit; this one runs the
// recurrence itself, step by step, so it has no chunk-size constraint (any
// S) and none of the factorisation's overflow: exp(-la) is never formed.
//
// Two deliberate differences from the TPU kernel:
//   * y comes out in fp32, not in the input type. The model's chunked form
//     (repro/models/rwkv.py::wkv6_chunked) returns fp32 y to the group norm
//     and the gate; the TPU kernel's cast would round it to bf16 first.
//   * no initial-state argument: every prefill of the model starts at zero.
//
// Design (a plain, correct first kernel; the chunked tensor-core form is
// later work):
//   * grid (H, B): one CTA per (head, batch row), N threads. Thread m holds
//     column m of the state in N registers for the whole sequence.
//   * r, k, v are read in the model layout (B, S, H, N) through element
//     strides (bf16 or fp32; last dim contiguous), w_log (fp32) likewise;
//     no transposed copy is made.
//   * steps are staged TC at a time in shared memory: r, k, exp(w), u*k and
//     v for TC steps, loaded coalesced by all N threads. Within a chunk of
//     steps no thread waits on another: thread m reads the staged rows
//     (broadcast) and its own state column only.
//
// What bounds it on an H100: at rwkv6-3b's prefill (H 40, N 64, B 1,
// S <= 152) only 40 CTAs of 2 warps run, each a chain of S dependent steps
// of ~5 N fp32 operations per thread: latency. The bound of the same work
// (about 5 N^2 flops per head and step at 67 TFLOP/s fp32, and the inputs
// and outputs over 3.35 TB/s) is a few microseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 32;  // steps staged per chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int N>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ state, int S, int H,
    int64_t srb, int64_t srs, int64_t srh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t swb, int64_t sws, int64_t swh) {
  __shared__ __align__(16) float Rs[TC][N];
  __shared__ __align__(16) float Ks[TC][N];
  __shared__ __align__(16) float Ws[TC][N];  // exp(w_log)
  __shared__ __align__(16) float Us[TC][N];  // u * k
  __shared__ float Vs[TC][N];

  const int m = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* rb = r + b * srb + h * srh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const float* wb = w + b * swb + h * swh;
  const float um = u[h * N + m];
  float* yb = y + ((int64_t)b * S * H + h) * N + m;  // y (B, S, H, N) contiguous

  float st[N];
#pragma unroll
  for (int n = 0; n < N; ++n) st[n] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int nt = min(TC, S - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 8
    for (int i = 0; i < nt; ++i) {  // unrolled: 8 steps' loads in flight
      const int64_t t = t0 + i;
      const float kv = to_f(kb[t * sks + m]);
      Rs[i][m] = to_f(rb[t * srs + m]);
      Ks[i][m] = kv;
      Ws[i][m] = expf(wb[t * sws + m]);
      Us[i][m] = um * kv;
      Vs[i][m] = to_f(vb[t * svs + m]);
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float vm = Vs[i][m];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int n = 0; n < N; n += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&Rs[i][n]);
        const float4 k4 = *reinterpret_cast<const float4*>(&Ks[i][n]);
        const float4 w4 = *reinterpret_cast<const float4*>(&Ws[i][n]);
        const float4 u4 = *reinterpret_cast<const float4*>(&Us[i][n]);
        y0 = fmaf(r4.x, fmaf(u4.x, vm, st[n + 0]), y0);
        y1 = fmaf(r4.y, fmaf(u4.y, vm, st[n + 1]), y1);
        y2 = fmaf(r4.z, fmaf(u4.z, vm, st[n + 2]), y2);
        y3 = fmaf(r4.w, fmaf(u4.w, vm, st[n + 3]), y3);
        st[n + 0] = fmaf(w4.x, st[n + 0], k4.x * vm);
        st[n + 1] = fmaf(w4.y, st[n + 1], k4.y * vm);
        st[n + 2] = fmaf(w4.z, st[n + 2], k4.z * vm);
        st[n + 3] = fmaf(w4.w, st[n + 3], k4.w * vm);
      }
      yb[(int64_t)(t0 + i) * H * N] = (y0 + y1) + (y2 + y3);
    }
  }

  float* sb = state + ((int64_t)b * H + h) * N * N + m;  // state (B, H, N, N)
#pragma unroll
  for (int n = 0; n < N; ++n) sb[n * N] = st[n];
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const float* w, const float* u,
           float* y, float* state, int B, int S, int H, const int64_t* st,
           cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_kernel<T, N><<<grid, N, 0, stream>>>(
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
// that order, last dim contiguous; u (H, N) contiguous. Writes y
// (B, S, H, N) float32 contiguous and the final state (B, H, N, N) float32
// contiguous. Returns the launch's cudaError_t (0 = success).
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
