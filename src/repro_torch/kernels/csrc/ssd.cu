// Mamba-2 SSD scan for Hopper, sm_90a.
//
// Replaces repro/kernels/ssd.py::ssd (the Pallas TPU kernel `_ssd_kernel`).
// Same function, per batch row b and head h, from a zero (P, Ns) fp32
// state H, with B_t and C_t shared across heads (n_groups = 1):
//     a_t = exp(-dt_t exp(A_log[h]))
//     H[p, s] <- a_t H[p, s] + dt_t x_t[p] B_t[s]
//     y_t[p] = sum_s H[p, s] C_t[s] + D[h] x_t[p]
// returning y and the final state. The TPU kernel walks the sequence in
// chunks with a masked (C x C) decay matrix for its matrix unit; this one
// runs the recurrence itself, step by step, so it has no chunk-size
// constraint (any S) and never forms exp(la_i - la_j).
//
// Two deliberate differences from the TPU kernel:
//   * y comes out in fp32, not in the input type, as the model's chunked
//     form (repro/models/mamba.py::ssd_chunked) returns it; the model
//     rounds it itself where it gates it.
//   * no initial-state argument: every prefill of the model starts at zero.
//
// Design (a plain, correct first kernel; the chunked tensor-core form is
// later work):
//   * grid (H, B): one CTA per (head, batch row), P threads. Thread p holds
//     row p of the state in Ns registers for the whole sequence.
//   * x (B, S, H, P) and B_/C_ (B, S, Ns) are read in the model layout
//     through element strides (bf16 or fp32; last dim contiguous), dt
//     (B, S, H) fp32 likewise: the model's views of its projection are used
//     in place, with no copy.
//   * steps are staged TC at a time in shared memory (B_, C_, x, dt and the
//     decay a_t), loaded coalesced by all P threads; within a chunk of
//     steps no thread waits on another.
//
// What bounds it on an H100: at zamba2-2.7b's prefill (H 80, P 64, Ns 64,
// B 1, S <= 152) 80 CTAs of 2 warps run, each a chain of S dependent steps
// of ~3 Ns fp32 operations per thread: latency. The bound of the same work
// (about 5 P Ns flops per head and step at 67 TFLOP/s fp32, and the inputs
// and outputs over 3.35 TB/s) is a few microseconds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 32;  // steps staged per chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int P, int NS>
__global__ void __launch_bounds__(P) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A_log,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    float* __restrict__ y, float* __restrict__ state, int S, int H,
    int64_t sxb, int64_t sxs, int64_t sxh, int64_t sdb, int64_t sds, int64_t sdh,
    int64_t sBb, int64_t sBs, int64_t sCb, int64_t sCs) {
  __shared__ __align__(16) float Bs[TC][NS];
  __shared__ __align__(16) float Cs[TC][NS];
  __shared__ float Xs[TC][P];
  __shared__ float DTs[TC];
  __shared__ float As[TC];

  const int p = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const T* xb = x + b * sxb + h * sxh;
  const float* db = dt + b * sdb + h * sdh;
  const T* Bb = Bm + b * sBb;
  const T* Cb = Cm + b * sCb;
  const float neg_a = -expf(A_log[h]);
  const float Dh = D[h];
  float* yb = y + ((int64_t)b * S * H + h) * P + p;  // y (B, S, H, P) contiguous

  float st[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) st[s] = 0.f;

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int nt = min(TC, S - t0);
    __syncthreads();  // the previous chunk's readers are done
#pragma unroll 8
    for (int idx = p; idx < nt * NS; idx += P) {  // unrolled: loads in flight
      const int i = idx / NS, s = idx % NS;
      const int64_t t = t0 + i;
      Bs[i][s] = to_f(Bb[t * sBs + s]);
      Cs[i][s] = to_f(Cb[t * sCs + s]);
    }
#pragma unroll 8
    for (int i = 0; i < nt; ++i) Xs[i][p] = to_f(xb[(int64_t)(t0 + i) * sxs + p]);
    for (int i = p; i < nt; i += P) {
      const float d = db[(int64_t)(t0 + i) * sds];
      DTs[i] = d;
      As[i] = expf(d * neg_a);
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float xv = Xs[i][p];
      const float dtx = xv * DTs[i];
      const float a = As[i];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int s = 0; s < NS; s += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[i][s]);
        const float4 c4 = *reinterpret_cast<const float4*>(&Cs[i][s]);
        st[s + 0] = fmaf(a, st[s + 0], dtx * b4.x);
        st[s + 1] = fmaf(a, st[s + 1], dtx * b4.y);
        st[s + 2] = fmaf(a, st[s + 2], dtx * b4.z);
        st[s + 3] = fmaf(a, st[s + 3], dtx * b4.w);
        y0 = fmaf(st[s + 0], c4.x, y0);
        y1 = fmaf(st[s + 1], c4.y, y1);
        y2 = fmaf(st[s + 2], c4.z, y2);
        y3 = fmaf(st[s + 3], c4.w, y3);
      }
      yb[(int64_t)(t0 + i) * H * P] = ((y0 + y1) + (y2 + y3)) + Dh * xv;
    }
  }

  float* sb = state + (((int64_t)b * H + h) * P + p) * NS;  // state (B, H, P, Ns)
#pragma unroll
  for (int s = 0; s < NS; ++s) sb[s] = st[s];
}

template <typename T, int P, int NS>
int launch(const void* x, const float* dt, const float* A_log, const void* Bm,
           const void* Cm, const float* D, float* y, float* state, int B, int S, int H,
           const int64_t* st, cudaStream_t stream) {
  dim3 grid(H, B);
  ssd_kernel<T, P, NS><<<grid, P, 0, stream>>>(
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
// (b, s, h); B_, C_ (B, S, Ns) by (b, s); last dims contiguous; A_log, D
// (H,) contiguous. Writes y (B, S, H, P) float32 contiguous and the final
// state (B, H, P, Ns) float32 contiguous. Returns the launch's
// cudaError_t (0 = success).
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
