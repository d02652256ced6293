// Causal / full GQA flash attention (prefill) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`). Same function: softmax(q k^T / sqrt(hd)) v
// with an fp32 online softmax (running max, denominator, accumulator),
// causal mask col > row, kv head = h // G without materialising the
// repeat, output in the input type.
//
// Design (a plain, correct first kernel; wgmma/TMA come later):
//   * grid (ceil(S/64), Hq, B): one CTA per (q tile of 64 rows, q head,
//     batch row), 256 threads. The CTA loops over 64-row K/V tiles up to
//     the causal diagonal; tiles wholly above it are never loaded.
//   * q/k/v are read in the model layout (B, S, H, hd) through element
//     strides (last dim contiguous); no transposed copy is made.
//   * any S: the ragged q and k tails are masked here (the TPU kernel's
//     S % block assert was a Pallas constraint).
//   * tiles are staged in shared memory as fp32 (rows padded by one
//     float so the score loop's column reads hit distinct banks); scores
//     and P.V are fp32 FMAs on a 4x4 / 4x(hd/16) register micro-tile
//     (hd in {32, 64, 80, 128}; at zamba2's hd 80 the P.V tile is 4x5).
//
// What bounds it on an H100 at the serving path's shapes (S <= 152,
// B = 1): launch and latency — a few hundred CTA-tiles of FMA work.
// At long S it is operation-bound: 4*B*Hq*hd*S^2/2 flops against the
// card's 989 TFLOP/s bf16 tensor-core peak, which this FMA kernel does
// not reach; tensor-core tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BQ = 64;        // q rows per CTA
constexpr int BK = 64;        // k rows per tile
constexpr int NT = 256;       // threads per CTA (16 x 16)
constexpr float NEG = -1e30f; // mask value (finite, as the reference)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int S, int G, int causal, float scale,
    int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh,
    int64_t sob, int64_t sos, int64_t soh) {
  constexpr int DP = D + 1;      // padded row (floats)
  constexpr int DJ = D / 16;     // output dims per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][DP]
  float* Ks = Qs + BQ * DP;      // [BK][DP]
  float* Vs = Ks + BK * DP;      // [BK][D]
  float* Ps = Vs + BK * D;       // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int ty = tid / 16;       // row group: rows ty + 16*i
  const int tx = tid % 16;       // col group: cols tx + 16*j
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / G;

  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    Qs[r * DP + d] = s < S ? to_f(qb[s * sqs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // causal: the last tile that holds a column <= the CTA's last row
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // previous tile's readers are done (and Qs is ready)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int s = k0 + c;
      const bool ok = s < S;
      Ks[c * DP + d] = ok ? to_f(kb[s * sks + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f(vb[s * svs + d]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (col >= S || (causal && col > row)) s = NEG;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* ob = o + b * sob + s * sos + h * soh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) from_f(ob + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int causal, const int64_t* st, cudaStream_t stream) {
  constexpr int DP = D + 1;
  const size_t smem = sizeof(float) * (2 * BQ * DP + BK * D + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Hq / Hkv, causal, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
               int S, int Hq, int Hkv, int causal, const int64_t* st,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
    case 80: return launch<T, 80>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (elements), in order:
// q (b, s, h), k (b, s, h), v (b, s, h), o (b, s, h); last dim contiguous.
// Returns the launch's cudaError_t (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int Hq, int Hkv, int D, int causal,
    int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos, int64_t soh,
    void* stream) {
  if (B <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t st[12] = {sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
  return (int)cudaErrorInvalidValue;
}
