// Decode attention (one query token against a KV cache) for Hopper, sm_90a.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (the Pallas
// TPU kernel `_decode_kernel`). Same function: for each sequence b and
// q head h, softmax over the first lengths[b] cache positions of
// q . k / sqrt(hd), times v; fp32 online softmax; the G q heads of one kv
// group are handled together, kv head = h // G.
//
// Design:
//   * grid (Hkv, B): one CTA per (kv head, sequence), 128 threads. The CTA
//     walks the cache in 32-position tiles up to lengths[b] (positions at
//     or past the length are masked; tiles past it are never read).
//   * the cache is read in the model layout (B, M, Hkv, hd) through
//     element strides, so the serving engine's per-layer cache view is
//     used in place: no (B, Hkv, M, hd) transpose of the whole cache per
//     step.
//   * batch invariance: every CTA sums in a fixed order (fixed thread ->
//     element mapping, fixed warp-shuffle trees, no atomics) that does not
//     depend on B, so a row of a mixed batch is bitwise equal to that row
//     decoded alone.
//
// What bounds it on an H100: memory. It reads 2*B*Hkv*len*hd cache
// elements for 4*B*Hq*hd*len flops (about one flop per byte in bf16), so
// the bound is the K/V bytes over 3.35 TB/s. At the serving path's shapes
// (B = 1, Hkv <= 16, len <= 192) only B*Hkv CTAs run and the kernel is
// latency-bound; splitting the cache across CTAs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 32;        // cache positions per tile (= warp width)
constexpr int NT = 128;       // threads per CTA (4 warps)
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, T* __restrict__ o, int M, int G, float scale,
    int64_t sqb, int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
    int64_t svb, int64_t svm, int64_t svh, int64_t sob, int64_t soh) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;               // [G][D]
  float* As = Qs + G * D;         // [G][D] accumulators
  float* Ks = As + G * D;         // [BK][DP]
  float* Vs = Ks + BK * DP;       // [BK][D]
  float* Ss = Vs + BK * D;        // [G][BK] scores, then probabilities
  float* Ms = Ss + G * BK;        // [G] running max
  float* Ls = Ms + G;             // [G] running denominator
  float* Al = Ls + G;             // [G] this tile's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int len = min(max(lengths[b], 0), M);

  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int p = tid; p < G * D; p += NT) {
    const int g = p / D, d = p % D;
    Qs[p] = to_f(q[b * sqb + (int64_t)(hk * G + g) * sqh + d]);
    As[p] = 0.f;
  }
  for (int g = tid; g < G; g += NT) {
    Ms[g] = NEG;
    Ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < len; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done (and init)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int s = k0 + c;
      const bool ok = s < len;
      Ks[c * DP + d] = ok ? to_f(kb[s * skm + d]) : 0.f;
      Vs[c * D + d] = ok ? to_f(vb[s * svm + d]) : 0.f;
    }
    __syncthreads();

    for (int p = tid; p < G * BK; p += NT) {
      const int g = p / BK, c = p % BK;
      const float* qg = Qs + g * D;
      const float* kc = Ks + c * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kc[d], dot);
      Ss[p] = (k0 + c < len) ? dot * scale : NEG;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float s = Ss[g * BK + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float pr = expf(s - m_new);
      Ss[g * BK + lane] = pr;
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Al[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    for (int p = tid; p < G * D; p += NT) {
      const int g = p / D, d = p % D;
      const float* pg = Ss + g * BK;
      float a = As[p] * Al[g];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) a = fmaf(pg[c], Vs[c * D + d], a);
      As[p] = a;
    }
  }
  __syncthreads();

  for (int p = tid; p < G * D; p += NT) {
    const int g = p / D, d = p % D;
    const float inv = 1.f / fmaxf(Ls[g], 1e-30f);
    from_f(o + b * sob + (int64_t)(hk * G + g) * soh + d, As[p] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           int B, int Hq, int Hkv, int M, const int64_t* st, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * G * D + BK * (D + 1) + BK * D + G * BK + 3 * G);
  auto kern = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), M, G, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, void* o, int B, int Hq, int Hkv, int M,
               const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, lengths, o, B, Hq, Hkv, M, st, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, o, B, Hq, Hkv, M, st, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, o, B, Hq, Hkv, M, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, hd) by strides (b, h);
// k, v (B, M, Hkv, hd) by strides (b, m, h); o (B, Hq, hd) by strides
// (b, h); last dims contiguous. lengths: (B,) int32 on the device.
// Returns the launch's cudaError_t (0 = success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    int dtype, int B, int Hq, int Hkv, int M, int D,
    int64_t sqb, int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
    int64_t svb, int64_t svm, int64_t svh, int64_t sob, int64_t soh,
    void* stream) {
  if (B <= 0 || M <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t st[10] = {sqb, sqh, skb, skm, skh, svb, svm, svh, sob, soh};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(D, q, k, v, len, o, B, Hq, Hkv, M, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, B, Hq, Hkv, M, st, s);
  return (int)cudaErrorInvalidValue;
}
