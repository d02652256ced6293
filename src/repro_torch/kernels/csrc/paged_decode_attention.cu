// Paged decode attention (one query token against K/V held in a shared page
// pool, reached through a page table) for Hopper, sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention (the
// Pallas TPU kernel `_paged_kernel`). Same function: for each sequence b and
// q head h, softmax over the first lengths[b] positions of q . k / sqrt(hd),
// times v, where position s lives at pool row page_table[b, s / ps], slot
// s % ps of the (N, ps, Hkv, hd) slabs. Table entries below 0 (the -1 past a
// sequence's last page) are clamped to row 0, as the TPU kernel's index map
// does, and positions at or past the length are masked. fp32 online softmax.
//
// Design: the dense decode kernel (decode_attention.cu) with one change, the
// address of each cache position.
//   * grid (Hkv, B): one CTA per (kv head, sequence), 128 threads; the G q
//     heads of a group are handled together.
//   * the CTA walks the positions in 32-position tiles up to lengths[b]. The
//     TPU kernel gets the page rows by scalar prefetch ahead of the grid; on
//     Hopper the block reads its own table. With pages of 32 positions or
//     more (ps a multiple of 32), a tile lies inside one page: one table
//     read per tile, then the dense kernel's address arithmetic. With
//     smaller pages a tile spans 32/ps pages and each position reads its
//     own row; that path is slower, since every load's address waits on a
//     table read. Rows at or past N are clamped to N - 1 so that a bad
//     table cannot read outside the slabs.
//   * the tile width, the thread -> element mapping, the shuffle trees and
//     the order of every sum are the dense kernel's, so the result is
//     bitwise equal to decode_attention on the cache gathered in table order,
//     and bitwise batch-invariant (no atomics, nothing depends on B).
//
// What bounds it on an H100: memory. It reads 2*B*Hkv*len*hd K/V elements
// for 4*B*Hq*hd*len flops (about one flop per byte in bf16), so the bound is
// the K/V bytes over 3.35 TB/s. At the prefix path's shapes (B = 4,
// Hkv <= 16, len <= 192) only B*Hkv CTAs run and the kernel is
// latency-bound, like the dense one; split-K and cp.async/TMA pipelining of
// the page loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BK = 32;        // positions per tile (= warp width)
constexpr int NT = 128;       // threads per CTA (4 warps)
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ table, const int* __restrict__ lengths, T* __restrict__ o,
    int N, int ps, int P, int G, float scale,
    int64_t sqb, int64_t sqh, int64_t skn, int64_t skp, int64_t skh,
    int64_t svn, int64_t svp, int64_t svh, int64_t sob, int64_t soh) {
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
  const int len = min(max(lengths[b], 0), P * ps);
  const int* tb = table + (int64_t)b * P;

  const T* kh = k + hk * skh;
  const T* vh = v + hk * svh;

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
    if (ps % BK == 0) {
      // pages of 32 positions or more: the tile lies inside one page, so one
      // table read gives every position's address
      const int row = min(max(tb[k0 / ps], 0), N - 1);
      const T* kt = kh + row * skn + (k0 % ps) * skp;
      const T* vt = vh + row * svn + (k0 % ps) * svp;
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int c = idx / D, d = idx % D;
        const bool ok = k0 + c < len;
        Ks[c * DP + d] = ok ? to_f(kt[c * skp + d]) : 0.f;
        Vs[c * D + d] = ok ? to_f(vt[c * svp + d]) : 0.f;
      }
    } else {
      // smaller pages: the tile spans several; each position reads its row
      for (int idx = tid; idx < BK * D; idx += NT) {
        const int c = idx / D, d = idx % D;
        const int s = k0 + c;
        float kx = 0.f, vx = 0.f;
        if (s < len) {
          const int row = min(max(tb[s / ps], 0), N - 1);
          const int slot = s % ps;
          kx = to_f(kh[row * skn + slot * skp + d]);
          vx = to_f(vh[row * svn + slot * svp + d]);
        }
        Ks[c * DP + d] = kx;
        Vs[c * D + d] = vx;
      }
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
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* o, int B, int Hq, int Hkv, int N, int ps, int P,
           const int64_t* st, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem =
      sizeof(float) * (2 * G * D + BK * (D + 1) + BK * D + G * BK + 3 * G);
  auto kern = paged_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      table, lengths, static_cast<T*>(o), N, ps, P, G, 1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* table,
               const int* lengths, void* o, int B, int Hq, int Hkv, int N, int ps,
               int P, const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, table, lengths, o, B, Hq, Hkv, N, ps, P, st, stream);
    case 64: return launch<T, 64>(q, k, v, table, lengths, o, B, Hq, Hkv, N, ps, P, st, stream);
    case 128: return launch<T, 128>(q, k, v, table, lengths, o, B, Hq, Hkv, N, ps, P, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, hd) by strides (b, h);
// k, v (N, ps, Hkv, hd) pool slabs by strides (row, slot, h); o (B, Hq, hd)
// by strides (b, h); last dims contiguous. table: (B, P) int32, contiguous;
// lengths: (B,) int32; both on the device. Returns the launch's cudaError_t
// (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* o, int dtype, int B, int Hq, int Hkv, int N, int ps,
    int P, int D, int64_t sqb, int64_t sqh, int64_t skn, int64_t skp, int64_t skh,
    int64_t svn, int64_t svp, int64_t svh, int64_t sob, int64_t soh, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || N <= 0 || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t st[10] = {sqb, sqh, skn, skp, skh, svn, svp, svh, sob, soh};
  const int* tb = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, tb, len, o, B, Hq, Hkv, N, ps, P, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, tb, len, o, B, Hq, Hkv, N, ps, P, st, s);
  return (int)cudaErrorInvalidValue;
}
