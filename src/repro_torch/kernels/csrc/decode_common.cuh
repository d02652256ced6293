// Split-K decode attention ("flash-decoding"), shared by the dense decode
// kernel (decode_attention.cu) and the paged one
// (paged_decode_attention.cu): one chunk body and one combine, templated on
// how a cache position's K/V row is addressed (`Rows`). The two kernels
// differ in that alone, so the paged result is bitwise equal to the dense
// one on the cache gathered in table order, by construction.
//
// Function: for each sequence b and q head h, softmax over the first
// lengths[b] cache positions (clamped to [0, M]) of q . k / sqrt(hd), times
// v; fp32 softmax; kv head = h // G; a row of length 0 gives zeros.
//
// Design (the cache is about 1 flop per byte: tensor cores buy nothing;
// the gain is in SMs busy and loads in flight):
//   * chunk kernel, grid (Hkv, ceil(M / DC), B), DNT threads: one CTA per
//     (kv head, chunk of DC = 32 positions, sequence) handles the G q heads
//     of its group. A chunk at or past the row's length exits at once (the
//     lengths are read on the device, never on the host). All of the
//     chunk's K and V rows are copied with 16-byte cp.async, in flight
//     together, into shared memory in the input type (rows padded by 16
//     bytes: conflict-free row reads). Warp w scores heads w, w + 4, ...,
//     lane c position c (a fixed-order fp32 FMA chain over hd), then the
//     chunk's max m, its sum l (xor-shuffle trees) and p = exp(s - m); each
//     thread sums p v for a pair of dims over the chunk's positions in
//     order. The fp32 partials (acc[G][hd], then (m, l)[G]) go to a scratch
//     the wrapper allocates.
//   * combine kernel, grid (Hq, B), hd threads: m = max of the chunks' m;
//     L and O sum l_c and acc_c scaled by exp(m_c - m) over the chunks below
//     the row's length only, in chunk order; out = O / max(L, 1e-30).
//   * batch invariance: nothing in the order of any sum depends on B, M,
//     the page size or the number of SMs (fixed chunk boundaries from
//     position 0, fixed thread -> element maps and shuffle trees, no
//     atomics), so a row of a mixed batch is bitwise equal to that row
//     decoded alone.

#pragma once

#include "common.cuh"

namespace attn {
namespace {

constexpr int DC = 32;   // cache positions per chunk (= warp width: lane c scores position c)
constexpr int DNT = 128; // threads per chunk CTA
constexpr int DNW = DNT / 32;

// 16 bytes of shared memory -> floats
__device__ __forceinline__ void vec_to_f(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void vec_to_f(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
// two adjacent elements -> floats
__device__ __forceinline__ float2 pair_to_f(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_to_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A dense cache (B, M, Hkv, hd) read through element strides.
template <typename T>
struct DenseRows {
  struct Params {
    const T* k;
    const T* v;
    int64_t skb, skm, skh, svb, svm, svh;
  };
  const T* kb;
  const T* vb;
  int64_t skm, svm;

  __device__ DenseRows(const Params& p, int b, int hk, int /*s0*/)
      : kb(p.k + b * p.skb + hk * p.skh), vb(p.v + b * p.svb + hk * p.svh),
        skm(p.skm), svm(p.svm) {}
  __device__ void kv(int s, const T*& kr, const T*& vr) const {
    kr = kb + s * skm;
    vr = vb + s * svm;
  }
};

// (N, ps, Hkv, hd) pool slabs reached through a (B, P) page table: position
// s lives at row table[b, s / ps], slot s % ps. Entries below 0 (the -1
// past a sequence's last page) are clamped to row 0, as the TPU kernel's
// index map does, and rows at or past N to N - 1, so a bad table cannot
// read outside the slabs. With ps a multiple of DC a chunk lies inside one
// page: one table read per chunk; else one per position.
template <typename T>
struct PagedRows {
  struct Params {
    const T* k;
    const T* v;
    const int* table;
    int N, ps, P;
    int64_t skn, skp, skh, svn, svp, svh;
  };
  const int* tb;
  const T* kh;
  const T* vh;
  int N, ps, chunk_row;  // chunk_row: the chunk's pool row, or -1
  int64_t skn, skp, svn, svp;

  __device__ PagedRows(const Params& p, int b, int hk, int s0)
      : tb(p.table + (int64_t)b * p.P), kh(p.k + hk * p.skh), vh(p.v + hk * p.svh),
        N(p.N), ps(p.ps), chunk_row(-1), skn(p.skn), skp(p.skp), svn(p.svn), svp(p.svp) {
    if (ps % DC == 0) chunk_row = row(s0);
  }
  __device__ int row(int s) const { return min(max(tb[s / ps], 0), N - 1); }
  __device__ void kv(int s, const T*& kr, const T*& vr) const {
    const int64_t r = chunk_row >= 0 ? chunk_row : row(s);
    const int64_t slot = s % ps;
    kr = kh + r * skn + slot * skp;
    vr = vh + r * svn + slot * svp;
  }
};

template <typename T, int D, typename Rows>
__global__ void __launch_bounds__(DNT) decode_chunk_kernel(
    const T* __restrict__ q, int64_t sqb, int64_t sqh, const int* __restrict__ lengths,
    const typename Rows::Params rp, int M, int G, int NC, float scale,
    float* __restrict__ part) {
  constexpr int EV = 16 / (int)sizeof(T);  // elements per 16-byte vector
  constexpr int VR = D / EV;               // vectors per row
  constexpr int RS = D + EV;               // shared row stride (elements): 16-byte pad
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);            // [DC][RS]
  T* Vs = Ks + DC * RS;                              // [DC][RS]
  float* Qs = reinterpret_cast<float*>(Vs + DC * RS);  // [G][D]
  float* Ps = Qs + G * D;                            // [G][DC]

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int hk = blockIdx.x;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int len = min(max(lengths[b], 0), M);
  const int s0 = chunk * DC;
  if (s0 >= len) return;  // past the row's length: the combine skips it
  const int n = min(DC, len - s0);  // positions of the chunk below the length

  const Rows rows(rp, b, hk, s0);
  for (int idx = tid; idx < DC * VR; idx += DNT) {
    const int r = idx / VR, c = (idx % VR) * EV;
    const bool ok = r < n;
    const T* kr;
    const T* vr;
    rows.kv(ok ? s0 + r : s0, kr, vr);
    cp_async16(Ks + r * RS + c, kr + c, ok);
    cp_async16(Vs + r * RS + c, vr + c, ok);
  }
  cp_async_commit();
  const T* qg = q + b * sqb + (int64_t)hk * G * sqh;
  for (int p = tid; p < G * D; p += DNT) {
    const int g = p / D, d = p % D;
    Qs[p] = to_f(qg[g * sqh + d]);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* acc = part + (((int64_t)b * gridDim.x + hk) * NC + chunk) * G * (D + 2);
  float* ml = acc + G * D;
  for (int g = warp; g < G; g += DNW) {
    const float* qv = Qs + g * D;
    const T* kr = Ks + lane * RS;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < D; c += EV) {
      float kf[EV];
      vec_to_f(kr + c, kf);
#pragma unroll
      for (int e = 0; e < EV; ++e) dot = fmaf(qv[c + e], kf[e], dot);
    }
    const float s = lane < n ? dot * scale : NEG;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float p = expf(s - mx);
    float sum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    Ps[g * DC + lane] = p;
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  for (int p = tid; p < G * D / 2; p += DNT) {
    const int g = p / (D / 2), d = (p % (D / 2)) * 2;
    const float* pg = Ps + g * DC;
    float a0 = 0.f, a1 = 0.f;
    for (int c = 0; c < n; ++c) {
      const float2 x = pair_to_f(Vs + c * RS + d);
      a0 = fmaf(pg[c], x.x, a0);
      a1 = fmaf(pg[c], x.y, a1);
    }
    *reinterpret_cast<float2*>(acc + g * D + d) = make_float2(a0, a1);
  }
}

template <typename T, int D>
__global__ void decode_combine_kernel(const float* __restrict__ part,
                                      const int* __restrict__ lengths, T* __restrict__ o,
                                      int64_t sob, int64_t soh, int M, int Hkv, int G,
                                      int NC) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / G, g = h % G;
  const int len = min(max(lengths[b], 0), M);
  const int nc = (len + DC - 1) / DC;  // the chunks below the row's length
  const int64_t cs = (int64_t)G * (D + 2);  // floats per chunk
  const float* base = part + ((int64_t)b * Hkv + hk) * NC * cs;
  const float* mlg = base + G * D + 2 * g;
  float m = NEG;
  for (int c = 0; c < nc; ++c) m = fmaxf(m, mlg[c * cs]);
  float L = 0.f;
  for (int c = 0; c < nc; ++c) L = fmaf(mlg[c * cs + 1], expf(mlg[c * cs] - m), L);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  const float* ag = base + g * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < nc; ++c) acc = fmaf(ag[c * cs + d], expf(mlg[c * cs] - m), acc);
    from_f(o + b * sob + h * soh + d, acc * inv);
  }
}

// Both kernels on `stream`. The scratch holds, per (sequence, kv head,
// chunk), acc[G][D] then (m, l)[G]. Returns the first launch error (0 =
// success).
template <typename T, int D, typename Rows>
int launch_decode(const void* q, int64_t sqb, int64_t sqh, const int* lengths,
                  const typename Rows::Params& rp, void* o, int64_t sob, int64_t soh,
                  void* scratch, int64_t scratch_floats, int B, int Hq, int Hkv, int M,
                  cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int NC = (M + DC - 1) / DC;
  if ((int64_t)B * Hkv * NC * G * (D + 2) > scratch_floats) return (int)cudaErrorInvalidValue;
  constexpr int EV = 16 / (int)sizeof(T);
  const int smem = 2 * DC * (D + EV) * (int)sizeof(T) + G * (D + DC) * (int)sizeof(float);
  auto chunk_kern = decode_chunk_kernel<T, D, Rows>;
  static SmemLimit limit;
  const int err = limit.raise((const void*)chunk_kern, smem);
  if (err != 0) return err;
  float* part = static_cast<float*>(scratch);
  chunk_kern<<<dim3(Hkv, NC, B), DNT, smem, stream>>>(
      static_cast<const T*>(q), sqb, sqh, lengths, rp, M, G, NC, 1.0f / sqrtf((float)D),
      part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T, D><<<dim3(Hq, B), D, 0, stream>>>(
      part, lengths, static_cast<T*>(o), sob, soh, M, Hkv, G, NC);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace attn
