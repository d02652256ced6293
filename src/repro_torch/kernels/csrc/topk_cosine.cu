// Batched cosine top-k (the plan cache's fuzzy lookup) for Hopper, sm_90a.
//
// Replaces repro/kernels/similarity.py::topk_cosine (the Pallas TPU kernel
// `_topk_kernel`). Same function: for each query, the k best
// q . bank[row] over rows 0..N-1, ordered by score descending and then by
// row ascending (ties go to the lowest row); slots past N when N < k come
// out as (-1e30, -1), and a score at or below -1e30 / 2 maps to row -1.
//
// Design:
//   * stage 1, grid (n_split, n_qblocks), 256 threads (8 warps). A CTA holds
//     a block of up to 64 queries in shared memory and walks one contiguous
//     range of bank rows. Each warp takes 4 consecutive rows per step: every
//     lane loads its float4 slices of the 4 rows (lane, lane + 32, ... in
//     float4 units: 128-bit loads, neighbouring lanes on neighbouring
//     addresses). For each tile of 8 queries, a lane forms 32 partial dot
//     products (4 rows x 8 queries) by fp32 FMAs in a fixed order over its
//     slices, and a 5-step butterfly reduce-scatter leaves lane L holding the
//     full score of (row L / 8, query L % 8). Each warp keeps a running top-k
//     per query in shared memory; a score enters only if it beats the list's
//     last entry. At the end the 8 warps' lists are merged per query and the
//     CTA writes its k candidates per query to a (Q, n_split, k) workspace.
//   * stage 2, one warp per query, merges the n_split * k candidates under
//     the same total order and writes the result.
//   * determinism: the score of (query, row) is computed by the same
//     arithmetic whichever CTA, warp, step or query tile handles it (the
//     lane -> slice mapping and the reduction tree are fixed), there are no
//     atomics, and top-k under a total order does not depend on the order in
//     which candidates arrive. So the result is bitwise independent of Q, of
//     the split count and of the padding.
//   * fp32 FMAs, not TF32 tensor cores: the scores are compared against
//     match thresholds of 0.6-0.85, and TF32's 10-bit mantissa moves a
//     cosine by ~1e-3, enough to flip a match.
//
// What bounds it on an H100: at the agent path's sizes (N of a few hundred
// rows, Q <= 8) the launch. At N = 1e6 rows of 384 floats, reading the bank
// (1.5 GB over 3.35 TB/s, 0.46 ms) bounds Q = 8, and the fp32 FMAs
// (2 * Q * N * D flops over 67 TFLOP/s) bound Q = 64. The kernel streams
// the bank once per query block; the score reductions (31 shuffles per 32
// scores) and the per-query top-k checks cost on top of the FMAs.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 256;           // stage-1 threads per CTA (8 warps)
constexpr int NW = NT / 32;
constexpr int RS = 4;             // rows per warp step
constexpr int QT = 8;             // queries per tile (RS * QT = 32 = one score per lane)
constexpr int QB_MAX = 64;        // queries per CTA
constexpr int MAX_K = 32;
constexpr int MAX_T = 8;          // float4 slices per lane: D <= 32 * 4 * MAX_T = 1024
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
constexpr int SMEM_MAX = 232448;  // H100: shared memory one block may use
static_assert(RS * QT == 32, "one score per lane after the reduce-scatter");

// the total order: a is better than b when its score is higher, or equal
// with a lower row. Empty list slots hold (-inf, INT_MAX), worse than any
// candidate.
__device__ __forceinline__ bool better(float as, int ar, float bs, int br) {
  return as > bs || (as == bs && ar < br);
}

// Insert (cs, cr), the same on every lane, into the sorted list (ls, lr)
// of length k <= 32 held in shared memory; the whole warp calls it. A
// candidate no better than the last entry leaves the list unchanged.
__device__ __forceinline__ void insert(float* ls, int* lr, int k, float cs, int cr,
                                       int lane) {
  float es = -INFINITY;
  int er = INT_MAX;
  if (lane < k) {
    es = ls[lane];
    er = lr[lane];
  }
  const unsigned beats = __ballot_sync(FULL, lane < k && better(cs, cr, es, er));
  if (beats == 0) return;
  const int pos = __ffs(beats) - 1;  // the list is sorted: cand beats pos..k-1
  const float ps = __shfl_up_sync(FULL, es, 1);
  const int pr = __shfl_up_sync(FULL, er, 1);
  __syncwarp();
  if (lane == pos) {
    ls[lane] = cs;
    lr[lane] = cr;
  } else if (lane > pos && lane < k) {
    ls[lane] = ps;
    lr[lane] = pr;
  }
  __syncwarp();
}

// Offer one candidate per lane (valid lanes only) to the lists of `list`
// (lane -> its own list); the passing ones are inserted one at a time.
__device__ __forceinline__ void offer(float* ls_base, int* lr_base, int k, bool valid,
                                      float s, int r, int list, int lane) {
  bool pass = false;
  if (valid) {
    pass = better(s, r, ls_base[list * k + k - 1], lr_base[list * k + k - 1]);
  }
  unsigned m = __ballot_sync(FULL, pass);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int cr = __shfl_sync(FULL, r, src);
    const int cl = __shfl_sync(FULL, list, src);
    insert(ls_base + cl * k, lr_base + cl * k, k, cs, cr, lane);
  }
}

// One step of the butterfly reduce-scatter over the first C values of p:
// a lane keeps the upper half if its bit C / 2 is set, the lower half
// otherwise, and adds the partner lane's copy of the half it keeps.
template <int C>
__device__ __forceinline__ void reduce_step(float (&p)[RS * QT], int lane) {
  constexpr int H = C / 2;
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? p[j] : p[j + H];
    const float keep = up ? p[j + H] : p[j];
    p[j] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, H));
  }
}

template <int T>
__global__ void __launch_bounds__(NT) topk_stage1(
    const float* __restrict__ queries, const float* __restrict__ bank,
    float* __restrict__ ws_s, int* __restrict__ ws_r, int Q, int N, int D, int k,
    int QB, int n_split, int rows_per) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [QB][D] queries (zero-padded)
  float* ls = qs + QB * D;                       // [NW][QB][k] list scores
  int* lr = reinterpret_cast<int*>(ls + NW * QB * k);  // [NW][QB][k] list rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, q0 = blockIdx.y * QB;
  const int F = D >> 2;  // float4 per row

  const float4* q4 = reinterpret_cast<const float4*>(queries);
  float4* qs4 = reinterpret_cast<float4*>(qs);
  for (int i = tid; i < QB * F; i += NT) {
    const int q = i / F, f = i - q * F;
    qs4[i] = (q0 + q < Q) ? q4[(int64_t)(q0 + q) * F + f] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < NW * QB * k; i += NT) {
    ls[i] = -INFINITY;
    lr[i] = INT_MAX;
  }
  __syncthreads();

  float* my_ls = ls + warp * QB * k;
  int* my_lr = lr + warp * QB * k;
  const int r_begin = split * rows_per;
  const int r_end = min(N, r_begin + rows_per);
  const float4* b4 = reinterpret_cast<const float4*>(bank);
  const int n_tiles = (QB + QT - 1) / QT;

  for (int base = r_begin + warp * RS; base < r_end; base += NW * RS) {
    float4 b[RS][T];
#pragma unroll
    for (int i = 0; i < RS; ++i) {
      const int row = base + i;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int f = lane + 32 * t;
        b[i][t] = (row < r_end && f < F) ? __ldg(&b4[(int64_t)row * F + f])
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      float p[RS * QT];
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        float4 qv[T];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int f = lane + 32 * t;
          qv[t] = f < F ? qs4[(tile * QT + j) * F + f] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int i = 0; i < RS; ++i) {
          float acc = 0.f;
#pragma unroll
          for (int t = 0; t < T; ++t) {
            acc = __fmaf_rn(b[i][t].x, qv[t].x, acc);
            acc = __fmaf_rn(b[i][t].y, qv[t].y, acc);
            acc = __fmaf_rn(b[i][t].z, qv[t].z, acc);
            acc = __fmaf_rn(b[i][t].w, qv[t].w, acc);
          }
          p[i * QT + j] = acc;
        }
      }
      // butterfly reduce-scatter: lane L ends with value index L, summed
      // over all 32 lanes by one fixed tree
      reduce_step<32>(p, lane);
      reduce_step<16>(p, lane);
      reduce_step<8>(p, lane);
      reduce_step<4>(p, lane);
      reduce_step<2>(p, lane);
      const int row = base + lane / QT;
      const int ql = tile * QT + (lane % QT);  // query within the block
      const bool valid = row < r_end && ql < QB && q0 + ql < Q;
      offer(my_ls, my_lr, k, valid, p[0], row, ql, lane);
    }
  }
  __syncthreads();

  // merge the warps' lists per query into warp 0's list; write it out
  for (int ql = warp; ql < QB && q0 + ql < Q; ql += NW) {
    float* dst_s = ls + ql * k;
    int* dst_r = lr + ql * k;
    for (int w = 1; w < NW; ++w) {
      const float* src_s = ls + (w * QB + ql) * k;
      const int* src_r = lr + (w * QB + ql) * k;
      const bool has = lane < k;
      const float s = has ? src_s[lane] : -INFINITY;
      const int r = has ? src_r[lane] : INT_MAX;
      const bool pass = has && r != INT_MAX && better(s, r, dst_s[k - 1], dst_r[k - 1]);
      unsigned m = __ballot_sync(FULL, pass);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        insert(dst_s, dst_r, k, __shfl_sync(FULL, s, src), __shfl_sync(FULL, r, src), lane);
      }
    }
    if (lane < k) {
      const int64_t o = ((int64_t)(q0 + ql) * n_split + split) * k + lane;
      ws_s[o] = dst_s[lane];
      ws_r[o] = dst_r[lane];
    }
  }
}

__global__ void __launch_bounds__(128) topk_stage2(
    const float* __restrict__ ws_s, const int* __restrict__ ws_r,
    float* __restrict__ out_s, int* __restrict__ out_i, int Q, int k, int n_split) {
  __shared__ float ls[4][MAX_K];
  __shared__ int lr[4][MAX_K];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * 4 + warp;
  if (q >= Q) return;  // warp-uniform
  if (lane < k) {
    ls[warp][lane] = -INFINITY;
    lr[warp][lane] = INT_MAX;
  }
  __syncwarp();
  const int M = n_split * k;
  const float* cs = ws_s + (int64_t)q * M;
  const int* cr = ws_r + (int64_t)q * M;
  for (int c0 = 0; c0 < M; c0 += 32) {
    const int c = c0 + lane;
    const float s = c < M ? cs[c] : -INFINITY;
    const int r = c < M ? cr[c] : INT_MAX;
    const bool pass = r != INT_MAX && better(s, r, ls[warp][k - 1], lr[warp][k - 1]);
    unsigned m = __ballot_sync(FULL, pass);
    while (m) {
      const int src = __ffs(m) - 1;
      m &= m - 1;
      insert(ls[warp], lr[warp], k, __shfl_sync(FULL, s, src), __shfl_sync(FULL, r, src),
             lane);
    }
  }
  if (lane < k) {
    const float s = ls[warp][lane];
    const int r = lr[warp][lane];
    const bool empty = r == INT_MAX;
    out_s[(int64_t)q * k + lane] = empty ? NEG : s;
    out_i[(int64_t)q * k + lane] = (empty || s <= NEG / 2) ? -1 : r;
  }
}

template <int T>
int launch(const float* q, const float* bank, float* ws_s, int* ws_r, float* out_s,
           int* out_i, int Q, int N, int D, int k, int n_split, cudaStream_t stream) {
  const int n_qblocks = (Q + QB_MAX - 1) / QB_MAX;
  const int per = (Q + n_qblocks - 1) / n_qblocks;
  int QB = (per + QT - 1) / QT * QT;
  auto smem_of = [&](int qb) {
    return (size_t)qb * D * sizeof(float) + (size_t)NW * qb * k * (sizeof(float) + sizeof(int));
  };
  while (QB > QT && smem_of(QB) > (size_t)SMEM_MAX) QB -= QT;
  if (smem_of(QB) > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int n_qb = (Q + QB - 1) / QB;
  int rows_per = (N + n_split - 1) / n_split;
  rows_per = (rows_per + NW * RS - 1) / (NW * RS) * (NW * RS);
  const size_t smem = smem_of(QB);
  auto kern = topk_stage1<T>;
  // the dynamic shared memory ceiling is set per function and per device:
  // once, at the most any launch asks for, not on every call
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  kern<<<dim3(n_split, n_qb), NT, smem, stream>>>(q, bank, ws_s, ws_r, Q, N, D, k, QB,
                                                  n_split, rows_per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_stage2<<<(Q + 3) / 4, 128, 0, stream>>>(ws_s, ws_r, out_s, out_i, Q, k, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// queries (Q, D) and bank (N, D): float32, contiguous rows, 16-byte
// aligned; D a multiple of 4, at most 1024. ws_s / ws_r: (Q, n_split, k)
// float32 / int32 scratch. out_s / out_i: (Q, k) float32 / int32.
// 1 <= k <= 32, Q >= 1, N >= 1, n_split >= 1. Returns the launch's
// cudaError_t (0 = success).
extern "C" int topk_cosine_fwd(const void* queries, const void* bank, void* ws_s, void* ws_r,
                               void* out_s, void* out_i, int Q, int N, int D, int k,
                               int n_split, void* stream) {
  if (Q <= 0 || N <= 0 || k < 1 || k > MAX_K || n_split < 1 || D <= 0 || D % 4 != 0 ||
      D > 32 * 4 * MAX_T)
    return (int)cudaErrorInvalidValue;
  const int T = (D / 4 + 31) / 32;
  const float* q = static_cast<const float*>(queries);
  const float* b = static_cast<const float*>(bank);
  float* wss = static_cast<float*>(ws_s);
  int* wsr = static_cast<int*>(ws_r);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 1: return launch<1>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 2: return launch<2>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 3: return launch<3>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 4: return launch<4>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 5: return launch<5>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 6: return launch<6>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 7: return launch<7>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    case 8: return launch<8>(q, b, wss, wsr, os, oi, Q, N, D, k, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
