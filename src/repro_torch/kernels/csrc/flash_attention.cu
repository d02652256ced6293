// Causal / full GQA flash attention (prefill) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas
// TPU kernel `_flash_kernel`). Same function: softmax(q k^T / sqrt(hd)) v
// with an fp32 online softmax (running max, denominator, accumulator),
// causal mask col > row, kv head = h // G without materialising the
// repeat, output in the input type.
//
// Both paths: one CTA per (q tile of 64 rows, q head, batch row), walking
// 64-position K/V tiles up to the causal diagonal (tiles wholly above it
// are never loaded); q/k/v read in the model layout (B, S, H, hd) through element strides (last dim
// contiguous), no transposed copy; any S (the ragged q and k tails are
// masked here; the TPU kernel's S % block assert was a Pallas constraint);
// hd in {32, 64, 80, 128}.
//
// bf16 (every served prefill): tensor cores, in the FlashAttention-2 shape.
//   * 4 warps, each owning 16 q rows, loaded once from memory straight into
//     mma A-fragments in registers (4-byte loads in the fragment layout).
//   * K and V tiles are copied in bf16 with 16-byte cp.async,
//     double-buffered: tile t + 1's copy is in flight while tile t is
//     computed, one __syncthreads a tile. Rows are padded by 16 bytes, so
//     the 8 rows an ldmatrix phase reads fall in distinct bank groups at
//     every hd.
//   * S = Q K^T with mma.sync m16n8k16 (bf16 in, fp32 accumulate; products
//     of bf16 values are exact in fp32), K read with ldmatrix. The online
//     softmax (base 2), the causal and ragged-tail masks run on the
//     accumulators in registers, with quad shuffles for the row max and sum.
//   * P is packed to bf16 A-fragments straight from the score registers
//     (no round trip through shared memory) and P V is a second mma.sync,
//     V read with ldmatrix.trans. Rounding P to bf16 perturbs each weight by
//     at most 2^-9 relative; the denominator sums the rounded weights, so
//     they still sum to one and the output stays a convex combination of
//     V's rows.
//   * less work at the edges: a warp whose rows all lie past S only helps
//     load, and on a diagonal or ragged tile a warp skips the 16-position
//     blocks that are masked whole (one instantiation per count of live
//     blocks, so the inner loops stay branch-free); the CTAs with the most
//     causal tiles are launched first.
//   * shared memory: two stages of K and V, (hd + 8) * 2 bytes a row,
//     69,632 bytes at hd 128: room for three CTAs on an SM, though at hd
//     128 the registers (about 174 a thread) hold it to two.
// fp32 (the model checks): exact fp32 CUDA-core FMAs, no TF32. Tiles are
//   staged in shared memory as fp32 (rows padded by one float), scores and
//   P V on a 4x4 / 4x(hd/16) register micro-tile, 256 threads.
//
// What bounds it on an H100: at the serving path's shapes (S <= 152,
// B = 1) latency: a few dependent load and mma rounds per CTA. At long S
// it is operation-bound: 4*B*Hq*hd*S^2/2 flops against the 989 TFLOP/s
// bf16 tensor-core peak, which mma.sync reaches only in part (wgmma and
// TMA are the next step there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

namespace {

using attn::NEG;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // q rows per CTA
constexpr int BK = 64;  // k rows per tile

// ---------------------------------------------------------------- bf16 path

constexpr int NT_MMA = 128;  // 4 warps x 16 q rows
constexpr int NSTAGE = 2;  // K/V tile stages: tile t + 1 is copied while tile t is used
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), fp32 accumulate
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats -> one register of two bf16 (lo in the low half); adds the
// rounded values to `sum`
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float& sum) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  const float2 r = __bfloat1622float2(p);
  sum += r.x + r.y;
  return *reinterpret_cast<const uint32_t*>(&p);
}

// One K/V tile of a warp's 16 q rows: S = Q K^T, the masks and the online
// softmax (in base 2: scores scaled by log2(e) / sqrt(hd)), O += P V. Only
// the first NB 16-position blocks of the tile are computed: the caller
// passes the blocks after them only when they are masked whole.
template <int D, int NB>
__device__ __forceinline__ void tile_step(const bf16* Kt, const bf16* Vt,
                                          const uint32_t (&qf)[D / 16][4],
                                          float (&acc)[D / 8][4], float (&m_r)[2],
                                          float (&l_r)[2], int lane, int k0, int row0, int S,
                                          int causal, bool edge, float scale_log2) {
  constexpr int RS = D + 8;
  constexpr int KS = D / 16;
  constexpr int NJ = 2 * NB;  // score n-tiles of 8 positions
  constexpr int ND = D / 8;   // output n-tiles of 8 dims
  const int t4 = lane & 3;

  // S = Q K^T: x4 loads give b0/b1 of two n-tiles (positions 0-7 | 8-15
  // of a block) x (dims 0-7 | 8-15 of the k-step)
  float sc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
  const bf16* pk = Kt + ((lane & 7) + (lane >> 4) * 8) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int jp = 0; jp < NB; ++jp) {
      uint32_t kf[4];
      ldmatrix_x4(kf, pk + jp * 16 * RS + ks * 16);
      mma_bf16(sc[2 * jp], qf[ks], kf[0], kf[1]);
      mma_bf16(sc[2 * jp + 1], qf[ks], kf[2], kf[3]);
    }
  }

  // masks and the online softmax; element e of n-tile j is row
  // row0 + 8 (e >> 1), column k0 + 8 j + 2 t4 + (e & 1)
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sc[j][e] * scale_log2;
      if (edge) {
        const int col = k0 + j * 8 + t4 * 2 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (col >= S || (causal && col > row)) s = NEG;
      }
      sc[j][e] = s;
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_r[r], mx);
    alpha[r] = exp2f(m_r[r] - m_new);
    m_r[r] = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      sc[j][2 * r] = exp2f(sc[j][2 * r] - m_new);
      sc[j][2 * r + 1] = exp2f(sc[j][2 * r + 1] - m_new);
    }
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }

  // O += P V: P's A-fragment for positions 16 kk .. 16 kk + 15 is the
  // score registers of n-tiles 2 kk and 2 kk + 1; x4.trans loads give
  // b0/b1 of two output n-tiles (positions 0-7 | 8-15) x (dims of a pair)
  float sum[2] = {0.f, 0.f};
  const bf16* pv = Vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1], sum[0]);
    pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3], sum[1]);
    pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], sum[0]);
    pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], sum[1]);
#pragma unroll
    for (int jp = 0; jp < ND / 2; ++jp) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, pv + kk * 16 * RS + jp * 16);
      mma_bf16(acc[2 * jp], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * jp + 1], pa, vf[2], vf[3]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l_r[r] = l_r[r] * alpha[r] + sum[r];
  }
}

template <int D>
constexpr int mma_smem_bytes() {
  return 2 * NSTAGE * BK * (D + 8) * (int)sizeof(bf16);  // NSTAGE x (K, V)
}

template <int D>
__global__ void __launch_bounds__(NT_MMA) flash_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int S, int G, int causal, float scale_log2,
    int64_t sqb, int64_t sqs, int64_t sqh,
    int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh,
    int64_t sob, int64_t sos, int64_t soh) {
  constexpr int RS = D + 8;     // shared row stride (elements): 16-byte pad
  constexpr int VR = D / 8;     // 16-byte vectors per row
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int ND = D / 8;     // output n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [NSTAGE][BK][RS]
  bf16* sV = sK + NSTAGE * BK * RS;              // [NSTAGE][BK][RS]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gr = lane >> 2, t4 = lane & 3;  // mma fragment row / column pair
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // the longest causal rows first
  const int b = blockIdx.z;
  const int hk = h / G;

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  // causal: the last tile that holds a column <= the CTA's last row
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? min(S, q_last + 1) : S;
  const int n_tiles = (k_end + BK - 1) / BK;

  // tile t into stage t % NSTAGE (nothing past the last tile); rows at or
  // past S are zero-filled, never read from memory
  auto load_kv = [&](int t) {
    if (t >= n_tiles) return;
    bf16* dk = sK + (t % NSTAGE) * BK * RS;
    bf16* dv = sV + (t % NSTAGE) * BK * RS;
    for (int idx = tid; idx < BK * VR; idx += NT_MMA) {
      const int r = idx / VR, c = (idx % VR) * 8;
      const int s = t * BK + r;
      const bool ok = s < S;
      const int64_t sr = ok ? s : 0;
      attn::cp_async16(dk + r * RS + c, kb + sr * sks + c, ok);
      attn::cp_async16(dv + r * RS + c, vb + sr * svs + c, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    load_kv(t);
    attn::cp_async_commit();
  }

  // this warp's 16 q rows straight from memory into A-fragments: a0/a2 row
  // gr, a1/a3 row gr + 8; a0/a1 dims 2 t4, 2 t4 + 1 of the k-step, a2/a3
  // those + 8. Rows past S read row S - 1 (never stored).
  const int row0 = q0 + warp * 16 + gr;  // this thread's rows: row0, row0 + 8
  uint32_t qf[KS][4];
  {
    const bf16* p0 = qb + (int64_t)min(row0, S - 1) * sqs + t4 * 2;
    const bf16* p1 = qb + (int64_t)min(row0 + 8, S - 1) * sqs + t4 * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(p0 + ks * 16);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(p1 + ks * 16);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(p0 + ks * 16 + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(p1 + ks * 16 + 8);
    }
  }

  // running max (in log2 units of the scaled scores) and denominator
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const bool live = q0 + warp * 16 < S;  // a warp whose rows are all past S only loads
  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // tile t is in for every thread; all are done with tile t - 1
    load_kv(t + NSTAGE - 1);  // into tile t - 1's stage
    attn::cp_async_commit();
    if (!live) continue;
    const bf16* Kt = sK + (t % NSTAGE) * BK * RS;
    const bf16* Vt = sV + (t % NSTAGE) * BK * RS;
    const int k0 = t * BK;
    const int wr0 = q0 + warp * 16;  // the warp's first row
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wr0);
    // the 16-position blocks of the tile holding a column this warp needs
    // (below S, and causal: at or left of its last row); the blocks after
    // them are masked whole, and skipped
    const int lim = causal ? min(S - 1, wr0 + 15) : S - 1;
    switch (min(BK / 16, (lim - k0) / 16 + 1)) {
      case 1:
        tile_step<D, 1>(Kt, Vt, qf, acc, m_r, l_r, lane, k0, row0, S, causal, edge, scale_log2);
        break;
      case 2:
        tile_step<D, 2>(Kt, Vt, qf, acc, m_r, l_r, lane, k0, row0, S, causal, edge, scale_log2);
        break;
      case 3:
        tile_step<D, 3>(Kt, Vt, qf, acc, m_r, l_r, lane, k0, row0, S, causal, edge, scale_log2);
        break;
      default:
        tile_step<D, 4>(Kt, Vt, qf, acc, m_r, l_r, lane, k0, row0, S, causal, edge, scale_log2);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + r * 8;
    if (s >= S) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    bf16* ob = o + b * sob + s * sos + h * soh + t4 * 2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(ob + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
               int Hkv, int causal, const int64_t* st, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  auto kern = flash_mma_kernel<D>;
  static attn::SmemLimit limit;
  const int err = limit.raise((const void*)kern, smem);
  if (err != 0) return err;
  dim3 grid(Hq, (S + BQ - 1) / BQ, B);
  kern<<<grid, NT_MMA, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, Hq / Hkv, causal, LOG2E / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path

constexpr int NT = 256;  // threads per CTA (16 x 16)

template <int D>
__global__ void __launch_bounds__(NT) flash_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, int S, int G, int causal, float scale,
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

  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + hk * skh;
  const float* vb = v + b * svb + hk * svh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    Qs[r * DP + d] = s < S ? qb[s * sqs + d] : 0.f;
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
      Ks[c * DP + d] = ok ? kb[s * sks + d] : 0.f;
      Vs[c * D + d] = ok ? vb[s * svs + d] : 0.f;
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
    float* ob = o + b * sob + s * sos + h * soh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[tx + 16 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
                int Hkv, int causal, const int64_t* st, cudaStream_t stream) {
  constexpr int DP = D + 1;
  constexpr int smem = (int)sizeof(float) * (2 * BQ * DP + BK * D + BQ * (BK + 1));
  auto kern = flash_fp32_kernel<D>;
  static attn::SmemLimit limit;
  const int err = limit.raise((const void*)kern, smem);
  if (err != 0) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq / Hkv, causal,
      1.0f / sqrtf((float)D),
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11]);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o, int B, int S,
           int Hq, int Hkv, int causal, const int64_t* st, cudaStream_t stream) {
  if (dtype == 0) return launch_fp32<D>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
  if (dtype == 1) return launch_mma<D>(q, k, v, o, B, S, Hq, Hkv, causal, st, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides (elements), in order:
// q (b, s, h), k (b, s, h), v (b, s, h), o (b, s, h); last dim contiguous.
// bf16: every pointer and every stride (in bytes) a multiple of 16 (the
// cp.async copies), which the Python wrapper checks.
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
  switch (D) {
    case 32: return launch<32>(dtype, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
    case 64: return launch<64>(dtype, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
    case 80: return launch<80>(dtype, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
    case 128: return launch<128>(dtype, q, k, v, o, B, S, Hq, Hkv, causal, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
