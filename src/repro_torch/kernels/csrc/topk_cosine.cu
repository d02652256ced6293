// Batched cosine top-k (the plan cache's fuzzy lookup) for Hopper, sm_90a.
//
// Replaces repro/kernels/similarity.py::topk_cosine (the Pallas TPU kernel
// `_topk_kernel`). Same function: for each query, the k best
// q . bank[row] over rows 0..N-1, ordered by score descending and then by
// row ascending (ties go to the lowest row); slots past N when N < k come
// out as (-1e30, -1), and a score at or below -1e30 / 2 maps to row -1.
//
// What bounds it on an H100 (D = 384; chip_smoke.py's time_topk shapes):
//   * the agent's lookup, Q = 8 (padded) against a 64-row arena, k = 1:
//     latency. One CTA; the launch, the copies' round trip and each
//     score's chain of 12 dependent 32-dim windows set its time, not bytes
//     (96 KB) or operations.
//   * Q = 8, N = 20,000 or 1e6: the bank's bytes (1.5 GB at N = 1e6 over
//     3.35 TB/s, 0.46 ms); the tensor-core work is a small fraction.
//   * Q = 64: the tensor cores. The three TF32 products a multiply-add are
//     3 x 2 * Q * N * D flops; mma.sync reaches about 2/3 of the 495 TFLOP/s
//     that wgmma can, which is 0.46 ms at N = 1e6, level with the bytes,
//     and the epilogue and the folds run on the same warps, not beside.
//
// Why 3xTF32 and not one TF32 product: the fuzzy stage compares scores with
// thresholds of 0.6-0.85, and one TF32 product (10-bit mantissa) moves a
// cosine by up to ~1e-4 (tests/test_torch_topk_split.py), ten times the
// kernel's tolerance of 1e-5 against the float64 sum. Splitting each
// operand as hi = tf32(x), lo = x - hi and summing hi.hi + hi.lo + lo.hi
// drops only lo.lo and lo's truncation, below 2^-22 of a product: close
// to fp32, at the tensor cores' rate (3 products still cost less than
// fp32 FMAs on the CUDA cores, 67 TFLOP/s).
//
// Design: one launch a call, grid (n_split, n_qblocks), 8 warps.
//   * Bank rows on M: mma.sync m16n8k8 TF32 with bank rows as A (a warp
//     holds 2 m16 tiles, or 4 when the CTA takes 64 queries) and queries as
//     B (n-tiles of 8; a warp takes all of a CTA's up to 32 queries, or 16
//     of its 64), K = D in steps of 8. At Q <= 8 one n-tile holds every
//     query, so no tensor-core work goes to padding rows.
//   * The split: queries sit in shared memory once, in the mma's B fragment
//     order (one 16-byte load gives a lane two k-steps of an n-tile); both
//     operands are split in registers as their fragments are loaded (two
//     integer operations and one subtraction a value). The k order is
//     permuted within each 16 dims so that one 16-byte load gives a lane
//     its A values for two k-steps; the query plane uses the same order.
//   * Rounding: the tensor cores' fp32 accumulation truncates. Each output
//     keeps a hi.hi and a hi.lo + lo.hi accumulator for the current 32-dim
//     window; the window's hi.hi + (hi.lo + lo.hi) is added to an fp32 sum
//     with __fadd_rn and the accumulators restart at 0, so a truncation is
//     relative to a partial sum of 32 products, not to the score.
//   * Bank streaming: TMA copies tiles of 64, 128 or 256 rows by 32 dims
//     (128-byte swizzle; rows past N and dims past D zero-filled, so a
//     ragged last k-step needs no branch) into a 96 KB ring of mbarrier-
//     guarded slots; thread 0 refills a slot once all warps released it.
//     Fragment row g reads tile row ((g & 1) << 2) | (g >> 1), so a
//     quarter-warp's 16-byte loads fall in all 32 banks under the swizzle.
//   * A lone tile of 8 queries (the agent's lookup) leaves most row groups
//     idle; its warps then split the 32-dim windows between them, write
//     each window's scores to shared memory and one warp a row group folds
//     them in window order: the same arithmetic, a quarter of the chain.
//   * Epilogue, after a tile's last window: each lane offers its fragment's
//     scores to per-warp sorted lists, one per query, in shared memory. A
//     score is dropped unless it beats the list's last entry; in rounds,
//     per query the best remaining score of the 8 lanes holding it (a
//     shuffle reduce) is shifted in by one lane.
//   * Across CTAs, in the same launch: the row groups' lists are merged per
//     query. With n_split == 1 the CTA writes the result directly.
//     Otherwise each CTA writes its k candidates per query to the workspace
//     (Q, n_split, k), and the last CTA of a query block to finish (an
//     arrival counter behind __threadfence, set back to 0 by that CTA)
//     merges the block's n_split * k candidates and writes the result.
//   * Determinism: the score of (query, row) comes from the same arithmetic
//     whichever CTA, warp, tile position, query position or k-group
//     handles it (the same split, the same k order, the window sums added
//     in window order), there are no atomics on data, and top-k under a
//     total order does not depend on the order in which candidates arrive.
//     So the result is bitwise independent of Q, of the split count and of
//     the padding.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int NW = 8;                // warps a CTA
constexpr int NTH = NW * 32;
constexpr int BK = 32;               // dims a tile (128 bytes a row); the fold window
constexpr int RING_BYTES = 98304;    // 3 tiles of 256 rows, 6 of 128 or 12 of 64
constexpr int MAX_SLOTS = RING_BYTES / (64 * BK * 4);
constexpr int MAX_K = 32;
constexpr int MAX_D = 1024;
constexpr int CPL = 16;              // candidates a lane holds in a merge pass
constexpr unsigned FULL = 0xffffffffu;
// H100: the shared memory one block may use, 232,448 bytes, less 1 KB for
// the kernel's static shared memory (the ring's barriers)
constexpr int SMEM_MAX = 231424;

// The warps of a CTA: up to 32 queries, 8 row groups of 32 rows that each
// take every query; 64 queries, 4 query groups of 16 by 2 row groups of 64
// rows (kernels/similarity.py mirrors both).
int query_groups(int qb) { return qb > 32 ? 4 : 1; }

// Dynamic shared memory of one CTA (kernels/similarity.py::smem_bytes
// mirrors it): 1 KB to align the ring, the ring, the query plane (qb
// queries over D padded to 16), the per-warp lists (score and row) of a
// warp's queries and, with kg k-groups (kg > 1, qb = 8 only), each 32-dim
// window's partial scores.
size_t smem_bytes(int qb, int D, int k, int kg) {
  const size_t dp = (size_t)(D + 15) / 16 * 16;
  const size_t wn = qb / query_groups(qb);
  const size_t windows = kg > 1 ? (size_t)(D + BK - 1) / BK * (NW / kg) * 32 * 8 * 4 : 0;
  return 1024 + (size_t)RING_BYTES + (size_t)qb * dp * 4 + (size_t)NW * wn * k * 8 + windows;
}

// Rows of a tile: the least of 64, 128, ... that covers rows_per, at most
// the rows the warps hold at once (kernels/similarity.py mirrors it).
int tile_rows(int rows_per, int qb) {
  const int bm = qb > 32 ? 128 : 256;
  int tr = 64;
  while (tr < bm && tr < rows_per) tr *= 2;
  return tr;
}

// K-groups: a CTA of 8 queries whose rows fit one tile (the agent's lookup)
// has fewer row groups than warps; the idle warps then take 32-dim windows
// of their own, 256 / TR groups in turn (kernels/similarity.py mirrors it).
int k_groups(int qb, int n_split, int TR, int D, int k) {
  if (qb != 8 || n_split != 1 || TR >= 256) return 1;
  const int kg = 256 / TR;
  return smem_bytes(qb, D, k, kg) <= (size_t)SMEM_MAX ? kg : 1;
}

// the total order: a is better than b when its score is higher, or equal
// with a lower row. Empty list slots hold (-inf, INT_MAX), worse than any
// candidate.
__device__ __forceinline__ bool better(float as, int ar, float bs, int br) {
  return as > bs || (as == bs && ar < br);
}

// Shift (s, r) into the sorted list (L, R) of length k, dropping its last
// entry; (s, r) must be better than that entry. One lane calls it.
__device__ __forceinline__ void shift_in(float* L, int* R, int k, float s, int r) {
  int p = k - 1;
  while (p > 0 && better(s, r, L[p - 1], R[p - 1])) {
    L[p] = L[p - 1];
    R[p] = R[p - 1];
    --p;
  }
  L[p] = s;
  R[p] = r;
}

// Merge M candidates, cand(i, s, r) for i < M (rows INT_MAX are empty; no
// row twice), into the sorted list (dst_s, dst_r) of length k in shared
// memory; the whole warp calls it. A pass holds CPL candidates a lane; in
// rounds the warp's best one enters (lane 0 shifts it in) while it beats
// the list's last entry: at most k + 1 rounds a pass, whatever the order.
template <class Cand>
__device__ __forceinline__ void merge_rounds(float* dst_s, int* dst_r, int k, int M,
                                             Cand cand, int lane) {
  for (int base = 0; base < M; base += 32 * CPL) {
    float s[CPL];
    int r[CPL];
    const float ts = dst_s[k - 1];
    const int tr = dst_r[k - 1];
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int i = base + j * 32 + lane;
      s[j] = -INFINITY;
      r[j] = INT_MAX;
      if (i < M) cand(i, s[j], r[j]);
      if (r[j] == INT_MAX || !better(s[j], r[j], ts, tr)) r[j] = INT_MAX;
    }
    for (;;) {
      float bs = -INFINITY;
      int br = INT_MAX;
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (r[j] != INT_MAX && better(s[j], r[j], bs, br)) {
          bs = s[j];
          br = r[j];
        }
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        const float os = __shfl_xor_sync(FULL, bs, m);
        const int orow = __shfl_xor_sync(FULL, br, m);
        if (better(os, orow, bs, br)) {
          bs = os;
          br = orow;
        }
      }
      if (br == INT_MAX || !better(bs, br, dst_s[k - 1], dst_r[k - 1])) break;
      __syncwarp();
      if (lane == 0) shift_in(dst_s, dst_r, k, bs, br);
#pragma unroll
      for (int j = 0; j < CPL; ++j)
        if (r[j] == br) r[j] = INT_MAX;
      __syncwarp();
    }
    __syncwarp();
  }
}

// One query's final list -> its output row: empty slots as (-1e30, -1),
// a score at or below -1e30 / 2 as row -1.
__device__ __forceinline__ void write_out(const float* ls, const int* lr, int k,
                                          float* out_s, int* out_i, int64_t q, int lane) {
  if (lane < k) {
    const float s = ls[lane];
    const int r = lr[lane];
    const bool empty = r == INT_MAX;
    out_s[q * k + lane] = empty ? attn::NEG : s;
    out_i[q * k + lane] = (empty || s <= attn::NEG / 2) ? -1 : r;
  }
}

// x -> (hi, lo) for 3xTF32. hi = x rounded to TF32 (10 mantissa bits,
// to nearest, ties away from zero: cvt.rna.tf32.f32's rounding, done with
// two integer operations); lo = x - hi, exact in fp32, which the tensor
// core reads as TF32 by dropping its low 13 bits (the error is below
// 2^-23 of x).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), fp32 accumulate
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// the 2-D box at (x = dim, y = row) of the bank's tensor map into shared
// memory at dst, completing on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// WQ query groups of QT n-tiles of 8 queries: QB = 8 * QT * WQ queries a
// CTA. Warp w takes query group w / RG and rows WM * (w % RG) .. + WM - 1
// of each tile, RG = NW / WQ row groups of WM = 16 * MT rows; with KG > 1
// (one tile, WQ = 1), RG / KG row groups, and warp w the windows c with
// c % KG = w / (RG / KG).
template <int WQ, int QT, int MT, int KG>
__global__ void __launch_bounds__(NTH, WQ == 1 && QT == 1 ? 2 : 1) topk_kernel(
    const __grid_constant__ CUtensorMap bank_map, const float* __restrict__ queries,
    float* __restrict__ ws_s, int* __restrict__ ws_r, int* __restrict__ counters,
    float* __restrict__ out_s, int* __restrict__ out_i, int Q, int N, int D, int k,
    int n_split, int rows_per, int TR) {
  constexpr int WN = 8 * QT;   // queries a warp
  constexpr int QB = WN * WQ;  // queries a CTA
  constexpr int RG = NW / WQ;  // row groups
  constexpr int WM = 16 * MT;  // rows a warp
  constexpr int NS = 2 * QT;   // query slots a lane: (n-tile, column pair)
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[MAX_SLOTS], empty[MAX_SLOTS];
  __shared__ int is_last;

  // The k order: within dims 16p..16p+15, k-step 2p takes mma k index
  // t <- dim 16p + 4t and t + 4 <- 16p + 4t + 1, k-step 2p + 1 the dims
  // 16p + 4t + 2 and + 3, so one 16-byte load of dims 16p + 4t .. + 3
  // gives lane t its A (and B) values for both k-steps.
  const int n_pairs = (D + 15) / 16;
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float4* qf = reinterpret_cast<float4*>(ring + RING_BYTES / 4);  // [QB/8][n_pairs][32]
  float* ls = reinterpret_cast<float*>(qf + (QB / 8) * n_pairs * 32);  // [NW][WN][k]
  int* lr = reinterpret_cast<int*>(ls + NW * WN * k);                  // [NW][WN][k]
  float4* wb = reinterpret_cast<float4*>(lr + NW * WN * k);  // [chunk][RG / KG][32][MT * QT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split_id = blockIdx.x, qblk = blockIdx.y, q0 = qblk * QB;
  const int r_begin = (int)min((int64_t)N, (int64_t)split_id * rows_per);
  const int r_end = min(N, r_begin + rows_per);
  const int slots = RING_BYTES / (TR * BK * 4);
  const int n_tiles = (r_end - r_begin + TR - 1) / TR;
  const int n_chunks = (D + BK - 1) / BK;
  const int n_stages = n_tiles * n_chunks;  // stage s: tile s / n_chunks, chunk s % n_chunks
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / thread in group

  // The tiles stream through the ring (TMA, 128-byte swizzle: 16-byte
  // chunk c of tile row R lands at c ^ (R & 7); rows past N and dims past D
  // are zero-filled): warp 0 fills every slot at first, a stage a lane;
  // then at stage s thread 0 refills the slot stage s - 1 used, once all
  // warps have released it.
  const int first = min(slots, n_stages);
  int p_next = first, p_slot = 0, p_c = first % n_chunks;  // the next stage to load
  int p_row0 = r_begin + first / n_chunks * TR;
  auto produce = [&]() {
    mbar_expect_tx(&full[p_slot], TR * BK * 4);
    tma_load(ring + p_slot * TR * BK, &bank_map, p_c * BK, p_row0, &full[p_slot]);
    ++p_next;
    if (++p_slot == slots) p_slot = 0;
    if (++p_c == n_chunks) {
      p_c = 0;
      p_row0 += TR;
    }
  };
  if (tid == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the query plane: lane (g, t) of n-tile nt holds query nt * 8 + g; a
  // warp loads PU pairs of 16 dims of every n-tile at once
  constexpr int PU = 3;
  for (int p0 = warp; p0 < n_pairs; p0 += NW * PU) {
    float4 v[PU][QB / 8];
#pragma unroll
    for (int u = 0; u < PU; ++u)
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt) {
        const int n = q0 + nt * 8 + g, dim = (p0 + u * NW) * 16 + t * 4;
        v[u][nt] = (n < Q && dim < D)
                       ? *reinterpret_cast<const float4*>(queries + (int64_t)n * D + dim)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
    for (int u = 0; u < PU; ++u)
#pragma unroll
      for (int nt = 0; nt < QB / 8; ++nt)
        if (p0 + u * NW < n_pairs) qf[(nt * n_pairs + p0 + u * NW) * 32 + lane] = v[u][nt];
  }
  for (int i = tid; i < NW * WN * k; i += NTH) {
    ls[i] = -INFINITY;
    lr[i] = INT_MAX;
  }
  __syncthreads();
  if (warp == 0 && lane < first) {
    const int tile = lane / n_chunks, c0 = lane - tile * n_chunks;
    mbar_expect_tx(&full[lane], TR * BK * 4);
    tma_load(ring + lane * TR * BK, &bank_map, c0 * BK, r_begin + tile * TR, &full[lane]);
  }

  // Fragment row g reads tile row sg: a quarter-warp (g = 2q, 2q + 1)
  // then reads rows q and q + 4, whose swizzles differ in bit 2, so its
  // eight 16-byte loads hit all 32 banks.
  const int sg = ((g & 1) << 2) | (g >> 1);
  constexpr int rga = RG / KG;  // row groups
  const int wq = warp / RG, kg = (warp % RG) / rga, wr = warp % rga;
  const int wrow = wr * WM;  // the warp's first row within a tile
  float* my_ls = ls + warp * WN * k;
  int* my_lr = lr + warp * WN * k;
  const float4* my_qf = qf + wq * QT * n_pairs * 32 + lane;

  // per output: the hi.hi and the hi.lo + lo.hi accumulators of the
  // current 32-dim window, and the fp32 sum of the windows before it
  float acc[2][MT][QT][4], sum[MT][QT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[0][mt][nt][i] = acc[1][mt][nt][i] = sum[mt][nt][i] = 0.f;

  // stage s: ring slot `slot` in its use of parity `phase`, 32-dim chunk c
  // of the tile at row row0 (counted, not divided, from s)
  int slot = 0, phase = 0, c = 0, row0 = r_begin;
  auto advance = [&]() {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1;
    }
    if (++c == n_chunks) {
      c = 0;
      row0 += TR;
    }
  };
  for (int s = 0; s < n_stages; ++s, advance()) {
    if (tid == 0 && s > 0 && p_next < n_stages) {
      // refill the slot of stage s - 1 (p_slot) once every warp released it
      mbar_wait(&empty[p_slot], slot == 0 ? phase ^ 1 : phase);
      produce();
    }
    const bool rows_here = wrow < TR && row0 + wrow < r_end;
    const bool active = rows_here && (c & (KG - 1)) == kg;  // warp-uniform
    mbar_wait(&full[slot], phase);
    if (active) {
      const float* buf = ring + slot * TR * BK;
      const int pairs = min(BK / 16, n_pairs - c * (BK / 16));
#pragma unroll
      for (int pp = 0; pp < BK / 16; ++pp) {
        if (pp >= pairs) break;
        const int p = c * (BK / 16) + pp;
        float4 a[MT][2];  // [m-tile][fragment rows g, g + 8]
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[mt][h] = *reinterpret_cast<const float4*>(
                buf + (wrow + mt * 16 + h * 8 + sg) * BK + (((4 * pp + t) ^ sg) << 2));
        float4 b[QT];
#pragma unroll
        for (int nt = 0; nt < QT; ++nt) b[nt] = my_qf[(nt * n_pairs + p) * 32];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            split(kk ? a[mt][0].z : a[mt][0].x, ah[mt][0], al[mt][0]);  // row g, k t
            split(kk ? a[mt][1].z : a[mt][1].x, ah[mt][1], al[mt][1]);  // row g + 8, k t
            split(kk ? a[mt][0].w : a[mt][0].y, ah[mt][2], al[mt][2]);  // row g, k t + 4
            split(kk ? a[mt][1].w : a[mt][1].y, ah[mt][3], al[mt][3]);  // row g + 8, k t + 4
          }
#pragma unroll
          for (int nt = 0; nt < QT; ++nt) {
            uint32_t bh0, bl0, bh1, bl1;
            split(kk ? b[nt].z : b[nt].x, bh0, bl0);  // query g, k t
            split(kk ? b[nt].w : b[nt].y, bh1, bl1);  // query g, k t + 4
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_tf32(acc[0][mt][nt], ah[mt], bh0, bh1);
              mma_tf32(acc[1][mt][nt], ah[mt], bl0, bl1);
              mma_tf32(acc[1][mt][nt], al[mt], bh0, bh1);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);  // the slot may be refilled
    // the 32-dim window's scores, hi.hi + (hi.lo + lo.hi), into the fp32
    // sums in window order: here, or with KG > 1 through shared memory
    float4* my_wb = wb + ((c * rga + wr) * 32 + lane) * (MT * QT);
    if (active) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < QT; ++nt) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[i] = __fadd_rn(acc[0][mt][nt][i], acc[1][mt][nt][i]);
            acc[0][mt][nt][i] = acc[1][mt][nt][i] = 0.f;
            if (KG == 1) sum[mt][nt][i] = __fadd_rn(sum[mt][nt][i], w[i]);
          }
          if (KG > 1) my_wb[mt * QT + nt] = make_float4(w[0], w[1], w[2], w[3]);
        }
    }
    if (c < n_chunks - 1) continue;
    if (KG > 1) {
      __syncthreads();  // every window of the (only) tile is in wb
      if (kg != 0 || !rows_here) continue;
      for (int cc = 0; cc < n_chunks; ++cc)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < QT; ++nt) {
            const float4 w = wb[((cc * rga + wr) * 32 + lane) * (MT * QT) + mt * QT + nt];
            sum[mt][nt][0] = __fadd_rn(sum[mt][nt][0], w.x);
            sum[mt][nt][1] = __fadd_rn(sum[mt][nt][1], w.y);
            sum[mt][nt][2] = __fadd_rn(sum[mt][nt][2], w.z);
            sum[mt][nt][3] = __fadd_rn(sum[mt][nt][3], w.w);
          }
    } else if (!active) {
      continue;
    }

    // The tile's scores are complete. Lane (g, t) holds, for query slot
    // (nt, j) = warp query nt * 8 + 2t + j, the rows sg + 8h + 16mt, h and
    // mt < MT: sum[mt][nt][2h + j]. A score stays a candidate (not
    // -inf) only if it beats its warp's list's last entry.
    int rows[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wrow + mt * 16 + h * 8 + sg;
        rows[mt][h] = row < r_end ? row : INT_MAX;
      }
    unsigned live = 0;  // bit nt * 2 + j: a candidate for that slot
#pragma unroll
    for (int nt = 0; nt < QT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qw = nt * 8 + 2 * t + j;
        const bool qok = q0 + wq * WN + qw < Q;
        const float ts = my_ls[qw * k + k - 1];
        const int tr = my_lr[qw * k + k - 1];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = sum[mt][nt][2 * h + j];
            if (!qok || rows[mt][h] == INT_MAX || !better(v, rows[mt][h], ts, tr))
              v = -INFINITY;
            else
              live |= 1u << (nt * 2 + j);
          }
      }
    // Rounds: per live slot, the best candidate of the query's 8 lanes (a
    // shuffle reduce) enters the list (lane g = 0 shifts it in) if it
    // beats the list's last entry, and its owner drops it; if it does
    // not, the 8 lanes drop the slot. At most k + 1 rounds.
    unsigned act = __reduce_or_sync(FULL, live);
    while (act) {
      live = 0;
#pragma unroll
      for (int sl = 0; sl < NS; ++sl) {
        if (!(act & (1u << sl))) continue;  // warp-uniform
        const int nt = sl >> 1, j = sl & 1;
        float bs = -INFINITY;
        int br = INT_MAX;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = sum[mt][nt][2 * h + j];
            if (v != -INFINITY && better(v, rows[mt][h], bs, br)) {
              bs = v;
              br = rows[mt][h];
            }
          }
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          const float os = __shfl_xor_sync(FULL, bs, m);
          const int orow = __shfl_xor_sync(FULL, br, m);
          if (better(os, orow, bs, br)) {
            bs = os;
            br = orow;
          }
        }
        float* L = my_ls + (nt * 8 + 2 * t + j) * k;
        int* R = my_lr + (nt * 8 + 2 * t + j) * k;
        const bool pass = br != INT_MAX && better(bs, br, L[k - 1], R[k - 1]);
        __syncwarp();
        if (pass && g == 0) shift_in(L, R, k, bs, br);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = sum[mt][nt][2 * h + j];
            if (!pass || rows[mt][h] == br) v = -INFINITY;
            if (v != -INFINITY) live |= 1u << sl;
          }
        __syncwarp();
      }
      act = __reduce_or_sync(FULL, live);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < QT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sum[mt][nt][i] = 0.f;
  }
  __syncthreads();

  // merge the row groups' lists of each query into row group 0's list
  for (int ql = warp; ql < QB && q0 + ql < Q; ql += NW) {
    const int w0 = (ql / WN) * RG, qw = ql % WN;
    float* dst_s = ls + (w0 * WN + qw) * k;
    int* dst_r = lr + (w0 * WN + qw) * k;
    merge_rounds(dst_s, dst_r, k, (RG - 1) * k,
                 [&](int i, float& s, int& r) {
                   const int o = ((w0 + 1 + i / k) * WN + qw) * k + i % k;
                   s = ls[o];
                   r = lr[o];
                 },
                 lane);
    if (n_split == 1) {
      write_out(dst_s, dst_r, k, out_s, out_i, q0 + ql, lane);
    } else if (lane < k) {
      const int64_t o = ((int64_t)(q0 + ql) * n_split + split_id) * k + lane;
      ws_s[o] = dst_s[lane];
      ws_r[o] = dst_r[lane];
    }
  }
  if (n_split == 1) return;

  // the last CTA of this query block to arrive merges every split's lists
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&counters[qblk], 1);
    is_last = prev == n_split - 1;
    if (is_last) counters[qblk] = 0;  // ready for the next launch
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  for (int ql = warp; ql < QB && q0 + ql < Q; ql += NW) {
    float* dst_s = ls + ql * k;  // free now
    int* dst_r = lr + ql * k;
    if (lane < k) {
      dst_s[lane] = -INFINITY;
      dst_r[lane] = INT_MAX;
    }
    __syncwarp();
    const float* cs = ws_s + (int64_t)(q0 + ql) * n_split * k;
    const int* cr = ws_r + (int64_t)(q0 + ql) * n_split * k;
    merge_rounds(dst_s, dst_r, k, n_split * k,
                 [&](int i, float& s, int& r) {
                   s = __ldcg(cs + i);
                   r = __ldcg(cr + i);
                 },
                 lane);
    write_out(dst_s, dst_r, k, out_s, out_i, q0 + ql, lane);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

template <int WQ, int QT, int MT, int KG>
int start(const CUtensorMap& map, const float* q, float* ws_s, int* ws_r, int* counters,
          float* out_s, int* out_i, int Q, int N, int D, int k, int n_split, int rows_per,
          int TR, dim3 grid, size_t smem, cudaStream_t stream) {
  auto kern = topk_kernel<WQ, QT, MT, KG>;
  static attn::SmemLimit limit;
  const int err = limit.raise((const void*)kern, (int)smem);
  if (err != 0) return err;
  kern<<<grid, NTH, smem, stream>>>(map, q, ws_s, ws_r, counters, out_s, out_i, Q, N, D, k,
                                    n_split, rows_per, TR);
  return (int)cudaGetLastError();
}

template <int WQ, int QT, int MT>
int launch(const float* q, const float* bank, float* ws_s, int* ws_r, int* counters,
           float* out_s, int* out_i, int Q, int N, int D, int k, int n_split, int rows_per,
           cudaStream_t stream) {
  constexpr int QB = 8 * QT * WQ;
  const int TR = tile_rows(rows_per, QB);
  const int KG = k_groups(QB, n_split, TR, D, k);
  const size_t smem = smem_bytes(QB, D, k, KG);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int n_qb = (Q + QB - 1) / QB;
  if (n_qb > 65535) return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(float)};
  const cuuint32_t box[2] = {BK, (cuuint32_t)TR};
  const cuuint32_t estrides[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(bank), dims, strides,
             box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_split, n_qb);
  if constexpr (QB == 8) {
    if (KG == 4)
      return start<WQ, QT, MT, 4>(map, q, ws_s, ws_r, counters, out_s, out_i, Q, N, D, k,
                                  n_split, rows_per, TR, grid, smem, stream);
    if (KG == 2)
      return start<WQ, QT, MT, 2>(map, q, ws_s, ws_r, counters, out_s, out_i, Q, N, D, k,
                                  n_split, rows_per, TR, grid, smem, stream);
  }
  return start<WQ, QT, MT, 1>(map, q, ws_s, ws_r, counters, out_s, out_i, Q, N, D, k, n_split,
                              rows_per, TR, grid, smem, stream);
}

}  // namespace

// queries (Q, D) and bank (N, D): float32, contiguous rows, 16-byte
// aligned; D a multiple of 4, at most 1024. qb: queries a CTA (8, 16, 24,
// 32 or 64); n_split CTAs along N, each rows_per rows (n_split *
// rows_per >= N). With n_split > 1, ws_s / ws_r: (Q, n_split, k) float32 /
// int32 scratch and counters: ceil(Q / qb) int32 arrival counters, all 0
// (the kernel leaves them 0); with n_split == 1 all three may be null.
// out_s / out_i: (Q, k) float32 / int32. 1 <= k <= 32, Q >= 1, N >= 1.
// Returns the launch's cudaError_t (0 = success).
extern "C" int topk_cosine_fwd(const void* queries, const void* bank, void* ws_s, void* ws_r,
                               void* counters, void* out_s, void* out_i, int Q, int N, int D,
                               int k, int qb, int n_split, int rows_per, void* stream) {
  if (Q <= 0 || N <= 0 || k < 1 || k > MAX_K || D <= 0 || D % 4 != 0 || D > MAX_D ||
      n_split < 1 || rows_per < 1 || (int64_t)n_split * rows_per < N ||
      (n_split > 1 && (ws_s == nullptr || ws_r == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  const float* b = static_cast<const float*>(bank);
  float* wss = static_cast<float*>(ws_s);
  int* wsr = static_cast<int*>(ws_r);
  int* ctr = static_cast<int*>(counters);
  float* os = static_cast<float*>(out_s);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qb) {
    case 8: return launch<1, 1, 2>(q, b, wss, wsr, ctr, os, oi, Q, N, D, k, n_split, rows_per, s);
    case 16: return launch<1, 2, 2>(q, b, wss, wsr, ctr, os, oi, Q, N, D, k, n_split, rows_per, s);
    case 24: return launch<1, 3, 2>(q, b, wss, wsr, ctr, os, oi, Q, N, D, k, n_split, rows_per, s);
    case 32: return launch<1, 4, 2>(q, b, wss, wsr, ctr, os, oi, Q, N, D, k, n_split, rows_per, s);
    case 64: return launch<4, 2, 4>(q, b, wss, wsr, ctr, os, oi, Q, N, D, k, n_split, rows_per, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
