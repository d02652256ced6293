// Paged decode attention (one query token against K/V held in a shared page
// pool, reached through a page table) for Hopper, sm_90a.
//
// Replaces repro/kernels/paged_attention.py::paged_decode_attention (the
// Pallas TPU kernel `_paged_kernel`). Same function: for each sequence b and
// q head h, softmax over the first lengths[b] positions of q . k / sqrt(hd),
// times v, where position s lives at pool row page_table[b, s / ps], slot
// s % ps of the (N, ps, Hkv, hd) slabs. Table entries below 0 (the -1 past a
// sequence's last page) are clamped to row 0, as the TPU kernel's index map
// does, and positions at or past the length are masked. fp32 softmax.
//
// Design: the dense decode kernel's split-K chunk body and combine
// (decode_common.cuh) with one change, the address of each cache position
// (attn::PagedRows). The TPU kernel gets the page rows by scalar prefetch
// ahead of the grid; on Hopper each chunk CTA reads its own table entries:
// with pages that are a multiple of the 32-position chunk, one entry per
// chunk; with smaller pages one per position, and every load's address then
// waits on a table read. Since the chunking, the thread -> element maps
// and the order of every sum are the dense kernel's, the result is bitwise
// equal to decode_attention on the cache gathered in table order, and
// bitwise batch-invariant.
//
// What bounds it on an H100: memory, as the dense kernel: 2*B*Hkv*len*hd
// K/V elements for 4*B*Hq*hd*len flops. At the prefix path's shapes (B = 4,
// Hkv <= 16, len <= 192) it is latency-bound: a table read, then the
// chunk's loads, then the combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "decode_common.cuh"

namespace {

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* table,
           const int* lengths, void* o, void* scratch, int64_t scratch_floats, int B,
           int Hq, int Hkv, int N, int ps, int P, const int64_t* st, cudaStream_t stream) {
  using Rows = attn::PagedRows<T>;
  const typename Rows::Params rp{static_cast<const T*>(k), static_cast<const T*>(v), table,
                                 N, ps, P, st[2], st[3], st[4], st[5], st[6], st[7]};
  return attn::launch_decode<T, D, Rows>(q, st[0], st[1], lengths, rp, o, st[8], st[9],
                                         scratch, scratch_floats, B, Hq, Hkv, P * ps, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* table,
               const int* lengths, void* o, void* scratch, int64_t scratch_floats, int B,
               int Hq, int Hkv, int N, int ps, int P, const int64_t* st,
               cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, table, lengths, o, scratch, scratch_floats, B, Hq, Hkv,
                           N, ps, P, st, stream);
    case 64:
      return launch<T, 64>(q, k, v, table, lengths, o, scratch, scratch_floats, B, Hq, Hkv,
                           N, ps, P, st, stream);
    case 128:
      return launch<T, 128>(q, k, v, table, lengths, o, scratch, scratch_floats, B, Hq, Hkv,
                            N, ps, P, st, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, hd) by strides (b, h);
// k, v (N, ps, Hkv, hd) pool slabs by strides (row, slot, h); o (B, Hq, hd)
// by strides (b, h); last dims contiguous; k, v and their strides (in
// bytes) multiples of 16 (the cp.async copies), which the Python wrapper
// checks. table: (B, P) int32, contiguous; lengths: (B,) int32; both on the
// device. scratch: at least scratch_floats fp32 on the device,
// B * Hkv * ceil(P * ps / 32) * (Hq / Hkv) * (hd + 2) of them. Returns the
// first launch's cudaError_t (0 = success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* table,
    const void* lengths, void* o, void* scratch, int64_t scratch_floats, int dtype, int B,
    int Hq, int Hkv, int N, int ps, int P, int D, int64_t sqb, int64_t sqh, int64_t skn,
    int64_t skp, int64_t skh, int64_t svn, int64_t svp, int64_t svh, int64_t sob,
    int64_t soh, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || N <= 0 || ps <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t st[10] = {sqb, sqh, skn, skp, skh, svn, svp, svh, sob, soh};
  const int* tb = static_cast<const int*>(table);
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, tb, len, o, scratch, scratch_floats, B, Hq, Hkv, N,
                             ps, P, st, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, tb, len, o, scratch, scratch_floats, B, Hq,
                                     Hkv, N, ps, P, st, s);
  return (int)cudaErrorInvalidValue;
}
