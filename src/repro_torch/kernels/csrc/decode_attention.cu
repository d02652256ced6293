// Decode attention (one query token against a KV cache) for Hopper, sm_90a.
//
// Replaces repro/kernels/decode_attention.py::decode_attention (the Pallas
// TPU kernel `_decode_kernel`). Same function: for each sequence b and
// q head h, softmax over the first lengths[b] cache positions of
// q . k / sqrt(hd), times v; fp32 softmax; the G q heads of one kv group
// are handled together, kv head = h // G; a row of length 0 gives zeros.
//
// Design: the split-K chunk body and combine of decode_common.cuh, with
// the cache read in the model layout (B, M, Hkv, hd) through element
// strides, so the serving engine's per-layer cache view is used in place:
// no (B, Hkv, M, hd) transpose of the whole cache per step. The TPU kernel
// walks the cache in order on one core, carrying (m, l, acc) in scratch
// from one grid step to the next; here ceil(M / 32) chunks run on as many
// CTAs per (kv head, sequence) and a second kernel, launched from the same
// entry point, combines their partials in chunk order.
//
// What bounds it on an H100: memory. It reads 2*B*Hkv*len*hd cache
// elements for 4*B*Hq*hd*len flops (about one flop per byte in bf16), so
// the bound is the K/V bytes over 3.35 TB/s. At the serving path's shapes
// (B = 1, Hkv <= 32, len <= 192) that is well under a microsecond, and the
// kernel is latency-bound: one round trip for the chunk's loads, the
// scores and P V, then the combine.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "decode_common.cuh"

namespace {

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           void* scratch, int64_t scratch_floats, int B, int Hq, int Hkv, int M,
           const int64_t* st, cudaStream_t stream) {
  using Rows = attn::DenseRows<T>;
  const typename Rows::Params rp{static_cast<const T*>(k), static_cast<const T*>(v),
                                 st[2], st[3], st[4], st[5], st[6], st[7]};
  return attn::launch_decode<T, D, Rows>(q, st[0], st[1], lengths, rp, o, st[8], st[9],
                                         scratch, scratch_floats, B, Hq, Hkv, M, stream);
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const int* lengths,
               void* o, void* scratch, int64_t scratch_floats, int B, int Hq, int Hkv,
               int M, const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, scratch, scratch_floats, B, Hq, Hkv, M, st,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, scratch, scratch_floats, B, Hq, Hkv, M, st,
                           stream);
    case 80:
      return launch<T, 80>(q, k, v, lengths, o, scratch, scratch_floats, B, Hq, Hkv, M, st,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, scratch, scratch_floats, B, Hq, Hkv, M, st,
                            stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B, Hq, hd) by strides (b, h);
// k, v (B, M, Hkv, hd) by strides (b, m, h); o (B, Hq, hd) by strides
// (b, h); last dims contiguous; k, v and their strides (in bytes) multiples
// of 16 (the cp.async copies), which the Python wrapper checks. lengths:
// (B,) int32 on the device. scratch: at least scratch_floats fp32 on the
// device, B * Hkv * ceil(M / 32) * (Hq / Hkv) * (hd + 2) of them.
// Returns the first launch's cudaError_t (0 = success).
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    void* scratch, int64_t scratch_floats, int dtype, int B, int Hq, int Hkv, int M, int D,
    int64_t sqb, int64_t sqh, int64_t skb, int64_t skm, int64_t skh,
    int64_t svb, int64_t svm, int64_t svh, int64_t sob, int64_t soh,
    void* stream) {
  if (B <= 0 || M <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t st[10] = {sqb, sqh, skb, skm, skh, svb, svm, svh, sob, soh};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, len, o, scratch, scratch_floats, B, Hq, Hkv, M, st,
                             s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, scratch, scratch_floats, B, Hq, Hkv,
                                     M, st, s);
  return (int)cudaErrorInvalidValue;
}
