// Helpers shared by the attention kernels (flash_attention.cu,
// decode_attention.cu, paged_decode_attention.cu), the scans (through
// scan_common.cuh) and topk_cosine.cu for Hopper, sm_90a:
// element conversions, 16-byte cp.async copies, and the once-per-device
// raise of a kernel's dynamic shared-memory limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>

namespace attn {

constexpr float NEG = -1e30f;  // mask value (finite, as the reference)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes global -> shared, asynchronously (cp.async, L2 only). With
// `pred` false nothing is read and the 16 bytes are zero-filled; `src`
// must still be a valid address. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kMaxDevices = 64;

// The dynamic shared-memory limit of one kernel instantiation. A launcher
// keeps one as a function-local static and calls raise() before each
// launch: cudaFuncSetAttribute runs only the first time a device needs more
// than the default 48 KB (and again only for a larger need), not on every
// launch. A failure is returned, and retried by the next launch.
struct SmemLimit {
  std::atomic<int> bytes[kMaxDevices] = {};  // the limit set on each device
  std::mutex mu;

  int raise(const void* kern, int need) {
    if (need <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= kMaxDevices)
      return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (bytes[dev].load(std::memory_order_acquire) >= need) return 0;
    std::lock_guard<std::mutex> lock(mu);
    if (bytes[dev].load(std::memory_order_relaxed) >= need) return 0;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err != cudaSuccess) return (int)err;
    bytes[dev].store(need, std::memory_order_release);
    return 0;
  }
};

}  // namespace attn
