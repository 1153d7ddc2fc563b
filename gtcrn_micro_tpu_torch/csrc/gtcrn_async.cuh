// Asynchronous global -> shared copies: cp.async (sm_80 and later), used to
// stage each layer's weights while the layer before it computes, and tensor
// copies (TMA, sm_90) completed on an mbarrier, used by B2 to stage each
// ring-reading layer's taps a layer ahead.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace gtcrn {

// Copy 16 bytes from global src to shared dst without going through
// registers; both 16-byte aligned.  Completes at the next cp_async_wait_all.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for every copy this thread issued; a barrier after it makes all
// threads' copies visible to the CTA.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory whose phase completes after `count` arrivals
// (and the bytes they announced); before any other thread uses it, a
// barrier of the CTA.
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar that announces `bytes` of tensor copies to come.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until bar's phase of parity `parity` has completed: its copies have
// landed and are visible to this thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// Order this thread's earlier accesses of shared memory before the tensor
// copies it issues next (a buffer read by the CTA, then refilled).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Copy the box of `map` at coordinates (x, y, z, w), innermost first, into
// shared dst (128-byte aligned), densely; its bytes count on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                            int w, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(x), "r"(y), "r"(z), "r"(w),
      "r"(smem_addr(bar))
      : "memory");
}

}  // namespace gtcrn
