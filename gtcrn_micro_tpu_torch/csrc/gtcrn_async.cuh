// Asynchronous global -> shared copies (cp.async, sm_80 and later), used to
// stage each layer's weights while the layer before it computes.

#pragma once

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

}  // namespace gtcrn
