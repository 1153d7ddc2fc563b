// The warp-level PTX of the forward's channel mixes (sm_80 and later): TF32
// rounding, the m16n8k8 TF32 product, and the thread index read anew.

#pragma once

#include <cuda_runtime.h>

namespace gtcrn {

// threadIdx.x by a volatile read, which the compiler neither merges with
// another read nor moves out of a loop.
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero), its
// 13 low bits zero (as read on an H100), as a .b32 operand of mma.
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d (16x8) += a (16x8, row-major) @ b (8x8, column-major) for the warp, all
// 32 lanes together.  With g = lane / 4 and q = lane % 4, a lane holds
// a = {A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]}, b = {B[q][g], B[q+4][g]}
// and d = {D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace gtcrn
