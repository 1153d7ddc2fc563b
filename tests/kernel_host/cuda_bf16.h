// Stand-in for <cuda_bf16.h> on the host: bf16 as its 16 bits, widened
// exactly and rounded to nearest even, as the CUDA intrinsics do.
#pragma once
#include <stdint.h>
#include <string.h>

struct __nv_bfloat16 { uint16_t x; };

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{(uint16_t)((u >> 16) | 0x40)};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}
