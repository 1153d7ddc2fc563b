// Kernel B1: the per-frame GTCRN-Micro forward over gathered ring taps.
//
// Replaces the Pallas kernel `_kernel` of gtcrn_micro_tpu/ops/fused_step.py
// (launched per 128-stream tile by `_fused_call_tile`).  Here one launch
// covers the whole batch, one CTA per TILE streams.  The caller hands in the
// two tap frames of every ring (x_{t-2d}, x_{t-d}) and gets the 20 new frames
// back in separate buffers; it writes them into the rings itself.  The
// forward, its design and its bound are described in gtcrn_forward.cuh.

#include <string.h>

#include "gtcrn_forward.cuh"

using namespace gtcrn;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
fused_step_b1(const T* __restrict__ W, WOffs o, const T* __restrict__ spec, T* __restrict__ out,
              TapIO<T> io, int B) {
  extern __shared__ float sm[];
  forward<T, TILE>(W, o, spec, out, io, blockIdx.x * TILE, B, sm);
}

template <typename T>
static int launch(const void* W, const int* offs, const void* spec, void* out,
                  void* const* taps, void* const* frames, int B, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(fused_step_b1<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  WOffs o;
  memcpy(&o, offs, sizeof(WOffs));
  TapIO<T> io;
  for (int i = 0; i < 2 * N_RINGS; ++i) io.tap[i] = static_cast<const T*>(taps[i]);
  for (int r = 0; r < N_RINGS; ++r) io.frame[r] = static_cast<T*>(frames[r]);
  const dim3 grid((B + TILE - 1) / TILE);
  fused_step_b1<T><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(W), o, static_cast<const T*>(spec), static_cast<T*>(out), io, B);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (spec, weights, taps and frames alike).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int gtcrn_fused_step_b1(int dtype, const void* W, const int* offs,
                                   const void* spec, void* out, void* const* taps,
                                   void* const* frames, int B, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(W, offs, spec, out, taps, frames, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(W, offs, spec, out, taps, frames, B, s);
  return (int)cudaErrorInvalidValue;
}
