// Kernel B2: the per-frame GTCRN-Micro forward reading and writing the ring
// state in place.
//
// Replaces the Pallas kernel built by `_make_kernel` in
// gtcrn_micro_tpu/ops/fused_grid.py (grid over tiles, taps fetched from HBM
// by DMA, frames written back by async DMA).  Here each CTA reads its
// streams' taps straight from every ring at slots (t mod L, (t+d) mod L) and
// writes the new frame at slot t mod L, so the step needs no gather or
// scatter around the kernel.  The forward, its design and its bound are
// described in gtcrn_forward.cuh.

#include <string.h>

#include "gtcrn_forward.cuh"

using namespace gtcrn;

template <typename T>
__global__ void __launch_bounds__(NT, 1)
fused_grid_b2(const T* __restrict__ W, WOffs o, const T* __restrict__ spec, T* __restrict__ out,
              RingIO<T> io) {
  extern __shared__ float sm[];
  forward<T, TILE>(W, o, spec, out, io, blockIdx.x * TILE, io.B, sm);
}

template <typename T>
static int launch(const void* W, const int* offs, const void* spec, void* out,
                  void* const* rings, int t, int B, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(fused_grid_b2<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  WOffs o;
  memcpy(&o, offs, sizeof(WOffs));
  RingIO<T> io;
  for (int r = 0; r < N_RINGS; ++r) io.ring[r] = static_cast<T*>(rings[r]);
  io.t = t;
  io.B = B;
  const dim3 grid((B + TILE - 1) / TILE);
  fused_grid_b2<T><<<grid, NT, SMEM_BYTES, stream>>>(
      static_cast<const T*>(W), o, static_cast<const T*>(spec), static_cast<T*>(out), io);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (spec, weights and rings alike).  rings
// are the 20 ring tensors in RING_DEFS order, each (L, *frame, B); t is the
// step counter (0..15).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gtcrn_fused_grid_b2(int dtype, const void* W, const int* offs,
                                   const void* spec, void* out, void* const* rings, int t,
                                   int B, void* stream) {
  if (B <= 0 || t < 0 || t > 15) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(W, offs, spec, out, rings, t, B, s);
  if (dtype == 1) return launch<__nv_bfloat16>(W, offs, spec, out, rings, t, B, s);
  return (int)cudaErrorInvalidValue;
}
