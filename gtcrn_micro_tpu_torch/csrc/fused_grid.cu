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

#include "gtcrn_forward.cuh"

using namespace gtcrn;

template <typename T>
__global__ void __launch_bounds__(NT, MIN_CTAS)
fused_grid_b2(const float* __restrict__ W, const __grid_constant__ Plan p, const T* __restrict__ spec,
              T* __restrict__ out, const __grid_constant__ RingIO<T> io) {
  extern __shared__ __align__(16) float sm[];
  forward<T>(W, p, spec, out, io, blockIdx.x * TILE, io.B, sm);
}

// dtype: 0 = float32, 1 = bfloat16 (spec, out and rings; the weights W are
// float32 either way, wlen floats, entry offsets in offs).  rings are the 20
// ring tensors in RING_DEFS order, each (L, *frame, B); t is the step counter
// (0..15).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gtcrn_fused_grid_b2(int dtype, const void* W, const int* offs, int wlen,
                                   const void* spec, void* out, void* const* rings, int t,
                                   int B, void* stream) {
  Plan p;
  if (B <= 0 || t < 0 || t > 15 || !make_plan(offs, wlen, &p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) -> int {
    using T = decltype(zero);
    const int e = prepare(fused_grid_b2<T>);
    if (e) return e;
    RingIO<T> io;
    for (int r = 0; r < N_RINGS; ++r) io.ring[r] = static_cast<T*>(rings[r]);
    io.t = t;
    io.B = B;
    fused_grid_b2<T><<<grid, NT, SMEM_BYTES, s>>>(static_cast<const float*>(W), p,
                                                  static_cast<const T*>(spec),
                                                  static_cast<T*>(out), io);
    return (int)cudaGetLastError();
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

// out[8]: registers, local bytes, shared bytes and CTAs per SM of the float32
// and then the bfloat16 instantiation.
extern "C" int gtcrn_fused_grid_attrs(int* out) {
  const int e = kernel_attrs(fused_grid_b2<float>, out);
  return e ? e : kernel_attrs(fused_grid_b2<__nv_bfloat16>, out + 4);
}
