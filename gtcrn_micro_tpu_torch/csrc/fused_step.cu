// Kernel B1: the per-frame GTCRN-Micro forward over gathered ring taps.
//
// Replaces the Pallas kernel `_kernel` of gtcrn_micro_tpu/ops/fused_step.py
// (launched per 128-stream tile by `_fused_call_tile`).  Here one launch
// covers the whole batch, one CTA per TILE streams.  The caller hands in the
// two tap frames of every ring (x_{t-2d}, x_{t-d}) and where each new frame
// goes; a frame may be its ring's tap 0 (the rings then update in place).
// The forward, its design and its bound are described in gtcrn_forward.cuh.

#include "gtcrn_forward.cuh"

using namespace gtcrn;

template <typename T>
__global__ void __launch_bounds__(NT, MIN_CTAS)
fused_step_b1(const float* __restrict__ W, const __grid_constant__ Plan p, const T* __restrict__ spec,
              T* __restrict__ out, const __grid_constant__ TapIO<T> io, int B) {
  extern __shared__ __align__(16) float sm[];
  forward<T>(W, p, spec, out, io, blockIdx.x * TILE, B, sm);
}

// dtype: 0 = float32, 1 = bfloat16 (spec, out, taps and frames; the weights
// W are float32 either way, wlen floats, entry offsets in offs).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int gtcrn_fused_step_b1(int dtype, const void* W, const int* offs, int wlen,
                                   const void* spec, void* out, void* const* taps,
                                   void* const* frames, int B, void* stream) {
  Plan p;
  if (B <= 0 || !make_plan(offs, wlen, &p)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto zero) -> int {
    using T = decltype(zero);
    const int e = prepare(fused_step_b1<T>);
    if (e) return e;
    TapIO<T> io;
    for (int i = 0; i < 2 * N_RINGS; ++i) io.tap[i] = static_cast<const T*>(taps[i]);
    for (int r = 0; r < N_RINGS; ++r) io.frame[r] = static_cast<T*>(frames[r]);
    fused_step_b1<T><<<grid, NT, SMEM_BYTES, s>>>(static_cast<const float*>(W), p,
                                                  static_cast<const T*>(spec),
                                                  static_cast<T*>(out), io, B);
    return (int)cudaGetLastError();
  };
  if (dtype == 0) return run(0.f);
  if (dtype == 1) return run(__nv_bfloat16());
  return (int)cudaErrorInvalidValue;
}

// out[8]: registers, local bytes, shared bytes and CTAs per SM of the float32
// and then the bfloat16 instantiation.
extern "C" int gtcrn_fused_step_attrs(int* out) {
  const int e = kernel_attrs(fused_step_b1<float>, out);
  return e ? e : kernel_attrs(fused_step_b1<__nv_bfloat16>, out + 4);
}
