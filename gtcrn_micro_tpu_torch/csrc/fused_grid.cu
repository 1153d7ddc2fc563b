// Kernel B2: the per-frame GTCRN-Micro forward reading and writing the ring
// state in place.
//
// Replaces the Pallas kernel built by `_make_kernel` in
// gtcrn_micro_tpu/ops/fused_grid.py (grid over tiles, taps fetched from HBM
// by DMA, frames written back by async DMA).  Here each CTA reads its
// streams' taps from every ring at slots (t mod L, (t+d) mod L) and writes
// the new frame at slot t mod L, so the step needs no gather or scatter
// around the kernel.  With bf16 storage and B % 8 == 0 the taps come into
// shared memory by tensor copies a layer ahead (StagedRingIO); otherwise
// each thread loads its own (RingIO).  The forward, its design and its
// bound are described in gtcrn_forward.cuh.

#include <type_traits>

#include "gtcrn_forward.cuh"

using namespace gtcrn;

template <typename T, class IO>
__global__ void __launch_bounds__(NT, MIN_CTAS)
fused_grid_b2(const float* __restrict__ W, const __grid_constant__ Plan p, const T* __restrict__ spec,
              T* __restrict__ out, const __grid_constant__ IO io) {
  extern __shared__ __align__(128) float sm[];
  forward<T>(W, p, spec, out, io, blockIdx.x * TILE, io.B, sm);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda);
// null where it is missing.
static EncodeTiledFn encoder() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(f)
                                                                : nullptr;
  }();
  return fn;
}

// dtype: 0 = float32, 1 = bfloat16 (spec, out and rings; the weights W are
// float32 either way, wlen floats, entry offsets in offs).  rings are the 20
// ring tensors in RING_DEFS order, each (L, *frame, B); t is the step counter
// (0..15).  *staged (if not null) is set to 1 where the launch took the
// staged path (staged_path), else 0.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gtcrn_fused_grid_b2(int dtype, const void* W, const int* offs, int wlen,
                                   const void* spec, void* out, void* const* rings, int t,
                                   int B, void* stream, int* staged) {
  Plan p;
  if (B <= 0 || t < 0 || t > 15 || !make_plan(offs, wlen, &p)) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + TILE - 1) / TILE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto& io, size_t bytes) -> int {
    using IO = std::remove_reference_t<decltype(io)>;
    using T = std::decay_t<decltype(*io.ring[0])>;
    const int e = prepare(fused_grid_b2<T, IO>, bytes);
    if (e) return e;
    for (int r = 0; r < N_RINGS; ++r) io.ring[r] = static_cast<T*>(rings[r]);
    io.t = t;
    io.B = B;
    fused_grid_b2<T, IO><<<grid, NT, bytes, s>>>(static_cast<const float*>(W), p,
                                                 static_cast<const T*>(spec), static_cast<T*>(out), io);
    return (int)cudaGetLastError();
  };
  const bool st = staged_path(dtype, B);
  if (staged) *staged = st;
  if (st) {
    StagedRingIO<__nv_bfloat16> io;
    const EncodeTiledFn encode = encoder();
    if (!encode || !encode_ring_maps(encode, rings, B, io.map)) return (int)cudaErrorInvalidValue;
    return launch(io, STAGED_SMEM_BYTES);
  }
  if (dtype == 1) {
    RingIO<__nv_bfloat16> io;
    return launch(io, SMEM_BYTES);
  }
  RingIO<float> io;
  return launch(io, SMEM_BYTES);
}

// out[12]: registers, local bytes, shared bytes and CTAs per SM of the
// float32, the bfloat16 and the staged bfloat16 instantiation.
extern "C" int gtcrn_fused_grid_attrs(int* out) {
  int e = kernel_attrs(fused_grid_b2<float, RingIO<float>>, out);
  if (!e) e = kernel_attrs(fused_grid_b2<__nv_bfloat16, RingIO<__nv_bfloat16>>, out + 4);
  if (!e)
    e = kernel_attrs(fused_grid_b2<__nv_bfloat16, StagedRingIO<__nv_bfloat16>>, out + 8,
                     STAGED_SMEM_BYTES);
  return e;
}
