// The forward of csrc/gtcrn_forward.cuh run on the host, CTA by CTA, with
// one std::thread per CUDA thread; the C entries mirror those of kernels B1
// (fused_step.cu) and B2 (fused_grid.cu).  Shared memory is filled with NaN
// before each CTA, so a read of a value no thread has written shows up in
// the output.  Built and driven by tests/test_torch_kernel_host.py.
#include <math.h>
#include <stdlib.h>

#include <thread>
#include <vector>

#include "gtcrn_forward.cuh"

thread_local Dim3 threadIdx, blockIdx, blockDim;
thread_local std::barrier<>* emu_cta_barrier;

using namespace gtcrn;

template <typename T, class IO>
static void run(const float* W, const Plan& p, const T* spec, T* out, const IO& io, int B) {
  const size_t n = SMEM_BYTES / sizeof(float);
  float* sm = static_cast<float*>(aligned_alloc(64, (SMEM_BYTES + 63) / 64 * 64));
  for (int blk = 0; blk < (B + TILE - 1) / TILE; ++blk) {
    for (size_t i = 0; i < n; ++i) sm[i] = NAN;
    std::barrier<> cta(NT);
    std::vector<std::thread> threads;
    for (int t = 0; t < NT; ++t)
      threads.emplace_back([&, t, blk] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)blk, 0, 0};
        blockDim = {(unsigned)NT, 1, 1};
        emu_cta_barrier = &cta;
        forward<T>(W, p, spec, out, io, blk * TILE, B, sm);
      });
    for (auto& th : threads) th.join();
  }
  free(sm);
}

// dtype: 0 = float32, 1 = bfloat16; the arguments of gtcrn_fused_grid_b2.
extern "C" int host_fused_grid_b2(int dtype, const float* W, const int* offs, int wlen,
                                  const void* spec, void* out, void* const* rings, int t, int B) {
  Plan p;
  if (B <= 0 || t < 0 || t > 15 || !make_plan(offs, wlen, &p)) return 1;
  auto go = [&](auto zero) {
    using T = decltype(zero);
    RingIO<T> io;
    for (int r = 0; r < N_RINGS; ++r) io.ring[r] = static_cast<T*>(rings[r]);
    io.t = t;
    io.B = B;
    run<T>(W, p, static_cast<const T*>(spec), static_cast<T*>(out), io, B);
  };
  if (dtype == 0) go(0.f); else go(__nv_bfloat16());
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16; the arguments of gtcrn_fused_step_b1.
extern "C" int host_fused_step_b1(int dtype, const float* W, const int* offs, int wlen,
                                  const void* spec, void* out, void* const* taps,
                                  void* const* frames, int B) {
  Plan p;
  if (B <= 0 || !make_plan(offs, wlen, &p)) return 1;
  auto go = [&](auto zero) {
    using T = decltype(zero);
    TapIO<T> io;
    for (int i = 0; i < 2 * N_RINGS; ++i) io.tap[i] = static_cast<const T*>(taps[i]);
    for (int r = 0; r < N_RINGS; ++r) io.frame[r] = static_cast<T*>(frames[r]);
    run<T>(W, p, static_cast<const T*>(spec), static_cast<T*>(out), io, B);
  };
  if (dtype == 0) go(0.f); else go(__nv_bfloat16());
  return 0;
}

// The runtime calls of prepare(): a current device, and a count per device
// of the shared-memory attributes set.
static int emu_device = 0;
static int emu_attrs_set[8];

cudaError_t cudaGetDevice(int* device) {
  *device = emu_device;
  return cudaSuccess;
}

template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int bytes) {
  if (bytes == (int)SMEM_BYTES) ++emu_attrs_set[emu_device];
  return cudaSuccess;
}

static void emu_kernel() {}

// prepare() of one kernel with `device` current (0..7); returns how often
// the attribute has been set on that device, or -1 if prepare() failed.
extern "C" int host_prepare_on(int device) {
  emu_device = device;
  return prepare(emu_kernel) ? -1 : emu_attrs_set[device];
}
