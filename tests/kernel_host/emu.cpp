// The forward of csrc/gtcrn_forward.cuh run on the host, CTA by CTA, with
// one std::thread per CUDA thread and an EmuWarp (gtcrn_mma.cuh) per warp;
// the C entries mirror those of kernels B1 (fused_step.cu) and B2
// (fused_grid.cu), host_mix runs one warp's channel mix alone and
// host_mma_products counts the warps' mma products.  Shared memory is filled
// with NaN before each CTA, so a read of a value no thread has written shows
// up in the output.  B2 takes the staged path where the card's entry does
// (staged_path), its tensor maps made by emu_encode_tiled.  Built and driven
// by tests/test_torch_kernel_host.py.
#include <math.h>
#include <stdlib.h>

#include <thread>
#include <type_traits>
#include <vector>

#include "gtcrn_forward.cuh"

thread_local Dim3 threadIdx, blockIdx, blockDim;
thread_local std::barrier<>* emu_cta_barrier;

using namespace gtcrn;

template <typename T, class IO>
static void run(const float* W, const Plan& p, const T* spec, T* out, const IO& io, int B,
                size_t bytes = SMEM_BYTES) {
  const size_t n = bytes / sizeof(float);
  float* sm = static_cast<float*>(aligned_alloc(128, (bytes + 127) / 128 * 128));
  for (int blk = 0; blk < (B + TILE - 1) / TILE; ++blk) {
    for (size_t i = 0; i < n; ++i) sm[i] = NAN;
    std::barrier<> cta(NT);
    std::vector<EmuWarp> warps(NT / 32);
    std::vector<std::thread> threads;
    for (int t = 0; t < NT; ++t)
      threads.emplace_back([&, t, blk] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)blk, 0, 0};
        blockDim = {(unsigned)NT, 1, 1};
        emu_cta_barrier = &cta;
        emu_warp = &warps[t / 32];
        forward<T>(W, p, spec, out, io, blk * TILE, B, sm);
      });
    for (auto& th : threads) th.join();
  }
  free(sm);
}

// cuTensorMapEncodeTiled for the emulated copies: the map of a tiled
// tensor, refused (as by the CUDA API) unless its base and strides are
// 16-byte aligned, its box is 1..256 elements a dim with inner rows of a
// 16-byte multiple, and element strides are 1.
static CUresult emu_encode_tiled(CUtensorMap* m, CUtensorMapDataType type, cuuint32_t rank,
                                 void* base, const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t* elem_strides,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (type != CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 || rank < 1 || rank > 4 ||
      reinterpret_cast<uintptr_t>(base) % 16)
    return CUDA_ERROR_INVALID_VALUE;
  *m = CUtensorMap{};
  m->base = static_cast<const char*>(base);
  m->rank = rank;
  m->elem = 2;
  for (cuuint32_t i = 0; i < 4; ++i) {
    m->dims[i] = i < rank ? dims[i] : 1;
    m->box[i] = i < rank ? box[i] : 1;
    if (i < rank && (dims[i] < 1 || box[i] < 1 || box[i] > 256 || elem_strides[i] != 1))
      return CUDA_ERROR_INVALID_VALUE;
    if (i + 1 < rank) {
      if (strides[i] % 16) return CUDA_ERROR_INVALID_VALUE;
      m->strides[i] = strides[i];
    }
  }
  return (box[0] * m->elem) % 16 ? CUDA_ERROR_INVALID_VALUE : CUDA_SUCCESS;
}

// dtype: 0 = float32, 1 = bfloat16; the arguments of gtcrn_fused_grid_b2
// but the stream.  *staged as there.
extern "C" int host_fused_grid_b2(int dtype, const float* W, const int* offs, int wlen,
                                  const void* spec, void* out, void* const* rings, int t, int B,
                                  int* staged) {
  Plan p;
  if (B <= 0 || t < 0 || t > 15 || !make_plan(offs, wlen, &p)) return 1;
  auto go = [&](auto& io, size_t bytes) {
    using T = std::decay_t<decltype(*io.ring[0])>;
    for (int r = 0; r < N_RINGS; ++r) io.ring[r] = static_cast<T*>(rings[r]);
    io.t = t;
    io.B = B;
    run<T>(W, p, static_cast<const T*>(spec), static_cast<T*>(out), io, B, bytes);
  };
  const bool st = staged_path(dtype, B);
  if (staged) *staged = st;
  if (st) {
    StagedRingIO<__nv_bfloat16> io;
    if (!encode_ring_maps(emu_encode_tiled, rings, B, io.map)) return 1;
    go(io, STAGED_SMEM_BYTES);
  } else if (dtype == 1) {
    RingIO<__nv_bfloat16> io;
    go(io, SMEM_BYTES);
  } else {
    RingIO<float> io;
    go(io, SMEM_BYTES);
  }
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

// One warp's mix of 16 channels: y = W x over 32 items, W (16, 16) row-major,
// x and y (16, 32) channel-major, item 16 mt + 8 h + g at row h of m-tile mt
// and lane g; x read as a tile in split (pair = 0) or pair order, y written
// from the pair-order tile.  products = 3 runs mix_tc; 1 runs the same
// fragments with the big TF32 parts alone (one TF32 product).
template <bool PAIR>
static void mix_warp(const float* w, const float* x, float* y, int products) {
  const Lane L;
  float t[16], acc[16];
  for (int j = 0; j < 16; ++j) {
    t[j] = x[L.c<PAIR>(j) * 32 + L.f(j) * TILE + L.g];
    acc[j] = 0.f;
  }
  const MixW<C, PAIR> m(w, L);
  if (products == 3) {
    mix_tc(acc, t, m);
  } else {
    for (int mt = 0; mt < 2; ++mt)
      for (int kb = 0; kb < 2; ++kb) {
        unsigned big[4], small[4];
        const int at[4] = {0, 2, 1, 3};
        for (int k = 0; k < 4; ++k) split(t[8 * mt + 4 * kb + at[k]], big[k], small[k]);
        for (int nt = 0; nt < 2; ++nt) {
          float(&d)[4] = *reinterpret_cast<float(*)[4]>(&acc[8 * mt + 4 * nt]);
          mma_tf32(d, big, m.big[nt][kb]);
        }
      }
  }
  for (int j = 0; j < 16; ++j) y[L.c<true>(j) * 32 + L.f(j) * TILE + L.g] = acc[j];
}

extern "C" int host_mix(const float* w, const float* x, float* y, int pair, int products) {
  if (products != 1 && products != 3) return 1;
  EmuWarp warp;
  std::vector<std::thread> threads;
  for (int t = 0; t < 32; ++t)
    threads.emplace_back([&, t] {
      threadIdx = {(unsigned)t, 0, 0};
      emu_warp = &warp;
      if (pair) mix_warp<true>(w, x, y, products); else mix_warp<false>(w, x, y, products);
    });
  for (auto& th : threads) th.join();
  return 0;
}

// The warp products (mma_tf32 calls of a warp) issued since the last call.
extern "C" unsigned long long host_mma_products() { return emu_mma_products.exchange(0); }

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
