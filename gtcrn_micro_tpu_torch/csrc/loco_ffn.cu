// Kernel F: one TF-Locoformer FFN sub-layer, y = x + FFN(RMSGroupNorm(x)),
// masked past each sequence's frames where the block masks it, in one pass.
//
// Replaces no TPU kernel: the JAX package has no TF-Locoformer.  It was added
// for the conv-SwiGLU FFNs of nn/blocks.LocoformerBlock (C 128, hidden 384,
// kernel 4, stride 1), which aten runs as a window copy, an SGEMM on FFMA
// over 512-wide windows, SiLU and a product over the 768-wide output, a
// second SGEMM to the transposed conv's four taps, four overlap-add passes,
// a slice, the residual add, the mask and the norm before it: seven passes
// over the activations around 2 x 589,824 FLOPs a position.
//
// What bounds it.  1,179,648 FLOPs a position against 1 KB read and
// written: the tensor cores.  Each float32 product is three TF32 products
// (the operands split into a TF32 high part and a TF32 residual; lo*hi +
// hi*lo + hi*hi), float32's accuracy at up to 165 TFLOP/s of float32 work
// on an H100 (495 / 3) where FFMA gives 67.  The products are warpgroup
// MMAs (wgmma, sm_90a): A, the activations, from registers, split as they
// load; B, the weights, from shared memory.
//
// Design.  Sequences (N, S, C) are laid end to end with three zero
// positions before each one ("padded positions": sequence n's position s is
// padded position n (S + 3) + 3 + s).  The conv1d's window ending at padded
// position Q is then the four positions Q - 3 .. Q, zeros standing for the
// conv's own padding at both ends of every sequence, so one conv over the
// padded positions serves every sequence at once, also where a tile spans
// two of them (S = 129 along frequency), and the transposed conv's output at
// Q reads the hidden rows Q .. Q + 3.  A CTA owns 122 output positions; its
// two warpgroups own 61 each and run independently of each other:
//   1. prologue (the whole CTA): the 128 input rows Q0 - 3 .. Q0 + 124, each
//      normalised (4 groups of 32, x / (||x|| / sqrt(32) + eps) * gamma) by
//      one warp in registers, into shared memory (`xs`);
//   2. per chunk of 32 of the 384 hidden units: the conv1d as an implicit-
//      window GEMM, the warpgroup's 64 hidden rows x 512 (tap-major, four
//      shifted views of `xs`) x 64 columns (the chunk's 32 u and 32 g
//      units), accumulated in registers (a thread's u and g columns are the
//      same units, so the gate is taken in registers);
//   3. h = (u + b_u) * SiLU(g + b_g) into the warpgroup's own rows of shared
//      memory (`hs`, 64 rows of 32 and 3 zero rows);
//   4. the transposed conv1d as four shifted GEMMs, out[r] += h[r + 3 - j]
//      W2_j over the chunk's 32 units, into a register-resident 64 x 128
//      output;
//   5. epilogue: + deconv bias + the residual x, zero past frames where
//      asked, written once; rows 61 .. 63 and the separators' rows are
//      computed and dropped (4.7 % and 3 / (S + 3) of the work).
// The weights, split into TF32 hi and lo parts once and packed in the order
// the kernel reads them (ops/loco_ffn.pack: 144 stages of 32 KB, a hi and a
// lo tile of 8-row x 16-byte core matrices, K-major, unswizzled), stay in
// L2 (4.7 MB) and stream through a ring of 3 stages in shared memory, each
// one bulk copy by the tensor memory accelerator that completes on the
// slot's `full` mbarrier; each warpgroup releases a slot on its `empty`
// mbarrier when its products of the stage are done, and thread 0 refills
// it once both have.  So one warpgroup runs up to a stage ahead of the
// other, and its loads, splits and sums fill the tensor cores' gaps of the
// other's.  Inside each 8-deep step the K order is permuted (logical k = q
// and q + 4 at physical 2 q and 2 q + 1), so a lane's A fragment is two
// 8-byte loads from rows whose strides (136 and 40 floats) keep each half
// warp on distinct banks.  The tensor cores' own sums align and truncate
// (toward zero), so the 192 products of a 512-deep sum taken in one
// accumulator drift by ~4e-6 of it, one-sided: each stage's products (64
// or 32 deep) go into a fresh partial that is added in float32, ~2e-7.
// 189,424 bytes of dynamic shared memory, one CTA of 256 threads an SM.
//
// Nothing about the frames reaches the host (they are read on the device),
// and the kernel allocates nothing, so it is captured into a CUDA graph.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "gtcrn_async.cuh"
#include "gtcrn_mma.cuh"

namespace {

using gtcrn::mbar_expect;
using gtcrn::mbar_init;
using gtcrn::mbar_wait;
using gtcrn::smem_addr;
using gtcrn::tf32;

constexpr int C = 128;                    // channels
constexpr int HID = 384;                  // hidden units
constexpr int TAPS = 4;                   // conv kernel
constexpr int HC = 32;                    // hidden units a chunk
constexpr int CHUNKS = HID / HC;          // 12
constexpr int ROWS = 64;                  // GEMM rows a warpgroup
constexpr int MW = ROWS - (TAPS - 1);     // 61 output positions a warpgroup
constexpr int M = 2 * MW;                 // 122 a CTA
constexpr int XR = M + 2 * (TAPS - 1);    // 128 normalised input rows
constexpr int HR = ROWS + TAPS - 1;       // 67 hidden rows a warpgroup
constexpr int XS = C + 8;                 // xs row stride (floats)
constexpr int HS = HC + 8;                // hs row stride (floats)
constexpr int STAGE = 8192;               // floats a stage: 32 KB, hi and lo tiles
constexpr int TILE = STAGE / 2;
constexpr int KD1 = 64;                   // conv1d stage: 64 deep x 64 columns
constexpr int KD2 = HC;                   // transposed-conv stage: 32 deep x 128 columns
constexpr int G1_STAGES = TAPS * C / KD1; // 8 conv1d stages a chunk
constexpr int G2_STAGES = TAPS;           // 4 transposed-conv stages a chunk, one a tap
constexpr int STAGES = CHUNKS * (G1_STAGES + G2_STAGES);  // 144
constexpr int RING = 3;
constexpr int NT = 256;
constexpr size_t SMEM_BYTES = sizeof(float) * (XR * XS + 2 * HR * HS + RING * STAGE) +
                              2 * RING * sizeof(unsigned long long);

struct Args {
  const float* x;            // (N, S, 128), contiguous
  const float* w;            // (144, 8192): the packed stages
  const float* b1;           // (768,): the conv1d's bias
  const float* b2;           // (128,): the transposed conv's bias
  const float* gamma;        // (128,): the norm's scale
  const long long* frames;   // (N,) valid positions a sequence, or null: no mask
  float* y;                  // (N, S, 128)
  int N, S;
  float eps;
};

// Copy `bytes` (a multiple of 16) from global src to shared dst, both
// 16-byte aligned, by the tensor memory accelerator; they count on bar.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One arrival on bar.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// The 128 threads of warpgroup w meet at named barrier 1 + w.
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Registers an asynchronous wgmma reads or writes: read and written here in
// the compiler's view, so no access moves across this point and none of
// them is reused before it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int K>
__device__ __forceinline__ void hold(unsigned (&r)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[k][i])::"memory");
}

// The descriptor of a K-major, unswizzled B tile of 8-row x 16-byte core
// matrices: `lbo` bytes to the next 4 of K, `sbo` to the next 8 rows.
__device__ __forceinline__ uint64_t desc(const float* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// d (64 x 64, this warpgroup) += a (64 x 8, registers) @ b (8 x 64, shared memory
// by descriptor), or = where scale_d is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// d (64 x 128, this warpgroup) += a (64 x 8, registers) @ b (8 x 128, shared memory
// by descriptor), or = where scale_d is 0
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4], uint64_t b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d)
      : "memory");
}

// a split into TF32 hi and lo parts, as mma operands: hi the float's own
// bits (the tensor cores read its 10 high mantissa bits), lo the rest of it
// rounded to TF32
__device__ __forceinline__ void split(float a, unsigned& hi, unsigned& lo) {
  hi = __float_as_uint(a);
  lo = tf32(a - __uint_as_float(hi & 0xffffe000u));
}

// One stage of a GEMM for this warpgroup's 64 rows x N columns, KSTEPS deep
// steps of 8: acc += A B with A rows `a + r * STRIDE` (this thread's rows r
// = g and g + 8 of its warp's 16, shifted by the caller) and B the stage's
// hi and lo tiles at `b`; the stage's 3 x KSTEPS products go into the
// partial t, then t into acc.
template <int STRIDE, int KSTEPS, int N>
__device__ __forceinline__ void stage_mma(float (&acc)[N / 2], float (&t)[N / 2], const float* a,
                                          const float* b, int g, int q) {
  unsigned ah[KSTEPS][4], al[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const float* p = a + g * STRIDE + kk * 8 + 2 * q;
    const float2 top = *reinterpret_cast<const float2*>(p);
    const float2 bot = *reinterpret_cast<const float2*>(p + 8 * STRIDE);
    split(top.x, ah[kk][0], al[kk][0]);
    split(bot.x, ah[kk][1], al[kk][1]);
    split(top.y, ah[kk][2], al[kk][2]);
    split(bot.y, ah[kk][3], al[kk][3]);
  }
  constexpr unsigned LBO = N / 8 * 128;  // bytes from one 4-deep column of core matrices to the next
  hold(t);
  hold(ah);
  hold(al);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t hi = desc(b + kk * 2 * LBO / 4, LBO, 128);
    const uint64_t lo = desc(b + TILE + kk * 2 * LBO / 4, LBO, 128);
    if constexpr (N == 64) {
      wgmma_n64(t, al[kk], hi, kk > 0);
      wgmma_n64(t, ah[kk], lo, 1);
      wgmma_n64(t, ah[kk], hi, 1);
    } else {
      wgmma_n128(t, al[kk], hi, kk > 0);
      wgmma_n128(t, ah[kk], lo, 1);
      wgmma_n128(t, ah[kk], hi, 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  hold(t);
  hold(ah);
  hold(al);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += t[i];
}

__global__ void __launch_bounds__(NT, 1) loco_ffn(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // RING stages of the packed weights
  float* xs = ring + RING * STAGE;     // (128, XS) normalised input rows
  float* hs_all = xs + XR * XS;        // (2, 67, HS) each warpgroup's 32 hidden units
  unsigned long long* full = reinterpret_cast<unsigned long long*>(hs_all + 2 * HR * HS);
  unsigned long long* empty = full + RING;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wg = warp >> 2;            // warpgroup: output positions Q0 + 61 wg + ..
  const int r0 = (warp & 3) * 16;      // the warp's first row in its warpgroup's 64
  const int ob = wg * MW;              // the warpgroup's first xs row: padded Q0 + ob - 3
  float* hs = hs_all + wg * HR * HS;
  const int SP = a.S + TAPS - 1;       // padded positions a sequence
  const long long Q0 = (long long)blockIdx.x * M;

  // stage s into slot s % RING, counted on full[s % RING]; thread 0 issues
  auto load_stage = [&](int s) {
    mbar_expect(&full[s % RING], STAGE * sizeof(float));
    bulk_load(ring + (s % RING) * STAGE, a.w + (size_t)s * STAGE, STAGE * sizeof(float),
              &full[s % RING]);
  };
  if (tid == 0) {
    for (int i = 0; i < RING; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);  // one arrival a warpgroup
    }
    for (int i = 0; i < RING; ++i) load_stage(i);
  }

  // 1. the normalised input rows; a separator or past the last sequence is 0
  for (int i = warp; i < XR; i += NT / 32) {
    const long long Q = Q0 - (TAPS - 1) + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    const long long n = Q >= 0 ? Q / SP : -1;
    const int s = Q >= 0 ? (int)(Q - n * SP) - (TAPS - 1) : -1;
    if (n >= 0 && n < a.N && s >= 0) {
      v = reinterpret_cast<const float4*>(a.x + ((size_t)n * a.S + s) * C)[lane];
      float ss = v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      ss += __shfl_xor_sync(0xffffffffu, ss, 2);
      ss += __shfl_xor_sync(0xffffffffu, ss, 4);
      const float d = sqrtf(ss) * 0.17677669529663687f + a.eps;
      const float4 gm = reinterpret_cast<const float4*>(a.gamma)[lane];
      v = make_float4(v.x / d * gm.x, v.y / d * gm.y, v.z / d * gm.z, v.w / d * gm.w);
    }
    reinterpret_cast<float4*>(xs + i * XS)[lane] = v;
  }
  // each warpgroup's hidden rows 64..66, read only by its dropped output rows
  for (int i = tid; i < 2 * HR * HS; i += NT)
    if (i % (HR * HS) >= ROWS * HS) hs_all[i] = 0.f;
  __syncthreads();

  // Stage s landed: wait for it.  Done with it (its products complete):
  // this warpgroup releases its slot, and thread 0 refills the slot of stage
  // s - 1 with stage s + 2 once both warpgroups have released it, so a
  // warpgroup runs up to a stage ahead of the other.
  auto begin = [&](int s) {
    mbar_wait(&full[s % RING], (s / RING) & 1);
    return ring + (s % RING) * STAGE;
  };
  auto end = [&](int s) {
    if ((tid & 127) == 0) mbar_arrive(&empty[s % RING]);
    const int done = s - (RING - 2);  // its slot takes stage s + 2
    if (tid == 0 && done >= 0 && s + 2 < STAGES) {
      mbar_wait(&empty[done % RING], (done / RING) & 1);
      load_stage(s + 2);
    }
    __syncwarp();
  };

  // accumulators in the wgmma layout: element 4 j + e is row g + 8 (e / 2)
  // of the warp's 16, column 8 j + 2 q + e % 2
  float out[64], t2[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) out[i] = t2[i] = 0.f;

  int s = 0;
  for (int c = 0; c < CHUNKS; ++c) {
    // 2. conv1d: hidden row r (padded position Q0 + ob + r) reads input rows
    // ob + r .. ob + r + 3
    float acc[32], t1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = t1[i] = 0.f;
    for (int ks = 0; ks < G1_STAGES; ++ks, ++s) {
      const float* b = begin(s);
      const int tap = ks / (C / KD1), c0 = (ks % (C / KD1)) * KD1;
      stage_mma<XS, KD1 / 8, 64>(acc, t1, xs + (ob + r0 + tap) * XS + c0, b, g, q);
      end(s);
    }
    // 3. the gate: columns 8 j + .. (j < 4) are u of units 8 j + .., j + 4
    // their g; the warpgroup's last chunk is done with hs
    warpgroup_sync(wg);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hcol = j * 8 + 2 * q;  // unit c * 32 + hcol
      const float2 bu = *reinterpret_cast<const float2*>(a.b1 + c * HC + hcol);
      const float2 bg = *reinterpret_cast<const float2*>(a.b1 + HID + c * HC + hcol);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float u0 = acc[4 * j + 2 * half] + bu.x, u1 = acc[4 * j + 2 * half + 1] + bu.y;
        const float g0 = acc[4 * (j + 4) + 2 * half] + bg.x;
        const float g1 = acc[4 * (j + 4) + 2 * half + 1] + bg.y;
        const float2 h = make_float2(u0 * (g0 / (1.f + expf(-g0))),
                                     u1 * (g1 / (1.f + expf(-g1))));
        *reinterpret_cast<float2*>(hs + (r0 + g + 8 * half) * HS + hcol) = h;
      }
    }
    warpgroup_sync(wg);
    // 4. transposed conv: out[r] += h[r + 3 - j] W2_j, a stage a tap
    for (int j = 0; j < G2_STAGES; ++j, ++s) {
      const float* b = begin(s);
      stage_mma<HS, KD2 / 8, 128>(out, t2, hs + (r0 + TAPS - 1 - j) * HS, b, g, q);
      end(s);
    }
  }

  // 5. + bias + residual, masked past frames where asked, for the 61 real rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const long long Q = Q0 + ob + r;
    const long long n = Q / SP;
    const int sq = (int)(Q - n * SP) - (TAPS - 1);
    if (r >= MW || n >= a.N || sq < 0) continue;
    const bool zero = a.frames != nullptr && sq >= a.frames[n];
    const size_t base = ((size_t)n * a.S + sq) * C;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + 2 * q;
      const float2 xr = *reinterpret_cast<const float2*>(a.x + base + col);
      const float2 bb = *reinterpret_cast<const float2*>(a.b2 + col);
      float2 v = make_float2(xr.x + (out[4 * j + 2 * half] + bb.x),
                             xr.y + (out[4 * j + 2 * half + 1] + bb.y));
      if (zero) v = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(a.y + base + col) = v;
    }
  }
}

int prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  e = cudaFuncSetAttribute(loco_ffn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e == cudaSuccess) done.fetch_or(bit);
  return (int)e;
}

}  // namespace

// x (N, S, 128) float32 contiguous; w the packed stages (ops/loco_ffn.pack);
// b1 (768,), b2 (128,), gamma (128,) float32; frames (N,) int64 or null; y
// (N, S, 128) float32, not x, every element written.  One CTA a tile of 122
// padded positions.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int gtcrn_loco_ffn(const void* x, const void* w, const void* b1, const void* b2,
                              const void* gamma, const void* frames, void* y, int N, int S,
                              float eps, void* stream) {
  if (N <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)N * (S + TAPS - 1) + M - 1) / M;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int e = prepare();
  if (e) return e;
  const Args a{static_cast<const float*>(x),     static_cast<const float*>(w),
               static_cast<const float*>(b1),    static_cast<const float*>(b2),
               static_cast<const float*>(gamma), static_cast<const long long*>(frames),
               static_cast<float*>(y),           N,
               S,                                eps};
  loco_ffn<<<(unsigned)tiles, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// out[4]: registers per thread, local bytes per thread, shared bytes per CTA
// and resident CTAs per SM.
extern "C" int gtcrn_loco_ffn_attrs(int* out) {
  int e = prepare();
  cudaFuncAttributes fa;
  if (!e) e = (int)cudaFuncGetAttributes(&fa, loco_ffn);
  int ctas = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, loco_ffn, NT, SMEM_BYTES);
  if (e) return e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)(fa.sharedSizeBytes + SMEM_BYTES);
  out[3] = ctas;
  return 0;
}
