// The whole per-frame GTCRN-Micro forward for one tile of TILE streams,
// shared by kernel B1 (fused_step.cu) and kernel B2 (fused_grid.cu).
//
// Replaces the forward of the JAX package's Pallas kernels
// (gtcrn_micro_tpu/ops/fused_step.py `_forward_values`, run by `_kernel` and
// by fused_grid.py `_make_kernel`).  Same math as the plain PyTorch version
// `forward_plain` in ops/fused_step.py: ERB merge -> SFE -> en0/en1 ->
// 3 GTConv -> 2x4 TCN -> 3 GTConv (+skips) -> de3/de4 -> ERB split -> mask.
//
// What bounds it on an H100: per stream and frame it reads 14,880 ring
// values, writes 7,440 and reads/writes 514 spec values each (bytes), and
// needs 550,815 multiply-adds, 1.10 MFLOP in f32 (operations; the ERB
// matrices count by their 382 nonzeros each); see PERF.md.  Neither bound is
// near: each CTA's chain of stages, not the card's throughput, sets its time
// (PERF.md has the measurements and what is left).  The design:
//
// - One CTA owns TILE streams and runs the network layer by layer with every
//   activation in shared memory, laid out [channel][freq][stream] (stream
//   innermost), so an item (f, s) of a layer is one offset in each channel
//   plane.
// - Weights: each layer's entries (one span of the float32 kernel weight
//   buffer, ops/fused_step.py kernel_weights) are copied into one of two
//   shared buffers with cp.async while the layer before runs.
// - The 16-input channel mixes (en1, each TCN's pw1 and pw3, the decoder
//   GTConvs' full 3x3 conv, every GTConv's pw2, de3), 85 % of the
//   multiply-adds (utils/roofline.tc_macs_per_stream), run on tensor cores
//   as three TF32 products (mma.sync m16n8k8, float32 to about 2^-21; see
//   "channel mixes on tensor cores" below).  A warp owns 32 items of an
//   F = 33 layer; a layer's weights are read once into mma fragments, in
//   registers, and a mix's output fragment is the next mix's input as it
//   stands.  Across a TCN stack each warp keeps the trunk in registers.
//   The depthwise convs run on the same tiles in FFMA.
// - The rest is one thread per item: the GTConvs' pw1, the TRA gate, en0,
//   de4, the ERB merge and split and the mask, each channel mix read as
//   float4 weight broadcasts, 4 input channels of one output row per load.
// - The ERB merge and split loop over band tables (first bin, length,
//   weights of each row's nonzero span), 382 multiply-adds each, not the
//   12,288 of the dense matrices.
// - Stages are fused where the data allow: a TCN block (pw1 -> depthwise
//   time conv -> pw3 + residual + PReLU) is one stage in registers; in a
//   GTConv the 3x3 conv feeds pw2 directly and the time taps' share of that
//   conv is summed before its first barrier; the TRA gate and the channel
//   interleave are one stage; SFE is computed as en0 loads its input; the
//   decoder's skip adds happen as the next layer loads its input.  32
//   barriers per frame.
// - Ring taps, B2 with bf16 storage and B % 8 == 0 (StagedRingIO): thread
//   0 copies each ring-reading layer's two tap frames (and a GTConv's two
//   TRA taps) by TMA, one 4-D tensor map a ring, into one of two 17,152-byte
//   stage buffers as the layer before begins; the layer waits on the
//   buffer's mbarrier, by which time the copies have landed.  The buffers
//   take a CTA's shared memory from 177,856 to 212,240 bytes (one CTA an SM
//   either way) and leave L1 the SM's last 28 KB, which no tap passes
//   through any more.  Elsewhere (f32, whose stage pair of 68,608 bytes does
//   not fit the 54,592 left; a B whose bf16 rows are not 16-byte multiples;
//   B1) the taps are loaded from device memory with every load of a round
//   issued before any is used (no load waits alone in a branch), and a
//   TCN's 32 tap values while the block before runs.
//
// Computation is float32 whatever the storage type T (float or bf16), with
// IEEE expf/tanhf/sqrtf and divisions (no fast-math); the tensor-core mixes
// keep float32 accuracy by their three TF32 products, not its rounding.
//
// Ring contract: a ring's taps are x_{t-2d} (tap 0) and x_{t-d} (tap 1); the
// new frame is written where tap 0 was read (B2, and B1 as its wrapper calls
// it, update in place), so every frame write comes after the CTA's last read
// of that ring's tap 0: a TCN item reads then writes its own addresses; a
// GTConv reads both taps of both its rings before its first barrier and
// writes their frames after it; staged, every thread writes a layer's
// frames only after its wait on the layer's copies.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include <atomic>

#include "gtcrn_async.cuh"
#include "gtcrn_mma.cuh"

namespace gtcrn {

constexpr int C = 16;       // channels
constexpr int H = 8;        // channel-split half
constexpr int F_FULL = 257; // STFT bins
constexpr int F_ERB = 129;  // 65 low bins + 64 ERB bands
constexpr int F_MID = 65;
constexpr int F_DOWN = 33;
constexpr int N_LO = 65;    // bins passed through the ERB unchanged
constexpr int N_RINGS = 20;
constexpr int N_WEIGHTS = 158;
constexpr int TILE = 8;     // streams per CTA
constexpr int ITEMS = F_DOWN * TILE;      // items (f, s) of an F = 33 layer, one per thread
constexpr int NT = (ITEMS + 31) / 32 * 32;  // threads per CTA

// ---------------------------------------------------------------------------
// weight entry offsets, in the order of ops/fused_step.py pack_weights
// ---------------------------------------------------------------------------

struct ConvW { int w, b, a; };
struct GtW { int pw1_w, pw1_b, a1, dw_w, dw_b, a2, pw2_w, pw2_b,
             tra_dw, tra_db, tra_pw, tra_pb; };
struct TcnW { int pw1_w, pw1_b, a1, dw_w, dw_b, a2, pw3_w, pw3_b, a3; };
struct WOffs {
  int bm_w, bs_w, sfe_w;
  ConvW en[2];
  GtW enc[3];
  TcnW tcn[8];
  GtW dec[3];
  ConvW de3;
  int de4_w, de4_b;
};
static_assert(sizeof(WOffs) == N_WEIGHTS * sizeof(int), "WOffs must mirror pack_weights");

// Weight groups: the entries one layer stages into shared memory together,
// each a span of the kernel weight buffer (ops/fused_step.py kernel_weights:
// the pack order with bs_w last).  G0 = ERB merge table, SFE, en0; G1 = en1;
// G2-4 encoder GTConvs; G5-12 TCNs; G13-15 decoder GTConvs; G16 = de3;
// G17 = de4 and the ERB split table.
constexpr int N_GROUPS = 18;
// the first pack-order entry of each group; a group holds the entries from
// its first to the next group's first, but bs_w (entry 1) is in the last
constexpr int GROUP_FIRST[N_GROUPS] = {0, 6, 9, 21, 33, 45, 54, 63, 72, 81, 90, 99, 108, 117, 129, 141, 153, 156};
constexpr int WBUF = 2816;  // floats per staging buffer; the largest group (a decoder GTConv) is 2,712
struct Plan {
  WOffs o;
  int gs[N_GROUPS + 1];  // group g is floats [gs[g], gs[g + 1]) of the buffer
};

inline int group_of(int entry) {
  if (entry == 1) return N_GROUPS - 1;
  int g = 0;
  while (g + 1 < N_GROUPS && GROUP_FIRST[g + 1] <= entry) ++g;
  return g;
}

// Fill *p from the entry offsets; false unless every offset is 16-byte
// aligned inside the buffer, every group is a non-empty span of at most
// WBUF floats in layer order, and every entry starts inside its group's span.
inline bool make_plan(const int* offs, int wlen, Plan* p) {
  if (wlen % 4) return false;
  for (int i = 0; i < N_WEIGHTS; ++i)
    if (offs[i] < 0 || offs[i] >= wlen || offs[i] % 4) return false;
  memcpy(&p->o, offs, sizeof(WOffs));
  int* gs = p->gs;
  for (int g = 0; g < N_GROUPS; ++g) gs[g] = offs[GROUP_FIRST[g]];
  gs[N_GROUPS] = wlen;
  for (int g = 0; g < N_GROUPS; ++g)
    if (gs[g + 1] <= gs[g] || gs[g + 1] - gs[g] > WBUF) return false;
  for (int i = 0; i < N_WEIGHTS; ++i) {
    const int g = group_of(i);
    if (offs[i] < gs[g] || offs[i] >= gs[g + 1]) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// rings, in the order of RING_DEFS: enc{0..2}_dw, enc{0..2}_tra,
// dec{0..2}_dw, dec{0..2}_tra, tcn{s}{j} (s = 0..1, j = 0..3)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int ring_len(int r) { return r < 12 ? 2 : 2 << ((r - 12) & 3); }
__host__ __device__ constexpr int ring_stride(int r) { return r < 12 ? 1 : 1 << ((r - 12) & 3); }
__host__ __device__ constexpr int ring_frame(int r) {
  return ((r >= 3 && r < 6) || (r >= 9 && r < 12)) ? H : C * F_DOWN;
}
constexpr int ENC_DW = 0, ENC_TRA = 3, DEC_DW = 6, DEC_TRA = 9, TCN = 12;

// One tap frame of a ring as a CTA reads it: value i (= c * F + f, or c for a
// TRA ring) of the CTA's stream s at p[i * stride + stream(s)]; a stream past
// B reads the last real one (its outputs are never written).
template <typename T>
struct Tap {
  const T* p;
  size_t stride;
  int last;
  __device__ __forceinline__ int stream(int s) const { return s < last ? s : last; }
};

// How the forward reaches the rings, one of three IO types: tap_of(r, k, ...)
// is tap k (0: x_{t-2d}, 1: x_{t-d}) of ring r, out(r) its new frame,
// (*frame, B) in device memory.  stage(l, ...) and wait(l, ...) bracket the
// staged copies of ring-reading layer l (StagedRingIO); here they do nothing.
struct NoStaging {
  static constexpr bool STAGED = false;
  __device__ __forceinline__ void stage(int, int, float*) const {}
  __device__ __forceinline__ void wait(int, float*) const {}
};

// B1: taps gathered by the caller, new frames where the caller says.
template <typename T>
struct TapIO : NoStaging {
  const T* tap[2 * N_RINGS];  // per ring: x_{t-2d}, x_{t-d}; each (*frame, B)
  T* frame[N_RINGS];          // per ring: the new frame, (*frame, B)
  __device__ __forceinline__ Tap<T> tap_of(int r, int k, int b0, int B, float*) const {
    return {tap[2 * r + k] + b0, (size_t)B, (B - b0 < TILE ? B - b0 : TILE) - 1};
  }
  __device__ __forceinline__ T* out(int r) const { return frame[r]; }
};

// B2: the ring state itself, (L, *frame, B) per ring, and the step counter;
// each tap read from device memory by the threads that use it.
template <typename T>
struct RingIO : NoStaging {
  T* ring[N_RINGS];
  int t;
  int B;
  __host__ __device__ __forceinline__ int slot(int r, int k) const {
    return (t + (k ? ring_stride(r) : 0)) % ring_len(r);
  }
  __device__ __forceinline__ T* at(int r, int slot) const {
    return ring[r] + (size_t)slot * ring_frame(r) * B;
  }
  __device__ __forceinline__ Tap<T> tap_of(int r, int k, int b0, int, float*) const {
    return {at(r, slot(r, k)) + b0, (size_t)B, (B - b0 < TILE ? B - b0 : TILE) - 1};
  }
  __device__ __forceinline__ T* out(int r) const { return at(r, slot(r, 0)); }
};

// ---------------------------------------------------------------------------
// numbers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float prelu(float x, float a) { return fmaxf(x, 0.f) + a * fminf(x, 0.f); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[co] += sum_ci w[co * CI + ci] * x[ci], ci ascending; w is a 16-byte
// aligned [CO][CI] block in shared memory, read as float4 broadcasts.
template <int CI, int CO>
__device__ __forceinline__ void mix(float (&acc)[CO], const float* w, const float (&x)[CI]) {
  static_assert(CI % 4 == 0, "rows are read 4 floats at a time");
#pragma unroll
  for (int co = 0; co < CO; ++co) {
#pragma unroll
    for (int c4 = 0; c4 < CI; c4 += 4) {
      const float4 q = ld4(w + co * CI + c4);
      acc[co] = fmaf(q.x, x[c4], acc[co]);
      acc[co] = fmaf(q.y, x[c4 + 1], acc[co]);
      acc[co] = fmaf(q.z, x[c4 + 2], acc[co]);
      acc[co] = fmaf(q.w, x[c4 + 3], acc[co]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// The item of an F = 33 layer this thread works on and whether it is real
// (the last warp holds fewer items; a thread past them computes on the last
// item and writes nothing).
struct Item {
  int it;
  bool valid;
};
__device__ __forceinline__ Item item33() {
  const int raw = tid_now();
  return {raw < ITEMS ? raw : ITEMS - 1, raw < ITEMS};
}

// ---------------------------------------------------------------------------
// channel mixes on tensor cores
// ---------------------------------------------------------------------------
//
// Warp w owns the 32 items of an F = 33 layer at rows f = 4 w + 2 mt + h
// (m-tile mt, half h) and stream s = g, with g = lane / 4 and q = lane % 4:
// the rows of two m16 tiles of mma.  A tile is those items by 16 channels,
// 16 floats a lane: value j = 8 mt + 4 kb + i is row h = i / 2 of m-tile mt
// and channel 8 kb + chan(q, i % 2) (Lane::f, Lane::c), in one of two orders:
// - split order, chan = q + 4 e: the A fragment's own; a warp's load of one
//   such value from a [c][f][s] plane is free of bank conflicts (plane
//   strides 33 x 8 and 65 x 8 are 8 mod 32);
// - pair order, chan = 2 q + e: the C fragment of a product with 16 outputs
//   (value 8 mt + 4 nt + i is D[row][8 nt + 2 q + e]), so one mix's output is
//   the next mix's input as it stands, K permuted to match.
// A mix of 16 inputs is, per m-tile, two k-steps of m16n8k8 per 8 outputs,
// with B = W^T read once into registers (MixW).  Each operand is split into
// TF32 parts, x = big + small, big = tf32(x), small = tf32(x - big), and
// the product big*big + big*small + small*big is accumulated in float32:
// float32 to about 2^-21 where one TF32 product keeps about 2^-11.  The
// inputs of a warp's rows past the layer (f > 32) are a real row's or zero,
// and their outputs are never written.

// This thread's place in its warp's tiles: warp w, g = lane / 4, q = lane %
// 4; c<PAIR>(j) and f(j) are value j's channel and row.  Each layer makes
// its own from threadIdx.x read anew (tid_now), so that nothing derived from
// it is hoisted out of the layer loops, where it would hold registers
// through every other layer.
struct Lane {
  int w, g, q;
  __device__ __forceinline__ Lane() {
    const int t = tid_now();
    w = t >> 5;
    g = (t & 31) >> 2;
    q = t & 3;
  }
  template <bool PAIR>
  __device__ __forceinline__ int c(int j) const {
    return 8 * ((j >> 2) & 1) + (PAIR ? 2 * q + (j & 1) : q + 4 * (j & 1));
  }
  __device__ __forceinline__ int f(int j) const { return 4 * w + 2 * (j >> 3) + ((j >> 1) & 1); }
};
// v clamped to [0, n): a tile's loads read a real address and select a zero
// after, so that no load sits in a branch of its own (each would wait)
__device__ __forceinline__ int clamp0(int v, int n) { return v < 0 ? 0 : (v < n ? v : n - 1); }

__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// The weights [CO][16] (row-major, 8-byte aligned) of a mix with CO outputs
// as split B fragments, K in the order of the input tile: [nt][kb][b0, b1]
// is W[8 nt + g][channels 8 kb + chan(q, 0 and 1)].
template <int CO, bool PAIR>
struct MixW {
  unsigned big[CO / 8][2][2], small[CO / 8][2][2];
  __device__ __forceinline__ MixW(const float* w, const Lane& L) {
    const int g = L.g, q = L.q;
#pragma unroll
    for (int nt = 0; nt < CO / 8; ++nt) {
#pragma unroll
      for (int kb = 0; kb < 2; ++kb) {
        const float* r = w + (8 * nt + g) * C + 8 * kb;
        float v[2];
        if (PAIR) {
          const float2 p = *reinterpret_cast<const float2*>(r + 2 * q);
          v[0] = p.x;
          v[1] = p.y;
        } else {
          v[0] = r[q];
          v[1] = r[q + 4];
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) split(v[e], big[nt][kb][e], small[nt][kb][e]);
      }
    }
  }
};

// acc (a pair-order tile of CO channels: value CO / 2 mt + 4 nt + i) += W @ x
// for the warp's 32 items, x a tile in W's order.
template <int CO, bool PAIR>
__device__ __forceinline__ void mix_tc(float (&acc)[CO], const float (&x)[16],
                                       const MixW<CO, PAIR>& w) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      unsigned big[4], small[4];
      const int at[4] = {0, 2, 1, 3};  // the A fragment's rows g, g + 8 of column q, then q + 4
#pragma unroll
      for (int k = 0; k < 4; ++k) split(x[8 * mt + 4 * kb + at[k]], big[k], small[k]);
#pragma unroll
      for (int nt = 0; nt < CO / 8; ++nt) {
        float(&d)[4] = *reinterpret_cast<float(*)[4]>(&acc[CO / 2 * mt + 4 * nt]);
        mma_tf32(d, small, w.big[nt][kb]);
        mma_tf32(d, big, w.small[nt][kb]);
        mma_tf32(d, big, w.big[nt][kb]);
      }
    }
  }
}

// R = this warp's rows f0 - 1 .. f0 + 4 of a (16, 33) plane at the lane's
// four channels of a tile in the order, zero outside the layer: value
// 4 r + 2 kb + e is row f0 - 1 + r, channel 8 kb + chan(q, e).  v(c, f) reads
// a row of the layer.  A 3-tap freq conv's tiles come from these 6 rows.
template <bool PAIR, class V>
__device__ __forceinline__ void load_rows(float (&R)[24], const Lane& L, V v) {
  const int f0 = 4 * L.w, q = L.q;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int fi = f0 - 1 + r, e = k & 1;
      const float x = v(8 * (k >> 1) + (PAIR ? 2 * q + e : q + 4 * e), clamp0(fi, F_DOWN));
      R[4 * r + k] = (fi >= 0 && fi < F_DOWN) ? x : 0.f;
    }
  }
}

// The tile of tap kf of a 3-tap freq conv (rows f + kf - 1) from rows R.
__device__ __forceinline__ void tap_tile(float (&x)[16], const float (&R)[24], int kf) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    x[j] = R[4 * (2 * (j >> 3) + ((j >> 1) & 1) + kf) + 2 * ((j >> 2) & 1) + (j & 1)];
}

// ---------------------------------------------------------------------------
// shared memory, in floats; activations are [c][f][s]
// ---------------------------------------------------------------------------

template <int S>
struct Smem {
  static constexpr int SKIP0 = 0;                        // (16, 65)
  static constexpr int SKIP1 = SKIP0 + C * F_MID * S;    // skips 1..4: (16, 33) each
  static constexpr int TRUNK = SKIP1 + 4 * C * F_DOWN * S;  // (16, 33) TCN0..de3; then the mask (2, 129)
  static constexpr int WORK = TRUNK + C * F_DOWN * S;
  // WORK holds, in turn: the spectrum (2, 257), its magnitude (257) and the
  // ERB features (3, 129); a GTConv's h (16, 33), h3 (8, 33) and its warps'
  // energy sums (9, 8); de3's output (16, 65)
  static constexpr int WORK_N = (2 * F_FULL + F_FULL + 3 * F_ERB) * S;
  static constexpr int E01 = WORK + WORK_N;              // a TRA ring's taps (2, 8)
  static constexpr int WB = (E01 + 2 * H * S + 3) / 4 * 4;  // two weight buffers of WBUF
  static constexpr int TOTAL = WB + 2 * WBUF;
  __host__ __device__ static constexpr int skip(int k) { return k == 0 ? SKIP0 : SKIP1 + (k - 1) * C * F_DOWN * S; }
  static_assert((C + H) * F_DOWN * S + NT / 32 * H * S <= WORK_N && C * F_MID * S <= WORK_N, "WORK");
  static_assert(2 * F_ERB * S <= C * F_DOWN * S, "the mask fits the trunk");
  static_assert(WB % 4 == 0, "weight buffers are 16-byte aligned");
};
constexpr size_t SMEM_BYTES = Smem<TILE>::TOTAL * sizeof(float);
// CTAs that fit an SM's 228 KB of shared memory (1 KB of it reserved per
// CTA): the kernels' __launch_bounds__, so registers do not hold fewer
constexpr int MIN_CTAS = 233472 / (SMEM_BYTES + 1024);

// ---------------------------------------------------------------------------
// B2's staged ring taps (bf16 storage, B % 8 == 0)
// ---------------------------------------------------------------------------
//
// The 14 ring-reading layers in order, l = 0..13: encoder GTConvs 0-2, TCNs
// 0-7, decoder GTConvs 0-2.  Layer l's taps go to stage buffer l % 2, behind
// the shared memory of the other kernels: its dw or TCN ring's two tap
// frames, [c][f][s] each, then a GTConv's two TRA taps, [c][s] each, all
// bf16; the buffers' two mbarriers follow them.
constexpr int N_STAGED = 14;
constexpr int STAGE_FRAME = C * F_DOWN * TILE * 2;            // 8,448 bytes
constexpr int STAGE_TRA = H * TILE * 2;                       // 128 bytes
constexpr int STAGE_BYTES = 2 * STAGE_FRAME + 2 * STAGE_TRA;  // 17,152 bytes
constexpr size_t STAGE_AT = (SMEM_BYTES + 127) / 128 * 128;  // tensor copies land 128-byte aligned
constexpr size_t STAGED_SMEM_BYTES = STAGE_AT + 2 * STAGE_BYTES + 2 * sizeof(unsigned long long);
static_assert(STAGE_BYTES % 128 == 0 && STAGE_FRAME % 128 == 0, "stage buffers stay 128-byte aligned");
static_assert(233472 / (STAGED_SMEM_BYTES + 1024) == MIN_CTAS, "the staged kernel keeps its CTAs an SM");

// layer l's dw or TCN ring, its TRA ring (-1 for a TCN), and the layer that
// reads ring r
__host__ __device__ constexpr int dw_ring_of(int l) {
  return l < 3 ? ENC_DW + l : l < 11 ? TCN + l - 3 : DEC_DW + l - 11;
}
__host__ __device__ constexpr int tra_ring_of(int l) {
  return l < 3 ? ENC_TRA + l : l < 11 ? -1 : DEC_TRA + l - 11;
}
__host__ __device__ constexpr int layer_of(int r) {
  return r < ENC_TRA ? r
         : r < DEC_DW ? r - ENC_TRA
         : r < DEC_TRA ? r - DEC_DW + 11
         : r < TCN ? r - DEC_TRA + 11
                   : r - TCN + 3;
}

// True where B2 takes the staged path: bf16 storage (a float32 stage pair,
// 68,608 bytes, does not fit the 54,592 left) and ring rows of B bf16 values
// that are 16-byte multiples, as tensor copies need.  dtype: 0 = float32,
// 1 = bfloat16.
inline bool staged_path(int dtype, int B) { return dtype == 1 && B % 8 == 0; }

// B2 with staged taps: RingIO's rings and frames, and one tensor map per
// ring (encode_ring_maps).  Thread 0 copies both taps of layer l + 1 (its
// stage) as layer l begins; every thread waits on the buffer's mbarrier
// before layer l + 1's first tap read and its frame writes, which follow
// the copy of tap 0 as the ring contract asks.
template <typename T>
struct StagedRingIO : RingIO<T> {
  static constexpr bool STAGED = true;
  CUtensorMap map[N_RINGS];
  __device__ __forceinline__ static char* buffer(float* sm, int l) {
    return reinterpret_cast<char*>(sm) + STAGE_AT + (l & 1) * STAGE_BYTES;
  }
  __device__ __forceinline__ static unsigned long long* bar(float* sm, int l) {
    char* bars = reinterpret_cast<char*>(sm) + STAGE_AT + 2 * STAGE_BYTES;
    return reinterpret_cast<unsigned long long*>(bars) + (l & 1);
  }
  __device__ __forceinline__ Tap<T> tap_of(int r, int k, int, int, float* sm) const {
    const char* b = buffer(sm, layer_of(r));
    b += ring_frame(r) == H ? 2 * STAGE_FRAME + k * STAGE_TRA : k * STAGE_FRAME;
    return {reinterpret_cast<const T*>(b), (size_t)TILE, TILE - 1};
  }
  // Thread 0: copy layer l's taps into its buffer, which every thread has
  // finished reading (layer l - 2's; the CTA barrier that began layer l - 1
  // comes after the last read); at l = 0, first set up both barriers.
  __device__ __forceinline__ void stage(int l, int b0, float* sm) const {
    if (threadIdx.x != 0 || l >= N_STAGED) return;
    unsigned long long* mb = bar(sm, l);
    if (l == 0) {
      mbar_init(bar(sm, 0), 1);
      mbar_init(bar(sm, 1), 1);
    }
    fence_proxy_async();
    const int rd = dw_ring_of(l), rt = tra_ring_of(l);
    mbar_expect(mb, rt < 0 ? 2 * STAGE_FRAME : STAGE_BYTES);
    char* b = buffer(sm, l);
    for (int k = 0; k < 2; ++k)
      tma_load_4d(b + k * STAGE_FRAME, &map[rd], b0, 0, 0, this->slot(rd, k), mb);
    if (rt >= 0)
      for (int k = 0; k < 2; ++k)
        tma_load_4d(b + 2 * STAGE_FRAME + k * STAGE_TRA, &map[rt], b0, 0, 0, this->slot(rt, k), mb);
  }
  // Layer l's copies have landed (its buffer's phase l / 2).
  __device__ __forceinline__ void wait(int l, float* sm) const {
    mbar_wait(bar(sm, l), (l >> 1) & 1);
  }
};

// cuTensorMapEncodeTiled of the CUDA API, which the caller looks up.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// One map per bf16 ring of B streams (rings[r], (L, *frame, B)), 4-D with
// dims innermost first: (B, 33, 16, L) with a box of (8, 33, 16, 1) for a dw
// or TCN ring, (B, 8, 1, L) with a box of (8, 8, 1, 1) for a TRA ring, so
// that one CTA's tap frame lands as [c][f][s]; zeros outside.  False if
// encode refuses one.
inline bool encode_ring_maps(EncodeTiledFn encode, void* const* rings, int B, CUtensorMap* maps) {
  for (int r = 0; r < N_RINGS; ++r) {
    const bool tra = ring_frame(r) == H;
    const cuuint64_t e = 2, f = tra ? H : F_DOWN, c = tra ? 1 : C;
    const cuuint64_t dims[4] = {(cuuint64_t)B, f, c, (cuuint64_t)ring_len(r)};
    const cuuint64_t strides[3] = {B * e, f * B * e, c * f * B * e};  // bytes, dims 1..3
    const cuuint32_t box[4] = {TILE, (cuuint32_t)f, (cuuint32_t)c, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    if (encode(&maps[r], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, rings[r], dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

// Allow a kernel its dynamic shared memory (`bytes`) on the current device.
// CUDA keeps function attributes per device, so this is done once per kernel
// and device (bit d of `done`: device d; devices from 64 on set it at every
// launch).
template <typename K>
inline int prepare(K kernel, size_t bytes = SMEM_BYTES) {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done.load() & bit) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done.fetch_or(bit);
  return (int)e;
}

// out[4]: registers per thread, local bytes per thread, shared bytes per CTA
// and resident CTAs per SM of a kernel at NT threads and `bytes` of dynamic
// shared memory.
template <typename K>
inline int kernel_attrs(K kernel, int* out, size_t bytes = SMEM_BYTES) {
  int e = prepare(kernel, bytes);
  cudaFuncAttributes a;
  if (!e) e = (int)cudaFuncGetAttributes(&a, kernel);
  int ctas = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, NT, bytes);
  if (e) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + bytes);
  out[3] = ctas;
  return 0;
}

// ---------------------------------------------------------------------------
// weight staging
// ---------------------------------------------------------------------------

// A staged group: entry offset (in the global buffer) -> its shared copy.
struct Wts {
  const float* base;
  int start;
  __device__ __forceinline__ const float* operator()(int off) const { return base + (off - start); }
};

// Start copying group g into buffer g & 1.
template <int S>
__device__ __forceinline__ void stage_group(const float* __restrict__ W, const Plan& p, float* sm,
                                            int g) {
  float* dst = sm + Smem<S>::WB + (g & 1) * WBUF;
  const float* src = W + p.gs[g];
  const int n4 = (p.gs[g + 1] - p.gs[g]) / 4;
  for (int i = threadIdx.x; i < n4; i += NT) cp_async16(dst + 4 * i, src + 4 * i);
  cp_async_commit();
}

// Group g has landed and is visible to the CTA (this is the barrier between
// the layer before and the layer of group g: every thread is past its last
// read of group g - 1), and group g + 1 starts copying into g - 1's buffer.
template <int S>
__device__ __forceinline__ Wts advance(const float* __restrict__ W, const Plan& p, float* sm,
                                       int g) {
  cp_async_wait_all();
  __syncthreads();
  if (g + 1 < N_GROUPS) stage_group<S>(W, p, sm, g + 1);
  return Wts{sm + Smem<S>::WB + (g & 1) * WBUF, p.gs[g]};
}

// ---------------------------------------------------------------------------
// layers
// ---------------------------------------------------------------------------

// ERB band merge of (mag, re, im) over the band table tb; bins 0-64 pass
// through.  x0 is (3, 129).
template <int S>
__device__ void erb_merge(const float* tb, const float* sp, const float* mag, float* x0) {
  for (int it = threadIdx.x; it < F_ERB * S; it += NT) {
    const int f = it / S, s = it % S;
    float v0, v1, v2;
    if (f < N_LO) {
      v0 = mag[f * S + s];
      v1 = sp[f * S + s];
      v2 = sp[(F_FULL + f) * S + s];
    } else {
      const int r = f - N_LO, k0 = N_LO + (int)tb[3 * r], n = (int)tb[3 * r + 1];
      const float* w = tb + (int)tb[3 * r + 2];
      v0 = v1 = v2 = 0.f;
      for (int k = 0; k < n; ++k) {
        const float wk = w[k];
        const int i = (k0 + k) * S + s;
        v0 = fmaf(wk, mag[i], v0);
        v1 = fmaf(wk, sp[i], v1);
        v2 = fmaf(wk, sp[F_FULL * S + i], v2);
      }
    }
    x0[f * S + s] = v0;
    x0[(F_ERB + f) * S + s] = v1;
    x0[(2 * F_ERB + f) * S + s] = v2;
  }
}

// SFE-Lite (depthwise 3-tap freq conv over x0 (3, 129), no bias) folded into
// en0, the (1,5) stride-2 freq conv 3 -> 16 channels, 129 -> 65, with its
// folded bias and PReLU.  sfe is (kf, c); w is (k, co, ci) = (5, 16, 3).
template <int S>
__device__ void en0(const float* sfe, const float* w, const float* bias, float a, const float* x0,
                    float* y) {
  for (int it = threadIdx.x; it < F_MID * S; it += NT) {
    const int fo = it / S, s = it % S;
    float acc[C];
    zero(acc);
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int fi = 2 * fo - 2 + k;
      float x1[3];  // the SFE output at fi (zero outside: en0's padding)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float v[3];
#pragma unroll
        for (int kf = 0; kf < 3; ++kf) {
          const int fj = fi + kf - 1;
          v[kf] = (fj >= 0 && fj < F_ERB) ? x0[(c * F_ERB + fj) * S + s] : 0.f;
        }
        x1[c] = (fi >= 0 && fi < F_ERB) ? fmaf(sfe[6 + c], v[2], fmaf(sfe[3 + c], v[1], sfe[c] * v[0])) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 3 * C / 4; ++j) {  // the rows of tap k, 4 floats at a time
        const float4 q = ld4(w + k * 3 * C + 4 * j);
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = (4 * j + e) / 3, ci = (4 * j + e) % 3;
          acc[co] = fmaf(qv[e], x1[ci], acc[co]);
        }
      }
    }
#pragma unroll
    for (int co = 0; co < C; ++co) y[(co * F_MID + fo) * S + s] = prelu(acc[co] + bias[co], a);
  }
}

// en1: (1,5) freq conv, stride 2, pad 2, 16 -> 16 channels, 65 -> 33, folded
// bias + PReLU, on tensor cores.  w is (5, 16, 16).
template <int S>
__device__ void en1(const float* w, const float* bias, float a, const float* in, float* out) {
  const Lane L;
  const int s = L.g;
  float acc[16];
  zero(acc);
#pragma unroll 1
  for (int k = 0; k < 5; ++k) {
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int fi = 2 * L.f(j) + k - 2;
      const float v = in[(L.c<false>(j) * F_MID + clamp0(fi, F_MID)) * S + s];
      x[j] = (fi >= 0 && fi < F_MID) ? v : 0.f;
    }
    mix_tc(acc, x, MixW<C, false>(w + k * C * C, L));
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int co = L.c<true>(j), fo = L.f(j);
    if (fo < F_DOWN) out[(co * F_DOWN + fo) * S + s] = prelu(acc[j] + bias[co], a);
  }
}

// GTConvBlock on (16, 33): in (+ skip, in the decoder) -> out (in == out
// allowed).  The 3x3 conv over (x_{t-2}, x_{t-1}, h) is depthwise in the
// encoder and a full 16x16 conv on tensor cores in the decoder, over the
// warp's tile; pw2 after it on tensor cores; pw1 and the TRA one thread an
// item.  Reads both taps of rings rdw and rtra before its first barrier;
// writes their new frames (h and the TRA energy e) after it.  Three stages,
// three barriers (the last is the next layer's advance).
template <typename T, int S, bool DECONV, class IO>
__device__ void gtconv(const Wts& w, const GtW& gw, const IO& io, int rdw, int rtra,
                       const float* in, const float* skip, float* out, float* sm, int b0, int B) {
  using M = Smem<S>;
  float* hs = sm + M::WORK;              // h (16, 33)
  float* h3s = hs + C * F_DOWN * S;      // h3 (8, 33)
  float* esum = h3s + H * F_DOWN * S;    // per warp, the sum of h3^2 over its rows (NT / 32, 8)
  float* e01 = sm + M::E01;              // TRA taps (2, 8)
  const Item I = item33();
  const int f = I.it / S, s = I.it % S, b = b0 + s;
  const bool live = I.valid && b < B;
  const float* wdw = w(gw.dw_w);
  // the conv's tile: stream ts, its taps read at the IO's stream for ts (the
  // last real one for a stream past B, whose outputs are never written)
  const Lane L;
  const int ts = L.g;
  float y[16];  // the 3x3 conv (pair-order tile): the time taps here, h's taps in b
  zero(y);
  // tap kk (frame kk / 3, freq kk % 3 - 1) of the conv on tile x
  auto conv_tap = [&](int kk, const float (&x)[16]) {
    if constexpr (DECONV) {
      mix_tc(y, x, MixW<C, true>(wdw + kk * C * C, L));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) y[j] = fmaf(wdw[kk * C + L.c<true>(j)], x[j], y[j]);
    }
  };

  // -- a: the time taps' part of the 3x3 conv; h = PReLU(pw1 @ x[:8] + b)
  if (threadIdx.x < S) {  // one thread per stream fetches its TRA taps
    const int es = threadIdx.x;
    const bool real = b0 + es < B;
    const Tap<T> e0 = io.tap_of(rtra, 0, b0, B, sm), e1 = io.tap_of(rtra, 1, b0, B, sm);
#pragma unroll
    for (int c = 0; c < H; ++c) {
      e01[c * S + es] = real ? to_f(e0.p[c * e0.stride + es]) : 0.f;
      e01[(H + c) * S + es] = real ? to_f(e1.p[c * e1.stride + es]) : 0.f;
    }
  }
  {
#pragma unroll 1
    for (int fr = 0; fr < 2; ++fr) {  // a frame's rows, one round of loads
      const Tap<T> tp = io.tap_of(rdw, fr, b0, B, sm);
      const Lane Lf;  // its addresses made in the loop, not held through it
      const int sf = tp.stream(Lf.g);
      float R[24];
      load_rows<true>(R, Lf, [&](int c, int fi) {
        return to_f(tp.p[(size_t)(c * F_DOWN + fi) * tp.stride + sf]);
      });
#pragma unroll
      for (int kf = 0; kf < 3; ++kf) {
        float x[16];
        tap_tile(x, R, kf);
        conv_tap(3 * fr + kf, x);
      }
    }
  }
  {
    float x[H];
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const int i = (c * F_DOWN + f) * S + s;
      x[c] = DECONV ? in[i] + skip[i] : in[i];
    }
    float h[C];
    zero(h);
    mix<H, C>(h, w(gw.pw1_w), x);
    const float* b1 = w(gw.pw1_b);
    const float a1 = *w(gw.a1);
    if (I.valid) {
#pragma unroll
      for (int c = 0; c < C; ++c) hs[(c * F_DOWN + f) * S + s] = prelu(h[c] + b1[c], a1);
    }
  }
  __syncthreads();

  // -- b: h2 = PReLU(conv + b) with h's part of the conv, h3 = pw2 @ h2 + b;
  // the dw ring's new frame is h, now that every read of its tap 0 is done
  {
    // h's rows in split order for the full conv's products (free of bank
    // conflicts), in pair order for the depthwise conv (y's channels)
    float R[24];
    load_rows<!DECONV>(R, L, [&](int c, int fi) { return hs[(c * F_DOWN + fi) * S + ts]; });
#pragma unroll
    for (int kf = 0; kf < 3; ++kf) {
      float x[16];
      tap_tile(x, R, kf);
      if constexpr (DECONV) {
        mix_tc(y, x, MixW<C, false>(wdw + (6 + kf) * C * C, L));
      } else {
        conv_tap(6 + kf, x);
      }
    }
  }
  {
    const float* bdw = w(gw.dw_b);
    const float a2 = *w(gw.a2);
    const float* b2 = w(gw.pw2_b);
#pragma unroll
    for (int j = 0; j < 16; ++j) y[j] = prelu(y[j] + bdw[L.c<true>(j)], a2);
    float h3[H];  // pair order, 8 channels: value 4 mt + i is channel 2 q + i % 2
    zero(h3);
    mix_tc(h3, y, MixW<H, true>(w(gw.pw2_w), L));
    float e2[2] = {0.f, 0.f};  // the TRA energy's share of this warp's rows
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const int c = 2 * L.q + (j & 1), fo = L.f(2 * (j & ~3) + (j & 3));
      const float v = h3[j] + b2[c];
      if (fo < F_DOWN) {
        h3s[(c * F_DOWN + fo) * S + ts] = v;
        e2[j & 1] = fmaf(v, v, e2[j & 1]);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) esum[(L.w * H + 2 * L.q + e) * S + ts] = e2[e];
    if (live) {
      T* fr = io.out(rdw);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = c * F_DOWN + f;
        fr[(size_t)i * B + b] = from_f<T>(hs[i * S + s]);
      }
    }
  }
  __syncthreads();

  // -- c: TRA energy e = mean_f h3^2 of this stream (every item of the
  // stream adds the warps' sums), yg = 3-tap time conv over (e_{t-2}, e_{t-1}, e),
  // gate = sigmoid(tra_pw @ yg + b); out[2i] = h3[i] * gate[i] (gated half),
  // out[2i+1] = x[8+i] (passive half); the TRA ring's new frame is e
  float x2[H];
#pragma unroll
  for (int c = 0; c < H; ++c) {
    const int i = ((H + c) * F_DOWN + f) * S + s;
    x2[c] = DECONV ? in[i] + skip[i] : in[i];
  }
  float e[H], yg[H];
  {
    const float* tdw = w(gw.tra_dw);
    const float* tdb = w(gw.tra_db);
#pragma unroll
    for (int c = 0; c < H; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < NT / 32; ++wp) acc += esum[(wp * H + c) * S + s];
      e[c] = acc / float(F_DOWN);
      yg[c] = tdb[c] + tdw[c] * e01[c * S + s] + tdw[H + c] * e01[(H + c) * S + s] + tdw[2 * H + c] * e[c];
    }
  }
  float gate[H];
  zero(gate);
  mix<H, H>(gate, w(gw.tra_pw), yg);
  const float* tpb = w(gw.tra_pb);
  if (I.valid) {
#pragma unroll
    for (int c = 0; c < H; ++c) {
      const float gc = sigmoidf(gate[c] + tpb[c]);
      out[(2 * c * F_DOWN + f) * S + s] = h3s[(c * F_DOWN + f) * S + s] * gc;
      out[((2 * c + 1) * F_DOWN + f) * S + s] = x2[c];
    }
  }
  if (I.it < S && live) {
    T* fr = io.out(rtra);
#pragma unroll
    for (int c = 0; c < H; ++c) fr[(size_t)c * B + b] = from_f<T>(e[c]);
  }
}

// A TCN's two ring taps x_{t-2d}, x_{t-d} at the lane's tile values, as
// stored; a row or stream past the layer reads a real one, unused.  Read
// from device memory (B1, and B2 unstaged), the forward loads a block's taps
// while the block before runs, so that their latency, the largest cost of a
// block, overlaps it; staged, the block reads them from its stage buffer.
template <typename T>
struct TcnTaps {
  T v0[16], v1[16];
};
template <typename T, class IO>
__device__ __forceinline__ void load_taps(TcnTaps<T>& tp, const IO& io, int r, int b0, int B,
                                          float* sm) {
  const Lane L;
  const Tap<T> t0 = io.tap_of(r, 0, b0, B, sm), t1 = io.tap_of(r, 1, b0, B, sm);
  const int s = t0.stream(L.g);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const size_t i = (size_t)(L.c<true>(j) * F_DOWN + clamp0(L.f(j), F_DOWN)) * t0.stride + s;
    tp.v0[j] = t0.p[i];
    tp.v1[j] = t1.p[i];
  }
}

// Residual TCN block on (16, 33), one stage in registers on tensor cores:
// x = PReLU(pw3 @ PReLU(dw(x_{t-2d}, x_{t-d}, h)) + b + x) with
// h = PReLU(pw1 @ x + b), x the warp's pair-order tile of the trunk (its
// rows past the layer unused), the taps loaded a block ahead (or, staged,
// from the stage buffer here).  It writes the ring's new frame h where it
// read tap 0, each value by the thread that read it (staged: after the
// layer's copies have landed).
template <typename T, class IO>
__device__ void tcn(const Wts& w, const TcnW& o, const IO& io, int r, float (&x)[16],
                    TcnTaps<T>& tp, int b0, int B, float* sm) {
  const Lane L;
  const int b = b0 + L.g;
  float h[16];
  zero(h);
  mix_tc(h, x, MixW<C, true>(w(o.pw1_w), L));
  {
    const float* b1 = w(o.pw1_b);
    const float a1 = *w(o.a1);
    T* fr = io.out(r);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      h[j] = prelu(h[j] + b1[L.c<true>(j)], a1);
      if (b < B && L.f(j) < F_DOWN)
        fr[(size_t)(L.c<true>(j) * F_DOWN + L.f(j)) * B + b] = from_f<T>(h[j]);
    }
  }
  if constexpr (IO::STAGED) load_taps(tp, io, r, b0, B, sm);
  {
    const float* dww = w(o.dw_w);
    const float* bdw = w(o.dw_b);
    const float a2 = *w(o.a2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = L.c<true>(j);
      h[j] = prelu(dww[c] * to_f(tp.v0[j]) + dww[C + c] * to_f(tp.v1[j]) + dww[2 * C + c] * h[j]
                   + bdw[c], a2);
    }
  }
  float acc[16];
  zero(acc);
  mix_tc(acc, h, MixW<C, true>(w(o.pw3_w), L));
  const float* b3 = w(o.pw3_b);
  const float a3 = *w(o.a3);
#pragma unroll
  for (int j = 0; j < 16; ++j) x[j] = prelu(acc[j] + b3[L.c<true>(j)] + x[j], a3);
}

// de3: (1,5) transposed freq conv, stride 2, pad 2 (zero-stuffed input), over
// x = in + skip (16, 33) -> (16, 65), bias + PReLU, on tensor cores:
// out[2p] = W0 x[p-1] + W2 x[p] + W4 x[p+1] and out[2p+1] = W1 x[p] +
// W3 x[p+1], x zero outside 0..32, over the warp's rows p.  w is (5, 16, 16).
template <int S>
__device__ void de3(const float* w, const float* bias, float a, const float* in,
                    const float* skip, float* out) {
  const Lane L;
  const int s = L.g;
  float even[16], odd[16];
  zero(even);
  zero(odd);
#pragma unroll
  for (int d = -1; d <= 1; ++d) {
    float x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int p = L.f(j) + d, i = (L.c<false>(j) * F_DOWN + clamp0(p, F_DOWN)) * S + s;
      const float v = in[i] + skip[i];
      x[j] = (p >= 0 && p < F_DOWN) ? v : 0.f;
    }
    mix_tc(even, x, MixW<C, false>(w + (2 + 2 * d) * C * C, L));
    if (d >= 0) mix_tc(odd, x, MixW<C, false>(w + (1 + 2 * d) * C * C, L));
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int co = L.c<true>(j), p = L.f(j);
    if (p < F_DOWN) out[(co * F_MID + 2 * p) * S + s] = prelu(even[j] + bias[co], a);
    if (p < F_DOWN - 1) out[(co * F_MID + 2 * p + 1) * S + s] = prelu(odd[j] + bias[co], a);
  }
}

// de4: (1,5) transposed freq conv, stride 2, pad 2 (zero-stuffed input) over
// in + skip (16, 65) -> the mask (2, 129), bias + tanh.  w is (5, 2, 16).
template <int S>
__device__ void de4(const float* w, const float* bias, const float* in, const float* skip,
                    float* out) {
  for (int it = threadIdx.x; it < F_ERB * S; it += NT) {
    const int fo = it / S, s = it % S;
    float acc[2];
    zero(acc);
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
      const int m = fo + k - 2;  // index into the zero-stuffed input
      if (m < 0 || (m & 1) || (m >> 1) >= F_MID) continue;
      const int j = m >> 1;
      float x[C];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const int i = (ci * F_MID + j) * S + s;
        x[ci] = in[i] + skip[i];
      }
      mix<C, 2>(acc, w + k * 2 * C, x);
    }
#pragma unroll
    for (int co = 0; co < 2; ++co) out[(co * F_ERB + fo) * S + s] = tanhf(acc[co] + bias[co]);
  }
}

// ERB band split of the mask m (2, 129) over the band table tb, then the
// complex ratio mask on the input spectrum; writes out (B, 257, 2).
template <typename T, int S>
__device__ void apply_mask(const float* tb, const float* m, const T* __restrict__ spec,
                           T* __restrict__ out, int b0, int B) {
  for (int it = threadIdx.x; it < S * F_FULL; it += NT) {
    const int s = it / F_FULL, f = it % F_FULL, b = b0 + s;
    if (b >= B) continue;
    float mr, mi;
    if (f < N_LO) {
      mr = m[f * S + s];
      mi = m[(F_ERB + f) * S + s];
    } else {
      const int r = f - N_LO, k0 = N_LO + (int)tb[3 * r], n = (int)tb[3 * r + 1];
      const float* w = tb + (int)tb[3 * r + 2];
      mr = mi = 0.f;
      for (int k = 0; k < n; ++k) {
        mr = fmaf(w[k], m[(k0 + k) * S + s], mr);
        mi = fmaf(w[k], m[(F_ERB + k0 + k) * S + s], mi);
      }
    }
    const size_t gi = ((size_t)b * F_FULL + f) * 2;
    const float re = to_f(spec[gi]), im = to_f(spec[gi + 1]);
    out[gi] = from_f<T>(re * mr - im * mi);
    out[gi + 1] = from_f<T>(im * mr + re * mi);
  }
}

// The whole forward for streams [b0, b0 + TILE) of B.  spec/out are
// (B, 257, 2); W is the kernel weight buffer, p its offsets and groups.
template <typename T, class IO>
__device__ void forward(const float* __restrict__ W, const Plan& p, const T* __restrict__ spec,
                        T* __restrict__ out, const IO& io, int b0, int B, float* sm) {
  constexpr int S = TILE;
  using M = Smem<S>;
  const WOffs& o = p.o;
  float* sp = sm + M::WORK;          // spectrum (2, 257)
  float* mag = sp + 2 * F_FULL * S;  // (257)
  float* x0 = mag + F_FULL * S;      // ERB features (3, 129)
  float* x = sm + M::TRUNK;

  io.stage(0, b0, sm);  // the first GTConv's taps, a frame's spectrum ahead
  stage_group<S>(W, p, sm, 0);
  for (int it = threadIdx.x; it < S * F_FULL; it += NT) {
    const int s = it / F_FULL, f = it % F_FULL, b = b0 + s;
    float re = 0.f, im = 0.f;
    if (b < B) {
      const size_t gi = ((size_t)b * F_FULL + f) * 2;
      re = to_f(spec[gi]);
      im = to_f(spec[gi + 1]);
    }
    sp[f * S + s] = re;
    sp[(F_FULL + f) * S + s] = im;
    mag[f * S + s] = sqrtf(re * re + im * im + 1e-12f);
  }

  // encoder: ERB merge, SFE + en0 (129 -> 65), en1 (65 -> 33), three GTConvs
  Wts w = advance<S>(W, p, sm, 0);
  erb_merge<S>(w(o.bm_w), sp, mag, x0);
  __syncthreads();
  en0<S>(w(o.sfe_w), w(o.en[0].w), w(o.en[0].b), *w(o.en[0].a), x0, sm + M::skip(0));
  w = advance<S>(W, p, sm, 1);
  en1<S>(w(o.en[1].w), w(o.en[1].b), *w(o.en[1].a), sm + M::skip(0), sm + M::skip(1));
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    w = advance<S>(W, p, sm, 2 + i);
    io.stage(i + 1, b0, sm);
    io.wait(i, sm);
    gtconv<T, S, false>(w, o.enc[i], io, ENC_DW + i, ENC_TRA + i, sm + M::skip(1 + i), nullptr,
                        sm + M::skip(2 + i), sm, b0, B);
  }

  // two stacks of four dilated TCNs (d = 1, 2, 4, 8); each warp keeps its
  // items of the trunk in registers from skip 4 to TRUNK
  float xt[16];
  TcnTaps<T> cur, nxt;
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    w = advance<S>(W, p, sm, 5 + i);
    io.stage(4 + i, b0, sm);
    io.wait(3 + i, sm);
    if (i == 0) {
      if constexpr (!IO::STAGED) load_taps(cur, io, TCN, b0, B, sm);
      const Lane L;
      const float* x4 = sm + M::skip(4);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        xt[j] = x4[(L.c<true>(j) * F_DOWN + clamp0(L.f(j), F_DOWN)) * S + L.g];
    }
    if constexpr (!IO::STAGED) {
      if (i < 7) load_taps(nxt, io, TCN + i + 1, b0, B, sm);
    }
    tcn<T>(w, o.tcn[i], io, TCN + i, xt, cur, b0, B, sm);
    if constexpr (!IO::STAGED) cur = nxt;
  }
  {
    const Lane L;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (L.f(j) < F_DOWN) x[(L.c<true>(j) * F_DOWN + L.f(j)) * S + L.g] = xt[j];
  }

  // decoder: three GTConvs over trunk + skips 4, 3, 2, then the transposed
  // convs over trunk + skip 1 (33 -> 65) and + skip 0 (65 -> 129)
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    w = advance<S>(W, p, sm, 13 + i);
    io.stage(12 + i, b0, sm);
    io.wait(11 + i, sm);
    gtconv<T, S, true>(w, o.dec[i], io, DEC_DW + i, DEC_TRA + i, x, sm + M::skip(4 - i), x, sm,
                       b0, B);
  }
  float* d3 = sm + M::WORK;  // (16, 65)
  w = advance<S>(W, p, sm, 16);
  de3<S>(w(o.de3.w), w(o.de3.b), *w(o.de3.a), x, sm + M::skip(1), d3);
  float* m = x;  // mask (2, 129)
  w = advance<S>(W, p, sm, 17);
  de4<S>(w(o.de4_w), w(o.de4_b), d3, sm + M::skip(0), m);
  __syncthreads();
  apply_mask<T, S>(w(o.bs_w), m, spec, out, b0, B);
}

}  // namespace gtcrn
