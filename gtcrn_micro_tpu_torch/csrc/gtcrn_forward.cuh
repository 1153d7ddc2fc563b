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
// matrices count by their 382 nonzeros each); see PERF.md.  At the served
// batch the f32 operations bound it.  The kernel reaches about a tenth of
// that bound: each CTA's chain of stages, not the card's throughput, sets its
// time (PERF.md has the measurements and what is left).  The design:
//
// - One CTA owns TILE streams and runs the network layer by layer with every
//   activation in shared memory, laid out [channel][freq][stream] (stream
//   innermost), so an item (f, s) of a layer is one offset in each channel
//   plane.  In every F = 33 layer one thread owns an item and keeps all its
//   output channels in registers.
// - Weights: each layer's entries (one span of the float32 kernel weight
//   buffer, ops/fused_step.py kernel_weights) are copied into one of two
//   shared buffers with cp.async while the layer before runs.  A channel mix
//   reads its weights as float4 broadcasts, 4 input channels of one output
//   row per load, so each shared weight load feeds 4 FFMA and each
//   activation is loaded once per layer.
// - The ERB merge and split loop over band tables (first bin, length,
//   weights of each row's nonzero span), 382 multiply-adds each, not the
//   12,288 of the dense matrices.
// - Stages in which a thread owns its whole (f, s) column are fused: a TCN
//   block (pw1 -> depthwise time conv -> pw3 + residual + PReLU) is one
//   stage in registers; in a GTConv the depthwise/full 3x3 conv feeds pw2
//   directly and the time taps' share of that conv is summed before its
//   first barrier; the TRA gate and the channel interleave are one stage;
//   SFE is computed as en0 loads its input; the decoder's skip adds happen
//   as the next layer loads its input.  32 barriers per frame (the first
//   version had ~75).
// - A TCN loads its 32 ring-tap values before pw1, so their latency
//   overlaps that mix.
//
// Computation is float32 whatever the storage type T (float or bf16), with
// IEEE expf/tanhf/sqrtf and divisions (no fast-math).
//
// Ring contract: a ring's taps are x_{t-2d} (tap 0) and x_{t-d} (tap 1); the
// new frame is written where tap 0 was read (B2, and B1 as its wrapper calls
// it, update in place), so every frame write comes after the CTA's last read
// of that ring's tap 0: a TCN item reads then writes its own addresses; a
// GTConv reads both taps of both its rings before its first barrier and
// writes their frames after it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <string.h>

#include "gtcrn_async.cuh"

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

// B1: taps gathered by the caller, new frames where the caller says.
template <typename T>
struct TapIO {
  const T* tap[2 * N_RINGS];  // per ring: x_{t-2d}, x_{t-d}; each (*frame, B)
  T* frame[N_RINGS];          // per ring: the new frame, (*frame, B)
  __device__ __forceinline__ const T* t0(int r) const { return tap[2 * r]; }
  __device__ __forceinline__ const T* t1(int r) const { return tap[2 * r + 1]; }
  __device__ __forceinline__ T* out(int r) const { return frame[r]; }
};

// B2: the ring state itself, (L, *frame, B) per ring, and the step counter.
template <typename T>
struct RingIO {
  T* ring[N_RINGS];
  int t;
  int B;
  __device__ __forceinline__ T* at(int r, int slot) const {
    return ring[r] + (size_t)slot * ring_frame(r) * B;
  }
  __device__ __forceinline__ const T* t0(int r) const { return at(r, t % ring_len(r)); }
  __device__ __forceinline__ const T* t1(int r) const {
    return at(r, (t + ring_stride(r)) % ring_len(r));
  }
  __device__ __forceinline__ T* out(int r) const { return at(r, t % ring_len(r)); }
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

// acc[c] += w[c] * x[c] over N channels (a depthwise tap), w read as float4.
template <int N>
__device__ __forceinline__ void dw(float (&acc)[N], const float* w, const float (&x)[N]) {
#pragma unroll
  for (int c4 = 0; c4 < N; c4 += 4) {
    const float4 q = ld4(w + c4);
    acc[c4] = fmaf(q.x, x[c4], acc[c4]);
    acc[c4 + 1] = fmaf(q.y, x[c4 + 1], acc[c4 + 1]);
    acc[c4 + 2] = fmaf(q.z, x[c4 + 2], acc[c4 + 2]);
    acc[c4 + 3] = fmaf(q.w, x[c4 + 3], acc[c4 + 3]);
  }
}

// The item of an F = 33 layer this thread works on and whether it is real
// (the last warp holds fewer items; a thread past them computes on the last
// item and writes nothing).
struct Item {
  int it;
  bool valid;
};
__device__ __forceinline__ Item item33() {
  const int raw = threadIdx.x;
  return {raw < ITEMS ? raw : ITEMS - 1, raw < ITEMS};
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
  // ERB features (3, 129); a GTConv's h (16, 33) and h3 (8, 33); de3's
  // output (16, 65)
  static constexpr int WORK_N = (2 * F_FULL + F_FULL + 3 * F_ERB) * S;
  static constexpr int E01 = WORK + WORK_N;              // a TRA ring's taps (2, 8)
  static constexpr int WB = (E01 + 2 * H * S + 3) / 4 * 4;  // two weight buffers of WBUF
  static constexpr int TOTAL = WB + 2 * WBUF;
  __host__ __device__ static constexpr int skip(int k) { return k == 0 ? SKIP0 : SKIP1 + (k - 1) * C * F_DOWN * S; }
  static_assert(C * F_DOWN * S + H * F_DOWN * S <= WORK_N && C * F_MID * S <= WORK_N, "WORK");
  static_assert(2 * F_ERB * S <= C * F_DOWN * S, "the mask fits the trunk");
  static_assert(WB % 4 == 0, "weight buffers are 16-byte aligned");
};
constexpr size_t SMEM_BYTES = Smem<TILE>::TOTAL * sizeof(float);
// CTAs that fit an SM's 228 KB of shared memory (1 KB of it reserved per
// CTA): the kernels' __launch_bounds__, so registers do not hold fewer
constexpr int MIN_CTAS = 233472 / (SMEM_BYTES + 1024);

// Allow a kernel its dynamic shared memory (once per kernel).
template <typename K>
inline int prepare(K kernel) {
  static K done = nullptr;
  if (done == kernel) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e == cudaSuccess) done = kernel;
  return (int)e;
}

// out[4]: registers per thread, local bytes per thread, shared bytes per CTA
// and resident CTAs per SM of a kernel at NT threads and SMEM_BYTES.
template <typename K>
inline int kernel_attrs(K kernel, int* out) {
  int e = prepare(kernel);
  cudaFuncAttributes a;
  if (!e) e = (int)cudaFuncGetAttributes(&a, kernel);
  int ctas = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, NT, SMEM_BYTES);
  if (e) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)(a.sharedSizeBytes + SMEM_BYTES);
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
// bias + PReLU.  w is (5, 16, 16).
template <int S>
__device__ void en1(const float* w, const float* bias, float a, const float* in, float* out) {
  for (int it = threadIdx.x; it < ITEMS; it += NT) {
    const int fo = it / S, s = it % S;
    float acc[C];
    zero(acc);
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
      const int fi = 2 * fo + k - 2;
      if (fi < 0 || fi >= F_MID) continue;
      float x[C];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) x[ci] = in[(ci * F_MID + fi) * S + s];
      mix<C, C>(acc, w + k * C * C, x);
    }
#pragma unroll
    for (int co = 0; co < C; ++co) out[(co * F_DOWN + fo) * S + s] = prelu(acc[co] + bias[co], a);
  }
}

// GTConvBlock on (16, 33): in (+ skip, in the decoder) -> out (in == out
// allowed).  The 3x3 conv over (x_{t-2}, x_{t-1}, h) is depthwise in the
// encoder and a full 16x16 conv in the decoder.  Reads both taps of rings
// rdw and rtra before its first barrier; writes their new frames (h and the
// TRA energy e) after it.  Three stages, three barriers (the last is the
// next layer's advance).
template <typename T, int S, bool DECONV, class IO>
__device__ void gtconv(const Wts& w, const GtW& gw, const IO& io, int rdw, int rtra,
                       const float* in, const float* skip, float* out, float* sm, int b0, int B) {
  using M = Smem<S>;
  float* hs = sm + M::WORK;              // h (16, 33)
  float* h3s = hs + C * F_DOWN * S;      // h3 (8, 33)
  float* e01 = sm + M::E01;              // TRA taps (2, 8)
  const Item I = item33();
  const int f = I.it / S, s = I.it % S, b = b0 + s;
  const bool live = I.valid && b < B;
  const float* wdw = w(gw.dw_w);

  // -- a: the time taps' part of the 3x3 conv; h = PReLU(pw1 @ x[:8] + b)
  if (threadIdx.x < S) {  // one thread per stream fetches its TRA taps
    const int ts = threadIdx.x, tb = b0 + ts;
    const T* e0 = io.t0(rtra);
    const T* e1 = io.t1(rtra);
#pragma unroll
    for (int c = 0; c < H; ++c) {
      e01[c * S + ts] = tb < B ? to_f(e0[(size_t)c * B + tb]) : 0.f;
      e01[(H + c) * S + ts] = tb < B ? to_f(e1[(size_t)c * B + tb]) : 0.f;
    }
  }
  float y[C];  // the 3x3 conv, from the time taps here and from h in b
  zero(y);
  {
    const T* t0 = io.t0(rdw);
    const T* t1 = io.t1(rdw);
#pragma unroll 1
    for (int kk = 0; kk < 6; ++kk) {
      const int kf = kk % 3, fi = f + kf - 1;
      if (fi < 0 || fi >= F_DOWN) continue;
      const T* tp = kk < 3 ? t0 : t1;
      float x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = live ? to_f(tp[(size_t)(c * F_DOWN + fi) * B + b]) : 0.f;
      if (DECONV)
        mix<C, C>(y, wdw + kk * C * C, x);
      else
        dw<C>(y, wdw + kk * C, x);
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
#pragma unroll 1
  for (int kf = 0; kf < 3; ++kf) {
    const int fi = f + kf - 1;
    if (fi < 0 || fi >= F_DOWN) continue;
    float x[C];
#pragma unroll
    for (int c = 0; c < C; ++c) x[c] = hs[(c * F_DOWN + fi) * S + s];
    if (DECONV)
      mix<C, C>(y, wdw + (6 + kf) * C * C, x);
    else
      dw<C>(y, wdw + (6 + kf) * C, x);
  }
  {
    const float* bdw = w(gw.dw_b);
    const float a2 = *w(gw.a2);
#pragma unroll
    for (int c = 0; c < C; ++c) y[c] = prelu(y[c] + bdw[c], a2);
    float h3[H];
    zero(h3);
    mix<C, H>(h3, w(gw.pw2_w), y);
    const float* b2 = w(gw.pw2_b);
    if (I.valid) {
#pragma unroll
      for (int c = 0; c < H; ++c) h3s[(c * F_DOWN + f) * S + s] = h3[c] + b2[c];
    }
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
  // stream computes it), yg = 3-tap time conv over (e_{t-2}, e_{t-1}, e),
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
#pragma unroll 11
      for (int ff = 0; ff < F_DOWN; ++ff) {
        const float v = h3s[(c * F_DOWN + ff) * S + s];
        acc = fmaf(v, v, acc);
      }
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

// Residual TCN block on (16, 33), one stage: out = PReLU(pw3 @ PReLU(dw(
// x_{t-2d}, x_{t-d}, h)) + b + x) with h = PReLU(pw1 @ x + b), all in the
// item's registers (in == out allowed).  It writes the ring's new frame h
// where it read tap 0.
template <typename T, int S, class IO>
__device__ void tcn(const Wts& w, const TcnW& o, const IO& io, int r, const float* in, float* out,
                    int b0, int B) {
  const Item I = item33();
  const int f = I.it / S, s = I.it % S, b = b0 + s;
  const bool live = I.valid && b < B;
  const T* t0 = io.t0(r);
  const T* t1 = io.t1(r);
  float x0[C], x1[C], x[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const size_t gi = (size_t)(c * F_DOWN + f) * B + b;
    x0[c] = live ? to_f(t0[gi]) : 0.f;
    x1[c] = live ? to_f(t1[gi]) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) x[c] = in[(c * F_DOWN + f) * S + s];
  float h[C];
  zero(h);
  mix<C, C>(h, w(o.pw1_w), x);
  {
    const float* b1 = w(o.pw1_b);
    const float a1 = *w(o.a1);
#pragma unroll
    for (int c = 0; c < C; ++c) h[c] = prelu(h[c] + b1[c], a1);
  }
  if (live) {
    T* fr = io.out(r);
#pragma unroll
    for (int c = 0; c < C; ++c) fr[(size_t)(c * F_DOWN + f) * B + b] = from_f<T>(h[c]);
  }
  {
    const float* dww = w(o.dw_w);
    const float* bdw = w(o.dw_b);
    const float a2 = *w(o.a2);
#pragma unroll
    for (int c = 0; c < C; ++c)
      h[c] = prelu(dww[c] * x0[c] + dww[C + c] * x1[c] + dww[2 * C + c] * h[c] + bdw[c], a2);
  }
  float acc[C];
  zero(acc);
  mix<C, C>(acc, w(o.pw3_w), h);
  const float* b3 = w(o.pw3_b);
  const float a3 = *w(o.a3);
  if (I.valid) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      out[(c * F_DOWN + f) * S + s] = prelu(acc[c] + b3[c] + x[c], a3);
  }
}

// (1,5) transposed freq conv, stride 2, pad 2 (zero-stuffed input) over
// in + skip (16, Fin) -> (CO, 2 Fin - 1) with bias; PReLU (de3) or tanh
// (de4, LAST) after.  w is (5, CO, 16).
template <int S, int CO, bool LAST>
__device__ void deconv5_up2(const float* w, const float* bias, float a, const float* in,
                            const float* skip, int Fin, float* out) {
  const int Fout = 2 * Fin - 1;
  for (int it = threadIdx.x; it < Fout * S; it += NT) {
    const int fo = it / S, s = it % S;
    float acc[CO];
    zero(acc);
#pragma unroll 1
    for (int k = 0; k < 5; ++k) {
      const int m = fo + k - 2;  // index into the zero-stuffed input
      if (m < 0 || (m & 1) || (m >> 1) >= Fin) continue;
      const int j = m >> 1;
      float x[C];
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const int i = (ci * Fin + j) * S + s;
        x[ci] = in[i] + skip[i];
      }
      mix<C, CO>(acc, w + k * CO * C, x);
    }
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      const float v = acc[co] + bias[co];
      out[(co * Fout + fo) * S + s] = LAST ? tanhf(v) : prelu(v, a);
    }
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
    gtconv<T, S, false>(w, o.enc[i], io, ENC_DW + i, ENC_TRA + i, sm + M::skip(1 + i), nullptr,
                        sm + M::skip(2 + i), sm, b0, B);
  }

  // two stacks of four dilated TCNs (d = 1, 2, 4, 8); the trunk lives in TRUNK
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    w = advance<S>(W, p, sm, 5 + i);
    tcn<T, S>(w, o.tcn[i], io, TCN + i, i == 0 ? sm + M::skip(4) : x, x, b0, B);
  }

  // decoder: three GTConvs over trunk + skips 4, 3, 2, then the transposed
  // convs over trunk + skip 1 (33 -> 65) and + skip 0 (65 -> 129)
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    w = advance<S>(W, p, sm, 13 + i);
    gtconv<T, S, true>(w, o.dec[i], io, DEC_DW + i, DEC_TRA + i, x, sm + M::skip(4 - i), x, sm,
                       b0, B);
  }
  float* d3 = sm + M::WORK;  // (16, 65)
  w = advance<S>(W, p, sm, 16);
  deconv5_up2<S, C, false>(w(o.de3.w), w(o.de3.b), *w(o.de3.a), x, sm + M::skip(1), F_DOWN, d3);
  float* m = x;  // mask (2, 129)
  w = advance<S>(W, p, sm, 17);
  deconv5_up2<S, 2, true>(w(o.de4_w), w(o.de4_b), 0.f, d3, sm + M::skip(0), F_MID, m);
  __syncthreads();
  apply_mask<T, S>(w(o.bs_w), m, spec, out, b0, B);
}

}  // namespace gtcrn
