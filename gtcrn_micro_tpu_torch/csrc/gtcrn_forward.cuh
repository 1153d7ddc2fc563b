// The whole per-frame GTCRN-Micro forward for one tile of S streams, shared by
// kernel B1 (fused_step.cu) and kernel B2 (fused_grid.cu).
//
// Replaces the forward of the JAX package's Pallas kernels
// (gtcrn_micro_tpu/ops/fused_step.py `_forward_values`, run by `_kernel` and
// by fused_grid.py `_make_kernel`).  Same math as the plain PyTorch version
// `forward_plain` in ops/fused_step.py: ERB merge -> SFE -> en0/en1 ->
// 3 GTConv -> 2x4 TCN -> 3 GTConv (+skips) -> de3/de4 -> ERB split -> mask.
//
// Design.  One CTA owns S streams (S = 8: one 32-byte sector of an f32 ring
// row) and runs the network layer by layer with every activation in shared
// memory, laid out [channel][freq][stream] (stream innermost).  A thread owns
// one (freq, stream) item of a layer and keeps all output channels of it in
// registers, so each input value is read from shared memory once per layer.
// NT = 33 * S threads, so every F=33 layer is exactly one item per thread.
// The five encoder skips stay resident (3,152 floats per stream); the whole
// working set is 5,800 floats per stream (185.6 KB per CTA for S = 8).
// Weights (one packed buffer, offsets in WOffs) are read through the
// read-only cache; every warp reads one weight address at a time.
// Computation is float32 whatever the storage type T (float or bf16).
//
// What bounds it on an H100: per stream and frame it reads 14,880 ring
// values, writes 7,440 and reads/writes 514 spec values each (bytes), and
// needs 550,815 multiply-adds, 1.10 MFLOP in f32 (operations; the ERB
// matrices count by their 382 nonzeros each); see PERF.md.  At the served
// batch the f32 operations bound it.  This first version is bound by
// neither: it runs the ERB merge and split as dense products, issues one
// weight load per FMA and runs one CTA per SM, so each CTA's chain of ~75
// barrier-separated stages sets its time.
//
// Ring contract: a ring's taps are x_{t-2d} (tap 0) and x_{t-d} (tap 1); the
// new frame is written where tap 0 was read (B2 writes in place), so every
// frame write comes after the CTA's last read of that ring's tap 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace gtcrn {

constexpr int C = 16;       // channels
constexpr int H = 8;        // channel-split half
constexpr int F_FULL = 257; // STFT bins
constexpr int F_ERB = 129;  // 65 low bins + 64 ERB bands
constexpr int F_MID = 65;
constexpr int F_DOWN = 33;
constexpr int N_LO = 65;    // bins passed through the ERB unchanged
constexpr int N_BANDS = 64;
constexpr int N_HI = 192;
constexpr int N_RINGS = 20;
constexpr int N_WEIGHTS = 158;
constexpr int TILE = 8;     // streams per CTA
constexpr int NT = F_DOWN * TILE;

// ---------------------------------------------------------------------------
// packed-weight offsets, in the order of ops/fused_step.py pack_weights
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

// B1: taps gathered by the caller, new frames to separate buffers.
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
// storage <-> f32
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

__device__ __forceinline__ float prelu(float x, float a) { return fmaxf(x, 0.f) + a * fminf(x, 0.f); }
__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// shared-memory regions, in floats; activations are [c][f][s]
template <int S>
struct Smem {
  static constexpr int R0 = 0;                       // skip 0: (16, 65)
  static constexpr int R1 = R0 + C * F_MID * S;      // skips 1..4: (16, 33) each
  static constexpr int WA = R1 + 4 * C * F_DOWN * S; // (16, 65): spec stage, trunk, mask
  static constexpr int WB = WA + C * F_MID * S;      // (16, 33); (16, 65) spanning WC for de3
  static constexpr int WC = WB + C * F_DOWN * S;
  static constexpr int WD = WC + C * F_DOWN * S;
  static constexpr int E = WD + C * F_DOWN * S;      // TRA energy (8,)
  static constexpr int YG = E + H * S;               // TRA conv output (8,)
  static constexpr int G = YG + H * S;               // TRA gate (8,)
  static constexpr int TOTAL = G + H * S;
  __host__ __device__ static constexpr int skip(int k) {
    return k == 0 ? R0 : R1 + (k - 1) * C * F_DOWN * S;
  }
};
constexpr size_t SMEM_BYTES = Smem<TILE>::TOTAL * sizeof(float);

#define ITEMS(n) for (int it = threadIdx.x; it < (n); it += blockDim.x)

// (1,5) freq conv, stride 2, pad 2, folded bias + PReLU: (CI, Fin) -> (16, Fout)
template <typename T, int S, int CI>
__device__ void conv5_stride2(const T* __restrict__ W, ConvW o, const float* in, int Fin,
                              float* out, int Fout) {
  const float a = ldw(W + o.a);
  ITEMS(Fout * S) {
    const int fo = it / S, s = it % S;
    float acc[C];
#pragma unroll
    for (int co = 0; co < C; ++co) acc[co] = 0.f;
    for (int k = 0; k < 5; ++k) {
      const int fi = 2 * fo + k - 2;
      if (fi < 0 || fi >= Fin) continue;
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {
        const float xv = in[(ci * Fin + fi) * S + s];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] += ldw(W + o.w + (k * C + co) * CI + ci) * xv;
      }
    }
#pragma unroll
    for (int co = 0; co < C; ++co)
      out[(co * Fout + fo) * S + s] = prelu(acc[co] + ldw(W + o.b + co), a);
  }
}

// (1,5) transposed freq conv, stride 2, pad 2 (zero-stuffed input): (16, Fin)
// -> (CO, 2 Fin - 1), bias added; PReLU (de3) or tanh (de4) after.
template <typename T, int S, int CO, bool LAST>
__device__ void deconv5_up2(const T* __restrict__ W, int w_off, int b_off, int a_off,
                            const float* in, int Fin, float* out) {
  const int Fout = 2 * Fin - 1;
  const float a = LAST ? 0.f : ldw(W + a_off);
  ITEMS(Fout * S) {
    const int fo = it / S, s = it % S;
    float acc[CO];
#pragma unroll
    for (int co = 0; co < CO; ++co) acc[co] = 0.f;
    for (int k = 0; k < 5; ++k) {
      const int m = fo + k - 2;  // index into the zero-stuffed input
      if (m < 0 || (m & 1) || (m >> 1) >= Fin) continue;
      const int j = m >> 1;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float xv = in[(ci * Fin + j) * S + s];
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] += ldw(W + w_off + (k * CO + co) * C + ci) * xv;
      }
    }
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      const float v = acc[co] + ldw(W + b_off + co);
      out[(co * Fout + fo) * S + s] = LAST ? tanhf(v) : prelu(v, a);
    }
  }
}

// x += skip over a whole (16, F) activation
template <int S>
__device__ void add_skip(float* x, const float* skip, int F) {
  ITEMS(C * F * S) x[it] += skip[it];
  __syncthreads();
}

// One frame value of a ring tap at (c, f) for stream b; zero outside F / B.
template <typename T>
__device__ __forceinline__ float tap_at(const T* p, int c, int f, int b, int B) {
  return (f >= 0 && f < F_DOWN && b < B) ? to_f(p[(size_t)(c * F_DOWN + f) * B + b]) : 0.f;
}

// GTConvBlock: in (16,33) -> out (16,33) (in == out allowed).  Writes ring
// frames h (RDW) and the TRA energy e (RTRA).
template <typename T, int S, bool DECONV, int RDW, int RTRA, class IO>
__device__ void gtconv(const T* __restrict__ W, const GtW& g, const IO& io, const float* in,
                       float* out, float* sm, int b0, int B) {
  using M = Smem<S>;
  float* h = sm + M::WB;
  float* h2 = sm + M::WC;
  float* h3 = sm + M::WD;
  float* E = sm + M::E;
  float* YG = sm + M::YG;
  float* G = sm + M::G;

  // h = PReLU(pw1 @ x[:8] + b)
  {
    const float a1 = ldw(W + g.a1);
    ITEMS(F_DOWN * S) {
      const int f = it / S, s = it % S;
      float acc[C];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = 0.f;
#pragma unroll
      for (int ci = 0; ci < H; ++ci) {
        const float xv = in[(ci * F_DOWN + f) * S + s];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] += ldw(W + g.pw1_w + co * H + ci) * xv;
      }
#pragma unroll
      for (int co = 0; co < C; ++co)
        h[(co * F_DOWN + f) * S + s] = prelu(acc[co] + ldw(W + g.pw1_b + co), a1);
    }
  }
  __syncthreads();

  // h2 = PReLU(conv3x3 over (x_{t-2}, x_{t-1}, h) + b): depthwise in the
  // encoder, a full 16x16 conv in the decoder
  {
    const T* t0 = io.t0(RDW);
    const T* t1 = io.t1(RDW);
    const float a2 = ldw(W + g.a2);
    ITEMS(F_DOWN * S) {
      const int f = it / S, s = it % S, b = b0 + s;
      if (!DECONV) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float y[3];
#pragma unroll
          for (int kt = 0; kt < 3; ++kt) {
            float acc = 0.f;
#pragma unroll
            for (int kf = 0; kf < 3; ++kf) {
              const int fi = f + kf - 1;
              const float xv = kt == 0 ? tap_at(t0, c, fi, b, B)
                             : kt == 1 ? tap_at(t1, c, fi, b, B)
                             : (fi >= 0 && fi < F_DOWN ? h[(c * F_DOWN + fi) * S + s] : 0.f);
              acc += ldw(W + g.dw_w + (kt * 3 + kf) * C + c) * xv;
            }
            y[kt] = acc;
          }
          h2[(c * F_DOWN + f) * S + s] = prelu(y[0] + y[1] + y[2] + ldw(W + g.dw_b + c), a2);
        }
      } else {
        float acc[C];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] = 0.f;
        for (int kt = 0; kt < 3; ++kt) {
          for (int kf = 0; kf < 3; ++kf) {
            const int fi = f + kf - 1;
            if (fi < 0 || fi >= F_DOWN) continue;
            const int wk = g.dw_w + (kt * 3 + kf) * C * C;
#pragma unroll
            for (int ci = 0; ci < C; ++ci) {
              const float xv = kt == 0 ? tap_at(t0, ci, fi, b, B)
                             : kt == 1 ? tap_at(t1, ci, fi, b, B)
                             : h[(ci * F_DOWN + fi) * S + s];
#pragma unroll
              for (int co = 0; co < C; ++co) acc[co] += ldw(W + wk + co * C + ci) * xv;
            }
          }
        }
#pragma unroll
        for (int co = 0; co < C; ++co)
          h2[(co * F_DOWN + f) * S + s] = prelu(acc[co] + ldw(W + g.dw_b + co), a2);
      }
    }
  }
  __syncthreads();

  // h3 = pw2 @ h2 + b; the dw ring's new frame h goes out now that every
  // read of its tap 0 is done
  {
    T* fr = io.out(RDW);
    ITEMS(F_DOWN * S) {
      const int f = it / S, s = it % S, b = b0 + s;
      float acc[H];
#pragma unroll
      for (int co = 0; co < H; ++co) acc[co] = 0.f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float xv = h2[(ci * F_DOWN + f) * S + s];
#pragma unroll
        for (int co = 0; co < H; ++co) acc[co] += ldw(W + g.pw2_w + co * C + ci) * xv;
      }
#pragma unroll
      for (int co = 0; co < H; ++co) h3[(co * F_DOWN + f) * S + s] = acc[co] + ldw(W + g.pw2_b + co);
      if (b < B) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          fr[(size_t)(c * F_DOWN + f) * B + b] = from_f<T>(h[(c * F_DOWN + f) * S + s]);
      }
    }
  }
  __syncthreads();

  // TRA: energy e = mean_f h3^2, then the 3-tap time conv over (e_{t-2}, e_{t-1}, e)
  {
    const T* e0p = io.t0(RTRA);
    const T* e1p = io.t1(RTRA);
    ITEMS(H * S) {
      const int c = it / S, s = it % S, b = b0 + s;
      float e = 0.f;
      for (int f = 0; f < F_DOWN; ++f) {
        const float v = h3[(c * F_DOWN + f) * S + s];
        e += v * v;
      }
      e = e / float(F_DOWN);
      const float e0 = b < B ? to_f(e0p[(size_t)c * B + b]) : 0.f;
      const float e1 = b < B ? to_f(e1p[(size_t)c * B + b]) : 0.f;
      E[c * S + s] = e;
      YG[c * S + s] = ldw(W + g.tra_db + c) + ldw(W + g.tra_dw + c) * e0
                    + ldw(W + g.tra_dw + H + c) * e1 + ldw(W + g.tra_dw + 2 * H + c) * e;
    }
  }
  __syncthreads();

  // gate g = sigmoid(tra_pw @ yg + b); the TRA ring's new frame is e
  {
    T* fr = io.out(RTRA);
    ITEMS(H * S) {
      const int c = it / S, s = it % S, b = b0 + s;
      float acc = 0.f;
#pragma unroll
      for (int ci = 0; ci < H; ++ci) acc += ldw(W + g.tra_pw + c * H + ci) * YG[ci * S + s];
      G[c * S + s] = sigmoidf(acc + ldw(W + g.tra_pb + c));
      if (b < B) fr[(size_t)c * B + b] = from_f<T>(E[c * S + s]);
    }
  }
  __syncthreads();

  // out[2i] = h3[i] * g[i] (gated half), out[2i+1] = x[8+i] (passive half)
  ITEMS(F_DOWN * S) {
    const int f = it / S, s = it % S;
    float x2[H];
#pragma unroll
    for (int i = 0; i < H; ++i) x2[i] = in[((H + i) * F_DOWN + f) * S + s];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      out[(2 * i * F_DOWN + f) * S + s] = h3[(i * F_DOWN + f) * S + s] * G[i * S + s];
      out[((2 * i + 1) * F_DOWN + f) * S + s] = x2[i];
    }
  }
  __syncthreads();
}

// Residual TCN block: in (16,33) -> out (16,33) (in == out allowed).  Writes
// ring frame h (R).
template <typename T, int S, int R, class IO>
__device__ void tcn(const T* __restrict__ W, const TcnW& o, const IO& io, const float* in,
                    float* out, float* sm, int b0, int B) {
  using M = Smem<S>;
  float* h = sm + M::WB;
  float* h2 = sm + M::WC;

  {  // h = PReLU(pw1 @ x + b)
    const float a1 = ldw(W + o.a1);
    ITEMS(F_DOWN * S) {
      const int f = it / S, s = it % S;
      float acc[C];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = 0.f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float xv = in[(ci * F_DOWN + f) * S + s];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] += ldw(W + o.pw1_w + co * C + ci) * xv;
      }
#pragma unroll
      for (int co = 0; co < C; ++co)
        h[(co * F_DOWN + f) * S + s] = prelu(acc[co] + ldw(W + o.pw1_b + co), a1);
    }
  }
  __syncthreads();

  {  // h2 = PReLU(w0 x_{t-2d} + w1 x_{t-d} + w2 h + b), depthwise in time.
     // Each item reads tap 0 at exactly the address its new frame goes to,
     // so the frame is written right after the read.
    const T* t0 = io.t0(R);
    const T* t1 = io.t1(R);
    T* fr = io.out(R);
    const float a2 = ldw(W + o.a2);
    ITEMS(C * F_DOWN * S) {
      const int c = it / (F_DOWN * S), f = (it / S) % F_DOWN, s = it % S, b = b0 + s;
      const size_t gi = (size_t)(c * F_DOWN + f) * B + b;
      const float x0 = b < B ? to_f(t0[gi]) : 0.f;
      const float x1 = b < B ? to_f(t1[gi]) : 0.f;
      const float hv = h[it];
      const float y = ldw(W + o.dw_w + c) * x0 + ldw(W + o.dw_w + C + c) * x1
                    + ldw(W + o.dw_w + 2 * C + c) * hv + ldw(W + o.dw_b + c);
      h2[it] = prelu(y, a2);
      if (b < B) fr[gi] = from_f<T>(hv);
    }
  }
  __syncthreads();

  {  // out = PReLU(pw3 @ h2 + b + x)
    const float a3 = ldw(W + o.a3);
    ITEMS(F_DOWN * S) {
      const int f = it / S, s = it % S;
      float acc[C];
#pragma unroll
      for (int co = 0; co < C; ++co) acc[co] = 0.f;
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const float xv = h2[(ci * F_DOWN + f) * S + s];
#pragma unroll
        for (int co = 0; co < C; ++co) acc[co] += ldw(W + o.pw3_w + co * C + ci) * xv;
      }
#pragma unroll
      for (int co = 0; co < C; ++co) {
        const int i = (co * F_DOWN + f) * S + s;
        out[i] = prelu(acc[co] + ldw(W + o.pw3_b + co) + in[i], a3);
      }
    }
  }
  __syncthreads();
}

// The whole forward for streams [b0, b0 + S) of B.  spec/out are (B, 257, 2).
template <typename T, int S, class IO>
__device__ void forward(const T* __restrict__ W, const WOffs& o, const T* __restrict__ spec,
                        T* __restrict__ out, const IO& io, int b0, int B, float* sm) {
  using M = Smem<S>;
  float* sp = sm + M::WA;   // spec [2][257][S]
  float* mag = sm + M::WD;  // [257][S]
  float* x0 = sm + M::WB;   // ERB-merged features [3][129][S]
  float* x1 = sm + M::WC;   // after SFE [3][129][S]

  ITEMS(S * 2 * F_FULL) {
    const int s = it / (2 * F_FULL), j = it % (2 * F_FULL), b = b0 + s;
    sp[((j & 1) * F_FULL + (j >> 1)) * S + s] = b < B ? to_f(spec[(size_t)b * 2 * F_FULL + j]) : 0.f;
  }
  __syncthreads();
  ITEMS(F_FULL * S) {
    const float re = sp[it], im = sp[F_FULL * S + it];
    mag[it] = sqrtf(re * re + im * im + 1e-12f);
  }
  __syncthreads();

  // ERB band merge of (mag, re, im); bins 0-64 pass through
  ITEMS(F_ERB * S) {
    const int f = it / S, s = it % S;
    float v[3];
    if (f < N_LO) {
      v[0] = mag[f * S + s];
      v[1] = sp[f * S + s];
      v[2] = sp[(F_FULL + f) * S + s];
    } else {
      const T* w = W + o.bm_w + (f - N_LO) * N_HI;
      v[0] = v[1] = v[2] = 0.f;
      for (int k = 0; k < N_HI; ++k) {
        const float wk = ldw(w + k);
        const int i = (N_LO + k) * S + s;
        v[0] += wk * mag[i];
        v[1] += wk * sp[i];
        v[2] += wk * sp[F_FULL * S + i];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) x0[(c * F_ERB + f) * S + s] = v[c];
  }
  __syncthreads();

  // SFE-Lite: depthwise 3-tap freq conv, no bias; weights (kf, c)
  ITEMS(3 * F_ERB * S) {
    const int c = it / (F_ERB * S), f = (it / S) % F_ERB, s = it % S;
    float acc = 0.f;
#pragma unroll
    for (int kf = 0; kf < 3; ++kf) {
      const int fi = f + kf - 1;
      const float xv = (fi >= 0 && fi < F_ERB) ? x0[(c * F_ERB + fi) * S + s] : 0.f;
      acc += ldw(W + o.sfe_w + kf * 3 + c) * xv;
    }
    x1[it] = acc;
  }
  __syncthreads();

  // encoder: two stride-2 convs (129 -> 65 -> 33), three GTConv blocks
  conv5_stride2<T, S, 3>(W, o.en[0], x1, F_ERB, sm + M::skip(0), F_MID);
  __syncthreads();
  conv5_stride2<T, S, C>(W, o.en[1], sm + M::skip(0), F_MID, sm + M::skip(1), F_DOWN);
  __syncthreads();
  gtconv<T, S, false, ENC_DW + 0, ENC_TRA + 0>(W, o.enc[0], io, sm + M::skip(1), sm + M::skip(2), sm, b0, B);
  gtconv<T, S, false, ENC_DW + 1, ENC_TRA + 1>(W, o.enc[1], io, sm + M::skip(2), sm + M::skip(3), sm, b0, B);
  gtconv<T, S, false, ENC_DW + 2, ENC_TRA + 2>(W, o.enc[2], io, sm + M::skip(3), sm + M::skip(4), sm, b0, B);

  // two stacks of four dilated TCNs (d = 1, 2, 4, 8); the trunk lives in WA
  float* x = sm + M::WA;
  tcn<T, S, TCN + 0>(W, o.tcn[0], io, sm + M::skip(4), x, sm, b0, B);
  tcn<T, S, TCN + 1>(W, o.tcn[1], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 2>(W, o.tcn[2], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 3>(W, o.tcn[3], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 4>(W, o.tcn[4], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 5>(W, o.tcn[5], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 6>(W, o.tcn[6], io, x, x, sm, b0, B);
  tcn<T, S, TCN + 7>(W, o.tcn[7], io, x, x, sm, b0, B);

  // decoder: additive skips 4, 3, 2 into three GTConv blocks, then 1 and 0
  // into the transposed convs (33 -> 65 -> 129)
  add_skip<S>(x, sm + M::skip(4), F_DOWN);
  gtconv<T, S, true, DEC_DW + 0, DEC_TRA + 0>(W, o.dec[0], io, x, x, sm, b0, B);
  add_skip<S>(x, sm + M::skip(3), F_DOWN);
  gtconv<T, S, true, DEC_DW + 1, DEC_TRA + 1>(W, o.dec[1], io, x, x, sm, b0, B);
  add_skip<S>(x, sm + M::skip(2), F_DOWN);
  gtconv<T, S, true, DEC_DW + 2, DEC_TRA + 2>(W, o.dec[2], io, x, x, sm, b0, B);
  add_skip<S>(x, sm + M::skip(1), F_DOWN);
  float* d3 = sm + M::WB;  // (16, 65), spans WB and WC
  deconv5_up2<T, S, C, false>(W, o.de3.w, o.de3.b, o.de3.a, x, F_DOWN, d3);
  __syncthreads();
  add_skip<S>(d3, sm + M::skip(0), F_MID);
  float* m = sm + M::WA;  // mask (2, 129)
  deconv5_up2<T, S, 2, true>(W, o.de4_w, o.de4_b, 0, d3, F_MID, m);
  __syncthreads();

  // ERB band split of the mask, complex ratio mask on the input spectrum
  ITEMS(F_FULL * S) {
    const int f = it / S, s = it % S, b = b0 + s;
    if (b >= B) continue;
    float mr, mi;
    if (f < N_LO) {
      mr = m[f * S + s];
      mi = m[(F_ERB + f) * S + s];
    } else {
      const T* w = W + o.bs_w + (f - N_LO) * N_BANDS;
      mr = mi = 0.f;
      for (int k = 0; k < N_BANDS; ++k) {
        const float wk = ldw(w + k);
        mr += wk * m[(N_LO + k) * S + s];
        mi += wk * m[(F_ERB + N_LO + k) * S + s];
      }
    }
    const size_t gi = ((size_t)b * F_FULL + f) * 2;
    const float re = to_f(spec[gi]), im = to_f(spec[gi + 1]);
    out[gi] = from_f<T>(re * mr - im * mi);
    out[gi + 1] = from_f<T>(im * mr + re * mi);
  }
}

}  // namespace gtcrn
