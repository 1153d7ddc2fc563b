// Kernel L: one LSTM layer (one or both directions) over a whole sequence in
// one launch, persistent and weight-stationary.
//
// Replaces no TPU kernel: the JAX package has no LSTM.  It was added for
// TF-GridNet's full-band BiLSTM (nn/core.LSTM, 192 inputs, 192 hidden units,
// 516 rows at batch 4, chains of up to 8,190 windows), where aten's loop
// launches two 516 x 192 x 768 GEMMs and a cell kernel a step and
// direction, ~27 us a step replayed, the input projection among them.
//
// What bounds it.  Each step is the product of the rows' [x_t, h_{t-1}]
// (384 values) with 768 gate columns, whose h half waits on the step
// before, so the chain is serial: its bound is the dispatch of float32 FMAs on
// the SMs that hold its rows, not bytes.  516 rows in both directions take
// 112 SMs (7 groups of 74 rows a direction, 80 computed), each SM's share of
// a step 80 rows x 96 columns x 384 = 2.95 M FMAs, 23 k cycles at 128 a
// cycle; both halves of a step measure 40 k (x half 23.0 k with its staging,
// h half 17.3 k), the cell 4.5 k and the rest 2 k (clock64 probe): ~24 us a
// step on an H100 at 1,980 MHz, half its SMs' FMA dispatch bound and 38 % of
// the card's float32 peak on the valid steps' FLOPs.
//
// Design.  A cluster of CL = 8 CTAs owns one direction of a group of up to
// ROWS = 80 rows and walks that group's whole chain; clusters never wait on
// each other (no grid-wide barrier, no cooperative launch), so the kernel
// is captured into a CUDA graph like any other.  CTA q of a cluster owns
// hidden units [24 q, 24 q + 24) and their i, f, g, o gate columns (96), so
// it applies the cell to its own units with no exchange of gates:
//   - its slice of [W_ih | W_hh] (384 x 96 floats, 147,456 bytes) stays in
//     shared memory for the whole chain, unit-major (unit u's four gates
//     are one 16-byte load); the cell state c stays in registers;
//   - 8 warps: each of 240 threads owns one unit and 8 rows (10 row blocks x
//     24 units), 32 accumulators, and per input column one 16-byte weight
//     load and two 16-byte activation loads (the 24 threads of a row block
//     read the same ones) for 32 FMAs;
//   - activations column-major in shared memory (column k, then its 80
//     rows): h_{t-1} of the group (61,440 bytes) and x_t staged through
//     registers in chunks of 32 columns, double-buffered (20,480 bytes):
//     229,376 bytes of dynamic shared memory and 144 registers a thread,
//     one CTA an SM.  An H100 holds 15 such clusters at once (14-16 by how
//     its SMs fall into GPCs), so a cluster takes up to 80 rows: 516 rows
//     are 7 groups a direction, 14 clusters, one wave;
//   - a step: the x half (the next chunk loaded while this one computes,
//     the next step's first chunk in flight across the h half); wait on
//     the CTA's mbarrier for the other CTAs' h_{t-1}; the h half; arrive at
//     the cluster barrier (done reading h); the cell and y_t; wait at the
//     barrier (every CTA done reading); h_t into the CTA's own slice of its
//     h buffer, and that 7,680-byte slice copied into the other seven CTAs'
//     buffers by bulk copies that complete on their mbarriers, landing
//     while the next x half computes.  One h buffer (a second does not fit
//     beside the weights), so one cluster barrier a step.
// Float32 FMAs throughout, sigmoid and tanh by expf and tanhf: float32's
// accuracy, in another order of sums than aten's GEMMs.  (Three TF32
// products on mma.sync measured no faster here, 23.3 us a step, and 8x
// further from the float32 loop.)
//
// Lengths stay on the device: row n has lengths[n] valid steps.  The
// forward direction reads x at step s, the backward one at lengths[n] - 1 -
// s, so each row's backward chain starts at its own last step; a step past
// a row's length writes a zero at position s of its direction, and each
// cluster stops at its rows' longest length and zeroes the positions after
// it.  Nothing about the lengths reaches the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int HID = 192;         // hidden units: the kernel's one width
constexpr int CL = 8;            // CTAs a cluster
constexpr int UNITS = HID / CL;  // 24 hidden units a CTA
constexpr int COLS = 4 * UNITS;  // 96 gate columns a CTA, unit-major: u's i, f, g, o
constexpr int RB = 10;           // row blocks
constexpr int RT = 8;            // rows a thread (a row block)
constexpr int ROWS = RB * RT;    // 80 rows a cluster
constexpr int RS = ROWS;         // an activation column's stride in shared memory
constexpr int NT = 256;          // threads: RB * UNITS = 240 compute, all stage x
constexpr int NC = RB * UNITS;
constexpr int KC = 32;           // input columns a staged chunk
constexpr int IN_MAX = 192;
constexpr int W_FLOATS = (IN_MAX + HID) * COLS;  // 36,864
constexpr int H_FLOATS = HID * RS;               // 15,360
constexpr int X_FLOATS = KC * RS;                // 2,560 a buffer
constexpr size_t SMEM_BYTES = sizeof(float) * (W_FLOATS + H_FLOATS + 2 * X_FLOATS);
constexpr int XQ = ROWS * (KC / 4);     // 640 16-byte pieces of a chunk
constexpr int XI = (XQ + NT - 1) / NT;  // 3 a thread

struct Args {
  const float* x;             // (N, S, I), contiguous
  const long long* lengths;   // (N,), or null: every step valid
  const float* w;             // (D, CL, I + HID, COLS)
  const float* b;             // (D, CL, COLS): b_ih + b_hh
  float* y;                   // (N, S, D * HID)
  int N, S, I, D, R, G;       // rows, steps, inputs, directions, rows a group, groups
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of shared location `a` (of this CTA) in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival on bar announcing `bytes` of copies to come in this phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until bar's phase of parity `parity` has completed: the copies it
// counted have landed and are visible to this thread.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}

// Copy `bytes` of this CTA's shared memory at src to the shared memory of
// another CTA of the cluster at dst (a cluster address), completing on its
// mbarrier at bar (a cluster address).
__device__ __forceinline__ void push(unsigned dst, unsigned src, unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// acc[m][g] += sum over NK columns k of act[k][m] * w[k][g]: act points at
// this thread's rows of column 0 (columns RS apart), w at its unit's four
// gates of column 0 (columns COLS apart).
template <int NK>
__device__ __forceinline__ void gates(float (&acc)[RT][4], const float* __restrict__ act,
                                      const float* __restrict__ w) {
#pragma unroll 8
  for (int k = 0; k < NK; ++k) {
    const float4 wk = *reinterpret_cast<const float4*>(w + k * COLS);
    const float4 a0 = reinterpret_cast<const float4*>(act + k * RS)[0];
    const float4 a1 = reinterpret_cast<const float4*>(act + k * RS)[1];
    const float av[RT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      acc[m][0] = fmaf(av[m], wk.x, acc[m][0]);
      acc[m][1] = fmaf(av[m], wk.y, acc[m][1]);
      acc[m][2] = fmaf(av[m], wk.z, acc[m][2]);
      acc[m][3] = fmaf(av[m], wk.w, acc[m][3]);
    }
  }
}

__global__ void __launch_bounds__(NT, 1) lstm_layer(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  float* ws = sm;               // [I + HID][COLS]
  float* hs = sm + W_FLOATS;    // [HID][RS]: h_{t-1} of the group, column-major
  float* xs = hs + H_FLOATS;    // [2][KC][RS]
  __shared__ int len_s[ROWS];
  __shared__ int lmax_s;
  __shared__ __align__(8) unsigned long long hbar;  // h_t of the other CTAs has landed

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int cid = blockIdx.x / CL;
  const int d = cid / a.G, g = cid % a.G;
  const int row0 = g * a.R;
  const int rows = min(a.R, a.N - row0);
  const int K = a.I + HID, nch = a.I / KC, tid = threadIdx.x;

  const float4* wsrc = reinterpret_cast<const float4*>(a.w + (size_t)(d * CL + q) * K * COLS);
  for (int i = tid; i < K * COLS / 4; i += NT) reinterpret_cast<float4*>(ws)[i] = wsrc[i];
  for (int r = tid; r < ROWS; r += NT) {
    long long L = 0;
    if (r < rows) L = a.lengths ? a.lengths[row0 + r] : a.S;
    len_s[r] = (int)min(max(L, 0LL), (long long)a.S);
  }
  if (tid == 0) mbar_init(&hbar, 1);
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < ROWS; ++r) m = max(m, len_s[r]);
    lmax_s = m;
  }
  __syncthreads();
  const int lmax = lmax_s;

  const bool computes = tid < NC;
  const int j = computes ? tid / UNITS : 0, u = computes ? tid % UNITS : 0;
  const int ycol = d * HID + q * UNITS + u;
  const size_t ystride = (size_t)a.D * HID;
  float bias[4], c[RT], acc[RT][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bias[k] = a.b[(d * CL + q) * COLS + 4 * u + k];
#pragma unroll
  for (int m = 0; m < RT; ++m) c[m] = 0.0f;
  // this CTA's slice of every h buffer: its units' columns
  float* own = hs + q * UNITS * RS;
  const unsigned own_addr = smem_addr(own), bar_addr = smem_addr(&hbar);

  // x_t of the group, chunk ch, into registers (zero past a row's length)
  // and from there into xs column-major
  float4 xr[XI];
  auto load_x = [&](int s, int ch) {
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int idx = tid + NT * i;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (idx < XQ) {
        const int r = idx % ROWS, kq = idx / ROWS, L = len_s[r];
        if (s < L) {
          const int t = d == 0 ? s : L - 1 - s;
          v = __ldg(reinterpret_cast<const float4*>(
              a.x + ((size_t)(row0 + r) * a.S + t) * a.I + ch * KC + 4 * kq));
        }
      }
      xr[i] = v;
    }
  };
  auto store_x = [&](int buf) {
    float* dst = xs + buf * X_FLOATS;
#pragma unroll
    for (int i = 0; i < XI; ++i) {
      const int idx = tid + NT * i;
      if (idx < XQ) {
        const int r = idx % ROWS, kq = idx / ROWS;
        float* p = dst + 4 * kq * RS + r;
        p[0] = xr[i].x;
        p[RS] = xr[i].y;
        p[2 * RS] = xr[i].z;
        p[3 * RS] = xr[i].w;
      }
    }
  };

  if (lmax > 0) load_x(0, 0);
  // every CTA of the cluster has started and initialised its mbarrier
  cluster_arrive();
  cluster_wait();
  for (int s = 0; s < lmax; ++s) {
    store_x(0);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < RT; ++m)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][k] = bias[k];
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) load_x(s, ch + 1);
      if (computes)
        gates<KC>(acc, xs + (ch & 1) * X_FLOATS + RT * j, ws + ch * KC * COLS + 4 * u);
      if (ch + 1 < nch) store_x((ch + 1) & 1);
      __syncthreads();
    }
    if (s + 1 < lmax) load_x(s + 1, 0);
    if (s > 0) mbar_wait(&hbar, (s - 1) & 1);  // h_{s-1} of the other CTAs has landed
    // the copies of h_s start only after this CTA's arrival below
    if (tid == 0 && s + 1 < lmax) mbar_expect(&hbar, (CL - 1) * UNITS * RS * sizeof(float));
    if (s > 0 && computes) gates<HID>(acc, hs + RT * j, ws + a.I * COLS + 4 * u);
    cluster_arrive();  // done reading hs
    float h[RT];
#pragma unroll
    for (int m = 0; m < RT; ++m) {
      const float ig = sigmoid(acc[m][0]), fg = sigmoid(acc[m][1]);
      const float gg = tanhf(acc[m][2]), og = sigmoid(acc[m][3]);
      c[m] = fg * c[m] + ig * gg;
      h[m] = og * tanhf(c[m]);
    }
    if (computes) {
#pragma unroll
      for (int m = 0; m < RT; ++m) {
        const int r = RT * j + m;
        if (r < rows) {
          const int L = len_s[r];
          const bool valid = s < L;
          const int t = valid && d == 1 ? L - 1 - s : s;
          a.y[((size_t)(row0 + r) * a.S + t) * ystride + ycol] = valid ? h[m] : 0.0f;
        }
      }
    }
    cluster_wait();  // every CTA of the cluster is done reading h_{s-1}
    if (s + 1 < lmax) {
      // h_s into this CTA's slice, then the slice copied into every other
      // CTA's h buffer, landing while the next step's x half computes
      if (computes) {
        float4* dst = reinterpret_cast<float4*>(own + u * RS + RT * j);
        dst[0] = make_float4(h[0], h[1], h[2], h[3]);
        dst[1] = make_float4(h[4], h[5], h[6], h[7]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (tid < CL && tid != q)
        push(cluster_addr(own_addr, tid), own_addr, UNITS * RS * sizeof(float),
             cluster_addr(bar_addr, tid));
    }
  }
  // no CTA leaves while another may still read from it
  cluster_arrive();
  cluster_wait();

  if (computes) {
    for (int m = 0; m < RT; ++m) {
      const int r = RT * j + m;
      if (r >= rows) break;
      float* yr = a.y + (size_t)(row0 + r) * a.S * ystride + ycol;
      for (int t = lmax; t < a.S; ++t) yr[(size_t)t * ystride] = 0.0f;
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
  e = cudaFuncSetAttribute(lstm_layer, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)SMEM_BYTES);
  if (e == cudaSuccess) done.fetch_or(bit);
  return (int)e;
}

cudaLaunchConfig_t config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * clusters);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// x (N, S, I) float32 contiguous; lengths (N,) int64 or null; w, b as packed
// by ops/lstm.pack for D directions; y (N, S, D * 192) float32, every
// element written.  Rows go to ceil(N / 75) groups of R = ceil(N / groups),
// each group to one cluster a direction.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for arguments the kernel does not
// take (I a multiple of 32 up to 192).
extern "C" int gtcrn_lstm_layer(const void* x, const void* lengths, const void* w, const void* b,
                                void* y, int N, int S, int I, int D, void* stream) {
  if (N <= 0 || S <= 0 || I <= 0 || I > IN_MAX || I % KC || (D != 1 && D != 2))
    return (int)cudaErrorInvalidValue;
  const int e = prepare();
  if (e) return e;
  const int G = (N + ROWS - 1) / ROWS;
  Args a{static_cast<const float*>(x), static_cast<const long long*>(lengths),
         static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(y),
         N, S, I, D, (N + G - 1) / G, G};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(G * D, static_cast<cudaStream_t>(stream), attr);
  cudaLaunchKernelEx(&cfg, lstm_layer, a);
  return (int)cudaGetLastError();
}

// out[4]: registers per thread, local bytes per thread, shared bytes per CTA
// and resident CTAs per SM.
extern "C" int gtcrn_lstm_attrs(int* out) {
  int e = prepare();
  cudaFuncAttributes fa;
  if (!e) e = (int)cudaFuncGetAttributes(&fa, lstm_layer);
  int ctas = 0;
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, lstm_layer, NT, SMEM_BYTES);
  if (e) return e;
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)(fa.sharedSizeBytes + SMEM_BYTES);
  out[3] = ctas;
  return 0;
}

// *out: clusters of CL CTAs the current card holds at once.
extern "C" int gtcrn_lstm_clusters(int* out) {
  int e = prepare();
  if (e) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(1, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, lstm_layer, &cfg);
}
