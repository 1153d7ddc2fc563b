// Stand-in for csrc/gtcrn_mma.cuh on the host.  TF32 rounding keeps 10
// mantissa bits, to nearest with ties away from zero (cvt.rna), and zeroes
// the 13 below.  An m16n8k8 product is the warp's: each lane puts its
// fragments in its warp's scratch, a barrier of the warp's 32 threads, then
// each lane sums the products of its D entries exactly and rounds once to
// float.  The scratch is double-buffered by the parity of the lane's count
// of products, so one barrier a product suffices: a lane refills a buffer
// only after every lane has passed the next product's barrier, and so has
// finished reading it.  Lane 0 counts the warp's products in
// emu_mma_products.
#pragma once
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <barrier>

namespace gtcrn {

struct EmuWarp {
  std::barrier<> bar{32};
  float a[2][32][4];
  float b[2][32][2];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local unsigned emu_products;
inline std::atomic<unsigned long long> emu_mma_products{0};

inline int tid_now() { return (int)threadIdx.x; }

inline unsigned tf32(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;  // the magnitude's half ulp
  return u & 0xffffe000u;
}

inline float emu_tf32_value(unsigned u) {  // the unit reads the TF32 bits alone
  u &= 0xffffe000u;
  float f;
  memcpy(&f, &u, 4);
  return f;
}

inline void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  EmuWarp& w = *emu_warp;
  const int l = threadIdx.x & 31, p = emu_products++ & 1;
  if (l == 0) emu_mma_products.fetch_add(1, std::memory_order_relaxed);
  for (int i = 0; i < 4; ++i) w.a[p][l][i] = emu_tf32_value(a[i]);
  for (int i = 0; i < 2; ++i) w.b[p][l][i] = emu_tf32_value(b[i]);
  w.bar.arrive_and_wait();
  const int g = l >> 2, q = l & 3;
  for (int r = 0; r < 4; ++r) {
    const int row = g + 8 * (r >> 1), col = 2 * q + (r & 1);
    double s = d[r];
    for (int k = 0; k < 8; ++k)
      s += (double)w.a[p][(row & 7) * 4 + (k & 3)][(row >> 3) + 2 * (k >> 2)] *
           (double)w.b[p][col * 4 + (k & 3)][k >> 2];
    d[r] = (float)s;
  }
}

}  // namespace gtcrn
