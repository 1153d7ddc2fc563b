// Stand-in for csrc/gtcrn_async.cuh on the host.  A copy's destination reads
// as NaN from its issue until the issuing thread's next cp_async_wait_all,
// which lands it: a read of a staged weight before the wait and the barrier
// that make it visible, or of a buffer that is being refilled, reaches the
// output as NaN.
#pragma once
#include <math.h>
#include <string.h>

#include <vector>

namespace gtcrn {
struct EmuCopy {
  float* dst;
  const float* src;
};
inline thread_local std::vector<EmuCopy> emu_copies;

inline void cp_async16(float* dst, const float* src) {
  for (int i = 0; i < 4; ++i) dst[i] = NAN;
  emu_copies.push_back({dst, src});
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {
  for (const EmuCopy& c : emu_copies) memcpy(c.dst, c.src, 16);
  emu_copies.clear();
}
}  // namespace gtcrn
