// Stand-in for csrc/gtcrn_async.cuh on the host.
//
// cp.async: a copy's destination reads as NaN from its issue until the
// issuing thread's next cp_async_wait_all, which lands it: a read of a
// staged weight before the wait and the barrier that make it visible, or of
// a buffer that is being refilled, reaches the output as NaN.
//
// Tensor copies and mbarriers: a tensor copy's destination reads as NaN from
// its issue; the copies of an mbarrier's phase land, reading their source
// then, when every thread of the CTA has reached its wait on that phase.  So
// a tap read before its layer's wait, a reissue into a buffer still in use,
// or a frame written over tap 0 before the wait reaches the output.  A phase
// that is waited on without its arrival, or whose copies do not add up to
// the bytes announced, would hang the card: here it aborts.
#pragma once
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <chrono>
#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <vector>

#include <cuda.h>

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

struct EmuTensorCopy {
  char* dst;
  const CUtensorMap* map;
  int at[4];
};

inline size_t emu_box_bytes(const CUtensorMap& m) {
  size_t n = m.elem;
  for (uint32_t i = 0; i < m.rank; ++i) n *= m.box[i];
  return n;
}

// The box of c.map at c.at, densely into c.dst; zeros outside the tensor.
inline void emu_land(const EmuTensorCopy& c) {
  const CUtensorMap& m = *c.map;
  const uint32_t* b = m.box;
  char* d = c.dst;
  for (uint32_t w = 0; w < b[3]; ++w)
    for (uint32_t z = 0; z < b[2]; ++z)
      for (uint32_t y = 0; y < b[1]; ++y)
        for (uint32_t x = 0; x < b[0]; ++x, d += m.elem) {
          const int64_t p[4] = {(int64_t)c.at[0] + x, (int64_t)c.at[1] + y, (int64_t)c.at[2] + z,
                                (int64_t)c.at[3] + w};
          bool in = true;
          for (int i = 0; i < 4; ++i) in = in && p[i] >= 0 && p[i] < (int64_t)m.dims[i];
          if (!in) {
            memset(d, 0, m.elem);
            continue;
          }
          memcpy(d, m.base + p[0] * m.elem + p[1] * m.strides[0] + p[2] * m.strides[1] +
                        p[3] * m.strides[2], m.elem);
        }
}

struct EmuMbar {
  std::mutex mu;
  std::condition_variable cv;
  unsigned phase = 0;     // phases completed
  unsigned count = 0;     // arrivals a phase takes
  unsigned arrived = 0;   // arrivals in this phase
  size_t expected = 0;    // bytes announced in this phase
  unsigned waiting = 0;   // threads at this phase's wait
  std::vector<EmuTensorCopy> copies;
};
inline std::mutex emu_mbars_mu;
inline std::map<const void*, std::unique_ptr<EmuMbar>> emu_mbars;

inline EmuMbar& emu_mbar(const void* bar) {
  std::lock_guard<std::mutex> g(emu_mbars_mu);
  auto it = emu_mbars.find(bar);
  if (it == emu_mbars.end()) {
    fprintf(stderr, "emu: mbarrier %p used before its init\n", bar);
    abort();
  }
  return *it->second;
}

[[noreturn]] inline void emu_hang(const char* what) {
  fprintf(stderr, "emu: %s: the card would wait forever\n", what);
  abort();
}

inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> g(emu_mbars_mu);
  auto m = std::make_unique<EmuMbar>();
  m->count = count;
  emu_mbars[bar] = std::move(m);
}

inline void mbar_expect(unsigned long long* bar, unsigned bytes) {
  EmuMbar& m = emu_mbar(bar);
  std::lock_guard<std::mutex> g(m.mu);
  m.arrived += 1;
  m.expected += bytes;
}

inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  EmuMbar& m = emu_mbar(bar);
  std::unique_lock<std::mutex> lk(m.mu);
  if ((m.phase & 1) != parity) return;  // that phase has completed
  const unsigned ph = m.phase;
  if (++m.waiting < blockDim.x) {
    if (!m.cv.wait_for(lk, std::chrono::seconds(300), [&] { return m.phase != ph; }))
      emu_hang("an mbarrier phase never completed");
    return;
  }
  size_t bytes = 0;
  for (const EmuTensorCopy& c : m.copies) bytes += emu_box_bytes(*c.map);
  if (m.arrived != m.count) emu_hang("a phase waited on without its arrivals");
  if (bytes != m.expected) emu_hang("a phase's copies differ from the bytes announced");
  for (const EmuTensorCopy& c : m.copies) emu_land(c);
  m.copies.clear();
  m.arrived = m.waiting = 0;
  m.expected = 0;
  m.phase += 1;
  m.cv.notify_all();
}

inline void fence_proxy_async() {}

inline void tma_load_4d(void* dst, const CUtensorMap* map, int x, int y, int z, int w,
                        unsigned long long* bar) {
  if (map->rank != 4) emu_hang("a 4-D copy through a map of another rank");
  memset(dst, 0xff, emu_box_bytes(*map));  // NaN in float32 and bf16 alike
  EmuMbar& m = emu_mbar(bar);
  std::lock_guard<std::mutex> g(m.mu);
  m.copies.push_back({static_cast<char*>(dst), map, {x, y, z, w}});
}
}  // namespace gtcrn
