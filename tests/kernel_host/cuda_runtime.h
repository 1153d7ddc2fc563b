// Stand-in for <cuda_runtime.h> when csrc/gtcrn_forward.cuh is compiled by
// the host C++ compiler (tests/test_torch_kernel_host.py): the CUDA names the
// forward uses, with one std::thread per CUDA thread.  __syncthreads is a
// std::barrier over the CTA's threads (gtcrn_mma.cuh has the warp's).
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <barrier>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct Dim3 { unsigned x, y, z; };
extern thread_local Dim3 threadIdx, blockIdx, blockDim;

extern thread_local std::barrier<>* emu_cta_barrier;

inline void __syncthreads() { emu_cta_barrier->arrive_and_wait(); }

inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// declared for the host helpers of the header; emu.cpp defines the two that
// prepare() calls (cudaGetDevice, cudaFuncSetAttribute) to test it
enum cudaError_t { cudaSuccess = 0 };
cudaError_t cudaGetDevice(int*);
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes, sharedSizeBytes; };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int);
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K);
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t);
