// Stand-in for <cuda.h> on the host: the CUDA tensor-map types that
// csrc/gtcrn_forward.cuh names.  A CUtensorMap here holds what the emulated
// tensor copy (gtcrn_async.cuh) reads; emu.cpp's emu_encode_tiled fills it
// and checks the alignment rules cuTensorMapEncodeTiled checks.
#pragma once
#include <stdint.h>

typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
enum CUresult { CUDA_SUCCESS = 0, CUDA_ERROR_INVALID_VALUE = 1 };
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0 };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };

// a tiled map: rank dims innermost first, strides in bytes of dims 1.., box
struct alignas(64) CUtensorMap {
  const char* base;
  uint32_t rank, elem;
  uint64_t dims[5], strides[4];
  uint32_t box[5];
};
