// f32 <-> element type of the kernels' inputs and outputs (f32, bf16).
// Type codes match `DTYPE_CODES` in src/repro_torch/kernels/build.py.
#pragma once

#include <cuda_bf16.h>

#define REPRO_DTYPE_F32 0
#define REPRO_DTYPE_BF16 1

__device__ __forceinline__ float zo_load(const float* p) { return *p; }
__device__ __forceinline__ float zo_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void zo_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void zo_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
