// Scalar loads and stores between a kernel's storage type (fp32 or bf16) and
// the fp32 it computes in.  Shared by every kernel of this directory.
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline void from_float(float* p, float x) { *p = x; }
__device__ inline void from_float(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

}  // namespace repro
