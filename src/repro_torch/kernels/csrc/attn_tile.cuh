// Constants and 16-byte loads of the prefill attention kernel.
//
// Users: the prefill kernel (flash_attention.cu), whose fp32 path stages
// tiles as fp32 with these loads.  The decode kernels (decode_attention.cu,
// paged_attention.cu) walk their tiles with decode_tile.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// 16-byte global loads unpacked to fp32.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& raw, float* dst) {
    dst[0] = __uint_as_float(raw.x);
    dst[1] = __uint_as_float(raw.y);
    dst[2] = __uint_as_float(raw.z);
    dst[3] = __uint_as_float(raw.w);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& raw, float* dst) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the upper half of the fp32 of the same value
      dst[2 * i] = __uint_as_float(w[i] << 16);
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

}  // namespace repro
