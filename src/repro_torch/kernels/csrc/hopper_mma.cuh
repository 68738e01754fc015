// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a),
// written as inline PTX: 16-byte cp.async copies into shared memory and the
// warpgroup products (wgmma) with fp32 accumulators.
//
// wgmma (sm_90a only): a warpgroup of 4 warps multiplies a 64-row tile
// asynchronously, B (and A, or A from registers) read from shared memory
// through a matrix descriptor: the start address, LBO and SBO (byte steps
// between 8 x 16-byte core matrices, CUTLASS's names) and the swizzle.
// The fp32 accumulator of m64nNk16 gives warp w of the group rows
// 16 w + gid and 16 w + gid + 8 (lane = 4 gid + tig), columns 8 j + 2 tig
// and 8 j + 2 tig + 1 in d[4 j..4 j + 3].  A register A operand (64 x 16
// bf16) takes rows 16 w + gid (a0, a2) and 16 w + gid + 8 (a1, a3), columns
// 2 tig..+1 (a0, a1) and 8 + 2 tig..+1 (a2, a3), the lower column in the
// lower half: so two 8-column tiles of an accumulator, rounded to bf16,
// are the A operand of the next product.
//
// Users: the bf16 path of flash_attention.cu.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro {
namespace mma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; lands at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two fp32 rounded to bf16 (nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ wgmma
// A shared-memory matrix descriptor; lbo and sbo in bytes; swizzled: the
// 128-byte swizzle (layout type 1), else none (interleave, type 0).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              bool swizzled) {
  return (uint64_t)((smem_u32(p) & 0x3ffff) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzled << 62);
}

// Order register and shared-memory writes before the next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by this thread's ordinary stores or cp.async,
// made visible to wgmma (the async proxy); a barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from touching an accumulator across a wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// The "+f" operands of an accumulator of N / 2 registers.
#define REPRO_ACC8(i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_ACC16 REPRO_ACC8(0), REPRO_ACC8(8)
#define REPRO_ACC32 REPRO_ACC16, REPRO_ACC8(16), REPRO_ACC8(24)
#define REPRO_ACC64 REPRO_ACC32, REPRO_ACC8(32), REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)

// d (64 x 64, fp32) (+)= a b: a 64 x 16 and b 16 x 64 bf16 from shared memory,
// both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x N, fp32) += a b: a 64 x 16 bf16 in registers, b 16 x N bf16 from
// shared memory, MN-major (N contiguous).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : REPRO_ACC16
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      " %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      " %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : REPRO_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef REPRO_ACC64
#undef REPRO_ACC32
#undef REPRO_ACC16
#undef REPRO_ACC8

}  // namespace mma
}  // namespace repro
