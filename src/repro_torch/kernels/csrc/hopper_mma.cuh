// Tensor-core and asynchronous-copy building blocks for Hopper (sm_90a),
// written as inline PTX: 4- and 16-byte cp.async copies and TMA boxes into
// shared memory with mbarriers, ldmatrix / stmatrix, named barriers, and the
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
// ldmatrix loads 8 x 8 matrices of 16-bit values from shared memory: lane l
// gives the address of row l % 8 of matrix l / 8 (16 bytes); with .trans a
// lane gets (rows 2 tig..+1, column gid) of each, so four matrices of a
// row-major (k, m) tile make the register A operand above of its transpose.
//
// Users: the bf16 paths of flash_attention.cu and mlstm_scan.cu (wgmma), and
// the decode kernels' rings (decode_tile.cuh) and ssm_scan.cu's staging
// (cp.async).
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

// 4 bytes global -> shared through L1; lands at cp_async_wait.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
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

// ------------------------------------------------- ldmatrix, stmatrix, barriers
// Four 8 x 8 matrices of 16-bit values from shared memory, each transposed.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Four 8 x 8 matrices of 16-bit values to shared memory, from the fragments
// ldmatrix without .trans gives (lane l holds row l / 4, columns 2 (l % 4)..+1
// of each, as in an accumulator's pairs); lane l gives the address of row
// l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4(void* p, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_u32(p)),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Named barrier id over n threads: wait for all, or only count this thread.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------- TMA, mbarrier
// An mbarrier in shared memory that completes a phase once `count` threads
// have arrived and the bytes they announced have landed.
__device__ __forceinline__ void mbar_init(void* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Make mbarrier inits visible to the other threads and to the copy engine;
// a barrier follows.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and announce `bytes` of copies that complete on this phase.
__device__ __forceinline__ void mbar_arrive_tx(void* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(void* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of the given parity to complete; a copy that never
// lands traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(void* bar, int parity) {
  for (long long n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n > (1ll << 24)) __trap();
}

// One box of a 3-D tensor map (TMA) into shared memory at dst, element
// coordinates (c0, c1, c2), completing on bar.  Out-of-range elements land
// as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            void* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
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

#define REPRO_ACC96 REPRO_ACC64, REPRO_ACC8(64), REPRO_ACC8(72), REPRO_ACC8(80), REPRO_ACC8(88)

// d (64 x 192, fp32) (+)= a b: a 64 x 16 and b 16 x 192 bf16 from shared
// memory, both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n192(float (&d)[96], uint64_t a, uint64_t b,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC96
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

#undef REPRO_ACC96
#undef REPRO_ACC64
#undef REPRO_ACC32
#undef REPRO_ACC16
#undef REPRO_ACC8

}  // namespace mma
}  // namespace repro
