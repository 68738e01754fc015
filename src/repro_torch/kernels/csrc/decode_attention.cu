// Dense ring-cache decode attention for Hopper (sm_90a): one query token per
// sequence against that sequence's dense KV cache.
//
//   q        (B, H, hd)              contiguous
//   k_cache  (B, S, KV, hd)          contiguous; v_cache alike
//   pos      (S) int32               absolute position of each slot, -1 = empty
//   out      (B, H, hd)              in q's type
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py::
// decode_attention.  Bound by bytes: each K and V row of an occupied slot is
// read once and used for about one multiply-add per byte and head.
//
// Design.  One block per (sequence, kv head, chunk of at most 8 of the
// group's G query heads) walks all of the sequence's slots in tiles
// (decode_tile.cuh::tile_rows) and writes its heads' output.  A block stages
// its tiles in their stored type with 16-byte cp.async into a ring of
// kStages (decode_tile.cuh::ring_walk, the paged kernel's loop too): the
// next two tiles are in flight while one is folded.  A tile's
// pos values arrive by 4-byte cp.async one ring ahead of its rows, so the
// rows of empty slots (pos < 0) are never loaded and a tile's pos is read
// from memory once.  The fold keeps the queries, the softmax state and the
// accumulators in registers (decode_tile.cuh): each staged K and V element
// crosses shared memory once per block, whatever G is.  A row with no
// occupied slot gives exactly 0.  All arithmetic is fp32 (no TF32).
//
// The keys are not split over blocks: at the shapes the port times (B 32
// over 8 or 32 kv heads, 256 or 1024 blocks) one block a row beat every
// split on the H100 (PERF.md, section 5).
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it
// is given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace repro {

using dtile::kThreads;

// Row p of a sequence is slot p of its cache; empty where pos[p] < 0.
struct DenseRows {
  const int* pos;
  size_t row_stride;  // elements between slots
  __device__ const int* id(int p) const { return pos + p; }
  __device__ size_t at(int p, int) const { return (size_t)p * row_stride; }
};

// 3 blocks an SM (170 registers a thread) up to 4 heads a block, 2 for 8
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, GC <= 4 ? 3 : 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, const int* __restrict__ pos,
                        T* __restrict__ out, int n_heads, int n_kv, int n_slots, float scale) {
  using C = dtile::Cfg<T, HD, GC>;
  extern __shared__ __align__(16) unsigned char smem[];

  const int g = n_heads / n_kv;
  const int n_hc = (g + GC - 1) / GC;
  int bid = blockIdx.x;
  const int hc = bid % n_hc;
  bid /= n_hc;
  const int kvh = bid % n_kv;
  const int b = bid / n_kv;
  const int head0 = kvh * g + hc * GC;  // this block's first query head
  const int n_here = min(GC, g - hc * GC);
  const int gi = threadIdx.x / C::L, lane = threadIdx.x % C::L;

  const size_t row_stride = (size_t)n_kv * HD;
  const size_t seq_off = (size_t)b * n_slots * row_stride + (size_t)kvh * HD;
  dtile::GroupState<T, HD, GC> st;
  dtile::ring_walk(st, smem, k_cache + seq_off, v_cache + seq_off, n_slots,
                   DenseRows{pos, row_stride}, q + ((size_t)b * n_heads + head0) * HD, n_here,
                   scale, gi, lane);

  T* o = out + ((size_t)b * n_heads + head0) * HD;
  st.block_combine(reinterpret_cast<float*>(smem), gi, lane, [&](int h, int d, float a, float l) {
    if (h < n_here) from_float(o + h * HD + d, a / fmaxf(l, 1e-30f));
  });
}

template <typename T, int HD, int GC>
int launch(const void* q, const void* k_cache, const void* v_cache, const int* pos, void* out,
           int n_rows, int n_heads, int n_kv, int n_slots, float scale, cudaStream_t stream) {
  constexpr size_t smem = dtile::ring_smem_bytes<T, HD, GC>();
  if (smem > dtile::kMaxSmem) return -2;
  auto kernel = decode_attention_kernel<T, HD, GC>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int g = n_heads / n_kv;
  const long long blocks = (long long)n_rows * n_kv * ((g + GC - 1) / GC);
  if (blocks > 0x7fffffffLL) return -2;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      pos, static_cast<T*>(out), n_heads, n_kv, n_slots, scale);
  return (int)cudaGetLastError();
}

// GC, the query heads a block holds: 1, 4 (G 2 to 4, spare heads masked) or
// 8 (larger groups take several blocks of 8).
template <typename T, int HD>
int dispatch_gc(const void* q, const void* k_cache, const void* v_cache, const int* pos,
                void* out, int n_rows, int n_heads, int n_kv, int n_slots, float scale,
                cudaStream_t stream) {
  const int g = n_heads / n_kv;
#define REPRO_GC_CASE(N) \
  return launch<T, HD, N>(q, k_cache, v_cache, pos, out, n_rows, n_heads, n_kv, n_slots, scale, stream)
  if (g <= 1) REPRO_GC_CASE(1);
  if (g <= 4) REPRO_GC_CASE(4);
  REPRO_GC_CASE(8);
#undef REPRO_GC_CASE
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_cache, const void* v_cache, const int* pos,
                void* out, int n_rows, int n_heads, int n_kv, int n_slots, float scale,
                cudaStream_t stream) {
#define REPRO_HD_CASE(N)                                                                  \
  case N:                                                                                 \
    return dispatch_gc<T, N>(q, k_cache, v_cache, pos, out, n_rows, n_heads, n_kv, n_slots, \
                             scale, stream)
  switch (hd) {
    REPRO_HD_CASE(8);
    REPRO_HD_CASE(16);
    REPRO_HD_CASE(32);
    REPRO_HD_CASE(64);
    REPRO_HD_CASE(128);
    default:
      return -1;
  }
#undef REPRO_HD_CASE
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t when
// the launch was refused, -1 for an unsupported head_dim or dtype, -2 for a
// grid or shared-memory size out of range.
extern "C" int decode_attention_launch(const void* q, const void* k_cache, const void* v_cache,
                                       const void* pos, void* out, int n_rows, int n_heads,
                                       int n_kv, int hd, int n_slots, int dtype, float scale,
                                       void* stream) {
  if (n_rows <= 0) return 0;
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_hd<float>(hd, q, k_cache, v_cache, ps, out, n_rows, n_heads, n_kv,
                                     n_slots, scale, s);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, ps, out, n_rows, n_heads,
                                             n_kv, n_slots, scale, s);
  return -1;
}
