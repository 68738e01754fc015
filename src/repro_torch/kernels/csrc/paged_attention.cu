// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against that sequence's run of blocks in a shared paged KV pool.
//
//   q        (B, H, hd)              contiguous
//   k_pool   (NB, bs, KV, hd)        contiguous; v_pool alike
//   tables   (B, MAXB) int32         block ids, padded with 0 (the dummy block)
//   ctx_len  (B) int32               valid tokens per sequence, >= 1
//   out      (B, H, hd)              in q's type
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py::
// paged_attention.  Bound by bytes: each valid token's K and V rows are read
// once and used for about one multiply-add per byte and head.
//
// Design: the dense decode kernel's walk (decode_attention.cu, the same
// decode_tile.cuh::ring_walk) with another row map.  One block per
// (sequence, kv head, chunk of at most 8 of the group's G query heads) walks
// the sequence's first n = min(ctx_len, MAXB * bs) positions in tiles.  Row
// p lives in pool block tables[b, p / bs], slot p % bs, at
// (blk * bs + p % bs) * KV * hd + kvh * hd in the pool's native layout, so a
// row's hd values are one contiguous run and no copy of the pool is made.
// Each row's block id arrives by 4-byte cp.async one ring ahead of its K and
// V rows (a table entry is read from memory once and from L1 by the other
// rows of its block); the rows themselves are staged in their stored type
// with 16-byte cp.async into a ring of kStages, the next two tiles in flight
// while one is folded.  Positions at or past n get no id and are never
// fetched, so stale values in a reused block, inf and NaN included, never
// reach the result.  The queries, the softmax state and the accumulators stay
// in registers (decode_tile.cuh), so each staged element crosses shared
// memory once per block, whatever G is.  All arithmetic is fp32 (no TF32).
// The keys are not split over blocks (a split lost at every shape a caller
// of the dense kernel makes; PERF.md, section 6).
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "decode_tile.cuh"

namespace repro {

using dtile::kThreads;

// Row p of a sequence is slot p % bs of pool block table[p / bs].
struct PagedRows {
  const int* table;   // this sequence's row of tables
  int bs;
  size_t row_stride;  // elements between slots of the pool
  __device__ const int* id(int p) const { return table + p / bs; }
  __device__ size_t at(int p, int blk) const {
    return ((size_t)blk * bs + (size_t)(p % bs)) * row_stride;
  }
};

// 3 blocks an SM up to 4 heads a block, 2 for 8 (as the dense kernel)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, GC <= 4 ? 3 : 2)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ ctx_len, T* __restrict__ out, int n_heads,
                       int n_kv, int bs, int maxb, float scale) {
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

  const int n_ctx = min(ctx_len[b], maxb * bs);
  const size_t row_stride = (size_t)n_kv * HD;
  dtile::GroupState<T, HD, GC> st;
  dtile::ring_walk(st, smem, k_pool + (size_t)kvh * HD, v_pool + (size_t)kvh * HD, n_ctx,
                   PagedRows{tables + (size_t)b * maxb, bs, row_stride},
                   q + ((size_t)b * n_heads + head0) * HD, n_here, scale, gi, lane);

  T* o = out + ((size_t)b * n_heads + head0) * HD;
  st.block_combine(reinterpret_cast<float*>(smem), gi, lane, [&](int h, int d, float a, float l) {
    if (h < n_here) from_float(o + h * HD + d, a / fmaxf(l, 1e-30f));
  });
}

template <typename T, int HD, int GC>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* ctx_len, void* out, int n_rows, int n_heads, int n_kv, int bs, int maxb,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = dtile::ring_smem_bytes<T, HD, GC>();
  if (smem > dtile::kMaxSmem) return -2;
  auto kernel = paged_attention_kernel<T, HD, GC>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int g = n_heads / n_kv;
  const long long blocks = (long long)n_rows * n_kv * ((g + GC - 1) / GC);
  if (blocks > 0x7fffffffLL) return -2;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, ctx_len, static_cast<T*>(out), n_heads, n_kv, bs, maxb, scale);
  return (int)cudaGetLastError();
}

// GC, the query heads a block holds: 1, 4 (G 2 to 4, spare heads masked) or
// 8 (larger groups take several blocks of 8).
template <typename T, int HD>
int dispatch_gc(const void* q, const void* k_pool, const void* v_pool, const int* tables,
                const int* ctx_len, void* out, int n_rows, int n_heads, int n_kv, int bs,
                int maxb, float scale, cudaStream_t stream) {
  const int g = n_heads / n_kv;
#define REPRO_GC_CASE(N)                                                                      \
  return launch<T, HD, N>(q, k_pool, v_pool, tables, ctx_len, out, n_rows, n_heads, n_kv, bs, \
                          maxb, scale, stream)
  if (g <= 1) REPRO_GC_CASE(1);
  if (g <= 4) REPRO_GC_CASE(4);
  REPRO_GC_CASE(8);
#undef REPRO_GC_CASE
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_pool, const void* v_pool, const int* tables,
                const int* ctx_len, void* out, int n_rows, int n_heads, int n_kv, int bs, int maxb,
                float scale, cudaStream_t stream) {
#define REPRO_HD_CASE(N)                                                                        \
  case N:                                                                                       \
    return dispatch_gc<T, N>(q, k_pool, v_pool, tables, ctx_len, out, n_rows, n_heads, n_kv, bs, \
                             maxb, scale, stream)
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
extern "C" int paged_attention_launch(const void* q, const void* k_pool, const void* v_pool,
                                      const void* tables, const void* ctx_len, void* out,
                                      int n_rows, int n_heads, int n_kv, int hd, int bs, int maxb,
                                      int dtype, float scale, void* stream) {
  if (n_rows <= 0) return 0;
  const int* tb = static_cast<const int*>(tables);
  const int* cl = static_cast<const int*>(ctx_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_hd<float>(hd, q, k_pool, v_pool, tb, cl, out, n_rows, n_heads, n_kv,
                                     bs, maxb, scale, s);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(hd, q, k_pool, v_pool, tb, cl, out, n_rows, n_heads,
                                             n_kv, bs, maxb, scale, s);
  return -1;
}
