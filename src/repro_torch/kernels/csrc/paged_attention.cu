// Paged decode attention for Hopper (sm_90a): one query token per sequence
// against that sequence's run of blocks in a shared paged KV pool.
//
//   q        (B, H, hd)              contiguous
//   k_pool   (NB, bs, KV, hd)        contiguous; v_pool alike
//   tables   (B, MAXB) int32         block ids, padded with 0 (the dummy block)
//   ctx_len  (B) int32               valid tokens per sequence, >= 1
//   out      (B, H, hd)              in q's type
//
// One thread block per (sequence, kv head).  The block reads its own table
// row and walks only the ceil(ctx_len / bs) live table slots, in tiles of
// TILE tokens; a token at position p lives in block tables[b, p / bs], slot
// p % bs, and its hd values for one kv head are contiguous in the pool's
// native layout, so a row is fetched with 16-byte loads and no transpose of
// the pool is ever made.  Tokens at positions >= ctx_len are never loaded:
// their rows are zero-filled in shared memory and their weight is exactly 0,
// so stale values in a reused block cannot reach the result.  The G = H / KV
// query heads of the group share each staged tile.  All arithmetic is fp32.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace repro {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ tables,
                       const int* __restrict__ ctx_len, T* __restrict__ out,
                       int n_heads, int n_kv, int bs, int maxb, float scale) {
  constexpr int TILE = TileCfg<HD>::TILE;
  constexpr int LD = TileCfg<HD>::LD;
  constexpr int VN = Vec16<T>::N;   // elements per 16-byte load
  constexpr int VPR = HD / VN;      // 16-byte loads per token row

  extern __shared__ float smem[];
  const int g = n_heads / n_kv;
  const int b = blockIdx.x / n_kv;
  const int kvh = blockIdx.x - b * n_kv;
  const int tid = threadIdx.x;

  float* k_s = smem;
  float* v_s = k_s + TILE * LD;
  int* valid_s = reinterpret_cast<int*>(v_s + TILE * LD);
  AttnState st = attn_state_carve<HD>(reinterpret_cast<float*>(valid_s + TILE), g);

  attn_state_init<HD>(st, g);
  const T* q_row = q + ((size_t)b * n_heads + (size_t)kvh * g) * HD;
  for (int i = tid; i < g * HD; i += kThreads) st.q[i] = to_float(q_row[i]) * scale;

  const int* table = tables + (size_t)b * maxb;
  const int n_ctx = min(ctx_len[b], maxb * bs);
  const size_t slot_stride = (size_t)n_kv * HD;
  const size_t head_off = (size_t)kvh * HD;
  __syncthreads();

  for (int t0 = 0; t0 < n_ctx; t0 += TILE) {
    // stage the tile: one 16-byte load of K and one of V per (token, chunk)
    for (int i = tid; i < TILE * VPR; i += kThreads) {
      const int t = i / VPR, c = i - t * VPR;
      const int pos = t0 + t;
      float kf[VN], vf[VN];
      if (pos < n_ctx) {
        const int blk = table[pos / bs];
        const size_t off =
            ((size_t)blk * bs + (size_t)(pos % bs)) * slot_stride + head_off + (size_t)c * VN;
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(k_pool + off), kf);
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(v_pool + off), vf);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) {
        k_s[t * LD + c * VN + j] = kf[j];
        v_s[t * LD + c * VN + j] = vf[j];
      }
    }
    for (int t = tid; t < TILE; t += kThreads) valid_s[t] = (t0 + t < n_ctx) ? 1 : 0;
    __syncthreads();
    attn_tile_update<HD>(st, k_s, v_s, valid_s, g);
  }

  T* out_row = out + ((size_t)b * n_heads + (size_t)kvh * g) * HD;
  attn_finish<HD>(st, g, [&](int idx, float x) { from_float(out_row + idx, x); });
}

template <int HD>
size_t smem_bytes(int g) {
  return sizeof(float) * (2 * TileCfg<HD>::TILE * TileCfg<HD>::LD + attn_state_floats<HD>(g)) +
         sizeof(int) * TileCfg<HD>::TILE;
}

template <typename T, int HD>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* ctx_len, void* out, int n_rows, int n_heads, int n_kv, int bs, int maxb,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(n_heads / n_kv);
  if (smem > kMaxSmem) return -2;
  auto kernel = paged_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_rows * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
      tables, ctx_len, static_cast<T*>(out), n_heads, n_kv, bs, maxb, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_pool, const void* v_pool, const int* tables,
                const int* ctx_len, void* out, int n_rows, int n_heads, int n_kv, int bs, int maxb,
                float scale, cudaStream_t stream) {
#define REPRO_HD_CASE(N)                                                                      \
  case N:                                                                                     \
    return launch<T, N>(q, k_pool, v_pool, tables, ctx_len, out, n_rows, n_heads, n_kv, bs,   \
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
// the launch was refused, -1 for an unsupported head_dim or dtype, -2 when the
// query group needs more shared memory than a block may have.
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
