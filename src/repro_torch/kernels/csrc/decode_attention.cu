// Dense ring-cache decode attention for Hopper (sm_90a): one query token per
// sequence against that sequence's dense KV cache.
//
//   q        (B, H, hd)              contiguous
//   k_cache  (B, S, KV, hd)          contiguous; v_cache alike
//   pos      (S) int32               absolute position of each slot, -1 = empty
//   out      (B, H, hd)              in q's type
//
// One thread block per (sequence, kv head), holding the G = H / KV query
// heads of the group.  The block walks the S slots in tiles of TILE tokens;
// a slot's hd values for one kv head are contiguous at
// ((b * S + s) * KV + kv) * hd, so each row is fetched with 16-byte loads in
// the cache's native layout (the TPU wrapper transposed both caches on every
// call).  A slot takes part where pos[s] >= 0; the K and V rows of an empty
// slot are never loaded (zero-filled in shared memory, weight exactly 0), so
// a row whose slots are all empty gives 0, as the reference does.  The tile
// update, the running (m, l, acc) state and the finish are attn_tile.cuh's,
// shared with the paged decode kernel.  All arithmetic is fp32.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace repro {

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                        const T* __restrict__ v_cache, const int* __restrict__ pos,
                        T* __restrict__ out, int n_heads, int n_kv, int n_slots, float scale) {
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

  const size_t slot_stride = (size_t)n_kv * HD;
  const T* k_seq = k_cache + (size_t)b * n_slots * slot_stride + (size_t)kvh * HD;
  const T* v_seq = v_cache + (size_t)b * n_slots * slot_stride + (size_t)kvh * HD;
  __syncthreads();

  for (int s0 = 0; s0 < n_slots; s0 += TILE) {
    for (int t = tid; t < TILE; t += kThreads) {
      const int s = s0 + t;
      valid_s[t] = (s < n_slots && pos[s] >= 0) ? 1 : 0;
    }
    __syncthreads();
    // stage the tile: one 16-byte load of K and one of V per (slot, chunk)
    for (int i = tid; i < TILE * VPR; i += kThreads) {
      const int t = i / VPR, c = i - t * VPR;
      float kf[VN], vf[VN];
      if (valid_s[t]) {
        const size_t off = (size_t)(s0 + t) * slot_stride + (size_t)c * VN;
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(k_seq + off), kf);
        Vec16<T>::unpack(*reinterpret_cast<const uint4*>(v_seq + off), vf);
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
int launch(const void* q, const void* k_cache, const void* v_cache, const int* pos, void* out,
           int n_rows, int n_heads, int n_kv, int n_slots, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(n_heads / n_kv);
  if (smem > kMaxSmem) return -2;
  auto kernel = decode_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_rows * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      pos, static_cast<T*>(out), n_heads, n_kv, n_slots, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k_cache, const void* v_cache, const int* pos,
                void* out, int n_rows, int n_heads, int n_kv, int n_slots, float scale,
                cudaStream_t stream) {
#define REPRO_HD_CASE(N)                                                                     \
  case N:                                                                                    \
    return launch<T, N>(q, k_cache, v_cache, pos, out, n_rows, n_heads, n_kv, n_slots, scale, \
                        stream)
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
