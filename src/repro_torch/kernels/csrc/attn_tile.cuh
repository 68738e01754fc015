// Per-tile online-softmax attention update for single-query ("decode")
// attention kernels.
//
// One thread block owns one (sequence, kv head) pair and walks that
// sequence's keys in tiles of TILE tokens.  The caller stages a tile's K and
// V rows in shared memory as fp32 (rows padded to HD + 1 floats so that a
// warp reading one column of 32 rows hits 32 banks) together with a per-token
// validity flag, then calls attn_tile_update().  The G query heads that share
// the kv head all reuse the staged tile: it is loaded once and used G times.
// The running (m, l, acc) state of every head lives in shared memory in fp32.
//
// Users: the paged decode kernel (paged_attention.cu) and the dense
// ring-cache decode kernel (decode_attention.cu), which differ only in how
// they stage a tile and which tokens they flag valid.  The prefill kernel
// (flash_attention.cu) shares the loads and constants below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;  // bytes one block may use on sm_90

// 16-byte global loads unpacked to fp32, and fp32 stores in the output type.
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

template <int HD>
struct TileCfg {
  static constexpr int TILE = HD <= 64 ? 64 : 32;  // tokens per tile
  static constexpr int LD = HD + 1;                // padded row, in floats
};

// Shared-memory state of one (sequence, kv head): G query heads.
struct AttnState {
  float* q;      // (G, HD) queries, already multiplied by the softmax scale
  float* acc;    // (G, HD) running weighted sum of V
  float* s;      // (G, TILE) scores, then softmax weights, of the current tile
  float* m;      // (G) running maximum
  float* l;      // (G) running sum of weights
  float* alpha;  // (G) rescale factor of the current tile
};

template <int HD>
__host__ __device__ inline size_t attn_state_floats(int g) {
  return (size_t)g * (2 * HD + TileCfg<HD>::TILE + 3);
}

template <int HD>
__device__ inline AttnState attn_state_carve(float* base, int g) {
  AttnState st;
  st.q = base;
  st.acc = st.q + (size_t)g * HD;
  st.s = st.acc + (size_t)g * HD;
  st.m = st.s + (size_t)g * TileCfg<HD>::TILE;
  st.l = st.m + g;
  st.alpha = st.l + g;
  return st;
}

// Zero acc and l, set m to -1e30.  The caller fills st.q and synchronises.
template <int HD>
__device__ inline void attn_state_init(const AttnState& st, int g) {
  for (int i = threadIdx.x; i < g * HD; i += kThreads) st.acc[i] = 0.f;
  for (int i = threadIdx.x; i < g; i += kThreads) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Fold one staged tile into the running state.
//   k_s, v_s : (TILE, LD) fp32; rows of invalid tokens in v_s must be zero
//   valid_s  : (TILE) 1 where the token takes part, 0 where it does not
// An invalid token gets weight exactly 0, whatever lies in its K row.
// Must be called by all kThreads threads; ends with a __syncthreads(), so the
// caller may overwrite k_s, v_s and valid_s right after it returns.
template <int HD>
__device__ inline void attn_tile_update(const AttnState& st, const float* k_s,
                                        const float* v_s, const int* valid_s,
                                        int g) {
  constexpr int TILE = TileCfg<HD>::TILE;
  constexpr int LD = TileCfg<HD>::LD;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  // 1. scores s[h, t] = q[h] . k[t]
  for (int idx = tid; idx < g * TILE; idx += kThreads) {
    const int h = idx / TILE, t = idx - h * TILE;
    float sum = kNegInf;
    if (valid_s[t]) {
      const float* qh = st.q + (size_t)h * HD;
      const float* kt = k_s + (size_t)t * LD;
      sum = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) sum = fmaf(qh[d], kt[d], sum);
    }
    st.s[idx] = sum;
  }
  __syncthreads();

  // 2. online softmax, one warp per head
  for (int h = warp; h < g; h += kWarps) {
    float* sh = st.s + (size_t)h * TILE;
    float mx = kNegInf;
    for (int t = lane; t < TILE; t += 32) mx = fmaxf(mx, sh[t]);
    mx = warp_max(mx);
    const float m_prev = __shfl_sync(0xffffffffu, lane == 0 ? st.m[h] : 0.f, 0);
    const float m_cur = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < TILE; t += 32) {
      const float p = valid_s[t] ? expf(sh[t] - m_cur) : 0.f;
      sh[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float a = expf(m_prev - m_cur);
      st.alpha[h] = a;
      st.l[h] = st.l[h] * a + sum;
      st.m[h] = m_cur;
    }
  }
  __syncthreads();

  // 3. acc[h, d] = acc[h, d] * alpha[h] + sum_t p[h, t] * v[t, d]
  for (int idx = tid; idx < g * HD; idx += kThreads) {
    const int h = idx / HD, d = idx - h * HD;
    const float* ph = st.s + (size_t)h * TILE;
    float a = st.acc[idx] * st.alpha[h];
#pragma unroll 8
    for (int t = 0; t < TILE; ++t) a = fmaf(ph[t], v_s[(size_t)t * LD + d], a);
    st.acc[idx] = a;
  }
  __syncthreads();
}

// out[h, d] = acc[h, d] / max(l[h], 1e-30), cast by the caller's store.
template <int HD, typename Store>
__device__ inline void attn_finish(const AttnState& st, int g, Store store) {
  for (int idx = threadIdx.x; idx < g * HD; idx += kThreads) {
    const int h = idx / HD;
    store(idx, st.acc[idx] / fmaxf(st.l[h], 1e-30f));
  }
}

}  // namespace repro
