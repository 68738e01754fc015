// Prefill ("flash") attention for Hopper (sm_90a): streaming softmax over
// key tiles, grouped-query heads, causal and sliding-window masks on absolute
// positions, and a query offset for keys prepended from a cached prefix.
//
//   q    (B, H, Sq, hd)     contiguous; query row i sits at position q_offset + i
//   k, v (B, KV, Sk, hd)    contiguous; key j sits at position j
//   out  (B, H, Sq, hd)     in q's type
//
// A key j is live for the query at position r where j < Sk, and j <= r when
// causal, and j > r - window when a window is set.
//
// One thread block per (b * H + h, tile of kQTile query rows); the block reads
// kv head h / (H / KV) directly, so K and V are never copied per query head.
// The block stages its query tile in shared memory once, multiplied by the
// softmax scale in fp32, then walks the key range that tile can see in tiles
// of TK keys: from max(0, q_offset + first row - window + 1) when a window is
// set, to min(Sk, q_offset + last row + 1) when causal (the loop bounds do
// what the TPU kernel's pl.when(live) did).  Keys at or beyond Sk are never
// loaded.  Each of the 128 threads owns 4 query rows (ty + 16 i) and every
// 8th column (tx + 8 j) of the score tile and of the output, so the row
// maximum and sum of a tile are a shuffle over the 8 threads of a row group.
// Masked scores are -1e30 and get weight exactly 0; the state (m, l, acc) is
// fp32 in registers; the output is acc / max(l, 1e-30).
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "attn_tile.cuh"

namespace repro {

constexpr int kQTile = 64;  // query rows per block

template <int HD>
struct FlashCfg {
  static constexpr int TK = HD <= 64 ? 64 : 32;  // keys per tile
  static constexpr int LD = HD + 1;              // padded q/k/v row, in floats
  static constexpr int LP = TK + 1;              // padded weight row, in floats
  static constexpr int RPT = kQTile / 16;        // query rows per thread
  static constexpr int SPT = TK / 8;             // score columns per thread
  static constexpr int OPT = HD / 8;             // output columns per thread
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)kQTile * LD + 2 * (size_t)TK * LD + (size_t)kQTile * LP);
};

// dst (n, HD + 1) fp32 <- rows row0 .. row0 + n - 1 of src (rows of HD
// values), times mul; rows at or beyond row_end are zero and never loaded.
template <typename T, int HD>
__device__ inline void stage_rows(float* dst, const T* __restrict__ src, int row0, int n,
                                  int row_end, float mul) {
  constexpr int VN = Vec16<T>::N;
  constexpr int VPR = HD / VN;
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < n * VPR; i += kThreads) {
    const int r = i / VPR, c = i - r * VPR;
    float f[VN];
    if (row0 + r < row_end) {
      Vec16<T>::unpack(
          *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + (size_t)c * VN), f);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * LD + c * VN + j] = f[j] * mul;
  }
}

__device__ inline float group8_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float group8_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n_heads, int n_kv,
                       int sq, int sk, int causal, int window, int q_offset, float scale) {
  using C = FlashCfg<HD>;
  constexpr int TK = C::TK, LD = C::LD, LP = C::LP;
  constexpr int RPT = C::RPT, SPT = C::SPT, OPT = C::OPT;

  extern __shared__ float smem[];
  float* q_s = smem;                // (kQTile, LD) scaled queries
  float* k_s = q_s + kQTile * LD;   // (TK, LD)
  float* v_s = k_s + TK * LD;       // (TK, LD)
  float* p_s = v_s + TK * LD;       // (kQTile, LP) weights of the current tile

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = blockIdx.y * kQTile;
  const int q_end = min(q0 + kQTile, sq);
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  const T* q_bh = q + (size_t)bh * sq * HD;
  const T* k_bh = k + ((size_t)b * n_kv + kvh) * sk * HD;
  const T* v_bh = v + ((size_t)b * n_kv + kvh) * sk * HD;

  // the keys this query tile can see
  const int hi = causal ? min(sk, q_offset + q_end) : sk;
  const int lo = window ? max(0, q_offset + q0 - window + 1) : 0;

  stage_rows<T, HD>(q_s, q_bh, q0, kQTile, sq, scale);

  float m[RPT], l[RPT], o[RPT][OPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OPT; ++j) o[i][j] = 0.f;
  }

  for (int k0 = lo; k0 < hi; k0 += TK) {
    __syncthreads();  // the last tile's k_s, v_s and p_s are no longer read
    stage_rows<T, HD>(k_s, k_bh, k0, TK, hi, 1.f);
    stage_rows<T, HD>(v_s, v_bh, k0, TK, hi, 1.f);
    __syncthreads();

    // scores of this thread's rows and columns
    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RPT], kv[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < SPT; ++j) kv[j] = k_s[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then fold the tile into each row's running state
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = q_offset + q0 + ty + 16 * i;  // absolute query position
      bool live[SPT];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int c = k0 + tx + 8 * j;
        live[j] = c < sk && (!causal || c <= r) && (!window || c > r - window);
        if (!live[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_cur = fmaxf(m[i], group8_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float p = live[j] ? expf(s[i][j] - m_cur) : 0.f;
        p_s[(ty + 16 * i) * LP + tx + 8 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_cur);
      l[i] = l[i] * alpha + group8_sum(sum);
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < OPT; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

    // acc += p @ v
#pragma unroll 4
    for (int t = 0; t < TK; ++t) {
      float pv[RPT], vv[OPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(ty + 16 * i) * LP + t];
#pragma unroll
      for (int j = 0; j < OPT; ++j) vv[j] = v_s[t * LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < OPT; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

  T* out_bh = out + (size_t)bh * sq * HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < OPT; ++j)
      from_float(out_bh + (size_t)row * HD + tx + 8 * j, o[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int n_batch, int n_heads,
           int n_kv, int sq, int sk, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = FlashCfg<HD>::SMEM;
  static_assert(smem <= kMaxSmem, "tile does not fit one block's shared memory");
  auto kernel = flash_attention_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_bh = (long long)n_batch * n_heads;
  const int n_qt = (sq + kQTile - 1) / kQTile;
  if (n_bh > 0x7fffffffLL || n_qt > 65535) return -3;
  dim3 grid((unsigned)n_bh, (unsigned)n_qt);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out),
                                           n_heads, n_kv, sq, sk, causal, window, q_offset,
                                           scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* out, int n_batch,
                int n_heads, int n_kv, int sq, int sk, int causal, int window, int q_offset,
                float scale, cudaStream_t stream) {
#define REPRO_HD_CASE(N)                                                                     \
  case N:                                                                                    \
    return launch<T, N>(q, k, v, out, n_batch, n_heads, n_kv, sq, sk, causal, window,        \
                        q_offset, scale, stream)
  switch (hd) {
    REPRO_HD_CASE(32);
    REPRO_HD_CASE(64);
    REPRO_HD_CASE(128);
    default:
      return -1;
  }
#undef REPRO_HD_CASE
}

}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1; window: 0 for none.
// Returns 0 on success, a cudaError_t when the launch was refused, -1 for an
// unsupported head_dim or dtype, -3 when the grid would be too large.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int n_batch, int n_heads, int n_kv, int hd, int sq,
                                      int sk, int causal, int window, int q_offset, int dtype,
                                      float scale, void* stream) {
  if (n_batch <= 0 || sq <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::dispatch_hd<float>(hd, q, k, v, out, n_batch, n_heads, n_kv, sq, sk, causal,
                                     window, q_offset, scale, s);
  if (dtype == 1)
    return repro::dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, n_batch, n_heads, n_kv, sq, sk,
                                             causal, window, q_offset, scale, s);
  return -1;
}
