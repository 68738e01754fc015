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
// One thread block per (b * H + h, tile of query rows: 64 in fp32, 128 in
// bf16); the block reads kv head h / (H / KV) directly, so K and V are never
// copied per query head.  It walks only the key range its tile can see, in
// tiles of TK keys: from max(0, q_offset + first row - window + 1) when a
// window is set, to min(Sk, q_offset + last row + 1) when causal (the loop
// bounds do what the TPU kernel's pl.when(live) did).  Keys at or beyond Sk
// are never loaded.  Masked scores get weight exactly 0; the state (m, l,
// acc) is fp32 in registers; the output is acc / max(l, 1e-30), so a row with
// no live key gives 0.
//
// bf16 inputs (flash_attention_wgmma_kernel) run on the tensor cores with
// wgmma (hopper_mma.cuh).  A block is two warpgroups over 128 query rows, 64
// each, that share every K and V tile; two blocks share an SM.  Q, K and V
// stay bf16 in shared memory, in the 128-byte swizzled layout wgmma reads
// without bank conflicts (core matrices without swizzle at hd 32), and K
// and V tiles of 64 keys are loaded with 16-byte cp.async into a ring of
// two stages: tile t + 1 is in flight while tile t is multiplied.
// S = Q K^T reads both operands from shared memory (m64n64k16, fp32
// accumulators); the online softmax (m, l and the rescale) stays in fp32
// registers; the weights are rounded to bf16 in registers and are the A
// operand of O += P V straight from the accumulators' layout (m64nHDk16,
// V MN-major), never passing through shared memory.  Only tiles that cut
// the diagonal, the window or Sk test the mask.  Query tiles start from the
// last, so the blocks with the most keys (causal) start first.
//
// fp32 inputs (flash_attention_kernel) keep scalar FMAs: TF32 tensor cores
// would not compute the same function.  Each of the 128 threads owns 4 query
// rows (ty + 16 i) and every 8th column (tx + 8 j) of the score tile and of
// the output, so the row maximum and sum of a tile are a shuffle over the 8
// threads of a row group.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <type_traits>

#include <cuda_runtime.h>

#include "attn_tile.cuh"
#include "hopper_mma.cuh"

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
  static_assert(SMEM <= kMaxSmem, "tile does not fit one block's shared memory");
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

using bf16 = __nv_bfloat16;

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int kWgWarps = 8;  // two warpgroups, 64 query rows each

template <int HD>
struct WgCfg {
  static constexpr int QT = 16 * kWgWarps;  // query rows per block
  static constexpr int TK = 64;             // keys per tile
  static constexpr int TILE_B = TK * HD * 2;  // bytes of a K or V tile
  // the 128-byte swizzle needs rows of 64 bf16 or more; hd 32 stays unswizzled
  static constexpr bool kSw = HD >= 64;
  // the query tile, then two stages each of K and V (+ room to align to 1 KB)
  static constexpr size_t SMEM = sizeof(bf16) * (size_t)HD * (QT + 4 * TK) + (kSw ? 1024 : 0);
  static_assert(SMEM <= kMaxSmem, "tiles do not fit one block's shared memory");
};

// Byte offset of 16-byte chunk c of row r in a tile of n rows.
//   swizzled (q, k and v alike): 64-column atoms of n rows x 128 bytes, the
//     chunks of row r permuted by r % 8 (CUTLASS's Swizzle<3,4,3>); 8-row
//     groups 1024 bytes apart, atoms n * 128 bytes apart
//   interleave K-major (q, k): core matrix (r / 8, c) at (r / 8 * HD / 8 + c) * 128
//   interleave MN-major (v, keys along K): core matrix (c, r / 8) at (c * n / 8 + r / 8) * 128
template <int HD, bool kSw, bool kMnMajor>
__device__ inline uint32_t chunk_at(int r, int c, int n) {
  if constexpr (kSw) return (c >> 3) * n * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  if constexpr (kMnMajor) return (c * (n / 8) + (r >> 3)) * 128 + (r & 7) * 16;
  return ((r >> 3) * (HD / 8) + c) * 128 + (r & 7) * 16;
}

// rows row0 .. row0 + n - 1 of src (rows of HD bf16) into the tile at dst
// with 16-byte cp.async; rows at or beyond row_end are zeroed and never read.
// 8 neighbouring threads fill one 128-byte row or core matrix.
template <int HD, bool kSw, bool kMnMajor>
__device__ inline void load_tile_async(unsigned char* dst, const bf16* __restrict__ src, int row0,
                                       int n, int row_end) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CPR; i += blockDim.x) {
    int r, c;
    if constexpr (kSw) {
      r = (i >> 3) % n;
      c = (i / (8 * n)) * 8 + (i & 7);
    } else {
      const int core = i >> 3;
      const int rg = kMnMajor ? core % (n / 8) : core / CPR;
      c = kMnMajor ? core / (n / 8) : core % CPR;
      r = rg * 8 + (i & 7);
    }
    unsigned char* d = dst + chunk_at<HD, kSw, kMnMajor>(r, c, n);
    if (row0 + r < row_end)
      mma::cp_async16(d, src + (size_t)(row0 + r) * HD + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Descriptor of k step ks (16 columns of hd) of the K-major rows [row0,
// row0 + 64) of a tile of n rows.
template <int HD, bool kSw>
__device__ inline uint64_t qk_desc(const unsigned char* tile, int n, int row0, int ks) {
  if constexpr (kSw)
    return mma::smem_desc(tile + (ks >> 2) * n * 128 + row0 * 128 + (ks & 3) * 32, 16, 1024,
                          true);
  return mma::smem_desc(tile + row0 * HD * 2 + ks * 256, 128, HD * 16, false);
}

// Descriptor of key step kk (16 keys) of the MN-major V tile of TK keys.
template <int HD, int TK, bool kSw>
__device__ inline uint64_t v_desc(const unsigned char* tile, int kk) {
  if constexpr (kSw) return mma::smem_desc(tile + kk * 2048, TK * 128, 1024, true);
  return mma::smem_desc(tile + kk * 256, 128, TK * 16, false);
}

// bf16 on the tensor cores with wgmma.  Warpgroup g owns query rows
// 64 g .. 64 g + 63 of the block's tile; lane (gid, tig) of warp w holds rows
// 16 w + gid and 16 w + gid + 8, and in each 8-column tile of the scores and
// of the output the columns 2 tig and 2 tig + 1.  Two blocks share an SM.
template <int HD>
__global__ void __launch_bounds__(32 * kWgWarps, 2)
flash_attention_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, bf16* __restrict__ out, int n_heads,
                             int n_kv, int sq, int sk, int causal, int window, int q_offset,
                             float scale_log2) {
  using C = WgCfg<HD>;
  constexpr int QT = C::QT, TK = C::TK, TILE_B = C::TILE_B, NT_S = TK / 8, NT_O = HD / 8;
  constexpr bool kSw = C::kSw;

  extern __shared__ __align__(128) unsigned char wg_smem[];
  unsigned char* q_s = wg_smem;  // (QT, HD), K-major
  if constexpr (kSw)             // swizzle atoms start on 1 KB
    q_s += (1024 - (mma::smem_u32(wg_smem) & 1023)) & 1023;
  unsigned char* k_s = q_s + QT * HD * 2;  // 2 x (TK, HD), K-major
  unsigned char* v_s = k_s + 2 * TILE_B;   // 2 x (TK, HD), MN-major

  const int bh = blockIdx.x;
  const int b = bh / n_heads, h = bh - b * n_heads;
  const int kvh = h / (n_heads / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QT;
  const int q_end = min(q0 + QT, sq);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  const bf16* q_bh = q + (size_t)bh * sq * HD;
  const bf16* k_bh = k + ((size_t)b * n_kv + kvh) * sk * HD;
  const bf16* v_bh = v + ((size_t)b * n_kv + kvh) * sk * HD;

  // the keys this query tile can see
  const int hi = causal ? min(sk, q_offset + q_end) : sk;
  const int lo = window ? max(0, q_offset + q0 - window + 1) : 0;
  const int n_tiles = hi > lo ? (hi - lo + TK - 1) / TK : 0;

  load_tile_async<HD, kSw, false>(q_s, q_bh, q0, QT, sq);
  const int q_row0 = (warp >> 2) * 64;  // this warpgroup's 64 rows
  if (n_tiles > 0) {
    load_tile_async<HD, kSw, false>(k_s, k_bh, lo, TK, hi);
    load_tile_async<HD, kSw, true>(v_s, v_bh, lo, TK, hi);
  }
  mma::cp_async_commit();

  const int r0 = q_offset + q0 + warp * 16 + gid, r1 = r0 + 8;  // this lane's rows
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = lo + t * TK;
    const unsigned char* kt = k_s + (t & 1) * TILE_B;
    const unsigned char* vt = v_s + (t & 1) * TILE_B;
    if (t + 1 < n_tiles) {  // the other stage was released by the last barrier
      load_tile_async<HD, kSw, false>(k_s + ((t + 1) & 1) * TILE_B, k_bh, k0 + TK, TK, hi);
      load_tile_async<HD, kSw, true>(v_s + ((t + 1) & 1) * TILE_B, v_bh, k0 + TK, TK, hi);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    mma::fence_proxy_async();
    __syncthreads();

    // s = q k^T, raw (unscaled), fp32: HD / 16 wgmma steps along hd
    float s[NT_S * 4];
    mma::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      mma::wgmma_ss_n64(s, qk_desc<HD, kSw>(q_s, QT, q_row0, ks), qk_desc<HD, kSw>(kt, TK, 0, ks),
                        ks > 0);
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(s);

    // a tile every row of the block sees whole needs no mask
    const bool whole = k0 + TK <= sk && (!causal || k0 + TK - 1 <= q_offset + q0) &&
                       (!window || k0 > q_offset + q_end - 1 - window);
    if (!whole) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + j * 8 + 2 * tig + (e & 1);
          const int r = e < 2 ? r0 : r1;
          const bool live = c < sk && (!causal || c <= r) && (!window || c > r - window);
          if (!live) s[4 * j + e] = __int_as_float(0xff800000);  // -inf: exp2 of it is 0
        }
    }

    // online softmax in fp32; m stays >= -1e30, so no inf - inf
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float alpha[2], mb[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * scale_log2);
      m[i] = mx[i];
      mb[i] = mx[i] * scale_log2;
    }
    // weights rounded to bf16 as the register A operand of P V: key slice
    // kk holds score tiles 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
    uint32_t pf[TK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      const float p0 = exp2f(fmaf(s[4 * j], scale_log2, -mb[0]));
      const float p1 = exp2f(fmaf(s[4 * j + 1], scale_log2, -mb[0]));
      const float p2 = exp2f(fmaf(s[4 * j + 2], scale_log2, -mb[1]));
      const float p3 = exp2f(fmaf(s[4 * j + 3], scale_log2, -mb[1]));
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = mma::pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = mma::pack_bf16(p2, p3);
    }
    // l is this lane's share of the row sum; the quad adds them at the end
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }

    // o += p v: TK / 16 wgmma steps along the keys
    mma::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk)
      mma::wgmma_rs<HD>(o, pf[kk], v_desc<HD, TK, kSw>(vt, kk));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
    mma::fence_regs(o);
    __syncthreads();  // this stage is free for tile t + 2
  }
  mma::cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

  bf16* out_bh = out + (size_t)bh * sq * HD;
  const int row0 = q0 + warp * 16 + gid;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int col = n * 8 + 2 * tig;
    if (row0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out_bh + (size_t)row0 * HD + col) =
          __floats2bfloat162_rn(o[4 * n] * inv[0], o[4 * n + 1] * inv[0]);
    if (row0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(out_bh + (size_t)(row0 + 8) * HD + col) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
  }
}

// bf16 goes to the tensor cores, fp32 to the scalar kernel.
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int n_batch, int n_heads,
           int n_kv, int sq, int sk, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, int, int, int, float);
  size_t smem;
  int rows, threads;
  if constexpr (std::is_same_v<T, bf16>) {
    kernel = flash_attention_wgmma_kernel<HD>;
    smem = WgCfg<HD>::SMEM;
    rows = WgCfg<HD>::QT;
    threads = 32 * kWgWarps;
    scale *= 1.4426950408889634f;  // the wgmma kernel exponentiates in base 2
  } else {
    kernel = flash_attention_kernel<T, HD>;
    smem = FlashCfg<HD>::SMEM;
    rows = kQTile;
    threads = kThreads;
  }
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_bh = (long long)n_batch * n_heads;
  const int n_qt = (sq + rows - 1) / rows;
  if (n_bh > 0x7fffffffLL || n_qt > 65535) return -3;
  dim3 grid((unsigned)n_bh, (unsigned)n_qt);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
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
