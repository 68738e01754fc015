// Stabilised mLSTM recurrence for Hopper (sm_90a): xLSTM's matrix memory.
//
//   q, k    (BH, S, DQK)   fp32 or bf16     v (BH, S, DV), same type
//   i_g, f_g (BH, S)       fp32
//   h       (BH, S, DV)    in q's type.  Per (sequence * head), with
//   q scaled by 1/sqrt(DQK) here and C = 0, n = 0, m = 0 at the start:
//     m'  = max(logsig(f) + m, i)
//     C   = e^{logsig(f)+m-m'} C + e^{i-m'} k v^T
//     n   = e^{logsig(f)+m-m'} n + e^{i-m'} k
//     h   = (C^T q) / max(|n . q|, e^{-m'})
//
// Replaces the Pallas kernel repro/kernels/mlstm_scan.py::mlstm_scan, which
// carried (C, n, m) in VMEM across a sequential grid of chunks and computed
// each chunk's h with matrix products.  At xLSTM's width one head's C is
// DQK 256 x DV 512 fp32 = 512 KB, more than a block can hold, so the work is
// cut into (sequence * head, tile of DV columns): each one's fp32 slice of C stays on
// chip for the whole sequence, and what does not depend on DV (the gates'
// running sums, S, n, the denominators) is recomputed for each tile.
//
// bf16 (mlstm_chunk_kernel): the Pallas kernel's chunkwise form, on the
// tensor cores.  The function does about 4 DQK DV operations a step and head
// against q, k, v, the gates and h moved once (some 170 a byte at xLSTM's
// width), so on this card it is bound by bytes, not by the tensor cores'
// rate; the per-step form it replaces (a barrier and 4 DQK DV / 256 scalar
// FMAs a thread every step) reached 0.017 of that bound.  An item is one
// (sequence * head, tile of kNV = 64 columns of DV); S is walked in chunks of
// kT = 64 steps.  For each chunk, with b the running sum of logsig(f) inside
// the chunk and the stabiliser m_row of each row floored at -50 as in the
// Pallas kernel:
//   S      = Q K^T                              (kT x kT over DQK)
//   W      = e^{b_i - b_j + i_j - m_row_i}, j <= i, else 0
//   h      = ((W o S) V + (Q C_prev) e^{b_i + m_prev - m_row_i}) / den_i
//   den_i  = max(|sum_j (W o S)_ij + e^{b_i + m_prev - m_row_i} (q_i . n_prev)|,
//                e^{-m_row_i})
//   C^T    = decay C_prev^T + (src o V)^T K,  n = decay n_prev + K^T src
// The four products are warpgroup wgmma (hopper_mma.cuh), bf16 in, fp32
// accumulators, on 64-row tiles in the 128-byte swizzle.  S = Q K^T and
// Q C_prev are one m64n192 product of Q by 192 K-major rows [K | C hi | C lo]
// (C is kept transposed, so its copy is K-major like K; the K / C^T tile
// holds both K buffers around the copy, see kcdesc), so Q is read once for
// both; (W o S) V takes W o S in registers straight from S's accumulators and
// V MN-major, as flash attention's P V; (src o V)^T K takes (src o V)^T in
// registers (ldmatrix .trans of V, times src) and K MN-major.  q, k and v
// are bf16 already.  The operands made inside the kernel -- W o S, C's copy
// for Q C_prev and src o V -- are each carried as two bf16, the rounded
// value and the rounded rest (about 16 bits together), and each of their
// products runs on both: one bf16 rounding (0.2% of each term) put h past
// 2e-2 of the per-step recurrence where a row's terms cancel, at xLSTM's
// width as in the tests' sweep.  The row sums of W o S, q . n, n and every
// gate term stay fp32.
//
// Three warpgroups, each in its own loop, kept in step by named barriers:
// warpgroup 0 (H) computes h; warpgroups 1 and 2 (C) the gates and q . n
// while H multiplies, then C^T (64 x DQK fp32 in their registers, 64 a thread
// each at DQK 256) and n while H weights and reads out, then C's copy.  The
// next chunk's Q, K and V arrive by TMA (one thread issues 2 DQK / 64 + 1
// boxes on an mbarrier; the gates by cp.async) while one computes: two
// buffers each, 221 KB at DQK 256, one block an SM.  The blocks are
// persistent, one an SM, each walking its items one after another, so an
// item's first chunk loads while the last item computes.  A last chunk
// shorter than kT is masked: its missing steps load as zeros (the boxes'
// out-of-range rows), with logsig(f) 0 and i -1e30, so they add nothing.
// The wrapper pads q and k rows below 64 values, and v rows to a multiple of
// 8 values, with zero columns.  The time goes to the products and to the
// single warp a scheduler runs for each role between barriers (PERF.md,
// section 7).
//
// fp32 (mlstm_scan_kernel): the per-step recurrence on scalar FMAs, a
// barrier a step; the block's DQK x 64 slice of C lives in its 256 threads'
// registers.  TF32 tensor cores would not compute the same function, and a
// chunkwise form on fp32 FMAs does more operations than the per-step one
// at kT 64 (it recomputes S and W o S), so fp32 keeps this route.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "scalar.cuh"

namespace repro {
namespace mlstm {

// ------------------------------------------------------------- per step, fp32
constexpr int kCols = 64;                // DV columns of one tile
constexpr int kGroups = 4;               // row groups: thread = (group, column)
constexpr int kThreads = kCols * kGroups;
constexpr int kWarps = kThreads / 32;

__device__ inline float log_sigmoid(float x) { return fminf(x, 0.f) - log1pf(expf(-fabsf(x))); }

template <typename T, int DQK>
__global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ i_g, const float* __restrict__ f_g,
                  T* __restrict__ out, int n_steps, int dv, float scale) {
  constexpr int R = DQK / kGroups;       // rows of C per thread
  __shared__ float q_s[2][DQK], k_s[2][DQK], v_s[2][kCols], g_s[2][2];
  __shared__ float part_s[2][kGroups][kCols], nq_s[2][kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col = tid % kCols, grp = tid / kCols;
  const int v0 = blockIdx.x * kCols;
  const size_t bh = blockIdx.y;
  const T* q_row = q + bh * n_steps * DQK;
  const T* k_row = k + bh * n_steps * DQK;
  const T* v_row = v + bh * n_steps * dv + v0;
  const float* i_row = i_g + bh * n_steps;
  const float* f_row = f_g + bh * n_steps;
  T* o_row = out + bh * n_steps * dv + v0;
  const bool v_live = v0 + col < dv;

  // what thread tid loads for a step: q[tid], k[tid] (tid < DQK), v[tid]
  // (tid < kCols), the gates (two threads)
  auto load = [&](int t, float& qv, float& kv, float& vv, float& gv) {
    if (tid < DQK) {
      qv = to_float(q_row[(size_t)t * DQK + tid]) * scale;
      kv = to_float(k_row[(size_t)t * DQK + tid]);
    }
    if (tid < kCols) vv = (v0 + tid < dv) ? to_float(v_row[(size_t)t * dv + tid]) : 0.f;
    if (tid == kThreads - 1) gv = i_row[t];
    if (tid == kThreads - 2) gv = f_row[t];
  };
  auto store = [&](int buf, float qv, float kv, float vv, float gv) {
    if (tid < DQK) {
      q_s[buf][tid] = qv;
      k_s[buf][tid] = kv;
    }
    if (tid < kCols) v_s[buf][tid] = vv;
    if (tid == kThreads - 1) g_s[buf][0] = gv;
    if (tid == kThreads - 2) g_s[buf][1] = gv;
  };

  float c[R];
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0.f;
  float n_reg = 0.f;                     // n[tid] for tid < DQK
  float m = 0.f;                         // the same in every thread

  float qv = 0.f, kv = 0.f, vv = 0.f, gv = 0.f;
  load(0, qv, kv, vv, gv);
  store(0, qv, kv, vv, gv);
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_steps) load(t + 1, qv, kv, vv, gv);

    const float ig = g_s[cur][0], lf = log_sigmoid(g_s[cur][1]);
    const float m_new = fmaxf(lf + m, ig);
    const float decay = expf(lf + m - m_new);
    const float inj = expf(ig - m_new);
    m = m_new;

    const float vc = v_s[cur][col];
    float num = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = grp + kGroups * r;
      c[r] = decay * c[r] + inj * k_s[cur][row] * vc;
      num += c[r] * q_s[cur][row];
    }
    part_s[cur][grp][col] = num;

    float nq = 0.f;
    if (tid < DQK) {
      n_reg = decay * n_reg + inj * k_s[cur][tid];
      nq = n_reg * q_s[cur][tid];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) nq += __shfl_xor_sync(0xffffffffu, nq, off);
    if (lane == 0) nq_s[cur][warp] = nq;

    if (t + 1 < n_steps) store(cur ^ 1, qv, kv, vv, gv);
    __syncthreads();

    if (grp == 0 && v_live) {
      float dot = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) dot += nq_s[cur][w];
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) s += part_s[cur][g][col];
      const float den = fmaxf(fabsf(dot), expf(-m_new));
      from_float(o_row + (size_t)t * dv + col, s / den);
    }
    // part_s / nq_s of this step are rewritten two steps on, after the next
    // __syncthreads, which every reader above has passed by then
  }
}

// ------------------------------------------------------------- chunkwise, bf16
using bf16 = __nv_bfloat16;

constexpr int kT = 64;          // steps of a chunk: the module's CHUNK
constexpr int kNV = 64;         // DV columns of an item
constexpr int kCThreads = 384;  // three warpgroups
// named barriers (0 is __syncthreads'): chunk start, gates ready, C^T's copy
// read, and one for each C warpgroup's n
constexpr int kBarStart = 1, kBarGates = 2, kBarCopy = 3, kBarN = 4;
constexpr float kNeg = -1e30f;
constexpr float kFloor = -50.f;  // the Pallas kernel's floor on m_row

// Byte offset of 16-byte chunk c of row r in a tile of 64 rows in the
// 128-byte swizzle wgmma reads (as flash_attention.cu's tiles): atoms of 64
// columns x 64 rows x 128 bytes, the chunks of row r permuted by r % 8.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)((c >> 3) * 64 * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// Descriptor of k step ks (16 columns) of a K-major tile of 64 rows.
__device__ __forceinline__ uint64_t kdesc(const unsigned char* tile, int ks) {
  return mma::smem_desc(tile + (ks >> 2) * 64 * 128 + (ks & 3) * 32, 16, 1024, true);
}

// The K / C^T tile: atoms of 64 columns x 256 rows, rows 0-63 K of buffer
// 0, 64-127 C^T's copy (hi), 128-191 its rest (lo), 192-255 K of buffer 1;
// so rows 0-191 and 64-255 are each one K-major B operand [K | hi | lo] or
// [hi | lo | K] of 192 rows.
constexpr int kKcRows = 256;
constexpr int kHiRow = 64, kLoRow = 128;
__device__ __forceinline__ int k_row0(int buf) { return buf ? 192 : 0; }

__device__ __forceinline__ uint32_t sw256(int r, int c) {
  return (uint32_t)((c >> 3) * kKcRows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// K-major descriptor of k step ks of the K / C^T tile's rows from row0 on.
__device__ __forceinline__ uint64_t kcdesc(const unsigned char* kc, int row0, int ks) {
  return mma::smem_desc(kc + (ks >> 2) * kKcRows * 128 + row0 * 128 + (ks & 3) * 32, 16, 1024,
                        true);
}

// MN-major descriptor of k step ks (16 rows) of the K rows from row0 on,
// from column atom a on.
__device__ __forceinline__ uint64_t kndesc(const unsigned char* kc, int row0, int ks, int a) {
  return mma::smem_desc(kc + a * kKcRows * 128 + (row0 + 16 * ks) * 128, kKcRows * 128, 1024,
                        true);
}

// Descriptor of k step ks (16 rows) of an MN-major tile of 64 rows, from its
// column atom a (64 columns) on.
__device__ __forceinline__ uint64_t ndesc(const unsigned char* tile, int ks, int a) {
  return mma::smem_desc(tile + a * 64 * 128 + ks * 2048, 64 * 128, 1024, true);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// (x0, x1) as two bf16 pairs: hi the rounded values, lo the rounded rest, so
// that hi + lo keeps about 16 bits of each.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = mma::pack_bf16(x0, x1);
  lo = mma::pack_bf16(x0 - bf16_lo(hi), x1 - bf16_hi(hi));
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error about 2^-22; 0 below -126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DQK>
struct ChunkCfg {
  static_assert(DQK % 64 == 0, "q and k rows are whole 128-byte atoms (the wrapper pads)");
  static constexpr int DP = DQK;
  static constexpr int CPR = DP / 8;              // 16-byte chunks of a q or k row
  static constexpr int NA = DP / 64;              // 64-column atoms of a q or k row
  static constexpr int QK_B = kT * DP * 2;        // bytes of a Q or K tile
  static constexpr int V_B = kT * kNV * 2;        // of a V tile
  static constexpr int KC_B = kKcRows * DP * 2;   // of the K / C^T tile
  // columns (of DQK) of C^T a C warpgroup holds, and how many hold some
  static constexpr int PN = DP >= 128 ? DP / 2 : DP;
  static constexpr int NCW = DP / PN;
  // n: each C warpgroup updates DP / 2 columns, NCH chunks of 8, each thread
  // one chunk over JPG of the kT steps
  static constexpr int NHALF = DP / 2, NCH = NHALF / 8, JG = 128 / NCH, JPG = kT / JG;
  static constexpr int PART = JG * NHALF;  // partial sums of n a C warpgroup, floats
  // f, i (two buffers each), b, i, m_row, w_inter, src, q.n, n, decay, partials
  static constexpr int FLOATS = 10 * kT + DP + 4 + 2 * PART;
  static constexpr int TX = (2 * NA + 1) * 64 * 128;  // bytes a step's boxes bring
  // Q and V twice (the next chunk's in flight), the K / C^T tile, the
  // floats, and room to align the tiles to 1 KB
  static constexpr size_t SMEM = 2 * ((size_t)QK_B + V_B) + KC_B + 4 * FLOATS + 16 + 1024;
  static_assert(SMEM <= 232448, "tiles do not fit one block's shared memory");
};

// A block walks items (sequence * head, tile of kNV columns of DV):
// blockIdx.x, + gridDim.x, ... (one block an SM), chunk by chunk, and
// stages each next chunk, of the same item or of its next one, while it
// computes the current.  Warpgroup 0 ("H") computes h: S, W o S, Q C_prev,
// (W o S) V.  Warpgroups 1 and 2 ("C") compute the gates and q . n_prev
// before it needs them, then, while H works, C^T (64 x DQK fp32, in their
// registers, DQK / 2 columns each from DQK 128 up) and n.  Each role runs
// its own loop; named barriers keep them in step.
template <int DQK>
__global__ void __launch_bounds__(kCThreads, 1)
mlstm_chunk_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ i_g,
                   const float* __restrict__ f_g, bf16* __restrict__ out, int n_bh, int n_steps,
                   int dv, float scale, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  using C = ChunkCfg<DQK>;
  constexpr int DP = C::DP, CPR = C::CPR, PN = C::PN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (mma::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* kc_s = q_s + 2 * C::QK_B;    // (kKcRows, DP): K twice, C^T hi, lo
  unsigned char* v_s = kc_s + C::KC_B;        // 2 x (kT, kNV); q_s 2 x (kT, DP)
  float* fraw = reinterpret_cast<float*>(v_s + 2 * C::V_B);    // 2 x kT
  float* iraw = fraw + 2 * kT;                                 // 2 x kT
  float* u2_s = iraw + 2 * kT;                                 // (b_i - m_row_i) log2 e
  float* v2_s = u2_s + kT;                                     // (i_j - b_j) log2 e
  float* mrow_s = v2_s + kT;
  float* winter_s = mrow_s + kT;
  float* src_s = winter_s + kT;
  float* qn_s = src_s + kT;                                    // scale * q . n_prev
  float* n_s = qn_s + kT;                                      // DP
  float* decay_s = n_s + DP;                                   // 4
  float* part_s = decay_s + 4;                                 // 2 x PART
  uint64_t* mbar = reinterpret_cast<uint64_t*>(part_s + 2 * C::PART);  // one a buffer

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // warpgroup (made visibly uniform for the compiler, so that the wgmma in
  // its branch are not serialized), its warp, its thread
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), wq = warp & 3, tg = tid & 127;
  const int gid = lane >> 2, tig = lane & 3;
  const int n_vt = (dv + kNV - 1) / kNV;
  const int n_chunks = (n_steps + kT - 1) / kT;
  const int n_items = n_bh * n_vt;
  const int n_walk = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * n_chunks;
  // item of step g of this block's walk; its chunk is g % n_chunks
  auto item_of = [&](int g) { return (int)blockIdx.x + g / n_chunks * (int)gridDim.x; };

  // q, k, v and the gates of walk step g into buffer g & 1: thread 160
  // announces the bytes and issues the TMA boxes (64 rows x 128 bytes each;
  // rows past S and columns past DV land as zeros), warp 4, which computes
  // the gates, copies their values by cp.async, each lane its own steps
  auto stage = [&](int g) {
    const int it = item_of(g), buf = g & 1, p0 = g % n_chunks * kT;
    const int bh = it / n_vt;
    if (warp == 4) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * lane + e;
        if (p0 + r < n_steps) {
          mma::cp_async4(fraw + buf * kT + r, f_g + (size_t)bh * n_steps + p0 + r);
          mma::cp_async4(iraw + buf * kT + r, i_g + (size_t)bh * n_steps + p0 + r);
        }
      }
      mma::cp_async_commit();
    }
    if (tid == 160) {
      mma::mbar_arrive_tx(mbar + buf, C::TX);
#pragma unroll
      for (int a = 0; a < C::NA; ++a) {
        mma::tma_load_3d(q_s + buf * C::QK_B + a * 64 * 128, &tq, 64 * a, p0, bh, mbar + buf);
        mma::tma_load_3d(kc_s + a * kKcRows * 128 + k_row0(buf) * 128, &tk, 64 * a, p0, bh,
                         mbar + buf);
      }
      mma::tma_load_3d(v_s + buf * C::V_B, &tv, it % n_vt * kNV, p0, bh, mbar + buf);
    }
  };
  // step g has landed, and step g - 1 is done with buffer g + 1 & 1; this
  // thread's plain stores (C^T's copy) are made visible to the tensor cores
  auto chunk_start = [&](int g) {
    mma::mbar_wait(mbar + (g & 1), (g >> 1) & 1);
    if (warp == 4) mma::cp_async_wait<0>();
    mma::fence_proxy_async();
    mma::bar_sync(kBarStart, kCThreads);
  };

  for (int i = tid; i < DP; i += kCThreads) n_s[i] = 0.f;
  if (tid == 0) {
    mma::mbar_init(mbar, 1);
    mma::mbar_init(mbar + 1, 1);
    mma::fence_mbar_init();
  }
  __syncthreads();
  if (n_walk > 0) stage(0);

  if (wg == 0) {
    // ================================================================ H
    const int r0 = 16 * wq + gid, r1 = r0 + 8;  // this lane's rows
    for (int g = 0; g < n_walk; ++g) {
      const int buf = g & 1, c = g % n_chunks, it = item_of(g);
      const int tc = min(kT, n_steps - c * kT);  // steps of this chunk
      chunk_start(g);
      const unsigned char* qt = q_s + buf * C::QK_B;
      const unsigned char* vt = v_s + buf * C::V_B;

      // ---- while C computes the gates: S = Q K^T and, from the second
      // chunk on, Q C_prev (hi and lo), as one product of Q by the 192 rows
      // [K | hi | lo] (buffer 0) or [hi | lo | K] (buffer 1).  The first
      // chunk takes S alone, even k steps into s, odd ones into h.
      float s[32], h[32];
      if (c == 0) {
        mma::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          if (ks & 1)
            mma::wgmma_ss_n64(h, kdesc(qt, ks), kcdesc(kc_s, k_row0(buf), ks), ks > 1);
          else
            mma::wgmma_ss_n64(s, kdesc(qt, ks), kcdesc(kc_s, k_row0(buf), ks), ks > 1);
        }
        mma::wgmma_commit();
        mma::bar_sync(kBarGates, kCThreads);
        mma::wgmma_wait<0>();
        mma::fence_regs(s);
        mma::fence_regs(h);
        mma::bar_arrive(kBarCopy, kCThreads);  // C^T's copy was not read
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          s[e] += h[e];
          h[e] = 0.f;
        }
      } else {
        float acc[96];
        mma::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks)
          mma::wgmma_ss_n192(acc, kdesc(qt, ks), kcdesc(kc_s, buf ? kHiRow : 0, ks), ks > 0);
        mma::wgmma_commit();
        mma::bar_sync(kBarGates, kCThreads);
        mma::wgmma_wait<0>();
        mma::fence_regs(acc);
        mma::bar_arrive(kBarCopy, kCThreads);  // C^T's copy is read
        if (buf == 0) {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            s[e] = acc[e];
            h[e] = acc[32 + e] + acc[64 + e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            s[e] = acc[64 + e];
            h[e] = acc[e] + acc[32 + e];
          }
        }
      }

      // ---- W o S (rows r0, r1), its row sums, and W o S as the register A
      // operand of (W o S) V, hi and lo: key slice kk holds score tiles 2 kk
      // (a0, a1) and 2 kk + 1 (a2, a3)
      const float u0 = u2_s[r0], u1 = u2_s[r1];
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t ph[kT / 16][4], pl[kT / 16][4];
#pragma unroll
      for (int jt = 0; jt < kT / 8; ++jt) {
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        if (jt <= 2 * wq + 1) {  // else every key of the tile is after every row
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 8 * jt + 2 * tig + e;
            const float vj = v2_s[j];
            if (j <= r0) x[e] = exp2_approx(u0 + vj) * (s[4 * jt + e] * scale);
            if (j <= r1) x[2 + e] = exp2_approx(u1 + vj) * (s[4 * jt + 2 + e] * scale);
          }
        }
        rs0 += x[0] + x[1];
        rs1 += x[2] + x[3];
        split2(x[0], x[1], ph[jt >> 1][(jt & 1) * 2], pl[jt >> 1][(jt & 1) * 2]);
        split2(x[2], x[3], ph[jt >> 1][(jt & 1) * 2 + 1], pl[jt >> 1][(jt & 1) * 2 + 1]);
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);

      // ---- h = Q C_prev times scale e^{b_i + m_prev - m_row_i}
      const float wi0 = winter_s[r0], wi1 = winter_s[r1];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        h[4 * jt] *= scale * wi0;
        h[4 * jt + 1] *= scale * wi0;
        h[4 * jt + 2] *= scale * wi1;
        h[4 * jt + 3] *= scale * wi1;
      }

      // ---- h += (W o S) V, hi and lo, then / den
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        mma::wgmma_rs<64>(h, ph[kk], ndesc(vt, kk, 0));
        mma::wgmma_rs<64>(h, pl[kk], ndesc(vt, kk, 0));
      }
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
      mma::fence_regs(h);
      const float inv0 = 1.f / fmaxf(fabsf(rs0 + wi0 * qn_s[r0]), expf(-mrow_s[r0]));
      const float inv1 = 1.f / fmaxf(fabsf(rs1 + wi1 * qn_s[r1]), expf(-mrow_s[r1]));
      const int v0 = it % n_vt * kNV;
      bf16* o_bh = out + (size_t)(it / n_vt) * n_steps * dv;
      const int p0 = c * kT;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int i = hr ? r1 : r0;
        if (i >= tc) continue;
        const float inv = hr ? inv1 : inv0;
        bf16* o_row = o_bh + (size_t)(p0 + i) * dv;
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
          const int col = v0 + 8 * jt + 2 * tig;
          const float x0 = h[4 * jt + 2 * hr] * inv, x1 = h[4 * jt + 2 * hr + 1] * inv;
          if (col + 1 < dv && !(dv & 1)) {
            *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(x0, x1);
          } else {
            if (col < dv) o_row[col] = __float2bfloat16(x0);
            if (col + 1 < dv) o_row[col + 1] = __float2bfloat16(x1);
          }
        }
      }
    }
  } else {
    // ================================================================ C
    const int wc = wg - 1, tc2 = tid - 128;  // which C warpgroup; thread of the two
    float* part = part_s + wc * C::PART;
    float cacc[PN / 2];  // C^T rows 16 wq + gid (+ 8), columns wc PN + ..., fp32
#pragma unroll
    for (int e = 0; e < PN / 2; ++e) cacc[e] = 0.f;
    float m_prev = 0.f;  // the stabiliser, kept by warp 4
    for (int g = 0; g < n_walk; ++g) {
      const int buf = g & 1, c = g % n_chunks;
      const int tc = min(kT, n_steps - c * kT);  // steps of this chunk
      chunk_start(g);
      if (g + 1 < n_walk) stage(g + 1);
      const unsigned char* qt = q_s + buf * C::QK_B;
      const unsigned char* vt = v_s + buf * C::V_B;
      const int kr = k_row0(buf);  // this chunk's K rows in the K / C^T tile

      // ---- the gates (warp 4: lane l has steps 2 l, 2 l + 1)
      if (warp == 4) {
        if (c == 0) m_prev = 0.f;
        float lf[2], ig[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * lane + e;
          lf[e] = r < tc ? log_sigmoid(fraw[buf * kT + r]) : 0.f;
          ig[e] = r < tc ? iraw[buf * kT + r] : kNeg;
        }
        float incl = lf[0] + lf[1];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        float excl = __shfl_up_sync(0xffffffffu, incl, 1);
        if (lane == 0) excl = 0.f;
        const float b[2] = {excl + lf[0], excl + lf[0] + lf[1]};
        const float g_tot = __shfl_sync(0xffffffffu, b[1], 31);
        // m_row_i = max(max_{j <= i} (b_i - b_j + i_j), b_i + m_prev, -50): a
        // running maximum of i_j - b_j
        const float a[2] = {ig[0] - b[0], ig[1] - b[1]};
        float pm = fmaxf(a[0], a[1]);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float y = __shfl_up_sync(0xffffffffu, pm, o);
          if (lane >= o) pm = fmaxf(pm, y);
        }
        float pex = __shfl_up_sync(0xffffffffu, pm, 1);
        if (lane == 0) pex = kNeg;
        const float pmx[2] = {fmaxf(pex, a[0]), fmaxf(fmaxf(pex, a[0]), a[1])};
        float cm = fmaxf(g_tot - b[0] + ig[0], g_tot - b[1] + ig[1]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
        const float m_new = fmaxf(g_tot + m_prev, cm);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 2 * lane + e;
          const float mr = fmaxf(fmaxf(b[e] + pmx[e], b[e] + m_prev), kFloor);
          u2_s[r] = (b[e] - mr) * kLog2e;
          v2_s[r] = (ig[e] - b[e]) * kLog2e;
          mrow_s[r] = mr;
          winter_s[r] = expf(b[e] + m_prev - mr);
          src_s[r] = expf(g_tot - b[e] + ig[e] - m_new);
        }
        if (lane == 0) decay_s[0] = expf(g_tot + m_prev - m_new);
        m_prev = m_new;
      }
      // ---- scale * q . n_prev: 4 threads a row
      {
        const int r = tc2 >> 2;
        float s0 = 0.f, s1 = 0.f;
        for (int ch = tc2 & 3; ch < CPR; ch += 4) {
          const uint4 raw = *reinterpret_cast<const uint4*>(qt + sw128(r, ch));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          const float* nn = n_s + ch * 8;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s0 = fmaf(bf16_lo(w[e]), nn[2 * e], s0);
            s1 = fmaf(bf16_hi(w[e]), nn[2 * e + 1], s1);
          }
        }
        s0 = quad_sum(s0 + s1);
        if (!(tc2 & 3)) qn_s[r] = s0 * scale;
      }
      mma::bar_sync(kBarGates, kCThreads);

      // ---- C^T = decay C^T + (src o V)^T K on this warpgroup's columns: A =
      // (src o V)^T from registers (ldmatrix.trans of V times src, hi and
      // lo), B = K, MN-major
      const float decay = decay_s[0];
      if (wc < C::NCW) {
#pragma unroll
        for (int e = 0; e < PN / 2; ++e) cacc[e] *= decay;
        mma::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kT / 16; ++ks) {
          uint32_t vf[4];  // rows (columns of v) 16 wq + gid (+ 8), steps 16 ks + 2 tig (+ 8)
          mma::ldsm_x4_t(vf, vt + sw128(16 * ks + (lane >> 4) * 8 + (lane & 7),
                                        2 * wq + ((lane >> 3) & 1)));
          const int j0 = 16 * ks + 2 * tig;
          const float sa = src_s[j0], sb = src_s[j0 + 1], sc = src_s[j0 + 8], sd = src_s[j0 + 9];
          uint32_t ah[4], al[4];
          split2(bf16_lo(vf[0]) * sa, bf16_hi(vf[0]) * sb, ah[0], al[0]);
          split2(bf16_lo(vf[1]) * sa, bf16_hi(vf[1]) * sb, ah[1], al[1]);
          split2(bf16_lo(vf[2]) * sc, bf16_hi(vf[2]) * sd, ah[2], al[2]);
          split2(bf16_lo(vf[3]) * sc, bf16_hi(vf[3]) * sd, ah[3], al[3]);
          mma::wgmma_rs<PN>(cacc, ah, kndesc(kc_s, kr, ks, wc * (PN / 64)));
          mma::wgmma_rs<PN>(cacc, al, kndesc(kc_s, kr, ks, wc * (PN / 64)));
        }
        mma::wgmma_commit();
      }

      // ---- n = decay n + K^T src on this warpgroup's DP / 2 columns, while
      // the products run: partial sums over JPG steps, then their sum
      {
        const int ch = tg % C::NCH, jg = tg / C::NCH;
        float t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) t[e] = 0.f;
#pragma unroll
        for (int jj = 0; jj < C::JPG; ++jj) {
          const int j = jg * C::JPG + jj;
          const uint4 raw =
              *reinterpret_cast<const uint4*>(kc_s + sw256(kr + j, wc * (C::NHALF / 8) + ch));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
          const float sj = src_s[j];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            t[2 * e] = fmaf(sj, bf16_lo(w[e]), t[2 * e]);
            t[2 * e + 1] = fmaf(sj, bf16_hi(w[e]), t[2 * e + 1]);
          }
        }
        float4* dst = reinterpret_cast<float4*>(part + jg * C::NHALF + ch * 8);
        dst[0] = make_float4(t[0], t[1], t[2], t[3]);
        dst[1] = make_float4(t[4], t[5], t[6], t[7]);
        mma::bar_sync(kBarN + wc, 128);
        for (int d = tg; d < C::NHALF; d += 128) {
          float sum = 0.f;
#pragma unroll
          for (int i = 0; i < C::JG; ++i) sum += part[i * C::NHALF + d];
          const int dd = wc * C::NHALF + d;
          n_s[dd] = c == n_chunks - 1 ? 0.f : decay * n_s[dd] + sum;
        }
      }
      if (wc < C::NCW) {
        mma::wgmma_wait<0>();
        mma::fence_regs(cacc);
      }
      mma::bar_sync(kBarCopy, kCThreads);  // H has read C^T's old copy
      if (wc >= C::NCW) continue;
      if (c == n_chunks - 1) {  // the next item starts from C = 0
#pragma unroll
        for (int e = 0; e < PN / 2; ++e) cacc[e] = 0.f;
        continue;
      }
      // C^T's copy, hi and lo, K-major for Q C_prev: 8 x 8 matrices
      // (rows 16 wq.. and 16 wq + 8.., columns of tiles jt and jt + 1)
      const int row = 16 * wq + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int jt = 0; jt < PN / 8; jt += 2) {
        const int ch = wc * (PN / 8) + jt + (lane >> 4);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          split2(cacc[4 * jt + 2 * m], cacc[4 * jt + 2 * m + 1], hi[m], lo[m]);
        mma::stsm_x4(kc_s + sw256(kHiRow + row, ch), hi[0], hi[1], hi[2], hi[3]);
        mma::stsm_x4(kc_s + sw256(kLoRow + row, ch), lo[0], lo[1], lo[2], lo[3]);
      }
    }
  }
}

// ------------------------------------------------------------------ launch
template <int DQK>
int launch_steps(const void* q, const void* k, const void* v, const void* i_g, const void* f_g,
                 void* out, int n_bh, int n_steps, int dv, float scale, cudaStream_t stream) {
  if (n_bh > 65535) return -2;
  const dim3 grid((dv + kCols - 1) / kCols, n_bh);
  mlstm_scan_kernel<float, DQK><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(i_g), static_cast<const float*>(f_g), static_cast<float*>(out),
      n_steps, dv, scale);
  return (int)cudaGetLastError();
}

// One block an SM, each walking its items; no more blocks than items.
int n_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
  }
  return n;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (cols, S, BH) bf16 tensor with rows of `stride` elements, as boxes of 64
// rows x 64 columns in the 128-byte swizzle.
bool tensor_map(CUtensorMap* m, const void* base, int cols, int stride, int n_steps, int n_bh) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n_steps, (cuuint64_t)n_bh};
  const cuuint64_t strides[2] = {(cuuint64_t)stride * 2, (cuuint64_t)stride * 2 * n_steps};
  const cuuint32_t box[3] = {64, 64, 1}, elem[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK>
int launch_chunks(const void* q, const void* k, const void* v, const void* i_g, const void* f_g,
                  void* out, int n_bh, int n_steps, int dv, int dv_stride, float scale,
                  cudaStream_t stream) {
  constexpr size_t smem = ChunkCfg<DQK>::SMEM;
  auto kernel = mlstm_chunk_kernel<DQK>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, DQK, DQK, n_steps, n_bh) || !tensor_map(&tk, k, DQK, DQK, n_steps, n_bh) ||
      !tensor_map(&tv, v, dv_stride, dv_stride, n_steps, n_bh))
    return -4;
  const long long items = (long long)n_bh * ((dv + kNV - 1) / kNV);
  if (items > 0x7fffffffLL) return -2;
  const int blocks = (int)(items < n_sms() ? items : n_sms());
  kernel<<<blocks, kCThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(i_g), static_cast<const float*>(f_g), static_cast<bf16*>(out),
      n_bh, n_steps, dv, scale, tq, tk, tv);
  return (int)cudaGetLastError();
}

// dtype 0 (fp32) takes the per-step kernel, 1 (bf16) the chunkwise one,
// whose q and k rows the caller pads to 64, 128 or 256 values and whose v
// rows are dv_stride >= dv values, a multiple of 8.
int dispatch(int dtype, int dqk, const void* q, const void* k, const void* v, const void* i_g,
             const void* f_g, void* out, int n_bh, int n_steps, int dv, int dv_stride,
             float scale, cudaStream_t stream) {
  if (dtype == 1) {
    if (dv_stride < dv || dv_stride % 8 || (reinterpret_cast<uintptr_t>(q) |
                                            reinterpret_cast<uintptr_t>(k) |
                                            reinterpret_cast<uintptr_t>(v)) % 16)
      return -1;
    switch (dqk) {
      case 64:
        return launch_chunks<64>(q, k, v, i_g, f_g, out, n_bh, n_steps, dv, dv_stride, scale,
                                 stream);
      case 128:
        return launch_chunks<128>(q, k, v, i_g, f_g, out, n_bh, n_steps, dv, dv_stride, scale,
                                  stream);
      case 256:
        return launch_chunks<256>(q, k, v, i_g, f_g, out, n_bh, n_steps, dv, dv_stride, scale,
                                  stream);
      default:
        return -1;
    }
  }
#define REPRO_DQK_CASE(D) \
  case D:                 \
    return launch_steps<D>(q, k, v, i_g, f_g, out, n_bh, n_steps, dv, scale, stream)
  switch (dqk) {
    REPRO_DQK_CASE(8);
    REPRO_DQK_CASE(16);
    REPRO_DQK_CASE(32);
    REPRO_DQK_CASE(64);
    REPRO_DQK_CASE(128);
    REPRO_DQK_CASE(256);
    default:
      return -1;
  }
#undef REPRO_DQK_CASE
}

}  // namespace mlstm
}  // namespace repro

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16; chunk: the steps of
// a chunk the caller was built for, which must be kT; dv_stride: the row
// length of v (bf16: dv rounded up to a multiple of 8; fp32: dv).  Returns 0
// on success, a cudaError_t when the launch was refused, -1 for an
// unsupported qk head dim, dtype or layout, -2 for a grid out of range, -3
// for another chunk, -4 when a tensor map cannot be made.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v, const void* i_g,
                                 const void* f_g, void* out, int n_bh, int n_steps, int dqk,
                                 int dv, int dv_stride, int dtype, int chunk, float scale,
                                 void* stream) {
  if (chunk != repro::mlstm::kT) return -3;
  if (dtype != 0 && dtype != 1) return -1;
  if (n_bh <= 0 || n_steps <= 0 || dv <= 0) return 0;
  return repro::mlstm::dispatch(dtype, dqk, q, k, v, i_g, f_g, out, n_bh, n_steps, dv,
                                dv_stride, scale, static_cast<cudaStream_t>(stream));
}
