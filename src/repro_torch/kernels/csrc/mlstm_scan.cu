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
// carried (C, n, m) in VMEM across a sequential chunk grid and computed each
// chunk's h with matrix products.  At xLSTM's width one head's C is
// DQK 256 x DV 512 fp32 = 512 KB, more than a block can hold, so a block owns
// one (sequence * head, DV tile of kCols columns) pair: its DQK x kCols slice
// of C lives in registers (kThreads threads, each one column and DQK / 4
// rows), and n and m, which every tile needs, are recomputed by each tile's
// block.  The block steps through S with the per-step recurrence above
// (ref.mlstm_ref's order, which gives the chunkwise kernel's h up to the
// point where the stabiliser is applied); step t + 1's q, k, v and gates are
// loaded into registers while step t computes, and land in the other half of
// a double-buffered stage, so each step takes one __syncthreads.  The
// function does about 4 DQK DV operations per step and head against q, k, v,
// the gates and h moved once (some 170 a byte at xLSTM's width): bound by
// bytes against the tensor cores' bf16 rate, by operations in fp32.  This
// kernel uses scalar fp32 FMAs, not the tensor cores a chunkwise form would.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace mlstm {

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

template <typename T, int DQK>
int launch(const void* q, const void* k, const void* v, const void* i_g, const void* f_g,
           void* out, int n_bh, int n_steps, int dv, float scale, cudaStream_t stream) {
  const dim3 grid((dv + kCols - 1) / kCols, n_bh);
  mlstm_scan_kernel<T, DQK><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(i_g), static_cast<const float*>(f_g), static_cast<T*>(out),
      n_steps, dv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dqk(int dqk, const void* q, const void* k, const void* v, const void* i_g,
                 const void* f_g, void* out, int n_bh, int n_steps, int dv, float scale,
                 cudaStream_t stream) {
  switch (dqk) {
#define REPRO_DQK_CASE(D) \
  case D:                 \
    return launch<T, D>(q, k, v, i_g, f_g, out, n_bh, n_steps, dv, scale, stream)
    REPRO_DQK_CASE(8);
    REPRO_DQK_CASE(16);
    REPRO_DQK_CASE(32);
    REPRO_DQK_CASE(64);
    REPRO_DQK_CASE(128);
    REPRO_DQK_CASE(256);
#undef REPRO_DQK_CASE
    default:
      return -1;
  }
}

}  // namespace mlstm
}  // namespace repro

// dtype (of q, k, v and out): 0 = float32, 1 = bfloat16.  Returns 0 on
// success, a cudaError_t when the launch was refused, -1 for an unsupported
// qk head dim or dtype.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v, const void* i_g,
                                 const void* f_g, void* out, int n_bh, int n_steps, int dqk,
                                 int dv, int dtype, float scale, void* stream) {
  if (n_bh <= 0 || n_steps <= 0 || dv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::mlstm::dispatch_dqk<float>(dqk, q, k, v, i_g, f_g, out, n_bh, n_steps, dv,
                                             scale, s);
  if (dtype == 1)
    return repro::mlstm::dispatch_dqk<__nv_bfloat16>(dqk, q, k, v, i_g, f_g, out, n_bh,
                                                     n_steps, dv, scale, s);
  return -1;
}
