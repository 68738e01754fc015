// Mamba selective scan for Hopper (sm_90a): Hymba's SSM heads.
//
//   x       (B, S, D)   fp32 or bf16        dt (B, S, D) fp32
//   b_t     (B, S, N)   fp32                c_t (B, S, N) fp32
//   a       (D, N)      fp32 (negative)
//   y       (B, S, D)   in x's type:
//     h[b,d,:] = exp(dt[b,s,d] * a[d,:]) * h[b,d,:] + dt[b,s,d] * x[b,s,d] * b_t[b,s,:]
//     y[b,s,d] = h[b,d,:] . c_t[b,s,:]          (h starts at 0, fp32)
//
// Replaces the Pallas kernel repro/kernels/ssm_scan.py::ssm_scan, whose
// sequential chunk grid kept the (block_d, N) state in VMEM scratch.  Here a
// channel's state never leaves its thread: one thread per (b, d) holds the N
// fp32 state values in registers and loops over S.  A block of kThreads
// channels of one sequence stages kSteps time steps at a time in shared
// memory: x and dt (loads coalesced along d) and the step's b_t and c_t (N
// values each, read by every thread of the block).  Each (b, s, d, n) costs
// one exp and a few multiply-adds in fp32; the bytes are x, dt, b_t, c_t, a
// and y once each, so at Hymba's N = 16 (about 14 operations a byte) the
// function is bound by bytes, by the fp32 units from N = 32 on.  What holds
// this kernel back: B * D / kThreads blocks (about 100 for 8 sequences of
// 1600 channels, under one wave of 132 SMs), each a serial chain of S steps.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace ssm {

constexpr int kThreads = 128;
constexpr int kSteps = 16;

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b_t, const float* __restrict__ c_t,
                const float* __restrict__ a, TX* __restrict__ y, int n_steps, int n_ch) {
  __shared__ float x_s[kSteps][kThreads];
  __shared__ float dt_s[kSteps][kThreads];
  __shared__ float b_s[kSteps * N];
  __shared__ float c_s[kSteps * N];
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + tid;
  const bool live = d < n_ch;
  const size_t seq = blockIdx.y;

  float h[N], an[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    h[n] = 0.f;
    an[n] = live ? a[(size_t)d * N + n] : 0.f;
  }

  for (int s0 = 0; s0 < n_steps; s0 += kSteps) {
    const int steps = min(kSteps, n_steps - s0);
    __syncthreads();  // the previous chunk's staged values are consumed
    for (int t = 0; t < steps; ++t) {
      const size_t off = (seq * n_steps + s0 + t) * n_ch + d;
      x_s[t][tid] = live ? to_float(x[off]) : 0.f;
      dt_s[t][tid] = live ? dt[off] : 0.f;
    }
    const size_t bc = (seq * n_steps + s0) * N;
    for (int i = tid; i < steps * N; i += kThreads) {
      b_s[i] = b_t[bc + i];
      c_s[i] = c_t[bc + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const float dtt = dt_s[t][tid];
      const float dx = dtt * x_s[t][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtt * an[n]) * h[n] + dx * b_s[t * N + n];
        acc += h[n] * c_s[t * N + n];
      }
      from_float(y + (seq * n_steps + s0 + t) * n_ch + d, acc);
    }
  }
}

template <typename TX, int N>
int launch(const void* x, const void* dt, const void* b_t, const void* c_t, const void* a,
           void* y, int n_seq, int n_steps, int n_ch, cudaStream_t stream) {
  const dim3 grid((n_ch + kThreads - 1) / kThreads, n_seq);
  ssm_scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b_t), static_cast<const float*>(c_t),
      static_cast<const float*>(a), static_cast<TX*>(y), n_steps, n_ch);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_n(int n, const void* x, const void* dt, const void* b_t, const void* c_t,
               const void* a, void* y, int n_seq, int n_steps, int n_ch,
               cudaStream_t stream) {
  switch (n) {
#define REPRO_N_CASE(V) \
  case V:               \
    return launch<TX, V>(x, dt, b_t, c_t, a, y, n_seq, n_steps, n_ch, stream)
    REPRO_N_CASE(4);
    REPRO_N_CASE(8);
    REPRO_N_CASE(16);
    REPRO_N_CASE(32);
    REPRO_N_CASE(64);
#undef REPRO_N_CASE
    default:
      return -1;
  }
}

}  // namespace ssm
}  // namespace repro

// dtype (of x and y): 0 = float32, 1 = bfloat16.  Returns 0 on success, a
// cudaError_t when the launch was refused, -1 for an unsupported N or dtype.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* b_t, const void* c_t,
                               const void* a, void* y, int n_seq, int n_steps, int n_ch,
                               int n_state, int dtype, void* stream) {
  if (n_seq <= 0 || n_steps <= 0 || n_ch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::ssm::dispatch_n<float>(n_state, x, dt, b_t, c_t, a, y, n_seq, n_steps, n_ch,
                                         s);
  if (dtype == 1)
    return repro::ssm::dispatch_n<__nv_bfloat16>(n_state, x, dt, b_t, c_t, a, y, n_seq,
                                                 n_steps, n_ch, s);
  return -1;
}
