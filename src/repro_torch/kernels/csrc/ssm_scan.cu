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
// sequential chunk grid kept the (block_d, N) state in VMEM scratch.  Here
// the state never leaves registers.
//
// What bounds it.  Each (b, s, d, n) costs one exp and four fp32 operations;
// the bytes are x, dt, b_t, c_t, a and y once each.  At Hymba's N 16 the
// bytes bound is 0.0079 ms (B 16, S 128, D 1600, bf16 x), but the card's
// special-function units give 16 exps a clock an SM, so the 52 M exps alone
// take about 0.0125 ms: no design with one MUFU exp a state-step goes below
// that.  Measured, the kernel is paced by the issue of its instructions.
//
// The design (ssm_scan.py::ssm_plan gives the same split on the host):
//   - A channel's N states are split over kLanes adjacent lanes of a warp,
//     kStates each (2 lanes x 8 states at N 16): B * D * kLanes threads run
//     the recurrence, 1,600 warps at Hymba's layer 0, in one wave.  A lane
//     sums its states' share of y, the channel's lanes add theirs by
//     __shfl_xor_sync.  4 states a thread (twice the warps) ran 8% slower.
//   - The decay by dtype.  bf16 x (the model's): 2^(dt * a log2 e), a scaled
//     by log2 e once a thread and ex2.approx.ftz a single MUFU instruction
//     (relative error about 2^-22; a decay under 2^-126 flushes to 0); y is
//     rounded to bf16, far coarser than what the exps add up to.  fp32 x:
//     what ssm_scan_plain computes, expf(dt * a) and each product and sum
//     rounded apart, so h is the plain recurrence's to the bit.  A slow decay
//     over a long sequence adds up any bias of the decay: ex2.approx missed
//     the fp32 tolerance of 1e-4 at S 1024 by 6x, and expf contracted into
//     multiply-adds by 1.1x.
//   - kSteps steps of x and dt (the block's channels, contiguous along d) and
//     of b_t and c_t are staged by cp.async into one of two buffers while the
//     other is computed: 16-byte copies where every row allows them (D a
//     multiple of 16 bytes of x, aligned pointers), else copies of one value
//     (bf16 x then by plain loads).  A block waits at one barrier a chunk of
//     kSteps steps, never between a load and its use.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_mma.cuh"
#include "scalar.cuh"

namespace repro {
namespace ssm {

using mma::cp_async16;
using mma::cp_async4;

constexpr int kThreads = 128;
constexpr int kSteps = 16;  // steps a staging buffer holds; ssm_scan.py::STEPS
// Registers for 4 blocks an SM (128 a thread): Hymba's 16 x 25 blocks of
// channels run in one wave on 132 SMs.
constexpr int kBlocksPerSM = 4;
constexpr float kLog2e = 1.4426950408889634f;

// How a channel's N states are split: ssm_scan.py::ssm_plan.
template <int N>
struct Split {
  static constexpr int kStates = N < 8 ? N : 8;        // states a thread
  static constexpr int kLanes = N / kStates;            // lanes a channel
  static constexpr int kChannels = kThreads / kLanes;   // channels a block
  static_assert(kLanes * kStates == N && 32 % kLanes == 0, "lanes must split a warp");
};

template <typename TX, int N>
struct __align__(16) Stage {
  TX x[kSteps][Split<N>::kChannels];
  float dt[kSteps][Split<N>::kChannels];
  float b[kSteps][N];
  float c[kSteps][N];
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Start the copies of `steps` steps from row `row` (= sequence * S + step)
// into `st`: x and dt of channels [d0, d0 + kChannels), b_t and c_t whole.
template <typename TX, int N>
__device__ __forceinline__ void stage(Stage<TX, N>& st, const TX* __restrict__ x,
                                      const float* __restrict__ dt,
                                      const float* __restrict__ b_t,
                                      const float* __restrict__ c_t, size_t row, int steps,
                                      int d0, int n_ch, bool vec) {
  constexpr int C = Split<N>::kChannels;
  const int tid = threadIdx.x;
  float* bs = &st.b[0][0];
  float* cs = &st.c[0][0];
  const size_t bc = row * N;
  if (vec) {
    constexpr int XV = 16 / sizeof(TX), XQ = C / XV, DQ = C / 4;  // values, copies a step
    for (int i = tid; i < steps * XQ; i += kThreads) {
      const int t = i / XQ, q = i % XQ;
      if (d0 + q * XV < n_ch) cp_async16(&st.x[t][q * XV], x + (row + t) * n_ch + d0 + q * XV);
    }
    for (int i = tid; i < steps * DQ; i += kThreads) {
      const int t = i / DQ, q = i % DQ;
      if (d0 + q * 4 < n_ch) cp_async16(&st.dt[t][q * 4], dt + (row + t) * n_ch + d0 + q * 4);
    }
    for (int i = tid; i < steps * N / 4; i += kThreads) {
      cp_async16(bs + 4 * i, b_t + bc + 4 * i);
      cp_async16(cs + 4 * i, c_t + bc + 4 * i);
    }
  } else {
    for (int i = tid; i < steps * C; i += kThreads) {
      const int t = i / C, j = i % C;
      if (d0 + j >= n_ch) continue;
      const size_t off = (row + t) * n_ch + d0 + j;
      cp_async4(&st.dt[t][j], dt + off);
      if constexpr (sizeof(TX) == 4)
        cp_async4(&st.x[t][j], x + off);
      else
        st.x[t][j] = x[off];
    }
    for (int i = tid; i < steps * N; i += kThreads) {
      cp_async4(bs + i, b_t + bc + i);
      cp_async4(cs + i, c_t + bc + i);
    }
  }
}

template <typename TX, int N>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssm_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ b_t, const float* __restrict__ c_t,
                const float* __restrict__ a, TX* __restrict__ y, int n_steps, int n_ch,
                int vec) {
  using P = Split<N>;
  constexpr int S = P::kStates, L = P::kLanes, C = P::kChannels;
  // fp32 x: the plain recurrence's own arithmetic, each product and sum
  // rounded apart and exp by expf, so h equals ssm_scan_plain's bit for bit.
  // bf16 x: 2^(dt * a log2 e) by one ex2.approx, a multiply-add.
  constexpr bool kExact = sizeof(TX) == 4;
  __shared__ Stage<TX, N> st[2];
  const int tid = threadIdx.x;
  const int sub = tid % L;  // this lane holds states [sub * S, sub * S + S)
  const int j = tid / L;    // of channel d0 + j
  const int d0 = blockIdx.x * C;
  const int d = d0 + j;
  const bool live = d < n_ch;
  const size_t row0 = (size_t)blockIdx.y * n_steps;

  float h[S], a2[S];
#pragma unroll
  for (int i = 0; i < S; ++i) {
    h[i] = 0.f;
    a2[i] = live ? a[(size_t)d * N + sub * S + i] * (kExact ? 1.f : kLog2e) : 0.f;
  }

  const int n_chunks = (n_steps + kSteps - 1) / kSteps;
  stage(st[0], x, dt, b_t, c_t, row0, min(kSteps, n_steps), d0, n_ch, vec);
  mma::cp_async_commit();
  for (int ck = 0; ck < n_chunks; ++ck) {
    const int s0 = ck * kSteps;
    const int steps = min(kSteps, n_steps - s0);
    if (ck + 1 < n_chunks)
      stage(st[(ck + 1) & 1], x, dt, b_t, c_t, row0 + s0 + kSteps,
            min(kSteps, n_steps - s0 - kSteps), d0, n_ch, vec);
    mma::cp_async_commit();  // possibly empty: the wait below counts groups
    mma::cp_async_wait<1>();
    __syncthreads();         // chunk ck has landed for every thread

    const Stage<TX, N>& cur = st[ck & 1];
    TX* yrow = y + (row0 + s0) * n_ch + d;
    auto step = [&](int t) {
      const float dtt = cur.dt[t][j];
      const float dx = __fmul_rn(dtt, to_float(cur.x[t][j]));
      float bv[S], cv[S];
#pragma unroll
      for (int q = 0; q < S / 4; ++q) {
        const float4 b4 = *reinterpret_cast<const float4*>(&cur.b[t][sub * S + 4 * q]);
        const float4 c4 = *reinterpret_cast<const float4*>(&cur.c[t][sub * S + 4 * q]);
        bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y, bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
        cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y, cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
      }
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < S; ++i) {
        if constexpr (kExact)
          h[i] = __fadd_rn(__fmul_rn(expf(__fmul_rn(dtt, a2[i])), h[i]), __fmul_rn(dx, bv[i]));
        else
          h[i] = fmaf(ex2(dtt * a2[i]), h[i], dx * bv[i]);
        acc = fmaf(h[i], cv[i], acc);
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (sub == 0 && live) from_float(yrow + (size_t)t * n_ch, acc);
    };
    if (steps == kSteps) {
#pragma unroll
      for (int t = 0; t < kSteps; ++t) step(t);
    } else {
      for (int t = 0; t < steps; ++t) step(t);
    }
    __syncthreads();  // buffer ck & 1 is staged again at chunk ck + 2
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename TX, int N>
int launch(const void* x, const void* dt, const void* b_t, const void* c_t, const void* a,
           void* y, int n_seq, int n_steps, int n_ch, int lanes, cudaStream_t stream) {
  using P = Split<N>;
  if (lanes != P::kLanes) return -3;  // the host's plan differs from this build
  const bool vec = n_ch % (16 / sizeof(TX)) == 0 && aligned16(x) && aligned16(dt) &&
                   aligned16(b_t) && aligned16(c_t);
  const dim3 grid((n_ch + P::kChannels - 1) / P::kChannels, n_seq);
  ssm_scan_kernel<TX, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(b_t), static_cast<const float*>(c_t),
      static_cast<const float*>(a), static_cast<TX*>(y), n_steps, n_ch, vec);
  return (int)cudaGetLastError();
}

template <typename TX>
int dispatch_n(int n, const void* x, const void* dt, const void* b_t, const void* c_t,
               const void* a, void* y, int n_seq, int n_steps, int n_ch, int lanes,
               cudaStream_t stream) {
  switch (n) {
#define REPRO_N_CASE(V) \
  case V:               \
    return launch<TX, V>(x, dt, b_t, c_t, a, y, n_seq, n_steps, n_ch, lanes, stream)
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

// dtype (of x and y): 0 = float32, 1 = bfloat16; lanes: the lanes a channel
// from ssm_scan.py::ssm_plan.  Returns 0 on success, a cudaError_t when the
// launch was refused, -1 for an unsupported N or dtype, -3 when `lanes` is
// not this build's split of N.
extern "C" int ssm_scan_launch(const void* x, const void* dt, const void* b_t, const void* c_t,
                               const void* a, void* y, int n_seq, int n_steps, int n_ch,
                               int n_state, int lanes, int dtype, void* stream) {
  if (n_seq <= 0 || n_steps <= 0 || n_ch <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::ssm::dispatch_n<float>(n_state, x, dt, b_t, c_t, a, y, n_seq, n_steps, n_ch,
                                         lanes, s);
  if (dtype == 1)
    return repro::ssm::dispatch_n<__nv_bfloat16>(n_state, x, dt, b_t, c_t, a, y, n_seq,
                                                 n_steps, n_ch, lanes, s);
  return -1;
}
