// MoE top-k gating for Hopper (sm_90a): Mixtral's router read-out.
//
//   logits  (T, E)     contiguous, fp32 or bf16
//   idx     (T, K)     int32: the top-K experts of each token, largest first;
//                      the lower expert index wins a tie
//   gates   (T, K)     fp32: softmax over the K chosen logits
//   pos     (T, K)     int32: the slot's arrival rank within its expert,
//                      counted in row-major (token, choice) order over all T
//
// Replaces the Pallas kernel repro/kernels/moe_gating.py::moe_gating, which
// carried a per-expert counter across a sequential grid.  Blocks of a CUDA
// grid run in no order and see none of each other's counts, and atomics
// would give ranks in the order blocks happen to run, while pos must equal
// the reference exactly.  So ONE block walks the tokens in tiles of
// kThreads, one token a thread:
//   1. top-K by K rounds of max-and-mask over the token's E logits;
//   2. for each expert e, an exclusive prefix sum over the tile's threads of
//      "how many of my K choices are e" (warp shuffles, then one running sum
//      over the warps per expert, in shared memory), plus the count of e in
//      all earlier tiles, carried in shared memory like the TPU's scratch.
// The function is bound by bytes (each logit is read once, a few operations
// each), and at the token counts of a forward pass (T in the thousands, a
// few tiles) the single block runs for a few microseconds: launch-bound.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given, allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace moe {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
moe_gating_kernel(const T* __restrict__ logits, int n_tok, int n_exp, int* __restrict__ idx,
                  float* __restrict__ gates, int* __restrict__ pos) {
  extern __shared__ int smem[];
  int* seen = smem;               // (E): slots given to expert e by earlier tiles
  int* warp_off = smem + n_exp;   // (E, kWarps): a warp's count of e, then its offset
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int e = tid; e < n_exp; e += kThreads) seen[e] = 0;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += kThreads) {
    const int t = t0 + tid;
    const bool live = t < n_tok;
    int my_idx[K];
    float my_val[K];
    int my_rank[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      my_idx[j] = -1;
      my_val[j] = 0.f;
      my_rank[j] = 0;
    }
    if (live) {
      const T* row = logits + (size_t)t * n_exp;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        int best = -1;
        float best_v = 0.f;
        for (int e = 0; e < n_exp; ++e) {
          bool taken = false;
#pragma unroll
          for (int jj = 0; jj < j; ++jj) taken |= my_idx[jj] == e;
          if (taken) continue;
          const float v = to_float(row[e]);
          if (best < 0 || v > best_v) {  // strict: the lower index keeps a tie
            best = e;
            best_v = v;
          }
        }
        my_idx[j] = best;
        my_val[j] = best_v;
      }
    }

    // rank within the tile: per expert, an exclusive scan over the threads
    for (int e = 0; e < n_exp; ++e) {
      int c = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) c += my_idx[j] == e;
      int incl = c;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
      }
      if (lane == 31) warp_off[e * kWarps + warp] = incl;
      // a token names an expert at most once, so one slot gets the rank
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (my_idx[j] == e) my_rank[j] = incl - c;
    }
    __syncthreads();
    // per expert: the warps' counts become offsets, the carry grows
    for (int e = tid; e < n_exp; e += kThreads) {
      int run = seen[e];
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_off[e * kWarps + w];
        warp_off[e * kWarps + w] = run;
        run += c;
      }
      seen[e] = run;
    }
    __syncthreads();

    if (live) {
      float ex[K], sum = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        ex[j] = expf(my_val[j] - my_val[0]);
        sum += ex[j];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const size_t o = (size_t)t * K + j;
        idx[o] = my_idx[j];
        gates[o] = ex[j] / sum;
        pos[o] = warp_off[my_idx[j] * kWarps + warp] + my_rank[j];
      }
    }
    __syncthreads();  // warp_off is rewritten by the next tile
  }
}

template <typename T, int K>
int launch(const void* logits, void* idx, void* gates, void* pos, int n_tok, int n_exp,
           cudaStream_t stream) {
  const size_t smem = sizeof(int) * (size_t)n_exp * (1 + kWarps);
  moe_gating_kernel<T, K><<<1, kThreads, smem, stream>>>(
      static_cast<const T*>(logits), n_tok, n_exp, static_cast<int*>(idx),
      static_cast<float*>(gates), static_cast<int*>(pos));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(int k, const void* logits, void* idx, void* gates, void* pos, int n_tok,
               int n_exp, cudaStream_t stream) {
  switch (k) {
#define REPRO_K_CASE(N) \
  case N:               \
    return launch<T, N>(logits, idx, gates, pos, n_tok, n_exp, stream)
    REPRO_K_CASE(1);
    REPRO_K_CASE(2);
    REPRO_K_CASE(3);
    REPRO_K_CASE(4);
    REPRO_K_CASE(5);
    REPRO_K_CASE(6);
    REPRO_K_CASE(7);
    REPRO_K_CASE(8);
#undef REPRO_K_CASE
    default:
      return -1;
  }
}

}  // namespace moe
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  Returns 0 on success, a cudaError_t when
// the launch was refused, -1 for an unsupported k or dtype, -2 for more
// experts than the shared counters hold (E <= 256).
extern "C" int moe_gating_launch(const void* logits, void* idx, void* gates, void* pos,
                                 int n_tok, int n_exp, int k, int dtype, void* stream) {
  if (n_tok <= 0) return 0;
  if (n_exp < 1 || n_exp > 256) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::moe::dispatch_k<float>(k, logits, idx, gates, pos, n_tok, n_exp, s);
  if (dtype == 1)
    return repro::moe::dispatch_k<__nv_bfloat16>(k, logits, idx, gates, pos, n_tok, n_exp, s);
  return -1;
}
