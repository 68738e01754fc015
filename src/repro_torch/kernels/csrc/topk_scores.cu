// Blocked top-k of a score vector for Hopper (sm_90a): ORDER BY ... LIMIT K
// over pointwise scores.
//
//   scores  (N,)           contiguous, fp32 or bf16, read in fp32
//   cand_v  (nb, K) fp32   scratch: each tile's K candidates, stage 1
//   cand_k  (nb, K) int32  scratch: their ranks as keys (key_of)
//   cand_i  (nb, K) int32  scratch: their global indices
//   out_v   (K,)    fp32   the K largest candidates, largest first
//   out_i   (K,)    int32  their indices into scores
//
// Replaces the Pallas kernel repro/kernels/topk_scores.py::topk_scores and
// the final lax.top_k of repro/kernels/ops.py::topk_scores: both stages of
// the function run here, in two launches on one stream.
//
// Stage 1, one block per tile of BN slots (slots >= N hold -3e38, the
// reference's NEG_INF): K rounds of a block-wide arg-max over (value, index)
// pairs, warp shuffles then one warp over the warps' winners.  The larger
// value wins and on equal values the lower index, which is jnp.argmax's
// rule; a NaN ranks above every number, as in jnp.argmax and torch.sort
// (what a diverged model's scores hold).  Ranks are compared as int keys
// (key_of), which order NaN first without a branch.  The winner is then overwritten with -3e38 in shared memory, exactly
// as the reference masks it, so a masked slot can win a later round (the
// reference's padding quirk, kept).
//
// Stage 2, one block over the nb*K candidates in their stage-1 order: K
// rounds, each taking the best candidate that comes after the previous
// round's winner in the order (value descending, position ascending).  That
// is lax.top_k, whose ties go to the lower candidate position, and it reads
// the candidates without changing them.
//
// The function is bound by bytes: each score is read once.  The K rounds of
// block reductions with barriers make the kernel latency-bound well above
// that.  The TPU kernel's (8, bn/8) VMEM tile becomes a shared-memory tile
// per block; its sequential grid becomes a grid of independent blocks.
//
// Plain C interface, loaded with ctypes.  The launches go to the stream they
// are given, allocate nothing and do not synchronise.

#include <climits>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace topk {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -3.0e38f;  // the reference's NEG_INF

// A value's rank as an int: larger values give larger keys, -0 and +0 one
// key (they are equal), and every NaN the largest key, above +inf.
__device__ __forceinline__ int key_of(float v) {
  if (isnan(v)) return INT_MAX;
  int b = __float_as_int(v);
  if (b == INT_MIN) b = 0;                 // -0 ranks as +0
  return b >= 0 ? b : b ^ 0x7fffffff;      // negatives: a larger magnitude ranks lower
}

// (key, i) ranks before (bkey, bi): the larger key, then the lower index.  An
// empty slot is (INT_MIN, INT_MAX), below every value's key.
constexpr int kNoKey = INT_MIN;
__device__ __forceinline__ bool before(int key, int i, int bkey, int bi) {
  return key > bkey || (key == bkey && i < bi);
}

// Block-wide arg-max of each thread's (key, i); every thread gets the winner.
__device__ __forceinline__ void block_argmax(int& key, int& i, int* sk, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ok = __shfl_down_sync(0xffffffffu, key, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (before(ok, oi, key, i)) {
      key = ok;
      i = oi;
    }
  }
  if (lane == 0) {
    sk[warp] = key;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    key = lane < n_warps ? sk[lane] : kNoKey;
    i = lane < n_warps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ok = __shfl_down_sync(0xffffffffu, key, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (before(ok, oi, key, i)) {
        key = ok;
        i = oi;
      }
    }
    if (lane == 0) {
      sk[kWarps] = key;
      si[kWarps] = i;
    }
  }
  __syncthreads();
  key = sk[kWarps];
  i = si[kWarps];
  __syncthreads();  // sk / si are reused by the next round
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_topk_kernel(const T* __restrict__ scores, int n, int bn, int k,
                 float* __restrict__ cand_v, int* __restrict__ cand_k,
                 int* __restrict__ cand_i) {
  extern __shared__ float tile[];  // (bn)
  __shared__ int sk[kWarps + 1];
  __shared__ int si[kWarps + 1];
  const long long base = (long long)blockIdx.x * bn;
  for (int j = threadIdx.x; j < bn; j += blockDim.x) {
    const long long g = base + j;
    tile[j] = g < n ? to_float(scores[g]) : kNegInf;
  }
  __syncthreads();
  for (int r = 0; r < k; ++r) {
    int key = kNoKey, i = INT_MAX;
    for (int j = threadIdx.x; j < bn; j += blockDim.x) {
      const int kj = key_of(tile[j]);
      if (before(kj, j, key, i)) {
        key = kj;
        i = j;
      }
    }
    block_argmax(key, i, sk, si);
    if (threadIdx.x == 0) {
      const long long c = (long long)blockIdx.x * k + r;
      cand_v[c] = tile[i];
      cand_k[c] = key;
      cand_i[c] = (int)(base + i);
      tile[i] = kNegInf;  // mask the winner, as the reference does
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
merge_topk_kernel(const float* __restrict__ cand_v, const int* __restrict__ cand_k,
                  const int* __restrict__ cand_i, int m, int k, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  __shared__ int sk[kWarps + 1];
  __shared__ int si[kWarps + 1];
  int pk = INT_MAX, pp = -1;  // the previous round's winner; none yet
  for (int r = 0; r < k; ++r) {
    int key = kNoKey, p = INT_MAX;
    for (int q = threadIdx.x; q < m; q += blockDim.x) {
      const int kq = cand_k[q];
      const bool after_prev = r == 0 || before(pk, pp, kq, q);
      if (after_prev && before(kq, q, key, p)) {
        key = kq;
        p = q;
      }
    }
    block_argmax(key, p, sk, si);
    if (threadIdx.x == 0) {
      out_v[r] = cand_v[p];
      out_i[r] = cand_i[p];
    }
    pk = key;
    pp = p;
  }
}

template <typename T>
int launch(const void* scores, int n, int k, int bn, void* cand_v, void* cand_k,
           void* cand_i, void* out_v, void* out_i, cudaStream_t stream) {
  const int n_blocks = (n + bn - 1) / bn;
  const int threads = bn >= kThreads ? kThreads : ((bn + 31) / 32) * 32;
  const size_t smem = sizeof(float) * (size_t)bn;  // bn <= 8192: 32 KB at most
  tile_topk_kernel<T><<<n_blocks, threads, smem, stream>>>(
      static_cast<const T*>(scores), n, bn, k, static_cast<float*>(cand_v),
      static_cast<int*>(cand_k), static_cast<int*>(cand_i));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_topk_kernel<<<1, kThreads, 0, stream>>>(
      static_cast<const float*>(cand_v), static_cast<const int*>(cand_k),
      static_cast<const int*>(cand_i), n_blocks * k, k, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace topk
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  bn is the tile the caller computed as
// the reference does; cand_v / cand_k / cand_i hold ceil(n / bn) * k entries.
// Returns 0 on success, a cudaError_t when a launch was refused, -1 for an
// unsupported dtype, -2 for sizes out of range.
extern "C" int topk_scores_launch(const void* scores, int n, int k, int bn, void* cand_v,
                                  void* cand_k, void* cand_i, void* out_v, void* out_i,
                                  int dtype, void* stream) {
  if (n < 1 || k < 1 || bn < 1 || bn > 8192) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::topk::launch<float>(scores, n, k, bn, cand_v, cand_k, cand_i, out_v, out_i,
                                      s);
  if (dtype == 1)
    return repro::topk::launch<__nv_bfloat16>(scores, n, k, bn, cand_v, cand_k, cand_i,
                                              out_v, out_i, s);
  return -1;
}
