// MoE top-k gating for Hopper (sm_90a): Mixtral's router read-out.
//
//   logits  (T, E)      contiguous, fp32 or bf16
//   idx     (T, K)      int32: the top-K experts of each token, largest first;
//                       the lower expert index wins a tie
//   gates   (T, K)      fp32: softmax over the K chosen logits
//   pos     (T, K)      int32: the slot's arrival rank within its expert,
//                       counted in row-major (token, choice) order over all T
//   counts  (blocks, E) int32 scratch of the grid route: a block's slots an expert
//
// Replaces the Pallas kernel repro/kernels/moe_gating.py::moe_gating, which
// carried a per-expert counter across a sequential grid.
//
// Bound by bytes (each logit is read once, a few operations each), and at a
// forward pass's token counts by the launch itself, so the design keeps what
// lies between the launch and the last store short:
//   - Token order (moe_gating.py::gating_plan sets warps, rounds and blocks):
//     block b holds tokens [b span, (b + 1) span), span = warps * 32 *
//     rounds; warp w the next 32 * rounds of them in turn; lane l in round r
//     the warp's token 32 r + l.
//   - Whole rows in registers: at E 8 (Mixtral's routers) a lane reads its
//     row with 16-byte loads, one in bf16 and two in fp32, every round's
//     loads issued before the first row is used.  At any other E a warp
//     copies its round's 32 rows into shared memory, coalesced, each row
//     padded to an odd stride so the lanes then read them with no bank
//     conflict.  The top K come from one pass over the row into a list of K
//     kept sorted in registers; a strict > keeps a tie on the lower index.
//   - Ranks without serial loops.  For each expert e, __ballot_sync of "one
//     of my K choices is e" and the __popc of the lanes below give a slot its
//     rank in the warp's round (a token names an expert at most once, so the
//     row-major (token, choice) order is the token order), a running sum over
//     the rounds its rank in the warp.  The warps' totals go to shared
//     memory, where one warp-level scan an expert makes them offsets.
//   - Routes.  Up to gating_plan's one-launch limit (16384 tokens at E 8,
//     K <= 4) one launch, no scratch, no memset: one block, or a cluster of
//     up to kMaxCluster blocks on as many SMs, whose blocks read the totals of
//     the blocks before them from their shared memory (Hopper's distributed
//     shared memory) between two cluster barriers.  Past it a grid, whose
//     blocks also write their totals to `counts`, and a second launch in
//     which each block adds the totals of the blocks before its own to its
//     slots' ranks.  The sums are of integers, so the ranks are exact in
//     whatever order the blocks run.
//
// Plain C interface, loaded with ctypes.  The launches go to the stream they
// are given, allocate nothing and do not synchronise.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace moe {

constexpr int kMaxWarps = 32;     // moe_gating.py::MAX_WARPS
constexpr int kRowExperts = 8;    // rows held in registers; moe_gating.py::ROW_EXPERTS
constexpr int kMaxCluster = 8;   // blocks of a one-launch cluster; moe_gating.py::MAX_CLUSTER
constexpr int kFixThreads = 256;

// Rounds a lane may hold (its slots stay in registers across the block's
// scan): moe_gating.py::max_rounds.
template <int K>
__host__ __device__ constexpr int max_rounds() {
  return K <= 4 ? 2 : 1;
}

// The K largest of a row, largest first, pushed in expert order.
template <int K>
struct TopK {
  float val[K];
  int idx[K];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < K; ++j) val[j] = 0.f, idx[j] = -1;
  }
  // The list is sorted, so v beats slot j only if it beats every slot after
  // it: from the last slot up, each beaten slot moves down one and v takes
  // its place.  Strict: an equal value keeps the earlier (lower) expert.
  __device__ __forceinline__ void push(float v, int e) {
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      if (idx[j] < 0 || v > val[j]) {
        if (j + 1 < K) val[j + 1] = val[j], idx[j + 1] = idx[j];
        val[j] = v, idx[j] = e;
      }
    }
  }
};

// Eight logits from their 16-byte words: two of fp32, one of bf16.
template <typename T>
__device__ __forceinline__ void unpack8(const uint4 (&w)[8 * sizeof(T) / 16], float (&v)[8]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      v[4 * q] = __uint_as_float(w[q].x), v[4 * q + 1] = __uint_as_float(w[q].y);
      v[4 * q + 2] = __uint_as_float(w[q].z), v[4 * q + 3] = __uint_as_float(w[q].w);
    }
  } else {
    const uint32_t u[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i)  // the lower half of a word is the earlier value
      v[2 * i] = __uint_as_float(u[i] << 16), v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ int2 pair(int a, int b) { return make_int2(a, b); }
__device__ __forceinline__ float2 pair(float a, float b) { return make_float2(a, b); }

// A token's K values, two at a time where K is even.
template <int K, typename V>
__device__ __forceinline__ void store_row(V* p, const V (&v)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2)
      *reinterpret_cast<decltype(pair(v[0], v[0]))*>(p + j) = pair(v[j], v[j + 1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = v[j];
  }
}

// The K choices of token t (or -1 where it is past n_tok), its idx and gates
// written at once.
template <int K>
__device__ __forceinline__ void settle(const TopK<K>& top, bool live, int t, int (&sel)[K],
                                       int* __restrict__ idx, float* __restrict__ gates) {
#pragma unroll
  for (int j = 0; j < K; ++j) sel[j] = live ? top.idx[j] : -1;
  if (!live) return;
  float g[K], sum = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    g[j] = expf(top.val[j] - top.val[0]);
    sum += g[j];
  }
#pragma unroll
  for (int j = 0; j < K; ++j) g[j] /= sum;
  store_row<K>(idx + (size_t)t * K, top.idx);
  store_row<K>(gates + (size_t)t * K, g);
}

template <typename T, int K, bool kRows>
__global__ void __launch_bounds__(kMaxWarps * 32)
gating_kernel(const T* __restrict__ logits, int n_tok, int n_exp, int rounds,
              int* __restrict__ idx, float* __restrict__ gates, int* __restrict__ pos,
              int* __restrict__ counts) {
  constexpr int R = max_rounds<K>();
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int E = kRows ? kRowExperts : n_exp;
  int* cnt = reinterpret_cast<int*>(smem);  // (E, warps): a warp's slots of e, then its offset
  int* tot = cnt + n_exp * warps;           // (E): the block's slots of e
  int* base = tot + n_exp;                  // (E): the cluster's earlier blocks' slots of e
  const long long tok_w = (long long)blockIdx.x * warps * 32 * rounds + (long long)w * 32 * rounds;
  const unsigned below = (1u << lane) - 1u;

  int sel[R][K], rank[R][K];
  if constexpr (kRows) {
    constexpr int V = 8 * sizeof(T) / 16;
    uint4 raw[R][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long t = tok_w + 32 * r + lane;
      if (r < rounds && t < n_tok) {
        const uint4* row = reinterpret_cast<const uint4*>(logits + t * kRowExperts);
#pragma unroll
        for (int q = 0; q < V; ++q) raw[r][q] = __ldg(row + q);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long t = tok_w + 32 * r + lane;
      const bool live = r < rounds && t < n_tok;
      TopK<K> top;
      top.clear();
      if (live) {
        float v[8];
        unpack8<T>(raw[r], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) top.push(v[e], e);
      }
      settle<K>(top, live, (int)t, sel[r], idx, gates);
    }
  } else {
    const int stride = n_exp | 1;
    float* buf = smem + n_exp * (warps + 2) + (size_t)w * 32 * stride;  // (32, stride)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long t0 = tok_w + 32 * r;
      const int n_rows = r < rounds ? (int)max(0LL, min(32LL, n_tok - t0)) : 0;
      TopK<K> top;
      top.clear();
      if (n_rows > 0) {  // uniform in the warp
        const T* src = logits + t0 * n_exp;
        for (int g = lane; g < n_rows * n_exp; g += 32)
          buf[(g / n_exp) * stride + g % n_exp] = to_float(src[g]);
        __syncwarp();
        if (lane < n_rows)
          for (int e = 0; e < n_exp; ++e) top.push(buf[lane * stride + e], e);
        __syncwarp();  // the next round refills buf
      }
      settle<K>(top, lane < n_rows, (int)(t0 + lane), sel[r], idx, gates);
    }
  }

  // Ranks in the warp, expert by expert; the warp's totals to cnt.
  for (int e = 0; e < E; ++e) {
    int run = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool hit = false;
#pragma unroll
      for (int j = 0; j < K; ++j) hit |= sel[r][j] == e;
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      const int before = run + __popc(m & below);
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (sel[r][j] == e) rank[r][j] = before;
      run += __popc(m);
    }
    if (lane == 0) cnt[e * warps + w] = run;
  }
  __syncthreads();
  // One scan over the warps an expert: totals -> offsets; the block's total
  // to counts on the grid route.
  for (int e = w; e < E; e += warps) {
    const int c = lane < warps ? cnt[e * warps + lane] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < warps) cnt[e * warps + lane] = incl - c;
    if (lane == 31) tot[e] = incl;
    if (counts != nullptr && lane == 31) counts[(size_t)blockIdx.x * E + e] = incl;
  }
  // In a cluster, the earlier blocks' totals read from their shared memory.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  if (cluster.num_blocks() > 1) {
    cluster.sync();  // every block's totals are in place
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
      int o = 0;
      for (int r = 0; r < crank; ++r) o += cluster.map_shared_rank(tot, r)[e];
      base[e] = o;
    }
    cluster.sync();  // no block leaves while another reads its totals
  } else {
    __syncthreads();
    for (int e = threadIdx.x; e < E; e += blockDim.x) base[e] = 0;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long t = tok_w + 32 * r + lane;
    if (r < rounds && t < n_tok) {
      int p[K];
#pragma unroll
      for (int j = 0; j < K; ++j) p[j] = base[sel[r][j]] + cnt[sel[r][j] * warps + w] + rank[r][j];
      store_row<K>(pos + t * K, p);
    }
  }
}

// The grid route's second launch: block b adds, to the ranks of its source
// block's slots, the slots each expert got in blocks 0 .. b - 1.
__global__ void __launch_bounds__(kFixThreads)
add_block_offsets(const int* __restrict__ counts, int n_exp, long long span, int n_tok, int k,
                  const int* __restrict__ idx, int* __restrict__ pos) {
  extern __shared__ int off[];  // (E)
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int e = tid; e < n_exp; e += kFixThreads) off[e] = 0;
  __syncthreads();
  const int groups = kFixThreads / n_exp;  // >= 1: E <= 256
  if (tid < groups * n_exp) {
    const int e = tid % n_exp;
    int s = 0;
    for (int bb = tid / n_exp; bb < b; bb += groups) s += counts[(size_t)bb * n_exp + e];
    if (s) atomicAdd(&off[e], s);
  }
  __syncthreads();
  const long long first = b * span * k;
  const long long n_slots = (min((long long)n_tok, (b + 1) * span) - b * span) * k;
  for (long long i = tid; i < n_slots; i += kFixThreads) pos[first + i] += off[idx[first + i]];
}

template <typename T, int K, bool kRows>
int launch(const void* logits, void* idx, void* gates, void* pos, void* counts, int n_tok,
           int n_exp, int warps, int rounds, int blocks, cudaStream_t stream) {
  // the host's plan must be one this build can run
  const long long span = (long long)warps * 32 * rounds;
  if (warps < 1 || warps > kMaxWarps || rounds < 1 || rounds > max_rounds<K>() ||
      blocks < 1 || (blocks - 1) * span >= n_tok || blocks * span < n_tok ||
      (counts == nullptr && blocks > kMaxCluster))
    return -3;
  if (kRows && (n_exp != kRowExperts || reinterpret_cast<uintptr_t>(logits) % 16)) return -3;
  const size_t smem =
      sizeof(float) * ((size_t)n_exp * (warps + 2) + (kRows ? 0 : (size_t)warps * 32 * (n_exp | 1)));
  auto kernel = gating_kernel<T, K, kRows>;
  if (smem > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  // One launch: the blocks as one cluster (no counts); the grid route: plain
  // blocks, then the offsets launch.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = counts == nullptr ? blocks : 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int rc = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(logits), n_tok, n_exp,
                                   rounds, static_cast<int*>(idx), static_cast<float*>(gates),
                                   static_cast<int*>(pos), static_cast<int*>(counts));
  if (rc == 0) rc = (int)cudaGetLastError();
  if (rc != 0 || counts == nullptr) return rc;
  add_block_offsets<<<blocks, kFixThreads, sizeof(int) * n_exp, stream>>>(
      static_cast<const int*>(counts), n_exp, span, n_tok, K, static_cast<const int*>(idx),
      static_cast<int*>(pos));
  return (int)cudaGetLastError();
}

template <typename T, bool kRows>
int dispatch_k(int k, const void* logits, void* idx, void* gates, void* pos, void* counts,
               int n_tok, int n_exp, int warps, int rounds, int blocks, cudaStream_t stream) {
  switch (k) {
#define REPRO_K_CASE(N) \
  case N:               \
    return launch<T, N, kRows>(logits, idx, gates, pos, counts, n_tok, n_exp, warps, rounds, \
                               blocks, stream)
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

template <typename T>
int dispatch_rows(int rows_in_registers, int k, const void* logits, void* idx, void* gates,
                  void* pos, void* counts, int n_tok, int n_exp, int warps, int rounds,
                  int blocks, cudaStream_t stream) {
  return rows_in_registers
             ? dispatch_k<T, true>(k, logits, idx, gates, pos, counts, n_tok, n_exp, warps,
                                   rounds, blocks, stream)
             : dispatch_k<T, false>(k, logits, idx, gates, pos, counts, n_tok, n_exp, warps,
                                    rounds, blocks, stream);
}

}  // namespace moe
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  rows_in_registers, warps, rounds and
// blocks: moe_gating.py::gating_plan; counts: (blocks, E) int32 scratch on
// the grid route, else null (one launch, the blocks as one cluster).  Returns 0 on success, a cudaError_t when a launch
// was refused, -1 for an unsupported k or dtype, -2 for more experts than the
// kernel takes (E <= 256), -3 for a plan this build cannot run.
extern "C" int moe_gating_launch(const void* logits, void* idx, void* gates, void* pos,
                                 void* counts, int n_tok, int n_exp, int k, int dtype,
                                 int rows_in_registers, int warps, int rounds, int blocks,
                                 void* stream) {
  if (n_tok <= 0) return 0;
  if (n_exp < 1 || n_exp > 256) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::moe::dispatch_rows<float>(rows_in_registers, k, logits, idx, gates, pos,
                                            counts, n_tok, n_exp, warps, rounds, blocks, s);
  if (dtype == 1)
    return repro::moe::dispatch_rows<__nv_bfloat16>(rows_in_registers, k, logits, idx, gates,
                                                    pos, counts, n_tok, n_exp, warps, rounds,
                                                    blocks, s);
  return -1;
}
