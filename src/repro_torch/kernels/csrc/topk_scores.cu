// Blocked top-k of a score vector for Hopper (sm_90a): ORDER BY ... LIMIT K
// over pointwise scores.
//
//   scores   (N,)      contiguous, fp32 or bf16, read in fp32
//   scratch  (2 m + ceil(m / kMergeRun) k) u64, m = nb k candidates (nb tiles):
//            sort keys of the candidates, sort keys a merge block hands on,
//            then the candidates' values (fp32) and indices (int32)
//   out_v    (K,) fp32   the K largest candidates, largest first
//   out_i    (K,) int32  their indices into scores
//
// Replaces the Pallas kernel repro/kernels/topk_scores.py::topk_scores and
// the final lax.top_k of repro/kernels/ops.py::topk_scores: both stages of
// the function run here, in two or three launches on one stream.
//
// The function.  Each tile of BN slots (slots >= N hold -3e38, the
// reference's NEG_INF) hands on K candidates: K rounds of arg-max (the larger
// value, on equal values the lower index; a NaN ranks above every number, as
// jnp.argmax ranks it), each winner overwritten with -3e38.  The K largest
// candidates by (value desc, candidate position asc) are the result, which is
// lax.top_k's order.  Ranks are compared as int keys (key_of), which order
// NaN first and -0 with +0.
//
// Stage 1, one block per tile: the tile's (rank key, slot) pairs, as 64-bit
// sort keys, go to shared memory once; a radix select (block_top) finds the
// tile's best min(K, BN) of them and sorts only those.  The first K rounds
// take the slots above -3e38 in that order.  Once they run out, the masking
// gives each remaining round in closed form: the lowest slot holding -3e38
// (a masked winner, padding or a score of exactly -3e38) wins with -3e38,
// every round again; in a tile with no such slot (every score below -3e38,
// say -inf) round 0 takes the best score and later rounds its slot again,
// masked to -3e38.  That is the reference's padding quirk, kept.
//
// Stage 2 keeps the K best of the m candidates by 64-bit sort keys (rank
// desc, position asc).  One launch of one block does it when m <=
// kMergeSlots; otherwise a grid of blocks each keeps the top K of a run of at
// least kMergeRun candidates, and one block keeps the top K of their
// survivors.  A block fills a buffer of kMergeSlots keys, keeps its top K
// (block_top) and refills the rest until its run is spent.
//
// The function is bound by bytes: each score is read once.  A radix select
// reads a block's keys once a byte of the K-th key it settles (at most 8
// passes, usually 3 or 4), where the first design ran K rounds of block
// arg-max a tile and then K rounds over all m candidates in one block.  The
// TPU kernel's (8, bn/8) VMEM tile becomes a shared-memory tile per block;
// its sequential grid becomes a grid of independent blocks.
//
// Plain C interface, loaded with ctypes.  The launches go to the stream they
// are given, allocate nothing and do not synchronise.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "scalar.cuh"

namespace repro {
namespace topk {

using u64 = unsigned long long;

constexpr float kNegInf = -3.0e38f;  // the reference's NEG_INF
constexpr u64 kNone = ~0ull;         // an empty slot: sorts after every key
constexpr int kMaxTile = 8192;       // MAX_BLOCK_N of the wrapper
constexpr int kMaxK = 1024;          // MAX_K of the wrapper
constexpr int kMergeSlots = 4096;    // a merge block's buffer of sort keys
constexpr int kMergeRun = 2048;      // the least candidates a merge block takes
constexpr int kTileThreads = 256;
constexpr int kMergeThreads = 512;

// A value's rank as an int: larger values give larger keys, -0 and +0 one
// key (they are equal), and every NaN the largest key, above +inf.
__device__ __forceinline__ int key_of(float v) {
  if (isnan(v)) return INT_MAX;
  int b = __float_as_int(v);
  if (b == INT_MIN) b = 0;                 // -0 ranks as +0
  return b >= 0 ? b : b ^ 0x7fffffff;      // negatives: a larger magnitude ranks lower
}

// Ascending sort keys give rank descending, then pos ascending.
__device__ __forceinline__ u64 sort_key(int key, uint32_t pos) {
  return ((u64)(~((uint32_t)key ^ 0x80000000u)) << 32) | pos;
}

__device__ __forceinline__ int rank_of(u64 c) {
  return (int)(~(uint32_t)(c >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ uint32_t pos_of(u64 c) { return (uint32_t)c; }

// Sort s[0, p) ascending, p a power of two; all threads of the block call
// it, and it ends with a barrier.  Compare-exchange t of a stage touches
// s[i] and s[i + stride], i = 2 t - t % stride, so at strides up to 32 a
// warp's 32 exchanges stay inside one 64-key segment, the same one at every
// stage: between two such stages the warp's own barrier is enough.
__device__ void bitonic_sort(u64* s, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const u64 a = s[i], b = s[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          s[i] = b;
          s[i + stride] = a;
        }
      }
      const int next = stride > 1 ? stride >> 1 : size;  // the next stage's stride
      if (stride <= 32 && next <= 32)
        __syncwarp();
      else
        __syncthreads();
    }
  }
  __syncthreads();
}

// Shared-memory scratch of block_top: a histogram, the selected keys, and
// the scan's results.
struct SelectSmem {
  int hist[256];
  u64 sel[kMaxK];
  int digit, rem, done, count;
};

// Leaves the min(k, n) smallest keys of s[0, n) (distinct, or repeats of
// kNone only past the k smallest), sorted, in s[0, min(k, n)); returns
// min(k, n).  Radix select from the top byte: a pass counts the keys that
// share the prefix found so far by their next byte (one atomic per group of
// lanes with the same byte), one warp finds the byte the k-th smallest has,
// and the search stops once that byte's keys are exactly the ones still
// wanted.  The keys below the prefix, and those with it, are then gathered
// and sorted.  All threads of the block call it; it ends with a barrier.
__device__ int block_top(u64* s, int n, int k, SelectSmem& sm) {
  const int lane = threadIdx.x & 31;
  const int want = min(k, n);
  u64 prefix = 0;
  int depth = 0;  // bytes of the prefix
  bool done = want == n;
  int rem = want;
  while (!done) {
    const int shift = 56 - 8 * depth;
    for (int i = threadIdx.x; i < 256; i += blockDim.x) sm.hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {  // whole warps take each step
      const int i = i0 + threadIdx.x;
      int d = -1;
      if (i < n) {
        const u64 c = s[i];
        if (depth == 0 || (c >> (shift + 8)) == prefix) d = (int)((c >> shift) & 255);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&sm.hist[d], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // lane l scans bytes 8 l .. 8 l + 7
      int own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += sm.hist[8 * lane + j];
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += x;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= rem);
      if (lane == __ffs(hit) - 1) {
        int before = incl - own, d = 8 * lane;
        while (before + sm.hist[d] < rem) before += sm.hist[d++];
        sm.digit = d;
        sm.rem = rem - before;
        sm.done = sm.hist[d] == rem - before;
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | (u64)sm.digit;
    rem = sm.rem;
    done = sm.done;
    ++depth;
    __syncthreads();  // hist and the results are rewritten by the next pass
  }

  // gather the keys below or at the prefix: exactly want of them
  if (threadIdx.x == 0) sm.count = 0;
  __syncthreads();
  const int shift = 64 - 8 * depth;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool take = i < n && (depth == 0 || (s[i] >> shift) <= prefix);
    const unsigned ballot = __ballot_sync(0xffffffffu, take);
    int base = 0;
    if (lane == 0 && ballot) base = atomicAdd(&sm.count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (take) sm.sel[base + __popc(ballot & ((1u << lane) - 1))] = s[i];
  }
  __syncthreads();
  int p = 1;
  while (p < want) p <<= 1;
  for (int i = want + threadIdx.x; i < p; i += blockDim.x) sm.sel[i] = kNone;
  __syncthreads();
  bitonic_sort(sm.sel, p);
  for (int i = threadIdx.x; i < want; i += blockDim.x) s[i] = sm.sel[i];
  __syncthreads();
  return want;
}

// Stage 1: the tile's K candidates, exactly as the reference's K rounds
// give them.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_topk_kernel(const T* __restrict__ scores, int n, int bn, int k, u64* __restrict__ cand_c,
                 float* __restrict__ cand_v, int* __restrict__ cand_i) {
  extern __shared__ u64 keys[];  // (bn)
  __shared__ SelectSmem sm;
  __shared__ unsigned first_neg;  // lowest slot at or above -3e38, once A runs out
  const int neg_key = key_of(kNegInf);
  const long long base = (long long)blockIdx.x * bn;
  if (threadIdx.x == 0) first_neg = UINT_MAX;
  __syncthreads();
  unsigned low = UINT_MAX;
  for (int j0 = 0; j0 < bn; j0 += blockDim.x) {  // whole warps take each step
    const int j = j0 + threadIdx.x;
    if (j < bn) {
      const float v = base + j < n ? to_float(scores[base + j]) : kNegInf;
      const int key = key_of(v);
      keys[j] = sort_key(key, (uint32_t)j);
      if (key >= neg_key) low = min(low, (unsigned)j);
    }
  }
  low = __reduce_min_sync(0xffffffffu, low);
  if ((threadIdx.x & 31) == 0 && low != UINT_MAX) atomicMin(&first_neg, low);
  __syncthreads();
  const int got = block_top(keys, bn, k, sm);  // the tile's best min(k, bn), sorted

  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const long long pos = (long long)blockIdx.x * k + r;
    const u64 c = r < got ? keys[r] : kNone;
    long long idx;
    float v;
    if (c != kNone && rank_of(c) > neg_key) {  // round r takes the r-th best slot
      idx = base + pos_of(c);
      v = to_float(scores[idx]);
    } else if (first_neg != UINT_MAX) {        // the lowest -3e38 slot, every round
      idx = base + first_neg;
      v = kNegInf;
    } else {                                   // all below -3e38: the best, then its slot
      idx = base + pos_of(keys[0]);
      v = r == 0 ? to_float(scores[idx]) : kNegInf;
    }
    cand_c[pos] = sort_key(key_of(v), (uint32_t)pos);
    cand_v[pos] = v;
    cand_i[pos] = (int)idx;
  }
}

// Stage 2: the top k of in[run start, run end) by sort key.  With one block
// this is the result, looked up in cand_v / cand_i; with more, each block's
// k survivors go to part (kNone where its run held fewer than k).
__global__ void __launch_bounds__(kMergeThreads)
merge_topk_kernel(const u64* __restrict__ in, long long m, int k, long long run,
                  u64* __restrict__ part, const float* __restrict__ cand_v,
                  const int* __restrict__ cand_i, float* __restrict__ out_v,
                  int* __restrict__ out_i) {
  __shared__ u64 buf[kMergeSlots];
  __shared__ SelectSmem sm;
  const long long lo = blockIdx.x * run, hi = min(m, lo + run);
  int kept = 0;
  for (long long c0 = lo; c0 < hi;) {
    const int take = (int)min((long long)(kMergeSlots - kept), hi - c0);
    for (int j = threadIdx.x; j < take; j += blockDim.x) buf[kept + j] = in[c0 + j];
    __syncthreads();
    kept = block_top(buf, kept + take, k, sm);
    c0 += take;
  }
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    if (gridDim.x == 1) {
      const uint32_t pos = pos_of(buf[r]);
      out_v[r] = cand_v[pos];
      out_i[r] = cand_i[pos];
    } else {
      part[(long long)blockIdx.x * k + r] = r < kept ? buf[r] : kNone;
    }
  }
}

template <typename T>
int launch(const void* scores, int n, int k, int bn, void* scratch, void* out_v, void* out_i,
           cudaStream_t stream) {
  const int nb = (n + bn - 1) / bn;
  const long long m = (long long)nb * k;
  const long long n_parts = (m + kMergeRun - 1) / kMergeRun * k;
  u64* cand_c = static_cast<u64*>(scratch);
  u64* part = cand_c + m;
  float* cand_v = reinterpret_cast<float*>(part + n_parts);
  int* cand_i = reinterpret_cast<int*>(cand_v + m);

  const size_t smem = sizeof(u64) * bn;  // 64 KB at the largest tile
  auto tile = tile_topk_kernel<T>;
  if (smem + sizeof(SelectSmem) + 64 > 48 * 1024) {  // past the default, static part included
    cudaError_t e =
        cudaFuncSetAttribute(tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tile<<<nb, kTileThreads, smem, stream>>>(static_cast<const T*>(scores), n, bn, k, cand_c,
                                           cand_v, cand_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const u64* in = cand_c;
  long long n_in = m;
  if (m > kMergeSlots) {  // a grid of runs first, balanced against the last block's merge
    long long run = kMergeRun;
    while (run * run < m * k) run <<= 1;
    const long long n_runs = (m + run - 1) / run;
    merge_topk_kernel<<<(unsigned)n_runs, kMergeThreads, 0, stream>>>(
        cand_c, m, k, run, part, cand_v, cand_i, nullptr, nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    in = part;
    n_in = n_runs * k;
  }
  merge_topk_kernel<<<1, kMergeThreads, 0, stream>>>(in, n_in, k, n_in, nullptr, cand_v,
                                                     cand_i, static_cast<float*>(out_v),
                                                     static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace topk
}  // namespace repro

// dtype: 0 = float32, 1 = bfloat16.  bn is the tile the caller computed as
// the reference does; scratch holds 2 m + ceil(m / 2048) k u64, m =
// ceil(n / bn) k.  Returns 0 on success, a cudaError_t when a launch was
// refused, -1 for an unsupported dtype, -2 for sizes out of range.
extern "C" int topk_scores_launch(const void* scores, int n, int k, int bn, void* scratch,
                                  void* out_v, void* out_i, int dtype, void* stream) {
  if (n < 1 || k < 1 || k > 1024 || bn < 1 || bn > repro::topk::kMaxTile) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return repro::topk::launch<float>(scores, n, k, bn, scratch, out_v, out_i, s);
  if (dtype == 1)
    return repro::topk::launch<__nv_bfloat16>(scores, n, k, bn, scratch, out_v, out_i, s);
  return -1;
}
