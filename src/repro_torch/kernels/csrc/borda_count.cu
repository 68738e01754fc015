// Borda-count consensus points for Hopper (sm_90a): the optimizer's
// pessimistic selection aggregates candidate rankings into a gold ranking.
//
//   ballots  (R, S)       contiguous int32 item ids; -1 pads a short ballot
//   points   (n_items,)   fp32: slot p of a ballot is worth S - p to its item
//   partial  (slot_blocks, n_items) 64-bit counts of the grid route's blocks
//
// Replaces the Pallas kernel repro/kernels/borda_count.py::borda_count.  The
// TPU has no scatter atomics, so it recast the sum as a one-hot matrix
// product per item block.  Hopper has them in shared memory: a block counts
// the items it owns with integer atomicAdd, S - p for the slot (r, p).  A
// slot holding -1 or an id >= n_items adds nothing, as in ref.borda_ref.
//
// Bound by bytes (each ballot id is read once, each point written once),
// but at the optimizer's sizes (a few ballots of a few items) by the launch
// alone.  So the route is chosen on the host (borda_count.py::borda_plan):
//   - one block (slot_blocks 0): when the counts fit shared memory and the
//     slots are few (the optimizer's ballots), one block zeroes its counts,
//     adds every slot, rounds each count once and writes the points.  One
//     launch, no memset, no scratch.
//   - grid: block (sb, ib) counts the items of range ib over the sb-th run
//     of slots in shared memory and writes its partial counts, so no global
//     atomic and no memset is needed; a second launch sums each item's
//     partials and rounds once.  Two launches.
//
// Why the sums are exact although the atomics add in no fixed order: every
// term is an integer and integer adds are associative, and no count can
// overflow: the one-block route takes at most 16384 slots of at most 16384
// points, under 2^28, so its counts are 32-bit; the grid route's are 64-bit
// (at most 2^31 slots of at most 2^31 points).  Up to 2^24
// the points equal the reference's fp32 sums exactly; above, they are the
// exact sums rounded once, where a fp32 sum in any order may differ.
//
// Plain C interface, loaded with ctypes.  The launches go to the stream they
// are given, allocate nothing and do not synchronise.

#include <cuda_runtime.h>

namespace repro {
namespace borda {

using Count = unsigned long long;  // the grid route's counts
constexpr int kThreads = 512;
constexpr int kUnroll = 4;            // ids loaded before their adds
constexpr int kBlockItems = 4096;     // items a block counts; borda_count.py::BLOCK_ITEMS
constexpr int kOneBlockSlots = 16384; // borda_count.py::ONE_BLOCK_SLOTS

// Add the slots [s0, s1) whose item lies in [lo, lo + n_here) to counts.
template <typename C>
__device__ __forceinline__ void count_slots(const int* __restrict__ ballots, int s0, int s1,
                                            int s, int lo, int n_here, C* counts) {
  for (long long base = s0 + threadIdx.x; base < s1; base += kUnroll * kThreads) {
    int ids[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long slot = base + u * kThreads;
      ids[u] = slot < s1 ? ballots[slot] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = (int)(base + u * kThreads);  // only read below when < s1
      const unsigned item = (unsigned)(ids[u] - lo);
      if (ids[u] >= 0 && item < (unsigned)n_here) atomicAdd(counts + item, (C)(s - slot % s));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
one_block_kernel(const int* __restrict__ ballots, int n_slots, int s, int n_items,
                 float* __restrict__ points) {
  extern __shared__ unsigned int counts32[];  // n_items
  for (int i = threadIdx.x; i < n_items; i += kThreads) counts32[i] = 0;
  __syncthreads();
  count_slots(ballots, 0, n_slots, s, 0, n_items, counts32);
  __syncthreads();
  for (int i = threadIdx.x; i < n_items; i += kThreads) points[i] = __uint2float_rn(counts32[i]);
}

// Block sb + slot_blocks * ib: slots [sb * slots_per_block, ...) and items
// [ib * kBlockItems, ...).
__global__ void __launch_bounds__(kThreads)
partial_kernel(const int* __restrict__ ballots, int n_slots, int s, int n_items,
               int slot_blocks, int slots_per_block, Count* __restrict__ partial) {
  extern __shared__ Count counts[];  // min(kBlockItems, n_items)
  const int sb = blockIdx.x % slot_blocks;
  const int lo = (blockIdx.x / slot_blocks) * kBlockItems;
  const int n_here = min(kBlockItems, n_items - lo);
  const int s0 = sb * slots_per_block;
  const int s1 = (int)min((long long)n_slots, (long long)s0 + slots_per_block);
  for (int i = threadIdx.x; i < n_here; i += kThreads) counts[i] = 0;
  __syncthreads();
  count_slots(ballots, s0, s1, s, lo, n_here, counts);
  __syncthreads();
  Count* dst = partial + (size_t)sb * n_items + lo;
  for (int i = threadIdx.x; i < n_here; i += kThreads) dst[i] = counts[i];
}

__global__ void __launch_bounds__(kThreads)
sum_kernel(const Count* __restrict__ partial, int slot_blocks, int n_items,
           float* __restrict__ points) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_items) return;
  Count total = 0;
  for (int b = 0; b < slot_blocks; ++b) total += partial[(size_t)b * n_items + i];
  points[i] = __ull2float_rn(total);
}

}  // namespace borda
}  // namespace repro

// slot_blocks: 0 for the one-block route (n_items <= 4096 and R * S <=
// 16384), else the grid
// route's runs of slots, partial holding slot_blocks * n_items counts.
// Returns 0 on success, a cudaError_t when a launch was refused, -2 for
// sizes or a plan out of range.
extern "C" int borda_count_launch(const void* ballots, int r, int s, int n_items,
                                  int slot_blocks, void* partial, void* points, void* stream) {
  using namespace repro::borda;
  if (r < 0 || s < 0 || n_items < 1 || slot_blocks < 0) return -2;
  if ((long long)r * s > 0x7fffffffLL) return -2;
  const int n_slots = r * s;
  const int* b = static_cast<const int*>(ballots);
  float* p = static_cast<float*>(points);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (slot_blocks == 0) {
    if (n_items > kBlockItems || n_slots > kOneBlockSlots) return -2;
    one_block_kernel<<<1, kThreads, sizeof(unsigned int) * n_items, st>>>(b, n_slots, s, n_items, p);
    return (int)cudaGetLastError();
  }
  const long long item_blocks = (n_items + kBlockItems - 1) / kBlockItems;
  if (partial == nullptr || slot_blocks * item_blocks > 0x7fffffffLL) return -2;
  const int slots_per_block = (int)(((long long)n_slots + slot_blocks - 1) / slot_blocks);
  Count* part = static_cast<Count*>(partial);
  const size_t smem = sizeof(Count) * (n_items < kBlockItems ? n_items : kBlockItems);
  partial_kernel<<<(unsigned)(slot_blocks * item_blocks), kThreads, smem, st>>>(
      b, n_slots, s, n_items, slot_blocks, slots_per_block, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_kernel<<<(n_items + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, slot_blocks, n_items,
                                                                       p);
  return (int)cudaGetLastError();
}
