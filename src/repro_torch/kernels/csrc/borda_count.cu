// Borda-count consensus points for Hopper (sm_90a): the optimizer's
// pessimistic selection aggregates candidate rankings into a gold ranking.
//
//   ballots  (R, S)       contiguous int32 item ids; -1 pads a short ballot
//   points   (n_items,)   fp32: slot p of a ballot is worth S - p to its item
//   counts   (n_items,)   uint64 scratch: the exact integer sums
//
// Replaces the Pallas kernel repro/kernels/borda_count.py::borda_count.  The
// TPU has no scatter atomics, so it recast the sum as a one-hot matrix
// product per item block.  Hopper has them: one thread per ballot slot
// (r, p) adds S - p to counts[ballots[r, p]] with a 64-bit integer
// atomicAdd.  A slot holding -1 or an id >= n_items adds nothing, as in
// ref.borda_ref.  A second launch rounds each count to fp32 once.
//
// Why the sums are exact although the atomics add in no fixed order: every
// term is an integer and integer adds are associative; no item's count can
// reach 2^64 (at most 2^31 slots of at most 2^31 points).  Up to 2^24 the
// points equal the reference's fp32 sums exactly; above, they are the
// exact sums rounded once, where a fp32 sum in any order may differ.
//
// Bound by bytes: each ballot id is read once and each point written once;
// the atomics land in L2.
//
// Plain C interface, loaded with ctypes.  The launch goes to the stream it is
// given (a memset of counts, then the two kernels), allocates nothing and
// does not synchronise.

#include <cuda_runtime.h>

namespace repro {
namespace borda {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
borda_count_kernel(const int* __restrict__ ballots, int n_slots, int s, int n_items,
                   unsigned long long* __restrict__ counts) {
  const int slot = blockIdx.x * kThreads + threadIdx.x;
  if (slot >= n_slots) return;
  const int item = ballots[slot];
  if (item >= 0 && item < n_items)
    atomicAdd(counts + item, (unsigned long long)(s - slot % s));
}

__global__ void __launch_bounds__(kThreads)
round_kernel(const unsigned long long* __restrict__ counts, int n_items,
             float* __restrict__ points) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_items) points[i] = __ull2float_rn(counts[i]);
}

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace borda
}  // namespace repro

// Returns 0 on success, a cudaError_t when the memset or a launch was
// refused, -2 for sizes out of range.
extern "C" int borda_count_launch(const void* ballots, int r, int s, int n_items, void* counts,
                                  void* points, void* stream) {
  using namespace repro::borda;
  if (r < 0 || s < 0 || n_items < 1) return -2;
  const long long n_slots = (long long)r * s;
  if (n_slots > 0x7fffffffLL) return -2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(unsigned long long) * (size_t)n_items, st);
  if (e != cudaSuccess) return (int)e;
  auto* c = static_cast<unsigned long long*>(counts);
  if (n_slots > 0) {
    borda_count_kernel<<<blocks_for(n_slots), kThreads, 0, st>>>(
        static_cast<const int*>(ballots), (int)n_slots, s, n_items, c);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  round_kernel<<<blocks_for(n_items), kThreads, 0, st>>>(c, n_items, static_cast<float*>(points));
  return (int)cudaGetLastError();
}
