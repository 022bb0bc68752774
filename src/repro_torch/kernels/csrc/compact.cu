// Frontier compaction as a gather (K3), on the merge-path core.
//
// Replaces: src/repro/kernels/compact.py, _compact_kernel / compact_pallas.
// Computes: for each output slot j < capacity, the leftmost lane i with
// csum[i] >= j + 1 (clamped to n - 1), where csum is the inclusive prefix
// sum of the valid mask (computed outside the kernel). Slots at or past
// live (read from device memory) get -1.
//
// What bounds it on the H100: bytes. csum is read once and one int32 is
// written per slot: at the main path's compaction (600,064 lanes into
// 8,192 slots) 2.4 MB, 0.73 us at 3.35 TB/s, less than launching a few
// hundred blocks costs. A thread per slot would fill only 32 blocks of 256
// threads there, leaving 100 of the 132 SMs idle, each thread making 20
// dependent loads.
//
// What the design does about it: the leftmost lane with csum >= j + 1 is
// ub(j), the number of lanes with csum <= j, so the output is one merge of
// csum with the slot sequence (load_balance.cuh). The merge's n + capacity
// items spread over all SMs in equal runs of 1,792 (340 blocks at the main
// path's shape), each block reads its window of csum once into shared
// memory and writes its slots coalesced. With every block resident at
// once, the time is one block's chain of dependent steps (the searches,
// the window copy, the merge) plus the launch. No tensor-core work:
// compare and select. 7 merge items a thread, fewer than K2's 9: with
// every block resident, a shorter run shortens the one chain that sets
// the time.
#include "load_balance.cuh"

namespace {

constexpr int kVT = 7;  // merge items a thread

__global__ void __launch_bounds__(lb::kNT)
    compact_kernel(const int32_t* __restrict__ csum, const int32_t* __restrict__ live,
                   int32_t* __restrict__ src, int n, int capacity) {
  __shared__ lb::Shared<1, kVT> sh;
  const int32_t* const srcs[1] = {csum};
  const lb::Tile t = lb::merge_tile(srcs, n, live, capacity, sh);
  int32_t* const outs[1] = {src};
  lb::fill_tail(outs, t.l, capacity);
#pragma unroll
  for (int step = 0; step < kVT; ++step) {  // the block's slots, at most kNT * kVT
    const int k = threadIdx.x + step * lb::kNT;
    if (k >= t.k1 - t.k0) break;
    src[t.k0 + k] = min(sh.ub[k], n - 1);
  }
#ifdef REPRO_LB_TRACE
  __syncthreads();
  lb::mark(4);
#endif
}

}  // namespace

REPRO_EXPORT int compact_launch(const void* csum, const void* live, void* src,
                                int n, int capacity, void* stream) {
  if (capacity > 0) {
    const unsigned int blocks = lb::grid<kVT>(n, capacity);
    compact_kernel<<<blocks, lb::kNT, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(csum), static_cast<const int32_t*>(live),
        static_cast<int32_t*>(src), n, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
