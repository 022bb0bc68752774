// Frontier compaction as a gather (K3).
//
// Replaces: src/repro/kernels/compact.py, _compact_kernel / compact_pallas.
// Computes: for each output slot j < capacity, the leftmost lane i with
// csum[i] >= j + 1, where csum is the inclusive prefix sum of the valid
// mask (computed outside the kernel). Slots at or past live (read from
// device memory) get -1.
//
// What bounds it on the H100: bytes. One int32 written per output slot;
// the log2(N) search reads per slot share their upper levels across the
// warp and hit L1/L2, so device-memory traffic is about 4 * capacity bytes
// plus one pass over the touched part of csum, against 3.35 TB/s.
//
// What the design does about it: one thread per output slot, each writing
// its slot exactly once (the scatter of the lane order becomes a gather,
// so no atomics), with consecutive threads on consecutive words.
#include "common.cuh"

namespace {

__global__ void compact_kernel(const int32_t* __restrict__ csum,
                               const int32_t* __restrict__ live,
                               int32_t* __restrict__ src, int n, int capacity) {
  const long long jl = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (jl >= capacity) return;
  const int32_t j = static_cast<int32_t>(jl);
  if (j >= *live) {
    src[j] = -1;
    return;
  }
  const int32_t target = j + 1;
  int lo = 0, hi = n;  // lower bound: first lane with csum >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (csum[mid] >= target) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  src[j] = min(lo, n - 1);
}

}  // namespace

REPRO_EXPORT int compact_launch(const void* csum, const void* live, void* src,
                                int n, int capacity, void* stream) {
  if (capacity > 0) {
    compact_kernel<<<grid_for(capacity), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(csum), static_cast<const int32_t*>(live),
        static_cast<int32_t*>(src), n, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
