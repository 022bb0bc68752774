// One stable LSD radix pass written as a gather (K4).
//
// Replaces: src/repro/kernels/radix_sort.py, _rank_kernel / radix_rank_pallas.
// Computes: for each output slot j < n, src[j] = the leftmost row i with
// csum[kd[j], i] >= kt[j], clamped to n - 1, where csum (radix, n) holds
// the inclusive per-digit prefix counts, digit-major, and kd/kt are each
// slot's digit and target rank (all computed outside the kernel from the
// per-segment digit histograms).
//
// What bounds it on the H100: bytes and gather latency. Each slot reads
// its kd/kt and writes one int32 (12 bytes a slot, coalesced), and the
// counts are 4 * radix * n bytes, so one pass over 1.8M rows moves about
// 137 MB: 0.04 ms at 3.35 TB/s. The search reads log2(n) entries of one
// digit's column, each a dependent load, which is where the time goes.
//
// What the design does about it: one thread per output slot, so each slot
// is written once with no atomics, and the scatter of a counting sort
// becomes a gather that needs no second pass. The prefix counts are kept
// digit-major (the Pallas kernel takes them row-major, (n, radix)), so a
// search walks one contiguous column: the upper levels of every search
// land in a few lines that stay in L2, and the deep levels of neighbouring
// slots of the same digit share sectors.
#include "common.cuh"

namespace {

__global__ void radix_rank_kernel(const int32_t* __restrict__ csum,
                                  const int32_t* __restrict__ kd,
                                  const int32_t* __restrict__ kt,
                                  int32_t* __restrict__ src, int n) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const int32_t digit = kd[j];
  const int32_t target = kt[j];
  const int32_t* col = csum + static_cast<long long>(digit) * n;
  int lo = 0, hi = n;  // lower bound: first row with csum[digit, row] >= target
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (col[mid] >= target) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  src[j] = min(lo, n - 1);
}

}  // namespace

REPRO_EXPORT int radix_rank_launch(const void* csum, const void* kd,
                                   const void* kt, void* src, int n, void* stream) {
  if (n > 0) {
    radix_rank_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(csum), static_cast<const int32_t*>(kd),
        static_cast<const int32_t*>(kt), static_cast<int32_t*>(src), n);
  }
  return static_cast<int>(cudaGetLastError());
}
