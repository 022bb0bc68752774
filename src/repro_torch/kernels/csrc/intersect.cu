// Sorted-set membership by lower-bound binary search (K5).
//
// Replaces: src/repro/kernels/intersect.py, _bsearch_kernel / intersect_pallas.
// Computes: for each query a[i], the lower bound lo = the first position in
// the sorted, duplicate-free b with b[lo] >= a[i] (the result of
// jnp.searchsorted(b, a, side="left"), which the Pallas kernel's masked
// fixed-step search also yields); mask[i] = lo < n and b[lo] == a[i], and
// pos[i] = lo where mask[i] is set, else -1.
//
// What bounds it on the H100: bytes. Each query reads one int32 and writes
// one byte (mask) and one int32 (pos), 9 bytes a query, coalesced; b is
// read by the searches at data-dependent addresses, log2(n) dependent loads
// per query. At the sizes the path gives it (a few hundred thousand keys,
// about a megabyte) b stays in the 50 MB L2 after its first touch, so
// device-memory traffic is about 9 Q + 4 N bytes against 3.35 TB/s and the
// search's dependent-load latency is what the time goes to.
//
// What the design does about it: one thread per query, neighbouring
// threads on neighbouring queries, so the reads of a and the writes of
// mask and pos are coalesced and every output is written exactly once.
// The Pallas kernel copies all of b into VMEM for each 1024-query block;
// here b is left in device memory and the L2 serves the shared upper
// levels of every search. Queries need no padding to a block multiple:
// the ragged tail is masked by the bounds check.
#include "common.cuh"

namespace {

__global__ void intersect_kernel(const int32_t* __restrict__ a,
                                 const int32_t* __restrict__ b,
                                 uint8_t* __restrict__ mask, int32_t* __restrict__ pos,
                                 int q, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const int32_t key = a[i];
  int lo = 0, hi = n;  // lower bound: first position with b >= key
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool found = lo < n && b[lo] == key;
  mask[i] = found ? 1 : 0;
  pos[i] = found ? lo : -1;
}

}  // namespace

REPRO_EXPORT int intersect_launch(const void* a, const void* b, void* mask, void* pos,
                                  int q, int n, void* stream) {
  if (q > 0) {
    intersect_kernel<<<grid_for(q), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
        static_cast<uint8_t*>(mask), static_cast<int32_t*>(pos), q, n);
  }
  return static_cast<int>(cudaGetLastError());
}
