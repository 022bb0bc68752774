// Capacity-bounded CSR expansion (K2).
//
// Replaces: src/repro/kernels/csr_expand.py, _expand_kernel / csr_expand_pallas.
// Computes: for each output slot j < capacity, fr = the last frontier row
// with starts[fr] <= j, and member = base[fr] + j - starts[fr]. Slots at or
// past total (read here from device memory, never on the host) get -1 in
// both outputs. `starts` is the exclusive prefix sum of the per-row counts,
// computed outside the kernel.
//
// What bounds it on the H100: bytes. The outputs are 8 bytes a slot,
// written once; the binary search reads log2(F) entries of `starts` per
// slot, but neighbouring slots walk the same path, so those reads are
// served by L1/L2 and device-memory traffic stays near
// 8 * capacity + 8 * F bytes against 3.35 TB/s.
//
// What the design does about it: one thread per output slot with a plain
// `while (lo < hi)` search, so every slot is written exactly once (no
// atomics, no scatter) and consecutive threads write consecutive words.
#include "common.cuh"

namespace {

__global__ void csr_expand_kernel(const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ base,
                                  const int32_t* __restrict__ total,
                                  int32_t* __restrict__ fr_out,
                                  int32_t* __restrict__ member_out, int f,
                                  int capacity) {
  const long long jl = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (jl >= capacity) return;
  const int32_t j = static_cast<int32_t>(jl);
  if (j >= *total) {
    fr_out[j] = -1;
    member_out[j] = -1;
    return;
  }
  int lo = 0, hi = f;  // upper bound: first row with starts[row] > j
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts[mid] <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int fr = min(max(lo - 1, 0), f - 1);
  fr_out[j] = fr;
  member_out[j] = base[fr] + (j - starts[fr]);
}

}  // namespace

REPRO_EXPORT int csr_expand_launch(const void* starts, const void* base,
                                   const void* total, void* fr, void* member,
                                   int f, int capacity, void* stream) {
  if (capacity > 0) {
    csr_expand_kernel<<<grid_for(capacity), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(total), static_cast<int32_t*>(fr),
        static_cast<int32_t*>(member), f, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
