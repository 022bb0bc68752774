// Capacity-bounded CSR expansion (K2), on the merge-path core.
//
// Replaces: src/repro/kernels/csr_expand.py, _expand_kernel / csr_expand_pallas.
// Computes: for each output slot j < capacity, fr = the last frontier row
// with starts[fr] <= j (clamped to [0, F-1]), and member = base[fr] + j -
// starts[fr]. Slots at or past total (read here from device memory, never
// on the host) get -1 in both outputs. `starts` is the exclusive prefix sum
// of the per-row counts, computed outside the kernel.
//
// What bounds it on the H100: bytes. starts and base are read once (8
// bytes a row) and both outputs written once (8 bytes a slot): at the main
// path's largest expansion (1,801,216 rows into 4,194,304 slots) 48 MB,
// 14 us at 3.35 TB/s. A binary search per slot would make 21 dependent
// loads for each of four million slots and be bound by their latency.
//
// What the design does about it: fr = ub(j) - 1, where ub(j) is the number
// of rows whose start is <= j, so the whole output is one merge of starts
// with the slot sequence (load_balance.cuh): each block takes an equal run
// of merge items whatever the fan-outs, copies its windows of starts and
// base into shared memory, merges there, and writes its slots coalesced.
// 9 merge items a thread (2,304 a block, 2,603 blocks at the main path's
// shape): the searches are a fixed cost a block, so a longer run than
// K3's 7 pays them less often; the ptxas line shows no spills at 9.
// A row's start tied with a slot consumes the row first, so in a run of
// zero-count rows sharing one start the slot goes to the last of them, the
// row whose count is not zero. No tensor-core work: compare and select.
#include "load_balance.cuh"

namespace {

constexpr int kVT = 9;  // merge items a thread

__global__ void __launch_bounds__(lb::kNT)
    csr_expand_kernel(const int32_t* __restrict__ starts, const int32_t* __restrict__ base,
                      const int32_t* __restrict__ total, int32_t* __restrict__ fr_out,
                      int32_t* __restrict__ member_out, int f, int capacity) {
  __shared__ lb::Shared<2, kVT> sh;
  const int32_t* const srcs[2] = {starts, base};
  const lb::Tile t = lb::merge_tile(srcs, f, total, capacity, sh);
  int32_t* const outs[2] = {fr_out, member_out};
  lb::fill_tail(outs, t.l, capacity);
#pragma unroll
  for (int step = 0; step < kVT; ++step) {  // the block's slots, at most kNT * kVT
    const int k = threadIdx.x + step * lb::kNT;
    if (k >= t.k1 - t.k0) break;
    const int fr = max(sh.ub[k] - 1, 0);  // ub <= f, so fr <= f - 1
    const uint32_t s = static_cast<uint32_t>(sh.win[0][t.origin[0] + fr]);
    const uint32_t b = static_cast<uint32_t>(sh.win[1][t.origin[1] + fr]);
    const int j = t.k0 + k;
    fr_out[j] = fr;
    member_out[j] = static_cast<int32_t>(b + static_cast<uint32_t>(j) - s);  // wraps as int32
  }
#ifdef REPRO_LB_TRACE
  __syncthreads();
  lb::mark(4);
#endif
}

}  // namespace

REPRO_EXPORT int csr_expand_launch(const void* starts, const void* base,
                                   const void* total, void* fr, void* member,
                                   int f, int capacity, void* stream) {
  if (capacity > 0) {
    const unsigned int blocks = lb::grid<kVT>(f, capacity);
    csr_expand_kernel<<<blocks, lb::kNT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(total), static_cast<int32_t*>(fr),
        static_cast<int32_t*>(member), f, capacity);
  }
  return static_cast<int>(cudaGetLastError());
}
