// Merge-path load-balancing search: the core of K2 (csr_expand.cu) and K3
// (compact.cu).
//
// Both kernels compute, for every slot j of 0..L-1, ub(j) = the number of
// entries of a monotone int32 array a[0..n) that are <= j. Because the
// slots are consecutive, this is a merge, not a search per slot: merge A =
// a[0..n) with B = 0..L-1, taking A's item i first when a[i] <= j; slot j
// then comes out after exactly ub(j) items of A. The merge has n + L items
// ("diagonals"), and cutting it into equal runs of diagonals balances the
// work whatever the data: a hub row that fans out over a million slots
// and a run of a million empty rows cost the same as any other run.
//
// One block of kNT threads owns kTile = kNT * kVT consecutive diagonals
// (kVT, the merge items a thread, is each kernel's own: 9 for K2, 7 for K3):
//   1. Warps 0 and 1 find where the block's first and last diagonal cross
//      A, each with a warp-wide 33-ary search over A in device memory (32
//      probes a step, so about 5 dependent loads instead of 21 for two
//      million rows). Diagonal indices are 64-bit: n + L can pass 2^31.
//   2. A block that emits no slot (all its items are A's) stops here.
//   3. The block's window of A (at most kTile + 1 entries, contiguous;
//      one entry left of the block's first item, for the slots that come
//      before any of its own A items), and for K2 the same rows of `base`,
//      go to shared memory in one 1-D bulk copy each (TMA, cp.async.bulk,
//      completing on an mbarrier), rounded out to 16-byte bounds.
//   4. Each thread finds its own diagonal by a binary search in shared
//      memory and runs a serial merge of kVT steps, writing each slot's
//      ub into a shared staging row.
//   5. The caller writes the block's slots [k0, k1) from the staging row,
//      consecutive threads on consecutive words.
// Slots in [L, capacity) get -1 from a grid-stride loop of the same kernel,
// so a wrapper call stays one launch, and L = min(*total, capacity) is read
// on the device: the host sizes the grid from n + capacity, never from L.
// The searches of step 1 run with capacity slots and are corrected to L
// after, so the read of *total overlaps them instead of preceding them.
//
// What bounds it on the H100: bytes. A is read about once (windows of
// neighbouring blocks overlap by one entry), each output slot is written
// once; there is no per-slot search. The work is integer compare and select
// with no matrix product, so the tensor cores (wgmma) have nothing to do.
// Shared memory: (kWindows * kWin + kTile) int32 a block, under 28 KB.
#pragma once

#include "common.cuh"

namespace lb {

constexpr int kNT = 256;  // threads a block

// Phase clocks of each block, for tools/merge_path_phases.py's breakdown of
// where the time goes: compiled only with -DREPRO_LB_TRACE, never into the
// shipped libraries. Thread 0 of block b writes clock64() at the kernel's
// entry (0), after the searches (1), with the windows in shared memory
// (2), after the merge (3) and after the block's writes (4), globaltimer
// at the entry (5) and the end (6), and the grid's size (7), so that a
// reader can tell a grid larger than the buffer; a block that stops early
// leaves the later marks 0.
constexpr int kTraceBlocks = 1 << 14;
#ifdef REPRO_LB_TRACE
__device__ unsigned long long trace_buf[kTraceBlocks][8];

__device__ __forceinline__ void mark(int phase) {
  if (threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {
    trace_buf[blockIdx.x][phase] = clock64();
    if (phase == 0 || phase == 4) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      trace_buf[blockIdx.x][phase == 0 ? 5 : 6] = ns;
    }
    if (phase == 0) trace_buf[blockIdx.x][7] = gridDim.x;
  }
}
#else
__device__ __forceinline__ void mark(int) {}
#endif

// A block's shared memory, with kWindows windows (K2: starts and base; K3:
// csum) and kVT merge items a thread.
template <int kWindows, int kVT>
struct Shared {
  static constexpr int kTile = kNT * kVT;  // merge items a block
  // A window holds up to kTile + 1 entries, plus up to 3 on each side when
  // it is rounded out to 16-byte bounds; a multiple of 4 entries.
  static constexpr int kWin = (kTile + 1 + 6 + 3) / 4 * 4;
  alignas(16) int32_t win[kWindows][kWin];
  int32_t ub[kTile];  // staged ub of the block's slots
  alignas(8) uint64_t bar;
  int split[2];
};

struct Tile {
  int l;          // slots that get a value: min(*total, capacity), at least 0
  int i0, i1;     // A items [i0, i1) are merged in this block
  int k0, k1;     // slots [k0, k1) are emitted in this block
  int origin[2];  // win[w][origin[w] + r] holds array w's entry r
};

// Blocks of kVT items a thread for n entries and up to `capacity` slots.
template <int kVT>
inline unsigned int grid(int n, int capacity) {
  constexpr long long kTile = kNT * kVT;
  return static_cast<unsigned int>((static_cast<long long>(n) + capacity + kTile - 1) / kTile);
}

// The merge-path split of diagonal d when all `capacity` slots are filled:
// how many of A's items are among the first d merged items. That is the
// first i in [clo, chi] = [max(0, d - capacity), min(d, n)] whose item does
// not come before slot d - 1 - i, i.e. a[i] > d - 1 - i (true below the
// split and false from it on, as a is monotone), or chi. With L slots the
// split is max(this, d - L), so the search need not wait for L.
// Warp-wide 33-ary search: each step the 32 lanes test 32 positions at
// once and keep the part between the last true and the first false. Where
// the range starts at 0 it is searched as [0, n], positions from chi on
// counting as false without a load, so that every such block walks the
// same static tree and the upper levels hit lines already in L2.
__device__ __forceinline__ int warp_split(const int32_t* __restrict__ a, int n, int capacity,
                                          long long d) {
  const unsigned long long lane1 = (threadIdx.x & 31) + 1;
  const int chi = static_cast<int>(min(d, static_cast<long long>(n)));
  const int clo = static_cast<int>(min(max(0LL, d - capacity), static_cast<long long>(chi)));
  int lo = clo, hi = clo == 0 ? n : chi;
  while (lo < hi) {
    const unsigned long long s = hi - lo;
    const int p = lo + static_cast<int>(lane1 * s / 33);
    const bool before = p < chi && static_cast<long long>(__ldg(a + p)) <= d - 1 - p;
    const int c = __popc(__ballot_sync(0xffffffffu, before));  // a prefix of the lanes
    const int nlo = c > 0 ? lo + static_cast<int>(c * s / 33) + 1 : lo;
    if (c < 32) hi = lo + static_cast<int>((c + 1) * s / 33);
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Entries between the 16-byte bound below p and p.
__device__ __forceinline__ int lead(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// Bytes of the 16-byte granules covering p[0..count).
__device__ __forceinline__ uint32_t span_bytes(const int32_t* p, int count) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(p) & ~uintptr_t{15};
  const uintptr_t hi = (reinterpret_cast<uintptr_t>(p + count) + 15) & ~uintptr_t{15};
  return static_cast<uint32_t>(hi - lo);
}

// The block's part of the merge of a[0..n) with the slots 0..L-1, L =
// min(*total, capacity). Fills sh.ub[0 .. k1 - k0) with ub of slots k0..,
// and sh.win[w] with the window of srcs[w] (srcs[0] is a). Block-uniform:
// every thread returns the same tile; k1 == k0 when the block emits no
// slot, and then nothing else was done. Ends with a barrier, so sh.ub and
// sh.win can be read.
template <int kWindows, int kVT>
__device__ __forceinline__ Tile merge_tile(const int32_t* const (&srcs)[kWindows], int n,
                                           const int32_t* total, int capacity,
                                           Shared<kWindows, kVT>& sh) {
  constexpr int kTile = Shared<kWindows, kVT>::kTile;
  const int32_t* __restrict__ a = srcs[0];
  const long long d0 = static_cast<long long>(blockIdx.x) * kTile;
  Tile t{};
  mark(0);
  t.l = max(0, min(__ldg(total), capacity));  // in flight during the searches
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&sh.bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (warp < 2) {
    const int s = warp_split(a, n, capacity, d0 + warp * kTile);
    if ((threadIdx.x & 31) == 0) sh.split[warp] = s;
  }
  __syncthreads();
  mark(1);
  const long long items = static_cast<long long>(n) + t.l;
  if (d0 >= items) return t;  // past the merge: only the -1 fill
  const long long d1 = min(d0 + kTile, items);
  t.i0 = static_cast<int>(max(static_cast<long long>(sh.split[0]), d0 - t.l));
  t.i1 = d1 == items ? n : static_cast<int>(max(static_cast<long long>(sh.split[1]), d1 - t.l));
  t.k0 = static_cast<int>(d0 - t.i0);
  t.k1 = static_cast<int>(d1 - t.i1);
  if (t.k1 == t.k0) return t;  // only A items here: no slot to write

  // windows: entries [w0, w1) of each source
  const int w0 = max(t.i0 - 1, 0), w1 = max(t.i1, w0 + 1);
  for (int w = 0; w < kWindows; ++w) t.origin[w] = lead(srcs[w] + w0) - w0;
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_addr(&sh.bar);
    uint32_t bytes[kWindows], sum = 0;
    for (int w = 0; w < kWindows; ++w) sum += bytes[w] = span_bytes(srcs[w] + w0, w1 - w0);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(sum)
                 : "memory");
    for (int w = 0; w < kWindows; ++w) {
      const uintptr_t src = reinterpret_cast<uintptr_t>(srcs[w] + w0) & ~uintptr_t{15};
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
          ::"r"(smem_addr(sh.win[w])), "l"(src), "r"(bytes[w]), "r"(bar)
          : "memory");
    }
  }
  for (uint32_t done = 0; !done;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(&sh.bar))
        : "memory");
  }
  mark(2);

  // this thread's run of kVT diagonals, in the block's coordinates
  const int a_len = t.i1 - t.i0, b_len = t.k1 - t.k0, m = a_len + b_len;
  const int32_t* sa = sh.win[0] + t.origin[0] + t.i0;  // sa[i] = a[i0 + i]
  const int dl = min(static_cast<int>(threadIdx.x) * kVT, m);
  int lo = max(0, dl - b_len), hi = min(dl, a_len);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= t.k0 + dl - 1 - mid) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo, k = dl - lo;
#pragma unroll
  for (int s = 0; s < kVT; ++s) {
    if (i + k < m) {
      if (i < a_len && (k >= b_len || sa[i] <= t.k0 + k)) {
        ++i;  // A's item first on ties: a[i] <= slot
      } else {
        sh.ub[k] = t.i0 + i;
        ++k;
      }
    }
  }
  __syncthreads();
  mark(3);
  return t;
}

// Slots [l, capacity) get -1 in each output: a grid-stride loop.
template <int kOuts>
__device__ __forceinline__ void fill_tail(int32_t* const (&outs)[kOuts], int l, int capacity) {
  for (long long j = l + static_cast<long long>(blockIdx.x) * kNT + threadIdx.x; j < capacity;
       j += static_cast<long long>(gridDim.x) * kNT) {
    for (int o = 0; o < kOuts; ++o) outs[o][j] = -1;
  }
}

}  // namespace lb

#ifdef REPRO_LB_TRACE
REPRO_EXPORT int lb_trace_clear() {
  void* buf = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&buf, lb::trace_buf);
  return static_cast<int>(err != cudaSuccess ? err : cudaMemset(buf, 0, sizeof(lb::trace_buf)));
}

REPRO_EXPORT int lb_trace_read(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, lb::trace_buf, sizeof(lb::trace_buf)));
}
#endif
