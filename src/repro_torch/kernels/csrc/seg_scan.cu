// Device-wide prefix scans of the trie build: a radix pass's per-digit
// counts, and an inclusive running maximum.
//
// Replaces no Pallas kernel: the reference leaves these scans to XLA
// (src/repro/kernels/radix_sort.py's cumsum over the one-hot and its
// segment-start cummax, src/repro/kernels/ops.py's displacement cummax).
// PyTorch runs a scan along the last dim of a (16, N) tensor, and any
// cummax, on a few blocks a row, so at SSB's 60M rows these scans were
// serial work on a card of 132 SMs.
//
// Computes: digit_counts, for digit (n,) int32 in [0, 16), the digit-major
// tables csum[r, i] = the rows <= i with digit r, and pcs[r, i] = the rows
// <= i with digit <= r (both (16, n) int32); max_scan, out[i] = max of
// x[0..i] for x (n,) int32.
//
// What bounds it on the H100: bytes. digit_counts writes 128 bytes a row
// (16 counts to each table) and reads 4, at n = 60M 7.92 GB, 2.4 ms at
// 3.35 TB/s; max_scan reads and writes 4 bytes a row. The warp work beside
// it is 16 ballots and popcounts a digit-row of 32.
//
// What the design does about it: reduce, then scan, then write, each over
// tiles of kTile rows, one tile a block. A block counts (or maxes) its
// tile; one block scans the (tiles, 16) partials into each tile's offsets
// (exclusive); then every block counts its tile again, warp by warp, and
// writes both tables once, coalesced: each warp owns 512 consecutive rows
// and writes, for each digit, 32 consecutive ints a step. No one-hot is
// made, and nothing but the (tiles, 16) partials is written twice. Offsets
// into the tables are 64-bit: 16 n elements pass 2^31 bytes at SSB's n.
#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRadix = 16;
constexpr int kWarps = kThreads / 32;                  // 8
constexpr int kRowsPerWarp = 512;                      // 16 steps of 32
constexpr long long kTile = kWarps * kRowsPerWarp;     // 4,096 rows a block
constexpr int kTopThreads = 1024;                      // the one scanning block

struct Add {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};

// Lane r (< kRadix) gets the count of digit r among the warp's rows
// [row0, min(row0 + kRowsPerWarp, n)); the other lanes get 0.
__device__ __forceinline__ int warp_digit_hist(const int32_t* __restrict__ digit,
                                               long long row0, long long n, int lane) {
  int count = 0;
  for (int k = 0; k < kRowsPerWarp; k += 32) {
    if (row0 + k >= n) break;  // warp-uniform
    const long long i = row0 + k + lane;
    const int d = i < n ? digit[i] : -1;
#pragma unroll
    for (int r = 0; r < kRadix; ++r) {
      const int c = __popc(__ballot_sync(kFull, d == r));
      if (lane == r) count += c;
    }
  }
  return count;
}

// Every lane gets the maximum of x over the warp's rows (INT_MIN if none).
__device__ __forceinline__ int warp_max(const int32_t* __restrict__ x, long long row0,
                                        long long n, int lane) {
  int m = INT_MIN;
  for (int k = 0; k < kRowsPerWarp; k += 32) {
    const long long i = row0 + k + lane;
    if (i < n) m = max(m, x[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// Exclusive scan of one value a thread across the block, in thread order.
// warp_tot holds 32 ints of shared memory.
template <class Op>
__device__ int block_exclusive(int x, Op op, int identity, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = op(v, y);
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < static_cast<int>(blockDim.x >> 5) ? warp_tot[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w = op(w, y);
    }
    warp_tot[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) excl = identity;
  if (warp > 0) excl = op(warp_tot[warp - 1], excl);
  __syncthreads();  // warp_tot is reused by the next call
  return excl;
}

// The tiles' partials, (blocks, W) row-major, become each tile's exclusive
// prefix, column by column, in place. One block; each thread walks a
// contiguous run of tiles.
template <int W, class Op>
__global__ void __launch_bounds__(kTopThreads)
    scan_tiles_kernel(int32_t* __restrict__ part, int blocks, int identity) {
  __shared__ int warp_tot[32];
  const Op op{};
  const int per = (blocks + kTopThreads - 1) / kTopThreads;
  const int b0 = min(blocks, static_cast<int>(threadIdx.x) * per);
  const int b1 = min(blocks, b0 + per);
  for (int col = 0; col < W; ++col) {
    int acc = identity;
    for (int b = b0; b < b1; ++b) acc = op(acc, part[b * W + col]);
    int run = block_exclusive(acc, op, identity, warp_tot);
    for (int b = b0; b < b1; ++b) {
      const int x = part[b * W + col];
      part[b * W + col] = run;
      run = op(run, x);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    digit_hist_kernel(const int32_t* __restrict__ digit, int32_t* __restrict__ hist,
                      long long n) {
  __shared__ int warp_hist[kWarps][kRadix];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = blockIdx.x * kTile + warp * kRowsPerWarp;
  const int c = warp_digit_hist(digit, row0, n, lane);
  if (lane < kRadix) warp_hist[warp][lane] = c;
  __syncthreads();
  if (threadIdx.x < kRadix) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_hist[w][threadIdx.x];
    hist[blockIdx.x * kRadix + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    digit_counts_kernel(const int32_t* __restrict__ digit, const int32_t* __restrict__ offsets,
                        int32_t* __restrict__ csum, int32_t* __restrict__ pcs, long long n) {
  __shared__ int warp_hist[kWarps][kRadix];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = blockIdx.x * kTile + warp * kRowsPerWarp;
  const int c = warp_digit_hist(digit, row0, n, lane);
  if (lane < kRadix) warp_hist[warp][lane] = c;
  __syncthreads();
  int start = 0;  // lane r: digit r's rows before the warp's first row
  if (lane < kRadix) {
    start = offsets[blockIdx.x * kRadix + lane];
    for (int w = 0; w < warp; ++w) start += warp_hist[w][lane];
  }
  int count[kRadix];
#pragma unroll
  for (int r = 0; r < kRadix; ++r) count[r] = __shfl_sync(kFull, start, r);
  const unsigned upto = kFull >> (31 - lane);  // lanes 0..lane
  for (int k = 0; k < kRowsPerWarp; k += 32) {
    if (row0 + k >= n) break;  // warp-uniform
    const long long i = row0 + k + lane;
    const bool in = i < n;
    const int d = in ? digit[i] : -1;
    int below = 0;  // rows <= i with digit <= r
    int32_t* c_at = csum + i;  // row r of each table is n ints further on
    int32_t* p_at = pcs + i;
#pragma unroll
    for (int r = 0; r < kRadix; ++r, c_at += n, p_at += n) {
      const unsigned m = __ballot_sync(kFull, d == r);
      const int v = count[r] + __popc(m & upto);
      count[r] += __popc(m);
      below += v;
      if (in) {
        *c_at = v;
        *p_at = below;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    max_reduce_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ part, long long n) {
  __shared__ int warp_m[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp_max(x, blockIdx.x * kTile + warp * kRowsPerWarp, n, lane);
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = INT_MIN;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = max(s, warp_m[w]);
    part[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    max_scan_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ part,
                    int32_t* __restrict__ out, long long n) {
  __shared__ int warp_m[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row0 = blockIdx.x * kTile + warp * kRowsPerWarp;
  const int m = warp_max(x, row0, n, lane);
  if (lane == 0) warp_m[warp] = m;
  __syncthreads();
  int carry = part[blockIdx.x];  // the maximum before the tile
  for (int w = 0; w < warp; ++w) carry = max(carry, warp_m[w]);
  for (int k = 0; k < kRowsPerWarp; k += 32) {
    if (row0 + k >= n) break;  // warp-uniform
    const long long i = row0 + k + lane;
    int v = i < n ? x[i] : INT_MIN;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v = max(v, y);
    }
    v = max(v, carry);
    if (i < n) out[i] = v;
    carry = __shfl_sync(kFull, v, 31);
  }
}

inline bool tiles_ok(long long n, int blocks) {
  return n >= 0 && blocks == (n + kTile - 1) / kTile;
}

}  // namespace

// scratch: (blocks, 16) int32, blocks = ceil(n / 4096).
REPRO_EXPORT int digit_counts_launch(const void* digit, void* csum, void* pcs, void* scratch,
                                     long long n, int blocks, void* stream) {
  if (!tiles_ok(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* d = static_cast<const int32_t*>(digit);
    auto* part = static_cast<int32_t*>(scratch);
    digit_hist_kernel<<<blocks, kThreads, 0, s>>>(d, part, n);
    scan_tiles_kernel<kRadix, Add><<<1, kTopThreads, 0, s>>>(part, blocks, 0);
    digit_counts_kernel<<<blocks, kThreads, 0, s>>>(d, part, static_cast<int32_t*>(csum),
                                                    static_cast<int32_t*>(pcs), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: (blocks,) int32, blocks = ceil(n / 4096).
REPRO_EXPORT int max_scan_launch(const void* x, void* out, void* scratch, long long n,
                                 int blocks, void* stream) {
  if (!tiles_ok(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const int32_t*>(x);
    auto* part = static_cast<int32_t*>(scratch);
    max_reduce_kernel<<<blocks, kThreads, 0, s>>>(in, part, n);
    scan_tiles_kernel<1, Max><<<1, kTopThreads, 0, s>>>(part, blocks, INT_MIN);
    max_scan_kernel<<<blocks, kThreads, 0, s>>>(in, part, static_cast<int32_t*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}
