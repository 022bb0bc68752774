// Sorted-set membership through a bucket directory over the key range (K5).
//
// Replaces: src/repro/kernels/intersect.py, _bsearch_kernel / intersect_pallas.
// Computes: for each query a[i], the lower bound lo = the first position in
// the sorted, duplicate-free b with b[lo] >= a[i] (the result of
// jnp.searchsorted(b, a, side="left"), which the Pallas kernel's masked
// fixed-step search also yields); mask[i] = lo < n and b[lo] == a[i], and
// pos[i] = lo where mask[i] is set, else -1.
//
// What bounds it on the H100: the function moves 9 bytes a query (a read,
// mask and pos written, coalesced) and 4 a key. A binary search over all
// of b adds log2(n) dependent loads a query at scattered addresses; those
// loads, each a 32-byte sector through L1 or from L2, not the bytes, set
// the time of a one-thread-a-query search.
//
// What the design does about it:
//   - A bucket directory over b's key range replaces the upper levels of
//     the search with one lookup. With 2^r buckets (r from n on the host:
//     about one bucket a key, at most 2^kMaxDirBits) and s the smallest
//     shift with (b[n-1] - b[0]) >> s < 2^r, bucket(x) = uint32(x - b[0])
//     >> s; 32-bit unsigned arithmetic, so a b over the whole int32 range
//     does not overflow. dir[u].x is the first i with bucket(b[i]) >= u.
//     A key in [b[0], b[n-1]] has its lower bound in [dir[u].x,
//     dir[u+1].x] for u = bucket(key); keys outside that range miss at 0
//     or n.
//   - Where buckets are at most 32 ids wide (s <= 5: keys dense in their
//     range, as person ids are), dir[u].y is the bucket's occupancy word,
//     bit t set when b[0] + (u << s) + t is a key. A query then takes one
//     8-byte load: mask from the bit, pos = dir[u].x plus the set bits
//     below it; b is not read. Wider buckets keep dir[u + 1].x in .y and
//     are searched in b (through L1 and L2) between the two, at most
//     min(s, log2 n) steps; the search tracks whether b at its upper end
//     equals the key, so no further load decides membership.
//   - The directory stays in device memory and is read through L1 (__ldg):
//     its 2^14 pairs take 128 KB, and a copy into every block's shared
//     memory cost more than the lookups it saved (PERF.md).
//   - A pre-pass kernel with one thread per key builds it, every entry
//     written exactly once, without atomics and without a host sync (b[0]
//     and b[n-1] are read on the device).
//   - The search kernel runs a persistent grid, one block of 1024 threads
//     an SM. Thread g takes queries g, g + P, g + 2P, ... (P threads in
//     all), several at once so that their loads overlap: reads of a and
//     writes of mask and pos stay coalesced, and the threads' shares
//     differ by at most one query.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kSearchThreads = 1024;  // one block an SM
constexpr int kDenseVQ = 8;   // queries a thread takes at once: bit lookups
constexpr int kSearchVQ = 2;  // and searches
constexpr int kMaxDirBits = 14;
constexpr int kDenseShift = 5;  // buckets of at most 32 ids carry an occupancy word

struct Keys {  // b's key range and the directory's bucket shift
  int32_t b0, bl;
  int s;
};

__device__ __forceinline__ Keys key_range(const int32_t* __restrict__ b, int n, int r) {
  Keys k;
  k.b0 = __ldg(b);
  k.bl = __ldg(b + n - 1);
  const uint32_t span = static_cast<uint32_t>(k.bl) - static_cast<uint32_t>(k.b0);
  k.s = max(0, 32 - __clz(static_cast<int>(span)) - r);  // r >= 1, so s <= 31
  return k;
}

// x - b[0] as an unsigned offset, for b[0] <= x <= b[n-1].
__device__ __forceinline__ uint32_t offset(int32_t x, const Keys& k) {
  return static_cast<uint32_t>(x) - static_cast<uint32_t>(k.b0);
}

// The bucket of x, for b[0] <= x <= b[n-1]: below 2^r.
__device__ __forceinline__ int bucket(int32_t x, const Keys& k) {
  return static_cast<int>(offset(x, k) >> k.s);
}

// x's bit in its bucket's occupancy word (dense buckets only).
__device__ __forceinline__ uint32_t bit(int32_t x, const Keys& k) {
  return 1u << (offset(x, k) & ((1u << k.s) - 1));
}

// The pre-pass, one thread per key: dir[u].x = the first i with
// bucket(b[i]) >= u; dir[u].y = dir[u + 1].x where buckets are searched,
// the bucket's occupancy word where they are dense. Thread i writes
// dir[u].x = i for u in (bucket(b[i-1]), bucket(b[i])] and, searched, the
// .y of the entry before each; dense, the empty buckets' words (0) and, as
// the first key of its bucket, the bucket's word: the OR of the bits of
// its warp's keys in the bucket and, where the bucket runs on into the
// next warp, of those keys (at most 31 more). The last key's thread ends
// the directory at last = bucket(b[n-1]). Every entry up to there is
// written exactly once, without atomics; the search reads no entry beyond.
__global__ void directory_kernel(const int32_t* __restrict__ b, int n, int r,
                                 int2* __restrict__ dir) {
  const Keys k = key_range(b, n, r);
  const bool dense = k.s <= kDenseShift;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned live = __ballot_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const int32_t x = __ldg(b + i);
  const int hi = bucket(x, k);
  const int lo = i == 0 ? -1 : bucket(__ldg(b + i - 1), k);
  // OR of the bits of this and later lanes of the warp in the same bucket
  // (a bucket's keys are consecutive): a segmented scan by shuffles.
  uint32_t word = dense ? bit(x, k) : 0u;
  if (dense) {
    const int lane = threadIdx.x & 31;
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t w = __shfl_down_sync(live, word, d);
      const int h = __shfl_down_sync(live, hi, d);
      if (lane + d < 32 && ((live >> (lane + d)) & 1u) && h == hi) word |= w;
    }
  }
  for (int u = lo + 1; u <= hi; ++u) {
    dir[u].x = static_cast<int32_t>(i);
    if (!dense && u > 0) dir[u - 1].y = static_cast<int32_t>(i);
    if (dense && u < hi) dir[u].y = 0;
  }
  if (dense && hi > lo) {
    uint32_t all = word;
    // its keys in later warps, 4 loads at a time
    for (long long j = (i | 31) + 1; j < n; j += 4) {
      int32_t y[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) y[t] = j + t < n ? __ldg(b + j + t) : k.bl;
      bool more = true;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        more = more && j + t < n && bucket(y[t], k) == hi;
        if (more) all |= bit(y[t], k);
      }
      if (!more) break;
    }
    dir[hi].y = static_cast<int32_t>(all);
  }
  if (i == n - 1) {
    dir[hi + 1].x = n;
    if (!dense) dir[hi].y = n;
  }
}

// Queries i0, i0 + threads, ... (kVQ of them) into their keys; a query
// past q gets b[0] and is not written.
template <int kVQ>
__device__ __forceinline__ void load_keys(const int32_t* __restrict__ a, long long i0,
                                          long long threads, int q, const Keys& k,
                                          int32_t (&key)[kVQ]) {
#pragma unroll
  for (int j = 0; j < kVQ; ++j) {
    const long long i = i0 + j * threads;
    key[j] = i < q ? __ldg(a + i) : k.b0;
  }
}

template <int kVQ>
__device__ __forceinline__ void store(uint8_t* __restrict__ mask, int32_t* __restrict__ pos,
                                      long long i0, long long threads, int q,
                                      const bool (&hit)[kVQ], const int (&at)[kVQ]) {
#pragma unroll
  for (int j = 0; j < kVQ; ++j) {
    const long long i = i0 + j * threads;
    if (i < q) {
      mask[i] = hit[j] ? 1 : 0;
      pos[i] = hit[j] ? at[j] : -1;
    }
  }
}

__global__ void __launch_bounds__(kSearchThreads)
    search_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                  const int2* __restrict__ dir, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ pos, int q, int n, int r) {
  const Keys k = key_range(b, n, r);
  const long long threads = static_cast<long long>(gridDim.x) * kSearchThreads;
  const long long g = static_cast<long long>(blockIdx.x) * kSearchThreads + threadIdx.x;
  if (k.s <= kDenseShift) {
    // A bucket is at most 32 ids wide: bit t of its word is set when
    // b[0] + (u << s) + t is a key, and that key sits at dir[u].x plus
    // the set bits below t. One 8-byte load a query; no load of b.
    const uint32_t low = (1u << k.s) - 1;
    for (long long i0 = g; i0 < q; i0 += kDenseVQ * threads) {
      int32_t key[kDenseVQ];
      load_keys(a, i0, threads, q, k, key);
      bool hit[kDenseVQ];
      int at[kDenseVQ];
#pragma unroll
      for (int j = 0; j < kDenseVQ; ++j) {
        const bool in = key[j] >= k.b0 && key[j] <= k.bl;
        const int2 e = __ldg(dir + (in ? bucket(key[j], k) : 0));
        const uint32_t t = offset(key[j], k) & low;
        hit[j] = in && ((static_cast<uint32_t>(e.y) >> t) & 1u);
        at[j] = e.x + __popc(static_cast<uint32_t>(e.y) & ((1u << t) - 1u));
      }
      store(mask, pos, i0, threads, q, hit, at);
    }
    return;
  }
  for (long long i0 = g; i0 < q; i0 += kSearchVQ * threads) {
    int32_t key[kSearchVQ];
    load_keys(a, i0, threads, q, k, key);
    int lo[kSearchVQ], hi[kSearchVQ];
    bool eq[kSearchVQ];  // b[hi] == key, where hi was set by the search
#pragma unroll
    for (int j = 0; j < kSearchVQ; ++j) {
      const bool in = key[j] >= k.b0 && key[j] <= k.bl;
      const int2 e = __ldg(dir + (in ? bucket(key[j], k) : 0));
      lo[j] = in ? e.x : (key[j] > k.bl ? n : 0);
      hi[j] = in ? e.y : lo[j];
      eq[j] = false;
    }
    // The lower bound lies in [lo, hi]: below dir[u] every key is in an
    // earlier bucket (smaller), from dir[u + 1] on in a later one (larger).
    for (bool open = true; open;) {
      int32_t v[kSearchVQ];
#pragma unroll
      for (int j = 0; j < kSearchVQ; ++j) {  // the loads, issued together
        const int mid = static_cast<int>((static_cast<uint32_t>(lo[j]) + hi[j]) >> 1);
        v[j] = lo[j] < hi[j] ? __ldg(b + mid) : 0;
      }
      open = false;
#pragma unroll
      for (int j = 0; j < kSearchVQ; ++j) {
        if (lo[j] < hi[j]) {
          const int mid = static_cast<int>((static_cast<uint32_t>(lo[j]) + hi[j]) >> 1);
          if (v[j] < key[j]) {
            lo[j] = mid + 1;
          } else {
            hi[j] = mid;
            eq[j] = v[j] == key[j];
          }
        }
        open |= lo[j] < hi[j];
      }
    }
    // A bound the search never lowered is dir[u + 1], a key of a later
    // bucket (or n): eq stays false, a miss.
    store(mask, pos, i0, threads, q, eq, lo);
  }
}

}  // namespace

// dir: scratch of 2^r + 1 int32 pairs, allocated by the caller;
// 1 <= r <= kMaxDirBits.
REPRO_EXPORT int intersect_launch(const void* a, const void* b, void* mask, void* pos, void* dir,
                                  int q, int n, int r, void* stream) {
  if (q <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || r < 1 || r > kMaxDirBits) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;  // the persistent grid: one block an SM, fewer for a small q
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (q + static_cast<long long>(kSearchThreads) - 1) / kSearchThreads;
  const auto blocks = static_cast<unsigned int>(std::min(want, static_cast<long long>(sms)));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* b32 = static_cast<const int32_t*>(b);
  int2* dir2 = static_cast<int2*>(dir);
  directory_kernel<<<grid_for(n), kThreads, 0, st>>>(b32, n, r, dir2);
  search_kernel<<<blocks, kSearchThreads, 0, st>>>(
      static_cast<const int32_t*>(a), b32, dir2, static_cast<uint8_t*>(mask),
      static_cast<int32_t*>(pos), q, n, r);
  return static_cast<int>(cudaGetLastError());
}
