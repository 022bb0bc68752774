// K1 variant: query rows staged in shared memory by TMA bulk copies over a
// persistent grid. A block walks tiles of kNT * V consecutive query rows
// (tile blockIdx.x, then + gridDim.x, ...); one thread brings each tile's
// span, rounded out to 16-byte bounds, into shared memory with one
// cp.async.bulk on an mbarrier, double-buffered: the next tile's copy is in
// flight while this one probes. The grid is the tiles or as many blocks as
// the SMs hold, whichever is fewer. A tile's rows are probed as
// hash_probe.cu's probe_rows probes them, V = 2 rows a thread on a large
// call and 1 on a smaller one, in blocks of its 128 threads; probe_wide is
// its own; same C interface. Compared with it by tools/k1_ab.py.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRows = 2;  // query rows a thread on a large call
constexpr int kNT = 128;  // threads a block

// mix32 of the reference, in uint32: the multiply wraps mod 2^32 and the
// shift is logical, exactly as jax.lax.shift_right_logical on int32.
__device__ __forceinline__ uint32_t mix_step(uint32_t h, int32_t key) {
  h = (h ^ (static_cast<uint32_t>(key) * 0xCC9E2D51u)) * 0x9E3779B9u;
  return h ^ (h >> 15);
}
constexpr uint32_t kMixSeed = 374761393u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Ints between the 16-byte bound below p and p.
__device__ __forceinline__ int lead_ints(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 2);
}

// K = 1..4: V query rows a thread; per tile, rows tile * kNT * V +
// threadIdx.x + v * kNT, their probes in lockstep steps: every live row's
// slot load, then every candidate's key-row load, then the compares.
template <int K, int V>
__global__ void __launch_bounds__(kNT)
    probe_tiles(const int32_t* __restrict__ slots, const int32_t* __restrict__ keys,
                const int32_t* __restrict__ queries, int32_t* __restrict__ out, int nq,
                int nkeys, int cap, int budget) {
  constexpr int kT = kNT * V;       // rows a tile
  constexpr int kBuf = kT * K + 8;  // ints a buffer: a tile and its rounding
  __shared__ __align__(16) int32_t buf[2][kBuf];
  __shared__ __align__(8) uint64_t bar[2];
  const long long ntiles = (static_cast<long long>(nq) + kT - 1) / kT;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&bar[b])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long tile, int b) {  // thread 0: tile's rows into buf[b]
    const long long r0 = tile * kT, r1 = min(r0 + kT, static_cast<long long>(nq));
    const int32_t* p = queries + r0 * K;
    const uintptr_t lo = reinterpret_cast<uintptr_t>(p) & ~uintptr_t{15};
    const uintptr_t hi = (reinterpret_cast<uintptr_t>(queries + r1 * K) + 15) & ~uintptr_t{15};
    const uint32_t bytes = static_cast<uint32_t>(hi - lo), b_addr = smem_addr(&bar[b]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b_addr),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(buf[b])), "l"(lo), "r"(bytes), "r"(b_addr)
        : "memory");
  };
  long long tile = blockIdx.x;
  if (threadIdx.x == 0 && tile < ntiles) issue(tile, 0);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int b = it & 1;
    if (threadIdx.x == 0 && tile + gridDim.x < ntiles) issue(tile + gridDim.x, b ^ 1);
    const uint32_t parity = (it >> 1) & 1;
    for (uint32_t done = 0; !done;) {
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(smem_addr(&bar[b])), "r"(parity)
          : "memory");
    }
    const int32_t* tq = buf[b] + lead_ints(queries + tile * kT * K);
    const long long j0 = tile * kT + threadIdx.x;
    int32_t q[V][K], res[V];
    int pos[V], end[V];
    unsigned live = 0;  // bit v: row v still probing
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long j = j0 + v * kNT;
      const int r = threadIdx.x + v * kNT;
      res[v] = -1;
      pos[v] = end[v] = 0;
      uint32_t h = kMixSeed;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        q[v][i] = j < nq ? tq[r * K + i] : 0;
        h = mix_step(h, q[v][i]);
      }
      if (j < nq && budget > 0) {
        pos[v] = static_cast<int>(h & static_cast<uint32_t>(cap - 1));
        end[v] = pos[v] + budget;
        live |= 1u << v;
      }
    }
    while (live) {
      int32_t cand[V], row[V][K];
#pragma unroll
      for (int v = 0; v < V; ++v) cand[v] = live >> v & 1 ? __ldg(slots + pos[v]) : -1;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (cand[v] >= 0) {
          const int32_t* p = keys + static_cast<long long>(min(cand[v], nkeys - 1)) * K;
#pragma unroll
          for (int i = 0; i < K; ++i) row[v][i] = __ldg(p + i);
        } else {
          live &= ~(1u << v);  // an empty slot: the key is absent
#pragma unroll
          for (int i = 0; i < K; ++i) row[v][i] = 0;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (live >> v & 1) {
          bool eq = true;
#pragma unroll
          for (int i = 0; i < K; ++i) eq &= row[v][i] == q[v][i];
          if (eq) {
            res[v] = cand[v];
            live &= ~(1u << v);
          } else if (++pos[v] == end[v]) {
            live &= ~(1u << v);
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long j = j0 + v * kNT;
      if (j < nq) __stcs(out + j, res[v]);
    }
    __syncthreads();  // every thread is done with buf[b] before it is refilled
  }
}

// K > 4: one thread a row, the key width a runtime bound.
__global__ void __launch_bounds__(kNT)
    probe_wide(const int32_t* __restrict__ slots, const int32_t* __restrict__ keys,
               const int32_t* __restrict__ queries, int32_t* __restrict__ out, int nq, int k,
               int nkeys, int cap, int budget) {
  const long long j = static_cast<long long>(blockIdx.x) * kNT + threadIdx.x;
  if (j >= nq) return;
  const int32_t* q = queries + j * k;
  uint32_t h = kMixSeed;
  for (int i = 0; i < k; ++i) h = mix_step(h, q[i]);
  h &= static_cast<uint32_t>(cap - 1);
  int32_t res = -1;
  for (int p = 0; p < budget; ++p) {
    const int32_t cand = __ldg(slots + h + p);
    if (cand < 0) break;  // empty slot: the key is absent
    const int32_t* row = keys + static_cast<long long>(min(cand, nkeys - 1)) * k;
    bool eq = true;
    for (int i = 0; i < k; ++i) eq &= __ldg(row + i) == q[i];
    if (eq) {
      res = cand;
      break;
    }
  }
  __stcs(out + j, res);
}

unsigned int blocks_for(int nq, int rows_per_thread) {
  const long long per_block = static_cast<long long>(kNT) * rows_per_thread;
  return static_cast<unsigned int>((static_cast<long long>(nq) + per_block - 1) / per_block);
}

// probe_tiles<K, V> over a grid of the tiles or the blocks the SMs hold,
// whichever is fewer.
template <int K, int V>
void launch_tiles(const int32_t* slots, const int32_t* keys, const int32_t* queries,
                  int32_t* out, int nq, int nkeys, int cap, int budget, cudaStream_t stream,
                  int sms) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, probe_tiles<K, V>, kNT, 0);
  const long long tiles = (static_cast<long long>(nq) + kNT * V - 1) / (kNT * V);
  const long long grid = std::min(tiles, static_cast<long long>(std::max(per_sm, 1)) * sms);
  probe_tiles<K, V><<<static_cast<unsigned int>(grid), kNT, 0, stream>>>(
      slots, keys, queries, out, nq, nkeys, cap, budget);
}

// K's kernel: kRows rows a thread when the call has that many for every
// thread the card holds, else one, so that a small call spreads over more
// SMs.
template <int K>
void launch_k(const int32_t* slots, const int32_t* keys, const int32_t* queries, int32_t* out,
              int nq, int nkeys, int cap, int budget, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (static_cast<long long>(nq) >= static_cast<long long>(kRows) * sms * per_sm) {
    launch_tiles<K, kRows>(slots, keys, queries, out, nq, nkeys, cap, budget, stream, sms);
  } else {
    launch_tiles<K, 1>(slots, keys, queries, out, nq, nkeys, cap, budget, stream, sms);
  }
}

}  // namespace

REPRO_EXPORT int hash_probe_launch(const void* slots, const void* table_keys,
                                   const void* query_keys, void* out, int nq,
                                   int k, int nkeys, int cap, int budget,
                                   void* stream) {
  if (nq > 0) {
    const auto* s = static_cast<const int32_t*>(slots);
    const auto* t = static_cast<const int32_t*>(table_keys);
    const auto* q = static_cast<const int32_t*>(query_keys);
    auto* o = static_cast<int32_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (k) {
      case 1: launch_k<1>(s, t, q, o, nq, nkeys, cap, budget, st); break;
      case 2: launch_k<2>(s, t, q, o, nq, nkeys, cap, budget, st); break;
      case 3: launch_k<3>(s, t, q, o, nq, nkeys, cap, budget, st); break;
      case 4: launch_k<4>(s, t, q, o, nq, nkeys, cap, budget, st); break;
      default:
        probe_wide<<<blocks_for(nq, 1), kNT, 0, st>>>(s, t, q, o, nq, k, nkeys, cap, budget);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
