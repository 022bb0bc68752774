// Batched open-addressing hash probe (K1).
//
// Replaces: src/repro/kernels/hash_probe.py, _probe_kernel / hash_probe_pallas.
// Computes: for each query row q (K int32 keys), the home slot
// h = mix32(q) & (cap - 1), then up to `budget` linear-probing steps over
// slots[h + p]; the result is the first slot entry whose key row equals q,
// or -1 when an empty slot (< 0) or the end of the budget comes first. A
// candidate past the table's last row is clamped to it for the compare.
//
// What bounds it on the H100: the load path through L1, not HBM bytes. The
// bytes are the query stream (Q * K * 4 in, Q * 4 out) and the table
// sectors the probes reach, which are few and hot (7.1 MB of the main
// path's 38 MB table on LSQB's Zipf 1.4 `knows`) and stay in L1 and the
// 50 MB L2. Each probe step is two dependent gathers of scattered words,
// the slot and then the candidate's key row, and L1 serves most of them:
// sending the table reads past L1 (ld.global.cg) is slower. On a
// large call the card is full of threads and the cost is the gathers'
// number; on a small one it is the length of each lane's chain of
// dependent loads. Reading the query rows column-major (below) left the
// largest call of GAP urand's triangle (276,865,024 rows, K = 3) as fast
// as row-major, 23.6 ms on an H100 and about half of that query's device
// time: the query stream is not what bounds it.
//
// What the design does about it:
//   - A large call (at least kLargeCall = 4 rows for every thread the
//     card holds) takes probe_rows: a thread owns kRows = 2 query rows and
//     advances their probes in lockstep, both rows' slot loads, then both
//     key-row loads. Two independent chains a thread at 32 registers or
//     fewer, so every SM still holds 2,048 threads; one row, or four, is
//     slower.
//   - A smaller call takes probe_sector: one row a thread, and a probe step
//     reads the aligned 16-byte granule of slots that holds slots[pos] in
//     one load, takes every slot from pos to the granule's end up to the
//     first empty one as candidates and loads all their key rows before it
//     compares them in probe order. The chain of dependent loads is then
//     granule -> key rows, not slot -> key row a slot: shorter on a call too
//     small to hide it, but more loads and registers a lane, so slower on a
//     large call.
//   - K (1 to 4) is a template parameter: the hash and the compare unroll,
//     and a key row is K read-only 4-byte loads, cached in L1.
//   - Key i of query row j is read at queries[j * s0 + i * s1] (64-bit
//     offsets): any (Q, K) view, so the caller hands K1 its key columns
//     where they lie and nothing is stacked or copied for it. The compiled
//     executor gathers each probe's columns into one column-major block
//     (s0 = 1, s1 = the block's row count), so a warp's load of one key is
//     32 consecutive words, one coalesced 128-byte line; a row-major block
//     (s0 = K, s1 = 1) spreads the same load over K lines.
//   - Query rows are read and results written as streaming (evict-first)
//     accesses, so that the stream does not push table lines out of L1
//     and L2.
//   - Blocks of 128 threads (kNT).
// tools/k1_variants/ holds what was measured against it with tools/k1_ab.py
// and found slower (PERF.md): the granule probe on large calls, L2
// evict-last on the table, the table past L1, 256-thread blocks, and one or
// four rows a thread on large calls. Query tiles staged in shared memory by
// TMA bulk copies over a persistent grid were 1.7x slower on row-major
// queries, and have no place in a column-major block.
// Wider keys (K > 4) take probe_wide: one thread a row, the key width a
// runtime loop bound.
#include "common.cuh"

namespace {

constexpr int kRows = 2;       // query rows a thread of probe_rows
constexpr int kLargeCall = 4;  // a call of this many rows for every thread the
                               // card holds, or more, takes probe_rows
constexpr int kNT = 128;       // threads a block

// mix32 of the reference, in uint32: the multiply wraps mod 2^32 and the
// shift is logical, exactly as jax.lax.shift_right_logical on int32.
__device__ __forceinline__ uint32_t mix_step(uint32_t h, int32_t key) {
  h = (h ^ (static_cast<uint32_t>(key) * 0xCC9E2D51u)) * 0x9E3779B9u;
  return h ^ (h >> 15);
}
constexpr uint32_t kMixSeed = 374761393u;

// K = 1..4 on a large call: V query rows a thread, rows blockIdx.x * kNT *
// V + threadIdx.x + v * kNT, their probes in lockstep steps: every live
// row's slot load, then every candidate's key-row load, then the compares.
template <int K, int V>
__global__ void __launch_bounds__(kNT)
    probe_rows(const int32_t* __restrict__ slots, const int32_t* __restrict__ keys,
               const int32_t* __restrict__ queries, long long s0, long long s1,
               int32_t* __restrict__ out, int nq, int nkeys, int cap, int budget) {
  const long long j0 = static_cast<long long>(blockIdx.x) * kNT * V + threadIdx.x;
  int32_t q[V][K], res[V];
  int pos[V], end[V];
  unsigned live = 0;  // bit v: row v still probing
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long j = j0 + v * kNT;
    res[v] = -1;
    pos[v] = end[v] = 0;
    uint32_t h = kMixSeed;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      q[v][i] = j < nq ? __ldcs(queries + j * s0 + i * s1) : 0;
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
}

// K = 1..4 on a small call: one query row a thread, a probe step a 16-byte
// granule of slots (see the note at the head of the file). A granule not
// wholly inside slots[0, cap + budget) is read one slot a step.
template <int K>
__global__ void __launch_bounds__(kNT)
    probe_sector(const int32_t* __restrict__ slots, const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ queries, long long s0, long long s1,
                 int32_t* __restrict__ out, int nq, int nkeys, int cap, int budget) {
  const long long j = static_cast<long long>(blockIdx.x) * kNT + threadIdx.x;
  if (j >= nq) return;
  int32_t q[K];
  uint32_t h = kMixSeed;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    q[i] = __ldcs(queries + j * s0 + i * s1);
    h = mix_step(h, q[i]);
  }
  const int n = cap + budget;
  int pos = static_cast<int>(h & static_cast<uint32_t>(cap - 1));
  const int end = pos + budget;
  int32_t res = -1;
  bool open = budget > 0;  // the chain goes on past this step
  while (open) {
    const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(slots + pos) >> 2) & 3);
    int first = pos - lead, span = 4, from = lead;
    int32_t cand[4];
    if (first >= 0 && first + 4 <= n) {
      const int4 g = __ldg(reinterpret_cast<const int4*>(slots + first));
      cand[0] = g.x, cand[1] = g.y, cand[2] = g.z, cand[3] = g.w;
    } else {  // the granule leaves the array: this slot alone
      cand[0] = __ldg(slots + pos), cand[1] = cand[2] = cand[3] = -1;
      first = pos, span = 1, from = 0;
    }
    unsigned take = 0;  // bit i: cand[i] is a candidate of this step
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (open && i >= from && i < span) {
        if (first + i >= end || cand[i] < 0) {
          open = false;  // the budget's end or an empty slot
        } else {
          take |= 1u << i;
        }
      }
    }
    int32_t row[4][K];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (take >> c & 1) {
        const int32_t* p = keys + static_cast<long long>(min(cand[c], nkeys - 1)) * K;
#pragma unroll
        for (int i = 0; i < K; ++i) row[c][i] = __ldg(p + i);
      }
    }
    bool hit = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // the first match in probe order
      if (!hit && (take >> c & 1)) {
        bool eq = true;
#pragma unroll
        for (int i = 0; i < K; ++i) eq &= row[c][i] == q[i];
        if (eq) {
          res = cand[c];
          hit = true;
        }
      }
    }
    pos = first + span;
    if (hit || pos >= end) open = false;
  }
  __stcs(out + j, res);
}

// K > 4: one thread a row, the key width a runtime bound.
__global__ void __launch_bounds__(kNT)
    probe_wide(const int32_t* __restrict__ slots, const int32_t* __restrict__ keys,
               const int32_t* __restrict__ queries, long long s0, long long s1,
               int32_t* __restrict__ out, int nq, int k, int nkeys, int cap, int budget) {
  const long long j = static_cast<long long>(blockIdx.x) * kNT + threadIdx.x;
  if (j >= nq) return;
  const int32_t* q = queries + j * s0;
  uint32_t h = kMixSeed;
  for (int i = 0; i < k; ++i) h = mix_step(h, q[i * s1]);
  h &= static_cast<uint32_t>(cap - 1);
  int32_t res = -1;
  for (int p = 0; p < budget; ++p) {
    const int32_t cand = __ldg(slots + h + p);
    if (cand < 0) break;  // empty slot: the key is absent
    const int32_t* row = keys + static_cast<long long>(min(cand, nkeys - 1)) * k;
    bool eq = true;
    for (int i = 0; i < k; ++i) eq &= __ldg(row + i) == q[i * s1];
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

// K's kernel: probe_rows when the call has kLargeCall rows for every thread
// the card holds, else probe_sector.
template <int K>
void launch_k(const int32_t* slots, const int32_t* keys, const int32_t* queries, long long s0,
              long long s1, int32_t* out, int nq, int nkeys, int cap, int budget,
              cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (static_cast<long long>(nq) >= static_cast<long long>(kLargeCall) * sms * per_sm) {
    probe_rows<K, kRows><<<blocks_for(nq, kRows), kNT, 0, stream>>>(
        slots, keys, queries, s0, s1, out, nq, nkeys, cap, budget);
  } else {
    probe_sector<K><<<blocks_for(nq, 1), kNT, 0, stream>>>(slots, keys, queries, s0, s1, out,
                                                           nq, nkeys, cap, budget);
  }
}

}  // namespace

REPRO_EXPORT int hash_probe_launch(const void* slots, const void* table_keys,
                                   const void* query_keys, long long s0, long long s1,
                                   void* out, int nq, int k, int nkeys, int cap,
                                   int budget, void* stream) {
  if (nq > 0) {
    const auto* s = static_cast<const int32_t*>(slots);
    const auto* t = static_cast<const int32_t*>(table_keys);
    const auto* q = static_cast<const int32_t*>(query_keys);
    auto* o = static_cast<int32_t*>(out);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (k) {
      case 1: launch_k<1>(s, t, q, s0, s1, o, nq, nkeys, cap, budget, st); break;
      case 2: launch_k<2>(s, t, q, s0, s1, o, nq, nkeys, cap, budget, st); break;
      case 3: launch_k<3>(s, t, q, s0, s1, o, nq, nkeys, cap, budget, st); break;
      case 4: launch_k<4>(s, t, q, s0, s1, o, nq, nkeys, cap, budget, st); break;
      default:
        probe_wide<<<blocks_for(nq, 1), kNT, 0, st>>>(s, t, q, s0, s1, o, nq, k, nkeys, cap,
                                                       budget);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
