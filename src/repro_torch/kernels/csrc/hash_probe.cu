// Batched open-addressing hash probe (K1).
//
// Replaces: src/repro/kernels/hash_probe.py, _probe_kernel / hash_probe_pallas.
// Computes: for each query row q (K int32 keys), the home slot
// h = mix32(q) & (cap - 1), then up to `budget` linear-probing steps over
// slots[h + p]; the result is the first slot entry whose key row equals q,
// or -1 when an empty slot (-1) or the end of the budget comes first.
//
// What bounds it on the H100: bytes. Each query reads its K keys once and
// writes one int32; each probe step is one 4-byte slot read plus a K-key
// row read at a data-dependent address. At load factor <= 0.5 almost every
// lane resolves in one or two steps, so the traffic is about
// Q * (8 K + 12) bytes against 3.35 TB/s, plus the latency of two dependent
// gathers per step.
//
// What the design does about it: one thread per query row, so neighbouring
// threads read neighbouring query rows (coalesced) and each thread leaves
// its loop at its first hit or empty slot instead of paying the whole
// budget. The Pallas kernel keeps the table resident in VMEM per block;
// here the slots and key rows stay in device memory, where the 50 MB L2
// holds the hot part of a table, and no shared-memory staging is needed.
#include "common.cuh"

namespace {

// mix32 of the reference, in uint32: the multiply wraps mod 2^32 and the
// shift is logical, exactly as jax.lax.shift_right_logical on int32.
__device__ __forceinline__ uint32_t mix32_row(const int32_t* row, int k) {
  uint32_t h = 374761393u;
  for (int i = 0; i < k; ++i) {
    const uint32_t c = static_cast<uint32_t>(row[i]);
    h = (h ^ (c * 0xCC9E2D51u)) * 0x9E3779B9u;
    h ^= h >> 15;
  }
  return h;
}

__global__ void hash_probe_kernel(const int32_t* __restrict__ slots,
                                  const int32_t* __restrict__ table_keys,
                                  const int32_t* __restrict__ query_keys,
                                  int32_t* __restrict__ out, int nq, int k,
                                  int nkeys, int cap, int budget) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= nq) return;
  const int32_t* q = query_keys + j * k;
  const uint32_t h = mix32_row(q, k) & static_cast<uint32_t>(cap - 1);
  int32_t res = -1;
  for (int p = 0; p < budget; ++p) {
    const int32_t cand = slots[h + p];
    if (cand < 0) break;  // empty slot: the key is absent
    const int32_t* row = table_keys + static_cast<long long>(min(cand, nkeys - 1)) * k;
    bool eq = true;
    for (int i = 0; i < k; ++i) eq &= row[i] == q[i];
    if (eq) {
      res = cand;
      break;
    }
  }
  out[j] = res;
}

}  // namespace

REPRO_EXPORT int hash_probe_launch(const void* slots, const void* table_keys,
                                   const void* query_keys, void* out, int nq,
                                   int k, int nkeys, int cap, int budget,
                                   void* stream) {
  if (nq > 0) {
    hash_probe_kernel<<<grid_for(nq), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(slots), static_cast<const int32_t*>(table_keys),
        static_cast<const int32_t*>(query_keys), static_cast<int32_t*>(out), nq, k,
        nkeys, cap, budget);
  }
  return static_cast<int>(cudaGetLastError());
}
