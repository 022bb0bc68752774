"""Batched open-addressing hash-table probe (K1; csrc/hash_probe.cu).

This is the hot loop of Free Join: every plan node probes each non-cover
relation's trie level with the whole frontier as one batch. The table is
built once (ops.build_table) and probed many times.

Layout: `slots` is a flat int32 array of length cap + budget; slots[s]
holds a row index into `table_keys` (or -1 = empty). A query key with home
slot h = mix32(key) & (cap-1) lives within `budget` slots of h (linear
probing, no wrap: the tail margin absorbs the last cluster).

`hash_probe` launches the CUDA kernel for tensors on the card and runs
`hash_probe_plain`, the same lookup written with tensor operations, for
tensors on the CPU. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

PROBE_BUDGET = 32

_C1 = 0x9E3779B9  # Knuth multiplicative
_C2 = 0xCC9E2D51  # murmur3 c1
_M32 = 0xFFFFFFFF

launches = 0


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 `a` in [0, 2**32), without ever leaving
    int64's range: the 16-bit halves of `a` multiply separately."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mix32(cols2d: torch.Tensor) -> torch.Tensor:
    """Mix (N, K) int32 key rows into int32 hashes, bit for bit the
    reference's mix32: uint32 arithmetic (wrapping multiply, logical
    shift) carried out in int64 masked to 32 bits, then reinterpreted."""
    keys = cols2d.to(torch.int64) & _M32
    h = torch.full(cols2d.shape[:-1], 374761393, dtype=torch.int64, device=cols2d.device)
    for i in range(cols2d.shape[-1]):
        h = _mul32(h ^ _mul32(keys[..., i], _C2), _C1)
        h = h ^ (h >> 15)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def hash_probe_plain(
    slots: torch.Tensor, table_keys: torch.Tensor, query_keys: torch.Tensor, budget: int
) -> torch.Tensor:
    """The kernel's lookup as tensor operations: all lanes step together,
    and the loop ends once every lane has hit or met an empty slot."""
    cap = slots.shape[0] - budget
    h = mix32(query_keys) & (cap - 1)
    nkeys = table_keys.shape[0]
    res = torch.full(h.shape, -1, dtype=torch.int32, device=h.device)
    done = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for p in range(budget):
        cand = slots[h + p]
        is_empty = cand < 0
        krow = table_keys[cand.clamp(0, nkeys - 1)]
        hit = ~is_empty & (krow == query_keys).all(dim=-1) & ~done
        res = torch.where(hit, cand, res)
        done = done | hit | is_empty
        if bool(done.all()):
            break
    return res


def hash_probe(
    slots: torch.Tensor, table_keys: torch.Tensor, query_keys: torch.Tensor, budget: int
) -> torch.Tensor:
    """slots: (cap + budget,) int32, cap a power of two; table_keys: (N, K)
    int32 with N >= 1; query_keys: (Q, K) int32, any strides (the kernel
    reads key i of row j at j * stride(0) + i * stride(1), so a view of
    the caller's key columns, such as a column-major (K, Q) block
    transposed, costs no copy). Returns (Q,) int32: the row of table_keys
    equal to each query row, or -1."""
    global launches
    device = _build.common_device(
        "hash_probe", ("query_keys",), slots=slots, table_keys=table_keys,
        query_keys=query_keys,
    )
    cap = slots.shape[0] - budget if slots.dim() == 1 else 0
    if cap <= 0 or cap & (cap - 1):
        raise ValueError("hash_probe: slots must be (cap + budget,) with cap a power of two")
    if table_keys.dim() != 2 or table_keys.shape[0] == 0:
        raise ValueError("hash_probe: table_keys must be (N, K) with N >= 1")
    if query_keys.dim() != 2 or query_keys.shape[1] != table_keys.shape[1]:
        raise ValueError("hash_probe: query_keys must be (Q, K) with the table's K")
    if device.type == "cpu":
        return _build.run_plain(
            "hash_probe", hash_probe_plain, slots, table_keys, query_keys, budget
        )
    out = torch.empty(query_keys.shape[0], dtype=torch.int32, device=device)
    _build.launch(
        "hash_probe", device, slots, table_keys, query_keys, query_keys.stride(0),
        query_keys.stride(1), out, query_keys.shape[0], query_keys.shape[1],
        table_keys.shape[0], cap, budget,
    )
    launches += 1
    return out
