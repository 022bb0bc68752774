"""Vectorized hash tables, group-by and CSR expansion over tensors.

The port of the reference's host-side kit (`repro.relational.npkit`): the
same names and the same results, with the work done by the kernel ops on
the device of the input tensors:

* `HashTable` builds with `ops.build_table` and probes with the hash-probe
  kernel (K1): linear probing in a power-of-two table, composite keys
  compared column by column, -1 on a miss. The hash is K1's `mix32`; the
  contract is probe()'s result, not the layout of the slots.
* `group_by` sorts with the segmented radix sort (K4) when every key is
  non-negative, else with the compiled path's stable comparison sort;
  both give numpy's `lexsort` permutation. Its group starts come from the compaction (K3).
* `csr_expand` is the CSR-expansion kernel (K2) at a capacity of exactly
  the expansion's total.
* `mix64` stays host numpy, bit for bit the reference's: the distributed
  driver's hypercube partition (core/distributed.py) hashes host columns
  with it, so every row lands on the same shard as in the reference.

Index outputs are int32 tensors. Each function reads a size back to the
host once (a group count, an expansion total, a live count) and never
loops over rows.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.hash_probe import PROBE_BUDGET

_I32 = torch.int32
I32_MAX = 2**31 - 1

_FNV = np.int64(-3750763034362895579)  # 0xCBF29CE484222325 as signed
_K1 = np.int64(-7046029254386353131)  # 0x9E3779B97F4A7C15
_K2 = np.int64(-4417276706812531889)  # 0xBF58476D1CE4E5B9


def mix64(cols: list[np.ndarray]) -> np.ndarray:
    """Column-wise 64-bit mix (splitmix-style) of host columns, vectorized
    over rows: int64 arithmetic with wrapping multiplies and an arithmetic
    shift, as the reference computes it."""
    with np.errstate(over="ignore"):
        h = np.full(len(cols[0]) if cols else 0, _FNV, dtype=np.int64)
        for c in cols:
            h = (h ^ (c.astype(np.int64) * _K1)) * _K2
            h ^= h >> np.int64(29)
    return h


def _empty(device) -> torch.Tensor:
    return torch.zeros(0, dtype=_I32, device=device)


def flatnonzero(mask: torch.Tensor) -> torch.Tensor:
    """The positions where `mask` is True, in order (int32), through the
    compaction kernel (K3)."""
    live = int(mask.sum())
    if live == 0:
        return _empty(mask.device)
    return ops.compact_indices(mask, live)[0]


class HashTable:
    """Maps composite integer keys -> their row index in the key columns.

    build expects *unique* key rows (the trie build dedups first); probe()
    returns the key-row index per query, -1 on a miss. Keys are int32.
    The table's displacement budget starts at the kernel's 32 slots and
    doubles until the build's longest displacement fits inside it, so no
    key lies beyond a probe's reach."""

    def __init__(self, key_cols: list[torch.Tensor]):
        self.keys = torch.stack([c.to(_I32) for c in key_cols], dim=1).contiguous()
        self.n = self.keys.shape[0]
        budget = PROBE_BUDGET
        self.table = ops.build_table(self.keys, budget=budget)
        while self.n and int(self.table.max_disp) >= budget:
            budget *= 2
            self.table = ops.build_table(self.keys, budget=budget)

    def probe(self, query_cols: list[torch.Tensor]) -> torch.Tensor:
        """One (K, Q) block of the query columns, which K1 reads
        column-major through its transpose."""
        q = torch.stack([c.to(_I32) for c in query_cols], dim=0)
        return ops.probe(self.table, q.t())


def group_by(key_cols: list[torch.Tensor]):
    """Vectorized group-by over composite keys.

    Returns (unique_key_cols, group_of_row, order, offsets) where `order`
    permutes rows so each group is contiguous and `offsets` is the CSR
    boundary array (len = n_groups + 1). Groups are in lexicographic order
    and rows with equal keys keep their order."""
    cols = [c.to(_I32) for c in key_cols]
    n = cols[0].shape[0]
    device = cols[0].device
    if n == 0:
        return cols, _empty(device), _empty(device), torch.zeros(1, dtype=_I32, device=device)
    ext = torch.stack([torch.stack([c.min(), c.max()]) for c in cols]).cpu()
    # a constant column orders nothing: a stable sort by it is the identity
    keyed = [(c, lo, hi) for c, (lo, hi) in zip(cols, ext.tolist()) if lo != hi]
    if not keyed:
        order = torch.arange(n, dtype=_I32, device=device)
    elif all(lo >= 0 for _, lo, _ in keyed):
        order = ops.segmented_sort(
            [c for c, _, _ in keyed], tuple(hi.bit_length() for _, _, hi in keyed)
        )
    else:
        from repro_torch.core.compiled import _lexsort  # deferred: core imports this module

        order = _lexsort([c for c, _, _ in keyed])
    sorted_cols = [c[order] for c in cols]
    neq = torch.zeros(n, dtype=torch.bool, device=device)
    neq[0] = True
    for c in sorted_cols:
        neq[1:] |= c[1:] != c[:-1]
    starts = flatnonzero(neq)
    uniq = [c[starts] for c in sorted_cols]
    group_of_row = torch.empty(n, dtype=_I32, device=device)
    group_of_row[order] = torch.cumsum(neq, dim=0, dtype=_I32) - 1
    offsets = torch.cat([starts, torch.full((1,), n, dtype=_I32, device=device)])
    return uniq, group_of_row, order, offsets


def csr_expand(offsets: torch.Tensor, groups: torch.Tensor):
    """Expand each requested group into its member positions.

    Given CSR `offsets` and an array of group ids (one per frontier row),
    returns (row_index, member_position), int32: `row_index[i]` is the
    frontier row and `member_position[i]` indexes into the CSR value
    array, in frontier order. The total is summed in int64 and read once;
    one beyond int32 raises ValueError before anything is allocated."""
    device = groups.device
    if groups.shape[0] == 0:
        return _empty(device), _empty(device)
    counts = offsets[groups + 1] - offsets[groups]
    total = int(counts.sum(dtype=torch.int64))
    if total > I32_MAX:
        raise ValueError(f"csr_expand: the expansion's total {total} exceeds int32")
    if total == 0:
        return _empty(device), _empty(device)
    cum = torch.cumsum(counts, dim=0, dtype=_I32)
    base = offsets[groups].to(_I32).contiguous()
    return ops.csr_expand((cum - counts.to(_I32)).contiguous(), base, cum[-1:], total)
