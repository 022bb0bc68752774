"""The kernel op layer the executor calls: the hash-table build and the
wrappers that prepare each kernel's inputs.

Every op runs on the device of its input tensors. The hash-table *build*
is sort-based: after sorting by home slot, slot assignment is
`slot_i = i + cummax(h_i - i)` (an associative scan, seg_scan.max_scan),
so a sort and a scan are all it needs. The probe, the expansion, the
compaction, the radix rank and the sorted-set intersection are the
kernels (K1-K5); their prefix sums are computed here, outside the
kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import seg_scan
from repro_torch.kernels.compact import compact
from repro_torch.kernels.csr_expand import csr_expand
from repro_torch.kernels.hash_probe import PROBE_BUDGET, hash_probe, mix32
from repro_torch.kernels.intersect import intersect
from repro_torch.kernels.radix_sort import segmented_sort  # noqa: F401  (re-exported)


class Table(NamedTuple):
    slots: torch.Tensor  # (cap + budget,) int32 row index or -1
    keys: torch.Tensor  # (N, K) int32 key rows
    max_disp: torch.Tensor  # () int32: max probe distance used at build


def _next_pow2(n: int) -> int:
    return max(8, 1 << (max(1, 2 * n) - 1).bit_length())


def _build(keys: torch.Tensor, cap: int, budget: int = PROBE_BUDGET) -> Table:
    n = keys.shape[0]
    device = keys.device
    h = mix32(keys) & (cap - 1)
    order = torch.argsort(h, stable=True).to(torch.int32)  # jnp.argsort is stable
    hs = h[order]
    idx = torch.arange(n, dtype=torch.int32, device=device)
    disp = seg_scan.max_scan(hs - idx)
    slot = idx + disp
    max_disp = (
        (slot - hs).max() if n else torch.zeros((), dtype=torch.int32, device=device)
    )
    # slots past the table are dropped: they land on one extra slot that
    # is cut off afterwards (real slots are unique, so nothing else collides)
    size = cap + budget
    slots = torch.full((size + 1,), -1, dtype=torch.int32, device=device)
    slots[torch.where(slot < size, slot, size)] = order
    return Table(slots=slots[:size], keys=keys, max_disp=max_disp)


def build_table(keys: torch.Tensor, budget: int = PROBE_BUDGET) -> Table:
    """keys: (N, K) int32, rows unique. Linear probing, load factor <= 0.5,
    no wraparound (tail margin = `budget`). max_disp >= budget would mean
    an overflow, astronomically unlikely at <= 0.5 load; tests check it."""
    if keys.dim() != 2:
        raise ValueError("keys must be (N, K)")
    return _build(keys.to(torch.int32).contiguous(), _next_pow2(keys.shape[0]), budget)


def probe(table: Table, queries: torch.Tensor) -> torch.Tensor:
    """queries: (Q, K) int32, any strides (K1 reads them where they lie) ->
    (Q,) int32 row index in table.keys or -1."""
    if table.keys.shape[0] == 0 or queries.shape[0] == 0:
        return torch.full((queries.shape[0],), -1, dtype=torch.int32, device=queries.device)
    budget = table.slots.shape[0] - _next_pow2(table.keys.shape[0])
    return hash_probe(table.slots, table.keys, queries, budget)


def intersect_sorted(a: torch.Tensor, b: torch.Tensor):
    """a: (Q,) int32 queries; b: (N,) int32 sorted and duplicate-free.
    Returns (mask, pos): (Q,) bool membership of each a[i] in b, and
    (Q,) int32 its position in b or -1."""
    if b.shape[0] == 0 or a.shape[0] == 0:
        return (
            torch.zeros(a.shape[0], dtype=torch.bool, device=a.device),
            torch.full((a.shape[0],), -1, dtype=torch.int32, device=a.device),
        )
    return intersect(a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous())


def _expand(starts, base, total, capacity):
    fr, member = csr_expand(starts, base, total.reshape(1), capacity)
    return fr, member, fr >= 0, total  # K2 writes -1 past the total


def expand_counted(base: torch.Tensor, counts: torch.Tensor, capacity: int):
    """Variable-fanout expansion: frontier row i contributes `counts[i]`
    outputs, the j-th reading position base[i] + j. Returns
    (fr, member, valid, total) with static `capacity`; total is a () int32
    device tensor. Rows with count 0 contribute nothing."""
    counts = counts.to(torch.int32)
    cum = torch.cumsum(counts, dim=0, dtype=torch.int32)
    total = cum[-1]
    starts = cum - counts
    return _expand(starts, base.to(torch.int32).contiguous(), total, capacity)


def compact_indices(valid: torch.Tensor, out_capacity: int):
    """Frontier compaction: squeeze the lanes where `valid` is True densely
    into the front of a buffer of `out_capacity` slots. Returns (src,
    live): src[j] is the source lane of output slot j (-1 beyond the live
    count), live the () int32 number of valid lanes. Overflow iff
    live > out_capacity, detected by the caller."""
    n = valid.shape[0]
    device = valid.device
    if n == 0:
        return (
            torch.full((out_capacity,), -1, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device),
        )
    csum = torch.cumsum(valid, dim=0, dtype=torch.int32)
    live = csum[-1]
    return compact(csum, live.reshape(1), out_capacity), live


def csr_expand_capped(offsets: torch.Tensor, groups: torch.Tensor, capacity: int):
    """Expand CSR members of each groups[i] into a `capacity` buffer.
    Returns (fr, member, valid, total). offsets: (G+1,) int32; groups: (F,)."""
    device = groups.device
    if groups.shape[0] == 0:
        z = torch.full((capacity,), -1, dtype=torch.int32, device=device)
        return z, z.clone(), torch.zeros(capacity, dtype=torch.bool, device=device), (
            torch.zeros((), dtype=torch.int32, device=device)
        )
    counts = offsets[groups + 1] - offsets[groups]
    base = offsets[groups].to(torch.int32).contiguous()
    cum = torch.cumsum(counts, dim=0, dtype=torch.int32)
    return _expand(cum - counts.to(torch.int32), base, cum[-1], capacity)
