"""Brute-force oracles for the kernel ops, as torch functions.

These are the semantic ground truth: O(N*Q) or host-side implementations
with no tiling, no probe budgets and no capacity tricks. The kernel tests
compare every op against them exactly (all outputs are integers). Results
land on the device of the inputs.
"""
from __future__ import annotations

import numpy as np
import torch


def hash_probe_ref(table_keys: torch.Tensor, query_keys: torch.Tensor) -> torch.Tensor:
    """For each query row, the index of the matching row in table_keys
    (-1 if absent). table_keys: (N, K) unique rows; query_keys: (Q, K)."""
    eq = (query_keys[:, None, :] == table_keys[None, :, :]).all(dim=-1)  # (Q, N)
    idx = eq.to(torch.int32).argmax(dim=1).to(torch.int32)
    return torch.where(eq.any(dim=1), idx, -1)


def intersect_ref(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """For each a[i], whether it occurs in b and its first position there
    (-1 if absent), by brute-force comparison of every pair."""
    eq = a[:, None] == b[None, :]  # (Q, N)
    hit = eq.any(dim=1)
    pos = eq.to(torch.int32).argmax(dim=1).to(torch.int32)
    return hit, torch.where(hit, pos, -1)


def compact_ref(valid: torch.Tensor, out_capacity: int):
    """Dense packing of the True lanes of `valid` into `out_capacity`
    output slots. Returns (src, live): src[j] = lane of the (j+1)-th valid
    lane or -1."""
    lanes = torch.nonzero(valid).flatten().to(torch.int32)
    src = torch.full((out_capacity,), -1, dtype=torch.int32, device=valid.device)
    k = min(len(lanes), out_capacity)
    src[:k] = lanes[:k]
    return src, torch.tensor(len(lanes), dtype=torch.int32, device=valid.device)


def segmented_sort_ref(cols) -> torch.Tensor:
    """Lexicographic sort permutation over `cols` (cols[0] major): stable
    np.lexsort, the exact permutation the radix passes must reproduce."""
    host = [np.asarray(c.cpu()) for c in cols]
    order = np.lexsort(tuple(reversed(host))).astype(np.int32)
    return torch.as_tensor(order, device=cols[0].device)


def csr_expand_ref(offsets: torch.Tensor, groups: torch.Tensor, capacity: int):
    """Expand each groups[i] into its CSR members, densely packed into a
    buffer of `capacity` slots, by enumerating them on the host. Returns
    (frontier_row, member, valid, total)."""
    off = np.asarray(offsets.cpu())
    frs, members = [], []
    for i, g in enumerate(np.asarray(groups.cpu())):
        members.extend(range(off[g], off[g + 1]))
        frs.extend([i] * (off[g + 1] - off[g]))
    total = len(members)
    fr = np.full(capacity, -1, np.int32)
    member = np.full(capacity, -1, np.int32)
    k = min(total, capacity)
    fr[:k] = frs[:k]
    member[:k] = members[:k]
    valid = np.arange(capacity) < total
    device = groups.device
    return (
        torch.as_tensor(fr, device=device),
        torch.as_tensor(member, device=device),
        torch.as_tensor(valid, device=device),
        torch.tensor(total, dtype=torch.int32, device=device),
    )
