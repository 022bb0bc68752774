"""Capacity-bounded CSR expansion (K2; csrc/csr_expand.cu).

Free Join's cover iteration expands every frontier row into the members of
its trie sub-group (variable fan-out). The output is a fixed-capacity
buffer; each output slot finds its source frontier row by binary search
over the exclusive prefix sum of fan-outs (`starts`), then its member
offset within that row's CSR segment (`base`). Slots at or past `total`
are -1. The prefix sum is computed outside the kernel (ops.expand_counted).

`csr_expand` launches the CUDA kernel for tensors on the card and runs
`csr_expand_plain`, the same search written with tensor operations, for
tensors on the CPU. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# The capacity planner rounds every frontier buffer to this block.
OBLK = 1024

launches = 0


def csr_expand_plain(
    starts: torch.Tensor, base: torch.Tensor, total: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's search as tensor operations: a fixed-step binary search
    for the last row with starts[row] <= j, for every slot j at once."""
    f = starts.shape[0]
    j = torch.arange(capacity, dtype=torch.int32, device=starts.device)
    lo = torch.zeros_like(j)
    hi = torch.full_like(j, f)
    for _ in range(f.bit_length()):  # ceil(log2(f + 1)) halvings
        open_ = lo < hi
        mid = (lo + hi) // 2
        right = open_ & (starts[mid.clamp(max=f - 1)] <= j)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(open_ & ~right, mid, hi)
    fr = (lo - 1).clamp(0, f - 1)
    valid = j < total
    member = base[fr] + (j - starts[fr])
    return torch.where(valid, fr, -1), torch.where(valid, member, -1)


def csr_expand(
    starts: torch.Tensor, base: torch.Tensor, total: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """starts/base: (F,) int32, F >= 1; total: (1,) int32, read on the
    device. Returns (fr, member), each (capacity,) int32, -1 past total."""
    global launches
    device = _build.common_device("csr_expand", starts=starts, base=base, total=total)
    if starts.dim() != 1 or starts.shape[0] == 0 or base.shape != starts.shape:
        raise ValueError("csr_expand: starts and base must be (F,) with F >= 1")
    if total.shape != (1,):
        raise ValueError("csr_expand: total must be (1,)")
    if device.type == "cpu":
        return _build.run_plain("csr_expand", csr_expand_plain, starts, base, total, capacity)
    fr = torch.empty(capacity, dtype=torch.int32, device=device)
    member = torch.empty(capacity, dtype=torch.int32, device=device)
    _build.launch(
        "csr_expand", device, starts, base, total, fr, member, starts.shape[0], capacity
    )
    launches += 1
    return fr, member
