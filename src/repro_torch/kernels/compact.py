"""Frontier compaction as a gather (K3; csrc/compact.cu).

The compiled Free Join frontier is a fixed-capacity buffer with a valid
mask; probe misses kill lanes in place, and every dead lane would still be
carried through all later expansions. When the live fraction drops, the
adaptive runner squeezes the frontier: output slot j is filled from the
(j+1)-th valid lane, so the live lanes land densely at the front of a
smaller buffer. With `csum` the inclusive prefix sum of the valid mask
(computed outside the kernel), the source lane of slot j is the leftmost
i with csum[i] >= j+1; slots at or past `live` are -1.

`compact` launches the CUDA kernel for tensors on the card and runs
`compact_plain`, the same search written with tensor operations, for
tensors on the CPU. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0


def compact_plain(csum: torch.Tensor, live: torch.Tensor, capacity: int) -> torch.Tensor:
    """The kernel's search as tensor operations: a fixed-step binary search
    for the leftmost lane with csum >= j+1, for every slot j at once."""
    n = csum.shape[0]
    j = torch.arange(capacity, dtype=torch.int32, device=csum.device)
    target = j + 1
    lo = torch.zeros_like(j)
    hi = torch.full_like(j, n)
    for _ in range(n.bit_length()):  # ceil(log2(n + 1)) halvings
        open_ = lo < hi
        mid = (lo + hi) // 2
        geq = csum[mid.clamp(max=n - 1)] >= target
        hi = torch.where(open_ & geq, mid, hi)
        lo = torch.where(open_ & ~geq, mid + 1, lo)
    return torch.where(j < live, lo.clamp(max=n - 1), -1)


def compact(csum: torch.Tensor, live: torch.Tensor, capacity: int) -> torch.Tensor:
    """csum: (N,) int32 inclusive prefix sum of the valid mask, N >= 1;
    live: (1,) int32 == csum[-1], read on the device. Returns src:
    (capacity,) int32 source lane of each output slot, -1 past live."""
    global launches
    device = _build.common_device("compact", csum=csum, live=live)
    if csum.dim() != 1 or csum.shape[0] == 0:
        raise ValueError("compact: csum must be (N,) with N >= 1")
    if live.shape != (1,):
        raise ValueError("compact: live must be (1,)")
    if device.type == "cpu":
        return compact_plain(csum, live, capacity)
    src = torch.empty(capacity, dtype=torch.int32, device=device)
    _build.launch("compact", device, csum, live, src, csum.shape[0], capacity)
    launches += 1
    return src
