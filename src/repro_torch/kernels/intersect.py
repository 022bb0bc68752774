"""Sorted-set intersection by batched lower-bound search (K5; csrc/intersect.cu).

Generic Join's leading intersection (R1.x ∩ R2.x ∩ ...) iterates the
smallest relation and probes the others. When trie keys are kept sorted
(the build is sort-based), the probe can be a binary search instead of a
hash probe: no table to build, and few memory touches for small and
medium tables. For each query a[i] the search finds the lower bound of
a[i] in the sorted, duplicate-free b; a[i] is a member iff that position
holds a[i].

`intersect` launches the CUDA kernel for tensors on the card and runs
`intersect_plain`, the same search written with tensor operations, for
tensors on the CPU. On the card a bucket directory over b's key range
(2^r buckets, `directory_bits`) narrows each search to one bucket, or,
where buckets are at most 32 ids wide, answers from an occupancy word a
bucket without a search; the wrapper allocates it as scratch
(`directory_words`). `launches` counts wrapper calls that launch the
kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

launches = 0
MAX_DIRECTORY_BITS = 14  # at most 2^14 buckets (csrc/intersect.cu kMaxDirBits)


def directory_bits(n: int) -> int:
    """r for N = n keys: about one bucket a key (the power of two at or
    above n), at least 2 and at most 2^MAX_DIRECTORY_BITS buckets."""
    return min(max(1, (n - 1).bit_length()), MAX_DIRECTORY_BITS)


def directory_words(r: int) -> int:
    """int32 words of the kernel's scratch for 2^r buckets: 2^r + 1 pairs
    (a bucket's first key, and the next bucket's first key or the bucket's
    occupancy word)."""
    return 2 * ((1 << r) + 1)


def intersect_plain(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's search as tensor operations: a fixed-step lower-bound
    search for every query at once."""
    n = b.shape[0]
    lo = torch.zeros_like(a)
    hi = torch.full_like(a, n)
    for _ in range(n.bit_length()):  # ceil(log2(n + 1)) halvings
        open_ = lo < hi
        mid = (lo + hi) // 2
        below = b[mid.clamp(max=n - 1)] < a
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    found = (lo < n) & (b[lo.clamp(max=n - 1)] == a)
    return found, torch.where(found, lo, -1)


def intersect(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a: (Q,) int32 queries; b: (N,) int32 sorted and duplicate-free,
    N >= 1. Returns (mask, pos): (Q,) bool membership of each a[i] in b,
    and (Q,) int32 its position in b or -1."""
    global launches
    device = _build.common_device("intersect", a=a, b=b)
    if a.dim() != 1 or b.dim() != 1 or b.shape[0] == 0:
        raise ValueError("intersect: a must be (Q,) and b (N,) with N >= 1")
    if device.type == "cpu":
        return _build.run_plain("intersect", intersect_plain, a, b)
    q = a.shape[0]
    mask = torch.empty(q, dtype=torch.bool, device=device)
    pos = torch.empty(q, dtype=torch.int32, device=device)
    r = directory_bits(b.shape[0])
    scratch = torch.empty(directory_words(r), dtype=torch.int32, device=device)
    _build.launch("intersect", device, a, b, mask, pos, scratch, q, b.shape[0], r)
    launches += 1
    return mask, pos
