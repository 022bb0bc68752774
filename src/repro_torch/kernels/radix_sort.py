"""Segmented radix sort for trie construction (K4; csrc/radix_rank.cu).

The trie build needs rows grouped hierarchically by the plan's level vars.
At level d the rows are already contiguous within their depth-(d-1)
groups, so the level's var only has to be rank-ordered *inside each parent
segment*: a stable LSD counting sort over RBITS-bit digits whose passes
scale with the key width of that one var, not with the whole key tuple
(Worst-Case Optimal Radix Triejoin, arXiv 1912.12747).

One pass over the current permutation works on three arrays: each row's
digit, csum[r, i] (the inclusive count of digit r among rows 0..i, kept
digit-major) and the row's segment bounds. Written as a gather, output
slot j knows its digit kd[j] and target rank kt[j] (from the per-segment
digit histograms), and its source row is the leftmost i with
csum[kd[j], i] >= kt[j]: one binary search per slot, which is the kernel
(`radix_rank`). Every pass keeps segment boundaries, so stability gives
the exact lexicographic order.

Keys must be non-negative (join keys are dictionary-encoded int32 >= 0);
negative keys take the comparison-sort path in compiled.StaticTrie.

`radix_rank` launches the CUDA kernel for tensors on the card and runs
`radix_rank_plain`, the same search written with tensor operations, for
tensors on the CPU. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

RBITS = 4
RADIX = 1 << RBITS

launches = 0


def radix_rank_plain(csum: torch.Tensor, kd: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """The kernel's search as tensor operations: a fixed-step binary search
    for the leftmost row with csum[kd[j], row] >= kt[j], for every j."""
    n = csum.shape[1]
    lo = torch.zeros_like(kd)
    hi = torch.full_like(kd, n)
    for _ in range(n.bit_length()):  # ceil(log2(n + 1)) halvings
        open_ = lo < hi
        mid = (lo + hi) // 2
        geq = csum[kd, mid.clamp(max=n - 1)] >= kt
        hi = torch.where(open_ & geq, mid, hi)
        lo = torch.where(open_ & ~geq, mid + 1, lo)
    return lo.clamp(max=n - 1)


def radix_rank(csum: torch.Tensor, kd: torch.Tensor, kt: torch.Tensor) -> torch.Tensor:
    """csum: (R, N) int32 inclusive per-digit prefix counts, digit-major,
    N >= 1; kd/kt: (N,) int32 digit and target rank per output slot.
    Returns src: (N,) int32 source position of each output slot."""
    global launches
    device = _build.common_device("radix_rank", csum=csum, kd=kd, kt=kt)
    if csum.dim() != 2 or csum.shape[1] == 0:
        raise ValueError("radix_rank: csum must be (R, N) with N >= 1")
    if kd.shape != (csum.shape[1],) or kt.shape != kd.shape:
        raise ValueError("radix_rank: kd and kt must be (N,)")
    if device.type == "cpu":
        return _build.run_plain("radix_rank", radix_rank_plain, csum, kd, kt)
    src = torch.empty(csum.shape[1], dtype=torch.int32, device=device)
    _build.launch("radix_rank", device, csum, kd, kt, src, csum.shape[1])
    launches += 1
    return src


def _seg_starts(seg: torch.Tensor) -> torch.Tensor:
    """Per-row start position of the row's (contiguous) segment."""
    n = seg.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=seg.device)
    first = torch.ones(n, dtype=torch.bool, device=seg.device)
    first[1:] = seg[1:] != seg[:-1]
    # running max of the last segment-start position
    return torch.cummax(torch.where(first, idx, 0), dim=0).values


def _radix_pass(perm, starts, seg_last, digit: torch.Tensor) -> torch.Tensor:
    """One stable counting-sort pass of `perm` by `digit` within contiguous
    segments, in the gather formulation. `starts`/`seg_last` give each
    row's segment start/end position (invariant across the passes of one
    var). Returns the new permutation of positions."""
    n = perm.shape[0]
    device = perm.device
    idx = torch.arange(n, dtype=torch.int32, device=device)
    radix = torch.arange(RADIX, dtype=torch.int32, device=device)
    # digit-major (R, N) prefix counts: csum[r, i] counts digit r among rows
    # 0..i, pcs[r, i] the rows <= i with digit <= r. Both scans run along
    # contiguous memory, and the kernel's search reads one digit's column.
    onehot = (radix[:, None] == digit[None, :]).to(torch.int32)
    csum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pcs = torch.cumsum(csum, dim=0, dtype=torch.int32)
    start1 = (starts - 1).clamp(0, n - 1)
    at_start = starts > 0

    def upto(tbl, row):  # tbl[row, .] restricted to the row's segment
        return tbl[row, seg_last] - torch.where(at_start, tbl[row, start1], 0)

    # slot j's digit and target rank
    local = idx - starts  # position within the segment
    seg_pcs = pcs[:, seg_last] - torch.where(at_start[None, :], pcs[:, start1], 0)  # (R, N)
    kd = (seg_pcs <= local[None, :]).sum(dim=0, dtype=torch.int32).clamp(0, RADIX - 1)
    off = torch.where(kd > 0, upto(pcs, (kd - 1).clamp(min=0)), 0)
    base = torch.where(at_start, csum[kd, start1], 0)  # digit-kd rows before the segment
    kt = base + (local - off) + 1
    return perm[radix_rank(csum, kd, kt)]


def _refine_segments(seg: torch.Tensor, sorted_key: torch.Tensor) -> torch.Tensor:
    """New segment ids after a var is fully sorted: split each segment at
    every value change of the (now sorted-within-segment) key."""
    flag = torch.ones(seg.shape[0], dtype=torch.bool, device=seg.device)
    flag[1:] = (seg[1:] != seg[:-1]) | (sorted_key[1:] != sorted_key[:-1])
    return torch.cumsum(flag, dim=0, dtype=torch.int32) - 1


def segmented_sort(
    cols: list[torch.Tensor],
    key_bits: tuple[int, ...],
    init_order: torch.Tensor | None = None,
    presorted: int = 0,
) -> torch.Tensor:
    """Row permutation sorting `cols` lexicographically (cols[0] major), via
    per-var LSD radix passes inside the segments induced by earlier vars.

    key_bits[i] must cover cols[i]'s value range (values in [0, 2**bits));
    a var costs ceil(key_bits[i] / RBITS) passes. `init_order` with
    `presorted=k` starts from a permutation already sorted by the first k
    cols (a shared prefix order from the trie cache): those vars pay only
    the segment refinement, never a sorting pass."""
    if not cols or len(cols) != len(key_bits):
        raise ValueError("segmented_sort: one key width per column")
    if not 0 <= presorted <= len(cols) or (presorted and init_order is None):
        raise ValueError("segmented_sort: presorted needs init_order and <= len(cols)")
    n = cols[0].shape[0]
    device = cols[0].device
    perm = (
        torch.arange(n, dtype=torch.int32, device=device)
        if init_order is None
        else init_order.to(torch.int32)
    )
    if n == 0:
        return perm
    seg = torch.zeros(n, dtype=torch.int32, device=device)
    for ci, (col, bits) in enumerate(zip(cols, key_bits)):
        col = col.to(torch.int32)
        if ci >= presorted:
            starts = _seg_starts(seg)
            seg_last = (n - 1) - _seg_starts(seg.flip(0)).flip(0)  # last position
            for shift in range(0, max(1, int(bits)), RBITS):
                digit = (col[perm] >> shift) & (RADIX - 1)
                perm = _radix_pass(perm, starts, seg_last, digit)
        seg = _refine_segments(seg, col[perm])
    return perm


def lex_searchsorted(
    sorted_cols: list[torch.Tensor],
    query_cols: list[torch.Tensor],
) -> torch.Tensor:
    """Per-query insertion rank (side="left") of each query tuple into the
    lexicographically sorted rows of `sorted_cols` (cols[0] major).

    The merge half of the delta trie build: the delta's rows are sorted
    among themselves by `segmented_sort`, then this locates each one's slot
    in the cached sorted run — the splice positions of a sorted-run merge
    without a full re-sort. A fixed-step binary search written as tensor
    operations (no kernel: the reference computes it outside Pallas too):
    ceil(log2(N+1)) gather rounds, each lane frozen once its bracket
    closes. Lexicographic "row < query" is folded from the least
    significant column backward: a < b at column d iff
    (a_d < b_d) | (a_d == b_d & the rest of a < the rest of b)."""
    if not sorted_cols or len(sorted_cols) != len(query_cols):
        raise ValueError("lex_searchsorted: one query column per sorted column")
    n = sorted_cols[0].shape[0]
    q = query_cols[0].shape[0]
    device = query_cols[0].device
    if n == 0:
        return torch.zeros(q, dtype=torch.int32, device=device)
    sorted_cols = [c.to(torch.int32) for c in sorted_cols]
    query_cols = [c.to(torch.int32) for c in query_cols]

    def row_lt_query(pos):  # (Q,) bool: sorted row pos[j] < query j ?
        lt = torch.zeros(pos.shape, dtype=torch.bool, device=device)
        for sc, qc in zip(reversed(sorted_cols), reversed(query_cols)):
            a = sc[pos]
            lt = (a < qc) | ((a == qc) & lt)
        return lt

    lo = torch.zeros(q, dtype=torch.int32, device=device)
    hi = torch.full((q,), n, dtype=torch.int32, device=device)
    for _ in range(n.bit_length()):  # ceil(log2(n + 1)) halvings
        mid = (lo + hi) // 2
        lt = row_lt_query(mid.clamp(max=n - 1))
        open_ = lo < hi
        lo = torch.where(open_ & lt, mid + 1, lo)
        hi = torch.where(open_ & ~lt, mid, hi)
    return lo
