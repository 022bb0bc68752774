"""Device-wide prefix scans of the trie build (csrc/seg_scan.cu).

Two scans that PyTorch runs on a few blocks a row, where the trie build's
sort and hash-table build need them over all rows at once:

* `digit_counts(digit)`: a radix pass's digit-major count tables (see
  radix_sort._radix_pass). csum[r, i] counts the rows <= i with digit r,
  pcs[r, i] the rows <= i with digit <= r. The kernel makes no one-hot:
  each block counts its tile by warp ballots and writes both tables once.
* `max_scan(x)`: the inclusive running maximum of a column, the segment
  starts of radix_sort and the hash-table build's displacement scan
  (ops._build). Values only: nobody reads cummax's indices.

Both launch the CUDA kernel for tensors on the card and run their plain
versions, the tensor code the build ran before, for tensors on the CPU.
An empty column launches nothing on either. `digit_counts_launches` and
`max_scan_launches` count each entry point's kernel launches
(_build.counter), and _build.plain_calls each one's plain calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

RADIX = 16  # digits a pass (radix_sort.RADIX); csrc/seg_scan.cu's kRadix
TILE = 4096  # rows a block: csrc/seg_scan.cu's kTile

digit_counts_launches = 0
max_scan_launches = 0


def _tiles(n: int) -> int:
    return -(-n // TILE)


def digit_counts_plain(digit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-hot's two cumulative sums, along the rows and then along the
    digits."""
    radix = torch.arange(RADIX, dtype=torch.int32, device=digit.device)
    onehot = (radix[:, None] == digit[None, :]).to(torch.int32)
    csum = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    return csum, torch.cumsum(csum, dim=0, dtype=torch.int32)


def digit_counts(digit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """digit: (N,) int32 in [0, RADIX). Returns (csum, pcs), each (RADIX, N)
    int32, digit-major: csum[r, i] the rows <= i with digit r, pcs[r, i]
    the rows <= i with digit <= r."""
    global digit_counts_launches
    device = _build.common_device("digit_counts", digit=digit)
    if digit.dim() != 1:
        raise ValueError("digit_counts: digit must be (N,)")
    n = digit.shape[0]
    if n == 0:
        empty = torch.empty((RADIX, 0), dtype=torch.int32, device=device)
        return empty, empty.clone()
    if device.type == "cpu":
        return _build.run_plain("digit_counts", digit_counts_plain, digit)
    csum = torch.empty((RADIX, n), dtype=torch.int32, device=device)
    pcs = torch.empty_like(csum)
    blocks = _tiles(n)
    scratch = torch.empty((blocks, RADIX), dtype=torch.int32, device=device)
    _build.launch("digit_counts", device, digit, csum, pcs, scratch, n, blocks)
    digit_counts_launches += 1
    return csum, pcs


def max_scan_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=0).values


def max_scan(x: torch.Tensor) -> torch.Tensor:
    """x: (N,) int32. Returns (N,) int32, out[i] = max(x[0..i])."""
    global max_scan_launches
    device = _build.common_device("max_scan", x=x)
    if x.dim() != 1:
        raise ValueError("max_scan: x must be (N,)")
    n = x.shape[0]
    if n == 0:
        return torch.empty_like(x)
    if device.type == "cpu":
        return _build.run_plain("max_scan", max_scan_plain, x)
    out = torch.empty_like(x)
    blocks = _tiles(n)
    scratch = torch.empty(blocks, dtype=torch.int32, device=device)
    _build.launch("max_scan", device, x, out, scratch, n, blocks)
    max_scan_launches += 1
    return out
