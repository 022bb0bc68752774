"""The least time a kernel's work could take on the card: the yardstick of
the `<kernel>_roofline` metrics. Each such metric's file
(metrics/<kernel>_roofline.py) holds its kernel's own count of bytes and
operations (`work`), frozen from chip_smoke.py's `bounds`; this module
holds what they share: the card's peaks, the time a count takes at them,
the share a metric reads, and frozen copies of chip_smoke.py's
`probe_reach` and the port's `mix32` (K1's hash), so that a change to the
program cannot change what its kernels are held to.

A bound counts each input byte read once and each output byte written once,
and the operations the work on these inputs needs; its time is the larger
of bytes over the HBM rate and operations over the scalar peak.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores, the listed rate closest to the kernels' int32
# compare-and-select work (no int32 rate is listed)
PEAKS = {"hbm_bytes_per_s": 3.35e12, "scalar_ops_per_s": 67e12}

SECTOR = 32  # bytes: the unit a scattered read moves from HBM

_C1 = 0x9E3779B9
_C2 = 0xCC9E2D51
_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def mix32(cols2d):
    """K1's hash of (N, K) int32 key rows: uint32 multiply-xorshift carried
    out in int64 masked to 32 bits, reinterpreted as int32."""
    import torch

    keys = cols2d.to(torch.int64) & _M32
    h = torch.full(cols2d.shape[:-1], 374761393, dtype=torch.int64, device=cols2d.device)
    for i in range(cols2d.shape[-1]):
        h = _mul32(h ^ _mul32(keys[..., i], _C2), _C1)
        h = h ^ (h >> 15)
    return torch.where(h >= 2**31, h - 2**32, h).to(torch.int32)


def probe_reach(slots, keys, queries, budget, block: int = 1 << 24) -> tuple[int, int]:
    """(steps, table bytes) of a linear-probing lookup, each lane stopping
    at its first hit or empty slot: the steps of all query rows, and the
    32-byte sectors of `slots` its steps read and of `keys` its compared
    candidate rows span, in bytes. Walks the query rows `block` at a time,
    so that a call over hundreds of millions of rows fits beside the
    program's state."""
    import torch

    total, slot_sec, key_sec = 0, [], []
    width = keys.shape[1] * keys.element_size()
    for lo in range(0, queries.shape[0], block):
        q = queries[lo:lo + block]
        h = (mix32(q) & (slots.shape[0] - budget - 1)).long()
        done = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
        slot_at, rows = [], []
        for p in range(budget):
            live = ~done
            if not bool(live.any()):
                break
            total += int(live.sum())
            cand = slots[h + p]
            row = cand.clamp(0, keys.shape[0] - 1).long()
            slot_at.append(torch.unique((h + p)[live] * slots.element_size() // SECTOR))
            seen = torch.unique(row[live & (cand >= 0)])
            rows.append(torch.cat([seen * width // SECTOR, ((seen + 1) * width - 1) // SECTOR]))
            hit = (cand >= 0) & (keys[row] == q).all(dim=-1)
            done |= hit | (cand < 0)
        slot_sec.append(torch.unique(torch.cat(slot_at)))
        key_sec.append(torch.unique(torch.cat(rows)))
    n_sec = torch.unique(torch.cat(slot_sec)).numel() + torch.unique(torch.cat(key_sec)).numel()
    return total, SECTOR * n_sec


def nbytes(t) -> int:
    return t.numel() * t.element_size()


def meta(t):
    """A tensor's shape and type, without its contents."""
    import torch

    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def seconds(nbytes_: int, ops: int) -> float:
    """The least seconds a kernel moving `nbytes_` and doing `ops` takes."""
    return max(nbytes_ / PEAKS["hbm_bytes_per_s"], ops / PEAKS["scalar_ops_per_s"])


def share(calls) -> float | None:
    """A roofline metric's reading: the bound time of the bracketed
    launches over their device time, in percent; None without launches."""
    if not calls:
        return None
    return 100 * sum(b for b, _d in calls) / sum(d for _b, d in calls)
