"""Paged KV-cache allocator.

The page table is a relation (seq_id, page_no) -> physical slot, and the
lookup is a batched probe of a vectorized open-addressing table over int64
keys. Allocation and release happen on the host control plane; the device
side sees only dense page-index arrays, so the table stays host numpy (the
port's `relational.npkit.HashTable` is the card's int32 table, and would
refuse a seq_id of 2**31 or more).
"""
from __future__ import annotations

import numpy as np

from repro_torch.relational.npkit import mix64


def _capacity(n: int) -> int:
    return max(8, 1 << int(np.ceil(np.log2(max(1, 2 * n)))))


class _HostHashTable:
    """Maps unique composite int64 keys -> their row index in the key
    arrays; probe() returns the key-row index per query, -1 on a miss.
    Linear probing in a power-of-two table, hashed with mix64."""

    def __init__(self, key_cols: list[np.ndarray]):
        self.key_cols = [np.ascontiguousarray(c, dtype=np.int64) for c in key_cols]
        self.n = len(self.key_cols[0]) if self.key_cols else 0
        self.mask = _capacity(self.n) - 1
        self.slots = np.full(self.mask + 1, -1, dtype=np.int64)
        if self.n == 0:
            return
        slot = mix64(self.key_cols) & self.mask
        pending = np.arange(self.n, dtype=np.int64)
        while pending.size:
            s = slot[pending]
            free = self.slots[s] == -1
            att, satt = pending[free], s[free]
            self.slots[satt] = att  # duplicate target slots: last write wins
            won = self.slots[satt] == att
            still = np.concatenate([att[~won], pending[~free]])
            slot[still] = (slot[still] + 1) & self.mask
            pending = still

    def probe(self, query_cols: list[np.ndarray]) -> np.ndarray:
        q = len(query_cols[0]) if query_cols else 0
        out = np.full(q, -1, dtype=np.int64)
        if q == 0 or self.n == 0:
            return out
        qcols = [np.asarray(c, dtype=np.int64) for c in query_cols]
        slot = mix64(qcols) & self.mask
        pending = np.arange(q, dtype=np.int64)
        while pending.size:
            occ = self.slots[slot[pending]]
            filled = occ != -1
            match = filled.copy()
            occ_safe = np.where(filled, occ, 0)
            for kc, qc in zip(self.key_cols, qcols):
                match &= kc[occ_safe] == qc[pending]
            out[pending[match]] = occ[match]
            pending = pending[filled & ~match]
            slot[pending] = (slot[pending] + 1) & self.mask
        return out


class PagedAllocator:
    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free = list(range(num_pages - 1, -1, -1))
        self.owner: dict[int, list[int]] = {}  # seq_id -> [slots in page order]
        self._table: _HostHashTable | None = None
        self._dirty = True

    def alloc(self, seq_id: int, num_tokens: int) -> list[int]:
        """Ensure seq has pages for `num_tokens`; returns new slots."""
        pages = self.owner.setdefault(seq_id, [])
        need = -(-num_tokens // self.page_size) - len(pages)
        if need > len(self.free):
            raise MemoryError(f"paged KV pool exhausted ({need} > {len(self.free)})")
        new = [self.free.pop() for _ in range(max(0, need))]
        pages.extend(new)
        self._dirty = bool(new)
        return new

    def release(self, seq_id: int) -> None:
        self.free.extend(self.owner.pop(seq_id, []))
        self._dirty = True

    def _rebuild(self) -> None:
        seqs, pnos, slots = [], [], []
        for sid, pages in self.owner.items():
            for i, slot in enumerate(pages):
                seqs.append(sid)
                pnos.append(i)
                slots.append(slot)
        self._vals = np.asarray(slots, np.int64)
        self._table = _HostHashTable([np.asarray(seqs, np.int64), np.asarray(pnos, np.int64)])
        self._dirty = False

    def lookup(self, seq_ids: np.ndarray, page_nos: np.ndarray) -> np.ndarray:
        """Batched page-table probe: physical slot per (seq, page), -1 miss."""
        if self._dirty or self._table is None:
            self._rebuild()
        idx = self._table.probe([np.asarray(seq_ids, np.int64), np.asarray(page_nos, np.int64)])
        return np.where(idx >= 0, self._vals[np.clip(idx, 0, None)], -1)

    def page_index(self, seq_ids: list[int], max_pages: int) -> np.ndarray:
        """Dense (B, max_pages) slot matrix for the device (-1 = unused)."""
        out = np.full((len(seq_ids), max_pages), -1, dtype=np.int32)
        for i, sid in enumerate(seq_ids):
            pages = self.owner.get(sid, [])[:max_pages]
            out[i, : len(pages)] = pages
        return out
