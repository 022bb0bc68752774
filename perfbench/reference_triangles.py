"""The plain reference of a triangle over one undirected graph: the bag
count of q1, K1(a,b) K2(b,c) K3(c,a) over three views of one edge table,
computed with plain PyTorch operations on `device` by GAP's own
triangle-counting method (Beamer, Asanovic, Patterson, arXiv:1508.03619,
TC), independent of the program under test.

It requires the edge table to hold an undirected graph as GAP's builder
makes it: both directions of every edge, no self-loop, no edge twice. It
raises ValueError on a table that breaks any of these. q1 then counts
every triangle six times (three rotations, two directions), and the
count is six times the triangles.

The method: each edge is oriented from the lower to the higher of its two
ends by (degree, id), so every triangle has one lowest vertex and is one
oriented wedge there; the wedges (u -> v, u -> w) with v before w are
enumerated in blocks of at most BLOCK, and each is closed by looking up
v -> w with searchsorted over the sorted packed oriented edges. It
imports numpy and torch alone.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK = 1 << 26  # wedges made and closed at a time


def _edges(atoms, tables, device):
    """The edge table's two columns on `device`, after checking that the
    atoms are q1's triangle over one table."""
    if len(atoms) != 3 or len({t for t, _vs in atoms}) != 1:
        raise ValueError("reference_triangles counts a triangle over one edge table")
    vs = [tuple(v) for _t, v in atoms]
    if any(len(v) != 2 for v in vs) or any(vs[i][1] != vs[(i + 1) % 3][0] for i in range(3)):
        raise ValueError(f"atoms {vs} are not a triangle x->y, y->z, z->x")
    cols = list(tables[atoms[0][0]].values())
    if len(cols) != 2:
        raise ValueError("the edge table has two columns")
    return [torch.as_tensor(np.asarray(c, np.int64), device=device) for c in cols]


def _check(a: torch.Tensor, b: torch.Tensor, n: int) -> None:
    if bool((a == b).any()):
        raise ValueError("reference_triangles: the edge table has a self-loop")
    key = torch.sort(a * n + b).values
    if len(key) > 1 and bool((key[1:] == key[:-1]).any()):
        raise ValueError("reference_triangles: the edge table holds an edge twice")
    if not torch.equal(key, torch.sort(b * n + a).values):
        raise ValueError("reference_triangles: the edge table is not symmetric")


def count(atoms, tables, memo: dict | None = None, device=None) -> int:
    """Six times the triangles of the graph `tables` holds: q1's bag count
    (module docstring). atoms: [(table, vars)] as perfbench/reference.py
    takes them; `memo` is accepted for that signature and unused."""
    dev = torch.device(device or "cpu")
    a, b = _edges(atoms, tables, dev)
    if not len(a):
        return 0
    if int(a.min()) < 0 or int(b.min()) < 0:
        raise ValueError("reference_triangles: vertex ids must be nonnegative")
    n = int(torch.maximum(a.max(), b.max())) + 1
    _check(a, b, n)
    deg = torch.bincount(a, minlength=n)
    # rank by (degree, id): the lower end of every edge is its source
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(deg * n + torch.arange(n, device=dev), stable=True)] = torch.arange(
        n, device=dev)
    ra, rb = rank[a], rank[b]
    keep = ra < rb
    key = torch.sort(ra[keep] * n + rb[keep]).values  # oriented edges, sorted by (u, v)
    del ra, rb, keep, a, b
    u, v = key // n, key % n
    end = torch.searchsorted(u, u, right=True)  # one past u's last oriented edge
    later = end - torch.arange(len(u), device=dev) - 1  # wedges each edge opens
    total = 0
    start = 0
    cum = torch.cumsum(later, 0)
    while start < len(u):
        # edges [start, stop) open at most BLOCK wedges (one edge may open more)
        base = int(cum[start - 1]) if start else 0
        stop = max(start + 1, int(torch.searchsorted(cum, base + BLOCK, right=True)))
        counts = later[start:stop]
        src = torch.repeat_interleave(torch.arange(start, stop, device=dev), counts)
        first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
        w = v[src + 1 + torch.arange(len(src), device=dev) - first]
        probe = v[src] * n + w
        at = torch.searchsorted(key, probe).clamp(max=len(key) - 1)
        total += int((key[at] == probe).sum())
        start = stop
    return 6 * total
