"""The GAP Benchmark Suite's `kron` graph (Beamer, Asanovic, Patterson,
arXiv:1508.03619, section 3): Graph500's Kronecker generator with
initiator A, B, C, D (0.57, 0.19, 0.19, 0.05), 2**scale vertices and
degree * 2**scale undirected edges (GAP's generator `-g scale -k degree`).
Each edge picks one quadrant of the adjacency matrix per bit of its two
endpoints, with probabilities A, B, C, D, so degrees are heavily skewed: a
few hubs touch a large share of the edges. The edges are symmetrized into
both directions, with self-loops and duplicate edges removed (GAP's
builder), as the undirected graph its triangle-counting kernel (TC)
reads. Held as one edge table `knows` with a row per direction.

The graph is drawn from the configuration's `structure_seed`; the run's
seed relabels the vertices and shuffles the rows, so every seed holds the
same graph up to the names of its vertices and the order of its rows: the
same degrees, two-paths and triangles, so the same work and bytes. The
draws are torch's, made on `device` (the card in a run) in a few large
calls; a draw depends on the device's generator, so the CPU tests' graph
differs from the card's, and each is the same on every run of its device.
"""
from __future__ import annotations

import torch


def generate(params: dict, seed: int, device: str = "cpu") -> dict:
    """{"knows": {"a": src, "b": dst}}, int64 numpy columns, both
    directions of every edge once."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["degree"]) * n
    init = params["initiator"]
    a, ab, abc = init["A"], init["A"] + init["B"], init["A"] + init["B"] + init["C"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(params["structure_seed"]))
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        # one draw a level picks the quadrant: [0, A) top left, [A, A+B)
        # top right, [A+B, A+B+C) bottom left, the rest bottom right
        r = torch.rand(m, generator=gen, device=device)
        u |= (r >= ab).to(torch.int64) << bit
        v |= (((r >= a) & (r < ab)) | (r >= abc)).to(torch.int64) << bit
    keep = u != v
    u, v = u[keep], v[keep]
    key = torch.unique(torch.cat([u * n + v, v * n + u]))
    del u, v, keep
    gen.manual_seed(seed % 2**64)
    label = torch.randperm(n, generator=gen, device=device)
    key = key[torch.randperm(len(key), generator=gen, device=device)]
    return {"knows": {"a": label[key // n].cpu().numpy(), "b": label[key % n].cpu().numpy()}}


def redraw(params: dict, tables: dict, seed: int, index: int) -> dict:
    """Tables for the `index`-th query over freshly loaded data: copies of
    every column (the graph does not change from query to query)."""
    return {t: {v: c.copy() for v, c in cols.items()} for t, cols in tables.items()}

# the tables `redraw` draws anew; it copies the others unchanged
REDRAWN = ()
