"""The plain reference: counts of a conjunctive query over numpy columns,
computed with plain PyTorch operations (sort, unique, searchsorted) on
`device`: the card once the window has closed and the program's state is
freed, so that billions of two-paths take seconds, or the CPU.

It imports numpy and torch alone, and takes nothing the program under test
made: the benchmark hands it the same generated columns it hands the
program. A query
is a list of atoms (table, variables); an atom reads its table's columns in
order, renamed to its variables, so three atoms over one table are the
three views of a self-join. Bag semantics: every row counts, duplicates
included.

`count_by` evaluates by variable elimination over sorted composite keys:
each atom is first grouped on the variables other atoms or the output
need (its multiplicities summed), then the atoms are joined one at a time,
each join grouping its result on the variables still needed. The triangle
becomes two-paths over distinct edges grouped on their end points, then a
lookup of the closing edge; the star becomes per-y counts multiplied.
"""
from __future__ import annotations

import numpy as np
import torch

_BITS = 21  # key columns are packed 21 bits each into one int64 key
DEVICE = "cpu"  # where count_by computes; the harness sets "cuda" on the card


class _Rel:
    """Columns keyed by variable, with an int64 multiplicity per row."""

    def __init__(self, cols: dict[str, torch.Tensor], mult: torch.Tensor):
        self.cols, self.mult = cols, mult

    @property
    def vars(self) -> tuple[str, ...]:
        return tuple(self.cols)


def _pack(cols: list[torch.Tensor], n: int, device) -> torch.Tensor:
    key = torch.zeros(n, dtype=torch.int64, device=device)
    for c in cols:
        if len(c) and (int(c.min()) < 0 or int(c.max()) >= 1 << _BITS):
            raise ValueError(f"reference: key values must lie in [0, 2**{_BITS})")
        key = (key << _BITS) | c
    return key


def _unpack(key: torch.Tensor, names: list[str]) -> dict[str, torch.Tensor]:
    out = {}
    for i, v in enumerate(reversed(names)):
        out[v] = (key >> (_BITS * i)) & ((1 << _BITS) - 1)
    return {v: out[v] for v in names}


def _group(rel: _Rel, keep: list[str]) -> _Rel:
    """Sum multiplicities over the rows that agree on `keep`."""
    if not keep:
        return _Rel({}, rel.mult.sum().reshape(1))
    key = _pack([rel.cols[v] for v in keep], len(rel.mult), rel.mult.device)
    uniq, inv = torch.unique(key, return_inverse=True)
    mult = torch.zeros(len(uniq), dtype=torch.int64, device=key.device).index_add_(0, inv, rel.mult)
    return _Rel(_unpack(uniq, keep), mult)


def _join(left: _Rel, right: _Rel) -> _Rel:
    """Natural join on the shared variables, multiplicities multiplied."""
    shared = [v for v in left.vars if v in right.vars]
    dev = left.mult.device
    lk = _pack([left.cols[v] for v in shared], len(left.mult), dev)
    rk = _pack([right.cols[v] for v in shared], len(right.mult), dev)
    rk_s, order = torch.sort(rk, stable=True)
    lo = torch.searchsorted(rk_s, lk)
    cnt = torch.searchsorted(rk_s, lk, right=True) - lo
    li = torch.repeat_interleave(torch.arange(len(lk), device=dev), cnt)
    start = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt - lo, cnt)
    ri = order[torch.arange(len(li), device=dev) - start]
    del start
    cols = {v: c[li] for v, c in left.cols.items()}
    cols.update({v: c[ri] for v, c in right.cols.items() if v not in cols})
    return _Rel(cols, left.mult[li] * right.mult[ri])


def count_by(atoms, tables: dict[str, dict[str, np.ndarray]], by: tuple[str, ...] = (),
             memo: dict | None = None, device=None):
    """The query's bag count, grouped on the variables `by`. atoms: [(table,
    vars)], each table's columns read in order and renamed to vars.
    Returns (keys (G, len(by)) int64, counts (G,) int64) as numpy arrays,
    groups with a positive count only; with by=() one group of the whole
    count. `memo` keeps each atom's grouping across calls, keyed by its
    column arrays (held in the memo), so a table shared by many queries
    groups once. `device`: where to compute (default DEVICE)."""
    dev = torch.device(device or DEVICE)
    rels, keys_of = [], []
    for table, vs in atoms:
        cols = list(tables[table].values())
        if len(cols) != len(vs):
            raise ValueError(f"atom over {table} names {len(vs)} variables for {len(cols)} columns")
        rels.append(_Rel({v: torch.as_tensor(np.asarray(c, np.int64), device=dev)
                          for v, c in zip(vs, cols)},
                         torch.ones(len(cols[0]), dtype=torch.int64, device=dev)))
        keys_of.append((tuple(id(c) for c in cols), tuple(vs), str(dev)))

    def needed(skip: set[int]) -> set[str]:
        out = set(by)
        for j, r in enumerate(rels):
            if j not in skip:
                out.update(r.vars)
        return out

    grouped = []
    for i, r in enumerate(rels):
        keep = [v for v in r.vars if v in needed({i})]
        key = (*keys_of[i], tuple(keep))
        if memo is not None and key in memo:
            grouped.append(memo[key][1])
            continue
        g = _group(r, keep)
        if memo is not None:
            memo[key] = ([tables[atoms[i][0]]], g)  # the arrays stay alive with their ids
        grouped.append(g)
    rels = grouped
    cur, done = rels[0], {0}
    while len(done) < len(rels):
        nxt = max((j for j in range(len(rels)) if j not in done),
                  key=lambda j: (len(set(rels[j].vars) & set(cur.vars)), -j))
        cur = _join(cur, rels[nxt])
        done.add(nxt)
        cur = _group(cur, [v for v in cur.vars if v in needed(done)])
    live = cur.mult > 0
    keys = (torch.stack([cur.cols[v][live] for v in by], dim=1).cpu().numpy() if by
            else np.zeros((int(live.sum()), 0), np.int64))
    return keys, cur.mult[live].cpu().numpy()


def count(atoms, tables, memo: dict | None = None, device=None) -> int:
    """The query's bag count."""
    _keys, counts = count_by(atoms, tables, memo=memo, device=device)
    return int(counts.sum())


def point_counts(atoms, tables, var: str, device=None):
    """The count of the query with `var` bound, for every value of `var`:
    a function of the constant (0 where no row binds it)."""
    keys, counts = count_by(atoms, tables, (var,), device=device)
    table = dict(zip(keys[:, 0].tolist(), counts.tolist()))
    return lambda c: table.get(int(c), 0)


def sampled(tables: dict[str, dict[str, np.ndarray]]) -> dict[str, dict[str, np.ndarray]]:
    """Every other row of each table: the control's input. An answer over
    it, scaled up, is an estimate: what an approximate count would give."""
    return {t: {v: c[::2] for v, c in cols.items()} for t, cols in tables.items()}


def brute_force(atoms, tables, bound: dict[str, int] | None = None) -> int:
    """Nested loops over every row of every atom: the check of count_by at
    tiny sizes."""
    rows = []
    for table, vs in atoms:
        cols = list(tables[table].values())
        rows.append([dict(zip(vs, (int(c[i]) for c in cols))) for i in range(len(cols[0]))])

    def extend(i, env):
        if i == len(rows):
            return 1
        total = 0
        for r in rows[i]:
            if all(env.get(v, x) == x for v, x in r.items()):
                total += extend(i + 1, {**env, **r})
        return total

    return extend(0, dict(bound or {}))
