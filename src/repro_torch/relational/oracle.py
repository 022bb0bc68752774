"""Brute-force join oracle used by tests: pairwise nested-loop-ish natural
join over numpy (small inputs only). Bag semantics."""
from __future__ import annotations

import numpy as np

from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Query


def _nat_join(left_vars, left_rows, right_vars, right_rows):
    shared = [v for v in left_vars if v in right_vars]
    li = [left_vars.index(v) for v in shared]
    ri = [right_vars.index(v) for v in shared]
    rv_extra = [v for v in right_vars if v not in left_vars]
    re = [right_vars.index(v) for v in rv_extra]
    index: dict[tuple, list] = {}
    for r in right_rows:
        index.setdefault(tuple(r[i] for i in ri), []).append([r[i] for i in re])
    out_vars = list(left_vars) + rv_extra
    out = []
    for lrow in left_rows:
        for extra in index.get(tuple(lrow[i] for i in li), ()):
            out.append(list(lrow) + extra)
    return out_vars, out


def join_oracle(query: Query, relations: dict[str, Relation]) -> set | list:
    """Returns the multiset of result tuples, ordered by query.head vars,
    as a sorted list of tuples (so bag-equality is plain list equality)."""
    vars_, rows = None, None
    for atom in query.atoms:
        rel = relations[atom.alias]
        r_rows = (
            [list(t) for t in zip(*(rel.columns[v] for v in atom.vars))] if rel.num_rows else []
        )
        r_rows = [[int(x) for x in t] for t in r_rows]
        vars_, rows = (
            (list(atom.vars), r_rows)
            if vars_ is None
            else _nat_join(vars_, rows, list(atom.vars), r_rows)
        )
    idx = [vars_.index(v) for v in query.head]
    return sorted(tuple(r[i] for i in idx) for r in rows)


def result_to_sorted(result: dict[str, np.ndarray], head) -> list:
    cols = [np.asarray(result[v]) for v in head]
    return sorted(tuple(int(c[i]) for c in cols) for i in range(len(cols[0]) if cols else 0))
