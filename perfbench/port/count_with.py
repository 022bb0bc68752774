"""A query's count where the configuration names its own reference
(loops/closed_ownref.py).

port(): the port counts as harness/program.Port.count does.
control(): the control's count through that reference. Its `sampled`
estimate keeps every other undirected edge of each table, both directions
of each kept edge (a graph reference requires a symmetric table), and
scales the count up by 2 per atom; `set_semantics` counts as the
control's own count does.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from perfbench.harness.manifest import module


def port(program, query, rels, reference: str):
    return program.count(query, rels)


def _every_other_edge(cols: dict) -> dict:
    (x, a), (y, b) = cols.items()
    a, b = np.asarray(a), np.asarray(b)
    lo = a < b
    a, b = a[lo][::2], b[lo][::2]
    return {x: np.concatenate([a, b]), y: np.concatenate([b, a])}


def control(control, query, rels, reference: str):
    if control.kind != "sampled":
        return control.count(query, rels)
    ref = module(Path(control.root) / "perfbench" / f"{reference}.py", f"perfbench_{reference}")
    tables = {t: _every_other_edge(c) for t, c in rels.tables.items()}
    n = ref.count(rels.atoms, tables, device=control.device) * control._scale(rels.atoms)
    return n, {"runner": None, "reruns": 0}
