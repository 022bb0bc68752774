"""The control: the plain reference put in the program's place, with one
guarantee of the configuration broken, to show that the comparison which
decides `correct` fails what it should. Configurations name theirs:

* set_semantics: duplicate rows counted once (tables deduplicated), where
  the configuration promises bag semantics;
* sampled: an estimate, the count over every other row of each table
  scaled up by 2 per atom, where it promises exact counts.

It answers through the same calls as harness/program.Port (and the
`control()` of a perfbench/port/<name>.py extension), so a run drives it as
it drives the port. It computes on `device`: the card, where there is one,
so that it reads the card's draw of a dataset at the cell's size.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from perfbench import reference
from perfbench.harness.manifest import HERE, extension


def _dedup(cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    rows = np.unique(np.stack(list(cols.values()), axis=1), axis=0)
    return {v: rows[:, i] for i, v in enumerate(cols)}


@dataclass
class Bound:
    """A query's atoms over one set of tables."""
    atoms: list
    tables: dict


@dataclass
class Handle:
    query: tuple
    rels: Bound
    filters: dict
    result: object = None
    error: Exception | None = None
    done: bool = False


class Control:
    def __init__(self, kind: str, device: str = "cpu", root=HERE.parent):
        if kind not in ("set_semantics", "sampled"):
            raise ValueError(f"unknown control {kind!r}")
        self.kind, self.device, self.root = kind, device, root
        self._seen: dict = {}

    def __getattr__(self, name: str):  # a call added as perfbench/port/<name>.py
        if name == "root":
            raise AttributeError(name)
        return extension(self, name, "control")

    def _tables(self, tables: dict) -> dict:
        key = id(tables)
        if key not in self._seen:
            f = _dedup if self.kind == "set_semantics" else (lambda c: reference.sampled({0: c})[0])
            if len(self._seen) > 4:
                self._seen.clear()
            self._seen[key] = (tables, {t: f(c) for t, c in tables.items()})
        return self._seen[key][1]

    def _scale(self, atoms) -> int:
        return 2 ** len(atoms) if self.kind == "sampled" else 1

    def relations(self, atoms, tables, shared=None) -> Bound:
        return Bound([(t, tuple(v)) for t, v, _a in atoms], tables)

    def query(self, atoms):
        return tuple((t, tuple(v)) for t, v, _a in atoms)

    def count(self, query, rels: Bound) -> tuple[int, dict]:
        n = reference.count(rels.atoms, self._tables(rels.tables), device=self.device)
        n *= self._scale(rels.atoms)
        return n, {"runner": None, "reruns": 0}

    def trie_builds(self) -> int:
        return 0

    def spell(self, rels: Bound, atoms, prefix: str, order) -> tuple:
        return self.query(atoms), rels

    def engine(self, slots: int):
        return _Engine(self, slots)


class _Engine:
    """Answers queued point queries `slots` at a time, in arrival order."""

    def __init__(self, control: Control, slots: int):
        self.control, self.slots = control, slots
        self.queue: deque = deque()
        self.dispatches = 0
        self._points: dict = {}

    def submit(self, query, rels, filters, tenant="default"):
        h = Handle(query, rels, dict(filters))
        self.queue.append(h)
        return h

    def step(self):
        batch = [self.queue.popleft() for _ in range(min(self.slots, len(self.queue)))]
        for h in batch:
            (var, c), = h.filters.items()
            key = (h.query, var, id(h.rels.tables))
            if key not in self._points:
                tables = self.control._tables(h.rels.tables)
                self._points[key] = reference.point_counts(h.rels.atoms, tables, var,
                                                            device=self.control.device)
            h.result, h.done = self._points[key](c) * self.control._scale(h.rels.atoms), True
        self.dispatches += 1
        return batch

    def run(self):
        while self.queue:
            self.step()
