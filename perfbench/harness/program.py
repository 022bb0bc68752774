"""The system under test, behind the few calls the loops make: the PyTorch
port (`repro_torch`), or the control (harness/control.py) in its place.
This is the one module of the harness that imports the port; it hands the
port the benchmark's own generated columns, wrapped as its Relations.

A loop that needs a call of the port that Port lacks adds it as a file:
perfbench/port/<name>.py holding `port(program, ...)` (and, for the
control, `control(control, ...)`); `program.<name>(...)` then calls it.
"""
from __future__ import annotations

from pathlib import Path

from perfbench.harness.manifest import extension

ROOT = Path(__file__).resolve().parents[2]


class Port:
    """repro_torch's compiled Free Join query and its serving engine, on
    `device` ("cuda"; "cpu" runs every kernel's plain version, for tests)."""

    def __init__(self, device: str = "cuda", root: Path = ROOT):
        from repro_torch.core import TRIE_CACHE, ExecOptions, compiled_free_join
        from repro_torch.relational.relation import Relation
        from repro_torch.relational.schema import Atom, Query

        self.device, self.root = device, root
        self.options = ExecOptions(device=device)
        self._count, self._Relation = compiled_free_join, Relation
        self._Atom, self._Query = Atom, Query
        self._tries = TRIE_CACHE

    def relations(self, atoms, tables, shared: dict | None = None) -> dict:
        """One Relation per atom alias over the tables' own arrays (no
        copy), its columns renamed to the atom's variables: the views of a
        self-join share their table's columns. `shared` keeps the views
        made so far, so that queries over one table use one Relation per
        view, as a service holding that table does."""
        shared = {} if shared is None else shared
        out = {}
        for table, vs, alias in atoms:
            key = (table, tuple(vs), id(tables[table]))
            if key not in shared:
                shared[key] = self._Relation(table, dict(zip(vs, tables[table].values())))
            out[alias] = shared[key]
        return out

    def query(self, atoms):
        return self._Query([self._Atom(table, tuple(vs), alias) for table, vs, alias in atoms])

    def count(self, query, rels) -> tuple[int, dict]:
        """The query's count, and what the call did: the runner it used and
        that runner's retries + reshapes so far."""
        info: dict = {}
        out = self._count(query, rels, agg="count", options=self.options, info=info)
        return int(out), {"runner": info["runner"],
                          "reruns": info["retries"] + info["reshapes"]}

    def trie_builds(self) -> int:
        """Full trie builds so far: a warm call makes none."""
        return self._tries.builds

    def engine(self, slots: int):
        from repro_torch.serve import JoinServeEngine

        return JoinServeEngine(slots=slots, options=self.options)

    def spell(self, rels: dict, atoms, prefix: str, order) -> tuple:
        """A tenant's own spelling of a query: its aliases prefixed, its
        atoms in `order`, over the same Relation objects. Returns (query,
        relations)."""
        mine = [(table, vs, prefix + alias) for table, vs, alias in (atoms[i] for i in order)]
        return self.query(mine), {prefix + alias: rels[alias] for _t, _v, alias in atoms}

    def __getattr__(self, name: str):  # a call added as perfbench/port/<name>.py
        if name == "root":
            raise AttributeError(name)
        return extension(self, name, "port")
