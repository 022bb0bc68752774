"""The closed loop: one client sends the configuration's main query (or the
mix's `query`) back to back and waits for each answer. With
`fresh_tables`, each query runs over newly loaded tables (the dataset's
`redraw`: new Relation objects over fresh copies, and whatever the dataset
draws anew per query), made between queries and outside the window's
time; the window is then the sum of the queries' own times.

Parameters: query ("main" or a query of the configuration), fresh_tables,
warmup_calls.
"""
from __future__ import annotations

import time

from perfbench import reference
from perfbench.harness.loops import atoms_of, plain

WARMUP_MAX = 20  # calls before a warm-up gives up waiting for steady calls
FRESH_WARMUP_BASE = 2**31  # dataset redraw indices of the cold loop's warm-up


class Loop:
    def __init__(self, cell, tables, program, seed: int):
        self.cell, self.tables, self.program, self.seed = cell, tables, program, seed
        self.cfg, self.params = cell.config, cell.traffic
        self.dataset = cell.dataset()
        self.atoms = atoms_of(self.cfg, self.cfg["main_query"] if self.params["query"] == "main"
                              else self.params["query"])
        self.fresh = bool(self.params.get("fresh_tables"))
        self.clock = time.perf_counter
        self.query = program.query(self.atoms)
        self.rels = None if self.fresh else program.relations(self.atoms, tables)
        self.answers: list[tuple[int, int]] = []  # (redraw index or -1, count)
        self.index = 0
        self._reruns: dict[int, int] = {}

    def _call(self, rels) -> tuple[int, float, int]:
        t = self.clock()
        out, info = self.program.count(self.query, rels)
        dt = self.clock() - t
        key = id(info["runner"])
        reruns = info["reruns"] - self._reruns.get(key, 0)
        self._reruns[key] = info["reruns"]
        return out, dt, reruns

    def _fresh_rels(self, index: int):
        self.rels = None  # the last query's state dies here, outside the window
        return self.program.relations(self.atoms, self.dataset.redraw(
            self.cfg, self.tables, self.seed, index))

    def setup(self, seconds: float | None = None) -> None:
        """Warm every shape the window uses: the warm loop calls until two
        calls in a row build no trie and rerun nothing; the cold loop runs
        its warm-up queries over fresh tables of their own."""
        n = int(self.params.get("warmup_calls", 3))
        if self.fresh:
            for k in range(n):
                self._call(self._fresh_rels(FRESH_WARMUP_BASE + k))
            return
        steady, before = 0, self.program.trie_builds()
        for k in range(WARMUP_MAX):
            _out, _dt, reruns = self._call(self.rels)
            builds = self.program.trie_builds()
            steady = steady + 1 if (builds == before and reruns == 0) else 0
            before = builds
            if k + 1 >= n and steady >= 2:
                return

    def iterate(self, rec) -> float:
        """One query; returns the seconds it adds to the window."""
        index = -1
        if self.fresh:
            index = self.index
            self.index += 1
            rels = self._fresh_rels(index)
        else:
            rels = self.rels
        out, dt, reruns = self._call(rels)
        if rec is not None:
            rec.latencies_s.append(dt)
            rec.add("reruns", reruns)
            rec.completed += 1
            rec.attempted += 1
        self.answers.append((index, out))
        return dt

    def window(self, rec, seconds: float, stretch=None) -> None:
        """Queries until `seconds` of window time; `stretch(iterate)`, where
        given, traces some of them a third of the way in."""
        total = 0.0
        while total < seconds:
            if stretch is not None and total >= seconds / 3:
                total += stretch(lambda: self.iterate(rec))
                stretch = None
            else:
                total += self.iterate(rec)
        rec.window_s = total

    def one_more(self) -> None:
        self.iterate(None)

    def release(self) -> None:
        self.rels = None

    def check(self) -> dict:
        """Every answer against the reference. Returns the compared numbers
        with their limits: exact answers, so each limit is 0."""
        by_index: dict[int, int] = {}
        memo: dict = {}
        redrawn = tuple(getattr(self.dataset, "REDRAWN", ()))
        wrong = 0
        for index, out in self.answers:
            if index not in by_index:
                tables = self.tables
                if index >= 0 and redrawn:
                    new = self.dataset.redraw(self.cfg, self.tables, self.seed, index)
                    tables = {**self.tables, **{t: new[t] for t in redrawn}}
                by_index[index] = reference.count(plain(self.atoms), tables, memo=memo,
                                                   device=self.program.device)
            wrong += out != by_index[index]
        return {"wrong_answers": (wrong, 0), "answers": (len(self.answers), None)}


