"""The open loop: requests arrive on a schedule whatever the system does.
rate_per_s * seconds arrivals, due at the times the mix's arrival process
(perfbench/arrivals/<arrivals>.py) gives, each a point query of one of
`templates` in turn with the configuration's point variable bound to a
constant that the mix's constants part (perfbench/constants/<constants>.py)
picks among the values that bind rows, most rows first; spelled by one of
`tenants` tenants with its own aliases and atom order, and served by the
engine with `slots` lanes. One thread submits every due request, then
steps the engine once. A request's latency runs from its due time to the
return of the step that retired it.

Parameters: rate_per_s, arrivals, constants (and what those parts read),
templates, tenants, slots, drain_s.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import reference
from perfbench.harness.loops import atoms_of, plain


class Loop:
    def __init__(self, cell, tables, program, seed: int):
        self.cell, self.tables, self.program, self.seed = cell, tables, program, seed
        self.cfg, self.params = cell.config, cell.traffic
        self.clock = time.perf_counter
        self.rate = float(self.params["rate_per_s"])
        self.var = self.cfg["point_var"]
        structure = np.random.default_rng([self.cfg["structure_seed"], 4])
        names = list(self.params["templates"])
        tenants = int(self.params["tenants"])
        self.spelled = {}
        views: dict = {}  # one Relation per view of a table, for every template
        for name in names:
            atoms = atoms_of(self.cfg, name)
            rels = program.relations(atoms, tables, views)
            for t in range(tenants):
                order = structure.permutation(len(atoms))
                self.spelled[t, name] = program.spell(rels, atoms, f"t{t}_", order)
        self.names, self.tenants = names, tenants
        # the values of the point variable that bind rows, most rows first
        table, vs, _alias = next(a for a in atoms_of(self.cfg, names[0]) if self.var in a[1])
        col = list(tables[table].values())[list(vs).index(self.var)]
        vals, counts = np.unique(col, return_counts=True)
        self.constants = vals[np.argsort(-counts, kind="stable")]
        self.engine = None
        self.requests: list = []

    def plan(self, seconds: float) -> None:
        """The window's requests: (due offset s, tenant, template, constant)."""
        n = max(1, int(round(self.rate * seconds)))
        structure = np.random.default_rng([self.cfg["structure_seed"], 5])
        run = np.random.default_rng(self.seed)
        ranks = self.cell.part("constants", self.params["constants"]).ranks(
            n, len(self.constants), structure, run, self.params)
        due = self.cell.part("arrivals", self.params["arrivals"]).due(
            n, seconds, structure, run, self.params)
        self.requests = [
            (float(due[i]), (i // len(self.names)) % self.tenants, self.names[i % len(self.names)],
             int(self.constants[ranks[i]]))
            for i in range(n)
        ]

    def _submit(self, tenant: int, name: str, c: int):
        q, rels = self.spelled[tenant, name]
        return self.engine.submit(q, rels, {self.var: c}, tenant=f"tenant{tenant}")

    def setup(self, seconds: float | None = None) -> None:
        """One engine; each template dispatched full twice, on the constants
        that bind most rows; the window's requests drawn."""
        slots = int(self.params["slots"])
        self.engine = self.program.engine(slots)
        for _ in range(2):
            for name in self.names:
                for lane in range(slots):
                    self._submit(lane % self.tenants, name, int(self.constants[lane]))
                while self.engine.queue:
                    self.engine.step()
        if seconds is not None:
            self.plan(seconds)

    def window(self, rec, seconds: float, stretch=None) -> None:
        """The requests of `seconds`, then the drain of what is left (up to
        drain_s). `stretch(iterate)`, where given, traces a stretch of the
        same load after the window, on requests of its own, so that the
        tracer's cost on the host does not back up the window's queue."""
        if len(self.requests) != max(1, int(round(self.rate * seconds))):
            self.plan(seconds)
        self.answers = []
        self._serve(rec, self.requests, seconds, keep=True)
        if stretch is not None:
            self._serve(None, self.requests, seconds, stretch=stretch)

    def _serve(self, rec, requests, seconds: float, keep: bool = False, stretch=None):
        eng = self.engine
        dispatches = eng.dispatches
        start = self.clock()
        end = start + seconds
        drain_until = end + float(self.params.get("drain_s", 60))
        pending: dict[int, tuple] = {}  # id(handle) -> (handle, due, request index)
        retired_at = [None] * len(requests)
        lateness = []
        k = 0

        def iterate() -> float:
            nonlocal k
            t0 = self.clock()
            while k < len(requests) and start + requests[k][0] <= t0:
                due, tenant, name, c = requests[k]
                h = self._submit(tenant, name, c)
                lateness.append(self.clock() - (start + due))
                pending[id(h)] = (h, start + due, k)
                k += 1
            if eng.queue:
                ts = self.clock()
                retired = eng.step()
                te = self.clock()
                for h in retired:
                    entry = pending.pop(id(h), None)
                    if entry is None:  # left queued by a window that ran out of drain time
                        continue
                    _h, due, i = entry
                    retired_at[i] = te - start
                    if keep:  # what the check needs, not the handle
                        _due, _tenant, name, c = requests[i]
                        self.answers.append((name, c, None if h.error is not None else h.result))
                    if rec is not None:
                        rec.latencies_s.append(te - due)
                        rec.waits_s.append(ts - due)
                        if te <= end and h.error is None:
                            rec.completed += 1
                        rec.add("retired", 1)
            elif k < len(requests):
                wait = start + requests[k][0] - self.clock()
                if wait > 2e-4:
                    time.sleep(wait - 1e-4)
            return self.clock() - t0

        if stretch is not None:
            stretch(iterate)
            while eng.queue:
                eng.step()
            return
        while (k < len(requests) or eng.queue) and self.clock() < drain_until:
            iterate()
        if rec is None:
            return
        rec.window_s = seconds
        rec.attempted = len(requests)
        rec.add("dispatches", eng.dispatches - dispatches)
        rec.notes["lateness_ms"] = {
            q: float(np.percentile(lateness, p)) * 1e3 for q, p in (("p50", 50), ("p99", 99))}
        rec.notes["lateness_ms"]["max"] = max(lateness) * 1e3

        def backlog(t: float) -> int:
            return sum(1 for (due, *_r), r in zip(requests, retired_at)
                       if due <= t and (r is None or r > t))

        rec.notes["backlog"] = {"half": backlog(seconds / 2), "end": backlog(seconds)}
        for name in ("degraded", "faults_absorbed"):  # the engine's own, since set-up
            if hasattr(eng, name):
                rec.notes[f"engine_{name}"] = getattr(eng, name)

    def one_more(self) -> None:
        slots = int(self.params["slots"])
        for lane in range(slots):
            self._submit(lane % self.tenants, self.names[0], int(self.constants[lane]))
        while self.engine.queue:
            self.engine.step()

    def release(self) -> None:
        self.engine = None

    def check(self) -> dict:
        """Every request of the window: answered, and as the reference
        answers it. A request never retired, or retired with an error, is
        missing."""
        points = {name: reference.point_counts(plain(atoms_of(self.cfg, name)), self.tables,
                                               self.var, device=self.program.device)
                  for name in self.names}
        missing = len(self.requests) - len(self.answers)
        wrong = 0
        for name, c, result in self.answers:
            if result is None:
                missing += 1
            elif int(result) != points[name](c):
                wrong += 1
        return {"wrong_answers": (wrong, 0), "missing_answers": (missing, 0),
                "answers": (len(self.answers), None)}


