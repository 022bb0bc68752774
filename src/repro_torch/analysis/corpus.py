"""The analysis corpus: every plan shape the system actually produces.

The mutation-fuzz suite and the CI gate need a fixed population of
*real* plans — built by the real optimizer, capacity planner, and
executor stack, over data big enough that the planner makes non-trivial
choices — to establish the zero-false-positive half of the verifier's
contract: every rule must stay silent on everything the planner emits.

Each `Case` is one (query, relations, serving knobs) combination chosen
to exercise a distinct structural regime:

* ``triangle``       — the cyclic WCOJ showcase (R(x,y) S(y,z) T(z,x)).
* ``triangle-self``  — the same shape as a self-join over one edge set.
* ``clover``         — one hub variable covering three petals (Ex. 3.6).
* ``star``           — the bench star: hub y with two satellite atoms.
* ``chain-selective``— a 4-hop chain with tiny end tables (the shape
                       where factoring and compaction actually fire).
* ``bushy``          — 5 atoms whose optimal tree is bushy: multi-stage
                       chain, stage atoms, stage-DAG checks for real.
* ``star-delta``     — the star over delta-built tries (relcache appends
                       and deletes after a first warm run).
* ``star-filtered``  — a serving template with kill-mode filters
                       (constant-parameterized executor, FilteredStats
                       capacity planning).
* ``star-batched``   — the same template batched over 4 lanes
                       (mask-mode filters, (B, F) constants).
* ``star-seeded``    — the same template on seeded lanes, as the serving
                       engine acquires it (its first node probes the
                       constants; the port's own case: the reference
                       has no seeded runner).

Every case draws its relations with the reference corpus's own
`np.random.default_rng` calls in the same order
(src/repro/analysis/corpus.py), so both packages lint the same data.
`build_runner(case, device=)` routes through `api._acquire_runner` — the
SAME acquisition path compiled_free_join and the serving engine use — so
what the corpus lints and audits is what production runs, not a
reimplementation.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.api import ExecOptions, _acquire_runner
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


@dataclass(frozen=True)
class Case:
    """One corpus entry: a query over generated relations plus the
    serving knobs that shape the runner built from it."""

    name: str
    query: Query
    relations: dict[str, Relation] = field(hash=False)
    filters: dict[str, int] | None = field(default=None, hash=False)
    batch: int | None = None
    seeded: bool = False  # seeded lanes, where the plan takes them
    agg: str | None = "count"
    options: ExecOptions = ExecOptions()
    # applied to the runner's relations AFTER a first warm run, so the
    # audited executor consumes delta-merged (padded, weighted) tries
    # instead of cold builds — see build_runner
    mutate: object = field(default=None, hash=False, compare=False)

    @property
    def filter_vars(self) -> tuple[str, ...]:
        return tuple(sorted(self.filters)) if self.filters else ()

    @property
    def filter_consts(self):
        if not self.filters:
            return None
        row = np.asarray([self.filters[v] for v in self.filter_vars], np.int32)
        if self.batch is None:
            return row
        return np.tile(row, (self.batch, 1))


def _edges(rng, n: int, dom: int, a: str, b: str, name: str) -> Relation:
    return Relation(
        name,
        {a: rng.integers(0, dom, n).astype(np.int64),
         b: rng.integers(0, dom, n).astype(np.int64)},
    )


def corpus_cases(seed: int = 0) -> list[Case]:
    rng = np.random.default_rng(seed)

    cases: list[Case] = []

    # triangle: R(x,y), S(y,z), T(z,x)
    tri_rels = {
        "R": _edges(rng, 1500, 120, "x", "y", "R"),
        "S": _edges(rng, 1500, 120, "y", "z", "S"),
        "T": _edges(rng, 1500, 120, "z", "x", "T"),
    }
    tri_q = Query([Atom("R", ("x", "y")), Atom("S", ("y", "z")), Atom("T", ("z", "x"))])
    cases.append(Case("triangle", tri_q, tri_rels))

    # triangle as a self-join: one edge sample bound under three renamings
    src = rng.integers(0, 100, 1200).astype(np.int64)
    dst = rng.integers(0, 100, 1200).astype(np.int64)
    self_rels = {
        "e1": Relation("E", {"x": src, "y": dst}),
        "e2": Relation("E", {"y": src, "z": dst}),
        "e3": Relation("E", {"z": src, "x": dst}),
    }
    self_q = Query(
        [
            Atom("E", ("x", "y"), "e1"),
            Atom("E", ("y", "z"), "e2"),
            Atom("E", ("z", "x"), "e3"),
        ]
    )
    cases.append(Case("triangle-self", self_q, self_rels))

    # clover: three petals sharing hub x (the COLT showcase shape)
    clover_rels = {
        "P1": _edges(rng, 1200, 80, "x", "a", "P1"),
        "P2": _edges(rng, 1200, 80, "x", "b", "P2"),
        "P3": _edges(rng, 1200, 80, "x", "c", "P3"),
    }
    clover_q = Query(
        [Atom("P1", ("x", "a")), Atom("P2", ("x", "b")), Atom("P3", ("x", "c"))]
    )
    cases.append(Case("clover", clover_q, clover_rels))

    # star: the bench star shape
    star_rels = {
        "R": _edges(rng, 2000, 150, "x", "y", "R"),
        "S": _edges(rng, 2000, 150, "y", "a", "S"),
        "T": _edges(rng, 2000, 150, "y", "b", "T"),
    }
    star_q = Query([Atom("R", ("x", "y")), Atom("S", ("y", "a")), Atom("T", ("y", "b"))])
    cases.append(Case("star", star_q, star_rels))

    # 4-hop chain with selective ends: A and D tiny, B and C wide
    chain_rels = {
        "A": _edges(rng, 60, 40, "a", "b", "A"),
        "B": _edges(rng, 2500, 200, "b", "c", "B"),
        "C": _edges(rng, 2500, 200, "c", "d", "C"),
        "D": _edges(rng, 60, 40, "d", "e", "D"),
    }
    chain_q = Query(
        [
            Atom("A", ("a", "b")),
            Atom("B", ("b", "c")),
            Atom("C", ("c", "d")),
            Atom("D", ("d", "e")),
        ]
    )
    cases.append(Case("chain-selective", chain_q, chain_rels))

    # bushy: two independent arms meeting at the star — the optimizer's
    # DPsub enumeration picks a bushy tree here, exercising multi-stage
    # chains, stage atoms, and the stage DAG
    bushy_rels = {
        "A": _edges(rng, 900, 70, "u", "v", "A"),
        "B": _edges(rng, 900, 70, "v", "x", "B"),
        "R": _edges(rng, 1500, 110, "x", "y", "R"),
        "S": _edges(rng, 1500, 110, "y", "a", "S"),
        "T": _edges(rng, 1500, 110, "y", "b", "T"),
    }
    bushy_q = Query(
        [
            Atom("A", ("u", "v")),
            Atom("B", ("v", "x")),
            Atom("R", ("x", "y")),
            Atom("S", ("y", "a")),
            Atom("T", ("y", "b")),
        ]
    )
    cases.append(Case("bushy", bushy_q, bushy_rels))

    # the star again over delta-built tries: the runner's first (warm) run
    # builds cold, then rows are appended and tombstoned through the
    # relcache mutation API — the audited program consumes level buffers
    # produced by the sorted-run merge (padded to the capacity bucket,
    # PAD_KEY tail, multiplicity-weighted), the PR 9 storage contract
    delta_rng = np.random.default_rng(seed + 17)

    def _star_mutate(rels):
        from repro_torch.core import relcache

        r = rels["R"]
        relcache.append(
            r,
            {v: delta_rng.integers(0, 150, 64).astype(np.int64) for v in ("x", "y")},
        )
        relcache.delete(r, np.arange(8))

    delta_rels = {
        "R": _edges(rng, 2000, 150, "x", "y", "R"),
        "S": _edges(rng, 2000, 150, "y", "a", "S"),
        "T": _edges(rng, 2000, 150, "y", "b", "T"),
    }
    cases.append(Case("star-delta", star_q, delta_rels, mutate=_star_mutate))

    # serving template, kill-mode filters (unbatched): constants are
    # runtime inputs, capacities planned for the selected slice
    cases.append(Case("star-filtered", star_q, star_rels, filters={"y": 7}))

    # the same template batched over 4 lanes: mask-mode filters, one
    # dispatch runs 4 constant vectors against shared tries
    cases.append(
        Case(
            "star-batched",
            star_q,
            star_rels,
            filters={"y": 7},
            batch=4,
        )
    )

    # and on seeded lanes: each lane's join starts from its constant
    cases.append(Case("star-seeded", star_q, star_rels, filters={"y": 7}, batch=4, seeded=True))

    return cases


def build_runner(case: Case, *, device="cuda"):
    """Build the case's AdaptiveExecutor on `device` through the
    production acquisition path. Returns (runner, rels): rels is the
    relation dict the runner executes over."""
    runner, rels, _cacheable, _tree = _acquire_runner(
        case.query,
        case.relations,
        None,
        agg=case.agg,
        options=replace(case.options, device=device),
        filter_vars=case.filter_vars,
        batch=case.batch,
        seeds=case.filter_consts if case.seeded else None,
    )
    if case.mutate is not None:
        # warm run builds the cold tries, then the mutation goes through
        # the relcache delta API: the caller's next run is served merged
        # level buffers, not a rebuild
        runner.run_relations(rels, filter_consts=case.filter_consts)
        case.mutate(rels)
    return runner, rels
