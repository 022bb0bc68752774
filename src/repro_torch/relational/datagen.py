"""Synthetic workloads for the port's end-to-end runs, made from a seed.

* LSQB (Mhedhbi et al., GRADES-NDA 2021), the graph benchmark the Free
  Join paper evaluates on: the `knows` edge table at scale factor SF has
  180,000 * SF + 200 rows over 30,000 * SF + 100 persons, both endpoints
  Zipf(a=1.4) with independent permutations of the person domain. Query
  q1 is the triangle knows(a,b), knows(b,c), knows(c,a) — the cyclic,
  worst-case-optimal case.
* The low-selectivity star Q(x,y,a,b) :- R(x,y), S(y,a), T(y,b), where S
  covers only a `sel` fraction of the y domain: the acyclic case, where
  the S probe kills most of the frontier and the planner schedules a
  compaction before the T probe.

Both draw their numbers in the same order as the reference package's
benchmark generators, so the same seed gives the same tables.
"""
from __future__ import annotations

import numpy as np

from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


def _zipf(rng, n, domain, a=1.3):
    """Zipf-skewed foreign keys with an independent permutation of the
    domain per call: heavy hitters, but different ones per call."""
    z = rng.zipf(a, n)
    perm = rng.permutation(domain)
    return perm[(z - 1) % domain].astype(np.int64)


def lsqb_knows(sf: float = 0.1, seed: int = 1) -> Relation:
    """The LSQB `knows` table (a -> b) at scale factor `sf`."""
    rng = np.random.default_rng(seed)
    n_person = int(30_000 * sf) + 100
    n_knows = int(180_000 * sf) + 200
    src = _zipf(rng, n_knows, n_person, a=1.4)
    dst = _zipf(rng, n_knows, n_person, a=1.4)
    return Relation("knows", {"a": src, "b": dst})


def lsqb_q1(knows: Relation) -> tuple[Query, dict[str, Relation]]:
    """LSQB q1, the triangle, over three renamed views of `knows`."""
    q = Query(
        [
            Atom("knows", ("a", "b"), "K1"),
            Atom("knows", ("b", "c"), "K2"),
            Atom("knows", ("c", "a"), "K3"),
        ]
    )
    rels = {
        "K1": knows,
        "K2": knows.rename({"a": "b", "b": "c"}),
        "K3": knows.rename({"a": "c", "b": "a"}),
    }
    return q, rels


def lowsel_star(n: int = 600_000, dom: int = 30_000, sel: float = 0.02, seed: int = 0):
    """The low-selectivity star: R has n rows, S covers a `sel` fraction of
    the y domain with that many rows, T has n // 10 rows."""
    rng = np.random.default_rng(seed)
    q = Query([Atom("R", ("x", "y")), Atom("S", ("y", "a")), Atom("T", ("y", "b"))])
    ny = max(1, int(dom * sel))
    y_live = rng.choice(dom, ny, replace=False)
    rels = {
        "R": Relation("R", {"x": rng.integers(0, dom, n), "y": rng.integers(0, dom, n)}),
        "S": Relation("S", {"y": y_live[rng.integers(0, ny, ny)],
                            "a": rng.integers(0, dom, ny)}),
        "T": Relation("T", {"y": rng.integers(0, dom, n // 10),
                            "b": rng.integers(0, dom, n // 10)}),
    }
    return q, rels
