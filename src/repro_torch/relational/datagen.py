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
* knows_inserts draws new `knows` edges from the same generator with
  another seed over the table's own hubs: the insert stream a standing
  query over `knows` ingests.

lsqb_knows and lowsel_star draw their numbers in the same order as the
reference package's benchmark generators, so the same seed gives the same
tables.
"""
from __future__ import annotations

import numpy as np

from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


def _n_person(sf: float) -> int:
    return int(30_000 * sf) + 100


def _n_knows(sf: float) -> int:
    return int(180_000 * sf) + 200


def _knows_edges(rng, n: int, n_person: int, perms=None):
    """`n` edges with Zipf(a=1.4) endpoints over `n_person` persons, drawn
    in lsqb_knows' order: source ranks, the permutation of the domain they
    map through, destination ranks, theirs. The permutations decide who the
    hubs are; given `perms` (another draw's), the ranks map through those
    and no permutation is drawn. Returns (src, dst, perms)."""
    ends, used = [], []
    for i in range(2):
        z = rng.zipf(1.4, n)
        perm = rng.permutation(n_person) if perms is None else perms[i]
        ends.append(perm[(z - 1) % n_person].astype(np.int64))
        used.append(perm)
    return ends[0], ends[1], used


def lsqb_knows(sf: float = 0.1, seed: int = 1) -> Relation:
    """The LSQB `knows` table (a -> b) at scale factor `sf`."""
    src, dst, _ = _knows_edges(np.random.default_rng(seed), _n_knows(sf), _n_person(sf))
    return Relation("knows", {"a": src, "b": dst})


def knows_inserts(sf: float, n: int, seed: int, table_seed: int) -> dict[str, np.ndarray]:
    """`n` new `knows` edges (a -> b) for lsqb_knows(sf, table_seed): LDBC
    SNB Interactive's "add friendship" insert. The Zipf ranks come from
    `seed`, the person permutations from the table's own draw, so new edges
    land on the table's hubs and close triangles with its edges. Returns
    int32 columns for relcache.append."""
    n_person = _n_person(sf)
    _, _, perms = _knows_edges(np.random.default_rng(table_seed), _n_knows(sf), n_person)
    src, dst, _ = _knows_edges(np.random.default_rng(seed), n, n_person, perms)
    return {"a": src.astype(np.int32), "b": dst.astype(np.int32)}


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
