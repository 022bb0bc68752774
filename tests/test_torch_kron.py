"""Lane-choice nodes and tiles of the port's compiled path, on GAP's kron
graph (perfbench/datasets/gap_kron.py) against the benchmark's plain
reference of the triangle (perfbench/reference_triangles.py).

The planner splits q1's partly bound lookup K3(c,a) into K3(a), probed in
node 0, and K3(c), a second cover of node 1, where its per-key estimate
says the split expands fewer lanes: on hub-skewed graphs, not on uniform
ones. Each lane of node 1 then iterates whichever of K2(c) and K3(c) holds
fewer keys under it. A node whose lanes pass the lane budget runs the
first node's rows in tiles. Everything runs on the CPU (every kernel's
plain version); the file imports no JAX.
"""
import math

import numpy as np
import pytest
import torch

from perfbench import reference, reference_triangles
from perfbench.datasets import gap_kron, gap_urand
from repro_torch.core import api, capacity, compiled, membudget
from repro_torch.core.api import ExecOptions, compiled_free_join
from repro_torch.core.capacity import INDEX_LIMIT, CapacityPlan, lane_budget
from repro_torch.core.compiled import TRIE_CACHE, AdaptiveExecutor, make_executor
from repro_torch.core.optimizer import Stats, split_lanes
from repro_torch.core.plan import binary2fj, factor, gj_plan, seed_plan, split_lookups
from repro_torch.core.trace import TRACE
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from repro_torch.serve import JoinServeEngine

CPU = ExecOptions(device="cpu")
KRON = {"degree": 16, "initiator": {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05},
        "structure_seed": 0}
ATOMS = [("knows", ("a", "b")), ("knows", ("b", "c")), ("knows", ("c", "a"))]
Q1 = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2"),
            Atom("knows", ("c", "a"), "K3")])


def kron(scale: int, seed: int = 7) -> dict:
    return gap_kron.generate({**KRON, "scale": scale}, seed)["knows"]


def urand(scale: int, seed: int = 7) -> dict:
    return gap_urand.generate({"scale": scale, "degree": 16, "structure_seed": 0}, seed)["knows"]


def views(cols: dict) -> dict:
    """q1's three views of one edge table, as the benchmark's Port makes them."""
    a, b = cols["a"], cols["b"]
    return {"K1": Relation("knows", {"a": a, "b": b}), "K2": Relation("knows", {"b": a, "c": b}),
            "K3": Relation("knows", {"c": a, "a": b})}


def q1_plan():
    return factor(binary2fj(Q1.atoms, Q1))


@pytest.mark.parametrize("scale", [8, 9, 10])
def test_kron_split_plan_equals_reference_triangles(scale):
    cols = kron(scale)
    rels = views(cols)
    info = {}
    got = compiled_free_join(Q1, rels, options=CPU, info=info)
    plan = info["runner"].plan
    assert plan.lane_choice == (1,) and str(plan).startswith(
        "[[K1(a,b), K2(b), K3(a)], {K2(c), K3(c)}")
    assert got == reference_triangles.count(ATOMS, {"knows": cols})
    # warm: the split's tries built once, no rerun, the same answer
    builds, retries = TRIE_CACHE.builds, info["retries"] + info["reshapes"]
    again = compiled_free_join(Q1, rels, options=CPU, info=info)
    assert again == got and TRIE_CACHE.builds == builds
    assert info["retries"] + info["reshapes"] == retries


@pytest.mark.parametrize("make,scale", [(kron, 4), (urand, 4), (kron, 6), (urand, 6)])
def test_reference_triangles_matches_reference_and_brute_force(make, scale):
    tables = {"knows": make(scale)}
    want = reference.count(ATOMS, tables)
    assert reference_triangles.count(ATOMS, tables) == want
    if scale == 4:
        assert reference.brute_force(ATOMS, tables) == want
    # wedges closed a few at a time count the same
    old = reference_triangles.BLOCK
    reference_triangles.BLOCK = 7
    try:
        assert reference_triangles.count(ATOMS, tables) == want
    finally:
        reference_triangles.BLOCK = old


@pytest.mark.parametrize("bad", ["self-loop", "duplicate", "one direction", "not a triangle"])
def test_reference_triangles_raises_on_what_it_does_not_count(bad):
    a = np.array([0, 1, 1, 2, 2, 0])
    b = np.array([1, 0, 2, 1, 0, 2])
    atoms = ATOMS
    if bad == "self-loop":
        a, b = np.append(a, 3), np.append(b, 3)
    elif bad == "duplicate":
        a, b = np.append(a, 0), np.append(b, 1)
    elif bad == "one direction":
        a, b = np.append(a, 0), np.append(b, 3)
    else:
        atoms = ATOMS[:2] + [("knows", ("a", "c"))]
    assert reference_triangles.count(ATOMS, {"knows": {"a": a[:6], "b": b[:6]}}) == 6
    with pytest.raises(ValueError):
        reference_triangles.count(atoms, {"knows": {"a": a, "b": b}})


@pytest.mark.parametrize("make,split", [(urand, False), (kron, True)], ids=["urand", "kron"])
def test_uniform_keeps_the_plan_skewed_takes_the_split(make, split):
    rels = views(make(9))
    plan = q1_plan()
    stats = Stats(rels)
    before, after = split_lanes(plan, split_lookups(plan), stats)
    assert (after < before) == split
    info = {}
    compiled_free_join(Q1, rels, options=CPU, info=info)
    got = info["runner"].plan
    assert (got.lane_choice == (1,)) == split
    if not split:
        assert str(got) == str(plan)


def test_tiles_under_a_budget_count_the_same(monkeypatch):
    """Under a memory budget of a third of node 1's estimated lanes (at
    capacity.LANE_BYTES each) the plan takes three tiles, each a slice of
    K1's rows, and counts and rows are those of the untiled plan. The
    floor under which no plan tiles (capacity.TILE_MIN_LANES, 2**20) is
    lowered to reach this size."""
    monkeypatch.setattr(capacity, "TILE_MIN_LANES", 1)
    cols = kron(8)
    want = reference_triangles.count(ATOMS, {"knows": cols})
    untiled = views(cols)
    rows_want = compiled_free_join(Q1, untiled, agg=None, options=CPU)
    runner, *_rest = api._acquire_runner(Q1, untiled, None, agg="count", options=CPU)
    est = max(e.expand for e in runner.cap_plan.estimates)
    assert runner.cap_plan.tiles == 1 and est > 2 * len(cols["a"])  # the skew-aware estimate
    rels = views(cols)  # new relation objects: a runner planned under the budget
    info = {}
    with membudget.budget(int(est / 3) * capacity.LANE_BYTES + capacity.LANE_BYTES):
        got = compiled_free_join(Q1, rels, options=CPU, info=info)
        cp = info["cap_plan"]
        assert cp.tiles == 3 and "degraded_to" not in info
        assert max(cp.capacities) <= lane_budget("cpu")
        tiles = TRACE.exec_tile.count
        assert compiled_free_join(Q1, rels, options=CPU, info=info) == got  # warm
        assert TRACE.exec_tile.count - tiles == 3
        rows = compiled_free_join(Q1, rels, agg=None, options=CPU, info=info)
    assert got == want
    key = [tuple(sorted(zip(*(r[0][v] for v in "abc"), r[1]))) for r in (rows, rows_want)]
    assert key[0] == key[1]


def test_a_need_past_int32_reads_back_unwrapped():
    """A two-path through one key: 2**16 rows in, 2**16 under the key, so
    node 1 needs 2**32 lanes. The need reads back as 2**32, and the
    adaptive runner tiles the plan where it can and raises where not."""
    n = 1 << 16
    q = Query([Atom("R", ("a", "b")), Atom("S", ("b", "c"))])
    rels = {"R": Relation("R", {"a": np.arange(n), "b": np.zeros(n, np.int64)}),
            "S": Relation("S", {"b": np.zeros(n, np.int64), "c": np.arange(n)})}
    plan = factor(binary2fj(q.atoms, q))
    fn = make_executor(plan, (n, 1024), agg=None)
    data = compiled.relations_to_cols(plan, rels, "cpu")
    *_rows, ne, _nc = fn(data)
    assert ne.dtype == torch.int64 and int(ne[1]) == n * n
    runner = AdaptiveExecutor(plan, CapacityPlan(capacities=(n, 1024), compact_to=(None, None)),
                              device="cpu")
    chain = runner._as_chain(runner.cap_plan)
    grown = runner._grow(chain, 0, 1, n * n, None)
    tiles = grown.stages[0].tiles
    assert n * n / tiles <= lane_budget("cpu") < n * n and grown.stages[0].capacities == (n, 1024)
    gj = gj_plan(q, ["a", "b", "c"])  # its first node reads R's first level: no tiles
    runner = AdaptiveExecutor(gj, CapacityPlan(capacities=(n, n, 1024),
                                               compact_to=(None,) * 3), device="cpu")
    assert not runner.schedule.tileable()
    with pytest.raises(RuntimeError, match="cannot run in tiles"):
        runner._grow(runner._as_chain(runner.cap_plan), 0, 2, INDEX_LIMIT + 1, None)


def test_seeded_requests_over_a_split_template_are_exact():
    cols = kron(9)
    rels = views(cols)
    a, b = cols["a"], cols["b"]
    deg = np.bincount(a)
    hub, light = int(np.argmax(deg)), int(np.flatnonzero(deg == 1)[0])
    adj = {}
    for x, y in zip(a.tolist(), b.tolist()):
        adj.setdefault(x, set()).add(y)

    def triangles_at(x):  # q1 with a = x: ordered pairs (b, c) closing at x
        return sum(len(adj[x] & adj[y]) for y in adj.get(x, ()))

    eng = JoinServeEngine(slots=4, options=CPU)
    seeded = TRACE.seeded_dispatches
    consts = [light, hub, light + 1, 1 << 20]
    reqs = [eng.submit(Q1, rels, {"a": c}) for c in consts]
    eng.run()
    assert TRACE.seeded_dispatches > seeded
    for c, r in zip(consts, reqs):
        assert r.error is None and r.result == triangles_at(c)
    split = split_lookups(q1_plan())
    seeded_plan = seed_plan(split, ("a",))
    assert seeded_plan.seeded and seeded_plan.lane_choice == (2,)
    assert str(seeded_plan) == "seeded [[K1(a), K3(a)], [K1(b), K2(b)], {K2(c), K3(c)}, [K3()]]"
