"""The port's eager engine against the reference on the same numpy inputs:
the tensor kit (hash table, group-by, CSR expansion), COLT, the
vectorized executor, the tuple engine, the drivers free_join /
binary_join / generic_join, and the hybrid compiled baseline
(ExecOptions(chain_stages=False)).

The port runs with device="cpu", where every kernel wrapper takes its
plain PyTorch version. Every output is an integer, so every comparison is
exact: arrays element for element, results as sorted tuple lists.
"""
import jax  # noqa: F401  (the reference's compiled path; JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as J
from repro.core import colt as jcolt
from repro.core import engine as jengine
from repro.core.tuple_engine import execute_tuples as jexecute_tuples
from repro.relational import npkit as jnpkit
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch.core import (
    BinaryPlan,
    Colt,
    ExecOptions,
    ExecStats,
    binary2fj,
    binary_join,
    compiled_free_join,
    execute,
    factor,
    free_join,
    generic_join,
    linear,
    optimize,
    to_sorted_tuples,
)
from repro_torch.core.tuple_engine import execute_tuples
from repro_torch.kernels.hash_probe import mix32
from repro_torch.relational import npkit
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query, clover_query
from tests.test_property import instance, random_query

CPU = "cpu"
ENGINES = ["free_join", "binary_join", "generic_join"]


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def arr(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(got, want, what=""):
    np.testing.assert_array_equal(arr(got), arr(want), err_msg=what)


class Case:
    """One workload built for both packages from the same numpy columns."""

    def __init__(self, atoms, cols, tree=None):
        self.atoms = atoms  # [(alias, vars)] or [(alias, vars, relname)]
        self.cols = cols  # {alias: {var: ndarray}}
        self.q = Query([Atom(a[2] if len(a) > 2 else a[0], a[1], a[0]) for a in atoms])
        self.jq = JQuery([JAtom(a[2] if len(a) > 2 else a[0], a[1], a[0]) for a in atoms])
        self.rels = {a: Relation(a, c) for a, c in cols.items()}
        self.jrels = {a: JRelation(a, c) for a, c in cols.items()}
        self.tree = tree  # nested pairs of aliases, or None

    def trees(self):
        if self.tree is None:
            return None, None

        def build(node, plan_cls, atom_of):
            if isinstance(node, str):
                return atom_of(node)
            return plan_cls(build(node[0], plan_cls, atom_of), build(node[1], plan_cls, atom_of))

        return build(self.tree, BinaryPlan, self.q.atom), build(self.tree, J.BinaryPlan,
                                                               self.jq.atom)


def rand_cols(rng, atoms, n, dom):
    return {a[0]: {v: rng.integers(0, dom, n) for v in a[1]} for a in atoms}


TRIANGLE = [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x"))]
CHAIN4 = [("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")), ("D", ("w", "u"))]


def triangle_case(seed):
    return Case(TRIANGLE, rand_cols(np.random.default_rng(seed), TRIANGLE, 60, 10))


def clover_case():
    """The paper's Fig. 3 adversarial instance (test_engine.py)."""
    n = 30
    ar = np.arange(n, dtype=np.int64)
    q = clover_query()
    cols = {
        "R": {"x": np.r_[0, np.full(n, 1), np.full(n, 2)], "a": np.r_[0, ar, ar + n]},
        "S": {"x": np.r_[0, np.full(n, 2), np.full(n, 3)], "b": np.r_[0, ar, ar + n]},
        "T": {"x": np.r_[0, np.full(n, 3), np.full(n, 1)], "c": np.r_[0, ar, ar + n]},
    }
    return Case([(a.alias, a.vars) for a in q.atoms], cols)


def bag_case():
    return Case([("R", ("x", "a")), ("S", ("x", "b"))],
                {"R": {"x": np.array([1, 1, 1]), "a": np.array([5, 5, 7])},
                 "S": {"x": np.array([1, 1]), "b": np.array([9, 9])}})


def bushy_case(rng):
    atoms = [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "u")), ("U", ("u", "w"))]
    return Case(atoms, rand_cols(rng, atoms, 80, 8), tree=(("R", "S"), ("T", "U")))


def cross_case():
    return Case([("R", ("x",)), ("S", ("y",))], {"R": {"x": np.arange(4)},
                                                 "S": {"y": np.arange(3)}}, tree=("R", "S"))


def empty_case():
    return Case([("R", ("x", "y")), ("S", ("y", "z"))],
                {"R": {"x": np.arange(5), "y": np.arange(5)},
                 "S": {"y": np.zeros(0, np.int64), "z": np.zeros(0, np.int64)}})


def self_join_case(rng):
    x, y = rng.integers(0, 8, 50), rng.integers(0, 8, 50)
    return Case([("E1", ("x", "y"), "E"), ("E2", ("y", "z"), "E")],
                {"E1": {"x": x, "y": y}, "E2": {"y": x, "z": y}})


def factorized_case(rng):
    q = clover_query()
    atoms = [(a.alias, a.vars) for a in q.atoms]
    return Case(atoms, rand_cols(rng, atoms, 100, 5))


# ---------------------------------------------------------------------------
# npkit
# ---------------------------------------------------------------------------

INT32 = st.integers(-2**31, 2**31 - 1)


@given(keys=st.lists(st.tuples(INT32, INT32), min_size=0, max_size=200, unique=True),
       queries=st.lists(st.tuples(INT32, INT32), min_size=0, max_size=100))
@settings(max_examples=50, deadline=None)
def test_hashtable_probe_matches_reference(keys, queries):
    cols = [np.array([k[i] for k in keys], np.int64) for i in range(2)]
    qcols = [np.array([k[i] for k in queries], np.int64) for i in range(2)]
    want = jnpkit.HashTable(cols).probe(qcols)
    got = npkit.HashTable([t32(c) for c in cols]).probe([t32(c) for c in qcols])
    assert got.dtype == torch.int32
    assert_equal(got, want)


def test_hashtable_grows_its_budget_past_a_long_cluster():
    """40 keys with one home slot: the longest displacement (39) is past
    the kernel's 32-slot budget, so the table rebuilds with a larger one
    and every key is still found."""
    cand = np.arange(200_000, dtype=np.int32)
    home = (mix32(t32(cand)[:, None]) & 127).numpy()  # capacity 128 for 40 keys
    keys = cand[home == np.bincount(home).argmax()][:40]
    table = npkit.HashTable([t32(keys)])
    assert int(table.table.max_disp) >= 32
    assert table.table.slots.shape[0] - 128 > 32
    assert_equal(table.probe([t32(keys)]), np.arange(40))
    assert_equal(table.probe([t32([-1, 7, 2**31 - 1])]), [-1, -1, -1])


@pytest.mark.parametrize("kind", ["nonneg", "negative", "constant", "wide", "empty"])
def test_group_by_matches_reference(kind, rng):
    n = 0 if kind == "empty" else 500
    cols = [rng.integers(0, 6, n), rng.integers(0, 40, n)]
    if kind == "negative":
        cols[1] = cols[1] - 20
    elif kind == "constant":
        cols[0] = np.full(n, 3)
    elif kind == "wide":
        cols.append(rng.integers(0, 2**31 - 1, n))
    want = jnpkit.group_by(cols)
    got = npkit.group_by([t32(c) for c in cols])
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert_equal(g, w, f"uniq[{i}]")
    for name, g, w in zip(("group_of_row", "order", "offsets"), got[1:], want[1:]):
        assert_equal(g, w, name)


@pytest.mark.parametrize("groups", [[], [0], [2, 0, 2, 4], [1, 1, 3]])
def test_csr_expand_matches_reference(groups):
    offsets = np.array([0, 3, 3, 7, 8, 12])
    want = jnpkit.csr_expand(offsets, np.array(groups, np.int64))
    got = npkit.csr_expand(t32(offsets), t32(groups))
    for g, w in zip(got, want):
        assert_equal(g, w)


def test_csr_expand_total_beyond_int32_raises():
    with pytest.raises(ValueError, match="exceeds int32"):
        npkit.csr_expand(torch.tensor([0, 2**31]), torch.tensor([0]))


# ---------------------------------------------------------------------------
# COLT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["colt", "slt", "simple"])
def test_colt_levels_match_reference(mode, rng):
    cols = {"x": rng.integers(0, 12, 300), "y": rng.integers(0, 9, 300),
            "z": rng.integers(0, 5, 300)}
    levels = [("x",), ("y", "z")]
    got = Colt(Relation("R", cols), levels, mode=mode, device=CPU)
    want = jcolt.Colt(JRelation("R", cols), levels, mode=mode)
    alive = np.array([0, 2, 3, 7, 8])  # a filtered force at depth 1 in colt mode
    for d in range(2):
        if d >= want.forced_depth:
            want.force(d, alive if d else None)
            got.force(d, t32(alive) if d else None)
        assert (got.forced_depth, got.num_groups(d + 1)) == (want.forced_depth,
                                                            want.num_groups(d + 1))
        g, w = got.levels[d], want.levels[d]
        assert_equal(g.parent, w.parent, "parent")
        for gk, wk in zip(g.keys, w.keys):
            assert_equal(gk, wk, "keys")
        assert_equal(g.koff, w.koff, "koff")
        assert_equal(got.leaf_rows, want.leaf_rows, "leaf_rows")
        assert_equal(got.leaf_offsets, want.leaf_offsets, "leaf_offsets")
        probe = rng.integers(0, 12, (2, 50))
        gids = rng.integers(0, want.num_groups(d), 50)
        assert_equal(g.table.probe([t32(gids)] + [t32(p) for p in probe[:len(g.keys)]]),
                     w.table.probe([gids] + list(probe[:len(w.keys)])), "probe")


def test_colt_rejects_keys_outside_int32():
    rels = {"R": Relation("R", {"x": np.array([1, 2**31]), "y": np.array([0, 1])}),
            "S": Relation("S", {"y": np.array([0, 1]), "z": np.array([3, 4])})}
    q = Query([Atom("R", ("x", "y")), Atom("S", ("y", "z"))])
    with pytest.raises(ValueError, match="outside int32"):
        free_join(q, rels, agg="count", device=CPU)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


def run_free_join(pkg_free_join, stats_cls, rels, q, tree, agg):
    stats = stats_cls()
    kw = {"device": CPU} if pkg_free_join is free_join else {}
    return pkg_free_join(q, rels, tree, agg=agg, stats=stats, **kw), stats


def run_reused_tries(pkg, case):
    """Two execute() calls sharing one Colt dict: (results, build_ns)."""
    if pkg == "port":
        q, rels, kw = case.q, case.rels, {"device": CPU}
        fj = factor(binary2fj(q.atoms, q))
        make = lambda a, lv: Colt(rels[a], lv, mode="colt", device=CPU)  # noqa: E731
        ex, stats_cls = execute, ExecStats
    else:
        q, rels, kw = case.jq, case.jrels, {}
        fj = J.factor(J.binary2fj(q.atoms, q))
        make = lambda a, lv: jcolt.Colt(rels[a], lv, mode="colt")  # noqa: E731
        ex, stats_cls = jengine.execute, jengine.ExecStats
    tries = {a: make(a, lv) for a, lv in fj.partitions().items()}
    stats, out = stats_cls(), []
    builds = []
    for _ in range(2):
        out.append(ex(fj, rels, agg="count", tries=tries, stats=stats, **kw))
        builds.append(stats.build_ns)
    return out, stats, builds


EXECUTE_CASES = {
    **{f"triangle_seed{s}": (lambda s=s: (triangle_case(s), None)) for s in range(5)},
    "clover_skew": lambda: (clover_case(), None),
    "bag_duplicates": lambda: (bag_case(), None),
    "bushy_plan": lambda: (bushy_case(np.random.default_rng(0)), None),
    "cross_product": lambda: (cross_case(), None),
    "empty_relation": lambda: (empty_case(), None),
    "self_join_aliases": lambda: (self_join_case(np.random.default_rng(0)), None),
    "factorized_count": lambda: (factorized_case(np.random.default_rng(0)), "count"),
    "reused_tries": lambda: (triangle_case(7), "reuse"),
}


@pytest.mark.parametrize("name", list(EXECUTE_CASES))
def test_execute_matches_reference(name):
    case, agg = EXECUTE_CASES[name]()
    if agg == "reuse":
        got, stats, builds = run_reused_tries("port", case)
        want, jstats, _ = run_reused_tries("reference", case)
        assert got == want and got[0] == got[1]
        assert builds[0] > 0, "the first call forced the probed levels"
        assert builds[1] - builds[0] < builds[0], "build_ns snapshots each call's forcing"
    else:
        tree, jtree = case.trees()
        got, stats = run_free_join(free_join, ExecStats, case.rels, case.q, tree, agg)
        want, jstats = run_free_join(J.free_join, jengine.ExecStats, case.jrels, case.jq, jtree,
                                     agg)
        if agg == "count":
            assert isinstance(got, int) and got == want
        else:
            (bound, mult), (jbound, jmult) = got, want
            assert set(bound) == set(jbound)
            for v in jbound:
                assert bound[v].dtype == np.int64
                assert_equal(bound[v], jbound[v], v)
            assert mult.dtype == np.int64
            assert_equal(mult, jmult, "mult")
    assert (stats.probes, stats.expansions, stats.max_frontier) == (
        jstats.probes, jstats.expansions, jstats.max_frontier)


def test_factorized_count_equals_materialized(rng):
    case = factorized_case(rng)
    bound, mult = free_join(case.q, case.rels, device=CPU)
    assert free_join(case.q, case.rels, agg="count", device=CPU) == int(mult.sum()) == \
        J.free_join(case.jq, case.jrels, agg="count")


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

PORT = {"free_join": free_join, "binary_join": binary_join, "generic_join": generic_join}


def assert_engine_matches(engine, case, tree=None, jtree=None):
    port, ref = PORT[engine], getattr(J, engine)
    args, jargs = ((tree,), (jtree,)) if tree is not None else ((), ())
    if engine == "generic_join" and tree is not None:
        args, jargs = (None, tree), (None, jtree)
    head = case.q.head
    assert to_sorted_tuples(port(case.q, case.rels, *args, device=CPU), head) == \
        J.to_sorted_tuples(ref(case.jq, case.jrels, *jargs), head)
    assert port(case.q, case.rels, *args, agg="count", device=CPU) == \
        ref(case.jq, case.jrels, *jargs, agg="count")


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("make", [lambda: triangle_case(11), clover_case, bag_case, empty_case,
                                  lambda: self_join_case(np.random.default_rng(3)),
                                  lambda: bushy_case(np.random.default_rng(4))],
                         ids=["triangle", "clover", "bag", "empty", "self_join", "bushy"])
def test_engines_match_reference(engine, make):
    case = make()
    tree, jtree = case.trees()
    assert_engine_matches(engine, case, tree, jtree)


@pytest.mark.parametrize("mode", ["colt", "slt", "simple"])
def test_free_join_modes_match_reference(mode):
    case = triangle_case(5)
    head = case.q.head
    assert to_sorted_tuples(free_join(case.q, case.rels, mode=mode, device=CPU), head) == \
        J.to_sorted_tuples(J.free_join(case.jq, case.jrels, mode=mode), head)


def test_optimizer_good_and_bad_plans_match_reference(rng):
    atoms = [("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")), ("D", ("w", "x"))]
    case = Case(atoms, rand_cols(rng, atoms, 50, 6))
    for bad in (False, True):
        tree = optimize(case.q, case.rels, bad=bad)
        jtree = J.optimize(case.jq, case.jrels, bad=bad)
        assert str(tree) == str(jtree)
        for engine in ("free_join", "binary_join"):
            assert_engine_matches(engine, case, tree, jtree)


@given(data=st.data())
@settings(max_examples=25, deadline=None)
def test_random_queries_match_reference(data):
    jq = data.draw(random_query())
    jrels = data.draw(instance(jq))
    case = Case([(a.alias, a.vars) for a in jq.atoms],
                {a: dict(r.columns) for a, r in jrels.items()})
    for engine in ENGINES:
        assert_engine_matches(engine, case)


def test_eager_filters_match_reference():
    case = triangle_case(2)
    for c in (1, 4):
        got = free_join(case.q, case.rels, agg="count", filters={"y": c}, device=CPU)
        assert got == J.free_join(case.jq, case.jrels, agg="count", filters={"y": c})


@pytest.mark.parametrize("batch_size", [1, 10, 1000])
def test_execute_tuples_matches_reference(batch_size):
    case = triangle_case(9)
    fj = factor(binary2fj(case.q.atoms, case.q))
    jfj = J.factor(J.binary2fj(case.jq.atoms, case.jq))
    got = execute_tuples(fj, case.rels, batch_size=batch_size, device=CPU)
    want = jexecute_tuples(jfj, case.jrels, batch_size=batch_size)
    assert sorted(got) == sorted(want)
    assert sorted(got) == to_sorted_tuples(free_join(case.q, case.rels, device=CPU),
                                           case.q.head)


def test_compiled_flag_forwards_and_checks_device():
    case = triangle_case(3)
    want = J.free_join(case.jq, case.jrels, agg="count")
    assert free_join(case.q, case.rels, agg="count", compiled=True, device=CPU) == want
    assert free_join(case.q, case.rels, agg="count", compiled=True, device=CPU,
                     options=ExecOptions(device=CPU)) == want
    with pytest.raises(ValueError, match="differs"):
        free_join(case.q, case.rels, compiled=True, options=ExecOptions(device=CPU))
    with pytest.raises(ValueError, match="eager-path"):
        free_join(case.q, case.rels, compiled=True, mode="slt", device=CPU)
    with pytest.raises(ValueError, match="compiled path only"):
        free_join(case.q, case.rels, options=ExecOptions(device=CPU), device=CPU)


def test_cross_product_linear_plan():
    case = cross_case()
    tree = linear(case.q.atoms)
    assert to_sorted_tuples(free_join(case.q, case.rels, tree, device=CPU), case.q.head) == \
        [(x, y) for x in range(4) for y in range(3)]


# ---------------------------------------------------------------------------
# chain_stages=False: the hybrid baseline
# ---------------------------------------------------------------------------


def three_stage_case(rng):
    """(((R0 R1)(R2 R3))(R4 R5)): two non-root stages + the root."""
    atoms = [(f"R{i}", (f"v{i}", f"v{i + 1}")) for i in range(6)]
    return Case(atoms, rand_cols(rng, atoms, 30, 12),
                tree=((("R0", "R1"), ("R2", "R3")), ("R4", "R5")))


@pytest.mark.parametrize("make", [lambda rng: Case(CHAIN4, rand_cols(rng, CHAIN4, 40, 8),
                                                   tree=(("A", "B"), ("C", "D"))),
                                  three_stage_case], ids=["two_stage", "three_stage"])
def test_hybrid_baseline_matches_reference(make, rng):
    case = make(rng)
    tree, jtree = case.trees()
    opts = ExecOptions(device=CPU, chain_stages=False)
    jopts = J.ExecOptions(impl="jnp", chain_stages=False)
    info = {}
    got = compiled_free_join(case.q, case.rels, tree, agg="count", options=opts, info=info)
    assert got == J.compiled_free_join(case.jq, case.jrels, jtree, agg="count", options=jopts)
    assert got == free_join(case.q, case.rels, tree, agg="count", device=CPU)
    assert len(info["runner"].stages) == 1, "only the root runs compiled"
    got = compiled_free_join(case.q, case.rels, tree, agg=None, options=opts)
    want = J.compiled_free_join(case.jq, case.jrels, jtree, agg=None, options=jopts)
    assert to_sorted_tuples(got, case.q.head) == J.to_sorted_tuples(want, case.jq.head)


def test_hybrid_baseline_rejects_filters(rng):
    case = Case(CHAIN4, rand_cols(rng, CHAIN4, 40, 8), tree=(("A", "B"), ("C", "D")))
    with pytest.raises(ValueError, match="chain_stages=True"):
        compiled_free_join(case.q, case.rels, case.trees()[0], agg="count", filters={"y": 1},
                           options=ExecOptions(device=CPU, chain_stages=False))


def test_eager_run_on_cpu_launches_no_kernel():
    """On CPU tensors every wrapper takes its plain version: a whole eager
    run counts no launch."""
    from repro_torch.kernels import compact, csr_expand, hash_probe, radix_sort

    mods = (hash_probe, csr_expand, compact, radix_sort)
    before = [m.launches for m in mods]
    case = triangle_case(4)
    free_join(case.q, case.rels, device=CPU)
    assert [m.launches for m in mods] == before
