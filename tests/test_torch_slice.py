"""The port's whole slice, `repro_torch.core.compiled_free_join` on the
CPU, against the reference `repro.core.compiled_free_join` (impl="jnp").

Both run on the same numpy relations. They must agree exactly on the
result, the chosen plan tree, the final capacity plan, and the adaptive
runner's retries, reshapes and executor builds; a warm repeat of the port
must build no trie.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.capacity import CapacityPlan as JCapacityPlan
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch.core import (
    TRIE_CACHE,
    AdaptiveExecutor,
    ExecOptions,
    binary2fj,
    compiled_free_join,
    factor,
    plan_capacities,
    to_sorted_tuples,
)
from repro_torch.core.capacity import CapacityPlan
from repro_torch.core.plan import BinaryPlan
from repro_torch.relational.datagen import lowsel_star
from repro_torch.relational.oracle import join_oracle
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query

CPU = ExecOptions(device="cpu")


class Case:
    """One workload, built twice from the same numpy columns: once for the
    reference package and once for the port."""

    def __init__(self, atoms, cols, tree=None):
        self.atoms = atoms  # [(alias, vars)]
        self.cols = cols  # {alias: {var: ndarray}}
        self.tree = tree  # nested pairs of aliases, or None (optimizer's choice)
        self.q = Query([Atom(a, vs) for a, vs in atoms])
        self.jq = JQuery([JAtom(a, vs) for a, vs in atoms])
        self.rels = {a: Relation(a, c) for a, c in cols.items()}
        self.jrels = {a: JRelation(a, c) for a, c in cols.items()}

    def trees(self):
        if self.tree is None:
            return None, None

        def build(node, plan_cls, atom_of):
            if isinstance(node, str):
                return atom_of(node)
            return plan_cls(build(node[0], plan_cls, atom_of), build(node[1], plan_cls, atom_of))

        return (
            build(self.tree, BinaryPlan, self.q.atom),
            build(self.tree, J.BinaryPlan, self.jq.atom),
        )


def rand_cols(rng, atoms, n, dom):
    return {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in atoms}


TRIANGLE = [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x"))]


def triangle(rng):
    return Case(TRIANGLE, rand_cols(rng, TRIANGLE, 60, 9))


def star_lowsel(rng):
    """The low-selectivity star: the S probe kills most lanes, so the plan
    compacts before the T probe."""
    q, rels = lowsel_star(n=20_000, dom=2_000, sel=0.05, seed=int(rng.integers(1 << 30)))
    return Case([(a.alias, a.vars) for a in q.atoms],
                {a: dict(r.columns) for a, r in rels.items()})


def bushy(rng):
    """((A ⋈ B) ⋈ (C ⋈ D)): one non-root stage chained into the root."""
    atoms = [("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")), ("D", ("w", "u"))]
    return Case(atoms, rand_cols(rng, atoms, 40, 8), tree=(("A", "B"), ("C", "D")))


def empty_relation(rng):
    cols = rand_cols(rng, TRIANGLE, 40, 8)
    cols["S"] = {"y": np.zeros(0, np.int64), "z": np.zeros(0, np.int64)}
    return Case(TRIANGLE, cols)


CASES = [triangle, star_lowsel, bushy, empty_relation]


def run_both(case, agg, **kw):
    tree, jtree = case.trees()
    jinfo, info = {}, {}
    want = J.compiled_free_join(case.jq, case.jrels, jtree, agg=agg, info=jinfo,
                                options=J.ExecOptions(impl="jnp", **kw))
    got = compiled_free_join(case.q, case.rels, tree, agg=agg, info=info,
                             options=ExecOptions(device="cpu", **kw))
    assert jax.default_backend() == "cpu"
    assert info["runner"].device == torch.device("cpu")
    return got, want, info, jinfo


def assert_same_run(case, agg, got, want, info, jinfo):
    if agg == "count":
        assert got == want
    else:
        head = case.q.head
        assert to_sorted_tuples(got, head) == J.to_sorted_tuples(want, head)
    assert str(info["plan_tree"]) == str(jinfo["plan_tree"])
    cp, jcp = info["cap_plan"], jinfo["cap_plan"]
    assert str(cp) == str(jcp)
    for mine, theirs in zip(getattr(cp, "stages", (cp,)), getattr(jcp, "stages", (jcp,))):
        assert mine.capacities == theirs.capacities
        assert mine.compact_to == theirs.compact_to
        assert mine.compact_probe == theirs.compact_probe
    assert info["retries"] == jinfo["retries"]
    assert info["reshapes"] == jinfo["runner"].reshapes
    assert info["compiles"] == jinfo["compiles"]


@pytest.mark.parametrize("make_case", CASES, ids=lambda f: f.__name__)
def test_slice_matches_reference(make_case, rng):
    case = make_case(rng)
    for agg in ("count", None):
        got, want, info, jinfo = run_both(case, agg)
        assert_same_run(case, agg, got, want, info, jinfo)
        # warm repeat: same answer, no trie build, no retry, no new executor
        builds = TRIE_CACHE.builds
        warm_info = {}
        again = compiled_free_join(case.q, case.rels, *case.trees()[:1], agg=agg,
                                   info=warm_info, options=CPU)
        assert TRIE_CACHE.builds == builds
        assert warm_info["runner"] is info["runner"]
        assert (warm_info["retries"], warm_info["compiles"]) == (info["retries"],
                                                                info["compiles"])
        if agg == "count":
            assert again == got
        else:
            assert to_sorted_tuples(again, case.q.head) == to_sorted_tuples(got, case.q.head)
    if make_case is star_lowsel:
        assert info["cap_plan"].compact_to[0] is not None, "the star must schedule compaction"
    if make_case is bushy:
        assert len(info["cap_plan"].stages) == 2
    if make_case is empty_relation:
        assert to_sorted_tuples(got, case.q.head) == []


@pytest.mark.parametrize("level", [0, 2])
def test_slice_other_optimize_levels(level, rng):
    case = Case([("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")), ("D", ("w", "x"))],
                rand_cols(rng, [("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")),
                                ("D", ("w", "x"))], 50, 7))
    got, want, info, jinfo = run_both(case, "count", optimize_level=level)
    assert_same_run(case, "count", got, want, info, jinfo)
    assert got == len(join_oracle(case.q, case.rels))


def test_slice_kill_mode_filters(rng):
    case = triangle(rng)
    jinfo, info = {}, {}
    for c in (3, 5):
        want = J.compiled_free_join(case.jq, case.jrels, agg="count", filters={"y": c},
                                    info=jinfo, options=J.ExecOptions(impl="jnp"))
        got = compiled_free_join(case.q, case.rels, agg="count", filters={"y": c},
                                 info=info, options=CPU)
        assert got == want
        assert str(info["cap_plan"]) == str(jinfo["cap_plan"])
    assert info["compiles"] == jinfo["compiles"], "one executor serves every constant"


def test_overflow_retry_from_undersized_plan(rng):
    case = triangle(rng)
    fj = factor(binary2fj(case.q.atoms, case.q))
    jfj = J.factor(J.binary2fj(case.jq.atoms, case.jq))
    n = len(plan_capacities(fj, case.rels).capacities)
    ex = AdaptiveExecutor(fj, CapacityPlan(capacities=(64,) * n, compact_to=(None,) * n),
                          device="cpu")
    jex = J.AdaptiveExecutor(jfj, JCapacityPlan(capacities=(64,) * n, compact_to=(None,) * n))
    assert ex.run_relations(case.rels) == jex.run_relations(case.jrels)
    assert ex.retries == jex.retries > 0
    assert ex.cap_plan.capacities == jex.cap_plan.capacities
    compiles = ex.compiles
    assert ex.run_relations(case.rels) == jex.run_relations(case.jrels)
    assert (ex.retries, ex.compiles) == (jex.retries, compiles)


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        ExecOptions(verify=True)
