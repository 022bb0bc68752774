"""The static plan verifier and the launch audit on the port, against the
reference's verifier.

Every scenario is written once over a package namespace (PORT / REF) and
run in both: the port with `device="cpu"` (every kernel's plain version),
the reference as its own tests run it on the CPU (impl="jnp"). Both
corpora draw the same relations from the same seed, so both planners see
the same data. Comparisons are exact:

* every corpus case's lint_chain + lint_template report, as equal
  (rule, severity, path) lists, and clean;
* every mutation of the reference's tests/test_analysis.py fires the same
  rule at the same path in both packages, and together they name every
  defect class;
* node_agm_bounds and plan_chain_capacities equal on every corpus case;
* recanonicalize is a fixed point; ExecOptions(verify=True) passes on a
  valid query and raises PlanVerificationError on a broken capacity plan;
  JoinOrderOptimizer(debug_lint=True) lints clean and raises
  enumerated-plan-invalid on a broken finalist;
* JoinServeEngine.submit rejects an unbound head var and an unknown
  filter var with equal admission counters, and serves on;
* count_query / make_count_fn on the reference's
  tests/test_compiled_distributed.py cases: counts and overflow flags;
* the launch audit (the port alone: the reference's audit reads jaxprs):
  each rule fires on its synthetic defect and on nothing else, and no rule
  but the small-uploads inventory fires on any corpus runner.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import repro.analysis as JA
import repro.analysis.corpus as jcorpus
import repro.core.capacity as jcapacity
import repro.core.optimizer as joptimizer
import repro.serve as JS
from repro.core import api as japi
from repro.core import compiled as jcompiled
from repro.core import plan as jplan
from repro.relational import schema as jschema
from repro.relational.relation import Relation as JRelation
from repro.serve import templates as jtemplates
from repro_torch import analysis as A
from repro_torch import serve as S
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import corpus, launch_audit
from repro_torch.core import api, capacity, compiled, optimizer, plan
from repro_torch.core.compiled import device_columns
from repro_torch.core.transfers import TRANSFERS
from repro_torch.kernels import ops
from repro_torch.relational import schema
from repro_torch.relational.relation import Relation
from repro_torch.serve import templates

CPU = api.ExecOptions(device="cpu")

# one namespace per package: a scenario written once runs on both
PORT = SimpleNamespace(
    name="port", A=A, corpus=corpus, capacity=capacity, optimizer=optimizer, plan=plan,
    compiled=compiled, schema=schema, Relation=Relation, templates=templates,
    options=lambda **kw: api.ExecOptions(device="cpu", **kw),
    compiled_free_join=api.compiled_free_join,
    engine=functools.partial(S.JoinServeEngine, options=CPU),
    count_query=functools.partial(compiled.count_query, device="cpu"),
    cols=functools.partial(compiled.relations_to_cols, device="cpu"),
    count_fn=compiled.make_count_fn,
)
REF = SimpleNamespace(
    name="reference", A=JA, corpus=jcorpus, capacity=jcapacity, optimizer=joptimizer,
    plan=jplan, compiled=jcompiled, schema=jschema, Relation=JRelation, templates=jtemplates,
    options=japi.ExecOptions, compiled_free_join=japi.compiled_free_join,
    engine=JS.JoinServeEngine, count_query=jcompiled.count_query,
    cols=jcompiled.relations_to_cols,
    count_fn=lambda fj, caps: jax.jit(jcompiled.make_count_fn(fj, caps)),
)
BOTH = (PORT, REF)
CASES = {P.name: {c.name: c for c in P.corpus.corpus_cases()} for P in BOTH}
NAMES = sorted(CASES["port"])


def triples(rep):
    """A report as comparable values: (rule, severity, path) in order."""
    return [(d.rule, int(d.severity), d.path) for d in rep]


def planned(P, case):
    """Fresh planner output for a corpus case, no execution: the stage
    chain and its ChainCapacityPlan as _acquire_runner derives them."""
    stats = P.optimizer.Stats(case.relations, cached=True)
    tree = P.optimizer.JoinOrderOptimizer().choose(case.query, case.relations, stats=stats)
    stages = P.plan.stage_plans(case.query, tree)
    return stages, P.capacity.plan_chain_capacities(stages, stats=stats)


def both(scenario):
    """Run scenario(P) in both packages; return (port, reference)."""
    return scenario(PORT), scenario(REF)


# ---------------------------------------------------------------------------
# the corpus: same plans, clean in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_corpus_lint_parity(name):
    def scenario(P):
        case = CASES[P.name][name]
        stages, chain = planned(P, case)
        rep = P.A.lint_chain(stages, chain, filter_vars=case.filter_vars, batch=case.batch)
        if case.filters:
            template, _ = P.templates.canonicalize(
                case.query, case.relations, case.filters, options=case.options
            )
            rep.extend(P.A.lint_template(template))
        return triples(rep), [(n, str(p)) for n, p in stages]

    (port, port_stages), (ref, ref_stages) = both(scenario)
    assert port_stages == ref_stages
    assert port == ref == []


@pytest.mark.parametrize("name", NAMES)
def test_node_agm_bounds_and_capacities_match(name):
    def scenario(P):
        case = CASES[P.name][name]
        stats = P.optimizer.Stats(case.relations, cached=True)
        stages, chain = planned(P, case)
        out = []
        for (_n, p), cp in zip(stages, chain.stages):
            bounds = None
            aliases = {sa.alias for node in p.nodes for sa in node}
            if aliases <= set(case.relations):  # a stage over base relations only
                sizes = {a: float(max(1, stats.size(a))) for a in aliases}
                bounds = P.capacity.node_agm_bounds(P.compiled._static_schedule(p), sizes)
                assert list(cp.agm) == bounds  # the planner's own walk
            out.append((bounds, cp.capacities, cp.compact_to, cp.compact_probe, cp.agm))
        return out

    port, ref = both(scenario)
    assert port == ref


# ---------------------------------------------------------------------------
# mutations: every injected defect class is named, at the same path
# ---------------------------------------------------------------------------


def m_unbound_probe_var(P):
    stages, _ = planned(P, CASES[P.name]["triangle"])
    p = stages[-1][1]
    nodes = [list(n) for n in p.nodes]
    for node in nodes:  # rename a probe subatom's var to one nothing binds
        if len(node) > 1 and node[1].vars:
            node[1] = P.plan.Subatom(node[1].alias, ("__never_bound",))
            break
    return P.A.lint_plan(P.plan.FreeJoinPlan(p.query, nodes))


def m_missing_cover(P):
    case = CASES[P.name]["triangle"]
    sub = P.plan.Subatom
    return P.A.lint_plan(P.plan.FreeJoinPlan(
        case.query, [[sub("R", ("x",))], [sub("S", ("y",)), sub("T", ("z",))]]
    ))


def m_unbound_head_var(P):
    q = CASES[P.name]["star"].query
    return P.A.lint_query(P.schema.Query(q.atoms, head=(*q.head, "__alien")))


def m_schedule_level_swap(P):
    stages, _ = planned(P, CASES[P.name]["triangle"])
    p = stages[-1][1]
    sched = P.compiled._static_schedule(p)
    alias = next(a for a, lo in sched.level_ops.items() if len(lo.levels) >= 2)
    lo = sched.level_ops[alias]
    bad = P.compiled.StaticSchedule(
        entries=sched.entries,
        level_ops={**sched.level_ops, alias: dataclasses.replace(lo, levels=lo.levels[::-1])},
    )
    return P.A.lint_schedule(p, bad)


def _root_cp(P, name="star"):
    stages, chain = planned(P, CASES[P.name][name])
    return stages[-1][1], chain.stages[-1]


def m_capacity_zero(P):
    p, cp = _root_cp(P)
    return P.A.lint_capacities(p, dataclasses.replace(cp, capacities=(0,) + cp.capacities[1:]))


def m_capacity_over_agm(P):
    p, cp = _root_cp(P)
    assert cp.agm, "the planner must record AGM bounds for this check to bite"
    return P.A.lint_capacities(
        p, dataclasses.replace(cp, capacities=(10**9,) + cp.capacities[1:])
    )


def m_compact_target_oversize(P):
    p, cp = _root_cp(P)
    ct = list(cp.compact_to)
    ct[0] = cp.capacities[0]  # "compacting" into a buffer the same size
    return P.A.lint_capacities(p, dataclasses.replace(cp, compact_to=tuple(ct)))


def m_stage_order_break(P):
    stages, _ = planned(P, CASES[P.name]["bushy"])
    assert len(stages) >= 2
    return P.A.lint_stage_dag([stages[-1], *stages[:-1]])


def m_stage_schema_mismatch(P):
    stages, _ = planned(P, CASES[P.name]["bushy"])
    name, root = stages[-1]
    names = {n for n, _ in stages}
    atoms, broke = [], False
    for a in root.query.atoms:
        if not broke and a.alias in names:
            atoms.append(P.schema.Atom(a.name, a.vars[:-1], a.alias))  # drop a column
            broke = True
        else:
            atoms.append(a)
    assert broke
    bad = P.plan.FreeJoinPlan(P.schema.Query(atoms), root.nodes)
    return P.A.lint_stage_dag([*stages[:-1], (name, bad)])


def m_filter_unbound(P):
    stages, chain = planned(P, CASES[P.name]["star"])
    return P.A.lint_chain(stages, chain, filter_vars=("__nope",))


def m_plan_tree_atoms(P):
    a, b, _c = CASES[P.name]["triangle"].query.atoms
    rep, stages = P.A.lint_tree(CASES[P.name]["triangle"].query, P.plan.BinaryPlan(a, b))
    assert stages is None
    return rep


MUTATIONS = {
    m_unbound_probe_var: {"unbound-probe-var", "plan-not-partitioning"},
    m_missing_cover: {"node-missing-cover"},
    m_unbound_head_var: {"unbound-head-var"},
    m_schedule_level_swap: {"schedule-level-mismatch"},
    m_capacity_zero: {"capacity-not-positive"},
    m_capacity_over_agm: {"capacity-over-agm"},
    m_compact_target_oversize: {"compact-target-oversize"},
    m_stage_order_break: {"stage-dag-order", "stage-root-last"},
    m_stage_schema_mismatch: {"stage-schema-mismatch"},
    m_filter_unbound: {"filter-unbound"},
    m_plan_tree_atoms: {"plan-tree-atoms"},
}


@pytest.mark.parametrize("mutation", list(MUTATIONS), ids=lambda m: m.__name__[2:])
def test_mutation_named_at_same_path(mutation):
    port, ref = both(mutation)
    assert triples(port) == triples(ref)
    assert MUTATIONS[mutation] <= port.rules()
    assert [d.message for d in port] == [d.message for d in ref]


def test_defect_class_coverage():
    """Together the mutations name every plan defect class of the
    catalogue that a planner regression can produce."""
    fired = set().union(*(m(PORT).rules() for m in MUTATIONS))
    assert fired >= set().union(*MUTATIONS.values())
    assert len(fired) >= 12


def test_report_surface():
    rep = A.Report()
    assert rep.ok and not rep
    rep.warning("w-rule", "p", "m")
    assert rep.ok and rep
    rep.error("e-rule", "p2", "m2")
    assert not rep.ok and rep.rules() == {"w-rule", "e-rule"}
    with pytest.raises(A.PlanVerificationError) as ei:
        rep.raise_errors()
    assert ei.value.report is rep and "e-rule" in str(ei.value)


# ---------------------------------------------------------------------------
# templates, verify=True, debug_lint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["star-filtered", "star-batched"])
def test_recanonicalize_is_a_fixed_point(name):
    def scenario(P):
        case = CASES[P.name][name]
        t, consts = P.templates.canonicalize(
            case.query, case.relations, case.filters, options=case.options
        )
        again, again_consts = P.templates.recanonicalize(t)
        assert again.key == t.key and again.filter_vars == t.filter_vars
        return t.key[:3], t.filter_vars, consts.tolist(), again_consts.tolist()

    port, ref = both(scenario)
    assert port == ref


def triangle_workload(P, seed=3, n=120, dom=12):
    rng = np.random.default_rng(seed)
    atoms = (("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x")))
    q = P.schema.Query([P.schema.Atom(a, vs) for a, vs in atoms])
    return q, {a: P.Relation(a, {v: rng.integers(0, dom, n) for v in vs}) for a, vs in atoms}


def test_verify_passes_on_valid_query():
    def scenario(P):
        q, rels = triangle_workload(P)
        plain = P.compiled_free_join(q, rels, options=P.options())
        verified = P.compiled_free_join(q, rels, options=P.options(verify=True))
        assert plain == verified
        return verified

    port, ref = both(scenario)
    assert port == ref


def test_verify_raises_on_broken_capacity_plan(monkeypatch):
    def scenario(P):
        real = P.capacity.plan_chain_capacities

        def broken(stages, **kw):
            chain = real(stages, **kw)
            cp = chain.stages[-1]
            bad = dataclasses.replace(cp, capacities=(0,) + cp.capacities[1:])
            return dataclasses.replace(chain, stages=chain.stages[:-1] + (bad,))

        monkeypatch.setattr(P.capacity, "plan_chain_capacities", broken)
        q, rels = triangle_workload(P, seed=4)
        with pytest.raises(P.A.PlanVerificationError) as ei:
            P.compiled_free_join(q, rels, options=P.options(verify=True))
        monkeypatch.undo()
        return triples(ei.value.report)

    port, ref = both(scenario)
    assert port == ref
    assert ("capacity-not-positive", 30, "stage[__root].cap[0]") in port


def fresh(P, rels):
    """The same columns under new relation objects: every cache misses."""
    return {a: P.Relation(r.name, dict(r.columns)) for a, r in rels.items()}


@pytest.mark.parametrize("name", NAMES)
def test_debug_lint_clean_on_corpus(name):
    def scenario(P):
        case = CASES[P.name][name]
        opt = P.optimizer.JoinOrderOptimizer(debug_lint=True)
        tree = opt.choose(case.query, fresh(P, case.relations))
        return str(tree)

    port, ref = both(scenario)
    assert port == ref


def test_debug_lint_counts_finalists():
    case = CASES["port"]["bushy"]
    opt = optimizer.JoinOrderOptimizer(debug_lint=True)
    opt.choose(case.query, fresh(PORT, case.relations))
    assert opt.linted >= 2 and opt.lint_s > 0


def test_debug_lint_names_an_invalid_finalist(monkeypatch):
    def scenario(P):
        case = CASES[P.name]["bushy"]
        real = P.optimizer.optimize

        def drops_an_atom(query, relations, *a, **kw):
            tree = real(query, relations, *a, **kw)
            return tree.left  # a tree over fewer atoms than the query has

        monkeypatch.setattr(P.optimizer, "optimize", drops_an_atom)
        with pytest.raises(P.A.PlanVerificationError) as ei:
            P.optimizer.JoinOrderOptimizer(debug_lint=True).choose(
                case.query, fresh(P, case.relations)
            )
        monkeypatch.undo()
        return triples(ei.value.report)

    port, ref = both(scenario)
    assert port == ref
    assert [r for r, _s, _p in port] == ["plan-tree-atoms", "enumerated-plan-invalid"]


# ---------------------------------------------------------------------------
# submit-time lint
# ---------------------------------------------------------------------------


def test_submit_rejects_invalid_queries_and_serves_on():
    def scenario(P):
        case = CASES[P.name]["star"]
        eng = P.engine(slots=2)
        bad_q = P.schema.Query(case.query.atoms, head=(*case.query.head, "__alien"))
        bad = eng.submit(bad_q, case.relations, {"y": 3}, tenant="t0")
        unknown = eng.submit(case.query, case.relations, {"__nope": 1}, tenant="t1")
        assert bad.done and isinstance(bad.error, P.A.PlanVerificationError)
        assert unknown.done and isinstance(unknown.error, ValueError)
        assert not eng.queue  # never enqueued: co-batched tenants are spared
        ok = eng.submit(case.query, case.relations, {"y": 3}, tenant="t0")
        eng.run()
        assert ok.done and ok.error is None
        return (
            triples(bad.error.report), type(unknown.error).__name__,
            eng.admission.rejected, dict(eng.admission.rejected_by),
            dict(eng.admission.rejected_reasons), int(ok.result),
        )

    port, ref = both(scenario)
    assert port == ref
    assert port[0] == [("unbound-head-var", 30, "query.head")] and port[2] == 2


# ---------------------------------------------------------------------------
# the count-only surface (the reference's test_compiled_distributed cases)
# ---------------------------------------------------------------------------


def rand_rels(P, q, rng, n, dom):
    return {a.alias: P.Relation(a.alias, {v: rng.integers(0, dom, n) for v in a.vars})
            for a in q.atoms}


def count_cases(P):
    out = []
    for seed in range(4):
        q = P.schema.triangle_query()
        rels = rand_rels(P, q, np.random.default_rng(seed), 40, 8)
        out.append((P.plan.factor(P.plan.binary2fj(q.atoms, q)), rels, [4096] * 4))
    q = P.schema.triangle_query()
    rels = rand_rels(P, q, np.random.default_rng(0), 40, 8)
    out.append((P.plan.gj_plan(q, ["x", "y", "z"]), rels, [4096] * 4))
    q = P.schema.clover_query()
    rels = rand_rels(P, q, np.random.default_rng(0), 60, 5)
    out.append((P.plan.factor(P.plan.binary2fj(q.atoms, q)), rels, [4] * 4))  # overflows
    rels = {
        "R": P.Relation("R", {"x": np.array([1, 1, 1]), "a": np.array([5, 5, 7])}),
        "S": P.Relation("S", {"x": np.array([1, 1]), "b": np.array([9, 9])}),
    }
    q = P.schema.Query([P.schema.Atom("R", ("x", "a")), P.schema.Atom("S", ("x", "b"))])
    out.append((P.plan.factor(P.plan.binary2fj(q.atoms, q)), rels, [64] * 3))
    return out


def test_count_query_matches_reference():
    def scenario(P):
        return [P.count_query(fj, rels, caps) for fj, rels, caps in count_cases(P)]

    port, ref = both(scenario)
    assert port == ref
    assert [ovf for _c, ovf in port] == [False] * 5 + [True, False]
    assert port[-1] == (6, False)
    assert all(isinstance(c, int) and isinstance(o, bool) for c, o in port)


def test_make_count_fn_matches_reference():
    """The function count_query wraps, called directly (the reference's
    under jax.jit, as its count_query runs it): one seed, the overflowing
    clover, the bag case."""
    def scenario(P):
        out = []
        for fj, rels, caps in [count_cases(P)[i] for i in (0, 5, 6)]:
            count, ovf = P.count_fn(fj, caps)(P.cols(fj, rels))
            out.append((int(count), bool(ovf)))
        return out

    port, ref = both(scenario)
    assert port == ref == [(port[0][0], False), (port[1][0], True), (6, False)]


# ---------------------------------------------------------------------------
# the launch audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_audit_silent_on_corpus_runner(name):
    case = CASES["port"][name]
    rep = cli.check_case(case, device="cpu")
    assert rep.rules() <= {"small-uploads"}, str(rep)
    assert ("small-uploads" in rep.rules()) == bool(case.filters)


def test_cli_gate_exits_zero_on_cpu(capsys):
    assert cli.main(["--device", "cpu"]) == 0
    assert "all corpus cases clean" in capsys.readouterr().out


class Defective:
    """A runner whose warm call does one extra thing after the real one."""

    def __init__(self, runner, extra):
        self._runner, self._extra = runner, extra

    def __getattr__(self, name):
        return getattr(self._runner, name)

    def run_relations(self, relations, **kw):
        out = self._runner.run_relations(relations, **kw)
        self._extra(self._runner, relations)
        return out


@pytest.fixture
def star_runner():
    runner, rels = corpus.build_runner(CASES["port"]["star"], device="cpu")
    runner.run_relations(rels)
    return runner, rels


def item_per_probe(runner, relations):
    for sched in runner.schedules:
        for _k, _c, probes in sched.entries:
            for _p in probes:
                torch.zeros((), dtype=torch.int32).item()


def scalar_write(runner, relations):
    flags = torch.zeros(4, dtype=torch.bool, device=runner.device)
    flags[0] = True  # a Python scalar copied from the host: a blocking upload on the card


def k1_budget_times(table, queries):
    def extra(runner, relations):
        for _ in range(runner.budget):  # one probe round a launch
            ops.probe(table, queries)
    return extra


def reupload_relation(big):
    def extra(runner, relations):
        device_columns(Relation("big", dict(big.columns)), runner.device)
    return extra


def test_audit_flags_each_synthetic_defect(star_runner):
    runner, rels = star_runner
    keys = torch.arange(64, dtype=torch.int32).reshape(-1, 1)
    table = ops.build_table(keys)
    big = Relation("big", {"x": np.arange(50_000)})
    want = {
        "item_per_probe": (item_per_probe, "host-sync", "star.syncs"),
        "scalar_write": (scalar_write, "host-sync", "star.syncs"),
        "k1_budget_times": (k1_budget_times(table, keys), "probe-loop-unrolled",
                            "star.launches[hash_probe]"),
        "reupload": (reupload_relation(big), "captured-buffer-upload", "star.upload[0]"),
    }
    for label, (extra, rule, path) in want.items():
        rep = launch_audit.audit_runner(Defective(runner, extra), rels, name="star")
        errors = [(d.rule, d.path) for d in rep.errors()]
        assert errors == [(rule, path)] * len(errors) and errors, (label, str(rep))
    clean = launch_audit.audit_runner(runner, rels, name="star")
    assert clean.ok and not clean.rules(), str(clean)


def test_audit_flags_a_warm_call_that_rebuilds(star_runner):
    runner, rels = star_runner
    rebuilt = Defective(runner, lambda r, relations: r.run_relations(fresh(PORT, relations)))
    rep = launch_audit.audit_runner(rebuilt, rels, name="star")
    assert ("captured-buffer-upload", "star.builds") in [(d.rule, d.path) for d in rep]


def test_audit_flags_ops_unrolled_into_straight_line(star_runner):
    runner, rels = star_runner
    keys = torch.arange(64, dtype=torch.int32).reshape(-1, 1)
    table = ops.build_table(keys)

    def unrolled(runner, relations):  # K1's probe rounds as straight-line tensor ops
        home = keys[:, 0] & (table.slots.shape[0] - runner.budget - 1)
        for sched in runner.schedules:
            for _k, _c, probes in sched.entries:
                for _p in probes:
                    for r in range(runner.budget):
                        cand = table.slots[home + r]
                        torch.where(cand >= 0, cand, -1)

    rep = launch_audit.audit_runner(Defective(runner, unrolled), rels, name="star")
    assert [(d.rule, d.path) for d in rep.errors()] == [("probe-loop-unrolled", "star.ops")]


def test_trace_counts_the_documented_crossings(star_runner):
    runner, rels = star_runner
    syncs = TRANSFERS.syncs
    trace = launch_audit.trace_runner(runner, rels)
    assert TRANSFERS.syncs - syncs == trace.syncs == runner.warm_read_backs == 2
    assert trace.sync_sites == ["read needs", "read count"]
    assert trace.kernel_calls["hash_probe"] == 2 and trace.launches["hash_probe"] == 0
    assert trace.builds == trace.compiles == 0 and trace.uploads == []
