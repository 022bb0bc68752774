"""Batched multi-tenant serving on the port against the reference.

Every case runs in both packages on the same seeded numpy data: the port
with `ExecOptions(device="cpu")` (every kernel's plain version), the
reference as its own tests run it on the CPU (impl="jnp"). All outputs are
integers, so every comparison is exact:

* the mask-mode executor (`make_executor(filter_kill=False)` over a (B, F)
  constants matrix) against the reference's executor under `jax.vmap`:
  per-lane counts, agg=None materializations and the (B, n) need vectors;
* a bushy chain whose filter falls in a non-root stage (the per-lane
  path), batched, against the reference's vmapped chain;
* `AdaptiveExecutor(batch=...)`: results, retries, reshapes, builds, the
  final capacity plan, and the lane a CapacityQuotaError names;
* `JoinServeEngine` on the reference's serving cases: each request's
  result, error type and reason, `degraded_to`, and the engine's and the
  admission controller's counters;
* seeded lanes (`SeededExecutor`, the port's point-query runner, which
  the reference lacks) against the reference's vmapped mask-mode
  executor and the eager oracle, the engine's choice between seeded
  lanes and mask mode, and a seeded dispatch's lanes against the
  relation's size.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.serve as JS
from repro.core import compiled as jcompiled
from repro.core import faults as jfaults
from repro.core import membudget as jmembudget
from repro.core import relcache as jrelcache
from repro.core.capacity import CapacityPlan as JCapacityPlan
from repro.core.capacity import plan_capacities as jplan_capacities
from repro.core.capacity import plan_chain_capacities as jplan_chain_capacities
from repro.core.optimizer import Stats as JStats
from repro.core.plan import BinaryPlan as JBinaryPlan
from repro.core.plan import stage_plans as jstage_plans
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch import serve as S
from repro_torch.core import (
    ExecOptions,
    compiled_free_join,
    faults,
    free_join,
    membudget,
    relcache,
    to_sorted_tuples,
)
from repro_torch.core import api, compiled
from repro_torch.core.capacity import CapacityPlan, plan_capacities
from repro_torch.core.capacity import plan_chain_capacities
from repro_torch.core.optimizer import Stats
from repro_torch.core.plan import (
    BinaryPlan,
    binary2fj,
    factor,
    linear,
    seed_plan,
    stage_plans,
)
from repro_torch.core.trace import TRACE
from repro_torch.core.transfers import TRANSFERS
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query

CPU = ExecOptions(device="cpu")

# one namespace per package: a scenario written once runs on both
PORT = SimpleNamespace(
    name="port", Atom=Atom, Query=Query, Relation=Relation, BinaryPlan=BinaryPlan,
    engine=functools.partial(S.JoinServeEngine, options=CPU),
    standing=functools.partial(S.StandingQueryEngine, options=CPU),
    AdmissionController=S.AdmissionController, AdmissionError=S.AdmissionError,
    QueryQuota=S.QueryQuota, KeyedCache=relcache.KeyedCache, relcache=relcache,
    faults=faults, membudget=membudget,
    free_join=functools.partial(free_join, device="cpu"),
    compiled_free_join=functools.partial(compiled_free_join, options=CPU),
    to_sorted_tuples=to_sorted_tuples,
)
REF = SimpleNamespace(
    name="reference", Atom=JAtom, Query=JQuery, Relation=JRelation, BinaryPlan=JBinaryPlan,
    engine=JS.JoinServeEngine, standing=JS.StandingQueryEngine,
    AdmissionController=JS.AdmissionController, AdmissionError=JS.AdmissionError,
    QueryQuota=JS.QueryQuota, KeyedCache=jrelcache.KeyedCache, relcache=jrelcache,
    faults=jfaults, membudget=jmembudget,
    free_join=J.free_join, compiled_free_join=J.compiled_free_join,
    to_sorted_tuples=J.to_sorted_tuples,
)

TRIANGLE = (("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x")))
CHAIN4 = (("R", ("a", "b")), ("S", ("b", "c")), ("T", ("c", "d")), ("U", ("d", "e")))


def workload(P, atoms=TRIANGLE, seed=0, n=300, dom=6):
    """The same relations in package P: columns drawn from the seed."""
    rng = np.random.default_rng(seed)
    q = P.Query([P.Atom(a, vs) for a, vs in atoms])
    rels = {a: P.Relation(a, {v: rng.integers(0, dom, n) for v in vs}) for a, vs in atoms}
    return q, rels


def respell(P, q, rels, tag, order=None):
    """The same query as tenant `tag` would write it: its own alias names,
    its own atom order, over the same base relations."""
    atoms = [P.Atom(a.name, a.vars, f"{tag}_{a.alias}") for a in q.atoms]
    if order is not None:
        atoms = [atoms[i] for i in order]
    return P.Query(atoms), {f"{tag}_{a.alias}": rels[a.alias] for a in q.atoms}


def oracle(P, q, rels, filters=None, agg="count"):
    return P.free_join(q, rels, agg=agg, filters=filters)


def norm(P, q, result):
    """A result as comparable host values: an int, or sorted tuples."""
    if result is None or isinstance(result, (int, np.integer)):
        return None if result is None else int(result)
    return P.to_sorted_tuples(result, q.head)


def record(P, q, reqs, eng):
    """What must agree between the packages: every request's outcome and
    the engine's and the admission controller's counters."""
    return {
        "requests": [
            (norm(P, q, r.result), r.done, type(r.error).__name__ if r.error else None,
             getattr(r.error, "reason", None), r.degraded_to)
            for r in reqs
        ],
        "engine": {k: getattr(eng, k) for k in
                   ("dispatches", "served", "degraded", "faults_absorbed",
                    "deadline_rejected")},
        "admission": {k: getattr(eng.admission, k) for k in
                      ("admitted", "rejected", "rejected_by", "rejected_reasons")},
    }


def assert_same(scenario, **kw):
    got, want = scenario(PORT, **kw), scenario(REF, **kw)
    assert got == want
    return got


# ---- the mask-mode executor against the reference's vmapped executor -----


def _executor_pair(rng, compact, n=300, dom=10):
    cols = {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in TRIANGLE}
    q, jq = (P.Query([P.Atom(a, vs) for a, vs in TRIANGLE]) for P in (PORT, REF))
    jfj = J.factor(J.binary2fj(jq.atoms, jq))
    fj = factor(binary2fj(q.atoms, q))
    assert str(fj) == str(jfj)
    rels = {a: Relation(a, c) for a, c in cols.items()}
    jrels = {a: JRelation(a, c) for a, c in cols.items()}
    cp = plan_capacities(fj, rels, block=128)
    jcp = jplan_capacities(jfj, jrels, block=128)
    assert str(cp) == str(jcp)
    # buffers that hold the unfiltered frontier (the planner's estimate may
    # not: the adaptive runner would grow it), optionally with a forced
    # squeeze after the first node, so the filter mask must ride along
    caps = tuple(1 << 14 for _ in cp.capacities)
    ct = ((1 << 12,) if compact else (None,)) + (None,) * (len(caps) - 1)
    cp = CapacityPlan(caps, ct, cp.compact_probe, block=128)
    jcp = JCapacityPlan(caps, ct, jcp.compact_probe, block=128)
    data = {a: {v: torch.as_tensor(c, dtype=torch.int32) for v, c in cs.items()}
            for a, cs in cols.items()}
    jdata = {a: {v: jnp.asarray(c, jnp.int32) for v, c in cs.items()} for a, cs in cols.items()}
    return fj, jfj, cp, jcp, data, jdata


def lane_rows(bound, valid, mult, b=None):
    """Lane b's live rows (of 1-D outputs if b is None) as sorted
    (values..., mult) tuples."""
    pick = (lambda t: np.asarray(t)) if b is None else (lambda t: np.asarray(t[b]))
    v = pick(valid)
    cols = [pick(bound[k])[v] for k in sorted(bound)] + [pick(mult)[v]]
    return sorted(zip(*(c.tolist() for c in cols)))


@pytest.mark.parametrize("agg", ["count", None])
@pytest.mark.parametrize("filter_vars,compact", [(("x",), False), (("y",), True),
                                                 (("z", "x"), False)])
def test_mask_executor_matches_vmapped_reference(agg, filter_vars, compact, rng):
    fj, jfj, cp, jcp, data, jdata = _executor_pair(rng, compact)
    consts = np.stack([rng.integers(0, 11, 6) for _ in filter_vars], axis=1).astype(np.int32)
    filters = tuple((v, i) for i, v in enumerate(filter_vars))
    jfn = jcompiled.make_executor(jfj, jcp.capacities, compact_to=jcp.compact_to,
                                  compact_probe=jcp.compact_probe, agg=agg,
                                  filters=filters, filter_kill=False)
    want = jax.device_get(jax.jit(jax.vmap(lambda c: jfn(jdata, None, c)))(jnp.asarray(consts)))
    fn = compiled.make_executor(fj, cp.capacities, compact_to=cp.compact_to,
                                compact_probe=cp.compact_probe, agg=agg,
                                filters=filters, filter_kill=False)
    got = fn(data, None, torch.as_tensor(consts))
    for g, w, name in ((got[-2], want[-2], "need_expand"), (got[-1], want[-1], "need_compact")):
        assert g.shape == (len(consts), len(cp.capacities))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert (got[-2].numpy() <= np.asarray(cp.capacities)).all(), "no node overflowed"
    if compact:
        assert 0 < int(got[-1][0, 0]) <= cp.compact_to[0], "the squeeze ran and fit"
    if agg == "count":
        assert got[0].dtype == torch.int64 and got[0].shape == (len(consts),)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        for b in range(len(consts)):
            assert lane_rows(got[0], got[1], got[2], b) == lane_rows(*want[:3], b)
    # each lane equals the kill-mode executor on that lane's constants
    kill = compiled.make_executor(fj, cp.capacities, compact_to=cp.compact_to,
                                  compact_probe=cp.compact_probe, agg=agg, filters=filters)
    for b in (0, len(consts) - 1):
        one = kill(data, None, torch.as_tensor(consts[b]))
        if agg == "count":
            assert int(one[0]) == int(got[0][b])
        else:
            assert lane_rows(*one[:3]) == lane_rows(got[0], got[1], got[2], b)


def _chain_pair(rng, n=400, dom=12):
    cols = {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in CHAIN4}
    out = []
    for P, plans, chain_caps, stats in ((PORT, stage_plans, plan_chain_capacities, Stats),
                                        (REF, jstage_plans, jplan_chain_capacities, JStats)):
        q = P.Query([P.Atom(a, vs) for a, vs in CHAIN4])
        at = {a.alias: a for a in q.atoms}
        tree = P.BinaryPlan(P.BinaryPlan(at["R"], at["S"]), P.BinaryPlan(at["T"], at["U"]))
        rels = {a: P.Relation(a, c) for a, c in cols.items()}
        stages = plans(q, tree)
        out.append((q, tree, rels, stages, chain_caps(stages, stats=stats(rels))))
    assert str(out[0][4]) == str(out[1][4])
    return cols, out


@pytest.mark.parametrize("filter_vars,agg", [(("e",), None), (("a", "e"), "count")])
def test_chain_filter_in_non_root_stage_matches_vmapped_reference(filter_vars, agg, rng):
    """`e` is bound only in the T⋈U stage: from its output on, every lane
    has its own stage buffer (the per-lane path)."""
    cols, ((q, _t, _r, stages, chain), (jq, _jt, _jr, jstages, jchain)) = _chain_pair(rng)
    names = [name for name, _ in stages]
    assert len(stages) == 2 and "e" in stages[0][1].query.variables, \
        "e is first bound in the non-root stage"
    consts = np.stack([rng.integers(0, 13, 5) for _ in filter_vars], axis=1).astype(np.int32)
    jrun = jcompiled.make_chain_executor(jstages, jchain.stages, agg=agg,
                                         filter_vars=filter_vars, filter_kill=False)
    jdata = {a: {v: jnp.asarray(c, jnp.int32) for v, c in cs.items()} for a, cs in cols.items()}
    want = jax.device_get(jax.jit(jax.vmap(jrun, in_axes=(None, 0)))(jdata, jnp.asarray(consts)))
    run = compiled.make_chain_executor(stages, chain.stages, agg=agg,
                                       filter_vars=filter_vars, filter_kill=False)
    data = {a: {v: torch.as_tensor(c, dtype=torch.int32) for v, c in cs.items()}
            for a, cs in cols.items()}
    got = run(data, torch.as_tensor(consts))
    for s, name in enumerate(names):
        for g, w in ((got[-2][s], want[-2][s]), (got[-1][s], want[-1][s])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if agg == "count":
        assert len(set(got[0].tolist())) > 1, "the lanes' counts must differ"
    else:  # the root expands the stage's per-lane buffer: its needs differ
        per_lane = np.asarray(want[-2][-1])
        assert (per_lane != per_lane[:1]).any()
    if agg == "count":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    else:
        for b in range(len(consts)):
            assert lane_rows(got[0], got[1], got[2], b) == lane_rows(*want[:3], b)


# ---- the batched adaptive runner ------------------------------------------


def _runner_pair(P, atoms, caps, tree=None, **kw):
    """An AdaptiveExecutor of package P over `atoms`, with capacities
    caps(planned per-stage capacity tuples) instead of the planner's."""
    q, rels = workload(P, atoms, seed=5, n=400, dom=12)
    at = {a.alias: a for a in q.atoms}
    if tree is None:
        fj = (factor if P is PORT else J.factor)(
            (binary2fj if P is PORT else J.binary2fj)(q.atoms, q))
        planned = (plan_capacities if P is PORT else jplan_capacities)(fj, rels)
        (c,) = caps([planned.capacities])
        plan, cap = fj, planned.__class__(capacities=c, compact_to=(None,) * len(c))
    else:
        stages = (stage_plans if P is PORT else jstage_plans)(q, tree(P, at))
        chain = (plan_chain_capacities if P is PORT else jplan_chain_capacities)(
            stages, stats=(Stats if P is PORT else JStats)(rels))
        plan = tuple(stages)
        cap = chain.__class__(chain.names, tuple(
            s.__class__(capacities=c, compact_to=(None,) * len(c)) for s, c in
            zip(chain.stages, caps([s.capacities for s in chain.stages]))))
    if P is PORT:
        return compiled.AdaptiveExecutor(plan, cap, device="cpu", **kw), rels
    return J.AdaptiveExecutor(plan, cap, **kw), rels


def undersized(planned):
    return [(64,) * len(c) for c in planned]


def _runner_state(ex):
    cp = ex.cap_plan
    return (ex.retries, ex.reshapes, ex.compiles, ex.calls,
            [(s.capacities, s.compact_to) for s in getattr(cp, "stages", (cp,))])


@pytest.mark.parametrize("agg", ["count", None])
def test_batched_runner_matches_reference(agg):
    consts = np.array([[0], [3], [5], [11]], np.int32)
    out = []
    for P in (PORT, REF):
        ex, rels = _runner_pair(P, TRIANGLE, undersized, agg=agg, tighten=True,
                                filter_vars=("x",), batch=4)
        first = ex.run_relations(rels, filter_consts=consts)
        state = _runner_state(ex)
        again = ex.run_relations(rels, filter_consts=consts[::-1].copy())
        if agg == "count":
            first, again = first.tolist(), again.tolist()
            assert first == [oracle(P, *workload(P, TRIANGLE, 5, 400, 12), {"x": int(c)})
                             for c in consts[:, 0]]
        else:
            head = ex.plan.query.head
            first = [P.to_sorted_tuples(r, head) for r in first]
            again = [P.to_sorted_tuples(r, head) for r in again]
        out.append((first, again, state, _runner_state(ex)))
    assert out[0] == out[1]
    assert out[0][2][0] > 0, "the undersized plan must have grown"
    assert out[0][2][0] == out[0][3][0], "the grown plan serves the next batch"


def test_batched_runner_needs_filters():
    with pytest.raises(ValueError, match="constant vector"):
        _runner_pair(PORT, TRIANGLE, undersized, batch=4)


def _bushy(P, at):
    return P.BinaryPlan(P.BinaryPlan(at["R"], at["S"]), P.BinaryPlan(at["T"], at["U"]))


def last_node_tight(planned):
    """Room for everything but the root's last node, which gets 128."""
    caps = [(1 << 14,) * len(c) for c in planned]
    caps[-1] = caps[-1][:-1] + (128,)
    return caps


@pytest.mark.parametrize("batch", [None, 5])
def test_capacity_quota_names_the_same_lane(batch):
    """A need past max_capacity raises instead of growing: the same stage,
    node, need and (batched) lane as the reference's. The node is the
    4-chain root's expansion of the T⋈U stage's buffer, whose need differs
    by lane, so argmax picks a lane of the data."""
    consts = np.array([[1], [7], [2], [9], [4]], np.int32)
    errs = []
    for P in (PORT, REF):
        ex, rels = _runner_pair(P, CHAIN4, last_node_tight, tree=_bushy, agg=None,
                                filter_vars=("e",), batch=batch, max_capacity=128)
        fc = consts if batch else consts[1]
        with pytest.raises(Exception) as ei:
            ex.run_relations(rels, filter_consts=fc)
        e = ei.value
        assert type(e).__name__ == "CapacityQuotaError"
        errs.append((e.stage, e.node, e.need, e.cap, e.lane, ex.retries))
    assert errs[0] == errs[1]
    assert (errs[0][4] is None) == (batch is None)
    assert errs[0][:2] == (1, 2)


def test_batched_chain_runner_matches_reference():
    consts = np.array([[1], [7], [2], [9]], np.int32)
    out = []
    for P in (PORT, REF):
        ex, rels = _runner_pair(P, CHAIN4, undersized, tree=_bushy,
                                filter_vars=("e",), batch=4, tighten=True)
        counts = ex.run_relations(rels, filter_consts=consts).tolist()
        q = P.Query([P.Atom(a, vs) for a, vs in CHAIN4])
        assert counts == [oracle(P, q, rels, {"e": int(c)}) for c in consts[:, 0]]
        out.append((counts, _runner_state(ex)))
    assert out[0] == out[1]


# ---- JoinServeEngine on the reference's serving cases --------------------


def _cached_runners(kc):
    return [v[0] for v in kc._data.values()]


def seeded(runner):
    """Does this (port or reference) runner take seeded lanes?"""
    return type(runner).__name__ == "SeededExecutor"


def two_spellings_one_runner(P):
    q, rels = workload(P)
    kc = P.KeyedCache()
    eng = P.engine(slots=1, cache=kc)
    qa, ra = respell(P, q, rels, "a")
    qb, rb = respell(P, q, rels, "b", order=[1, 2, 0])
    r0 = eng.submit(qa, ra, {"x": 2}, tenant="a")
    r1 = eng.submit(qb, rb, {"x": 4}, tenant="b")
    eng.step()
    cold = (kc.misses, kc.hits)
    (runner,) = _cached_runners(kc)
    compiles = runner.compiles
    eng.step()
    assert runner.compiles == compiles
    for req, c in ((r0, 2), (r1, 4)):
        assert req.result == oracle(P, q, rels, {"x": c})
    return record(P, q, [r0, r1], eng), cold, (kc.misses, kc.hits), compiles


def batched_counts(P):
    q, rels = workload(P)
    consts = [0, 1, 2, 3, 4, 5, 0, 3]
    eng = P.engine(slots=4)
    reqs = [eng.submit(*respell(P, q, rels, f"t{i}"), {"x": c}, tenant=f"t{i}")
            for i, c in enumerate(consts)]
    eng.run()
    assert eng.dispatches == 2
    assert [r.result for r in reqs] == [oracle(P, q, rels, {"x": c}) for c in consts]
    return record(P, q, reqs, eng)


def batched_full_results(P):
    q, rels = workload(P, n=150, dom=5)
    consts = [0, 1, 2]
    eng = P.engine(slots=4)
    reqs = [eng.submit(*respell(P, q, rels, f"t{i}"), {"x": c}, tenant=f"t{i}", agg=None)
            for i, c in enumerate(consts)]
    eng.run()
    for req, c in zip(reqs, consts):
        assert norm(P, q, req.result) == norm(P, q, oracle(P, q, rels, {"x": c}, agg=None))
    return record(P, q, reqs, eng)


def filterless_group(P):
    q, rels = workload(P)
    eng = P.engine(slots=4)
    reqs = [eng.submit(*respell(P, q, rels, f"t{i}"), tenant=f"t{i}") for i in range(4)]
    eng.run()
    assert eng.dispatches == 1
    assert [r.result for r in reqs] == [oracle(P, q, rels)] * 4
    return record(P, q, reqs, eng)


def distinct_templates(P):
    q, rels = workload(P)
    eng = P.engine(slots=8)
    ra = eng.submit(*respell(P, q, rels, "a"), {"x": 1})
    rb = eng.submit(*respell(P, q, rels, "b"), {"y": 1})
    retired = eng.step()
    assert retired == [ra] and not rb.done
    eng.run()
    assert rb.result == oracle(P, q, rels, {"y": 1})
    return record(P, q, [ra, rb], eng)


def plan_cells_rejection(P):
    q, rels = workload(P)
    adm = P.AdmissionController(per_tenant={"small": P.QueryQuota(max_plan_cells=1)})
    kc = P.KeyedCache()
    eng = P.engine(slots=4, admission=adm, cache=kc)
    reqs = [eng.submit(*respell(P, q, rels, t), {"x": c}, tenant=ten)
            for t, c, ten in (("a", 1, "a"), ("s", 2, "small"), ("b", 3, "b"))]
    eng.run()
    assert isinstance(reqs[1].error, P.AdmissionError)
    (runner,) = _cached_runners(kc)
    compiles, dispatches = runner.compiles, eng.dispatches
    reqs.append(eng.submit(*respell(P, q, rels, "s2"), {"x": 4}, tenant="small"))
    eng.run()
    assert (runner.compiles, eng.dispatches) == (compiles, dispatches)
    assert [reqs[0].result, reqs[2].result] == [oracle(P, q, rels, {"x": c}) for c in (1, 3)]
    return record(P, q, reqs, eng)


def admission_counters(P):
    adm = P.AdmissionController(default=P.QueryQuota(max_plan_cells=100),
                                per_tenant={"vip": P.QueryQuota()})
    adm.check_plan("vip", 10**9)
    with pytest.raises(P.AdmissionError) as ei:
        adm.check_plan("anon", 101)
    adm.check_plan("anon", 100)
    adm2 = P.AdmissionController(per_tenant={"t": P.QueryQuota(max_dispatch_us=50.0)})
    adm2.check_cost("t", None)
    adm2.check_cost("t", 50.0)
    with pytest.raises(P.AdmissionError) as ei2:
        adm2.check_cost("t", 50.1)
    return [(e.value.tenant, e.value.reason) for e in (ei, ei2)], [
        (a.admitted, a.rejected, a.rejected_by, a.rejected_reasons) for a in (adm, adm2)]


def round_robin(P):
    q, rels = workload(P)
    eng = P.engine(slots=2)
    qa, ra = respell(P, q, rels, "a")
    qb, rb = respell(P, q, rels, "b")
    a_reqs = [eng.submit(qa, ra, {"x": i}, tenant="a") for i in range(6)]
    r_b = eng.submit(qb, rb, {"y": 1}, tenant="b")
    eng.step()
    assert not r_b.done and sum(r.done for r in a_reqs) == 2
    a_reqs.append(eng.submit(qa, ra, {"x": 6}, tenant="a"))
    eng.step()
    assert r_b.done and r_b.result == oracle(P, q, rels, {"y": 1})
    eng.run()
    assert [r.result for r in a_reqs] == [oracle(P, q, rels, {"x": i}) for i in range(7)]
    return record(P, q, a_reqs + [r_b], eng)


def measured_cost_admission(P):
    q, rels = workload(P)
    adm = P.AdmissionController(per_tenant={"cheap": P.QueryQuota(max_dispatch_us=0.001)})
    kc = P.KeyedCache()
    eng = P.engine(slots=4, admission=adm, cache=kc)
    qa, ra = respell(P, q, rels, "a")
    r0 = eng.submit(qa, ra, {"x": 1}, tenant="cheap")
    eng.run()
    (t_key,) = eng.cost_ema_us
    assert eng.cost_ema_us[t_key] > 0
    (runner,) = _cached_runners(kc)
    compiles, calls = runner.compiles, runner.calls
    r1 = eng.submit(qa, ra, {"x": 2}, tenant="cheap")
    r2 = eng.submit(qa, ra, {"x": 3}, tenant="vip")
    eng.run()
    # the cost-rejected request reaches no runner: one call, r2's
    assert runner.calls == calls + 1
    if not seeded(runner):
        # mask mode's layout does not depend on the constants: no new
        # executor either
        assert runner.compiles == compiles
    else:
        # a seeded runner may grow once, to r2's larger selection
        assert runner.compiles <= compiles + 1
    assert [r0.result, r2.result] == [oracle(P, q, rels, {"x": c}) for c in (1, 3)]
    return record(P, q, [r0, r1, r2], eng)


def chain_filter_on_non_root_stage(P):
    """The stage replay's 4-chain shape as a batched template whose filter
    var `e` is bound only in the T⋈U stage (the per-lane path)."""
    q, rels = workload(P, CHAIN4, seed=3, n=300, dom=10)
    tree = _bushy(P, {a.alias: a for a in q.atoms})
    consts = [0, 4, 9, 4, 2]
    eng = P.engine(slots=4)
    reqs = [eng.submit(q, rels, {"e": c}, plan_tree=tree, tenant=f"t{i % 2}")
            for i, c in enumerate(consts)]
    eng.run()
    assert [r.result for r in reqs] == [oracle(P, q, rels, {"e": c}) for c in consts]
    return record(P, q, reqs, eng)


SERVING = [two_spellings_one_runner, batched_counts, batched_full_results, filterless_group,
           distinct_templates, plan_cells_rejection, admission_counters, round_robin,
           measured_cost_admission, chain_filter_on_non_root_stage]


@pytest.mark.parametrize("scenario", SERVING, ids=lambda f: f.__name__)
def test_serving_matches_reference(scenario):
    assert_same(scenario)


def test_invalid_submission_is_rejected_not_raised():
    q, rels = workload(PORT)
    eng = PORT.engine(slots=2)
    req = eng.submit(q, rels, {"nope": 1}, tenant="t")
    assert req.done and isinstance(req.error, ValueError) and req.template is None
    assert eng.admission.rejected_reasons == {"invalid": 1} and not eng.queue


def test_standing_engine_shares_the_serving_options():
    eng = S.JoinServeEngine(options=CPU)
    st = S.StandingQueryEngine(engine=eng)
    assert st.options is eng.options
    q, rels = workload(PORT)
    sq = st.register(q, rels, {"x": 2})
    assert sq.result == oracle(PORT, q, rels, {"x": 2})
    req = eng.submit(q, rels, {"x": 2})
    eng.run()
    assert req.result == sq.result and req.template.key == sq.template.key


def _first_bound_var(runner):
    """The variable the plan binds first: filtering on it keeps the
    mask-mode schedule identical to the unfiltered one (no var loses the
    factorized-count shortcut)."""
    return runner.schedule.entries[0][1].vars[0]


def test_mask_path_runs_the_probe_pipeline_once(monkeypatch):
    """One batched dispatch of 8 lanes makes as many expansions, probes
    and compactions as one unfiltered query, and its lanes equal 8
    kill-mode queries."""
    from repro_torch.core import api
    from repro_torch.kernels import ops

    q, rels = workload(PORT, seed=4, n=2000, dom=40)
    calls = {}
    for name in ("expand_counted", "probe", "compact_indices"):
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(ops, name, counted)

    def warm_calls(fn):
        fn()  # cold: builds, growth, tightening
        calls.clear()
        out = fn()
        return out, dict(calls)

    plain, _rels, _c, _t = api._acquire_runner(q, rels, None, agg="count", options=CPU)
    want_total, plain_calls = warm_calls(lambda: plain.run_relations(rels))
    var = _first_bound_var(plain)
    consts = np.arange(8, dtype=np.int32)[:, None] * 5
    batched, _rels, _c, _t = api._acquire_runner(q, rels, None, agg="count", options=CPU,
                                                 filter_vars=(var,), batch=8)
    got, batched_calls = warm_calls(lambda: batched.run_relations(rels, filter_consts=consts))
    assert batched_calls == plain_calls and plain_calls["expand_counted"] > 0
    assert got.tolist() == [compiled_free_join(q, rels, filters={var: int(c)}, options=CPU)
                            for c in consts[:, 0]]
    assert sum(got) <= want_total


# ---- seeded lanes: the served point query's runner ------------------------

PATH2 = (("R", ("x", "y")), ("S", ("y", "z")))


def bag_rows(cols, mult):
    """Rows as a sorted list of value tuples (variables in sorted order),
    each repeated by its multiplicity."""
    names = sorted(cols)
    out = []
    for i, m in enumerate(np.asarray(mult).tolist()):
        out += [tuple(int(np.asarray(cols[v])[i]) for v in names)] * int(m)
    return sorted(out)


@pytest.mark.parametrize("agg", ["count", None])
@pytest.mark.parametrize("atoms,filter_vars", [(TRIANGLE, ("x",)), (PATH2, ("x",)),
                                               (TRIANGLE, ("x", "y"))],
                         ids=["triangle-x", "path2-x", "triangle-xy"])
def test_seeded_runner_matches_vmapped_reference(atoms, filter_vars, agg, rng):
    """Seeded lanes answer each lane as the reference's mask-mode executor
    under jax.vmap and the eager oracle do: per-lane counts, and agg=None
    rows with their multiplicities. The constants hold one that binds no
    row, a duplicate, and fewer live requests than slots; `x` is held by
    two of the triangle's atoms."""
    slots, n, dom = 8, 300, 10
    cols = {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in atoms}
    rels = {a: Relation(a, c) for a, c in cols.items()}
    consts = np.array([[3, 1], [3, 1], [99, 99], [0, 4], [7, 2]], np.int32)[:, :len(filter_vars)]
    q = Query([Atom(a, vs) for a, vs in atoms])
    runner, *_ = api._acquire_runner(q, rels, linear(q.atoms), agg=agg, options=CPU,
                                     filter_vars=filter_vars, batch=slots, seeds=consts)
    assert isinstance(runner, compiled.SeededExecutor) and runner.plan.seeded
    jq = JQuery([JAtom(a, vs) for a, vs in atoms])
    jfj = J.factor(J.binary2fj(jq.atoms, jq))
    assert str(factor(binary2fj(q.atoms, q))) == str(jfj)
    jcp = jplan_capacities(jfj, {a: JRelation(a, c) for a, c in cols.items()}, block=128)
    caps = tuple(1 << 14 for _ in jcp.capacities)  # room for the unfiltered frontier
    jfn = jcompiled.make_executor(jfj, caps, compact_to=(None,) * len(caps), agg=agg,
                                  filters=tuple((v, i) for i, v in enumerate(filter_vars)),
                                  filter_kill=False)
    jdata = {a: {v: jnp.asarray(c, jnp.int32) for v, c in cs.items()} for a, cs in cols.items()}
    want = jax.device_get(jax.jit(jax.vmap(lambda c: jfn(jdata, None, c)))(jnp.asarray(consts)))
    got = runner.run_relations(rels, filter_consts=consts)
    assert len(got) == slots
    for b, row in enumerate(consts):
        filters = {v: int(c) for v, c in zip(filter_vars, row)}
        eager = free_join(q, rels, agg=agg, filters=filters, device="cpu")
        if agg == "count":
            assert int(got[b]) == int(want[0][b]) == eager
        else:
            v = np.asarray(want[1][b])
            ref = bag_rows({k: np.asarray(a[b])[v] for k, a in want[0].items()},
                           np.asarray(want[2][b])[v])
            assert bag_rows(*got[b]) == ref == bag_rows(*eager)
    assert (got[1] == got[0]) if agg == "count" else bag_rows(*got[1]) == bag_rows(*got[0])
    dead = got[len(consts):]  # slots past the live requests: nothing
    if agg == "count":
        assert got[2] == 0 and not dead.any()
    else:
        assert bag_rows(*got[2]) == [] and all(bag_rows(*d) == [] for d in dead)


@pytest.mark.parametrize("agg", ["count", None])
def test_seeded_lanes_ride_through_a_squeeze(agg, rng):
    """A compaction carries each lane's id with its rows: the seeded
    executor with squeezes forced after the node that probes S and after
    the last node, and a dead last slot, answers each live lane as the
    reference's vmapped mask-mode executor does. S holds half of R's `y`
    values, so its probe kills rows inside each lane's run and the squeeze
    moves the rest; the last squeeze leaves the fold a tail of empty
    slots."""
    cols = {a: {v: rng.integers(0, 5 if (a, v) == ("S", "y") else 10, 300) for v in vs}
            for a, vs in TRIANGLE}
    q = Query([Atom(a, vs) for a, vs in TRIANGLE])
    jq = JQuery([JAtom(a, vs) for a, vs in TRIANGLE])
    plan = seed_plan(factor(binary2fj(q.atoms, q)), ("x",))
    assert len(compiled._static_schedule(plan)) == 3
    caps, ct = (4, 1 << 14, 1 << 14), (None, 1 << 10, 1 << 12)
    fn = compiled.make_executor(plan, caps, compact_to=ct, agg=agg, filters=(("x", 0),))
    consts = np.array([[3], [99], [5], [7]], np.int32)
    data = {a: {v: torch.as_tensor(c, dtype=torch.int32) for v, c in cs.items()}
            for a, cs in cols.items()}
    got = fn(data, None, torch.as_tensor(consts), live=3)
    assert all(0 < int(got[-1][0, i]) <= ct[i] for i in (1, 2)), "the squeezes ran and fit"
    jfj = J.factor(J.binary2fj(jq.atoms, jq))
    jcaps = (1 << 14,) * len(jcompiled._static_schedule(jfj))
    jfn = jcompiled.make_executor(jfj, jcaps, compact_to=(None,) * len(jcaps), agg=agg,
                                  filters=(("x", 0),), filter_kill=False)
    jdata = {a: {v: jnp.asarray(c, jnp.int32) for v, c in cs.items()} for a, cs in cols.items()}
    want = jax.device_get(jax.vmap(lambda c: jfn(jdata, None, c))(jnp.asarray(consts[:3])))
    if agg == "count":
        assert got[0].tolist() == np.asarray(want[0]).tolist() + [0]
    else:
        for b in range(3):
            assert lane_rows(got[0], got[1], got[2], b) == lane_rows(*want[:3], b)
        assert not got[1][3].any()


# the benchmark's served templates over one edge table E, each atom a view
# of it: fof (a 2-hop) is K1 K2, q1 (the triangle) K1 K2 K3
VIEWS = {"K1": ("a", "b"), "K2": ("b", "c"), "K3": ("c", "a")}


def edge_views(P, src, dst):
    return {a: P.Relation("E", dict(zip(vs, (src, dst)))) for a, vs in VIEWS.items()}


def graph_query(P, views, aliases):
    q = P.Query([P.Atom("E", VIEWS[a], a) for a in aliases])
    return q, {a: views[a] for a in aliases}


def test_engine_routes_point_queries_to_seeded_lanes():
    """q1 and fof bind `a` in their first node's cover: seeded lanes. A
    bushy template whose filter falls in a later stage, a group whose
    member carries a max_node_capacity quota, and a group whose constants
    (a hub, repeated) select as many rows of the edges as they hold, keep
    mask mode; light constants of that same template take seeded lanes.
    Every answer equals the oracle's."""
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 30, 400), rng.integers(0, 30, 400)
    views = edge_views(PORT, src, dst)
    # vertex 0 holds a third of these edges: three requests for it select them all
    hub = edge_views(PORT, np.where(np.arange(400) % 3 == 0, 0, src), dst)
    assert 3 * np.count_nonzero(hub["K1"].columns["a"] == 0) >= 400
    kc = relcache.KeyedCache()
    adm = S.AdmissionController(per_tenant={"capped": S.QueryQuota(max_node_capacity=1 << 20)})
    eng = PORT.engine(slots=4, cache=kc, admission=adm)
    chain_q, chain_rels = workload(PORT, CHAIN4, seed=3, n=300, dom=10)
    tree = _bushy(PORT, {a.alias: a for a in chain_q.atoms})
    runs = {}
    for name, (q, rels), filters, kw in (
        ("fof", graph_query(PORT, views, ["K1", "K2"]), {"a": 3}, {}),
        ("q1", graph_query(PORT, views, ["K1", "K2", "K3"]), {"a": 3}, {}),
        ("q1 capped", graph_query(PORT, views, ["K1", "K2", "K3"]), {"a": 3},
         {"tenant": "capped"}),
        ("chain4 e", (chain_q, chain_rels), {"e": 4}, {"plan_tree": tree}),
        ("q1 hub", graph_query(PORT, hub, ["K1", "K2", "K3"]), [{"a": 0}] * 3, {}),
        ("q1 hub, light", graph_query(PORT, hub, ["K1", "K2", "K3"]), {"a": 3}, {}),
    ):
        batch = filters if isinstance(filters, list) else [
            {k: c + i for k, c in filters.items()} for i in range(3)]
        before = set(map(id, _cached_runners(kc)))
        reqs = [eng.submit(q, rels, f, **kw) for f in batch]
        eng.run()
        for f, r in zip(batch, reqs):
            assert r.error is None and r.result == oracle(PORT, q, rels, f)
        (new,) = [r for r in _cached_runners(kc) if id(r) not in before]
        runs[name] = seeded(new)
    assert runs == {"fof": True, "q1": True, "q1 capped": False, "chain4 e": False,
                    "q1 hub": False, "q1 hub, light": True}


@pytest.mark.parametrize("filter_vars,seeds,fewer", [
    (("x",), [[2], [7]], True),            # 3 + 1 of the 6 rows
    (("x",), [[2], [2]], False),           # 3 + 3: a repeated constant counts twice
    (("x",), [[2], [99], [99]], True),     # a constant that binds no row adds none
    (("x", "y"), [[2, 5], [2, 5]], True),  # (2, 5) holds 2 rows: 4 of 6
    (("x", "y"), [[2, 5]] * 3, False),     # 6 of 6
    (("w",), [[2]], False),                # the cover does not bind w
], ids=["two-rows", "repeated", "absent", "two-vars", "two-vars-all", "not-the-cover"])
def test_seeds_select_fewer_rows_counts_the_batch(filter_vars, seeds, fewer):
    """The engine's test for seeded lanes: the first cover binds every
    filter var, and the rows of its relation a batch's constants select,
    duplicates counted, are fewer than it holds."""
    rel = Relation("R", {"x": np.array([2, 2, 2, 7, 9, 9]), "y": np.array([5, 5, 1, 5, 5, 1])})
    q = Query([Atom("R", ("x", "y"))])
    plan = factor(binary2fj(q.atoms, q))
    got = api._seeds_select_fewer_rows(plan, {"R": rel}, filter_vars, np.array(seeds, np.int32))
    assert got is fewer


def _lanes_of_one_dispatch(runner, rels, consts):
    runner.run_relations(rels, filter_consts=consts)  # capacities settle
    live, allocated = TRACE.lanes_live, TRACE.lanes_allocated
    syncs = TRANSFERS.syncs
    counts = runner.run_relations(rels, filter_consts=consts)
    return (TRACE.lanes_live - live, TRACE.lanes_allocated - allocated,
            TRANSFERS.syncs - syncs, counts)


def test_seeded_work_follows_the_selection_not_the_relation():
    """The same constants on a graph and on that graph beside 100 times as
    many edges they never reach: a seeded dispatch's lanes stay within 2x,
    a mask-mode dispatch's grow with the graph. A warm seeded dispatch
    waits for the device at its documented read-backs and its constants'
    upload only."""
    rng = np.random.default_rng(7)
    n, verts = 200, 40
    src, dst = rng.integers(0, verts, n), rng.integers(0, verts, n)
    far = verts + rng.integers(0, 100 * verts, (2, 100 * n))  # vertices past the graph
    consts = np.array([[1], [5], [9]], np.int32)
    lanes = {}
    for size, (s, d) in (("small", (src, dst)), ("large", (np.concatenate([src, far[0]]),
                                                            np.concatenate([dst, far[1]])))):
        q, rels = graph_query(PORT, edge_views(PORT, s, d), ["K1", "K2"])
        seeded_runner, *_ = api._acquire_runner(q, rels, None, agg="count", options=CPU,
                                                filter_vars=("a",), batch=4, seeds=consts)
        mask_runner, *_ = api._acquire_runner(q, rels, None, agg="count", options=CPU,
                                              filter_vars=("a",), batch=4)
        assert seeded(seeded_runner) and not seeded(mask_runner)
        s_live, s_alloc, s_syncs, s_counts = _lanes_of_one_dispatch(seeded_runner, rels, consts)
        m_live, m_alloc, _syncs, m_counts = _lanes_of_one_dispatch(
            mask_runner, rels, np.concatenate([consts, consts[:1]]))
        assert s_counts[:3].tolist() == m_counts[:3].tolist() == [
            compiled_free_join(q, rels, filters={"a": int(c)}, options=CPU) for c in consts[:, 0]]
        assert s_syncs == seeded_runner.warm_read_backs + 1  # + the constants' upload
        lanes[size] = (s_live, s_alloc, m_live, m_alloc)
    (s_live, s_alloc, m_live, m_alloc), big = lanes["small"], lanes["large"]
    assert s_live == big[0] and big[1] <= 2 * s_alloc
    # mask mode scans every row: its lanes grow with the edges (allocated
    # lanes by less, as the small graph's buffer is one rounded block)
    assert big[2] >= 100 * m_live and big[3] >= 10 * m_alloc
