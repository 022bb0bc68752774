"""The port's tracer (repro_torch.core.trace): the span tree of a query, the
sync spans against the transfer counter, the lane counters against a hand
count, the profiler ranges only under a profiler, idle time by span, and
the serving engine's dispatch cost taken from its spans.

Everything runs on the CPU (`ExecOptions(device="cpu")`, every kernel's
plain version); tests/test_torch_cuda.py holds the card's check that the
spans share the device trace's clock. The file imports no JAX.
"""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import corpus
from repro_torch.core import api, faults, trace
from repro_torch.core.api import ExecOptions, compiled_free_join
from repro_torch.core.plan import BinaryPlan
from repro_torch.core.trace import NAMES, OUTSIDE, TRACE, idle_by_span
from repro_torch.core.transfers import TRANSFERS
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from repro_torch.serve import JoinServeEngine

CPU = ExecOptions(device="cpu")
TRIANGLE = [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x"))]
CHAIN4 = [("A", ("x", "y")), ("B", ("y", "z")), ("C", ("z", "w")), ("D", ("w", "u"))]
# the span each span opens under (None: a root)
PARENTS = {
    "query": {None},
    "plan.acquire": {"query"},
    "plan.choose": {"plan.acquire"},
    "plan.capacity": {"plan.acquire"},
    "plan.distinct": {"plan.choose", "plan.capacity"},
    "exec.run": {"query"},
    "exec.tries": {"exec.run"},
    "tries.build": {"exec.tries"},
    "exec.enqueue": {"exec.run"},
    "exec.node": {"exec.enqueue"},
    "exec.sync": {"exec.run", "exec.tries"},
    "exec.feedback": {"exec.run"},
}


def case(atoms, seed=0, n=60, dom=9):
    """A query over fresh relations of random columns (so a first call
    plans, uploads and builds)."""
    rng = np.random.default_rng(seed)
    q = Query([Atom(a, vs) for a, vs in atoms])
    rels = {a: Relation(a, {v: rng.integers(0, dom, n) for v in vs}) for a, vs in atoms}
    return q, rels


def triangle():
    return (*case(TRIANGLE), None)


def bushy():
    """((A ⋈ B) ⋈ (C ⋈ D)): one non-root stage chained into the root."""
    q, rels = case(CHAIN4, n=40, dom=8)
    at = {a.alias: a for a in q.atoms}
    tree = BinaryPlan(BinaryPlan(at["A"], at["B"]), BinaryPlan(at["C"], at["D"]))
    return q, rels, tree


def complete_triangle(k=10):
    """The triangle over the complete relation on k values: k**2 rows a
    relation, k**3 two-paths, every one a triangle."""
    i, j = np.divmod(np.arange(k * k), k)
    rels = {a: Relation(a, {vs[0]: i, vs[1]: j}) for a, vs in TRIANGLE}
    return Query([Atom(a, vs) for a, vs in TRIANGLE]), rels


def totals_delta(before):
    after = TRACE.totals()
    return {k: tuple(a - b for a, b in zip(after[k], before[k])) for k in after}


def program_spans(prof):
    """[(name, parent span name or None, kwargs, start, end)] of the
    session's program spans, the parent the nearest enclosing one."""
    out = []
    for e in prof.events():
        if e.name not in NAMES:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in NAMES:
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name, dict(e.kwinputs or {}),
                    e.time_range.start, e.time_range.end))
    return out


@pytest.mark.parametrize("make", [triangle, bushy], ids=["triangle", "bushy"])
def test_span_tree_of_a_count(make):
    q, rels, tree = make()
    before = TRACE.totals()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        first = compiled_free_join(q, rels, tree, options=CPU)
        second = compiled_free_join(q, rels, tree, options=CPU)
    assert first == second
    d = totals_delta(before)
    spans = program_spans(prof)
    names = {s[0] for s in spans}
    want = set(PARENTS) - ({"plan.choose"} if tree is not None else set())
    assert names == want
    for name, parent, _kw, _s, _e in spans:
        assert parent in PARENTS[name], (name, parent)
    for name in NAMES:
        count, ns, self_ns = d[name]
        assert count == sum(1 for s in spans if s[0] == name), name
        assert ns >= self_ns >= 0, name
    # the spans of one call share its query id; the two calls have two
    ids = [s[2]["query"] for s in spans]
    roots = [s[2]["query"] for s in spans if s[0] == "query"]
    assert len(set(roots)) == 2 and set(ids) == set(roots)
    for qid, (_n, _p, _kw, s, e) in zip(roots, [x for x in spans if x[0] == "query"]):
        inside = [x for x in spans if x[3] >= s and x[4] <= e]
        assert {x[2]["query"] for x in inside} == {qid}
    nodes = [s[2]["node"] for s in spans if s[0] == "exec.node"]
    assert nodes and min(nodes) == 0
    assert {s[2]["kind"] for s in spans if s[0] == "exec.sync"} == {"read", "upload"}


@pytest.mark.parametrize("agg", ["count", None])
def test_sync_spans_are_the_counted_crossings(agg):
    q, rels = case(TRIANGLE, seed=3)
    syncs, spans = TRANSFERS.syncs, TRACE.exec_sync.count
    info = {}
    compiled_free_join(q, rels, agg=agg, options=CPU, info=info)  # uploads, builds, reruns
    assert TRACE.exec_sync.count - spans == TRANSFERS.syncs - syncs > 2
    syncs, spans = TRANSFERS.syncs, TRACE.exec_sync.count
    compiled_free_join(q, rels, agg=agg, options=CPU)
    warm = TRACE.exec_sync.count - spans
    assert warm == TRANSFERS.syncs - syncs == info["runner"].warm_read_backs


def run_counting_lanes(runner, rels, **kw):
    """Run once; returns the result, each rerun's (chain, needs read back)
    and the lane counters' deltas."""
    chains, needs = [], []
    fn = runner._fn

    def spy_fn(chain):
        chains.append(chain)
        return fn(chain)

    to_host = TRANSFERS.to_host

    def spy_to_host(t, what):
        out = to_host(t, what)
        if what == "needs":
            needs.append(out.copy())
        return out

    runner._fn = spy_fn
    TRANSFERS.to_host = spy_to_host
    live, allocated = TRACE.lanes_live, TRACE.lanes_allocated
    try:
        out = runner.run_relations(rels, **kw)
    finally:
        del runner._fn
        TRANSFERS.to_host = to_host
    return out, list(zip(chains, needs)), (TRACE.lanes_live - live,
                                           TRACE.lanes_allocated - allocated)


@pytest.mark.parametrize("batch", [None, 4])
def test_lane_counters_against_a_hand_count(batch):
    """On the complete triangle over 10 values both executed nodes expand
    (100 lanes, then 1,000) and none compacts: every run's live lanes are
    min(need, capacity) of the two, its allocated lanes the two
    capacities. A batched (mask-mode) dispatch runs its frontier once for
    all lanes: its need rows are one lane-independent row."""
    q, rels = complete_triangle()
    kw = {}
    if batch:
        kw["filter_consts"] = np.arange(batch, dtype=np.int32)[:, None]
    runner, rels, _c, _t = api._acquire_runner(
        q, rels, None, agg="count", options=CPU,
        filter_vars=("x",) if batch else (), batch=batch)
    for _call in range(2):  # the first call reruns to tightened capacities
        out, runs, (live, allocated) = run_counting_lanes(runner, rels, **kw)
        want_live = want_allocated = 0
        for chain, needs in runs:
            (cp,) = chain.stages
            rows = needs.reshape(-1, 4)
            assert (rows == [100, 1000, 0, 0]).all()  # need_expand x2, need_compact x2
            assert cp.compact_to == (None, None)
            want_live += min(100, cp.capacities[0]) + min(1000, cp.capacities[1])
            want_allocated += cp.capacities[0] + cp.capacities[1]
        assert (live, allocated) == (want_live, want_allocated)
    assert len(runs) == 1 and want_live == 1100
    assert (np.asarray(out) == 1000 if batch is None else np.asarray(out) == 100).all()


def test_lane_counters_of_a_batch_split_by_lane():
    """A chain whose filter falls in a non-root stage runs the stages after
    it once per lane: those stages' buffers count once per lane, each with
    its own lane's need row; the stages before, once."""
    q, rels = case(CHAIN4, seed=5, n=200, dom=12)
    at = {a.alias: a for a in q.atoms}
    tree = BinaryPlan(BinaryPlan(at["A"], at["B"]), BinaryPlan(at["C"], at["D"]))
    lanes = 3
    runner, rels, _c, _t = api._acquire_runner(
        q, rels, tree, agg="count", options=CPU, filter_vars=("u",), batch=lanes)
    consts = np.array([[1], [7], [2]], np.int32)
    runner.run_relations(rels, filter_consts=consts)
    out, runs, (live, allocated) = run_counting_lanes(runner, rels, filter_consts=consts)
    assert len(runs) == 1
    chain, needs = runs[0]
    fn = runner._fn(chain)
    stage_runs = [r for _sizes, r in fn.allocated]
    # the (C D) stage binds the filter and runs once; the root, once a lane
    assert [n for n, _p in runner.stages][-1] == "__root" and stage_runs == [1, lanes]
    sizes = [len(cp.capacities) for cp in chain.stages]
    cut = np.cumsum(sizes + sizes)[:-1]
    parts = np.split(needs.reshape(lanes, -1), cut, axis=1)
    want_live = want_allocated = 0
    for s, cp in enumerate(chain.stages):
        (e_sizes, c_sizes), runs_s = fn.allocated[s]
        for sizes_s, rows in ((e_sizes, parts[s]), (c_sizes, parts[len(sizes) + s])):
            for row in rows[:runs_s]:
                want_live += sum(min(int(n), c) for n, c in zip(row, sizes_s))
            want_allocated += runs_s * sum(sizes_s)
        assert all(c in (0, cap) for c, cap in zip(e_sizes, cp.capacities))
    assert (live, allocated) == (want_live, want_allocated) and allocated > 0


def test_no_profiler_range_without_a_session(monkeypatch):
    """With no profiler running no range is ever opened; under a CPU
    profiler every span of a cold call appears by name, inside `query`."""
    def refuse(*args, **kwargs):
        raise AssertionError("a profiler range opened with no session")

    q, rels = case(TRIANGLE, seed=11)
    with monkeypatch.context() as m:
        m.setattr(trace, "_Range", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        want = compiled_free_join(q, rels, options=CPU)
    q, rels = case(TRIANGLE, seed=11)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert compiled_free_join(q, rels, options=CPU) == want
    spans = program_spans(prof)
    assert {s[0] for s in spans} == set(PARENTS)
    (root,) = [s for s in spans if s[0] == "query"]
    assert all(root[3] <= s[3] and s[4] <= root[4] for s in spans)


class Ev:
    """A kineto event as idle_by_span reads it."""

    def __init__(self, name, start, end, device=False, annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._a = device, annotation

    def name(self):
        return self._n

    def device_type(self):
        return DeviceType.CUDA if self._d else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def kernel(s, e):
    return Ev("kernel", s, e, device=True)


SYNTHETIC = {
    # the device idles over [50, 150), across the end of one span and the
    # start of the next
    "gap across two spans": (
        [Ev("query", 0, 300), Ev("exec.node", 0, 100), Ev("exec.sync", 100, 200),
         kernel(0, 50), kernel(150, 300)],
        {"exec.node": 50, "exec.sync": 50}),
    # idle before the first span and after the last, under no span; an
    # operator of torch's own and a device-side annotation change nothing
    "gap outside all spans": (
        [kernel(0, 100), Ev("aten::add", 100, 200), Ev("query", 150, 250), kernel(250, 400),
         Ev("exec.node", 300, 350, device=True, annotation=True), kernel(420, 500)],
        {OUTSIDE: 70, "query": 100}),
    # nested spans: each stretch goes to the innermost span open over it
    "nested spans": (
        [Ev("query", 0, 100), Ev("exec.run", 10, 90), Ev("exec.node", 20, 40),
         kernel(100, 110)],
        {"exec.node": 20, "exec.run": 60, "query": 20}),
}


@pytest.mark.parametrize("name", list(SYNTHETIC))
def test_idle_by_span_on_synthetic_events(name):
    events, want = SYNTHETIC[name]
    got = idle_by_span(events)
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert list(got) == sorted(got, key=lambda k: -got[k])


def test_idle_by_span_reads_a_session():
    """A CPU session has no device operation: its whole length is idle,
    and what a query leaves to no span is its own."""
    q, rels = case(TRIANGLE, seed=13)
    compiled_free_join(q, rels, options=CPU)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        compiled_free_join(q, rels, options=CPU)
    got = idle_by_span(prof)
    assert set(got) <= set(NAMES) | {OUTSIDE} and "exec.node" in got
    assert sum(got.values()) > 0


def corpus_case(name):
    """A fresh copy of a corpus case (the same seeded draws): its own
    relation objects, so no cache or feedback entry carries over."""
    return next(c for c in corpus.corpus_cases() if c.name == name)


@pytest.mark.parametrize("name", sorted(c.name for c in corpus.corpus_cases()))
def test_launch_audit_findings_unchanged_under_a_profiler(name):
    """The audit's findings on each corpus case are the same with the
    spans' profiler ranges open as without them."""
    def findings(rep):
        return sorted((d.rule, str(d.severity), d.path) for d in rep)

    plain = findings(cli.check_case(corpus_case(name), device="cpu"))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True):
        ranged = findings(cli.check_case(corpus_case(name), device="cpu"))
    assert ranged == plain
    assert {r for r, _s, _p in plain} <= {"small-uploads"}


def test_dispatch_cost_is_the_dispatch_span():
    """cost_ema_us folds in each serve.dispatch span's duration, on the
    filterless, the batched and the quota-evicted path."""
    q, rels = case(TRIANGLE, seed=17, n=200, dom=12)
    seen = []
    eng = JoinServeEngine(slots=4, options=CPU)
    eng.backoff_base_ms = 0
    observe = eng._observe_cost

    def spy(key):
        seen.append((key, TRACE.serve_dispatch.last_ns / 1e3))
        observe(key)

    eng._observe_cost = spy
    dispatches = TRACE.serve_dispatch.count
    plain = eng.submit(q, rels)
    eng.run()
    with faults.inject("overflow_storm", times=1, lanes=(1,)):
        lanes = [eng.submit(q, rels, {"x": c}) for c in range(3)]
        eng.run()
    assert plain.error is None and lanes[0].error is None and lanes[2].error is None
    assert type(lanes[1].error).__name__ == "CapacityQuotaError"
    assert len(seen) == TRACE.serve_dispatch.count - dispatches == 3
    ema = {}
    for key, us in seen:
        ema[key] = us if key not in ema else 0.7 * ema[key] + 0.3 * us
    assert eng.cost_ema_us == pytest.approx(ema)


def test_seeded_dispatches_count_the_seeded_calls():
    """TRACE.seeded_dispatches rises by exactly the engine's seeded
    dispatches, and not at all for mask-mode dispatches (a group whose
    member carries a max_node_capacity quota) or kill-mode calls."""
    from repro_torch.serve import AdmissionController, QueryQuota

    q, rels = case(TRIANGLE, seed=21, n=200, dom=12)
    adm = AdmissionController(per_tenant={"capped": QueryQuota(max_node_capacity=1 << 20)})
    eng = JoinServeEngine(slots=4, options=CPU, admission=adm)
    counts = []
    for tenant in ("free", "capped"):
        seeded, dispatches = TRACE.seeded_dispatches, eng.dispatches
        reqs = [eng.submit(q, rels, {"x": c}, tenant=tenant) for c in range(6)]
        eng.run()
        assert all(r.error is None for r in reqs)
        counts.append((TRACE.seeded_dispatches - seeded, eng.dispatches - dispatches))
    seeded = TRACE.seeded_dispatches
    compiled_free_join(q, rels, filters={"x": 3}, options=CPU)
    assert counts == [(2, 2), (0, 2)] and TRACE.seeded_dispatches == seeded


def kron_views(scale=7):
    """q1's three views of GAP's kron graph (perfbench/datasets/gap_kron.py):
    hub-skewed, so the plan splits K3(c,a) and node 1 chooses per lane."""
    from perfbench.datasets import gap_kron

    cols = gap_kron.generate({"scale": scale, "degree": 16, "structure_seed": 0,
                              "initiator": {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05}},
                             3)["knows"]
    a, b = cols["a"], cols["b"]
    q = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2"),
               Atom("knows", ("c", "a"), "K3")])
    rels = {"K1": Relation("knows", {"a": a, "b": b}), "K2": Relation("knows", {"b": a, "c": b}),
            "K3": Relation("knows", {"c": a, "a": b})}
    return q, rels, a, b


def test_expanded_and_cover_counters_against_a_hand_count():
    """A warm q1 over the kron graph: node 0 expands every row; node 1's
    lanes iterate K2(c) under b (deg b rows) or, where it holds fewer,
    K3(c) under a (deg a rows). lanes_expanded counts both nodes' lanes,
    lanes_multi_cover node 1's, lanes_other_cover those K3(c) made."""
    q, rels, a, b = kron_views()
    info = {}
    compiled_free_join(q, rels, options=CPU, info=info)
    assert info["runner"].plan.lane_choice == (1,)
    before = (TRACE.lanes_expanded, TRACE.lanes_multi_cover, TRACE.lanes_other_cover,
              TRACE.lanes_live, TRACE.lanes_allocated)
    compiled_free_join(q, rels, options=CPU, info=info)
    got = [x - y for x, y in zip((TRACE.lanes_expanded, TRACE.lanes_multi_cover,
                                  TRACE.lanes_other_cover, TRACE.lanes_live,
                                  TRACE.lanes_allocated), before)]
    deg = np.bincount(a)
    da, db = deg[a], deg[b]
    other = da < db
    node1 = int(np.minimum(da, db).sum())
    assert got[:3] == [len(a) + node1, node1, int(da[other].sum())]
    cp = info["cap_plan"]
    assert got[3] == len(a) + node1  # nothing overflowed: every lane live
    assert got[4] == cp.capacities[0] + 2 * cp.capacities[1]  # node 1: a buffer a cover


def test_tile_spans_and_their_lanes(monkeypatch):
    """Under a memory budget the kron q1 runs in tiles (the floor under
    which no plan tiles lowered to reach this size): one `exec.tile` span
    a tile, under the call's `exec.enqueue`, each holding its nodes'
    spans; the lanes add up to the untiled call's."""
    from repro_torch.core import capacity, membudget

    monkeypatch.setattr(capacity, "TILE_MIN_LANES", 1)

    q, rels, a, b = kron_views()
    deg = np.bincount(a)
    want = len(a) + int(np.minimum(deg[a], deg[b]).sum())
    info = {}
    with membudget.budget(want // 2 * capacity.LANE_BYTES):
        compiled_free_join(q, rels, options=CPU, info=info)
        tiles = info["cap_plan"].tiles
        assert tiles > 1
        before = TRACE.lanes_expanded
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            compiled_free_join(q, rels, options=CPU, info=info)
    assert TRACE.lanes_expanded - before == want
    spans = program_spans(prof)
    assert sum(1 for s in spans if s[0] == "exec.tile") == tiles
    assert {p for n, p, *_r in spans if n == "exec.tile"} == {"exec.enqueue"}
    assert {p for n, p, *_r in spans if n == "exec.node"} == {"exec.tile"}
