"""Quickstart on the PyTorch/CUDA port: Free Join on the paper's own examples.

Shows the whole pipeline: query -> cost-based binary plan -> binary2fj ->
factor -> COLT + vectorized execution, against the Generic Join and binary
join baselines, on the triangle query (Example 2.1) and the adversarial
clover instance (Fig. 3/4), then the compiled static-shape path, where
frontier capacities come from the capacity planner (no manual sizes) and
overflow is recovered adaptively; then serving, resilience and streaming.

Everything runs on --device (the card by default; "cpu" runs every kernel's
plain PyTorch version):

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

main() returns every count, the clover's rows, the serving and standing
results, the ladder rungs and the cache counters, and under "inputs" the
columns each section started from (the streaming deltas among them).
"""
import argparse
import time

import numpy as np

from repro_torch.core import (
    BinaryPlan,
    ExecOptions,
    binary2fj,
    binary_join,
    compiled_free_join,
    factor,
    faults,
    free_join,
    generic_join,
    optimize,
    relcache,
    to_sorted_tuples,
)
from repro_torch.core.compiled import TRIE_CACHE
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query, clover_query, triangle_query
from repro_torch.serve import JoinServeEngine, StandingQueryEngine

SERVE_X = (3, 17, 41, 88)  # the tenants' selection constants on x
CLOVER_N = 5000


def triangle_relations(rng):
    q = triangle_query()
    return q, {
        a.alias: Relation(a.alias, {v: rng.integers(0, 100, 5000) for v in a.vars})
        for a in q.atoms
    }


def clover_relations(n: int = CLOVER_N):
    """The paper's adversarial clover instance: n^2 pairwise joins, 1 result."""
    ar = np.arange(n, dtype=np.int64)
    return clover_query(), {
        "R": Relation(
            "R", {"x": np.r_[0, np.full(n, 1), np.full(n, 2)], "a": np.r_[0, ar, ar + n]}
        ),
        "S": Relation(
            "S", {"x": np.r_[0, np.full(n, 2), np.full(n, 3)], "b": np.r_[0, ar, ar + n]}
        ),
        "T": Relation(
            "T", {"x": np.r_[0, np.full(n, 3), np.full(n, 1)], "c": np.r_[0, ar, ar + n]}
        ),
    }


def chain_query() -> Query:
    return Query(
        [Atom("A", ("x", "y")), Atom("B", ("y", "z")), Atom("C", ("z", "w")), Atom("D", ("w", "u"))]
    )


def ms_since(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def columns(rels) -> dict:
    return {a: dict(r.columns) for a, r in rels.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device
    opts = ExecOptions(device=dev)
    out = {"device": dev, "inputs": {}}

    rng = np.random.default_rng(0)
    q, rels = triangle_relations(rng)
    tree = optimize(q, rels)
    fj_plan = binary2fj(q.atoms, q)
    print("query          :", q)
    print("binary2fj      :", fj_plan)
    print("factored       :", factor(fj_plan))
    out["triangle"] = {}
    for name, fn in (
        ("free join", lambda: free_join(q, rels, tree, agg="count", device=dev)),
        ("binary join", lambda: binary_join(q, rels, tree, agg="count", device=dev)),
        ("generic join", lambda: generic_join(q, rels, plan_tree=tree, agg="count", device=dev)),
    ):
        t0 = time.perf_counter()
        c = fn()
        out["triangle"][name] = c
        print(f"{name:<12}: count={c}  ({ms_since(t0):.1f} ms)")

    out["inputs"]["triangle"] = columns(rels)
    qc, crels = clover_relations()
    out["inputs"]["clover"] = columns(crels)
    tree = optimize(qc, crels)
    print("\nclover (adversarial skew, n =", CLOVER_N, ")")
    out["clover"] = {}
    for name, fn in (
        ("free join", lambda: free_join(qc, crels, tree, device=dev)),
        ("binary join", lambda: binary_join(qc, crels, tree, device=dev)),
    ):
        t0 = time.perf_counter()
        bound, mult = fn()
        rows = to_sorted_tuples((bound, mult), qc.head)
        out["clover"][name] = rows
        print(f"{name:<12}: output={rows}  ({ms_since(t0):.1f} ms)")

    # the compiled path: same triangle count, static shapes. The capacity
    # planner sizes every frontier buffer from the optimizer's estimates
    # capped by the AGM bound (no manual capacities) and the adaptive runner
    # grows any buffer that still overflows and retries.
    rng = np.random.default_rng(0)
    q, rels = triangle_relations(rng)
    print("\ncompiled path (static shapes, planner-derived capacities)")
    info = {}
    t0 = time.perf_counter()
    c = compiled_free_join(q, rels, agg="count", options=opts, info=info)
    print(f"cold        : count={c}  ({ms_since(t0):.1f} ms incl. upload, trie builds "
          "and executor build)")
    # steady state, build once and probe many: the cold call uploaded the
    # columns, built every trie (segmented radix sort, K4, + lazy hash
    # tables) and built the executor, and cached all three process-wide. A
    # repeated identical call is probe work only (K2 expansions, K1
    # probes, K3 compactions): no np.unique, no trie build, no executor
    # build.
    warm = []
    for i in range(3):
        t0 = time.perf_counter()
        c2 = compiled_free_join(q, rels, agg="count", options=opts, info=info)
        print(f"warm call {i} : count={c2}  ({ms_since(t0):.1f} ms, probe only)")
        assert c2 == c
        warm.append(c2)
    print(f"plan        : {info['cap_plan']}  retries={info['retries']}")
    eager = free_join(q, rels, agg="count", device=dev)
    assert c == eager
    out["compiled"] = {"cold": c, "warm": warm, "eager": eager, "retries": info["retries"],
                       "cap_plan": str(info["cap_plan"])}

    # bushy plans, fully compiled: a binary plan tree with a join on its
    # right side decomposes into stages (Sec 2.2). The compiled path runs
    # the WHOLE chain on the device: each non-root stage's output stays
    # there as a padded, multiplicity-weighted buffer that the next stage
    # builds its trie from; the eager engine is never invoked. Per-stage
    # capacities come from estimated stage statistics and any stage's
    # overflow grows exactly the offending buffer.
    qb = chain_query()
    relsb = {
        a.alias: Relation(a.alias, {v: rng.integers(0, 500, 1500) for v in a.vars})
        for a in qb.atoms
    }
    out["inputs"]["chain"] = columns(relsb)
    # (A ⋈ B) ⋈ (C ⋈ D): the right subtree becomes a materialized stage
    bushy = BinaryPlan(
        BinaryPlan(qb.atoms[0], qb.atoms[1]), BinaryPlan(qb.atoms[2], qb.atoms[3])
    )
    print("\nbushy plan, fully compiled (stage chained on the device)")
    info = {}
    t0 = time.perf_counter()
    cb = compiled_free_join(qb, relsb, bushy, agg="count", options=opts, info=info)
    print(f"chained     : count={cb}  ({ms_since(t0):.1f} ms incl. executor build)")
    print(f"chain plan  : {info['cap_plan']}")
    eager = free_join(qb, relsb, bushy, agg="count", device=dev)
    assert cb == eager
    out["bushy"] = {"count": cb, "eager": eager}

    # cost-based plan enumeration: no hand-written tree this time. The
    # ExecOptions.optimize_level knob picks the plan-choice effort: 0 is the
    # greedy left-deep search, 1 (default) enumerates bushy candidates by
    # dynamic programming over connected subqueries and ranks them with a
    # device cost model (frontier cells touched, AGM-capped), 2 makes the
    # enumeration exhaustive and re-plans when measured cardinalities from
    # earlier runs contradict the estimates. On this chain the middle join
    # (b ⋈ c over a small domain) is dense while both end joins are
    # selective: greedy must drag the dense intermediate left-deep, the
    # enumeration brackets it bushy.
    relsd = {
        "A": Relation("A", {"x": rng.integers(0, 1500, 1500), "y": rng.integers(0, 1500, 1500)}),
        "B": Relation("B", {"y": rng.integers(0, 1500, 1500), "z": rng.integers(0, 12, 1500)}),
        "C": Relation("C", {"z": rng.integers(0, 12, 1500), "w": rng.integers(0, 1500, 1500)}),
        "D": Relation("D", {"w": rng.integers(0, 1500, 1500), "u": rng.integers(0, 1500, 1500)}),
    }
    out["inputs"]["dense_chain"] = columns(relsd)
    print("\ncost-based plan enumeration (ExecOptions.optimize_level)")
    out["optimize_level"], out["plans"] = {}, {}
    for level in (0, 2):
        info = {}
        c = compiled_free_join(
            qb, relsd, agg="count", options=ExecOptions(device=dev, optimize_level=level),
            info=info,
        )
        out["optimize_level"][level], out["plans"][level] = c, str(info["plan_tree"])
        print(f"level {level}     : count={c}  plan={info['plan_tree']}")

    # static verification: ExecOptions(verify=True) runs the plan/schedule/
    # capacity linter (repro_torch.analysis) over the freshly planned chain
    # before the executor is built: structural defects (unbound probe vars,
    # missing covers, capacities past the AGM cap, broken stage wiring)
    # surface as typed diagnostics with plan-path locations instead of
    # shape errors deep inside the executor. The lint runs once per build,
    # never on warm hits.
    c = compiled_free_join(qb, relsd, agg="count", options=ExecOptions(device=dev, verify=True))
    out["verified"] = c
    print(f"verified    : count={c}  (ExecOptions(verify=True) linted the plan before the build)")

    # multi-tenant serving loop: concurrent tenants send the SAME query in
    # different spellings (their own aliases) with their own selection
    # constants. JoinServeEngine canonicalizes each request into a plan
    # template (alias alpha-renaming + constant lifting), so all of them
    # share ONE runner, and co-template requests are answered by ONE
    # dispatch over the shared cached tries, the constants matrix the only
    # per-lane input. The filter binds x in the plan's first node and the
    # constants select few of the rows, so the dispatch runs on seeded
    # lanes: each lane's join starts from its own constant, and its work
    # follows the rows that constant selects.
    # Admission quotas (see
    # src/repro_torch/serve/README.md) reject oversized queries instead of
    # letting them stall the batch with a grow/rebuild storm.
    print("\nserving loop (plan templates + batched probes)")
    eng = JoinServeEngine(slots=4, options=opts)
    reqs = []
    for i, c in enumerate(SERVE_X):
        # tenant i's spelling: same triangle, different alias names
        qi = Query([Atom(a.name, a.vars, f"tenant{i}_{a.alias}") for a in q.atoms])
        ri = {f"tenant{i}_{a.alias}": rels[a.alias] for a in q.atoms}
        reqs.append(eng.submit(qi, ri, {"x": c}, tenant=f"tenant{i}"))
    assert len({r.template.key for r in reqs}) == 1  # one template for all
    t0 = time.perf_counter()
    eng.run()
    dt = ms_since(t0)
    out["serving"] = {"counts": {}, "eager": {}, "dispatches": eng.dispatches}
    for r, c in zip(reqs, SERVE_X):
        eager = free_join(q, rels, agg="count", filters={"x": c}, device=dev)
        assert r.result == eager
        out["serving"]["counts"][c], out["serving"]["eager"][c] = r.result, eager
        print(f"  x={c:>2}: count={r.result}")
    print(f"4 tenants, {eng.dispatches} batched dispatch ({dt:.1f} ms incl. executor build)")

    # resilience: a fault the quota machinery has no protocol for, here an
    # injected executor-build failure, in production a CUDA out-of-memory
    # error or a memory-governor shed, never crashes step(). The group
    # descends a degradation ladder (full-width batch -> halved batch ->
    # unbatched -> the eager engine on the same device; there is no CPU
    # rung) and every admitted request still answers correctly, with the
    # rung recorded on the handle as `degraded_to`. A kernel build or
    # launch error is not absorbed: it propagates.
    print("\nresilience (degradation ladder under an injected executor-build failure)")
    reng = JoinServeEngine(slots=2, options=opts)
    with faults.inject("compile_fail", times=1) as f:
        r0 = reng.submit(q, rels, {"x": 3}, tenant="tenantA")
        r1 = reng.submit(q, rels, {"x": 17}, tenant="tenantB")
        reng.run()
    for r, c in zip((r0, r1), (3, 17)):
        assert r.done and r.error is None
        assert r.result == out["serving"]["eager"][c]
    print(f"  build faults injected: {f.fired}; absorbed: {reng.faults_absorbed}")
    print(f"  x= 3: count={r0.result}  (degraded_to={r0.degraded_to})")
    print(f"  x=17: count={r1.result}  (degraded_to={r1.degraded_to})")
    print("  both answers correct: the query survived the failed executor build")
    out["resilience"] = {"counts": {3: r0.result, 17: r1.result},
                         "degraded_to": {3: r0.degraded_to, 17: r1.degraded_to},
                         "fired": f.fired, "faults_absorbed": reng.faults_absorbed}

    # streaming ingest + standing queries: relations mutate through the
    # relcache delta API (append/delete), and the cached trie absorbs each
    # batch with ONE delta merge: the batch is sorted alone and spliced into
    # the cached level buffers, never a full re-sort; deletes tombstone
    # rows at multiplicity 0 until a compaction threshold. A
    # StandingQueryEngine keeps registered queries answered across ingests,
    # recomputing only the plan stages whose input fingerprints moved;
    # unchanged stages replay their cached device buffers.
    print("\nstreaming ingest (delta tries + standing query)")
    seng = StandingQueryEngine(options=opts)
    sq = seng.register(q, rels, agg="count")
    builds = TRIE_CACHE.builds
    merges0, refreshes0 = TRIE_CACHE.delta_merges, TRIE_CACHE.tombstone_refreshes
    st = {"registered": sq.result, "ingests": [], "eager": []}
    out["inputs"]["deltas"] = []
    print(f"  registered : count={sq.result}")
    for step in range(3):
        delta = {
            "x": rng.integers(0, 200, 256),
            "y": rng.integers(0, 200, 256),
        }
        out["inputs"]["deltas"].append(delta)
        t0 = time.perf_counter()
        seng.ingest(rels["R"], delta)  # append + refresh every standing query
        dt = ms_since(t0)
        eager = free_join(q, rels, agg="count", device=dev)
        assert sq.result == eager
        st["ingests"].append(sq.result)
        st["eager"].append(eager)
        print(f"  ingest {step}   : count={sq.result}  ({dt:.1f} ms)")
    relcache.delete(rels["R"], np.arange(64))  # tombstones, then refresh
    seng.refresh()
    eager = free_join(q, {**rels, "R": relcache.live_relation(rels["R"])}, agg="count",
                      device=dev)
    assert sq.result == eager
    st.update(deleted=sq.result, deleted_eager=eager,
              delta_merges=TRIE_CACHE.delta_merges - merges0,
              tombstone_refreshes=TRIE_CACHE.tombstone_refreshes - refreshes0,
              builds_after_register=TRIE_CACHE.builds - builds)
    out["streaming"] = st
    print(f"  delete 64  : count={sq.result}  "
          f"({st['delta_merges']} delta merges, {st['tombstone_refreshes']} "
          f"tombstone refresh, {st['builds_after_register']} full rebuilds after registration)")
    return out


if __name__ == "__main__":
    main()
