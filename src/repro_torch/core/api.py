"""Top-level driver of the port: the compiled Free Join query.

`compiled_free_join` runs the *whole* stage chain of a query as one device
program: query -> cost-based binary plan -> per-stage binary2fj + factor
-> capacity.plan_chain_capacities -> one compiled.AdaptiveExecutor call.
Non-root stages execute with the same static-shape executor as the root
(agg=None), their output columns stay on the device as padded,
mult-weighted buffers, and the next stage builds its trie straight from
that buffer. No manual capacities: per-stage buffer sizes come from the
optimizer's estimates capped by the AGM bound, and any stage's overflow is
recovered by growing exactly the offending node and re-running the chain.

A device error propagates to the caller; there is no host fallback.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import relcache
from repro_torch.core.optimizer import FilteredStats, JoinOrderOptimizer, Stats
from repro_torch.core.plan import BinaryPlan, stage_plans
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


@dataclass(frozen=True)
class ExecOptions:
    """Execution knobs of the compiled path, as one frozen (hashable)
    value: it rides through the runner-cache key and every planner and
    executor build.

    device: where tries and frontiers live ("cuda", or "cpu", where every
    kernel runs its plain PyTorch version); budget: hash-probe
    displacement budget; safety: multiplier on planner cardinality
    estimates; compact_threshold: schedule compaction when the live
    fraction is estimated to drop below this; optimize_level: plan-choice
    effort when no plan tree is given — 0 is the greedy left-deep search,
    1 (default) enumerates bushy candidates by dynamic programming, ranks
    them with the device cost model and pins the winner for the life of
    the relations, 2 enumerates exhaustively and re-plans when measured
    cardinalities contradict the estimates (optimizer.JoinOrderOptimizer).

    chain_stages=False (the hybrid baseline with eager host stages) and
    verify=True (the static plan verifier) are not available in the port
    yet and raise NotImplementedError."""

    device: str = "cuda"
    budget: int = 32
    safety: float = 2.0
    compact_threshold: float = 0.25
    chain_stages: bool = True
    optimize_level: int = 1
    verify: bool = False

    def __post_init__(self):
        if not self.chain_stages:
            raise NotImplementedError(
                "chain_stages=False needs the eager engine, which the port does not have yet"
            )
        if self.verify:
            raise NotImplementedError("verify=True needs the plan verifier, not ported yet")


# warm serving surface: whole AdaptiveExecutors reused across
# compiled_free_join calls, keyed by the query/plan structure + execution
# knobs + the identity of every base relation. Entries are evicted when any
# keyed relation dies (weakref finalizers — see relcache.KeyedCache), so an
# id() reused by a new relation object can never resurrect a stale runner.
_runner_cache = relcache.KeyedCache(max_entries=32)


def _runner_key(stages, rels, base, agg, options, filter_vars):
    return (
        # str(plan) renders the nodes but not the output projection, and
        # agg=None executors bind exactly plan.query.head — so the head is
        # part of the executor's identity
        tuple((name, str(p), tuple(p.query.head)) for name, p in stages),
        agg,
        options,
        filter_vars,
        tuple(sorted((a, id(rels[a])) for a in base)),
    )


def _acquire_runner(
    query: Query,
    relations: dict[str, Relation],
    plan_tree,
    *,
    agg: str | None,
    options: ExecOptions,
    filter_vars: tuple[str, ...] = (),
):
    """One planning pass -> one (possibly cached) AdaptiveExecutor.

    A single optimizer.Stats cache feeds the plan choice and
    plan_chain_capacities, the StaticSchedule per stage rides on its
    CapacityPlan into every executor build, and the whole runner is keyed
    in the runner cache by plan structure + head + options + filter vars +
    relation identities. `filter_vars` builds a constant-parameterized
    executor, capacity-planned with FilteredStats for the selected slice.

    Returns (runner, plan_tree): plan_tree is the binary plan actually
    chosen (the caller's, or the optimizer's)."""
    from repro_torch.core.capacity import plan_chain_capacities
    from repro_torch.core.compiled import AdaptiveExecutor, _base_aliases

    rels = dict(relations)
    stats = Stats(rels, cached=True)  # registry-backed distinct counts
    if plan_tree is None:
        # cost-based choice with the measured-cardinality feedback loop;
        # the choice is memoized against the feedback store's version, so
        # steady state pays one cache probe
        plan_tree = JoinOrderOptimizer(
            level=options.optimize_level,
            safety=options.safety,
            compact_threshold=options.compact_threshold,
            feedback=relcache.FEEDBACK,
        ).choose(query, rels, stats=stats)
    stages = stage_plans(query, plan_tree)
    base = sorted(_base_aliases(stages))
    key = _runner_key(stages, rels, base, agg, options, filter_vars)
    runner = _runner_cache.get(key)
    if runner is None:
        pstats = stats
        if filter_vars:
            # kill-mode filters prune the frontier as they apply, so
            # capacity-plan for the selected slice, not the whole relation;
            # this depends only on WHICH vars are filtered, never on the
            # constants, so every query of the template shares the plan
            pstats = FilteredStats(
                stats,
                {a.alias: frozenset(v for v in a.vars if v in filter_vars)
                 for a in query.atoms},
            )
        cap_plan = plan_chain_capacities(
            stages,
            stats=pstats,
            safety=options.safety,
            compact_threshold=options.compact_threshold,
            feedback=relcache.FEEDBACK,
        )
        if len(stages) == 1:  # classic single-stage surface (plain CapacityPlan)
            cap_plan = cap_plan.stages[0]
        plan_arg = stages[0][1] if len(stages) == 1 else tuple(stages)
        runner = AdaptiveExecutor(
            plan_arg,
            cap_plan,
            device=options.device,
            budget=options.budget,
            agg=agg,
            tighten=True,
            filter_vars=filter_vars,
        )
        _runner_cache.put(key, runner, [rels[a] for a in base])
    return runner, plan_tree


def compiled_free_join(
    query: Query,
    relations: dict[str, Relation],
    plan_tree: BinaryPlan | Atom | None = None,
    *,
    agg: str | None = "count",
    options: ExecOptions | None = None,
    filters: dict[str, int] | None = None,
    info: dict | None = None,
):
    """Compiled driver, no manual capacities (see module docstring).

    Zero-row inputs run through the executor natively (an empty relation
    is a trie whose every frontier expansion yields zero live lanes).
    Repeated calls over the same relation objects are the steady-state
    path and pay probe cost only: distinct counts persist in the
    per-relation registry, base tries come from the cross-call
    compiled.TRIE_CACHE, and the whole runner — capacity plan, learned
    growth, built executors — is reused from _runner_cache, so a warm call
    performs zero np.unique, zero trie builds and zero executor builds.

    `filters` ({var: constant}) runs the query under equality selections
    through a constant-parameterized executor: every call with the same
    filtered VARS, whatever the constants, reuses one runner.

    Returns a count for agg="count" (an int, summed in int64), else
    (bound, mult) host numpy arrays over live rows. `info`, if given,
    receives the runner, capacity plan, retry/reshape/compile counters, the
    options and the chosen plan tree (`plan_tree`)."""
    opts = options or ExecOptions()
    filters = dict(filters or {})
    unknown = set(filters) - set(query.variables)
    if unknown:
        raise ValueError(f"filter vars not in the query: {sorted(unknown)}")
    filter_vars = tuple(sorted(filters))
    runner, chosen_tree = _acquire_runner(
        query, relations, plan_tree, agg=agg, options=opts, filter_vars=filter_vars
    )
    consts = (
        np.asarray([filters[v] for v in filter_vars], np.int32) if filter_vars else None
    )
    out = runner.run_relations(dict(relations), filter_consts=consts)
    if info is not None:
        info.update(
            runner=runner,
            cap_plan=runner.cap_plan,
            retries=runner.retries,
            reshapes=runner.reshapes,
            compiles=runner.compiles,
            options=opts,
            plan_tree=chosen_tree,
        )
    return out


def materialize(bound: dict[str, np.ndarray], mult: np.ndarray, head) -> dict[str, np.ndarray]:
    """Expand multiplicities into physical duplicate rows (bag output)."""
    if len(mult) == 0:
        # empty result: later nodes may never have bound their vars
        return {v: bound.get(v, np.zeros(0, dtype=np.int64)) for v in head}
    if mult.max(initial=1) > 1:
        idx = np.repeat(np.arange(len(mult)), mult)
        return {v: bound[v][idx] for v in head}
    return {v: bound[v] for v in head}


def to_sorted_tuples(result, head) -> list:
    bound, mult = result
    cols = materialize(bound, mult, head)
    arrs = [np.asarray(cols[v]) for v in head]
    n = len(arrs[0]) if arrs else 0
    return sorted(tuple(int(a[i]) for a in arrs) for i in range(n))
