"""Top-level drivers of the port: Free Join, Generic Join, binary hash
join, and the compiled Free Join query.

Each driver takes a query, relations, and a binary plan (tree). Bushy plans
are decomposed into left-deep stages (Sec 2.2). The eager drivers
(`free_join`, `binary_join`, `generic_join`) run every stage on the
vectorized engine (core/engine.py, COLT tries on the device) and
materialize every non-root stage into a fresh host relation before its
parent runs — the paper's (intentionally simple) materialization strategy.
They run on the card unless `device="cpu"` is given.

`compiled_free_join` (or `free_join(compiled=True)`) instead runs the
*whole* stage chain as one device program: query -> cost-based binary
plan -> per-stage binary2fj + factor -> capacity.plan_chain_capacities ->
one compiled.AdaptiveExecutor call. Non-root stages execute with the same
static-shape executor as the root (agg=None), their output columns stay on
the device as padded, mult-weighted buffers, and the next stage builds its
trie straight from that buffer. No manual capacities: per-stage buffer
sizes come from the optimizer's estimates capped by the AGM bound, and any
stage's overflow is recovered by growing exactly the offending node and
re-running the chain. `ExecOptions(chain_stages=False)` keeps the hybrid
(non-root stages on the eager engine, root compiled) as a baseline.

`compiled_free_join` has one degradation rung: an error that
`core.faults.recoverable` names (an injected fault, a memory-governor
shed, the CUDA allocator's out-of-memory error) is answered by the eager
`free_join` on the same device, with a RuntimeWarning. Every other error,
a kernel build or launch error among them, propagates to the caller.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import engine, faults, membudget, relcache
from repro_torch.core.engine import materialize
from repro_torch.core.optimizer import (
    FilteredStats,
    JoinOrderOptimizer,
    Stats,
    choose_split,
    key_counts,
    optimize,
)
from repro_torch.core.plan import (
    BinaryPlan,
    FreeJoinPlan,
    decompose_tree,
    gj_plan,
    seed_plan,
    stage_plans,
    var_order_from_fj,
)
from repro_torch.core.trace import TRACE
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
    cardinalities contradict the estimates (optimizer.JoinOrderOptimizer);
    chain_stages: run every stage of a bushy plan on the compiled path
    (False = the hybrid baseline: non-root stages on the eager engine of
    free_join, on the same device, the root compiled); verify: run the
    static plan verifier (repro_torch.analysis.planlint) over every
    freshly planned stage chain and its capacities before the runner is
    built, raising analysis.PlanVerificationError with every finding
    instead of failing opaquely inside the executor. Off by default: the
    lint costs host time on each cold plan, nothing on warm calls."""

    device: str = "cuda"
    budget: int = 32
    safety: float = 2.0
    compact_threshold: float = 0.25
    chain_stages: bool = True
    optimize_level: int = 1
    verify: bool = False


# one release of backwards compatibility: compiled_free_join's old loose
# kwargs still work but warn (collapse them into ExecOptions). The
# reference's impl= and jit= have no counterpart here: device= takes the
# place of impl, and there is no jit to turn off.
_LEGACY_OPTION_KWARGS = ("budget", "safety", "compact_threshold", "chain_stages")


def _resolve_options(options: ExecOptions | None, legacy: dict) -> ExecOptions:
    unknown = sorted(set(legacy) - set(_LEGACY_OPTION_KWARGS))
    if unknown:
        raise TypeError(
            f"compiled_free_join() got unexpected keyword arguments {unknown}; "
            "where it runs is options=ExecOptions(device=...)"
        )
    given = {k: v for k, v in legacy.items() if v is not None}
    if given:
        warnings.warn(
            f"passing {sorted(given)} as loose kwargs is deprecated; "
            "pass options=ExecOptions(...) instead",
            DeprecationWarning,
            stacklevel=3,
        )
    return replace(options or ExecOptions(), **given)


# stage derivation lives in core/plan.py (the optimizer's device cost model
# needs it too); the old private names stay importable
_decompose = decompose_tree
_stage_plans = stage_plans


# warm serving surface: whole AdaptiveExecutors reused across
# compiled_free_join calls, keyed by the query/plan structure + execution
# knobs + the identity of every base relation. Entries are evicted when any
# keyed relation dies (weakref finalizers — see relcache.KeyedCache), so an
# id() reused by a new relation object can never resurrect a stale runner.
_runner_cache = relcache.KeyedCache(max_entries=32)


def _govern_runner(cache, key, runner) -> None:
    """Register a freshly-cached runner with the device-memory governor,
    costed at its frontier footprint. The governor may LRU-evict it later
    (the callback drops the cache entry; an identical query then re-plans),
    and the cache's own eviction paths release the governor entry through
    KeyedCache.on_evict, so the two stores never disagree. A shed (the
    runner alone cannot fit the budget) un-caches it: the current call
    still runs, nothing ungoverned is kept warm."""
    if isinstance(cache, relcache.ScopedCache):
        root, fkey = cache._parent, (cache._tag, key)
    else:
        root, fkey = cache, key
    if root.on_evict is None:
        root.on_evict = lambda k, _v, _root=root: membudget.GOVERNOR.release(
            ("runner", id(_root), k)
        )
    token = ("runner", id(root), fkey)
    try:
        membudget.GOVERNOR.account(
            token,
            runner.frontier_nbytes(),
            evict=lambda _root=root, _k=fkey: _root._evict(_k),
        )
    except membudget.MemoryBudgetError:
        root._evict(fkey)
        return
    runner._govern_token = token


def _runner_key(stages, rels, base, agg, options, filter_vars, batch, max_capacity, seeded):
    return (
        # str(plan) renders the nodes but not the output projection, and
        # agg=None executors bind exactly plan.query.head — so the head is
        # part of the executor's identity
        tuple((name, str(p), tuple(p.query.head)) for name, p in stages),
        agg,
        options,
        filter_vars,
        batch,
        max_capacity,
        seeded,
        tuple(sorted((a, id(rels[a])) for a in base)),
    )


def _run_stages(
    query: Query,
    relations: dict[str, Relation],
    plan_tree: BinaryPlan,
    *,
    fj_mode: str,
    factorize: bool,
    dynamic_cover: bool,
    agg,
    stats: engine.ExecStats | None,
    device,
):
    """Eager stage driver: every stage runs on the vectorized engine,
    non-root stage outputs are materialized into fresh host relations. The
    compiled driver (compiled_free_join) shares stage_plans but routes
    *all* stages through the static-shape executor instead."""
    rels = dict(relations)
    result = None
    for name, fj in stage_plans(query, plan_tree, factorize=factorize):
        is_root = name == "__root"
        out = engine.execute(
            fj,
            rels,
            mode=_trie_modes(fj, fj_mode),
            dynamic_cover=dynamic_cover and factorize,
            agg=agg if is_root else None,
            stats=stats,
            device=device,
        )
        if is_root:
            result = out
        else:
            bound, mult = out
            rels[name] = Relation(name, materialize(bound, mult, fj.query.head))
    return result


def _trie_modes(fj: FreeJoinPlan, fj_mode: str) -> dict[str, str]:
    """Per-relation trie mode. For the binary-join baseline ("binary"):
    hash tables are built eagerly for every probed relation, while pure
    covers (only iterated, single level) build nothing."""
    parts = fj.partitions()
    if fj_mode != "binary":
        return {a: fj_mode for a in parts}
    probed = set()
    for node in fj.nodes:
        for sa in node[1:]:
            if sa.vars:
                probed.add(sa.alias)
    return {a: ("simple" if a in probed else "colt") for a in parts}


def _apply_filters_eager(
    query: Query, relations: dict[str, Relation], filters: dict[str, int]
) -> dict[str, Relation]:
    """Eager-path equality selections: every atom containing a filtered var
    is pre-selected to the rows matching the constant (joins equate the var
    across atoms, so this is exactly sigma_{v=c} of the query result)."""
    unknown = set(filters) - set(query.variables)
    if unknown:
        raise ValueError(f"filter vars not in the query: {sorted(unknown)}")
    rels = dict(relations)
    for a in query.atoms:
        sel = [v for v in a.vars if v in filters]
        if not sel:
            continue
        rel = rels[a.alias]
        mask = np.ones(rel.num_rows, bool)
        for v in sel:
            mask &= rel.columns[v] == filters[v]
        rels[a.alias] = rel.select(mask)
    return rels


def free_join(
    query: Query,
    relations: dict[str, Relation],
    plan_tree: BinaryPlan | None = None,
    *,
    mode: str = "colt",
    agg: str | None = None,
    dynamic_cover: bool = True,
    stats: engine.ExecStats | None = None,
    compiled: bool = False,
    filters: dict[str, int] | None = None,
    options: ExecOptions | None = None,
    device="cuda",
):
    """The full Free Join system: cost-based binary plan -> binary2fj ->
    factor -> COLT + vectorized execution (the paper's Sec 5
    configuration), on `device`.

    compiled=True instead runs the whole plan on the static-shape executor
    with planner-derived capacities (see compiled_free_join, which also
    accepts `options`). The eager-only knobs are rejected loudly on the
    compiled path — `mode` and `dynamic_cover` have no compiled equivalent
    and `stats` (engine.ExecStats) measures the eager engine; silently
    dropping them would misreport what ran. There the device comes from
    `options`, and a `device` that differs from options.device raises.

    filters: equality selections {var: constant}, applied on either path
    (sigma_{v=c} over the join result). options: compiled-path ExecOptions
    (invalid on the eager path). Returns an int for agg="count", else
    (bound, mult) as int64 host numpy arrays."""
    if compiled:
        dropped = []
        if mode != "colt":
            dropped.append(f"mode={mode!r}")
        if dynamic_cover is not True:
            dropped.append(f"dynamic_cover={dynamic_cover!r}")
        if stats is not None:
            dropped.append("stats (use compiled_free_join(info=...) instead)")
        if dropped:
            raise ValueError(
                "free_join(compiled=True) does not honor the eager-path "
                "arguments " + ", ".join(dropped)
            )
        if options is None:
            options = ExecOptions(device=device)
        elif torch.device(options.device) != torch.device(device):
            raise ValueError(
                f"free_join(compiled=True): device={device!r} differs from "
                f"options.device={options.device!r}"
            )
        return compiled_free_join(
            query, relations, plan_tree, agg=agg, filters=filters, options=options
        )
    if options is not None:
        raise ValueError("options=ExecOptions(...) applies to the compiled path only")
    if filters:
        relations = _apply_filters_eager(query, relations, filters)
    if plan_tree is None:
        plan_tree = optimize(query, relations)
    return _run_stages(
        query,
        relations,
        plan_tree,
        fj_mode=mode,
        factorize=True,
        dynamic_cover=dynamic_cover,
        agg=agg,
        stats=stats,
        device=device,
    )


def _as_rows(a: np.ndarray) -> np.ndarray:
    """(n, F) integers -> n void scalars, equal where the rows are."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    return a.view(np.dtype((np.void, 8 * a.shape[1]))).ravel()


def _seeds_select_fewer_rows(plan: FreeJoinPlan, rels, filter_vars, seeds) -> bool:
    """Does the plan's first cover bind every filter var (seed_plan's
    condition), and do a batch's constants (n, F, in filter_vars order),
    duplicates counted, select fewer rows of its relation than it holds?
    A seeded lane expands the rows its constants select, and a mask-mode
    dispatch scans all of that relation's rows once for every lane, so
    below that total seeded lanes do less work, and at or above it (hubs,
    repeated constants) mask mode does."""
    cover = next(sa for sa in plan.covers(0) if sa.vars)
    rel = rels[cover.alias]
    if not set(filter_vars) <= set(cover.vars) or not rel.num_rows:
        return False
    keys, counts = key_counts(rel, tuple(filter_vars))
    seeds = np.asarray(seeds)
    q = seeds[:, 0] if len(filter_vars) == 1 else _as_rows(seeds)
    at = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    return int(counts[at][keys[at] == q].sum()) < rel.num_rows


def _acquire_runner(
    query: Query,
    relations: dict[str, Relation],
    plan_tree,
    *,
    agg: str | None,
    options: ExecOptions,
    filter_vars: tuple[str, ...] = (),
    batch: int | None = None,
    max_capacity: int | None = None,
    seeds=None,
    cache=None,
):
    """One planning pass -> one (possibly cached) AdaptiveExecutor.

    The runner-acquisition surface behind compiled_free_join AND the join
    serving engine. A single optimizer.Stats cache feeds the plan choice
    and plan_chain_capacities, the StaticSchedule per stage rides on its
    CapacityPlan into every executor build, and the whole runner is keyed
    in the runner cache by plan structure + head + options + filter vars +
    batch width + growth quota + relation identities. `filter_vars` builds
    a constant-parameterized executor (kill mode: capacity-planned with
    FilteredStats for the selected slice); `batch` builds the mask-mode
    multi-lane variant (planned on plain stats: its frontier layout is the
    unfiltered one); `max_capacity` arms the per-node growth quota
    (admission control). `seeds`, the (n, F) constants of the dispatch
    to come, asks a batched runner for seeded lanes
    (compiled.SeededExecutor over plan.seed_plan, capacities from
    FilteredStats for all `batch` lanes), which it gets when the plan is
    one stage whose first node's cover binds every filter var, no quota
    is armed, and the seeds select fewer rows of that cover's relation
    than it holds (_seeds_select_fewer_rows); otherwise it is the
    mask-mode runner. `cache`
    defaults to the verbatim runner cache; the serving engine passes its
    template-scoped namespace.

    Returns (runner, rels, cacheable, plan_tree): rels is the relation dict
    the runner should execute over (the hybrid baseline materializes its
    eager stages into it), cacheable=False marks hybrid multi-stage runs
    whose per-call stage relations make caching useless, and plan_tree is
    the binary plan actually chosen (the caller's, or the optimizer's)."""
    with TRACE.plan_acquire:
        from repro_torch.core.capacity import lane_budget, plan_chain_capacities
        from repro_torch.core.compiled import AdaptiveExecutor, SeededExecutor, _base_aliases

        cache = _runner_cache if cache is None else cache
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
        # the hybrid path materializes fresh stage relations per call — a cache
        # entry keyed on them could never hit (and its put would evict a live
        # runner), so don't store one
        cacheable = options.chain_stages or len(stages) == 1
        if not cacheable:
            if filter_vars:
                raise ValueError("filters require chain_stages=True (the hybrid "
                                 "baseline's eager stages cannot parameterize constants)")
            # hybrid baseline: non-root stages on the eager engine, root compiled
            for name, fj in stages[:-1]:
                bound, mult = engine.execute(
                    fj, rels, mode=_trie_modes(fj, "colt"), agg=None, device=options.device
                )
                rels[name] = Relation(name, materialize(bound, mult, fj.query.head))
            stages = stages[-1:]
        base = sorted(_base_aliases(stages))
        seeded = bool(
            seeds is not None and batch and filter_vars and max_capacity is None
            and len(stages) == 1
            and _seeds_select_fewer_rows(stages[0][1], rels, filter_vars, seeds)
        )
        key = _runner_key(
            stages, rels, base, agg, options, filter_vars, batch, max_capacity, seeded
        )
        runner = cache.get(key) if cacheable else None
        if runner is None:
            pstats = stats
            if filter_vars and (batch is None or seeded):
                # kill-mode filters prune the frontier as they apply, so
                # capacity-plan for the selected slice, not the whole relation;
                # this depends only on WHICH vars are filtered, never on the
                # constants, so every query of the template shares the plan.
                # Seeded lanes follow the selection too, one query a lane.
                # Batched (mask-mode) runners keep the unfiltered frontier
                # layout, shared across lanes, so plain stats size them right
                pstats = FilteredStats(
                    stats,
                    {a.alias: frozenset(v for v in a.vars if v in filter_vars)
                     for a in query.atoms},
                )
            with TRACE.plan_capacity:
                # a partly bound lookup split into a probe and a further
                # cover, chosen per lane, where the estimate says it
                # expands fewer lanes (a function of the plan and the
                # relations, so the key above names the runner still)
                stages = [(name, choose_split(fj, stats)) for name, fj in stages]
                seed = seed_plan(stages[0][1], filter_vars) if seeded else None
                if seed is not None:  # the seeded plan runs in the template's place
                    stages = [(stages[0][0], seed)]
                cap_plan = plan_chain_capacities(
                    stages,
                    stats=pstats,
                    safety=options.safety,
                    compact_threshold=options.compact_threshold,
                    feedback=relcache.FEEDBACK,
                    lanes=batch if seed is not None else 1,
                    lane_budget=lane_budget(options.device),
                )
            if options.verify:
                # full pre-build verification: plan structure, schedules,
                # capacities, stage DAG, filter coverage — findings raised as
                # one PlanVerificationError instead of a failure mid-run
                from repro_torch.analysis.planlint import lint_chain

                lint_chain(
                    stages, cap_plan, filter_vars=filter_vars, batch=batch
                ).raise_errors()
            if len(stages) == 1:  # classic single-stage surface (plain CapacityPlan)
                cap_plan = cap_plan.stages[0]
            plan_arg = stages[0][1] if len(stages) == 1 else tuple(stages)
            if seed is not None:
                runner = SeededExecutor(
                    seed,
                    cap_plan,
                    device=options.device,
                    budget=options.budget,
                    agg=agg,
                    filter_vars=filter_vars,
                    batch=batch,
                )
            else:
                runner = AdaptiveExecutor(
                    plan_arg,
                    cap_plan,
                    device=options.device,
                    budget=options.budget,
                    agg=agg,
                    tighten=True,
                    filter_vars=filter_vars,
                    batch=batch,
                    max_capacity=max_capacity,
                )
            if cacheable:
                cache.put(key, runner, [rels[a] for a in base])
                _govern_runner(cache, key, runner)
        return runner, rels, cacheable, plan_tree


def compiled_free_join(
    query: Query,
    relations: dict[str, Relation],
    plan_tree: BinaryPlan | Atom | None = None,
    *,
    agg: str | None = "count",
    options: ExecOptions | None = None,
    filters: dict[str, int] | None = None,
    info: dict | None = None,
    **legacy,
):
    """Compiled driver, no manual capacities (see module docstring).

    Execution knobs ride in `options` (ExecOptions); the old loose kwargs
    budget/safety/compact_threshold/chain_stages (`legacy`) still work for
    one release behind a DeprecationWarning; any other keyword, such as the
    reference's impl= or jit=, raises TypeError: the device is chosen by
    ExecOptions(device=...).

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

    ExecOptions(chain_stages=False) runs the hybrid baseline instead: the
    non-root stages of a bushy plan on the eager engine (free_join's), on
    the same device, their outputs materialized into host relations, and
    the root compiled over them.

    The degradation ladder's bottom rung: if the run raises an error that
    faults.recoverable names (an injected fault, a MemoryBudgetError, a
    torch.OutOfMemoryError), the query is answered by the eager free_join
    over live-row snapshots, on the SAME device as the runner, with a
    RuntimeWarning, and `info` gets degraded_to="eager" and degraded_from.
    There is no CPU rung: a real out-of-memory error on the eager rung
    propagates too. Any other error (a kernel build or launch error, a
    ValueError, a CapacityQuotaError) propagates untouched.

    Returns a count for agg="count" (an int, summed in int64), else
    (bound, mult) host numpy arrays over live rows. `info`, if given,
    receives the runner, capacity plan, retry/reshape/compile counters, the
    options and the chosen plan tree (`plan_tree`)."""
    with TRACE.query:
        opts = _resolve_options(options, legacy)
        filters = dict(filters or {})
        unknown = set(filters) - set(query.variables)
        if unknown:
            raise ValueError(f"filter vars not in the query: {sorted(unknown)}")
        filter_vars = tuple(sorted(filters))
        runner, rels, cacheable, chosen_tree = _acquire_runner(
            query, relations, plan_tree, agg=agg, options=opts, filter_vars=filter_vars
        )
        consts = (
            np.asarray([filters[v] for v in filter_vars], np.int32) if filter_vars else None
        )
        # the hybrid baseline's stage relations are fresh every call: its
        # root builds its tries in the run (caching would only insert
        # dead-on-arrival entries)
        degraded = None
        try:
            out = runner.run_relations(rels, reuse_tries=cacheable, filter_consts=consts)
        except Exception as e:
            if not faults.recoverable(e):
                raise
            warnings.warn(
                f"compiled path degraded to eager free_join after {type(e).__name__}: {e}",
                RuntimeWarning,
                stacklevel=2,
            )
            degraded = f"{type(e).__name__}: {e}"
            tree = chosen_tree if isinstance(chosen_tree, BinaryPlan) else None
            live = {a: relcache.live_relation(r) for a, r in relations.items()}
            out = free_join(query, live, tree, agg=agg, filters=filters or None, device=opts.device)
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
            if degraded is not None:
                info.update(degraded_to="eager", degraded_from=degraded)
        return out


def binary_join(
    query: Query,
    relations: dict[str, Relation],
    plan_tree: BinaryPlan | None = None,
    *,
    agg: str | None = None,
    stats: engine.ExecStats | None = None,
    device="cuda",
):
    """Baseline 1: classic binary hash join == the unfactored binary2fj plan
    with eagerly-built hash tables (Sec 5.3: 'if we do not optimize the Free
    Join plan ... Free Join would behave identically to binary join')."""
    if plan_tree is None:
        plan_tree = optimize(query, relations)
    return _run_stages(
        query,
        relations,
        plan_tree,
        fj_mode="binary",
        factorize=False,
        dynamic_cover=False,
        agg=agg,
        stats=stats,
        device=device,
    )


def generic_join(
    query: Query,
    relations: dict[str, Relation],
    var_order: list[str] | None = None,
    plan_tree: BinaryPlan | None = None,
    *,
    agg: str | None = None,
    stats: engine.ExecStats | None = None,
    device="cuda",
):
    """Baseline 2: Generic Join — full trie construction for every relation,
    variable-at-a-time plan. Variable order defaults to the one induced by
    the Free Join plan (Sec 5.1)."""
    if var_order is None:
        if plan_tree is None:
            plan_tree = optimize(query, relations)
        order: list[str] = []
        for _name, fj in stage_plans(query, plan_tree):
            for v in var_order_from_fj(fj):
                if v not in order:
                    order.append(v)
        var_order = [v for v in order if v in query.variables]
    plan = gj_plan(query, var_order)
    return engine.execute(
        plan, relations, mode="simple", dynamic_cover=True, agg=agg, stats=stats,
        device=device,
    )


def to_sorted_tuples(result, head) -> list:
    bound, mult = result
    cols = materialize(bound, mult, head)
    arrs = [np.asarray(cols[v]) for v in head]
    n = len(arrs[0]) if arrs else 0
    return sorted(tuple(int(a[i]) for a in arrs) for i in range(n))
