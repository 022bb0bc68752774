"""Standing queries over streaming ingest: incremental view maintenance.

JoinServeEngine answers a query once; this engine keeps queries ANSWERED —
each registered query's result is maintained as the base relations mutate
through the relcache delta API (append/delete): a continuous workload
served by one engine for both plan shapes (Kaboli et al., arXiv
2505.19918), built from three pieces:

* The versioned TRIE CACHE (compiled.TrieCache): a refresh over a mutated
  base relation pays one delta merge (sort the delta, splice the sorted
  run) or tombstone weight refresh — never a full rebuild.
* STAGE-BUFFER FINGERPRINTS: a bushy plan's stages are driven here by one
  AdaptiveExecutor each, instead of one fused chain program, exactly so a
  stage's inputs can be fingerprinted between runs. A stage's fingerprint
  covers every input: base relations by mutation version (or column object
  identity for never-mutated ones) and upstream stages by their run
  counter. Unchanged fingerprint -> the stage is SKIPPED and its cached
  device output buffers (and the weighted tries consumers built from them)
  are replayed verbatim; only the stages downstream of an actually-changed
  input recompute.
* PLAN TEMPLATES (serve.templates.canonicalize): standing queries are
  registered through the same canonicalization as JoinServeEngine
  requests, so two tenants' spellings of one query share a single set of
  per-stage runners, with the lifted constants as the only per-query
  state.

The observable contract (tests lock the counters): ingest into a relation
only the root stage reads recomputes exactly that stage; a refresh with no
mutations at all recomputes nothing.

A refresh whose compiled run raises an error that core.faults.recoverable
names, or a CapacityQuotaError, is answered by the eager free_join on the
same device (`degraded_to = "eager"`, `degraded_refreshes` counts it), and
every stage state is cleared so the next refresh rebuilds the compiled
pipeline. Any other error (a kernel build or launch error) propagates.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import faults, relcache
from repro_torch.core.api import ExecOptions, free_join
from repro_torch.core.capacity import CapacityQuotaError, plan_chain_capacities
from repro_torch.core.compiled import (
    PAD_KEY,
    TRIE_CACHE,
    AdaptiveExecutor,
    build_trie,
    device_columns,
    materialize_compiled,
)
from repro_torch.core.optimizer import JoinOrderOptimizer, Stats
from repro_torch.core.plan import BinaryPlan, stage_plans
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Query
from repro_torch.serve.templates import PlanTemplate, canonicalize


class _StageState:
    """Per-query, per-stage maintenance state: the last run's fingerprint,
    the cached device output buffers (non-root stages), the weighted tries
    consumers built from them (keyed by consumer level layout), and the run
    counter downstream fingerprints embed."""

    __slots__ = ("fingerprint", "out", "tries", "runs")

    def __init__(self):
        self.fingerprint = None
        self.out = None  # (bound, valid, mult) device buffers
        self.tries: dict = {}  # (levels, probed) -> weighted StaticTrie
        self.runs = 0


def _fp_equal(a, b) -> bool:
    """Fingerprint comparison. Column entries are numpy arrays compared by
    IDENTITY — `==` would be elementwise, and the fingerprint holding the
    strong reference is what makes identity sound (no id() reuse while the
    old fingerprint is alive)."""
    if a is None or b is None or len(a) != len(b):
        return False
    for pa, pb in zip(a, b):
        if len(pa) != len(pb):
            return False
        for xa, xb in zip(pa, pb):
            if isinstance(xa, np.ndarray) or isinstance(xb, np.ndarray):
                if xa is not xb:
                    return False
            elif xa != xb:
                return False
    return True


@dataclasses.dataclass
class StandingQuery:
    """Handle for one registered query: `result` always holds the answer as
    of the last refresh; `result_version` bumps each time a refresh actually
    recomputed the root stage."""

    qid: int
    template: PlanTemplate
    consts: np.ndarray
    states: list[_StageState]
    stage_consts: list[np.ndarray | None]
    result: object = None
    result_version: int = 0
    # "eager" while the last refresh was answered by the eager engine after
    # a recoverable fault; cleared by the next successful compiled root
    # recompute
    degraded_to: str | None = None

    @property
    def states_by_name(self) -> dict:
        return dict(zip(self._stage_names, self.states))

    _stage_names: tuple = ()


class StandingQueryEngine:
    """register() standing queries, refresh() their results incrementally.

    Pass `engine=` a JoinServeEngine to share its ExecOptions (so templates
    canonicalized here carry the same key a submit() of the same query
    would); otherwise supply `options` directly (default: on the card).
    Per-stage runners are cached per template key: every standing query of
    one template shares them, constants being the only per-query input.

    `ingest(rel, delta_cols)` is the streaming front door: one
    relcache.append (delta trie merge downstream) followed by a refresh of
    every registered query. Counters: `stage_runs` (stage executions),
    `stages_skipped` (fingerprint hits that replayed cached buffers),
    `stages_recomputed` (fingerprint misses)."""

    def __init__(
        self,
        *,
        engine=None,
        options: ExecOptions | None = None,
    ):
        self.options = engine.options if engine is not None else (options or ExecOptions())
        self.queries: list[StandingQuery] = []
        self._next_qid = 0
        # template key -> tuple of (name, plan, AdaptiveExecutor, stage filter
        # vars with their index into the template's consts vector)
        self._runners: dict = {}
        self.stage_runs = 0
        self.stages_skipped = 0
        self.stages_recomputed = 0
        # refreshes answered by the eager engine after a recoverable fault:
        # the result stays correct, the counter says the compiled path
        # needs attention
        self.degraded_refreshes = 0

    # ---- intake -------------------------------------------------------
    def register(
        self,
        query: Query,
        relations: dict[str, Relation],
        filters: dict[str, int] | None = None,
        *,
        agg: str | None = "count",
        plan_tree=None,
    ) -> StandingQuery:
        """Canonicalize, plan, and compute the initial result. The returned
        handle's `result` is live: each refresh() updates it in place."""
        template, consts = canonicalize(
            query, relations, filters, plan_tree=plan_tree, agg=agg, options=self.options
        )
        runners = self._acquire_stage_runners(template)
        sq = StandingQuery(
            qid=self._next_qid,
            template=template,
            consts=consts,
            states=[_StageState() for _ in runners],
            stage_consts=[
                np.asarray([consts[idx] for _v, idx in fv], np.int32) if fv else None
                for _n, _p, _r, fv in runners
            ],
        )
        sq._stage_names = tuple(n for n, _p, _r, _fv in runners)
        self._next_qid += 1
        self.queries.append(sq)
        self._refresh_query(sq, runners)
        return sq

    def _acquire_stage_runners(self, template: PlanTemplate):
        runners = self._runners.get(template.key)
        if runners is not None:
            return runners
        o = template.options
        rels = dict(template.relations)
        stats = Stats(rels, cached=True)
        tree = template.plan_tree
        if tree is None:
            tree = JoinOrderOptimizer(
                level=o.optimize_level,
                safety=o.safety,
                compact_threshold=o.compact_threshold,
                feedback=relcache.FEEDBACK,
            ).choose(template.query, rels, stats=stats)
        stages = stage_plans(template.query, tree)
        chain = plan_chain_capacities(
            stages,
            stats=stats,
            safety=o.safety,
            compact_threshold=o.compact_threshold,
            feedback=relcache.FEEDBACK,
        )
        # first-binder filter assignment, mirroring make_chain_executor: a
        # var's selection runs in the first stage that binds it, and dead
        # rows carry mult 0 into every downstream weighted trie
        unassigned = {v: i for i, v in enumerate(template.filter_vars)}
        built = []
        for i, ((name, plan), cp) in enumerate(zip(stages, chain.stages)):
            fv = tuple(
                (v, unassigned.pop(v))
                for v in tuple(plan.query.variables)
                if v in unassigned
            )
            runner = AdaptiveExecutor(
                plan,
                cp,
                device=o.device,
                budget=o.budget,
                agg=template.agg if i == len(stages) - 1 else None,
                tighten=True,
                filter_vars=tuple(v for v, _ in fv),
            )
            built.append((name, plan, runner, fv))
        if unassigned:
            raise ValueError(f"filter vars bound by no stage: {sorted(unassigned)}")
        runners = tuple(built)
        self._runners[template.key] = runners
        return runners

    # ---- maintenance --------------------------------------------------
    def ingest(self, rel: Relation, delta_cols: dict) -> list[StandingQuery]:
        """Append a delta through the relcache mutation API, then refresh
        every standing query. Returns the queries whose result changed."""
        relcache.append(rel, delta_cols)
        return self.refresh()

    def refresh(self) -> list[StandingQuery]:
        """Re-maintain every registered query: stages whose fingerprints
        moved recompute (delta-merged tries flowing in from the trie
        cache), the rest replay cached buffers. Returns the queries whose
        root stage actually re-ran."""
        changed = []
        for sq in self.queries:
            if self._refresh_query(sq, self._runners[sq.template.key]):
                changed.append(sq)
        return changed

    def _refresh_query(self, sq: StandingQuery, runners) -> bool:
        rels = sq.template.relations
        states_by_name = sq.states_by_name
        root_changed = False
        for i, (_name, plan, runner, _fv) in enumerate(runners):
            state = sq.states[i]
            stage_names = set(sq._stage_names[:i])
            fp = self._stage_fp(plan, stage_names, rels, states_by_name)
            is_root = i == len(runners) - 1
            self.stage_runs += 1
            if _fp_equal(fp, state.fingerprint) and (is_root or state.out is not None):
                self.stages_skipped += 1
                continue
            self.stages_recomputed += 1
            try:
                data = self._stage_data(plan, stage_names, rels, runner, states_by_name)
                out = runner(data, sq.stage_consts[i])
            except Exception as e:
                # a standing query has no co-batched tenants to protect, so
                # a runtime capacity quota degrades like a device fault:
                # answer from the eager engine, keep the result live
                if not (faults.recoverable(e) or isinstance(e, CapacityQuotaError)):
                    raise
                self._recover_eager(sq)
                return True
            if is_root:
                if sq.template.agg == "count":
                    sq.result = int(out.item())  # the refresh's one read-back
                else:
                    sq.result = materialize_compiled(*out)
                sq.result_version += 1
                sq.degraded_to = None
                root_changed = True
            else:
                state.out = out
                state.tries = {}  # consumers rebuild from the fresh buffers
            state.fingerprint = fp
            state.runs += 1
        return root_changed

    def _recover_eager(self, sq: StandingQuery) -> None:
        """Fault recovery: answer the query on the eager engine over
        live-row snapshots, on the template's device, and invalidate every
        cached stage state, so the next refresh rebuilds the compiled
        pipeline from scratch (clearing `degraded_to` if it succeeds)."""
        t = sq.template
        filters = {v: int(c) for v, c in zip(t.filter_vars, sq.consts)}
        tree = t.plan_tree if isinstance(t.plan_tree, BinaryPlan) else None
        rels = {a: relcache.live_relation(r) for a, r in t.relations.items()}
        out = free_join(
            t.query, rels, tree, agg=t.agg, filters=filters or None, device=t.options.device
        )
        sq.result = int(out) if t.agg == "count" else out
        sq.result_version += 1
        sq.degraded_to = "eager"
        self.degraded_refreshes += 1
        for state in sq.states:
            state.fingerprint = None
            state.out = None
            state.tries = {}

    def _stage_fp(self, plan, stage_names, rels, states_by_name):
        """One stage's input fingerprint: upstream stages by run counter,
        base relations by mutation version (strong column refs make the
        identity comparison in _fp_equal sound for never-mutated ones)."""
        parts = []
        for a in sorted({sa.alias for node in plan.nodes for sa in node}):
            if a in stage_names:
                parts.append((a, "stage", states_by_name[a].runs))
                continue
            rel = rels[a]
            st = relcache.mutation_state(rel)
            if st is not None:
                parts.append((a, "mut", id(rel), st.version))
            else:
                parts.append((a, "cols", *(rel.columns[v] for v in rel.schema)))
        return tuple(parts)

    def _stage_data(self, plan, stage_names, rels, runner, states_by_name):
        """Assemble the stage's rel_data dict: base aliases from the
        delta-aware trie cache (or live-row columns when the schedule reads
        raw), upstream stage aliases as weighted tries built once per
        upstream run from the cached output buffers."""
        data = {}
        for a in {sa.alias for node in plan.nodes for sa in node}:
            if a in stage_names:
                up = states_by_name[a]
                lo = runner.schedule.level_ops[a]
                key = (lo.levels, lo.probed)
                trie = up.tries.get(key)
                if trie is None:
                    bound, valid, mult = up.out
                    flat = [v for lv in lo.levels for v in lv]
                    cols = {v: torch.where(valid, bound[v], PAD_KEY) for v in flat}
                    w = torch.where(valid, mult, 0).to(torch.int32)
                    trie = build_trie(cols, lo, budget=runner.budget, mult=w)
                    up.tries[key] = trie
                data[a] = trie
                continue
            rel = rels[a]
            lo = runner._alias_lops.get(a)
            if lo is not None:
                data[a] = TRIE_CACHE.get(
                    rel, device_columns(rel, runner.device), lo, budget=runner.budget
                )
            else:
                data[a] = device_columns(relcache.live_relation(rel), runner.device)
        return data
