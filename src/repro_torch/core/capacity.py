"""Capacity planning for the compiled (static-shape) Free Join path.

The compiled executor (core/compiled.py) runs every plan node into a
fixed-capacity frontier buffer; picking those capacities used to be the
caller's problem. This module derives them from the optimizer's per-prefix
cardinality estimates (optimizer.estimate_prefixes), capped by the AGM
bound of the prefix sub-query — the estimates give the expected frontier,
the AGM bound gives a sound worst case, and a safety factor in between
absorbs estimation error. Capacities are rounded up to the kernel block
size so the kernels' launch grids stay aligned.

The planner also schedules *frontier compaction*: when a node's probes are
estimated to kill enough lanes that the live fraction drops below a
threshold, the plan records a compacted (smaller) capacity for the frontier
going into the next node; the runner squeezes the valid lanes densely into
that buffer (kernels/compact.py), so all later nodes pay for live rows
rather than for the largest buffer ever allocated.

Under-estimates are recoverable: the executor reports every node's
*required* total and the adaptive runner jumps exactly the offending
capacity to that need and retries (see compiled.AdaptiveExecutor), so
the plan here only has to be right on average, not in the worst case.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from scipy.optimize import linprog as _linprog

from repro_torch.core.optimizer import NodeEstimate, StageStats, Stats, estimate_prefixes, stage_est
from repro_torch.core.plan import FreeJoinPlan
from repro_torch.kernels.csr_expand import OBLK
from repro_torch.relational.relation import Relation


# AGM bounds are pure functions of (hyperedges, sizes) and each linprog call
# costs host milliseconds; planning calls agm_bound once per node *and* once
# per probe prefix, so a repeated query re-derives identical bounds every
# call. Memoized process-wide (bounded), the per-call planning pass costs
# dict lookups — part of dropping build/planning cost out of warm calls.
_agm_cache: dict[tuple, float] = {}
_AGM_CACHE_MAX = 4096


def agm_bound(edges: dict[str, tuple[str, ...]], sizes: dict[str, float]) -> float:
    """AGM bound of a join: min over fractional edge covers x of
    prod_R |R|^x_R, via the LP  min sum x_R log|R|  s.t. every variable is
    covered. Falls back to a greedy integral cover (still a valid upper
    bound, just looser) when the LP does not solve. Memoized on the exact
    (edges, sizes) contents."""
    aliases = [a for a, vs in edges.items() if vs]
    variables = sorted({v for a in aliases for v in edges[a]})
    if not aliases or not variables:
        return 1.0
    memo_key = (
        tuple(sorted((a, tuple(edges[a])) for a in aliases)),
        tuple(sorted((a, float(sizes[a])) for a in aliases)),
    )
    hit = _agm_cache.get(memo_key)
    if hit is not None:
        return hit
    logs = [math.log(max(1.0, sizes[a])) for a in aliases]
    bound = None
    a_ub = [[-1.0 if v in edges[a] else 0.0 for a in aliases] for v in variables]
    res = _linprog(logs, A_ub=a_ub, b_ub=[-1.0] * len(variables), bounds=(0, 1), method="highs")
    if res.status == 0:
        bound = float(math.exp(res.fun))
    if bound is None:
        cover = 0.0
        for v in variables:  # greedy integral cover: cheapest edge per variable
            cover += min(lg for a, lg in zip(aliases, logs) if v in edges[a])
        bound = float(math.exp(min(cover, sum(logs))))
    if len(_agm_cache) >= _AGM_CACHE_MAX:
        _agm_cache.clear()
    _agm_cache[memo_key] = bound
    return bound


def _round_block(x: float, block: int) -> int:
    return max(block, int(math.ceil(x / block)) * block)


def node_agm_bounds(schedule, sizes: dict[str, float]) -> list[float]:
    """AGM bound of each executed node's prefix sub-query, in schedule
    order: the bound is taken right after the node's cover level is
    consumed (exactly where plan_capacities caps the expansion buffer),
    then the node's probes extend the prefix for the next node. Shared by
    the capacity planner's sizing walk and the static verifier
    (repro_torch.analysis.planlint), so "capacity exceeds the AGM cap"
    means the same thing in both places."""
    prefix: dict[str, tuple[str, ...]] = {a: () for a in sizes}
    out: list[float] = []
    for _k, cover, probes in schedule:
        prefix[cover.alias] = prefix[cover.alias] + tuple(cover.vars)
        out.append(agm_bound(prefix, sizes))
        for sa in probes:
            prefix[sa.alias] = prefix[sa.alias] + tuple(sa.vars)
    return out


class CapacityQuotaError(RuntimeError):
    """A query's frontier requirement exceeded its admission quota.

    Raised by the adaptive runner *instead of* growing a buffer past
    `max_capacity`: under multi-tenant serving, growing the shared batched
    executor for one pathological query would stall every co-batched
    tenant, so the runner surfaces the violation and lets the serving layer
    reject exactly the offending request. `lane` identifies the batch lane
    whose reported need drove the violation (None for unbatched runs)."""

    def __init__(self, stage: int, node: int, need: int, cap: int, lane: int | None = None):
        self.stage = stage
        self.node = node
        self.need = need
        self.cap = cap
        self.lane = lane
        who = f" (batch lane {lane})" if lane is not None else ""
        super().__init__(
            f"stage {stage} node {node} needs {need} frontier lanes, "
            f"over the {cap}-lane capacity quota{who}"
        )


@dataclass(frozen=True)
class CapacityPlan:
    """Static per-node frontier sizing for one compiled plan.

    capacities[i] is the expansion buffer for the i-th executed node;
    compact_to[i] (or None) is the capacity the frontier is squeezed into
    at that node's compact point. compact_probe[i] says where that point
    is: the number of probes run before compacting — mid-node when an early
    probe is predicted to kill most lanes (the remaining probes then run at
    the compacted width, budget x fewer gather rounds each), len(probes)
    for after the whole node. estimates/agm record where the numbers came
    from (estimates per node, AGM bound of the node's prefix sub-query)."""

    capacities: tuple[int, ...]
    compact_to: tuple[int | None, ...]
    compact_probe: tuple[int, ...] = ()
    estimates: tuple[NodeEstimate, ...] = ()
    agm: tuple[float, ...] = ()
    block: int = OBLK
    # the query's StaticSchedule, computed once by the planner and reused by
    # every executor build (AdaptiveExecutor, spmd_count)
    schedule: object = field(default=None, compare=False, repr=False)

    def grow(self, node: int, *, compaction: bool = False) -> "CapacityPlan":
        """Double one node's capacity. Growing a compaction target past its
        node capacity disables that compaction instead."""
        if compaction:
            cur = self.compact_to[node]
            new = None if cur is None or 2 * cur >= self.capacities[node] else 2 * cur
            ct = tuple(new if i == node else c for i, c in enumerate(self.compact_to))
            return replace(self, compact_to=ct)
        caps = tuple(2 * c if i == node else c for i, c in enumerate(self.capacities))
        # a bigger buffer lowers the live fraction; keep compaction targets
        ct = tuple(
            None if i == node and c is not None and c >= caps[node] else c
            for i, c in enumerate(self.compact_to)
        )
        return replace(self, capacities=caps, compact_to=ct)

    def grow_to(self, node: int, need: int, *, compaction: bool = False) -> "CapacityPlan":
        """Jump one node's capacity straight to a reported requirement (the
        executor returns exact per-node totals), block-rounded. At least
        doubles, so needs under-measured behind an upstream overflow still
        make geometric progress. A compaction target grown past its node
        capacity is disabled instead."""
        need = int(need)
        if compaction:
            cur = self.compact_to[node]
            if cur is None:
                return self
            new = max(2 * cur, _round_block(need, self.block))
            ct = tuple(
                (None if new >= self.capacities[node] else new) if i == node else c
                for i, c in enumerate(self.compact_to)
            )
            return replace(self, compact_to=ct)
        new = max(2 * self.capacities[node], _round_block(need, self.block))
        caps = tuple(new if i == node else c for i, c in enumerate(self.capacities))
        ct = tuple(
            None if i == node and c is not None and c >= caps[node] else c
            for i, c in enumerate(self.compact_to)
        )
        return replace(self, capacities=caps, compact_to=ct)

    def shrink_to(self, node: int, need: int, *, compaction: bool = False) -> "CapacityPlan":
        """Tighten one node's capacity (or compaction target) down to a
        *measured* requirement, block-rounded — the adaptive runner's
        response to a buffer that ran mostly empty. Callers only shrink
        when the buffer exceeds twice the rounded need, so a later small
        overflow's grow_to (which at least doubles) lands back inside the
        hysteresis band instead of oscillating."""
        new = _round_block(max(1, int(need)), self.block)
        if compaction:
            cur = self.compact_to[node]
            if cur is None or new >= cur:
                return self
            ct = tuple(new if i == node else c for i, c in enumerate(self.compact_to))
            return replace(self, compact_to=ct)
        if new >= self.capacities[node]:
            return self
        caps = tuple(new if i == node else c for i, c in enumerate(self.capacities))
        # a compaction target at or above the shrunk capacity is pointless
        ct = tuple(
            None if i == node and c is not None and c >= caps[node] else c
            for i, c in enumerate(self.compact_to)
        )
        return replace(self, capacities=caps, compact_to=ct)

    def cells(self) -> int:
        """Total planned frontier cells, the admission-control currency:
        quotas compare this against a per-query budget before any run."""
        return int(sum(self.capacities))

    def __str__(self):
        parts = []
        for i, (cap, ct) in enumerate(zip(self.capacities, self.compact_to)):
            at = f"@p{self.compact_probe[i]}" if ct is not None and self.compact_probe else ""
            parts.append(f"n{i}:{cap}" + (f"->{ct}{at}" if ct is not None else ""))
        return "CapacityPlan[" + ", ".join(parts) + "]"


@dataclass(frozen=True)
class ChainCapacityPlan:
    """Capacity plans for a whole bushy plan run as one compiled chain:
    one CapacityPlan per stage, root last (`names` aligned). The adaptive
    runner grows exactly the offending (stage, node) pair; growing any
    stage recompiles the chain, because a stage's output buffer width is a
    static shape of every downstream trie build."""

    names: tuple[str, ...]
    stages: tuple["CapacityPlan", ...]

    def key(self) -> tuple:
        """Hashable identity of every static shape in the chain (the
        executor-cache key)."""
        return tuple(
            (cp.capacities, cp.compact_to, cp.compact_probe) for cp in self.stages
        )

    def grow_to(self, stage: int, node: int, need: int, *, compaction: bool = False):
        cp = self.stages[stage].grow_to(node, need, compaction=compaction)
        if cp is self.stages[stage]:
            return self
        return replace(
            self, stages=tuple(cp if i == stage else c for i, c in enumerate(self.stages))
        )

    def shrink_to(self, stage: int, node: int, need: int, *, compaction: bool = False):
        cp = self.stages[stage].shrink_to(node, need, compaction=compaction)
        if cp is self.stages[stage]:
            return self
        return replace(
            self, stages=tuple(cp if i == stage else c for i, c in enumerate(self.stages))
        )

    def with_schedules(self, schedules) -> "ChainCapacityPlan":
        return replace(
            self,
            stages=tuple(replace(cp, schedule=s) for cp, s in zip(self.stages, schedules)),
        )

    def cells(self) -> int:
        """Total planned frontier cells across every stage (see
        CapacityPlan.cells)."""
        return sum(cp.cells() for cp in self.stages)

    def __str__(self):
        return "Chain[" + "; ".join(
            f"{n}:{cp}" for n, cp in zip(self.names, self.stages)
        ) + "]"


def plan_capacities(
    plan: FreeJoinPlan,
    relations: dict[str, Relation] | None = None,
    *,
    stats: Stats | None = None,
    schedule=None,
    safety: float = 2.0,
    block: int = OBLK,
    compact_threshold: float = 0.25,
    max_capacity: int = 1 << 22,
    compact_output: bool = False,
    feedback=None,
) -> CapacityPlan:
    """Derive a CapacityPlan for `plan` (see module doc).

    Statistics come from `stats` — any object with .size(alias) and
    .distinct(alias, var) — or are computed from `relations`. The
    distributed driver passes per-shard stats (sizes and distinct counts
    shrunk by the hypercube shares); the local driver passes its query-wide
    Stats cache. `schedule` is the query's StaticSchedule if already
    computed; it is stored on the returned plan for executor builds.

    safety: multiplier on the cardinality estimates; compact_threshold:
    schedule compaction after a node when est-after / capacity falls below
    this; max_capacity: clamp on planned (not grown) capacities.
    compact_output: allow a compact point on the final node too — for
    non-root stages of a chained bushy plan, whose output buffer feeds the
    next stage's trie build (a squeezed buffer means a smaller lexsort),
    there is always "more work" after the last probe.
    feedback: a relcache.CardFeedback — prefix estimates are replaced by
    measured cardinalities from prior runs where recorded (see
    optimizer.prefix_card), so a warm query's buffers are sized from
    measurements instead of independence assumptions."""
    from repro_torch.core.compiled import _static_schedule  # deferred: avoids a cycle

    if stats is None:
        stats = Stats(relations)
    if schedule is None:
        schedule = _static_schedule(plan)
    estimates = estimate_prefixes(plan, stats=stats, schedule=schedule, feedback=feedback)
    sizes = {
        a: float(max(1, stats.size(a)))
        for a in {sa.alias for node in plan.nodes for sa in node}
    }
    agms = node_agm_bounds(schedule.entries, sizes)
    prefix: dict[str, tuple[str, ...]] = {a: () for a in sizes}
    caps: list[int] = []
    compact: list[int | None] = []
    compact_probe: list[int] = []
    for (_k, cover, probes), est, bound in zip(schedule.entries, estimates, agms):
        prefix[cover.alias] = prefix[cover.alias] + tuple(cover.vars)
        cap = _round_block(min(max(1.0, est.expand) * safety, bound, float(max_capacity)), block)
        last = est is estimates[-1] and not compact_output
        # earliest probe after which the predicted live fraction collapses:
        # compacting right there lets every remaining probe (and all later
        # nodes) run at the squeezed width
        target: int | None = None
        cp_idx = len(probes)
        for j, sa in enumerate(probes):
            prefix[sa.alias] = prefix[sa.alias] + tuple(sa.vars)
            more_work = (j + 1 < len(probes)) or not last
            if target is not None or not more_work:
                continue
            a_est = est.probe_after[j]
            t = _round_block(min(max(1.0, a_est) * safety, agm_bound(prefix, sizes)), block)
            if a_est < compact_threshold * cap and t < cap:
                target, cp_idx = t, j + 1
        if compact_output and est is estimates[-1] and target is None:
            # a stage's final frontier is the next stage's trie, whose build
            # cost scales with the static buffer width — squeeze it whenever
            # the estimate says the buffer is oversized, selective or not.
            # No safety factor here: a too-small target is recovered by one
            # compact-overflow retry that jumps to the *measured* live count,
            # so steady state converges to a tight output buffer.
            t = _round_block(min(max(1.0, est.after), agm_bound(prefix, sizes)), block)
            if t < cap:
                target, cp_idx = t, len(probes)
        caps.append(cap)
        compact.append(target)
        compact_probe.append(cp_idx)
    return CapacityPlan(
        capacities=tuple(caps),
        compact_to=tuple(compact),
        compact_probe=tuple(compact_probe),
        estimates=tuple(estimates),
        agm=tuple(agms),
        block=block,
        schedule=schedule,
    )


def plan_chain_capacities(
    stages,
    *,
    stats: Stats,
    safety: float = 2.0,
    block: int = OBLK,
    compact_threshold: float = 0.25,
    max_capacity: int = 1 << 22,
    feedback=None,
) -> ChainCapacityPlan:
    """Capacity-plan a whole stage chain in one pass (no materialization).

    stages: ((name, FreeJoinPlan), ...) root last, each plan's query built
    over the stage's atoms (which may reference earlier stage names).
    `stats` covers the *base* relations only; stage outputs are answered by
    a StageStats view from the optimizer's cardinality estimates — each
    stage's estimated Est (size + per-var distincts) registers before the
    next stage plans, so stage output estimates feed every downstream
    prefix estimate and AGM bound. Non-root stages plan with
    compact_output=True so their output buffers (the next trie's static
    width) get squeezed when the estimates say most lanes are dead."""
    sstats = StageStats(stats)
    cps = []
    for i, (name, plan) in enumerate(stages):
        root = i == len(stages) - 1
        cps.append(
            plan_capacities(
                plan,
                stats=sstats,
                safety=safety,
                block=block,
                compact_threshold=compact_threshold,
                max_capacity=max_capacity,
                compact_output=not root,
                feedback=feedback,
            )
        )
        if not root:
            sstats.register(name, stage_est(plan.query.atoms, sstats))
    return ChainCapacityPlan(names=tuple(n for n, _ in stages), stages=tuple(cps))
