"""Cost-based join-order optimization: enumerate -> cost -> feedback.

The paper uses DuckDB's optimizer; plan choice here is our own. Three layers, each feeding the next:

1. **Enumerate.** `JoinOrderOptimizer` runs dynamic programming over
   connected sub-queries (DPsub-style: every connected subset of atoms,
   every connected split of it, no cross products) and keeps the top-k
   candidate *bushy* binary trees per subset, ranked by the classic C_out
   cost with every per-subset cardinality capped by the AGM bound of that
   subset — one bad estimate cannot blow up the ranking. The enumeration
   pays at most `budget` (subset, split) pairs; past the budget — or at
   `level=0` — it falls back to `optimize`, the original greedy left-deep
   search driven by |L join R| = |L|*|R| / prod_{v shared} max(d_L, d_R).

2. **Cost.** The surviving candidates (plus the greedy tree, which wins
   ties for stability) are re-ranked by a *device* cost model
   (`device_cost`): capacity.plan_chain_capacities sizes every frontier
   buffer the compiled chain would allocate — estimates x safety, capped
   per prefix by the AGM bound — and the cost is the total number of
   frontier cells *touched*: one buffer-wide pass per expansion, per
   probe (at the compacted width once the plan compacts), per compaction
   scatter, plus the write + sort of every non-root stage's output
   buffer. That is the quantity the device actually pays for; output row
   counts alone would miss that a bushy stage trades frontier width for
   a trie build.

3. **Feedback.** The compiled executor reports every node's exact
   frontier need; the adaptive runner records them in
   relcache.FEEDBACK (a per-relation measured-cardinality store), and
   both the DP's subset cardinalities and the capacity planner's prefix
   estimates (`prefix_card`) consult it — so the next cold plan for these
   relations is chosen against measured, not estimated, cardinalities.
   Chosen plans are memoized per (query, relations): at the default
   level 1 the first choice is *pinned* for the life of the relations
   (one run measures only the chosen plan's own prefixes, so re-ranking
   against unmeasured challengers is information-asymmetric and every
   plan flip is a recompile); at level >= 2 a version bump of the store
   triggers re-planning, and the incumbent is abandoned only when the
   re-ranked best is decisively cheaper (`adopt_margin`) — it re-plans
   exactly when the measurements contradict the estimates.

`bad=True` reproduces the paper's Sec 5.4 hijack — every cardinality
estimate is pinned to 1 — under which the greedy search degenerates to
input order and we emit a *bushy* balanced tree (the paper observes DuckDB
"routinely outputs bushy plans that materialize large results" in this
regime).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import relcache
from repro_torch.core.plan import BinaryPlan, FreeJoinPlan, linear
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


class Est:
    """A cardinality estimate: expected row count plus per-variable distinct
    counts (the state threaded through the System-R style estimator)."""

    def __init__(self, card: float, distinct: dict[str, float], atoms: list[Atom]):
        self.card = card
        self.distinct = distinct
        self.atoms = atoms


class Stats:
    """Per-column statistics shared across one query's whole planning pass
    (optimize -> plan_capacities -> estimate_prefixes): each referenced
    column is np.unique'd exactly once and the result cached. Holds a live
    reference to the driver's relation dict, so stage relations materialized
    mid-query are visible without rebuilding the cache.

    cached=True additionally persists each distinct count in the process-
    wide weakref registry (core/relcache.py), keyed by relation + column
    object identity — the compiled driver's steady-state surface, where a
    repeated query over the same relations pays zero np.unique calls. The
    default stays per-instance so eager-path callers keep the one-pass
    contract without touching global state."""

    def __init__(self, relations: dict[str, Relation], *, cached: bool = False):
        self.relations = relations
        self._distinct: dict[tuple[str, str], float] = {}
        self._cached = cached

    def size(self, alias: str) -> int:
        # live rows, not physical rows: a mutating relation's tombstones
        # weigh nothing in the trie, so capacity/cost estimates that counted
        # them would oversize every delta-maintained buffer
        from repro_torch.core import relcache

        return relcache.live_size(self.relations[alias])

    def distinct(self, alias: str, var: str) -> float:
        key = (alias, var)
        if key not in self._distinct:
            rel = self.relations[alias]
            col = rel.columns[var]

            def compute():
                return float(max(1, len(np.unique(col))))

            if self._cached:
                from repro_torch.core import relcache

                self._distinct[key] = relcache.memo(
                    relcache.REGISTRY, rel, "distinct", var, col, compute
                )
            else:
                self._distinct[key] = compute()
        return self._distinct[key]

    def relation_of(self, alias: str) -> Relation | None:
        """The live relation behind an alias, or None when the alias has no
        host relation (measured-cardinality feedback keys on relation
        identity, so only alias with a real object can use the store)."""
        return self.relations.get(alias)


class StageStats:
    """Statistics view that also answers for *planned* stage outputs —
    relations that never exist on the host, because the chained compiled
    path materializes them only as device buffers. A stage's size and
    per-var distinct counts come from the optimizer's Est of its sub-query
    (register() after planning the stage, before any downstream stage reads
    it); every other alias falls through to the base Stats cache, so the
    whole chain still costs one np.unique per referenced base column."""

    def __init__(self, base: Stats):
        self.base = base
        self._stage: dict[str, Est] = {}

    def register(self, alias: str, est: Est) -> None:
        self._stage[alias] = est

    def size(self, alias: str) -> int:
        if alias in self._stage:
            return int(max(1.0, self._stage[alias].card))
        return self.base.size(alias)

    def distinct(self, alias: str, var: str) -> float:
        if alias in self._stage:
            e = self._stage[alias]
            return float(min(max(1.0, e.distinct.get(var, e.card)), max(1.0, e.card)))
        return self.base.distinct(alias, var)

    def relation_of(self, alias: str) -> Relation | None:
        # stage outputs live only on device — no identity to key feedback on
        if alias in self._stage:
            return None
        return self.base.relation_of(alias)


class FilteredStats:
    """Statistics view for a query carrying equality selections (the serving
    path's plan *templates*: `v = ?` with the constant lifted out of the
    plan). A filtered variable contributes exactly one distinct value, and
    every atom containing it shrinks by that column's selectivity
    (size / distinct), so capacity planning sizes frontier buffers for the
    *selected* slice instead of the whole relation — the difference between
    a batched probe lane costing O(rows-matching-constant) and
    O(all-rows). Deliberately value-agnostic: the estimates depend only on
    WHICH vars are filtered, never on the constants, so every query of a
    template shares one plan and one executor.

    `filtered` maps alias -> the set of that atom's filtered vars. Plan
    choice (optimize) should keep using the unfiltered base stats — the
    binary plan must be template-stable too; this view feeds capacity
    planning, where an under-estimate is recovered by the adaptive runner's
    exact-need growth."""

    def __init__(self, base, filtered: dict[str, frozenset[str]]):
        self.base = base
        self.filtered = {a: frozenset(vs) for a, vs in filtered.items() if vs}

    def size(self, alias: str) -> int:
        s = float(max(1, self.base.size(alias)))
        for v in self.filtered.get(alias, ()):
            s /= max(1.0, self.base.distinct(alias, v))
        return int(max(1.0, math.ceil(s)))

    def distinct(self, alias: str, var: str) -> float:
        if var in self.filtered.get(alias, frozenset()):
            return 1.0
        return float(min(self.base.distinct(alias, var), max(1, self.size(alias))))

    def relation_of(self, alias: str) -> Relation | None:
        # a filtered atom's frontier contribution depends on the constant;
        # measured (unfiltered) cardinalities would oversize it
        if alias in self.filtered:
            return None
        return self.base.relation_of(alias)


def stage_est(atoms: list[Atom], stats) -> Est:
    """Estimated output of joining `atoms` (a stage sub-query): fold the
    binary estimator left to right. `stats` may be a StageStats so earlier
    stages' estimates flow into later stages'."""
    cur = base_est(atoms[0], stats)
    for a in atoms[1:]:
        cur = join_est(cur, base_est(a, stats))
    return cur


def base_est(atom: Atom, stats: Stats, bad: bool = False) -> Est:
    if bad:
        return Est(1.0, {v: 1.0 for v in atom.vars}, [atom])
    d = {v: stats.distinct(atom.alias, v) for v in atom.vars}
    return Est(float(max(1, stats.size(atom.alias))), d, [atom])


def join_est(a: Est, b: Est) -> Est:
    shared = set(a.distinct) & set(b.distinct)
    denom = 1.0
    for v in shared:
        denom *= max(a.distinct[v], b.distinct[v])
    card = max(1.0, a.card * b.card / max(1.0, denom))
    d = dict(a.distinct)
    for v, dv in b.distinct.items():
        d[v] = min(d.get(v, float("inf")), dv, card)
    d = {v: min(dv, card) for v, dv in d.items()}
    return Est(card, d, a.atoms + b.atoms)


def optimize(
    query: Query,
    relations: dict[str, Relation],
    bad: bool = False,
    *,
    stats: Stats | None = None,
) -> BinaryPlan | Atom:
    if stats is None:
        stats = Stats(relations)
    ests = [base_est(a, stats, bad) for a in query.atoms]
    if bad:
        # balanced bushy over input order (all estimates tie at 1)
        nodes: list = list(query.atoms)
        while len(nodes) > 1:
            nxt = []
            for i in range(0, len(nodes) - 1, 2):
                nxt.append(BinaryPlan(nodes[i], nodes[i + 1]))
            if len(nodes) % 2:
                nxt.append(nodes[-1])
            nodes = nxt
        return nodes[0]  # single-atom queries get the atom, not a self-join
    # greedy left-deep: best starting pair, then best extension
    best_pair, best_card = None, float("inf")
    for i in range(len(ests)):
        for j in range(len(ests)):
            if i == j or not (set(ests[i].distinct) & set(ests[j].distinct)):
                continue
            e = join_est(ests[i], ests[j])
            # prefer iterating the bigger relation first (build on the smaller)
            if e.card < best_card or (
                e.card == best_card and best_pair and ests[i].card > ests[best_pair[0]].card
            ):
                best_pair, best_card = (i, j), e.card
    if best_pair is None:
        best_pair = (0, 1) if len(ests) > 1 else (0, 0)
    cur = join_est(ests[best_pair[0]], ests[best_pair[1]]) if len(ests) > 1 else ests[0]
    used = set(best_pair)
    order = [query.atoms[best_pair[0]]] + ([query.atoms[best_pair[1]]] if len(ests) > 1 else [])
    while len(used) < len(ests):
        best_k, best_e = None, None
        for k in range(len(ests)):
            if k in used:
                continue
            connected = bool(set(ests[k].distinct) & set(cur.distinct))
            e = join_est(cur, ests[k])
            key = (not connected, e.card)
            if best_e is None or key < best_e:
                best_k, best_e = k, key
        used.add(best_k)
        order.append(query.atoms[best_k])
        cur = join_est(cur, ests[best_k])
    return linear(order)


# ---------------------------------------------------------------------------
# Per-prefix estimates along a Free Join plan (Sec 4.3/4.4 batched execution:
# the compiled path sizes its static frontier buffers from these).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class NodeEstimate:
    """Frontier-size estimates around one executed plan node: `expand` is
    the frontier right after the cover's trie level is iterated (this bounds
    the expansion buffer), `probe_after[j]` the live frontier once the
    node's first j+1 probes have filtered it, and `after` the frontier when
    the whole node is done. probe_after drives compaction decisions —
    including mid-node, between two probes of a factored plan."""

    node: int  # index into plan.nodes
    expand: float
    after: float
    probe_after: tuple[float, ...] = ()


def prefix_card(
    prefix: dict[str, tuple[str, ...]], stats: Stats, feedback=None
) -> float:
    """Estimated size of the join of each relation's consumed var-prefix.

    A depth-d trie level holds the distinct prefix combos, bounded by both
    the relation's row count and the product of per-var distinct counts
    (independence); the prefixes are then joined with the same max-distinct
    rule as the binary estimator.

    `feedback` (a relcache.CardFeedback) short-circuits the estimate with
    the *measured* cardinality of this exact prefix multiset when a prior
    run recorded one — but only when every participating alias resolves to
    a live relation object (stats.relation_of), so stage outputs and
    constant-filtered atoms keep their estimates."""
    if feedback is not None:
        specs: list | None = []
        for alias, vars_ in prefix.items():
            if not vars_:
                continue
            rel = stats.relation_of(alias) if hasattr(stats, "relation_of") else None
            if rel is None:
                specs = None
                break
            specs.append((rel, vars_))
        if specs:
            measured = feedback.lookup(specs)
            if measured is not None:
                return float(max(1.0, measured))
    cur: Est | None = None
    for alias, vars_ in prefix.items():
        if not vars_:
            continue
        d = {v: stats.distinct(alias, v) for v in vars_}
        card = min(float(max(1, stats.size(alias))), float(np.prod(list(d.values()))))
        e = Est(card, d, [])
        cur = e if cur is None else join_est(cur, e)
    return 1.0 if cur is None else cur.card


def estimate_prefixes(
    plan: FreeJoinPlan,
    relations: dict[str, Relation] | None = None,
    *,
    stats: Stats | None = None,
    schedule=None,
    feedback=None,
) -> list[NodeEstimate]:
    """Walk the plan with the compiled path's static schedule (first-listed
    cover per node) and estimate the frontier size around every executed
    node. One entry per executed node, aligned with the compiled schedule.

    `stats` and `schedule` let the driver share one Stats cache and one
    StaticSchedule across the whole planning pass; passing only `relations`
    keeps the standalone surface working (stats built here). `feedback`
    replaces individual prefix estimates with measured cardinalities from
    prior runs where available (see prefix_card)."""
    from repro_torch.core.compiled import _static_schedule  # deferred: avoids a cycle

    if stats is None:
        stats = Stats(relations)
    if schedule is None:
        schedule = _static_schedule(plan)
    aliases = {sa.alias for node in plan.nodes for sa in node}
    prefix: dict[str, tuple[str, ...]] = {a: () for a in aliases}
    out: list[NodeEstimate] = []
    for k, cover, probes in schedule.entries:
        prefix[cover.alias] = prefix[cover.alias] + tuple(cover.vars)
        expand = prefix_card(prefix, stats, feedback)
        cards = []
        for sa in probes:
            prefix[sa.alias] = prefix[sa.alias] + tuple(sa.vars)
            cards.append(min(prefix_card(prefix, stats, feedback), expand))
        after = cards[-1] if cards else expand
        out.append(
            NodeEstimate(node=k, expand=expand, after=after, probe_after=tuple(cards))
        )
    return out


# ---------------------------------------------------------------------------
# Cost-based plan enumeration: DP over connected subqueries + a device cost
# model over planned frontier capacities (see module docstring, layers 1-2).
# ---------------------------------------------------------------------------


def _tree_sig(tree) -> tuple:
    """Structural identity of a binary plan tree (BinaryPlan has no value
    equality; plan choice needs one to detect 'same plan as last time')."""
    if isinstance(tree, Atom):
        return (tree.alias,)
    return (_tree_sig(tree.left), _tree_sig(tree.right))


def device_cost(
    query: Query,
    tree,
    *,
    stats,
    safety: float = 2.0,
    compact_threshold: float = 0.25,
    feedback=None,
) -> float:
    """Device cost of one candidate plan tree, in frontier cells *touched*.

    The tree is decomposed into its compiled stage chain and capacity-
    planned exactly as execution would (capacity.plan_chain_capacities:
    estimates x safety capped per prefix by the AGM bound, measured
    cardinalities from `feedback` where available). The cost then charges
    one buffer-wide pass per expansion, one per probe — at the compacted
    width for probes after the plan's compact point — one per compaction
    scatter, and write + sort passes for every non-root stage's output
    buffer (the next stage's trie build scales with that static width).
    This is what distinguishes a bushy split from a left-deep chain on
    device: the bushy plan pays two small stage buffers and a trie build
    instead of dragging one huge intermediate frontier through every
    remaining probe."""
    from repro_torch.core.capacity import plan_chain_capacities  # deferred: cycle
    from repro_torch.core.plan import stage_plans

    stages = stage_plans(query, tree)
    chain = plan_chain_capacities(
        stages,
        stats=stats,
        safety=safety,
        compact_threshold=compact_threshold,
        feedback=feedback,
    )
    total = 0.0
    for si, cp in enumerate(chain.stages):
        for (_k, _cover, probes), cap, ct, cpi in zip(
            cp.schedule.entries, cp.capacities, cp.compact_to, cp.compact_probe
        ):
            total += cap  # the expansion writes the frontier once
            width = cap
            for j in range(len(probes)):
                if ct is not None and j >= cpi:
                    width = ct  # probes after the compact point run squeezed
                total += width  # one gather pass over the frontier per probe
            if ct is not None:
                total += cap  # the compaction scatter itself
        if si < len(chain.stages) - 1:
            out_w = cp.compact_to[-1] if cp.compact_to[-1] is not None else cp.capacities[-1]
            total += 2.0 * out_w  # stage output write + downstream trie sort
    return total


# chosen plans, memoized per (query structure, relation identities, knobs)
# and revalidated against the feedback store's version: a steady-state
# stream of identical queries re-enumerates nothing
_CHOICE_CACHE = relcache.KeyedCache(max_entries=128)


class JoinOrderOptimizer:
    """Enumerate -> cost -> feedback plan choice (module docstring).

    level 0 delegates to the greedy `optimize`; level >= 1 runs the DP
    enumeration with the default budget and PINS the choice (measured
    cardinalities sharpen later *cold* plans and capacity planning, but a
    live (query, relations) pair keeps its first plan — no recompiles);
    level >= 2 additionally enumerates with an effectively exhaustive
    budget and RE-PLANS when new measurements arrive, guarded by
    `adopt_margin` hysteresis. `budget` (max (subset, split) pairs
    considered) overrides the level default; exhausting it falls back to
    greedy. `keep` is the number of candidate trees retained per connected
    subset AND the number of finalists re-ranked by device_cost.
    `feedback` is a relcache.CardFeedback (usually relcache.FEEDBACK);
    `adopt_margin` is the hysteresis: a re-ranking under new measurements
    must beat the incumbent's device cost by this factor to displace it.
    `debug_lint` runs the static plan verifier (repro_torch.analysis.
    planlint) over every device-costed finalist and raises on the first
    invalid one — an enumeration bug surfaces at the enumerator, named,
    instead of as a wrong winner three layers later. Off by default: it
    lints `keep`+1 whole stage chains per cold choice. `linted` and
    `lint_s` count the finalists it linted and the host seconds it took."""

    def __init__(
        self,
        level: int = 1,
        *,
        budget: int | None = None,
        keep: int = 3,
        safety: float = 2.0,
        compact_threshold: float = 0.25,
        feedback=None,
        adopt_margin: float = 0.8,
        debug_lint: bool = False,
    ):
        self.level = int(level)
        self.budget = int(
            budget if budget is not None else (4096 if self.level <= 1 else 1 << 20)
        )
        self.keep = int(keep)
        self.safety = float(safety)
        self.compact_threshold = float(compact_threshold)
        self.feedback = feedback
        self.adopt_margin = float(adopt_margin)
        self.debug_lint = bool(debug_lint)
        self.linted = 0
        self.lint_s = 0.0

    # ---- public surface ----------------------------------------------
    def choose(
        self,
        query: Query,
        relations: dict[str, Relation],
        *,
        stats: Stats | None = None,
        bad: bool = False,
    ) -> BinaryPlan | Atom:
        if stats is None:
            stats = Stats(relations)
        if bad or self.level <= 0 or len(query.atoms) < 3:
            # greedy fallback: level 0, the Sec 5.4 hijack, and queries too
            # small for the enumeration to beat the heuristic
            return optimize(query, relations, bad, stats=stats)
        key = self._choice_key(query, relations)
        version = self.feedback.version if self.feedback is not None else 0
        hit = _CHOICE_CACHE.get(key)
        if hit is not None and (self.level < 2 or hit[1] == version):
            # level < 2 PINS the first choice for the life of the relations:
            # one run's measurements cover only the incumbent's own prefixes,
            # so re-ranking against unmeasured challengers is information-
            # asymmetric (the measured plan always looks worse than the
            # fantasy ones) and would flip-flop plans — and every flip is a
            # recompile. Level >= 2 opts into adaptive re-planning, guarded
            # by adopt_margin hysteresis below.
            return hit[0]
        chosen = self._choose_uncached(query, relations, stats, incumbent=hit)
        _CHOICE_CACHE.put(
            key, (chosen, version), [relations[a.alias] for a in query.atoms]
        )
        return chosen

    # ---- internals ----------------------------------------------------
    def _choice_key(self, query: Query, relations) -> tuple:
        return (
            tuple((a.alias, a.name, tuple(a.vars)) for a in query.atoms),
            tuple(query.head),
            self.level,
            self.budget,
            self.keep,
            round(self.safety, 6),
            round(self.compact_threshold, 6),
            tuple(sorted((a.alias, id(relations[a.alias])) for a in query.atoms)),
        )

    def _lint_finalists(self, query, finalists) -> None:
        """debug_lint mode: every enumerated finalist must derive a valid
        stage chain. A finding here is an enumerator/stage-derivation bug,
        so raise with the tree's signature in the message."""
        from repro_torch.analysis.diagnostics import PlanVerificationError
        from repro_torch.analysis.planlint import lint_chain, lint_tree

        t0 = time.perf_counter()
        for t, sig in finalists:
            rep, stages = lint_tree(query, t)
            if stages is not None:
                rep.extend(lint_chain(stages))
            self.linted += 1
            if not rep.ok:
                rep.error(
                    "enumerated-plan-invalid",
                    f"finalist[{sig}]",
                    "device-costed finalist fails static verification",
                )
                raise PlanVerificationError(rep)
        self.lint_s += time.perf_counter() - t0

    def _choose_uncached(self, query, relations, stats, *, incumbent):
        fb = self.feedback
        greedy = optimize(query, relations, stats=stats)
        candidates = self._enumerate(query, stats)
        # greedy first: exact device-cost ties keep the pre-enumeration plan
        finalists, seen = [], set()
        for t in [greedy] + (candidates or []):
            sig = _tree_sig(t)
            if sig in seen:
                continue
            seen.add(sig)
            finalists.append((t, sig))
        if self.debug_lint:
            self._lint_finalists(query, finalists)
        if len(finalists) == 1:
            return finalists[0][0]
        costed = [
            (
                device_cost(
                    query,
                    t,
                    stats=stats,
                    safety=self.safety,
                    compact_threshold=self.compact_threshold,
                    feedback=fb,
                ),
                i,
                t,
                sig,
            )
            for i, (t, sig) in enumerate(finalists)
        ]
        cost, _i, best, best_sig = min(costed)
        if incumbent is not None:
            prev = incumbent[0]
            prev_sig = _tree_sig(prev)
            if prev_sig != best_sig:
                prev_cost = next(
                    (c for c, _i, _t, s in costed if s == prev_sig),
                    device_cost(
                        query,
                        prev,
                        stats=stats,
                        safety=self.safety,
                        compact_threshold=self.compact_threshold,
                        feedback=fb,
                    ),
                )
                if cost > self.adopt_margin * prev_cost:
                    # not decisively cheaper under the new measurements:
                    # keep the incumbent (a running template never swaps
                    # its compiled runner over estimation noise)
                    return prev
        return best

    def _enumerate(self, query: Query, stats) -> list | None:
        """Top-`keep` bushy trees for the full query by C_out cost with
        AGM-capped (and measured, where known) subset cardinalities; None
        when the budget runs out or the join graph is disconnected."""
        from repro_torch.core.capacity import agm_bound  # deferred: cycle

        fb = self.feedback
        atoms = list(query.atoms)
        m = len(atoms)
        vars_of = [frozenset(a.vars) for a in atoms]
        sizes = {a.alias: float(max(1, stats.size(a.alias))) for a in atoms}
        full = (1 << m) - 1
        # best[mask] = up to `keep` of (cost, counter, tree, Est, varset)
        best: dict[int, list] = {}
        for i, a in enumerate(atoms):
            best[1 << i] = [(0.0, i, a, base_est(a, stats), vars_of[i])]
        tiebreak = m  # deterministic ordering for equal costs
        pairs = 0
        for mask in sorted(range(1, full + 1), key=lambda x: x.bit_count()):
            if mask.bit_count() < 2:
                continue
            members = [i for i in range(m) if mask >> i & 1]
            edges = {atoms[i].alias: tuple(atoms[i].vars) for i in members}
            bound = agm_bound(edges, sizes)
            measured = self._measured_card([atoms[i] for i in members], stats)
            cands: list = []
            sub = (mask - 1) & mask
            while sub:
                rest = mask ^ sub
                left, right = best.get(sub), best.get(rest)
                if left and right:
                    pairs += 1
                    if pairs > self.budget:
                        return None
                    cl, _tl, tl, el, vl = left[0]
                    cr, _tr, tr, er, vr = right[0]
                    if vl & vr:  # no cross products
                        est = join_est(el, er)
                        card = min(est.card, bound)
                        if measured is not None:
                            card = measured
                        est = Est(
                            card,
                            {v: min(dv, card) for v, dv in est.distinct.items()},
                            est.atoms,
                        )
                        tiebreak += 1
                        cands.append(
                            (cl + cr + card, tiebreak, BinaryPlan(tl, tr), est, vl | vr)
                        )
                sub = (sub - 1) & mask
            if cands:
                cands.sort(key=lambda c: (c[0], c[1]))
                dedup, sigs = [], set()
                for c in cands:
                    s = _tree_sig(c[2])
                    if s in sigs:
                        continue
                    sigs.add(s)
                    dedup.append(c)
                    if len(dedup) >= self.keep:
                        break
                best[mask] = dedup
        if full not in best:
            return None  # disconnected join graph: greedy handles it
        return [t for _c, _i, t, _e, _v in best[full]]

    def _measured_card(self, subset_atoms, stats) -> float | None:
        if self.feedback is None:
            return None
        specs = []
        for a in subset_atoms:
            rel = stats.relation_of(a.alias) if hasattr(stats, "relation_of") else None
            if rel is None:
                return None
            specs.append((rel, a.vars))
        return self.feedback.lookup(specs)
