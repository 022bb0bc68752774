"""planlint — static verification of plans, schedules, and capacities.

Free Join's correctness hangs on a chain of invariants the paper states
but execution never re-checks: every probe key must be a variable some
earlier cover bound, every node needs a covering subatom for its new
variables, a stage chain must be a DAG whose output schemas match the
weighted-trie layouts built downstream, and every frontier capacity must
be positive and within the AGM bound of its prefix sub-query. The
compiled executor *assumes* all of this — a violation shows up as a
wrong answer or a shape error deep inside the executor, attributed to
nothing.

This module checks each invariant over the host-side plan structures
(`FreeJoinPlan`, `StaticSchedule`, `CapacityPlan`/`ChainCapacityPlan`,
binary plan trees, serving templates) and reports findings as typed
diagnostics with a plan-path locator (see diagnostics.py) — never
asserts. Entry points, smallest to largest scope:

* `lint_plan`       — one FreeJoinPlan: partitioning, covers, probe
                      binding order, head binding.
* `lint_schedule`   — a StaticSchedule against its plan: entry sequence
                      and per-alias trie level layouts must match what
                      `_static_schedule` derives.
* `lint_capacities` — a CapacityPlan against its plan: arity, positive
                      capacities, compaction targets/points in range,
                      capacities within the (block-rounded) AGM cap.
* `lint_stage_dag`  — a stage chain: unique names, root last, references
                      only to earlier stages, referencing atoms matching
                      the producing stage's output schema.
* `lint_chain`      — everything above over a whole stage chain, plus
                      filter-variable coverage for kill vs mask mode.
* `lint_tree`       — a binary plan tree against its query (leaf multiset,
                      stage derivation) — the cheap admission-time check.
* `lint_template`   — serving-template canonicalization idempotence:
                      canonicalize(canonicalize(q)) == canonicalize(q).

The rule catalogue with severities lives in README.md next door; the
mutation suite (tests/test_torch_analysis.py) locks that every rule
fires on its defect class at the reference's path and stays silent on
every plan the real planner produces.
"""
from __future__ import annotations

from repro_torch.analysis.diagnostics import Report
from repro_torch.core.capacity import _round_block, node_agm_bounds
from repro_torch.core.plan import FreeJoinPlan, stage_plans
from repro_torch.relational.schema import Atom, Query

ROOT_STAGE = "__root"


def _stage_path(stage: str) -> str:
    return f"stage[{stage}]"


# ---------------------------------------------------------------------------
# Single-plan structure
# ---------------------------------------------------------------------------


def _walk_schedule(plan: FreeJoinPlan):
    """Tolerant re-derivation of the static schedule: yields
    (k, cover, probes) like compiled._static_schedule, but degrades to the
    first non-empty subatom when a node has no cover instead of crashing —
    lint_plan must keep walking a broken plan to report everything."""
    for k, node in enumerate(plan.nodes):
        subs = [sa for sa in node if sa.vars]
        if not subs:
            continue
        covers = [sa for sa in plan.covers(k) if sa.vars and any(sa is s for s in subs)]
        cover = covers[0] if covers else subs[0]
        yield k, cover, tuple(sa for sa in subs if sa is not cover)


def lint_plan(plan: FreeJoinPlan, *, stage: str = ROOT_STAGE) -> Report:
    """Structural validity of one FreeJoinPlan (Def 3.5 + Def 3.7), plus
    the execution-order invariants the compiled path relies on: every
    probe variable bound by an earlier-or-same-node cover before it is
    used as a key, and every head variable bound somewhere."""
    rep = Report()
    sp = _stage_path(stage)
    for rule, locus, message in plan.violations():
        path = f"{sp}.atom[{locus}]" if isinstance(locus, str) else f"{sp}.node[{locus}]"
        rep.error(rule, path, message)
    # probe-binding order: the executor reads bound[v] for every probe key,
    # and bound[] is written only when a cover iterates the variable
    bound: set[str] = set()
    for k, cover, probes in _walk_schedule(plan):
        bound |= set(cover.vars)
        for j, sa in enumerate(probes):
            loose = set(sa.vars) - bound
            if loose:
                rep.error(
                    "unbound-probe-var",
                    f"{sp}.node[{k}].probe[{j}]",
                    f"probe {sa} uses variable(s) {sorted(loose)} before any "
                    f"cover binds them (bound so far: {sorted(bound)})",
                )
    plan_vars = {v for node in plan.nodes for sa in node for v in sa.vars}
    missing_head = set(plan.query.head) - plan_vars
    if missing_head:
        rep.error(
            "unbound-head-var",
            f"{sp}.head",
            f"head variable(s) {sorted(missing_head)} are never bound by the plan "
            f"(plan binds {sorted(plan_vars)})",
        )
    return rep


def lint_query(query: Query, *, path: str = "query") -> Report:
    """Query-level sanity that Query.__post_init__ does not enforce: an
    explicit head may name variables no atom binds (the executor would
    KeyError mid-trace; canonicalization would silently drop them)."""
    rep = Report()
    missing = set(query.head) - set(query.variables)
    if missing:
        rep.error(
            "unbound-head-var",
            f"{path}.head",
            f"head variable(s) {sorted(missing)} appear in no atom",
        )
    return rep


# ---------------------------------------------------------------------------
# Schedule vs plan
# ---------------------------------------------------------------------------


def lint_schedule(plan: FreeJoinPlan, schedule, *, stage: str = ROOT_STAGE) -> Report:
    """A StaticSchedule is a pure function of its plan; any drift between
    the two means the executor will probe trie levels that were never
    built (or built in a different variable order). Recompute the
    reference schedule and compare entries and per-alias level layouts."""
    from repro_torch.core.compiled import _static_schedule  # deferred: analysis -> core only

    rep = Report()
    sp = _stage_path(stage)
    try:
        ref = _static_schedule(plan)
    except (IndexError, KeyError) as e:  # broken plan: lint_plan owns the diagnosis
        rep.error(
            "schedule-underivable",
            f"{sp}.schedule",
            f"no static schedule derivable from this plan ({e})",
        )
        return rep
    for a, lo in ref.level_ops.items():
        got = schedule.level_ops.get(a)
        if got is None:
            rep.error(
                "schedule-level-mismatch",
                f"{sp}.levels[{a}]",
                f"schedule has no level layout for alias {a!r}",
            )
        elif got.levels != lo.levels:
            rep.error(
                "schedule-level-mismatch",
                f"{sp}.levels[{a}]",
                f"trie level layout {got.levels} does not match the plan's "
                f"consumption order {lo.levels} for alias {a!r}",
            )
        elif len(got.probed) != len(got.levels):
            rep.error(
                "schedule-level-mismatch",
                f"{sp}.levels[{a}]",
                f"probed flags {got.probed} do not align with levels {got.levels}",
            )
    extra = set(schedule.level_ops) - set(ref.level_ops)
    if extra:
        rep.error(
            "schedule-level-mismatch",
            f"{sp}.levels",
            f"schedule carries layouts for unknown alias(es) {sorted(extra)}",
        )
    if tuple(schedule.entries) != tuple(ref.entries):
        for i, (got, want) in enumerate(zip(schedule.entries, ref.entries)):
            if got != want:
                rep.error(
                    "schedule-entry-mismatch",
                    f"{sp}.schedule[{i}]",
                    f"entry {got} does not match the plan-derived entry {want}",
                )
        if len(schedule.entries) != len(ref.entries):
            rep.error(
                "schedule-entry-mismatch",
                f"{sp}.schedule",
                f"schedule has {len(schedule.entries)} entries, plan derives "
                f"{len(ref.entries)}",
            )
    return rep


# ---------------------------------------------------------------------------
# Capacity plan vs plan/schedule
# ---------------------------------------------------------------------------


def lint_capacities(
    plan: FreeJoinPlan,
    cap_plan,
    *,
    stage: str = ROOT_STAGE,
    sizes: dict[str, float] | None = None,
) -> Report:
    """A CapacityPlan against its plan: one capacity per executed node,
    every capacity >= 1, compaction targets positive and strictly under
    their node capacity, compact points within the node's probe count,
    and no planned capacity above the (block-rounded) AGM bound of its
    prefix sub-query — the planner caps by AGM, so anything larger is
    either corruption or a planner regression. AGM bounds come from the
    plan's recorded `agm` tuple, or are recomputed from `sizes`
    (alias -> row count) when provided; with neither, the AGM check is
    skipped (every other check still runs).

    The AGM check applies to FRESH planner output only: overflow growth
    follows *measured* needs, which can legitimately exceed the recorded
    bound (kill-mode filtered runs record the filtered-stats AGM, but
    expansion is counted before lanes die). Lint at plan time — as
    ExecOptions.verify and the CI gate do — not after a grown run."""
    from repro_torch.core.compiled import _static_schedule  # deferred

    rep = Report()
    sp = _stage_path(stage)
    schedule = cap_plan.schedule
    if schedule is None:
        try:
            schedule = _static_schedule(plan)
        except (IndexError, KeyError):
            rep.error(
                "schedule-underivable",
                f"{sp}.schedule",
                "cannot align capacities: no schedule derivable from this plan",
            )
            return rep
    nsched = len(schedule.entries)
    # Python ints, so a message reads the same in both packages
    caps = tuple(int(c) for c in cap_plan.capacities)
    if len(caps) != nsched:
        rep.error(
            "capacity-arity",
            f"{sp}.caps",
            f"{len(caps)} capacities for {nsched} executed nodes",
        )
    compact_to = tuple(None if c is None else int(c) for c in cap_plan.compact_to)
    compact_probe = tuple(
        None if c is None else int(c) for c in cap_plan.compact_probe or (None,) * len(caps)
    )
    block = int(getattr(cap_plan, "block", 1) or 1)
    agms = tuple(cap_plan.agm) if len(cap_plan.agm) == nsched else None
    if agms is None and sizes is not None:
        agms = tuple(node_agm_bounds(schedule.entries, dict(sizes)))
    for i, (_k, _cover, probes) in enumerate(schedule.entries):
        if i >= len(caps):
            break
        cap = caps[i]
        if cap < 1:
            rep.error(
                "capacity-not-positive",
                f"{sp}.cap[{i}]",
                f"node {i} has non-positive expansion capacity {cap}",
            )
        elif agms is not None and cap > _round_block(agms[i], block):
            rep.error(
                "capacity-over-agm",
                f"{sp}.cap[{i}]",
                f"node {i} capacity {cap} exceeds the AGM bound of its prefix "
                f"sub-query ({agms[i]:.1f}, block-rounded "
                f"{_round_block(agms[i], block)}) — a frontier can never need "
                "more lanes than the worst-case join size",
            )
        ct = compact_to[i] if i < len(compact_to) else None
        if ct is not None:
            if ct < 1:
                rep.error(
                    "compact-target-not-positive",
                    f"{sp}.compact[{i}]",
                    f"node {i} compaction target {ct} is not positive",
                )
            elif ct >= cap:
                rep.error(
                    "compact-target-oversize",
                    f"{sp}.compact[{i}]",
                    f"node {i} compacts into {ct} lanes, not smaller than its "
                    f"{cap}-lane buffer — the squeeze would enlarge the frontier",
                )
        cp = compact_probe[i] if i < len(compact_probe) else None
        if cp is not None and not (0 <= cp <= len(probes)):
            rep.error(
                "compact-point-range",
                f"{sp}.compact[{i}]",
                f"node {i} compact point {cp} outside its {len(probes)} probes",
            )
    return rep


# ---------------------------------------------------------------------------
# Stage chains (bushy plans decomposed per Sec 2.2)
# ---------------------------------------------------------------------------


def lint_stage_dag(stages) -> Report:
    """A stage chain must be a schedulable DAG: unique names, the root
    stage last, every stage-alias reference resolving to an *earlier*
    stage, and every referencing atom's variables matching the producing
    stage's output head — that head is exactly the column set of the
    weighted trie the downstream stage builds from the stage's buffer."""
    rep = Report()
    names = [name for name, _ in stages]
    heads = {name: tuple(p.query.head) for name, p in stages}
    dup = {n for n in names if names.count(n) > 1}
    for n in sorted(dup):
        rep.error("stage-name-dup", _stage_path(n), f"stage name {n!r} repeats")
    if names and names[-1] != ROOT_STAGE:
        rep.error(
            "stage-root-last",
            _stage_path(names[-1]),
            f"last stage is {names[-1]!r}, expected {ROOT_STAGE!r} "
            "(the chain's result is the last stage's output)",
        )
    defined: set[str] = set()
    for name, plan in stages:
        for atom in plan.query.atoms:
            a = atom.alias
            if a in names or a.startswith("__stage"):
                if a not in heads:
                    rep.error(
                        "stage-unknown-ref",
                        f"{_stage_path(name)}.atom[{a}]",
                        f"stage {name!r} reads {a!r}, which no stage produces",
                    )
                elif a not in defined:
                    rep.error(
                        "stage-dag-order",
                        f"{_stage_path(name)}.atom[{a}]",
                        f"stage {name!r} reads {a!r} before it is produced "
                        "(stage order must topologically sort the plan tree)",
                    )
                elif set(atom.vars) != set(heads[a]):
                    rep.error(
                        "stage-schema-mismatch",
                        f"{_stage_path(name)}.atom[{a}]",
                        f"stage {name!r} reads {a!r} with schema {atom.vars}, "
                        f"but the stage outputs {heads[a]} — the weighted trie "
                        "built from the stage buffer would miss columns",
                    )
                elif tuple(atom.vars) != heads[a]:
                    rep.warning(
                        "stage-schema-order",
                        f"{_stage_path(name)}.atom[{a}]",
                        f"stage {name!r} reads {a!r} as {atom.vars}; the stage "
                        f"outputs {heads[a]} (same columns, different order — "
                        "legal, but trie levels will consume a permuted layout)",
                    )
        defined.add(name)
    return rep


def lint_chain(
    stages,
    chain_cap_plan=None,
    *,
    sizes: dict[str, float] | None = None,
    filter_vars: tuple[str, ...] = (),
    batch: int | None = None,
) -> Report:
    """The whole pre-compile verification pass over a stage chain:
    stage-DAG shape, every stage's plan structure and schedule, every
    stage's capacities (when a ChainCapacityPlan is given), and filter-
    variable coverage. `batch` marks mask-mode (batched) filter serving;
    kill mode is the unbatched default — the coverage rule is the same
    (every filter var must be bound by some stage), but mask mode earns a
    warning when a filter var first binds in a non-root stage, because the
    terminal mult-0 fold makes every later stage per-lane and quietly
    defeats the batched pipeline sharing that mask mode exists for."""
    rep = Report()
    rep.extend(lint_stage_dag(stages))
    cps = tuple(chain_cap_plan.stages) if chain_cap_plan is not None else (None,) * len(stages)
    for (name, plan), cp in zip(stages, cps):
        rep.extend(lint_plan(plan, stage=name))
        if cp is not None:
            if cp.schedule is not None:
                rep.extend(lint_schedule(plan, cp.schedule, stage=name))
            rep.extend(lint_capacities(plan, cp, stage=name, sizes=sizes))
    # filter coverage: mirror make_chain_executor's assignment — each
    # filtered var runs its comparison in the FIRST stage that binds it
    unassigned = set(filter_vars)
    nonroot_bound: list[str] = []
    for i, (_name, plan) in enumerate(stages):
        mine = [v for v in plan.query.variables if v in unassigned]
        unassigned -= set(mine)
        if mine and i < len(stages) - 1:
            nonroot_bound.extend(mine)
    if unassigned:
        rep.error(
            "filter-unbound",
            "chain.filters",
            f"filter variable(s) {sorted(unassigned)} are bound by no stage — "
            "the executor would have no column to compare the constant against",
        )
    if batch is not None and nonroot_bound:
        rep.warning(
            "mask-filter-nonroot",
            "chain.filters",
            f"mask-mode (batched) filters on {sorted(nonroot_bound)} bind in a "
            "non-root stage: every downstream stage runs per-lane, so the "
            "batched dispatch loses most of its cross-lane sharing",
        )
    return rep


# ---------------------------------------------------------------------------
# Binary plan trees (the admission-time surface: cheap, no capacities yet)
# ---------------------------------------------------------------------------


def _tree_leaves(tree) -> list[Atom]:
    if isinstance(tree, Atom):
        return [tree]
    return _tree_leaves(tree.left) + _tree_leaves(tree.right)


def lint_tree(query: Query, tree, *, path: str = "plan_tree"):
    """A binary plan tree against its query: every query atom exactly once
    as a leaf, and the stage derivation (decompose -> binary2fj -> factor)
    must succeed. Returns (report, stages) — stages is None when the tree
    is too broken to derive them. tree=None (optimizer's choice) is
    trivially clean."""
    rep = Report()
    if tree is None:
        return rep, None
    leaves = _tree_leaves(tree)
    want = sorted(a.alias for a in query.atoms)
    got = sorted(a.alias for a in leaves)
    if got != want:
        rep.error(
            "plan-tree-atoms",
            path,
            f"plan tree leaves {got} do not match the query atoms {want} "
            "(each atom must appear exactly once)",
        )
        return rep, None
    by_alias = {a.alias: a for a in query.atoms}
    for leaf in leaves:
        qa = by_alias[leaf.alias]
        if tuple(leaf.vars) != tuple(qa.vars) or leaf.name != qa.name:
            rep.error(
                "plan-tree-atoms",
                f"{path}.leaf[{leaf.alias}]",
                f"leaf {leaf} disagrees with the query atom {qa}",
            )
    if not rep.ok:
        return rep, None
    try:
        stages = stage_plans(query, tree)
    except ValueError as e:
        rep.error("invalid-plan-tree", path, f"stage derivation failed: {e}")
        return rep, None
    return rep, stages


# ---------------------------------------------------------------------------
# Serving templates: canonicalization idempotence
# ---------------------------------------------------------------------------


def lint_template(template) -> Report:
    """Template-canonicalization idempotence: re-canonicalizing a
    template's own canonical query must be a fixed point
    (canonicalize(canonicalize(q)) == canonicalize(q)). If it is not, two
    spellings of one query can land on different template keys — each
    compiling its own executor — and the serving engine's whole
    one-compile-per-template contract silently degrades to one compile
    per spelling."""
    from repro_torch.serve.templates import recanonicalize  # deferred: serve imports core

    rep = Report()
    try:
        again, _consts = recanonicalize(template)
    except (KeyError, ValueError) as e:
        rep.error(
            "canonicalize-not-idempotent",
            "template",
            f"re-canonicalization crashed: {e}",
        )
        return rep
    if again.key != template.key:
        rep.error(
            "canonicalize-not-idempotent",
            "template.key",
            "canonicalize(canonicalize(q)) != canonicalize(q): "
            f"{again.key} vs {template.key}",
        )
    return rep
