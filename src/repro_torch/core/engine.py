"""The Free Join algorithm (Fig. 7), executed fully vectorized on tensors.

The paper batches the cover iteration and probes per relation (Sec 4.3,
Fig. 13); on vector hardware we take that to its limit: the *entire frontier*
(the set of partially-bound tuples at the current plan node) is one batch.
Each plan node is executed as: expand the frontier along the cover's trie
level (the CSR-expansion kernel, K2), then probe every other subatom's trie
level with whole-column keys (the hash-probe kernel, K1), compacting the
frontier to the hits (the compaction kernel, K3). Per-tuple recursion
disappears; the recursion depth of Fig. 7 becomes a sequential walk over
plan nodes. Trie levels are built on demand with the segmented radix sort
(K4), see core/colt.py.

The frontier lives on the device: bound columns and trie group ids are
int32, the multiplicity int64. A node reads sizes back to the host (an
expansion total, a live count, a cover's cost, a level's group count),
never rows.

Bag semantics: duplicate tuples live below the deepest trie level; instead of
expanding them eagerly we carry a `mult` column and expand once at output
(duplicates agree on all bound vars, so this is exact).

Factorized counting (Sec 4.4 "factorized representation... to compress large
outputs"): with agg="count", a cover at its last, unforced level whose vars
are never used again contributes only its subtree sizes to `mult` — no
expansion. This is the optimization behind the paper's Fig. 19.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.colt import Colt
from repro_torch.core.plan import FreeJoinPlan, Subatom
from repro_torch.relational.npkit import flatnonzero
from repro_torch.relational.relation import Relation


def _take(x: torch.Tensor, src: torch.Tensor | None) -> torch.Tensor:
    return x if src is None else x[src]


@dataclass
class Frontier:
    n: int
    mult: torch.Tensor
    bound: dict[str, torch.Tensor] = field(default_factory=dict)
    gid: dict[str, torch.Tensor] = field(default_factory=dict)

    def expand(self, fr: torch.Tensor) -> None:
        self.mult = self.mult[fr]
        self.bound = {k: v[fr] for k, v in self.bound.items()}
        self.gid = {k: v[fr] for k, v in self.gid.items()}
        self.n = fr.shape[0]

    def filter(self, mask: torch.Tensor) -> torch.Tensor | None:
        """Keep the rows where `mask` is True, in order, compacted by the
        compaction kernel (K3). Returns the kept rows' indices, for the
        caller's own columns, or None when every row is kept."""
        src = flatnonzero(mask)
        if src.shape[0] == self.n:
            return None
        self.mult = self.mult[src]
        self.bound = {k: v[src] for k, v in self.bound.items()}
        self.gid = {k: v[src] for k, v in self.gid.items()}
        self.n = src.shape[0]
        return src

    def gids_for(self, alias: str) -> torch.Tensor:
        if alias not in self.gid:
            self.gid[alias] = torch.zeros(self.n, dtype=torch.int32, device=self.mult.device)
        return self.gid[alias]


@dataclass
class ExecStats:
    build_ns: int = 0
    max_frontier: int = 0
    probes: int = 0
    expansions: int = 0


def execute(
    plan: FreeJoinPlan,
    relations: dict[str, Relation],
    *,
    mode: str | dict[str, str] = "colt",
    dynamic_cover: bool = True,
    agg: str | None = None,
    stats: ExecStats | None = None,
    tries: dict[str, Colt] | None = None,
    device="cuda",
):
    """Run a Free Join plan on `device`. Returns (bound, mult) where bound
    maps each bound variable to a column and mult is the per-row
    multiplicity, as int64 host numpy arrays — or the scalar count (an
    int) when agg == "count".

    `tries` lets a caller reuse already-(partially-)built Colt tries across
    calls of the same plan shape; stats.build_ns then accounts only the
    forcing done by this call (before/after snapshot, not the tries'
    lifetime totals)."""
    plan.validate()
    parts = plan.partitions()
    modes = mode if isinstance(mode, dict) else {a: mode for a in parts}
    if tries is None:
        # construction may force levels (simple/slt modes): that build time
        # belongs to this call, so the snapshot baseline is zero
        build_ns_before = 0
        tries = {
            alias: Colt(relations[alias], parts[alias], mode=modes.get(alias, "colt"),
                        device=device)
            for alias in parts
        }
    else:
        build_ns_before = sum(t.build_ns for t in tries.values())
    depth = {alias: 0 for alias in parts}
    f = Frontier(n=1, mult=torch.ones(1, dtype=torch.int64, device=torch.device(device)))

    for k, node in enumerate(plan.nodes):
        subs = [sa for sa in node if sa.vars]
        if not subs:
            continue
        cover = _choose_cover(plan, k, subs, tries, depth, dynamic_cover, f)
        probes = [sa for sa in subs if sa is not cover]

        needed_later = _needed_later(plan, k, probes, agg)
        if (
            agg == "count"
            and not (set(cover.vars) & needed_later)
            and not any(v in f.bound for v in cover.vars)
            and depth[cover.alias] == tries[cover.alias].L - 1
            and depth[cover.alias] == tries[cover.alias].forced_depth
        ):
            # factorized count: fold subtree sizes into mult, skip expansion
            t = tries[cover.alias]
            g = f.gids_for(cover.alias)
            f.mult = f.mult * t.subtree_sizes(depth[cover.alias], g)
            f.gid.pop(cover.alias, None)
            depth[cover.alias] = t.L
        else:
            _iterate_cover(f, cover, tries, depth, stats)
        for sa in probes:
            _probe(f, sa, tries, depth, stats)
            if f.n == 0:
                break
        if stats is not None:
            stats.max_frontier = max(stats.max_frontier, f.n)
        if f.n == 0:
            break

    if stats is not None:
        stats.build_ns += sum(t.build_ns for t in tries.values()) - build_ns_before
    if agg == "count":
        return int(f.mult.sum())
    bound = {v: c.cpu().numpy().astype(np.int64) for v, c in f.bound.items()}
    return bound, f.mult.cpu().numpy()


def _choose_cover(plan, k, subs, tries, depth, dynamic, f: Frontier):
    covers = [sa for sa in plan.covers(k) if sa.vars]
    covers = [sa for sa in covers if any(sa is s for s in subs)]
    if not covers:
        raise ValueError(f"node {k} has no usable cover")
    if not dynamic or len(covers) == 1:
        return covers[0]
    # Sec 4.4, frontier-conditional: iterate the cover whose expansion is
    # smallest *given the current frontier* (exact per-subtrie sums; the
    # paper's fewest-keys rule is the tuple-at-a-time approximation).
    return min(
        covers,
        key=lambda sa: tries[sa.alias].iter_cost(depth[sa.alias], f.gids_for(sa.alias)),
    )


def _needed_later(plan, k, probes, agg) -> set[str]:
    need: set[str] = set()
    for sa in probes:
        need |= set(sa.vars)
    for node in plan.nodes[k + 1 :]:
        for sa in node:
            need |= set(sa.vars)
    if agg != "count":
        need |= set(plan.query.head)
    return need


def _iterate_cover(f: Frontier, sa: Subatom, tries, depth, stats) -> None:
    t: Colt = tries[sa.alias]
    d = depth[sa.alias]
    gids = f.gids_for(sa.alias)
    fr, cols, new_gids = t.iter_expand(d, gids)
    # A cover may contain vars bound by earlier nodes (possible after
    # dynamic cover selection): those act as a semijoin filter, not a
    # rebinding.
    rebound = [i for i, v in enumerate(sa.vars) if v in f.bound]
    f.expand(fr)
    if rebound:
        keep = torch.ones(fr.shape[0], dtype=torch.bool, device=fr.device)
        for i in rebound:
            keep &= cols[i] == f.bound[sa.vars[i]]
        src = f.filter(keep)
        cols = [_take(c, src) for c in cols]
        if new_gids is not None:
            new_gids = _take(new_gids, src)
    for v, c in zip(sa.vars, cols):
        if v not in f.bound:
            f.bound[v] = c
    if stats is not None:
        stats.expansions += fr.shape[0]
    depth[sa.alias] = d + 1
    if new_gids is None:
        f.gid.pop(sa.alias, None)  # exhausted by direct row iteration
        return
    if depth[sa.alias] == t.L:
        f.mult = f.mult * t.leaf_counts(new_gids)
        f.gid.pop(sa.alias, None)
    else:
        f.gid[sa.alias] = new_gids


def _probe(f: Frontier, sa: Subatom, tries, depth, stats) -> None:
    t: Colt = tries[sa.alias]
    d = depth[sa.alias]
    gids = f.gids_for(sa.alias)
    keys = [f.bound[v] for v in sa.vars]
    res = t.probe(d, gids, keys)
    if stats is not None:
        stats.probes += res.shape[0]
    res = _take(res, f.filter(res >= 0))
    depth[sa.alias] = d + 1
    if depth[sa.alias] == t.L:
        f.mult = f.mult * t.leaf_counts(res)
        f.gid.pop(sa.alias, None)
    else:
        f.gid[sa.alias] = res


def materialize(bound: dict[str, np.ndarray], mult: np.ndarray, head) -> dict[str, np.ndarray]:
    """Expand multiplicities into physical duplicate rows (bag output)."""
    if len(mult) == 0:
        # empty result: later nodes may never have bound their vars
        return {v: bound.get(v, np.zeros(0, dtype=np.int64)) for v in head}
    if mult.max(initial=1) > 1:
        idx = np.repeat(np.arange(len(mult)), mult)
        return {v: bound[v][idx] for v in head}
    return {v: bound[v] for v in head}
