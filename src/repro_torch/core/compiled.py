"""Static-shape Free Join on PyTorch: the device path.

This module runs a Free Join plan with fully static buffer shapes, in two
parts with an explicit contract between them:

* The BUILD (build_trie / StaticTrie) turns a relation's columns into a
  column-oriented lazy trie: one sort over the consumed level vars +
  boundary flags + segment sums. Every tensor keeps the base relation's
  length N (group counts are values, never shapes). Only levels the plan
  probes get hash tables, and a relation that is only iterated at a single
  level skips the build entirely. The sort is the segmented radix sort
  (kernels/radix_sort.py); chained stable comparison sorts remain only for
  keys that may be negative (weighted stage buffers).

* The PROBE program (make_executor / make_chain_executor) takes tries,
  prebuilt or as raw column dicts per alias, and runs the plan over a
  capacity-bounded frontier. Iteration is ops.expand_counted (prefix sum +
  the csr_expand kernel); probing is the hash_probe kernel; predicted-dead
  frontiers are compacted (the compact kernel). Bag semantics via a mult
  column; factorized counting decided statically from the plan.

* The cross-call TRIE CACHE (TrieCache / TRIE_CACHE) amortizes builds
  across calls. It is keyed by relation identity (weakref registry, see
  core/relcache.py) + level layout + device + budget, revalidated per
  column by host-array identity, and lazy per level: a schedule probing a
  level the cached build skipped adds exactly that level's table; a level
  sequence prefix-compatible with a cached one reuses the cached sort
  order. Weighted (stage-output) tries are never cached.

* The cache has a DELTA path for relations mutated through
  core/relcache.py's append/delete API, in place of rebuild-on-any-change.
  A mutating relation's trie is padded to a power-of-two capacity bucket
  (_bucket), pad rows carrying PAD_KEY keys and multiplicity 0 so they
  sort to the tail and weigh nothing. An append sorts ONLY the delta
  (segmented radix sort, the delta's own key width) and splices the
  sorted run into the cached level buffers with a rank-merge
  (_merge_append): lex_searchsorted ranks each delta row against the old
  sorted order, position arithmetic scatters both runs into the new
  order, and the trie is rebuilt through the presorted constructor bypass,
  with zero sort passes over old rows. A delete tombstones rows
  (_retire_rows zeroes their weights and refreshes group weights); when
  live/total drops below relcache.COMPACT_RATIO, relcache compacts and
  the next access pays one full rebuild. Counters (delta_merges,
  tombstone_refreshes) make the contract testable: appends move
  delta_merges while builds stands still.

Bushy plans run as one chain (Sec 2.2): make_chain_executor strings every
stage's executor together; a non-root stage runs with agg=None, its
output columns stay on the device as a padded buffer (invalid lanes
stamped PAD_KEY with multiplicity 0), and the next stage builds a
*weighted* StaticTrie straight from that buffer.

The driver contract:

* make_executor builds the probe program for one capacity vector. Buffer
  pressure is reported per node as *required totals*: agg="count" returns
  (count, need_expand, need_compact); agg=None returns (bound columns,
  valid mask, mult, need_expand, need_compact). Node i overflowed iff the
  need exceeds its capacity, and the need is the exact capacity the retry
  loop should jump to.
* AdaptiveExecutor drives the whole chain in an overflow-retry loop (grow
  exactly the offending node straight to its reported need; tighten=True
  also shrinks >2x-oversized buffers to measured needs once), keeping one
  built executor per capacity-vector chain, so `compiles` counts the same
  thing as the reference's jit cache. It reads the need vectors back with
  one device-to-host copy per run and nothing else inside the loop.
* Zero-row relations are handled natively: an empty relation builds a
  StaticTrie whose every frontier expansion yields zero live lanes and
  whose probes match nothing.

Serving adds a batched mode (AdaptiveExecutor(batch=B), behind
serve/join_engine.py): the equality filters of a plan template run in
MASK mode (make_executor(filter_kill=False)). The constants are a (B, F)
matrix, each filter comparison ANDs into a (B, cap) lane mask gathered
along with the frontier, and only the terminal fold reads it, so the
expansions (K2), probes (K1) and compactions (K3) run once for all B
queries. A chain whose filter falls in a non-root stage runs every later
stage once per lane, on that lane's weighted stage buffer. Two more
serving hooks live here: every cached trie and every growth of a cached
runner is accounted with the device-memory governor (core/membudget.py),
and AdaptiveExecutor carries the fault-injection sites of core/faults.py
("compile" where a new executor shape is made, "overflow" and "dispatch"
in __call__).

Gathers here never rely on out-of-range clamping (PyTorch raises where JAX
clamps): every index that can leave its range is clamped explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.core import faults, membudget, relcache
from repro_torch.core.plan import FreeJoinPlan
from repro_torch.core.transfers import TRANSFERS
from repro_torch.kernels import ops
from repro_torch.kernels.radix_sort import lex_searchsorted

# Key stamped on the pad (invalid) lanes of a materialized stage buffer.
# Real join keys are dictionary-encoded int32 >= 0 and never reach int32
# max, so pad rows lose every probe immediately; correctness does not rest
# on that (their multiplicity is 0), it only keeps dead lanes short-lived.
PAD_KEY = 2**31 - 1

_I32 = torch.int32


@dataclass(frozen=True)
class _LevelOps:
    """Static decisions for one atom: which levels are probed/iterated."""

    levels: tuple[tuple[str, ...], ...]
    probed: tuple[bool, ...]  # per level: consumed by probe?


@dataclass(frozen=True)
class StaticSchedule:
    """One static walk of a plan, computed once per query and threaded
    through the whole driver stack (planner, estimator, executor builds).
    entries[i] = (node index, cover subatom, probe subatoms); level_ops maps
    alias -> per-level probe/iterate decisions."""

    entries: tuple
    level_ops: dict

    def __len__(self):
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)


def _static_schedule(plan: FreeJoinPlan) -> StaticSchedule:
    """Walk the plan once, statically: per node pick the cover (first listed
    — plans arrive factored), mark each atom level probe/iterate."""
    parts = plan.partitions()
    consumed: dict[str, int] = {a: 0 for a in parts}
    probed: dict[str, list[bool]] = {a: [False] * len(parts[a]) for a in parts}
    schedule = []
    for k, node in enumerate(plan.nodes):
        subs = [sa for sa in node if sa.vars]
        if not subs:
            continue
        covers = [sa for sa in plan.covers(k) if sa.vars and any(sa is s for s in subs)]
        cover = covers[0]
        probes = tuple(sa for sa in subs if sa is not cover)
        schedule.append((k, cover, probes))
        for sa in probes:
            probed[sa.alias][consumed[sa.alias]] = True
            consumed[sa.alias] += 1
        consumed[cover.alias] += 1
    level_ops = {a: _LevelOps(tuple(parts[a]), tuple(probed[a])) for a in parts}
    return StaticSchedule(entries=tuple(schedule), level_ops=level_ops)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort, keys[0] major: chained stable sorts
    from the least significant key (the jnp.lexsort permutation)."""
    order = torch.arange(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.argsort(key[order], stable=True)]
    return order.to(_I32)


def _segment_sum(values: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """jax.ops.segment_sum with num_segments=n (ids are in [0, n))."""
    out = torch.zeros(n, dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, values)


class StaticTrie:
    """Sort-based trie with static shapes (see module docstring).

    Constructing one IS the build. `key_bits` (one width per level var, in
    level order) routes the sort to the segmented radix sort; None, an
    empty relation, or a weighted build use the chained comparison sort
    (weighted/pad keys can be negative or PAD_KEY-wide).
    `init_order`/`presorted` seed the sort with a cached permutation
    already sorted by the first `presorted` level vars (TrieCache's
    prefix-compatible order sharing).

    `mult` (optional) marks a *weighted* trie built from another stage's
    padded output buffer: row i carries multiplicity mult[i] >= 0, and rows
    with mult 0 are padding (dead executor lanes) that must contribute
    nothing. Weighted tries keep two per-group aggregates — physical row
    counts (for last-level enumeration addressing) and mult sums (for
    factorized counting and bag multiplicity) — and the executor folds the
    per-row mult in (and kills mult-0 lanes) whenever it enumerates physical
    rows."""

    def __init__(
        self,
        cols: dict[str, torch.Tensor],
        lops: _LevelOps,
        budget: int = 32,
        mult: torch.Tensor | None = None,
        key_bits: tuple[int, ...] | None = None,
        init_order: torch.Tensor | None = None,
        presorted: int = 0,
    ):
        self.budget = budget
        self.lops = lops
        self.L = len(lops.levels)
        self.levels = lops.levels
        some = next(iter(cols.values()))
        device = some.device
        self.empty = some.shape[0] == 0
        if self.empty:
            # zero-row relation: keep one sentinel row so every downstream
            # gather has a real operand; iter_counts/rows_under/probe below
            # force zero live lanes, so the sentinel is never observable
            cols = {k: torch.full((1,), -1, dtype=_I32, device=device) for k in cols}
            some = next(iter(cols.values()))
            mult = None
        n = some.shape[0]
        self.n = n
        self.cols = {k: v.to(_I32) for k, v in cols.items()}
        self.mult_col = None if mult is None else mult.to(_I32)
        self.total_mult = None if mult is None else self.mult_col.sum(dtype=_I32)
        self.trivial = self.L == 1 and not lops.probed[0]
        self.order = None
        self.sorted_cols = None
        self.g = self.kpos = None
        self.child_base = self.child_counts = self.row_count = None
        self.row_weight = self.tables = None
        if self.trivial:  # pure cover: iterate the base table, zero build
            return
        all_vars = [v for lv in lops.levels for v in lv]
        if init_order is not None and presorted >= len(all_vars) and not self.empty:
            order = init_order  # a cached order already sorts every level var
        elif key_bits is not None and not self.empty and mult is None:
            order = ops.segmented_sort(
                [self.cols[v] for v in all_vars],
                tuple(key_bits),
                init_order=init_order,
                presorted=presorted,
            )
        else:
            order = _lexsort([self.cols[v] for v in all_vars])
        self.order = order.to(_I32)
        sc = {v: self.cols[v][self.order] for v in all_vars}
        self.sorted_cols = sc
        sm = None if self.mult_col is None else self.mult_col[self.order]
        idx = torch.arange(n, dtype=_I32, device=device)
        # depth-d group ids for d = 0..L, flags for d = 1..L
        self.g = [torch.zeros(n, dtype=_I32, device=device)]  # g[0] = root
        self.kpos = [torch.zeros(1, dtype=_I32, device=device)]  # first position of each group
        flag = torch.zeros(n, dtype=torch.bool, device=device)
        self.child_base, self.child_counts, self.row_count, self.tables = [], [], [], []
        self.row_weight = []
        ones = torch.ones(n, dtype=_I32, device=device)
        # row 0 starts a group at every depth; made on the device, since a
        # Python scalar written into a device tensor is a blocking upload
        first = idx == 0
        for d, lv in enumerate(lops.levels):
            diff = first.clone()
            for v in lv:
                diff[1:] |= sc[v][1:] != sc[v][:-1]
            flag = flag | diff
            flag32 = flag.to(_I32)
            gd1 = torch.cumsum(flag32, dim=0, dtype=_I32) - 1  # g[d+1]
            # children of each depth-d group (counts over depth-(d+1) firsts)
            ccnt = _segment_sum(flag32, self.g[d], n)
            cbase = torch.cumsum(ccnt, dim=0, dtype=_I32) - ccnt
            # first position of each depth-(d+1) group; non-first rows write
            # to the extra slot n, which is cut off
            kp = torch.zeros(n + 1, dtype=_I32, device=device)
            kp[torch.where(flag, gd1, n)] = idx
            rcnt = _segment_sum(ones, gd1, n)
            self.g.append(gd1)
            self.kpos.append(kp[:n])
            self.child_base.append(cbase)
            self.child_counts.append(ccnt)
            self.row_count.append(rcnt)
            if sm is not None:
                self.row_weight.append(_segment_sum(sm, gd1, n))
            # probed levels get their hash table; one shared construction
            # with the lazy path (build_level_table), so eagerly- and
            # lazily-built tables can never drift
            self.tables.append(self.build_level_table(d, budget) if lops.probed[d] else None)

    def build_level_table(self, d: int, budget: int | None = None):
        """Build the depth-d probe table on an already-sorted trie — the
        lazy-COLT path for a schedule that probes a level the cached build
        skipped. Device work is exactly one table build; the sort and the
        group structure are reused."""
        assert not self.trivial and self.g is not None
        lv = self.levels[d]
        n = self.n
        idx = torch.arange(n, dtype=_I32, device=self.order.device)
        gd1 = self.g[d + 1]
        flag = torch.ones(n, dtype=torch.bool, device=gd1.device)
        flag[1:] = gd1[1:] != gd1[:-1]
        parent = torch.where(flag, self.g[d], -idx - 2)
        key_rows = torch.stack(
            [parent] + [torch.where(flag, self.sorted_cols[v], 0) for v in lv], dim=1
        )
        return ops.build_table(key_rows, budget=budget or self.budget)

    def table_view(self, probed: tuple[bool, ...]) -> "StaticTrie":
        """A shallow view sharing every tensor, exposing tables only where
        `probed` asks — so what the executor sees depends only on the
        schedule, not on how many tables the cached build has accumulated."""
        if self.trivial:
            return self
        view = object.__new__(StaticTrie)
        view.__dict__.update(self.__dict__)
        view.lops = replace(self.lops, probed=tuple(probed))
        view.tables = [t if p else None for t, p in zip(self.tables, probed)]
        return view

    # depth-d group sizes (weighted by mult for stage tries): drives
    # factorized count and last-level probe multiplicity
    def rows_under(self, d: int, gids: torch.Tensor) -> torch.Tensor:
        if self.empty:
            return torch.zeros(gids.shape, dtype=_I32, device=gids.device)
        if self.trivial or d == 0:
            if self.total_mult is not None:
                return self.total_mult.expand(gids.shape)
            return torch.full(gids.shape, self.n, dtype=_I32, device=gids.device)
        if self.mult_col is not None:
            return self.row_weight[d - 1][gids]
        return self.row_count[d - 1][gids]

    # physical depth-d group sizes: addressing for last-level enumeration
    def _phys_rows(self, d: int, gids: torch.Tensor) -> torch.Tensor:
        if self.trivial or d == 0:
            return torch.full(gids.shape, self.n, dtype=_I32, device=gids.device)
        return self.row_count[d - 1][gids]

    def probe(self, d: int, gids, key_cols):
        if self.empty:  # nothing to match: kill every probing lane
            return torch.full(gids.shape, -1, dtype=_I32, device=gids.device)
        q = torch.stack([gids.to(_I32)] + [c.to(_I32) for c in key_cols], dim=1)
        p = ops.probe(self.tables[d], q)
        child = self.g[d + 1][p.clamp(0, self.n - 1)]
        return torch.where(p >= 0, child, -1)

    def iter_counts(self, d: int, gids, last: bool):
        """(base, counts) for expand_counted at level d from groups `gids`.
        last=True enumerates rows; otherwise enumerates child groups."""
        z = torch.zeros(gids.shape, dtype=_I32, device=gids.device)
        if self.empty:  # every expansion yields zero live lanes
            return z, z
        if self.trivial:
            return z, torch.full(gids.shape, self.n, dtype=_I32, device=gids.device)
        if last:
            base = self.kpos[d][gids.clamp(0, self.n - 1)] if d > 0 else z
            return base, self._phys_rows(d, gids)
        return self.child_base[d][gids], self.child_counts[d][gids]

    def bind_iter(self, d: int, members, last: bool):
        """Column values bound by iterating; members from expand_counted.
        Returns (cols list in level-var order, new_gids or None)."""
        lv = self.levels[d]
        if self.trivial:
            return [self.cols[v][members] for v in lv], None
        if last:
            rows = self.order[members]
            return [self.cols[v][rows] for v in lv], self.g[d + 1][members]
        kp = self.kpos[d + 1][members]
        return [self.sorted_cols[v][kp] for v in lv], members

    def iter_mult(self, members) -> torch.Tensor | None:
        """Per-row multiplicity of the physical rows enumerated by a
        last-level bind_iter (None for unweighted tries: each row counts 1).
        A zero marks a pad row — the executor kills that lane."""
        if self.mult_col is None:
            return None
        rows = members if self.trivial else self.order[members]
        return self.mult_col[rows]


def build_trie(
    cols: dict[str, torch.Tensor],
    lops: _LevelOps,
    *,
    budget: int = 32,
    mult: torch.Tensor | None = None,
    key_bits: tuple[int, ...] | None = None,
    init_order: torch.Tensor | None = None,
    presorted: int = 0,
) -> StaticTrie:
    """The explicit build step: columns in, a StaticTrie of tensors on the
    columns' device out."""
    return StaticTrie(
        cols,
        lops,
        budget,
        mult=mult,
        key_bits=key_bits,
        init_order=init_order,
        presorted=presorted,
    )


def _bucket(n: int, block: int = 1024) -> int:
    """Physical capacity for a mutating relation's padded trie: the next
    power of two >= n (min `block`). Appends within a bucket keep every
    tensor shape fixed; shapes change only when the bucket grows."""
    return max(block, 1 << max(0, n - 1).bit_length())


def _merge_append(
    old_cols: dict[str, torch.Tensor],
    old_mult: torch.Tensor | None,
    old_sorted: dict[str, torch.Tensor] | None,
    old_order: torch.Tensor | None,
    n_real: int,
    delta_cols: dict[str, torch.Tensor],
    *,
    lops: _LevelOps,
    budget: int,
    cap: int,
    delta_bits: tuple[int, ...],
) -> StaticTrie:
    """Splice a sorted delta run into a cached padded trie: the delta
    build. Sorts ONLY the delta (segmented radix sort over the delta's own
    key widths), binary-searches each delta tuple's slot in the cached
    sorted run (radix_sort.lex_searchsorted), and derives the merged
    permutation arithmetically; the constructor's presorted bypass then
    rebuilds the group structure with zero sorting passes.

    `n_real` (the live+tombstone prefix length) is a host int: every size
    here is known on the host, so nothing is read back. Pad rows (keys
    PAD_KEY, mult 0) sort after all real rows, so they stay a contiguous
    tail that the merge shifts with elementwise ops; pads pushed past the
    (possibly grown) capacity `cap` are written to one spare slot that is
    cut off."""
    flat = [v for lv in lops.levels for v in lv]
    some = next(iter(old_cols.values()))
    device = some.device
    c_old = some.shape[0]
    m = next(iter(delta_cols.values())).shape[0]
    n_new = n_real + m  # cap >= n_new by construction (_bucket)
    idx = torch.arange(cap, dtype=_I32, device=device)

    def extend(a, fill):
        out = torch.full((cap,), fill, dtype=_I32, device=device)
        out[:c_old] = a
        return out

    new_cols = {}
    for v in old_cols:
        col = extend(old_cols[v], PAD_KEY)
        col[n_real:n_new] = delta_cols[v]
        new_cols[v] = col
    om = old_mult if old_mult is not None else torch.ones(c_old, dtype=_I32, device=device)
    new_mult = extend(torch.where(idx[:c_old] < n_real, om, 0), 0)
    new_mult = torch.where((idx >= n_real) & (idx < n_new), 1, new_mult)
    if len(lops.levels) == 1 and not lops.probed[0]:
        # trivial (cover-only) trie: no order to maintain, just new columns
        return build_trie(new_cols, lops, budget=budget, mult=new_mult)
    # sort the delta among itself, then locate each tuple's splice slot
    delta_order = ops.segmented_sort([delta_cols[v] for v in flat], tuple(delta_bits))
    ds = {v: delta_cols[v][delta_order] for v in flat}
    # rank in the cached sorted run; real keys < PAD_KEY, so ranks never
    # land inside the pad tail and the merged real prefix is exactly n_new
    rank = lex_searchsorted([old_sorted[v] for v in flat], [ds[v] for v in flat])
    pos_delta = rank + torch.arange(m, dtype=_I32, device=device)
    k = idx[:c_old]
    pos_old = k + torch.searchsorted(rank, k, right=True, out_int32=True)
    # delta rows take indices [n_real, n_new); old pads shift up by m
    adj = old_order + torch.where(old_order >= n_real, m, 0).to(_I32)
    new_order = torch.zeros(cap + 1, dtype=_I32, device=device)
    new_order[torch.where(pos_old < cap, pos_old, cap)] = adj
    new_order[pos_delta] = n_real + delta_order
    # pads are interchangeable: identity-map the tail so `new_order` stays a
    # permutation however many pads fell on the spare slot
    new_order = torch.where(idx >= n_new, idx, new_order[:cap])
    return build_trie(
        new_cols,
        lops,
        budget=budget,
        mult=new_mult,
        init_order=new_order,
        presorted=len(flat),
    )


def _retire_rows(mult: torch.Tensor, order, groups, rows: torch.Tensor):
    """Tombstone catch-up on a cached trie: zero the rows' multiplicity and
    refresh the per-level weight aggregates. The sort order, the group
    structure and the hash tables are untouched: dead rows keep their
    slots and simply weigh nothing. Returns new tensors and modifies none:
    views of the trie already handed out keep the weights they were
    served with."""
    mult = mult.index_fill(0, rows.to(torch.int64), 0)
    total = mult.sum(dtype=_I32)
    sm = mult[order] if order is not None else mult
    weights = [_segment_sum(sm, gd1, mult.shape[0]) for gd1 in groups]
    return mult, total, weights


def device_columns(rel, device) -> dict[str, torch.Tensor]:
    """Registry-cached int32 upload of a relation's columns to `device`:
    each host column is transferred once per (relation object, column
    object, device) and the upload dies with the relation. Replacing a
    column in rel.columns re-uploads exactly that column (identity check);
    mutating a numpy array in place is not detectable and not supported —
    replace the array."""
    device = torch.device(device)
    return {
        v: relcache.memo(
            relcache.REGISTRY,
            rel,
            "dev_cols",
            (str(device), v),
            rel.columns[v],
            lambda v=v: TRANSFERS.to_device(
                np.asarray(rel.columns[v], dtype=np.int32), device, f"column {v}"
            ),
        )
        for v in rel.schema
    }


class TrieCache:
    """Cross-call StaticTrie cache (see module docstring).

    One entry per (relation object, level layout, device, budget), held in
    the weakref registry so it dies with the relation; revalidated per
    column by host-array identity, so a replaced column rebuilds. Lazy per
    level: a request probing a level the cached build skipped adds only
    that level's table (build_level_table); a level-var sequence sharing a
    prefix with a cached one seeds the sort with the cached order and skips
    the shared passes.

    MUTATING relations (those with a relcache.MutationState, i.e. touched
    by relcache.append/delete) take the versioned DELTA path instead of
    identity revalidation. Their entries carry the mutation version they
    materialized at plus `n_real` (live+tombstone row prefix), and the trie
    itself is padded to a power-of-two bucket: pad rows carry PAD_KEY keys
    and multiplicity 0, sorted to a contiguous tail. Serving one then means:

    * version match: a pure cache hit, zero device work;
    * version behind: replay `deltas_since`. An append sorts ONLY the
      delta and splices it into the cached sorted run (_merge_append, zero
      full re-sorts; `delta_merges` counts these); a delete refreshes the
      weight aggregates (`tombstone_refreshes`);
    * log pruned / compaction crossed / negative delta keys: a full padded
      weighted rebuild (counted in `builds`, like any cold build).

    A trie built BEFORE the relation's first mutation is adopted as the
    version-0 merge base when it is over the state's version-0 device
    columns on the same device, so warm-then-stream never pays a rebuild.

    Counters (builds/table_builds/hits/order_shares/delta_merges/
    tombstone_refreshes) are the observable contract the tests lock: a
    repeated identical call must be all hits, and an append followed by a
    query must move delta_merges, never builds.
    """

    def __init__(self, registry: relcache.RelationRegistry | None = None):
        self._reg = registry or relcache.REGISTRY
        self.builds = 0  # full trie builds (sort + structure + tables)
        self.table_builds = 0  # lazy per-level table additions
        self.hits = 0  # fully served from cache: zero device work
        self.order_shares = 0  # builds that reused a cached sort order
        self.delta_merges = 0  # appends absorbed by sorted-run splicing
        self.tombstone_refreshes = 0  # deletes absorbed by weight refresh

    @staticmethod
    def entry_key(lops: _LevelOps, device, budget: int) -> tuple:
        """The registry key of a relation's cached trie for one layout.
        Trivial-ness is part of the identity: a cover-only (table-less,
        order-less) trie must never be served to a schedule that probes."""
        trivial = len(lops.levels) == 1 and not lops.probed[0]
        return (lops.levels, str(torch.device(device)), budget, trivial)

    def _key_bits(self, rel, flat_vars) -> tuple[int, ...] | None:
        """Static per-var key widths for the radix sort, from the host
        columns (cached per column object). None when any key may be
        negative — those builds take the comparison sort."""
        def width_of(host):
            def compute():
                if len(host) == 0:
                    return 1
                if int(host.min()) < 0:
                    return None
                return max(1, int(host.max()).bit_length())

            return compute

        bits = []
        for v in flat_vars:
            host = rel.columns[v]
            w = relcache.memo(self._reg, rel, "key_bits", v, host, width_of(host))
            if w is None:
                return None
            bits.append(w)
        return tuple(bits)

    def get(
        self,
        rel,
        dev_cols: dict[str, torch.Tensor],
        lops: _LevelOps,
        *,
        budget: int = 32,
    ) -> StaticTrie:
        ns = self._reg.namespace(rel, "tries")
        flat = tuple(v for lv in lops.levels for v in lv)
        used = {v: dev_cols[v] for v in flat}
        device = next(iter(used.values())).device
        key = self.entry_key(lops, device, budget)
        st = relcache.mutation_state(rel)
        if st is not None:
            return self._get_mutating(rel, st, dev_cols, lops, flat, key, budget)
        entry = ns.get(key)
        if (
            entry is not None
            and entry.get("version") is None
            and all(entry["cols"][v] is used[v] for v in flat)
        ):
            view = self._serve(entry["trie"], lops, budget, count_hit=True)
            self._govern(rel, ns, key)
            return view
        # miss: build, seeding the sort with any prefix-compatible cached
        # order over the same (identical) columns
        key_bits = self._key_bits(rel, flat)
        init_order, presorted = None, 0
        if key_bits is not None and not key[3]:
            for (levels2, device2, _b2, _t2), e2 in ns.items():
                donor = e2["trie"]
                if donor.order is None or device2 != key[1] or e2.get("version") is not None:
                    continue  # padded mutating orders never seed plain builds
                flat2 = tuple(v for lv in levels2 for v in lv)
                share = 0
                while (
                    share < min(len(flat), len(flat2))
                    and flat[share] == flat2[share]
                    and e2["cols"][flat2[share]] is used[flat[share]]
                ):
                    share += 1
                if share > presorted:
                    init_order, presorted = donor.order, share
        trie = build_trie(
            used, lops, budget=budget, key_bits=key_bits,
            init_order=init_order, presorted=presorted,
        )
        ns[key] = {"trie": trie, "cols": used}
        self.builds += 1
        if presorted:
            self.order_shares += 1
        self._govern(rel, ns, key)
        return trie.table_view(lops.probed)

    def _govern(self, rel, ns, key) -> None:
        """Account the cached entry's device bytes with the memory
        governor (an LRU touch on every serve, a resize when lazy tables or
        delta merges changed the footprint). If the governor sheds (this
        trie alone cannot fit the budget even after evicting every cold
        entry), the entry is dropped and the trie serves this one call
        uncached, keeping the governed-bytes invariant intact."""
        entry = ns.get(key)
        if entry is None:
            return
        token = ("trie", id(rel), key)
        try:
            membudget.GOVERNOR.account(
                token,
                membudget.trie_nbytes(entry["trie"]),
                evict=lambda _ns=ns, _k=key: _ns.pop(_k, None),
                owner=rel,
            )
        except membudget.MemoryBudgetError:
            ns.pop(key, None)
            membudget.GOVERNOR.release(token)

    def _serve(self, trie: StaticTrie, lops, budget, *, count_hit: bool):
        """Fill any probe tables the request needs that the cached build
        skipped (the lazy-COLT path), then hand out a probed view."""
        missing = [
            d
            for d, p in enumerate(lops.probed)
            if p and not trie.trivial and trie.tables[d] is None
        ]
        for d in missing:
            trie.tables[d] = trie.build_level_table(d, budget)
            self.table_builds += 1
        if count_hit and not missing:
            self.hits += 1
        return trie.table_view(lops.probed)

    def _get_mutating(self, rel, st, dev_cols, lops, flat, key, budget):
        """Serve a mutating relation: version-matched hit, delta catch-up
        (merge appends, retire deletes), or full padded rebuild."""
        ns = self._reg.namespace(rel, "tries")
        device = key[1]
        entry = ns.get(key)
        if entry is not None and entry.get("version") is None:
            # built before the first mutation: adopt as the version-0 merge
            # base iff it is over the state's version-0 device columns on
            # this device (and no compaction/pruning has moved the base past
            # version 0)
            trie = entry["trie"]
            if (
                st.base_version == 0
                and not trie.empty
                and all(entry["cols"].get(v) is st.dev0.get((device, v)) for v in flat)
            ):
                entry["version"] = 0
                entry["n_real"] = trie.n
            else:
                entry = None
        deltas = None
        if entry is not None:
            deltas = st.deltas_since(entry["version"])
            if deltas is None or entry["trie"].empty:
                entry = None  # pruned log or sentinel empty trie: rebuild
        if entry is not None:
            trie = entry["trie"]
            if not deltas:
                view = self._serve(trie, lops, budget, count_hit=True)
                self._govern(rel, ns, key)
                return view
            for _ver, kind, payload in deltas:
                if kind == "append":
                    merged = self._merge_append(trie, entry["n_real"], payload, lops, budget)
                    if merged is None:  # negative delta keys: comparison sort only
                        entry = None
                        break
                    trie = merged
                    entry["n_real"] += len(next(iter(payload.values())))
                    self.delta_merges += 1
                else:
                    self._retire(trie, payload)
                    self.tombstone_refreshes += 1
            if entry is not None:
                entry["trie"] = trie
                entry["cols"] = dict(trie.cols)
                entry["version"] = st.version
                view = self._serve(trie, lops, budget, count_hit=False)
                self._govern(rel, ns, key)
                return view
        # full rebuild, padded to the bucket and weighted by the liveness
        # mask, so later appends merge and later deletes retire in place
        cap = _bucket(st.total)
        pad = cap - st.total
        used = {}
        for v in flat:
            dc = dev_cols[v]
            used[v] = (
                torch.cat([dc, torch.full((pad,), PAD_KEY, dtype=_I32, device=dc.device)])
                if pad else dc
            )
        dev = next(iter(used.values())).device
        if st.mult is not None:
            hm = np.concatenate([st.mult, np.zeros(pad, np.int32)])
            mult = TRANSFERS.to_device(hm, dev, "row weights")
        else:
            mult = (torch.arange(cap, dtype=_I32, device=dev) < st.total).to(_I32)
        # pads carry PAD_KEY keys and mult 0: the comparison sort routes
        # them to the tail, where every later merge expects them
        trie = build_trie(used, lops, budget=budget, mult=mult)
        ns[key] = {
            "trie": trie,
            "cols": dict(trie.cols),
            "version": st.version,
            "n_real": st.total,
        }
        self.builds += 1
        view = self._serve(trie, lops, budget, count_hit=False)
        self._govern(rel, ns, key)
        return view

    def _merge_append(self, trie, n_real, payload, lops, budget):
        """Host wrapper for one append log entry: delta key widths, bucket
        growth, the delta's upload, and the probed-union layout (a merge
        rebuilds every table the cached trie had accumulated, so other
        schedules stay warm). Returns None when the delta has negative
        keys, which the radix delta sort cannot order."""
        flat = tuple(v for lv in lops.levels for v in lv)
        m = len(next(iter(payload.values())))
        bits = []
        for v in flat:
            col = payload[v]
            if int(col.min()) < 0:
                return None
            bits.append(max(1, int(col.max()).bit_length()))
        device = next(iter(trie.cols.values())).device
        delta_dev = {
            v: TRANSFERS.to_device(np.asarray(payload[v], dtype=np.int32), device, "appended rows")
            for v in flat
        }
        if trie.trivial:
            mlops = lops
        else:
            mlops = replace(
                lops,
                probed=tuple(
                    (t is not None) or p for t, p in zip(trie.tables, lops.probed)
                ),
            )
        return _merge_append(
            {v: trie.cols[v] for v in flat},
            trie.mult_col,
            trie.sorted_cols,
            trie.order,
            n_real,
            delta_dev,
            lops=mlops,
            budget=budget,
            cap=_bucket(n_real + m),
            delta_bits=tuple(bits),
        )

    def _retire(self, trie, rows):
        """Apply one delete log entry to the cached trie: rows are host
        positions, which by the padding invariant are trie row indices
        verbatim. Order, groups and tables are untouched."""
        device = next(iter(trie.cols.values())).device
        mult = trie.mult_col
        if mult is None:
            mult = torch.ones(trie.n, dtype=_I32, device=device)
        groups = [] if trie.trivial else trie.g[1:]
        mult, total, weights = _retire_rows(
            mult, trie.order, groups, TRANSFERS.to_device(rows, device, "deleted rows")
        )
        trie.mult_col = mult
        trie.total_mult = total
        if not trie.trivial:
            trie.row_weight = weights


TRIE_CACHE = TrieCache()


def make_executor(
    plan: FreeJoinPlan,
    capacities,
    *,
    compact_to=None,
    compact_probe=None,
    budget: int = 32,
    agg: str | None = "count",
    schedule: StaticSchedule | None = None,
    filters: tuple = (),
    filter_kill: bool = True,
):
    """Build the probe program for `plan` (see module docstring).

    capacities: one static expansion capacity per executed node; compact_to:
    optional per-node compaction target (None = keep the buffer);
    compact_probe: per node, how many probes run before compacting (default
    all — compact after the node; smaller values compact mid-node so the
    remaining probes run at the squeezed width); schedule: the query's
    StaticSchedule if the driver already computed it. Returns
    fn(rel_data, rel_mults, filter_consts) ->
      agg="count":  (count, need_expand, need_compact)
      agg=None:     (bound, valid, mult, need_expand, need_compact)
    rel_data maps alias -> either a prebuilt StaticTrie (the warm path:
    zero build work in this call) or {var: (N,) int32} raw columns (built
    here — the cold path, and the only path for weighted stage buffers).
    rel_mults (optional) maps an alias to a per-row multiplicity vector;
    such a relation is a *weighted* (stage-output) buffer whose mult-0 rows
    are padding — see StaticTrie. need_expand/need_compact are
    (num_executed_nodes,) int32 tensors of required totals. The count is
    summed in int64; the reference sums in int32, so the two differ only
    where the reference wraps at 2**31.

    filters: ((var, const_index), ...) — equality selections whose
    constants are a runtime int32 tensor `filter_consts`, compared against
    `bound[var]` the moment `var` is bound. Two dispositions for the
    comparison's outcome:

    * filter_kill=True (one query): filter_consts is (F,) and the
      comparison ANDs into `valid`; filter-dead lanes stop probing
      immediately and compaction squeezes them out.
    * filter_kill=False (a batch of B queries of one template):
      filter_consts is (B, F) and the comparison ANDs into a separate
      (B, cap) mask, `fvalid`, gathered along with the frontier and folded
      in only at the end. `valid`, every expansion, probe and compaction
      stay independent of the constants, so the probe pipeline runs once
      for all B lanes. The outputs then carry a leading lane axis: counts
      (B,) int64, or bound/valid/mult (B, cap), and the need vectors
      (B, num_executed_nodes), a lane-independent tensor broadcast along
      it.
    """
    plan.validate()
    filters = tuple(filters)
    filter_idx = {v: int(i) for v, i in filters}
    unknown = set(filter_idx) - set(plan.query.variables)
    if unknown:
        raise ValueError(f"filter vars not bound by this plan: {sorted(unknown)}")
    if schedule is None:
        schedule = _static_schedule(plan)
    level_ops = schedule.level_ops
    schedule = schedule.entries
    nsched = len(schedule)
    capacities = tuple(int(c) for c in capacities[:nsched])
    compact_to = tuple(compact_to[:nsched]) if compact_to is not None else (None,) * nsched
    compact_probe = (
        tuple(compact_probe[:nsched])
        if compact_probe
        else tuple(len(probes) for _, _, probes in schedule)
    )
    if not len(capacities) == len(compact_to) == len(compact_probe) == nsched:
        raise ValueError("one capacity, compaction target and compact point per executed node")

    def as_trie(src, lops: _LevelOps, mult):
        if isinstance(src, StaticTrie):
            if src.levels != lops.levels:
                raise ValueError("prebuilt trie level mismatch")
            for d, p in enumerate(lops.probed):
                if p and not src.trivial and src.tables[d] is None:
                    raise ValueError(f"prebuilt trie missing probed level-{d} table")
            return src
        return build_trie(src, lops, budget=budget, mult=mult)

    def run(
        rel_data: dict[str, object],
        rel_mults: dict[str, torch.Tensor] | None = None,
        filter_consts: torch.Tensor | None = None,
    ):
        if filter_idx and filter_consts is None:
            raise ValueError("this executor was built with filters; pass filter_consts")
        batched = not filter_kill and filter_consts is not None
        mults = rel_mults or {}
        tries = {
            a: as_trie(rel_data[a], level_ops[a], mults.get(a)) for a in level_ops
        }
        device = next(iter(next(iter(tries.values())).cols.values())).device
        # mask-mode filter state: (B, cap) per-lane liveness that never
        # feeds the frontier layout; created at the first filter comparison
        fvalid = None
        depth = {a: 0 for a in level_ops}
        # frontier
        cap = 1
        valid = torch.ones(1, dtype=torch.bool, device=device)
        mult = torch.ones(1, dtype=_I32, device=device)
        bound: dict[str, torch.Tensor] = {}
        gid: dict[str, torch.Tensor] = {}
        zero = torch.zeros((), dtype=_I32, device=device)
        need_expand = [zero] * nsched
        need_compact = [zero] * nsched

        def squeeze(bound, gid, mult, valid, fvalid, cap, c_compact, i):
            """Pack the valid lanes into a fresh c_compact-wide frontier
            (on `valid` alone: the mask-mode filter mask rides along)."""
            src, live = ops.compact_indices(valid, c_compact)
            need_compact[i] = live
            srcc = src.clamp(0, cap - 1)
            bound = {v: a[srcc] for v, a in bound.items()}
            gid = {a: arr[srcc] for a, arr in gid.items()}
            mult = mult[srcc]
            if fvalid is not None:
                fvalid = fvalid[:, srcc]
            valid = torch.arange(c_compact, dtype=_I32, device=device) < live
            return bound, gid, mult, valid, fvalid, c_compact

        for i, ((k, cover, probes), c_next, c_compact, cp_idx) in enumerate(
            zip(schedule, capacities, compact_to, compact_probe)
        ):
            t = tries[cover.alias]
            d = depth[cover.alias]
            g = gid.get(cover.alias, torch.zeros(cap, dtype=_I32, device=device))
            last = d == t.L - 1
            # a filtered var can never take the factorized-count shortcut:
            # its comparison against the constant needs the bound values
            needed = _needed_later_static(plan, k, probes, agg) | set(filter_idx)
            if agg == "count" and not (set(cover.vars) & needed) and last and not (
                set(cover.vars) & set(bound)
            ):
                # factorized count (static decision)
                mult = mult * torch.where(valid, t.rows_under(d, g), 1)
                gid.pop(cover.alias, None)
                depth[cover.alias] = t.L
            else:
                base, counts = t.iter_counts(d, g, last)
                counts = torch.where(valid, counts, 0)
                fr, member, vnew, total = ops.expand_counted(base, counts, c_next)
                need_expand[i] = total
                frc = fr.clamp(0, cap - 1)
                memc = member.clamp(0, max(t.n - 1, 0))
                bound = {v: a[frc] for v, a in bound.items()}
                gid = {a: arr[frc] for a, arr in gid.items()}
                mult = mult[frc]
                if fvalid is not None:
                    fvalid = fvalid[:, frc]
                valid = vnew
                cap = c_next
                cols, new_g = t.bind_iter(d, memc, last)
                for v, cvals in zip(cover.vars, cols):
                    if v in bound:  # semijoin on re-bound vars
                        valid = valid & (bound[v] == cvals)
                    else:
                        bound[v] = cvals
                        if v in filter_idx and filter_kill:  # constant
                            # selection the moment the var is bound: dead
                            # lanes never reach a probe
                            valid = valid & (cvals == filter_consts[filter_idx[v]])
                        elif v in filter_idx:  # layout-neutral lane mask
                            hit = cvals[None, :] == filter_consts[:, filter_idx[v], None]
                            fvalid = hit if fvalid is None else fvalid & hit
                depth[cover.alias] = d + 1
                if new_g is None or depth[cover.alias] == t.L:
                    # last-level iteration enumerates physical rows, so bag
                    # multiplicity is already accounted for — except on a
                    # weighted (stage-output) trie, whose per-row mult folds
                    # in here and whose mult-0 pad rows die on the spot.
                    rm = t.iter_mult(memc)
                    if rm is not None:
                        mult = mult * torch.where(valid, rm, 1)
                        valid = valid & (rm > 0)
                    gid.pop(cover.alias, None)
                else:
                    gid[cover.alias] = new_g
            compacted = False
            for j, sa in enumerate(probes):
                tp = tries[sa.alias]
                dp = depth[sa.alias]
                gp = gid.get(sa.alias, torch.zeros(cap, dtype=_I32, device=device))
                keys = [bound[v] for v in sa.vars]
                child = tp.probe(dp, torch.where(valid, gp, -1), keys)
                valid = valid & (child >= 0)
                childc = child.clamp(0, max(tp.n - 1, 0))
                depth[sa.alias] = dp + 1
                if depth[sa.alias] == tp.L:
                    mult = mult * torch.where(valid, tp.rows_under(tp.L, childc), 1)
                    gid.pop(sa.alias, None)
                else:
                    gid[sa.alias] = childc
                if c_compact is not None and not compacted and j + 1 >= cp_idx and c_compact < cap:
                    # squeeze dead lanes out mid-node: the remaining probes
                    # (and all later nodes) run at c_compact
                    bound, gid, mult, valid, fvalid, cap = squeeze(
                        bound, gid, mult, valid, fvalid, cap, c_compact, i
                    )
                    compacted = True
            if c_compact is not None and not compacted and c_compact < cap:
                # probe-less node (or unreached compact point): after-node
                bound, gid, mult, valid, fvalid, cap = squeeze(
                    bound, gid, mult, valid, fvalid, cap, c_compact, i
                )
        ne = torch.stack(need_expand) if nsched else torch.zeros(0, dtype=_I32, device=device)
        nc = torch.stack(need_compact) if nsched else torch.zeros(0, dtype=_I32, device=device)
        if batched:
            return _fold_lanes(agg, bound, valid, mult, fvalid, ne, nc, filter_consts.shape[0])
        if agg == "count":
            return torch.where(valid, mult, 0).sum(dtype=torch.int64), ne, nc
        # lanes that went through a weighted trie's probe path can survive
        # with mult 0 (pad groups weigh nothing); they are not output rows
        valid = valid & (mult > 0)
        return bound, valid, mult, ne, nc

    return run


def _fold_lanes(agg, bound, valid, mult, fvalid, ne, nc, lanes: int):
    """The mask-mode terminal fold: the shared frontier and the (B, cap)
    filter mask give each lane's result. Counts are (B,) int64; agg=None
    gives (B, cap) bound/valid/mult. Lane-independent tensors (the needs,
    and everything when no filter var was bound) are broadcast views."""

    def lanewise(t):
        return t.expand(lanes, *t.shape)

    if agg == "count":
        w = torch.where(valid, mult, 0).to(torch.int64)
        if fvalid is None:
            return lanewise(w.sum()), lanewise(ne), lanewise(nc)
        return (w[None, :] * fvalid).sum(dim=1), lanewise(ne), lanewise(nc)
    valid = valid & (mult > 0)
    valid = lanewise(valid) if fvalid is None else valid[None, :] & fvalid
    return (
        {v: lanewise(a) for v, a in bound.items()},
        valid,
        lanewise(mult),
        lanewise(ne),
        lanewise(nc),
    )


def overflows(cap_plan, need_expand, need_compact):
    """Per-node overflow bits from the executor's reported needs and the
    capacity plan the run used: (ovf_expand, ovf_compact) bool arrays."""
    ne = np.asarray(need_expand)
    nc = np.asarray(need_compact)
    caps = np.asarray(cap_plan.capacities, np.int64)
    cts = np.array(
        [np.iinfo(np.int64).max if c is None else c for c in cap_plan.compact_to], np.int64
    )
    return ne > caps, nc > cts


def make_chain_executor(
    stages,
    cap_plans,
    *,
    budget: int = 32,
    agg: str | None = "count",
    filter_vars: tuple[str, ...] = (),
    filter_kill: bool = True,
):
    """One device program for a whole bushy plan (Sec 2.2 stages).

    stages: ((name, FreeJoinPlan), ...) with the root stage last — each plan
    may reference earlier stages' names as relation aliases; cap_plans: one
    CapacityPlan per stage (schedule riding along). Every non-root stage
    runs its make_executor with agg=None, its output columns stay on the
    device as a padded buffer (invalid lanes stamped PAD_KEY, multiplicity
    0), and the next stage builds a weighted StaticTrie straight from that
    buffer — no host round-trip. Returns
        run(rel_data) -> (root outputs..., need_expand_t, need_compact_t)
    where rel_data holds the *base* relations only — prebuilt StaticTries
    or raw column dicts per alias, exactly as make_executor accepts — and
    the need vectors are per-stage tuples (one (num_nodes,) int32 tensor
    each, stage order). Stage-output tries are always built in the run:
    they are weighted buffers of this one run and never cacheable.

    filter_vars names equality-selected vars: run gains a `filter_consts`
    int32 tensor in filter_vars order, and each var's comparison runs in
    the FIRST stage that binds it — filtered rows carry mult 0 into
    downstream weighted tries, so later stages never re-check.

    filter_kill picks the comparison's disposition (see make_executor).
    In mask mode filter_consts is (B, F) and every output gains a leading
    lane axis (counts (B,), bound/valid/mult (B, cap), needs (B, n)).
    Stages run once for all lanes up to and including the first non-root
    stage with a filter; that stage's output stamps each lane's
    filter-dead rows with multiplicity 0, so from there on each lane has
    its own stage buffer and every later stage runs once per lane, on a
    weighted trie built from that lane's buffer. Templates whose filters
    all fall in the root stage share every stage across the lanes."""
    if not len(stages) == len(cap_plans) >= 1:
        raise ValueError("one capacity plan per stage")
    filter_vars = tuple(filter_vars)
    unassigned = {v: i for i, v in enumerate(filter_vars)}
    fns = []
    filtered = []  # per stage: does it bind a filter var?
    for i, ((_name, plan), cp) in enumerate(zip(stages, cap_plans)):
        stage_filters = tuple(
            (v, unassigned.pop(v)) for v in tuple(plan.query.variables) if v in unassigned
        )
        filtered.append(bool(stage_filters))
        fns.append(
            make_executor(
                plan,
                cp.capacities,
                compact_to=cp.compact_to,
                compact_probe=cp.compact_probe,
                budget=budget,
                agg=agg if i == len(stages) - 1 else None,
                schedule=cp.schedule,
                filters=stage_filters,
                filter_kill=filter_kill,
            )
        )
    if unassigned:
        raise ValueError(f"filter vars not bound by any stage: {sorted(unassigned)}")

    def run(rel_data: dict[str, object], filter_consts: torch.Tensor | None = None):
        if not filter_kill and filter_consts is not None and filter_vars:
            return run_lanes(rel_data, filter_consts)
        cols = dict(rel_data)
        stage_mults: dict[str, torch.Tensor] = {}
        nes, ncs = [], []
        for (name, plan), fn in zip(stages[:-1], fns[:-1]):
            bound, valid, mult, ne, nc = fn(cols, stage_mults, filter_consts)
            head = plan.query.head
            cols[name] = {v: torch.where(valid, bound[v], PAD_KEY) for v in head}
            stage_mults[name] = torch.where(valid, mult, 0)
            nes.append(ne)
            ncs.append(nc)
        out = fns[-1](cols, stage_mults, filter_consts)
        nes.append(out[-2])
        ncs.append(out[-1])
        return out[:-2] + (tuple(nes), tuple(ncs))

    def lane_of(out, b: int):
        """Lane b's (bound, valid, mult) of a stage's agg=None output
        (lane-independent outputs are 1-D and serve every lane)."""
        bound, valid, mult = out[:3]
        if valid.dim() == 1:
            return bound, valid, mult
        return {v: a[b] for v, a in bound.items()}, valid[b], mult[b]

    def lane_needs(needs, lanes: int):
        if len(needs) == 1:
            t = needs[0]
            return t if t.dim() == 2 else t.expand(lanes, *t.shape)
        return torch.stack([t.reshape(-1) for t in needs])

    def run_lanes(rel_data, filter_consts):
        lanes = filter_consts.shape[0]
        envs = [(dict(rel_data), {})]  # one shared, or one per lane once split
        nes, ncs = [], []
        for i, ((name, plan), fn) in enumerate(zip(stages, fns)):
            split = len(envs) > 1
            outs = []
            for b, (cols, stage_mults) in enumerate(envs):
                fc = None
                if filtered[i]:
                    fc = filter_consts[b : b + 1] if split else filter_consts
                outs.append(fn(cols, stage_mults, fc))
            nes.append(lane_needs([o[-2] for o in outs], lanes))
            ncs.append(lane_needs([o[-1] for o in outs], lanes))
            if i == len(stages) - 1:
                break
            if not split and filtered[i]:  # the lanes part here
                pairs = [(envs[0], lane_of(outs[0], b)) for b in range(lanes)]
            else:
                pairs = [(env, lane_of(o, 0)) for env, o in zip(envs, outs)]
            envs = []
            for (cols, stage_mults), (bound, valid, mult) in pairs:
                cols, stage_mults = dict(cols), dict(stage_mults)
                cols[name] = {v: torch.where(valid, bound[v], PAD_KEY) for v in plan.query.head}
                stage_mults[name] = torch.where(valid, mult, 0)
                envs.append((cols, stage_mults))
        if len(outs) == 1:  # every filter is in the root: its outputs carry the lanes
            root = outs[0][:-2]
        elif agg == "count":
            root = (torch.cat([o[0].reshape(-1) for o in outs]),)
        else:
            per = [lane_of(o, 0) for o in outs]
            root = (
                {v: torch.stack([p[0][v] for p in per]) for v in per[0][0]},
                torch.stack([p[1] for p in per]),
                torch.stack([p[2] for p in per]),
            )
        return root + (tuple(nes), tuple(ncs))

    return run


def make_count_fn(
    plan: FreeJoinPlan,
    capacities,
    budget: int = 32,
    *,
    schedule: StaticSchedule | None = None,
):
    """Original count-only surface: fn(rel_cols) -> (count, overflowed),
    a () int64 and a () bool tensor on the columns' device. One overflow
    flag over every node (a need above its capacity, so the count is
    short); no compaction. Kept for benchmarks and dry runs; the adaptive
    runner reads make_executor's need vectors instead, so its retry loop
    can grow the offending node. The reference's `impl` argument has no
    counterpart: the device of the columns picks the kernels."""
    if schedule is None:
        schedule = _static_schedule(plan)
    inner = make_executor(plan, capacities, budget=budget, agg="count", schedule=schedule)
    caps = np.asarray([int(c) for c in capacities[: len(schedule)]], np.int32)
    on_device: dict[torch.device, torch.Tensor] = {}

    def run(rel_cols):
        count, ne, _nc = inner(rel_cols)
        if ne.device not in on_device:
            on_device[ne.device] = TRANSFERS.to_device(caps, ne.device, "capacities")
        return count, (ne > on_device[ne.device]).any()

    return run


def count_query(plan: FreeJoinPlan, relations, capacities, budget: int = 32, *, device="cuda"):
    """Convenience: the compiled COUNT of `plan` over host relations, on
    `device`. Returns (count, overflowed) as (int, bool), read back in one
    copy. The reference's `impl` and `jit` arguments have no PyTorch
    meaning and are dropped: there is no trace to compile, and the device
    picks the kernels (the CUDA kernels on the card, their plain versions
    on the CPU)."""
    fn = make_count_fn(plan, capacities, budget)
    count, overflow = fn(relations_to_cols(plan, relations, device))
    host = TRANSFERS.to_host(torch.stack([count, overflow.to(torch.int64)]), "count")
    return int(host[0]), bool(host[1])


def relations_to_cols(plan: FreeJoinPlan, relations, device="cuda") -> dict[str, dict]:
    """Device int32 columns for every alias the plan touches."""
    return stage_relations_to_cols((("__root", plan),), relations, device)


def stage_relations_to_cols(stages, relations, device="cuda") -> dict[str, dict]:
    """Device int32 columns for every *base* alias a stage chain touches
    (device_columns: uploaded once per column object and device)."""
    return {a: device_columns(relations[a], device) for a in _base_aliases(stages)}


def _needed_later_static(plan: FreeJoinPlan, k: int, probes, agg: str | None = "count") -> set[str]:
    need: set[str] = set()
    for sa in probes:
        need |= set(sa.vars)
    for node in plan.nodes[k + 1 :]:
        for sa in node:
            need |= set(sa.vars)
    if agg != "count":
        need |= set(plan.query.head)
    return need


def _base_aliases(stages) -> set[str]:
    """Every relation alias a stage chain reads from the caller — stage
    names are produced on the device by the chain executor, never read."""
    names = {name for name, _ in stages}
    return {sa.alias for _, plan in stages for node in plan.nodes for sa in node} - names


class AdaptiveExecutor:
    """Overflow-retrying driver around the chained executor (see module
    docstring).

    Accepts a single FreeJoinPlan + CapacityPlan (the classic one-stage
    surface) or a full stage chain — ((name, plan), ...) root last — with a
    ChainCapacityPlan. If any stage's node reports a need above its
    capacity, jumps exactly that node's capacity (or compaction target) to
    the reported need and re-runs — one retry per offending node, not a
    doubling ladder. Executors are kept per capacity-vector chain and the
    grown plan replaces the initial one, so a stream of similar queries
    pays the retry once and then runs overflow-free.

    run_relations is the warm serving surface: device uploads come from the
    per-relation registry and base tries from the cross-call TRIE_CACHE, so
    repeated calls over the same relations — and every overflow/tighten
    re-run — pay probe cost only.

    Serving extensions (the multi-tenant path, see serve/join_engine.py):

    * filter_vars — equality selections whose constants are runtime
      inputs: __call__ takes a `filter_consts` int32 vector in filter_vars
      order, and one executor serves every constant.
    * batch=B — the chain runs in mask mode over a (B, F) constants
      matrix, so ONE dispatch answers B queries of the template against
      the SAME shared tries: counts come back (B,) and need vectors per
      lane, (B, n). Overflow growth follows the per-node max over lanes
      (the chain's shapes are shared).
    * max_capacity — per-node growth quota: a need that would grow any
      node past it raises capacity.CapacityQuotaError naming the
      offending batch lane instead of growing the shared executor, so
      admission control can reject exactly that request.
    """

    def __init__(
        self,
        plan,
        cap_plan,
        *,
        device="cuda",
        budget: int = 32,
        agg: str | None = "count",
        max_retries: int = 12,
        tighten: bool = False,
        filter_vars: tuple[str, ...] = (),
        batch: int | None = None,
        max_capacity: int | None = None,
    ):
        from repro_torch.core.capacity import ChainCapacityPlan  # deferred: no cycle

        stages = (
            (("__root", plan),)
            if isinstance(plan, FreeJoinPlan)
            else tuple((name, p) for name, p in plan)
        )
        chain = (
            cap_plan
            if isinstance(cap_plan, ChainCapacityPlan)
            else ChainCapacityPlan(names=tuple(n for n, _ in stages), stages=(cap_plan,))
        )
        if len(chain.stages) != len(stages):
            raise ValueError("one capacity plan per stage")
        # reuse the schedules the planner already computed, if they rode along
        chain = chain.with_schedules(
            tuple(
                cp.schedule if cp.schedule is not None else _static_schedule(p)
                for cp, (_n, p) in zip(chain.stages, stages)
            )
        )
        for _name, p in stages:
            p.validate()
        self.stages = stages
        self._single = len(stages) == 1
        self.plan = stages[-1][1]  # the root stage plan
        self.cap_plan = chain.stages[0] if self._single else chain
        self.schedules = tuple(cp.schedule for cp in chain.stages)
        self.schedule = self.schedules[-1]
        self.device = torch.device(device)
        self.budget = budget
        self.agg = agg
        self.max_retries = max_retries
        self.tighten = tighten
        self.filter_vars = tuple(filter_vars)
        self.batch = batch
        self.max_capacity = max_capacity
        if batch is not None and not self.filter_vars:
            raise ValueError(
                "batched execution varies only the constant vector per lane; "
                "a template with no filters should run once, unbatched"
            )
        self.retries = 0  # total overflow re-runs across calls
        self.reshapes = 0  # tightening re-runs across calls
        self.calls = 0  # top-level calls (retries excluded)
        self._cache: dict[tuple, object] = {}
        # memory-governor token, set by api._govern_runner when this runner
        # is cached: growth re-accounts against the budget and sheds
        # (MemoryBudgetError, into the serving ladder) instead of growing
        self._govern_token = None
        self._last_needs = None  # per-stage measured expansion needs (lane counts)
        self._feedback_specs = None  # lazily-derived per-node prefix specs
        # base alias -> its level layout (for cross-call trie reuse); an
        # alias read under two different layouts falls back to raw columns
        base = _base_aliases(stages)
        self._alias_lops: dict[str, _LevelOps | None] = {}
        for sched in self.schedules:
            for a, lo in sched.level_ops.items():
                if a not in base:
                    continue
                if a in self._alias_lops and self._alias_lops[a] != lo:
                    self._alias_lops[a] = None
                else:
                    self._alias_lops.setdefault(a, lo)

    @property
    def compiles(self) -> int:
        """Executors built so far: one per distinct capacity-vector chain."""
        return len(self._cache)

    @property
    def warm_read_backs(self) -> int:
        """Read-backs of one warm run_relations call, each a counted copy
        (core/transfers.py) that waits for the device: the needs, then the
        result (the count; or valid, mult and one column per variable of
        the root plan). With filters the call also uploads the constants,
        a blocking copy too. The launch audit holds a warm call to it."""
        return 2 if self.agg == "count" else 3 + len(tuple(self.plan.query.variables))

    def _as_chain(self, cp):
        from repro_torch.core.capacity import ChainCapacityPlan  # deferred: no cycle

        if isinstance(cp, ChainCapacityPlan):
            return cp
        return ChainCapacityPlan(names=tuple(n for n, _ in self.stages), stages=(cp,))

    def frontier_nbytes(self, cap_plan=None) -> int:
        """Accounting model of this runner's frontier footprint: per stage,
        cells x 4 bytes x (bound vars + valid + mult), plus the per-lane
        mask columns of a batched (mask-mode) runner. The governor's
        currency for runner-cache entries and adaptive growth."""
        chain = self._as_chain(self.cap_plan if cap_plan is None else cap_plan)
        total = 0
        for (_name, p), cp in zip(self.stages, chain.stages):
            width = len(tuple(p.query.variables)) + 2
            total += cp.cells() * 4 * width
            if self.batch:
                total += cp.cells() * 4 * self.batch
        return total

    def _fn(self, chain):
        key = chain.key()
        if key not in self._cache:
            # a new executor shape is made here: the injection point of
            # "compile_fail", on the same misses as the reference's compile
            faults.fire("compile")
            self._cache[key] = make_chain_executor(
                self.stages,
                chain.stages,
                budget=self.budget,
                agg=self.agg,
                filter_vars=self.filter_vars,
                # batched runs use mask-mode filters so the frontier layout
                # is shared across lanes; single queries keep kill mode
                filter_kill=self.batch is None,
            )
        return self._cache[key]

    @staticmethod
    def _reduced(need: np.ndarray) -> np.ndarray:
        """Per-node need vector of a (possibly per-lane) reported need:
        batched runs report (B, n); the chain's shapes are shared, so
        growth follows the max over lanes."""
        return need.max(axis=0) if need.ndim == 2 else need

    def _check_quota(self, chain, s: int, i: int, need: int, per_lane: np.ndarray) -> None:
        from repro_torch.core.capacity import CapacityQuotaError, _round_block

        if self.max_capacity is None:
            return
        cp = chain.stages[s]
        target = max(2 * cp.capacities[i], _round_block(int(need), cp.block))
        if target <= self.max_capacity:
            return
        lane = int(np.argmax(per_lane[:, i])) if per_lane.ndim == 2 else None
        raise CapacityQuotaError(s, i, int(need), self.max_capacity, lane=lane)

    def __call__(self, rel_data: dict[str, object], filter_consts=None):
        """agg="count" -> () int64 count tensor; agg=None -> (bound, valid,
        mult). rel_data values are prebuilt StaticTries and/or raw column
        dicts (see make_executor). filter_consts: (F,) int32 in filter_vars
        order, or (batch, F) for a batched runner, which returns (B,)
        counts or (B, cap) bound/valid/mult."""
        from repro_torch.core.capacity import _round_block  # deferred: no cycle

        if self.filter_vars:
            if filter_consts is None:
                raise ValueError("this runner's template has filters")
            filter_consts = TRANSFERS.to_device(
                np.asarray(filter_consts, dtype=np.int32), self.device, "filter constants"
            )
            want = (self.batch, len(self.filter_vars)) if self.batch else (len(self.filter_vars),)
            if tuple(filter_consts.shape) != want:
                raise ValueError(f"filter_consts must be {want}")
        chain = self._as_chain(self.cap_plan)
        self.calls += 1
        tightened = False
        faults.fire("overflow", batch=self.batch, max_capacity=self.max_capacity)
        rows = self.batch or 1
        for _ in range(self.max_retries + 1):
            fn = self._fn(chain)
            faults.fire("dispatch")
            out = fn(rel_data, filter_consts) if self.filter_vars else fn(rel_data)
            # ONE device-to-host copy for the control plane: the per-stage
            # need vectors (per lane when batched) drive host-side
            # overflow/tighten decisions. Results stay on the device until
            # the caller reads them.
            sizes = [ne.shape[-1] for ne in out[-2]]
            host = torch.cat([t.reshape(rows, -1) for t in out[-2] + out[-1]], dim=1)
            parts = np.split(
                TRANSFERS.to_host(host, "needs"), np.cumsum(sizes + sizes)[:-1], axis=1
            )
            if not self.batch:
                parts = [p[0] for p in parts]
            needs_e, needs_c = parts[: len(sizes)], parts[len(sizes):]
            grown = chain
            for s, (cp, ne_l, nc_l) in enumerate(zip(chain.stages, needs_e, needs_c)):
                ne, nc = self._reduced(ne_l), self._reduced(nc_l)
                oe, oc = overflows(cp, ne, nc)
                for i in np.flatnonzero(oc):
                    grown = grown.grow_to(s, int(i), int(nc[i]), compaction=True)
                for i in np.flatnonzero(oe):
                    self._check_quota(chain, s, int(i), int(ne[i]), ne_l)
                    grown = grown.grow_to(s, int(i), int(ne[i]))
            if grown is not chain:
                if self._govern_token is not None:
                    # growth must fit the device-memory budget: a shed here
                    # raises MemoryBudgetError into the degradation ladder
                    # instead of growing past what the budget allows
                    membudget.GOVERNOR.account(self._govern_token, self.frontier_nbytes(grown))
                chain = grown
                self.retries += 1
                continue
            if self.tighten and not tightened:
                # success with measured needs in hand: shrink any buffer
                # that ran >2x oversized and re-run once at the tight
                # shapes, so steady state pays for measured frontiers, not
                # for planning estimates
                shrunk = chain
                for s, (ne, nc) in enumerate(zip(needs_e, needs_c)):
                    ne, nc = self._reduced(ne), self._reduced(nc)
                    for i in range(len(ne)):
                        cp = shrunk.stages[s]
                        if cp.capacities[i] > 2 * _round_block(int(ne[i]), cp.block):
                            shrunk = shrunk.shrink_to(s, i, int(ne[i]))
                        ct = shrunk.stages[s].compact_to[i]
                        if ct is not None and ct > 2 * _round_block(int(nc[i]), cp.block):
                            shrunk = shrunk.shrink_to(s, i, int(nc[i]), compaction=True)
                if shrunk is not chain:
                    chain = shrunk
                    tightened = True
                    self.reshapes += 1
                    continue
            # steady state: keep the grown/tightened plan
            self.cap_plan = chain.stages[0] if self._single else chain
            if self._govern_token is not None:
                membudget.GOVERNOR.account(self._govern_token, self.frontier_nbytes(chain))
            # stash the measured per-node expansion needs: exact frontier
            # lane counts, the optimizer's measured-cardinality feedback
            self._last_needs = tuple(self._reduced(ne) for ne in needs_e)
            result = out[:-2]
            return result[0] if self.agg == "count" else result
        raise RuntimeError(
            f"frontier overflow persists after {self.max_retries} retries: {chain}"
        )

    def _node_feedback_specs(self):
        """Per stage, per executed node: the (alias, consumed-vars) multiset
        whose joined cardinality that node's need_expand measures — or None
        when the measurement is not a joined-prefix size. Two exclusions:
        a cover that re-binds an already-bound variable (the executor
        semijoins AFTER expanding, so the count is pre-equate), and a stage
        alias whose consumed prefix is not the stage's full head (device-
        only output, no base-relation equivalent). A fully-consumed stage
        alias substitutes its own atoms' full specs, recursively, so every
        recorded spec names only base relations."""
        names = {n for n, _ in self.stages}
        full_specs: dict[str, tuple | None] = {}
        heads = {name: frozenset(p.query.head) for name, p in self.stages}
        out = []
        for (name, plan), sched in zip(self.stages, self.schedules):
            aliases = {sa.alias for node in plan.nodes for sa in node}
            prefix: dict[str, tuple[str, ...]] = {a: () for a in aliases}
            bound: set[str] = set()
            per_node = []
            for _k, cover, probes in sched.entries:
                rebinds = bool(set(cover.vars) & bound)
                prefix[cover.alias] = prefix[cover.alias] + tuple(cover.vars)
                bound |= set(cover.vars)
                spec: list | None = None if rebinds else []
                if spec is not None:
                    for a, vs in prefix.items():
                        if not vs:
                            continue
                        if a in names or a.startswith("__stage"):
                            sub = (
                                full_specs.get(a)
                                if frozenset(vs) == heads.get(a)
                                else None
                            )
                            if sub is None:
                                spec = None
                                break
                            spec.extend(sub)
                        else:
                            spec.append((a, frozenset(vs)))
                per_node.append(tuple(spec) if spec else None)
                for sa in probes:
                    prefix[sa.alias] = prefix[sa.alias] + tuple(sa.vars)
                    bound |= set(sa.vars)
            out.append(tuple(per_node))
            fs: list | None = []
            for a in plan.query.atoms:
                if a.alias in names or a.alias.startswith("__stage"):
                    sub = full_specs.get(a.alias)
                    if sub is None:
                        fs = None
                        break
                    fs.extend(sub)
                else:
                    fs.append((a.alias, frozenset(a.vars)))
            full_specs[name] = tuple(fs) if fs else None
        return tuple(out)

    def _record_feedback(self, relations) -> None:
        """Persist the last call's measured expansion needs into the
        process-wide measured-cardinality store (relcache.FEEDBACK). Filtered
        runs are skipped by the caller (lane counts depend on the constants),
        and nodes with no recordable prefix spec or a zero need (the
        factorized-count shortcut never expands) are skipped here."""
        if self._last_needs is None:
            return
        if self._feedback_specs is None:
            self._feedback_specs = self._node_feedback_specs()
        for per_node, needs in zip(self._feedback_specs, self._last_needs):
            for spec, n in zip(per_node, needs):
                if spec is None or int(n) <= 0:
                    continue
                relcache.FEEDBACK.record(
                    [(relations[a], vs) for a, vs in spec], int(n)
                )

    def run_relations(self, relations, *, reuse_tries: bool = True, filter_consts=None):
        """Host relations in, host results out — the warm path. Device
        columns come from the per-relation registry (uploaded once per
        column object) and base tries from the cross-call TRIE_CACHE, so a
        stream of calls over the same relations performs zero builds after
        the first. reuse_tries=False bypasses the trie cache and rebuilds in
        the run every call (the cold baseline). Returns an int count for
        agg="count", else (cols, mult) host numpy arrays over live rows.

        A batched runner returns the per-lane results: a (B,) int64 count
        array for agg="count", else a list of B (cols, mult) pairs.

        Successful runs feed the optimizer's measured-cardinality loop
        (see _record_feedback), except kill-mode filtered runs, whose lane
        counts depend on the constants (mask-mode batched runs keep the
        unfiltered layout)."""
        data = {}
        for a in sorted(_base_aliases(self.stages)):
            rel = relations[a]
            if reuse_tries:
                lo = self._alias_lops.get(a)
                if lo is not None:
                    data[a] = TRIE_CACHE.get(
                        rel, device_columns(rel, self.device), lo, budget=self.budget
                    )
                    continue
            data[a] = device_columns(relcache.live_relation(rel), self.device)
        out = self(data, filter_consts)
        if not self.filter_vars or self.batch is not None:
            self._record_feedback(relations)
        if self.agg == "count":
            if self.batch:  # the dispatch's one result read-back
                return TRANSFERS.to_host(out, "counts").astype(np.int64)
            return int(TRANSFERS.to_host(out, "count"))
        if self.batch:
            bound, valid, mult = out
            cols = {v: TRANSFERS.to_host(a, f"rows {v}") for v, a in bound.items()}
            valid, mult = TRANSFERS.to_host(valid, "valid"), TRANSFERS.to_host(mult, "mult")
            return [
                (
                    {v: a[b][valid[b]].astype(np.int64) for v, a in cols.items()},
                    mult[b][valid[b]].astype(np.int64),
                )
                for b in range(self.batch)
            ]
        return materialize_compiled(*out)


def materialize_compiled(bound, valid, mult):
    """Strip padding lanes from an agg=None result: returns (cols, mult) as
    host numpy arrays over live rows only (the eager engine's contract —
    expand duplicate multiplicities with api.materialize)."""
    v = TRANSFERS.to_host(valid, "valid")
    # one column at a time: each full read-back dies as soon as it is
    # indexed, so the next one reuses host pages already faulted in (three
    # 4,194,304-lane columns read back first and indexed after took twice
    # as long on q1 at SF 10, on the host of an H100 machine)
    cols = {
        name: TRANSFERS.to_host(a, f"rows {name}")[v].astype(np.int64)
        for name, a in bound.items()
    }
    return cols, TRANSFERS.to_host(mult, "mult")[v].astype(np.int64)
