"""Distributed Free Join: HyperCube (Shares) partitioning + SPMD execution,
over torch.distributed.

The paper is single-core; the canonical way to distribute a worst-case
optimal join is the HyperCube / Shares scheme: pick per-variable share
counts p_v with prod(p_v) = P shards, view the shards as a hypercube
indexed by (h_v(a_v) mod p_v), and send each tuple of R(x_i) to every
shard whose coordinates agree on R's variables. Every shard then runs the
*same local Free Join* on its fragment; results are a disjoint union
(counts: a sum). One round of communication, no intermediate shuffles —
this composes cleanly with Free Join because the local engine is unchanged.

Two execution paths share the partitioning logic:
  * host path (distributed_join_host): partition on the host, then the
    eager engine per shard on `device`, results concatenated in shard
    order;
  * SPMD path (SpmdCounter / spmd_count): the compiled count per shard,
    reduced across ranks with dist.all_reduce. Shards are padded to one
    dense length per relation, so every shard's executor sees the same
    shapes and the capacity plan reads the padded fragment maxima.

Where the reference maps shards onto a mesh axis, the port takes
`num_shards` and a process group. Rank r of a world of W holds shards
[r*k, (r+1)*k) with k = num_shards / W, and runs them one after another
on its device; a world of one (no group, or a group of one rank) runs
every shard on one device, the counterpart of the reference's fake CPU
devices on one host. Each rank partitions the same host relations, and
uploads only its own shards' rows.

The SPMD path is driven by the same planning stack as the local compiled
path: spmd_count derives a CapacityPlan from capacity.plan_capacities over
*per-shard* statistics — fragment sizes are the actual padded per-shard
maxima and distinct counts shrink by the hypercube share of each variable.
Each shard runs make_executor, which reports per-node *required totals*;
the counts are summed and the needs max-reduced on the device, then
across ranks (all_reduce SUM and MAX), and read back in one copy. The
overflow-retry loop runs on the host: grow exactly the offending node
(CapacityPlan.grow_to), build the executor at the new capacity vector,
re-run. Every rank reads the same reduced needs, so every rank grows the
same nodes and builds the same executor, and the ranks' collectives stay
in step. No overflow sentinel exists anywhere — spmd_count either returns
the exact (non-negative) count or raises after max_retries.

For acyclic queries hash partitioning on the first join key (shares
concentrated on one variable) recovers the classic distributed hash join as
a special case of the same code path.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import api, engine, relcache
from repro_torch.core.capacity import CapacityPlan, plan_capacities
from repro_torch.core.compiled import StaticTrie, _static_schedule, make_executor, overflows
from repro_torch.core.optimizer import Stats
from repro_torch.core.plan import FreeJoinPlan
from repro_torch.core.transfers import TRANSFERS
from repro_torch.relational.npkit import mix64
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Query

# dist.all_reduce calls made by SpmdCounter runs (two per reduced run: the
# count's SUM and the needs' MAX)
COLLECTIVES = 0


def _query_sig(query: Query) -> tuple:
    """Hashable structural identity of a query (its hyperedges in order)."""
    return tuple((a.alias, a.vars) for a in query.atoms)


# share assignments depend only on (hyperedges, sizes, shard count) — memoized
# process-wide so repeated queries over the same relations skip the search
_shares_cache: dict[tuple, dict[str, int]] = {}
_SHARES_CACHE_MAX = 256


def hypercube_shares(query: Query, sizes: dict[str, int], num_shards: int) -> dict[str, int]:
    """Choose shares p_v (prod = num_shards, powers of two) minimizing the
    max per-shard load sum_R |R| / prod_{v in R} p_v. Exhaustive over
    exponent splits — query variable counts are tiny. Memoized on
    (hyperedges, sizes, num_shards): the assignment depends on nothing
    else, so SpmdCounter instances over the same relations share it. The
    memo hands out copies."""
    key = (_query_sig(query), tuple(sorted(sizes.items())), num_shards)
    hit = _shares_cache.get(key)
    if hit is not None:
        return dict(hit)
    if num_shards < 1 or num_shards & (num_shards - 1):
        raise ValueError(f"num_shards must be a power of two, got {num_shards}")
    vars_ = list(query.variables)
    logp = num_shards.bit_length() - 1
    best, best_load = None, float("inf")

    def loads(assign: dict[str, int]) -> float:
        total = 0.0
        for a in query.atoms:
            frac = 1.0
            for v in a.vars:
                frac /= assign[v]
            total += sizes[a.alias] * frac
        return total

    for combo in itertools.combinations_with_replacement(range(len(vars_)), logp):
        assign = {v: 1 for v in vars_}
        for i in combo:
            assign[vars_[i]] *= 2
        load = loads(assign)
        if load < best_load:
            best, best_load = assign, load
    if best is None:
        # no variables to split over (e.g. a zero-variable query): every
        # shard gets the full input, the all-ones assignment
        best = {v: 1 for v in vars_}
    if len(_shares_cache) >= _SHARES_CACHE_MAX:
        _shares_cache.clear()
    _shares_cache[key] = dict(best)
    return best


def _coords(num_shards: int, shares: dict[str, int], var_order: list[str]):
    """Map shard id -> {var: coordinate} (mixed radix over shared vars)."""
    radices = [(v, shares[v]) for v in var_order if shares[v] > 1]
    out = []
    for s in range(num_shards):
        c, rem = {}, s
        for v, r in radices:
            c[v] = rem % r
            rem //= r
        out.append(c)
    return out


def partition(
    query: Query,
    relations: dict[str, Relation],
    shares: dict[str, int],
    num_shards: int,
) -> list[dict[str, Relation]]:
    """HyperCube partition: each relation row goes to every shard whose
    coordinates match the row's hashed values on the relation's vars.
    Each column is hashed once, for all shards."""
    coords = _coords(num_shards, shares, list(query.variables))
    coord_of = {
        (a.alias, v): mix64([relations[a.alias].columns[v].astype(np.int64)]) % shares[v]
        for a in query.atoms
        for v in a.vars
        if shares[v] > 1
    }
    shards = []
    for c in coords:
        local = {}
        for a in query.atoms:
            rel = relations[a.alias]
            mask = np.ones(rel.num_rows, dtype=bool)
            for v in a.vars:
                if shares[v] > 1:
                    mask &= coord_of[a.alias, v] == c[v]
            local[a.alias] = rel.select(mask)
        shards.append(local)
    return shards


def distributed_join_host(
    query: Query,
    relations: dict[str, Relation],
    num_shards: int,
    plan_tree=None,
    agg: str | None = None,
    device="cuda",
):
    """Distributed execution through the eager engine: partition, then
    free_join per shard on `device`, then the sum (agg="count") or the
    materialized rows of every shard concatenated in shard order.
    Semantically equal to single-node free_join."""
    sizes = {a.alias: relations[a.alias].num_rows for a in query.atoms}
    shares = hypercube_shares(query, sizes, num_shards)
    shards = partition(query, relations, shares, num_shards)
    if agg == "count":
        return sum(api.free_join(query, s, plan_tree, agg="count", device=device) for s in shards)
    outs = []
    for s in shards:
        bound, mult = api.free_join(query, s, plan_tree, device=device)
        outs.append(engine.materialize(bound, mult, query.head))
    return {
        v: np.concatenate([o[v] for o in outs]) if outs else np.zeros(0, np.int64)
        for v in query.head
    }


# ---------------------------------------------------------------------------
# SPMD path: the compiled count per shard, all_reduce across ranks.
# ---------------------------------------------------------------------------


def pad_shards_to_dense(shards, query: Query):
    """Stack per-shard fragments into dense (num_shards, N_max) int32 host
    arrays with a -1-padded tail, N_max the largest fragment of the
    relation (at least 1), and each shard's real row count per alias.
    _mask_pad turns the pad rows into keys that never join."""
    out = {}
    counts = {}
    for a in query.atoms:
        nmax = max(max(s[a.alias].num_rows for s in shards), 1)
        cols = {}
        for v in a.vars:
            arr = np.full((len(shards), nmax), -1, dtype=np.int32)
            for i, s in enumerate(shards):
                r = s[a.alias]
                arr[i, : r.num_rows] = r.columns[v].astype(np.int32)
            cols[v] = arr
        out[a.alias] = cols
        counts[a.alias] = np.array([s[a.alias].num_rows for s in shards], np.int32)
    return out, counts


def _mask_pad(cols: dict[str, dict[str, torch.Tensor]], counts: dict[str, torch.Tensor]):
    """One shard's columns with the pad rows' keys replaced by negative
    sentinels, -(offset + row) - 1, unique across *all* relations (an
    offset per alias, in sorted alias order), so pad rows never match any
    probe and never collide with another relation's pad rows. `counts`
    holds each alias's real row count as a () device tensor."""
    out = {}
    offset = 0
    for alias in sorted(cols):
        c = cols[alias]
        some = next(iter(c.values()))
        n = some.shape[0]
        idx = torch.arange(n, dtype=torch.int32, device=some.device)
        pad = idx >= counts[alias]
        out[alias] = {v: torch.where(pad, -(offset + idx) - 1, a) for v, a in c.items()}
        offset += n
    return out


def _world(group) -> tuple[int, int, bool]:
    """(rank, world size, whether runs reduce across ranks) for `group`.
    No group and no initialised process group is a world of one that
    reduces nothing; a group given explicitly always reduces."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return 0, 1, False
    world = dist.get_world_size(group)
    return dist.get_rank(group), world, group is not None or world > 1


# hypercube partition + dense padding + this rank's upload, cached across
# SpmdCounter instances over the very same Relation objects. Relation
# identity is part of the key (id per alias) and every entry is evicted by
# a weakref finalizer the moment any of its relations dies — the device
# fragments can neither outlive their relations nor be served to an
# unrelated object that reused a dead relation's address. The device and
# the rank's place in its group are part of the key too, so a CPU call and
# a card call never share fragments.
_partition_cache = relcache.KeyedCache(max_entries=8)


def _cached_partition(query: Query, relations, shares, num_shards: int, device, rank, world):
    """This rank's device fragments for (query, shares, num_shards):
    ({alias: {var: (k, N_max) int32}}, {alias: (k,) int32 row counts}),
    reused when every relation object is identical to the cached entry's."""
    rels = [relations[a.alias] for a in query.atoms]
    key = (
        _query_sig(query),
        tuple(sorted(shares.items())),
        num_shards,
        str(device),
        rank,
        world,
        tuple(id(r) for r in rels),
    )
    hit = _partition_cache.get(key)
    if hit is not None:
        return hit
    shards = partition(query, relations, shares, num_shards)
    dense, counts = pad_shards_to_dense(shards, query)
    k = num_shards // world
    mine = slice(rank * k, (rank + 1) * k)
    local = {
        a: {
            v: TRANSFERS.to_device(arr[mine], device, f"shard rows {a}.{v}")
            for v, arr in cols.items()
        }
        for a, cols in dense.items()
    }
    local_counts = {
        a: TRANSFERS.to_device(c[mine], device, f"shard row counts {a}") for a, c in counts.items()
    }
    value = (local, local_counts)
    _partition_cache.put(key, value, rels)
    return value


# per-shard prebuilt tries, cached with the same identity discipline as the
# partition. Every later count executor (including every grow/rebuild
# retry) takes the built tries as inputs, so per-shard builds run once per
# (relations, shares, schedule, budget, device, rank) per process, not once
# per call or per retry.
_shard_trie_cache = relcache.KeyedCache(max_entries=8)


def _cached_shard_tries(
    query: Query,
    relations,
    shares,
    num_shards: int,
    dense,
    counts,
    level_ops,
    device,
    rank: int,
    world: int,
    budget: int = 32,
):
    """One {alias: StaticTrie} per local shard, over the pad-masked
    fragments."""
    rels = [relations[a.alias] for a in query.atoms]
    key = (
        _query_sig(query),
        tuple(sorted(shares.items())),
        num_shards,
        tuple(sorted((a, lo) for a, lo in level_ops.items())),
        budget,
        str(device),
        rank,
        world,
        tuple(id(r) for r in rels),
    )
    hit = _shard_trie_cache.get(key)
    if hit is not None:
        return hit
    built = []
    for i in range(num_shards // world):
        cols = _mask_pad(
            {a: {v: arr[i] for v, arr in c.items()} for a, c in dense.items()},
            {a: c[i] for a, c in counts.items()},
        )
        # lexsort path (key_bits=None): pad sentinels are negative
        built.append({a: StaticTrie(cols[a], level_ops[a], budget) for a in level_ops})
    _shard_trie_cache.put(key, built, rels)
    return built


# grown capacity plans persist across SpmdCounter instances: each process
# pays the overflow retry + executor rebuild once per (plan, relations,
# shards) and every later instance starts overflow-free (planner-derived
# plans only — manual capacities are the caller's to manage); bounded like
# _shares_cache
_cap_plan_cache: dict[tuple, CapacityPlan] = {}
_CAP_PLAN_CACHE_MAX = 256


class _ShardStats:
    """Planner statistics for one hypercube shard, derived from the global
    Stats cache without touching any column again: a fragment of R holds the
    actual padded per-shard row maximum (known after partitioning), and a
    variable sharded p_v ways keeps ~1/p_v of its distinct values."""

    def __init__(self, base: Stats, shares: dict[str, int], sizes: dict[str, int]):
        self.base = base
        self.shares = shares
        self.sizes = sizes

    def size(self, alias: str) -> int:
        return self.sizes[alias]

    def distinct(self, alias: str, var: str) -> float:
        return max(1.0, self.base.distinct(alias, var) / self.shares.get(var, 1))


class SpmdCounter:
    """AdaptiveExecutor's distributed sibling: partition once, then run the
    compiled count over this rank's shards, reduce across ranks, and drive
    the host-side grow/retry loop. Executors are kept per capacity vector
    and the grown plan is kept, so repeated calls run overflow-free with no
    new executors.

    Three levels persist process-wide across *instances* over the same
    relations: the share assignment (pure function of hyperedges + sizes),
    the device fragments and their tries (validated by relation object
    identity, per device and rank), and the grown planner-derived
    CapacityPlan — a new counter for a repeated query re-partitions
    nothing, re-learns nothing, and builds an executor only if its capacity
    vector was never seen by this instance.

    num_shards defaults to the group's size and must be a multiple of it;
    group=None uses the default process group if one is initialised, else
    a world of one. Runs reduce across ranks (all_reduce; COLLECTIVES counts
    the calls) when the world has more than one rank or `group` was given.
    Every rank of the group must construct and call its counter alike: the
    reduced needs are the same on every rank, so the retry loop grows the
    same nodes everywhere. The count is summed in int64; the reference's
    psum sums int32, so the two differ only where the reference wraps.
    Compaction stays off (compact_to is all None), as in the reference.

    `setup_s` holds the host seconds of the constructor's three steps
    (partition and upload, capacity planning, shard trie builds); a cached
    step takes next to none. Device work a step enqueues without waiting
    for it is charged to the step that next waits."""

    def __init__(
        self,
        query: Query,
        relations: dict[str, Relation],
        plan: FreeJoinPlan,
        capacities: list[int] | None = None,
        *,
        num_shards: int | None = None,
        group=None,
        device="cuda",
        cap_plan: CapacityPlan | None = None,
        safety: float = 2.0,
        max_retries: int = 12,
    ):
        self.rank, self.world, self._reduce = _world(group)
        num_shards = self.world if num_shards is None else int(num_shards)
        if num_shards < 1 or num_shards % self.world:
            raise ValueError(
                f"num_shards={num_shards} must be a positive multiple of the world size "
                f"{self.world}"
            )
        self.group = group
        self.num_shards = num_shards
        self.device = torch.device(device)
        t0 = time.perf_counter()
        sizes = {a.alias: relations[a.alias].num_rows for a in query.atoms}
        self.shares = hypercube_shares(query, sizes, num_shards)
        self._dense, self._counts = _cached_partition(
            query, relations, self.shares, num_shards, self.device, self.rank, self.world
        )
        t1 = time.perf_counter()
        self._plan_key = None  # set only for planner-derived plans
        if cap_plan is not None:
            # reuse the schedule riding on a caller's plan (one walk per
            # query); compaction stays off here — a reused local plan may
            # carry targets, strip them so overflows() checks what ran
            self.schedule = getattr(cap_plan, "schedule", None) or _static_schedule(plan)
            cap_plan = replace(cap_plan, compact_to=(None,) * len(cap_plan.capacities))
        elif capacities is not None:
            self.schedule = _static_schedule(plan)
            n = len(self.schedule)
            cap_plan = CapacityPlan(
                capacities=tuple(int(c) for c in capacities[:n]),
                compact_to=(None,) * n,
                schedule=self.schedule,
            )
        else:
            self._plan_key = (
                str(plan), _query_sig(query), tuple(sorted(sizes.items())),
                num_shards, safety,
            )
            cached = _cap_plan_cache.get(self._plan_key)
            if cached is not None:
                # a previous instance already learned (grew) this plan; skip
                # the stats pass and start overflow-free
                cap_plan = cached
                self.schedule = cached.schedule
            else:
                # per-shard sizing: padded fragment maxima + share-shrunk
                # distinct counts, same planner as the local path
                self.schedule = _static_schedule(plan)
                frag_sizes = {
                    a: int(next(iter(cols.values())).shape[1]) for a, cols in self._dense.items()
                }
                cap_plan = plan_capacities(
                    plan,
                    stats=_ShardStats(Stats(relations), self.shares, frag_sizes),
                    schedule=self.schedule,
                    safety=safety,
                )
                cap_plan = replace(cap_plan, compact_to=(None,) * len(cap_plan.capacities))
        t2 = time.perf_counter()
        self.plan = plan
        self.cap_plan = cap_plan
        self.max_retries = max_retries
        self.retries = 0  # total overflow re-runs across calls
        # per-shard tries, prebuilt once (cached across instances over the
        # same relations): every count executor and every grow/rebuild
        # retry below reuses them as plain inputs
        self._tries = _cached_shard_tries(
            query,
            relations,
            self.shares,
            num_shards,
            self._dense,
            self._counts,
            self.schedule.level_ops,
            self.device,
            self.rank,
            self.world,
        )
        self.setup_s = {
            "partition": t1 - t0,
            "planning": t2 - t1,
            "shard_tries": time.perf_counter() - t2,
        }
        self._cache: dict[tuple, object] = {}

    @property
    def compiles(self) -> int:
        """Executors built so far: one per distinct capacity vector."""
        return len(self._cache)

    def _fn(self, cp: CapacityPlan):
        if cp.capacities not in self._cache:
            self._cache[cp.capacities] = make_executor(
                self.plan, cp.capacities, agg="count", schedule=self.schedule
            )
        return self._cache[cp.capacities]

    def run_once(self, cp: CapacityPlan) -> tuple[int, np.ndarray, np.ndarray]:
        """One run at `cp` over every shard: (count, need_expand,
        need_compact), reduced over this rank's shards and across ranks,
        read back in one copy. need_* are int64 host arrays."""
        global COLLECTIVES
        fn = self._fn(cp)
        total = torch.zeros((), dtype=torch.int64, device=self.device)
        ne = nc = None
        for tries in self._tries:
            c, e, n = fn(tries)
            total = total + c
            ne = e if ne is None else torch.maximum(ne, e)
            nc = n if nc is None else torch.maximum(nc, n)
        needs = torch.cat([ne, nc]).to(torch.int64)
        if self._reduce:
            # count by SUM, needs by MAX: the host retry loop sizes every
            # shard's next capacities to the worst shard's need
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=self.group)
            dist.all_reduce(needs, op=dist.ReduceOp.MAX, group=self.group)
            COLLECTIVES += 2
        host = TRANSFERS.to_host(torch.cat([total.reshape(1), needs]), "count and needs")
        k = len(ne)
        return int(host[0]), host[1 : 1 + k], host[1 + k :]

    def __call__(self) -> int:
        cp = self.cap_plan
        for _ in range(self.max_retries + 1):
            total, ne, nc = self.run_once(cp)
            oe, oc = overflows(cp, ne, nc)
            if not (oe.any() or oc.any()):
                self.cap_plan = cp  # steady state: keep the grown plan
                if self._plan_key is not None:
                    # ...and persist it: the next SpmdCounter over the same
                    # relations starts from the learned capacities
                    if len(_cap_plan_cache) >= _CAP_PLAN_CACHE_MAX:
                        _cap_plan_cache.clear()
                    _cap_plan_cache[self._plan_key] = cp
                if total < 0:
                    raise RuntimeError(f"spmd count must be non-negative, got {total}")
                return total
            # compaction is off here, but grow symmetrically with
            # AdaptiveExecutor so the two retry loops cannot diverge
            for i in np.flatnonzero(oc):
                cp = cp.grow_to(int(i), int(nc[i]), compaction=True)
            for i in np.flatnonzero(oe):
                cp = cp.grow_to(int(i), int(ne[i]))
            self.retries += 1
        raise RuntimeError(
            f"spmd frontier overflow persists after {self.max_retries} retries: {cp}"
        )


def spmd_count(
    query: Query,
    relations: dict[str, Relation],
    plan: FreeJoinPlan,
    capacities: list[int] | None = None,
    *,
    num_shards: int | None = None,
    group=None,
    device="cuda",
    cap_plan: CapacityPlan | None = None,
    safety: float = 2.0,
    max_retries: int = 12,
    info: dict | None = None,
) -> int:
    """End-to-end SPMD count: hypercube partition on the host, pad to dense,
    upload this rank's shards to `device`, run the compiled local engine
    per shard, reduce (see SpmdCounter for num_shards and group).

    Capacities come from the shared planning stack (see module docstring):
    by default a CapacityPlan over per-shard statistics; `capacities` (a
    manual per-node list) or `cap_plan` override the initial plan. Overflow
    is recovered by SpmdCounter's host-side retry loop — grow the offending
    node to its reported need, build the executor, re-run — so the returned
    count is always exact and non-negative; no sentinel exists to leak.
    `info`, if given, receives shares, the final capacity plan, and
    retry/compile counters."""
    counter = SpmdCounter(
        query,
        relations,
        plan,
        capacities,
        num_shards=num_shards,
        group=group,
        device=device,
        cap_plan=cap_plan,
        safety=safety,
        max_retries=max_retries,
    )
    total = counter()
    if info is not None:
        info.update(
            shares=counter.shares,
            cap_plan=counter.cap_plan,
            retries=counter.retries,
            compiles=counter.compiles,
        )
    return total
