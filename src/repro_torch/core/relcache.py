"""Weakref-keyed cache registry for per-relation device state.

The compiled path keeps three kinds of state alive across calls so
steady-state serving pays probe cost only: device uploads of base columns,
built StaticTries, and per-column planning statistics. All of it is
per-Relation-object, and all of it must die with the relation — caching by
`id(rel)` is unsound (CPython reuses addresses after GC, so a dead
relation's entry could be served to an unrelated new object), and caching
by content is exactly the O(N) work the cache exists to avoid.

Two primitives, both identity-keyed *through weak references* so an entry
can never outlive (or be confused with) its relation:

* `RelationRegistry` — relation -> named namespace dicts. Backed by a
  WeakKeyDictionary: the interpreter drops the whole entry the moment the
  relation is collected. Identity comes from the live object, never from a
  reusable address.
* `KeyedCache` — bounded mapping whose keys may span *several* relations
  (a partition of a whole query, a compiled runner over a relation dict).
  Relation identity goes into the key as `id(rel)`, but every entry
  registers a `weakref.finalize` on each relation that evicts the entry on
  death — the id can only be reused after the finalizer has already
  removed the stale entry, closing the reuse race by construction.

Values held here are strong references (device tensors, built
executors): that is the point — they are the cache. Lifetime is bounded by
the relations themselves plus the LRU bound on KeyedCache.

The registry also carries each relation's MUTATION STATE, the delta-build
contract that replaces rebuild-on-any-change:

* `append(rel, delta_cols)` extends the host columns AND primes every
  identity-keyed memo (device uploads on every device they were made for,
  radix key width, distinct count) with an incrementally-computed value,
  so the next planning/build pass pays O(delta), not O(N). The delta
  itself lands in a bounded version log that compiled.TrieCache replays:
  a cached trie catches up by sorting only the delta (segmented radix
  sort) and merging sorted runs, with no full re-sort.
* `delete(rel, rows)` writes tombstones: rows keep their physical slots
  with multiplicity 0 (the weighted-trie mult-fold makes them contribute
  nothing). When live/total drops below COMPACT_RATIO,
  `compact()` physically drops dead rows, replacing the host column
  objects, so every identity-keyed consumer sees the full rebuild a
  compaction is.
* Each mutation bumps the relation's `version` (a per-relation clock);
  consumers that cache derived device state record the version they
  materialized at and use `deltas_since(v)` to replay exactly the missing
  suffix, or rebuild when the suffix was pruned or a compaction reset
  the clock.
"""
from __future__ import annotations

import warnings
import weakref
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.transfers import TRANSFERS


class RelationRegistry:
    """Per-relation namespaces: `namespace(rel, "tries")` returns a dict
    private to (rel, "tries") that dies with `rel`."""

    def __init__(self):
        self._spaces: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def namespace(self, rel, name: str) -> dict:
        spaces = self._spaces.get(rel)
        if spaces is None:
            spaces = {}
            self._spaces[rel] = spaces
        return spaces.setdefault(name, {})

    def clear(self) -> None:
        self._spaces.clear()


def memo(registry: "RelationRegistry", rel, space: str, key, obj, compute):
    """The registry's one validation idiom, shared by every per-relation
    memo (device uploads, key widths, distinct counts): cache `compute()`
    under (rel, space, key), revalidated by `obj` identity — a replaced
    column object recomputes, an identical one returns the cached value.
    In-place mutation of `obj` is undetectable by design; replace the
    object instead."""
    ns = registry.namespace(rel, space)
    hit = ns.get(key)
    if hit is None or hit[0] is not obj:
        ns[key] = (obj, compute())
    return ns[key][1]


class KeyedCache:
    """Bounded LRU cache whose entries are pinned to relation lifetimes.

    `put(key, value, rels)` stores value under `key` (which should embed
    `id(r)` for each r in rels to make identity part of the key) and
    arranges for the entry to be evicted when any of `rels` is collected.

    `hits`/`misses` count every get() outcome — the observable contract
    serving tests lock ("N queries, one compile" shows up as one miss and
    N-1 hits). `scoped(tag)` returns a view whose keys live under `tag` in
    the same bounded store, so independent keying disciplines (verbatim
    runner keys vs canonicalized template keys) can share one cache without
    ever colliding.

    `on_evict`, if set, is called as `on_evict(key, value)` on EVERY path
    an entry leaves the cache — put-replacement, LRU overflow, finalizer
    eviction, explicit _evict, clear — so external accounting (the device-
    memory governor) can never go stale against the cache's contents.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.on_evict = None  # callable (key, value), see class docstring

    def get(self, key):
        hit = self._data.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._data.move_to_end(key)
        return hit[0]

    def scoped(self, tag: str) -> "ScopedCache":
        return ScopedCache(self, tag)

    def put(self, key, value, rels=()) -> None:
        old = self._data.pop(key, None)
        if old is not None:
            for fin in old[1]:
                fin.detach()
            if self.on_evict is not None and old[0] is not value:
                self.on_evict(key, old[0])
        fins = tuple(weakref.finalize(r, self._evict, key) for r in rels)
        self._data[key] = (value, fins)
        while len(self._data) > self.max_entries:
            k, (v, evicted_fins) = self._data.popitem(last=False)
            for fin in evicted_fins:
                fin.detach()
            if self.on_evict is not None:
                self.on_evict(k, v)

    def _evict(self, key) -> None:
        entry = self._data.pop(key, None)
        if entry is not None:
            for fin in entry[1]:
                fin.detach()
            if self.on_evict is not None:
                self.on_evict(key, entry[0])

    def __len__(self) -> int:
        return len(self._data)

    def clear(self) -> None:
        for k, (v, fins) in self._data.items():
            for fin in fins:
                fin.detach()
            if self.on_evict is not None:
                self.on_evict(k, v)
        self._data.clear()


class ScopedCache:
    """Namespace view over a KeyedCache: every key is stored as
    (tag, key), sharing the parent's LRU bound, finalizer discipline, and
    hit/miss counters. Used to give template-canonicalized runner keys
    their own namespace inside the runner cache."""

    def __init__(self, parent: KeyedCache, tag: str):
        self._parent = parent
        self._tag = tag

    def get(self, key):
        return self._parent.get((self._tag, key))

    def put(self, key, value, rels=()) -> None:
        self._parent.put((self._tag, key), value, rels)

    @property
    def hits(self) -> int:
        return self._parent.hits

    @property
    def misses(self) -> int:
        return self._parent.misses


class CardFeedback:
    """Measured-cardinality store: the optimizer's feedback loop.

    The compiled executor reports, for every executed node, the *exact*
    number of frontier lanes its expansion produced — which, for a node
    whose cover binds only fresh variables, is precisely the size of the
    join of the per-relation consumed prefixes (distinct-combination
    semantics, the same currency optimizer.prefix_card estimates). The
    adaptive runner records those measurements here after each successful
    unfiltered (or mask-mode batched) run; plan enumeration and capacity
    planning then consult the store, so a warm template re-optimizes and
    re-sizes against measured, not estimated, cardinalities.

    Keys are multisets of (relation identity, consumed-var set) pairs —
    one per atom of the measured sub-join — so a measurement taken under
    one plan transfers to any other plan (or any other query) joining the
    same prefixes of the same relation objects. Entries ride a KeyedCache,
    so they are LRU-bounded and die with their relations (weakref
    finalizers); id() reuse can never resurrect a stale measurement.

    `version` increments only when a recording *changes* the store
    materially (a new key, or a value drifting past `rtol`). Plan choice
    caches key on it: a steady-state stream of identical runs re-records
    identical measurements, never bumps the version, and therefore never
    re-enumerates."""

    def __init__(self, max_entries: int = 2048, rtol: float = 1.25):
        self._cache = KeyedCache(max_entries=max_entries)
        self.rtol = rtol
        self.version = 0
        self.records = 0  # record() calls that changed the store

    @staticmethod
    def key(specs) -> tuple:
        """specs: iterable of (rel, vars) pairs. The multiset is order-
        insensitive but duplicate-preserving (self-joins keep both legs)."""
        return tuple(sorted((id(r), tuple(sorted(vs))) for r, vs in specs))

    def record(self, specs, card: float) -> None:
        specs = list(specs)
        key = self.key(specs)
        card = float(max(1.0, card))
        old = self._cache.get(key)
        if old is not None and max(old, card) <= self.rtol * min(old, card):
            return  # within tolerance: keep the store (and the version) still
        self._cache.put(key, card, [r for r, _ in specs])
        self.records += 1
        self.version += 1

    def lookup(self, specs) -> float | None:
        return self._cache.get(self.key(specs))

    def __len__(self) -> int:
        return len(self._cache)

    def clear(self) -> None:
        self._cache.clear()
        self.version += 1


# the process-wide registry every compiled-path cache hangs off
REGISTRY = RelationRegistry()

# the process-wide measured-cardinality store (see CardFeedback)
FEEDBACK = CardFeedback()


# ---------------------------------------------------------------------------
# Mutation state: the delta-build contract (see module docstring)
# ---------------------------------------------------------------------------

COMPACT_RATIO = 0.5  # delete() compacts once live/total drops below this
MAX_LOG = 64  # log entries kept; older ones are pruned (consumers rebuild)


class MutationState:
    """Versioned delta log + liveness mask for one mutating relation.

    `version` is the relation's mutation clock: every append/delete/compact
    bumps it. Consumers that cache derived device state (TrieCache entries,
    standing-query stage fingerprints) record the version they materialized
    at; `deltas_since(v)` returns the log suffix they must replay, or None
    when that suffix was pruned or a compaction reset the clock, which
    means "rebuild from scratch".

    Tombstone semantics: `delete` never moves a row. The host-side `mult`
    mask zeroes the row (device tries zero the same rows in their mult
    column), and the weighted-trie mult-fold makes dead rows contribute
    nothing to counts or materialized outputs. Physical rows shrink only at
    `compact()`, which runs automatically once live/total < COMPACT_RATIO.
    """

    def __init__(self, rel):
        self.version = 0
        self.base_version = 0  # the log holds versions (base_version, version]
        self.total = rel.num_rows  # physical host rows (live + tombstoned)
        self.live = rel.num_rows
        self.mult = None  # (total,) int32 host liveness mask; None = all live
        self.log: list[tuple] = []  # (version, "append"|"delete", payload)
        self.cols = dict(rel.columns)  # current column identities (authority)
        self.uniques: dict[str, np.ndarray] = {}  # var -> sorted distincts
        self._live_rel: tuple | None = None  # (version, Relation) snapshot
        self.appends = 0
        self.deletes = 0
        self.compactions = 0
        # device uploads of the version-0 columns, captured at state birth
        # per (tensor device, var): the handle TrieCache uses to recognize a trie
        # built BEFORE the first mutation and adopt it as the version-0
        # merge base (the "warm build, then stream" path pays no rebuild)
        self.dev0 = {
            (str(hit[1].device), v): hit[1]
            for (_dev, v), hit in REGISTRY.namespace(rel, "dev_cols").items()
            if hit[0] is rel.columns.get(v)
        }

    def validate(self, rel) -> bool:
        """True while the relation's columns are the ones this state last
        produced. A column replaced behind the API's back (out-of-band
        mutation) fails this, and the state abdicates: identity
        revalidation of the plain memos regains authority."""
        return all(self.cols.get(v) is rel.columns[v] for v in rel.schema)

    def deltas_since(self, version: int) -> list[tuple] | None:
        if version < self.base_version:
            return None
        return [e for e in self.log if e[0] > version]

    def distinct(self, var: str) -> float | None:
        """Incrementally-maintained distinct count (an upper bound after
        deletes: tombstoned values are not retired until compaction)."""
        u = self.uniques.get(var)
        return None if u is None else float(max(1, len(u)))

    def _prune(self) -> None:
        while len(self.log) > MAX_LOG:
            self.base_version = self.log.pop(0)[0]


# Out-of-band mutation observability: a column replaced behind the delta
# API is handled correctly (the stale state abdicates and identity-keyed
# caches fully rebuild), but silently a workload paying rebuild-per-query
# would look like a healthy one. Every detection bumps a counter and the
# first one warns.
_OOB = {"swaps": 0, "warned": False}


def oob_swaps() -> int:
    """Process-lifetime count of out-of-band column swaps detected on
    mutating relations (each one dropped a delta log and forced cached
    tries to fully rebuild)."""
    return _OOB["swaps"]


def reset_oob_warning() -> None:
    """Re-arm the one-shot out-of-band-swap warning (tests)."""
    _OOB["warned"] = False


def _note_oob(rel) -> None:
    _OOB["swaps"] += 1
    if not _OOB["warned"]:
        _OOB["warned"] = True
        warnings.warn(
            f"out-of-band column swap detected on mutating relation "
            f"{rel.name!r}: its delta log was dropped and cached tries will "
            "fully rebuild. Mutate through relcache.append/delete/compact to "
            "keep delta merges. (Warned once per process; "
            "relcache.oob_swaps() counts every detection.)",
            RuntimeWarning,
            stacklevel=4,
        )


def mutation_state(rel) -> MutationState | None:
    """The relation's mutation state, or None if it was never mutated
    through this API (or was mutated out-of-band, which drops the stale
    state so the identity-keyed caches see a plain full rebuild)."""
    ns = REGISTRY.namespace(rel, "mutation")
    st = ns.get("state")
    if st is not None and not st.validate(rel):
        del ns["state"]
        _note_oob(rel)
        return None
    return st


def _state_of(rel) -> MutationState:
    ns = REGISTRY.namespace(rel, "mutation")
    st = ns.get("state")
    if st is None or not st.validate(rel):
        if st is not None:
            _note_oob(rel)
        st = MutationState(rel)
        ns["state"] = st
    return st


def append(rel, delta_cols: dict) -> MutationState:
    """Append rows to `rel` through the delta contract.

    Host columns are extended (new array objects), and every per-column
    memo is *primed* with an incrementally-computed value so the next
    build/planning pass pays O(delta):

    * "dev_cols": each cached device upload, on whichever device it was
      made for, is extended by a concatenation of the delta on that
      device, with no O(N) host-to-device re-transfer;
    * "key_bits": the radix sort width grows by a max over the delta;
    * "distinct": one np.union1d over the delta against the maintained
      sorted-distinct set (the optimizer's delta-aware size estimates).

    The delta lands in the version log; compiled.TrieCache replays it by
    sorting only the delta and merging sorted runs into the cached level
    buffers (zero full re-sorts)."""
    st = _state_of(rel)
    missing = set(rel.schema) - set(delta_cols)
    if missing:
        raise ValueError(f"append missing columns: {sorted(missing)}")
    arrs = {v: np.asarray(delta_cols[v]) for v in rel.schema}
    lens = {len(a) for a in arrs.values()}
    if len(lens) > 1:
        raise ValueError(f"ragged delta columns: {lens}")
    m = lens.pop() if lens else 0
    if m == 0:
        return st
    dev_ns = REGISTRY.namespace(rel, "dev_cols")
    bit_ns = REGISTRY.namespace(rel, "key_bits")
    dis_ns = REGISTRY.namespace(rel, "distinct")
    log_cols = {}
    for v in rel.schema:
        old = rel.columns[v]
        delta = arrs[v].astype(old.dtype, copy=False)
        new = np.concatenate([old, delta])
        for key, hit in list(dev_ns.items()):
            if key[1] == v and hit[0] is old:
                dev = hit[1]
                up = TRANSFERS.to_device(
                    np.asarray(delta, dtype=np.int32), dev.device, "appended rows"
                )
                dev_ns[key] = (new, torch.cat([dev, up]))
        hit = bit_ns.get(v)
        if hit is not None and hit[0] is old:
            if hit[1] is None or int(delta.min()) < 0:
                width = None
            else:
                width = max(hit[1], 1, int(delta.max()).bit_length())
            bit_ns[v] = (new, width)
        uniq = st.uniques.get(v)
        if uniq is None:  # first append pays one full unique; then O(delta)
            uniq = np.unique(old)
        uniq = np.union1d(uniq, delta)
        st.uniques[v] = uniq
        dis_ns[v] = (new, float(max(1, len(uniq))))
        rel.columns[v] = new
        log_cols[v] = np.ascontiguousarray(delta)
    rel.num_rows += m
    if st.mult is not None:
        st.mult = np.concatenate([st.mult, np.ones(m, np.int32)])
    st.total += m
    st.live += m
    st.version += 1
    st.appends += 1
    st.log.append((st.version, "append", log_cols))
    st._prune()
    st.cols = dict(rel.columns)
    st._live_rel = None
    return st


def delete(rel, rows) -> MutationState:
    """Tombstone rows of `rel` by physical index (row i is column[i]).
    Dead rows keep their slots with multiplicity 0 until live/total drops
    below COMPACT_RATIO, at which point compact() runs: the
    "real rebuild" threshold of the delta contract."""
    st = _state_of(rel)
    rows = np.unique(np.asarray(rows, np.int64))
    if rows.size == 0:
        return st
    if int(rows[0]) < 0 or int(rows[-1]) >= st.total:
        raise IndexError(f"delete rows out of range [0, {st.total})")
    if st.mult is None:
        st.mult = np.ones(st.total, np.int32)
    newly = int(np.count_nonzero(st.mult[rows]))
    st.mult[rows] = 0
    st.live -= newly
    st.version += 1
    st.deletes += 1
    st.log.append((st.version, "delete", rows.astype(np.int32)))
    st._prune()
    st._live_rel = None
    if st.total and st.live / st.total < COMPACT_RATIO:
        compact(rel)
    return st


def compact(rel) -> int:
    """Physically drop tombstoned rows. Host columns are REPLACED (new
    array objects), so every identity-keyed memo and cached trie sees the
    full rebuild a compaction is; the version log is cleared and
    base_version advanced so no cached consumer can "catch up" across it.
    Returns the number of rows dropped."""
    st = _state_of(rel)
    dropped = 0
    if st.mult is not None:
        mask = st.mult != 0
        dropped = int(st.total - np.count_nonzero(mask))
        if dropped:
            for v in rel.schema:
                rel.columns[v] = rel.columns[v][mask]
        rel.num_rows = int(np.count_nonzero(mask))
    st.mult = None
    st.total = st.live = rel.num_rows
    st.version += 1
    st.compactions += 1
    st.log.clear()
    st.base_version = st.version
    st.cols = dict(rel.columns)
    st.uniques.clear()  # deletes may have shrunk domains: recompute lazily
    st._live_rel = None
    return dropped


def live_relation(rel):
    """Live-rows host snapshot (tombstones dropped): the oracle view of a
    mutating relation. Cached per version, so repeated calls at the same
    version return the identical object and downstream identity-keyed
    memos (device uploads) stay warm."""
    st = mutation_state(rel)
    if st is None or st.mult is None or st.live == st.total:
        return rel
    if st._live_rel is not None and st._live_rel[0] == st.version:
        return st._live_rel[1]
    from repro_torch.relational.relation import Relation  # deferred: no cycle

    mask = st.mult != 0
    snap = Relation(rel.name, {v: rel.columns[v][mask] for v in rel.schema})
    st._live_rel = (st.version, snap)
    return snap


def live_size(rel) -> int:
    """Live row count: num_rows minus tombstones (the size the optimizer's
    delta-aware estimates plan for)."""
    st = mutation_state(rel)
    return rel.num_rows if st is None else st.live
