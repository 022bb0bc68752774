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

The reference package's mutation API (`append`/`delete`/`compact`, with a
versioned delta log that its trie cache replays) is not part of this port
yet: `mutation_state` always returns None here, so every relation is
served by identity revalidation alone, and `live_relation`/`live_size`
are the identity and the physical row count.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict


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


def mutation_state(rel) -> None:
    """The relation's mutation state. The port has no mutation API yet, so
    no relation ever has one."""
    return None


def live_relation(rel):
    """Live-rows host snapshot of `rel` (tombstones dropped). Without the
    mutation API every row is live, so this is `rel` itself."""
    return rel


def live_size(rel) -> int:
    """Live row count: the size the optimizer's estimates plan for."""
    return rel.num_rows
