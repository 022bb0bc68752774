"""Global device-memory governor for the compiled path's caches.

Every persistent device buffer the serving stack keeps warm (cached
StaticTries in compiled.TRIE_CACHE, cached AdaptiveExecutors and their
frontier capacity vectors in api._runner_cache) is accounted here against
one configurable budget. Without a budget (the default) the governor is
pure bookkeeping: `live_bytes` is observable, nothing is ever refused.
With a budget set (`set_budget` / the `budget()` context manager) the
governor enforces one invariant:

    governed live bytes never exceed the budget.

Enforcement has two teeth:

* **LRU eviction of cold entries.** Every accounted entry carries an
  evict callback that drops it from its home cache (a trie namespace
  entry, a runner-cache slot). When a new or grown entry needs room, the
  least-recently-touched entries are evicted until it fits.
* **Admission shedding.** When evicting everything else still cannot make
  room (the entry alone is bigger than the budget), `account` raises
  MemoryBudgetError *without* registering the entry. Callers shed: the
  trie cache serves the trie uncached, the runner cache declines to keep
  the runner, and a runner whose adaptive GROWTH would blow the budget
  propagates the error into the serving engine's degradation ladder
  (halve the batch -> unbatched -> eager), so the query still answers.

The governor is an accounting model: it counts the bytes of the tensors
it is told about (`tensor.numel() * tensor.element_size()`). It never
reads the CUDA allocator's state and never empties its cache, so the CPU
and the card make the same decisions on the same workload.

Entries die three ways, all releasing their bytes: governor eviction
(the callback removes them from their cache), explicit `release` (the
home cache dropped them first; KeyedCache.on_evict wires this), or their
owner relation being garbage collected (a weakref.finalize per owned
token). Tokens embed `id(owner)`, which is safe for the same reason
relcache.KeyedCache keys are: the finalizer releases the token before
the id can be reused.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import OrderedDict

import torch


class MemoryBudgetError(RuntimeError):
    """Admitting/growing a governed buffer would exceed the device-memory
    budget even after evicting every cold entry. Carries the arithmetic so
    callers (and the degradation ladder) can report it."""

    def __init__(self, requested: int, live: int, budget: int):
        super().__init__(
            f"device-memory budget exceeded: need {requested} bytes with "
            f"{live} live of {budget} budget"
        )
        self.requested = requested
        self.live = live
        self.budget = budget


class MemoryGovernor:
    """LRU accounting of governed device buffers against one budget.

    `account(token, nbytes, evict=cb, owner=rel)` registers or resizes an
    entry; `touch` marks it recently used; `release` forgets it without
    calling its callback (the home cache already dropped it). Counters:
    `live_bytes` (current governed total), `peak_bytes`, `evictions`
    (entries removed to make room), `sheds` (account refusals)."""

    def __init__(self, budget_bytes: int | None = None):
        self.budget = budget_bytes
        self._entries: OrderedDict = OrderedDict()  # token -> [nbytes, evict_cb]
        self._fins: dict = {}  # token -> weakref.finalize on its owner
        self.live_bytes = 0
        self.peak_bytes = 0
        self.evictions = 0
        self.sheds = 0

    # ---- accounting ---------------------------------------------------
    def account(self, token, nbytes: int, *, evict=None, owner=None) -> None:
        """Register `token` at `nbytes` (or resize an existing entry),
        evicting cold entries as needed. Raises MemoryBudgetError — with
        the entry left exactly as it was — when no amount of eviction can
        make the growth fit."""
        nbytes = int(nbytes)
        entry = self._entries.get(token)
        delta = nbytes - (entry[0] if entry is not None else 0)
        if self.budget is not None and delta > 0:
            self._reserve(delta, protect=token)
        if entry is None:
            self._entries[token] = [nbytes, evict]
            if owner is not None and token not in self._fins:
                self._fins[token] = weakref.finalize(owner, self._owner_died, token)
        else:
            entry[0] = nbytes
            if evict is not None:
                entry[1] = evict
            self._entries.move_to_end(token)
        self.live_bytes += delta
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def touch(self, token) -> None:
        if token in self._entries:
            self._entries.move_to_end(token)

    def release(self, token) -> None:
        """Forget an entry WITHOUT its evict callback — the home cache has
        already dropped it (or is dropping it right now)."""
        entry = self._entries.pop(token, None)
        if entry is not None:
            self.live_bytes -= entry[0]
        fin = self._fins.pop(token, None)
        if fin is not None:
            fin.detach()

    def _owner_died(self, token) -> None:
        self._fins.pop(token, None)
        self.release(token)

    def _reserve(self, delta: int, *, protect=None) -> None:
        """Evict least-recently-touched entries until `delta` more bytes
        fit under the budget; raise (shed) when they cannot."""
        while self.live_bytes + delta > self.budget:
            victim = next((t for t in self._entries if t != protect), None)
            if victim is None:
                self.sheds += 1
                raise MemoryBudgetError(delta, self.live_bytes, self.budget)
            nbytes, cb = self._entries.pop(victim)
            self.live_bytes -= nbytes
            self.evictions += 1
            fin = self._fins.pop(victim, None)
            if fin is not None:
                fin.detach()
            if cb is not None:
                cb()

    # ---- configuration ------------------------------------------------
    def set_budget(self, budget_bytes: int | None) -> None:
        """Set (or clear) the budget. Shrinking below the current live
        total evicts coldest-first until the invariant holds again."""
        self.budget = budget_bytes
        if budget_bytes is not None and self.live_bytes > budget_bytes:
            self._reserve(0)

    def reset(self) -> None:
        """Drop all accounting (tests). Home caches are NOT touched —
        their entries simply stop being governed."""
        for fin in self._fins.values():
            fin.detach()
        self._fins.clear()
        self._entries.clear()
        self.live_bytes = 0


# the process-wide governor every compiled-path cache reports to
GOVERNOR = MemoryGovernor()


def set_budget(budget_bytes: int | None) -> None:
    GOVERNOR.set_budget(budget_bytes)


@contextlib.contextmanager
def budget(budget_bytes: int | None):
    """Scoped budget: `with membudget.budget(64 << 20): ...` — restores
    the previous budget (and its enforcement) on exit."""
    old = GOVERNOR.budget
    GOVERNOR.set_budget(budget_bytes)
    try:
        yield GOVERNOR
    finally:
        GOVERNOR.set_budget(old)


def _nbytes(x) -> int:
    """Total bytes of a nested structure of tensors: numel() *
    element_size() per tensor (numpy arrays by their .nbytes); dicts,
    lists and tuples (a hash table is a NamedTuple) recurse, scalars and
    None count zero."""
    if x is None:
        return 0
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    nb = getattr(x, "nbytes", None)
    return int(nb) if nb is not None else 0


# the StaticTrie attributes holding its tensors, in the reference's pytree
# order: level columns, weights, sort order, group structure, hash tables
_TRIE_TENSORS = (
    "cols",
    "mult_col",
    "total_mult",
    "order",
    "sorted_cols",
    "g",
    "kpos",
    "child_base",
    "child_counts",
    "row_count",
    "row_weight",
    "tables",
)


def trie_nbytes(trie) -> int:
    """Device bytes held by one StaticTrie: every tensor it holds (level
    columns, sort order, group ids, hash tables, ...)."""
    return _nbytes([getattr(trie, name) for name in _TRIE_TENSORS])
