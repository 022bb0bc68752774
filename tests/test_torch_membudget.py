"""The port's MemoryGovernor on its own: the reference's unit cases
(tests/test_membudget.py) run against `repro_torch.core.membudget` with
the reference's expected values, plus the byte count of a port trie.

The governor is an accounting model (tensor bytes, never the CUDA
allocator's state), so these cases need no card. Its integration with the
caches under a live budget is in tests/test_torch_chaos.py."""
import gc

import numpy as np
import pytest
import torch

from repro_torch.core import membudget
from repro_torch.core.compiled import TRIE_CACHE, _LevelOps, build_trie, device_columns
from repro_torch.core.membudget import MemoryBudgetError, MemoryGovernor
from repro_torch.relational.relation import Relation


def test_bookkeeping_without_budget_never_refuses():
    gov = MemoryGovernor()
    gov.account("a", 100)
    gov.account("b", 50)
    assert gov.live_bytes == 150 and gov.peak_bytes == 150
    gov.account("a", 30)  # resize down
    assert gov.live_bytes == 80
    gov.release("b")
    assert gov.live_bytes == 30
    assert gov.evictions == 0 and gov.sheds == 0
    gov.account("c", 1 << 60)  # no budget, no enforcement
    assert gov.peak_bytes == 30 + (1 << 60)


def test_lru_eviction_order_and_callbacks():
    dropped = []
    gov = MemoryGovernor(budget_bytes=100)
    for name, n in (("a", 40), ("b", 40), ("c", 20)):
        gov.account(name, n, evict=lambda name=name: dropped.append(name))
    # "a" is coldest; touching it promotes it, so "b" pays for "d"
    gov.touch("a")
    gov.account("d", 30, evict=lambda: dropped.append("d"))
    assert dropped == ["b"]
    assert gov.live_bytes == 40 + 20 + 30
    assert gov.evictions == 1
    # the evicted token is really gone: accounting it again is a fresh entry
    gov.account("b", 10, evict=lambda: dropped.append("b2"))
    assert gov.live_bytes == 100


def test_shed_leaves_state_untouched():
    gov = MemoryGovernor(budget_bytes=100)
    gov.account("a", 60, evict=lambda: None)
    with pytest.raises(MemoryBudgetError) as ei:
        gov.account("whale", 200)
    assert ei.value.budget == 100
    assert gov.sheds == 1
    assert "whale" not in gov._entries
    assert gov.live_bytes <= 100


def test_growing_an_entry_never_evicts_itself():
    gov = MemoryGovernor(budget_bytes=100)
    gov.account("me", 60, evict=lambda: pytest.fail("self-eviction"))
    gone = []
    gov.account("other", 30, evict=lambda: gone.append("other"))
    gov.account("me", 90)
    assert gone == ["other"]
    assert gov.live_bytes == 90
    # growth that cannot fit even alone sheds, and the OLD size survives
    with pytest.raises(MemoryBudgetError):
        gov.account("me", 150)
    assert gov._entries["me"][0] == 90 and gov.live_bytes == 90


def test_owner_gc_releases_token():
    gov = MemoryGovernor()

    class Owner:
        pass

    o = Owner()
    gov.account("t", 77, owner=o)
    assert gov.live_bytes == 77
    del o
    gc.collect()
    assert gov.live_bytes == 0 and "t" not in gov._entries


def test_release_detaches_owner_finalizer():
    gov = MemoryGovernor()

    class Owner:
        pass

    o = Owner()
    gov.account("t", 10, owner=o)
    gov.release("t")
    gov.account("t2", 5)
    del o
    gc.collect()  # the dead finalizer must not touch anything
    assert gov.live_bytes == 5


def test_set_budget_shrink_evicts_coldest_first():
    gone = []
    gov = MemoryGovernor()
    for name in ("a", "b", "c"):
        gov.account(name, 40, evict=lambda name=name: gone.append(name))
    gov.set_budget(50)
    assert gone == ["a", "b"]
    assert gov.live_bytes == 40 and gov.budget == 50


def test_budget_context_restores_previous():
    gov = membudget.GOVERNOR
    old = gov.budget
    with membudget.budget(1 << 30) as g:
        assert g is gov and gov.budget == 1 << 30
    assert gov.budget == old


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_nbytes_walks_nested_structures(kind):
    a = torch.zeros(10, dtype=torch.int32) if kind == "tensor" else np.zeros(10, np.int32)
    assert membudget._nbytes(a) == 40
    assert membudget._nbytes({"x": a, "y": [a, (a, a, None)]}) == 160
    assert membudget._nbytes(None) == 0
    assert membudget._nbytes(3) == 0  # scalars carry no bytes
    assert membudget._nbytes(torch.zeros(3, 5, dtype=torch.int64)) == 120
    # a view counts its own elements, not its base's storage
    assert membudget._nbytes(torch.zeros(100, dtype=torch.int32)[:10]) == 40


def _tensor_bytes(trie) -> int:
    """Every tensor reachable from the trie's attributes, by numel() *
    element_size(): an independent walk over __dict__."""
    total = 0

    def walk(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    for v in vars(trie).values():
        walk(v)
    return total


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("levels,probed", [((("x",), ("y",)), (True, True)),
                                           ((("x", "y"),), (True,)),
                                           ((("x",),), (False,))])
def test_trie_nbytes_is_the_sum_of_its_tensors(levels, probed, weighted, rng):
    n = 500
    cols = {v: torch.as_tensor(rng.integers(0, 30, n), dtype=torch.int32) for v in ("x", "y")}
    mult = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int32) if weighted else None
    trie = build_trie(cols, _LevelOps(levels, probed), mult=mult)
    assert membudget.trie_nbytes(trie) == _tensor_bytes(trie) > 0
    if probed[-1]:
        table = trie.tables[-1]
        assert membudget._nbytes(table) == sum(
            t.numel() * t.element_size() for t in table
        )


def test_trie_cache_accounts_its_entries(rng):
    """A cached trie is governed at its byte count; a budget below it
    sheds the entry (served uncached) and keeps the invariant."""
    rel = Relation("R", {"x": rng.integers(0, 50, 2000), "y": rng.integers(0, 50, 2000)})
    lo = _LevelOps((("x",), ("y",)), (True, True))
    gov = membudget.GOVERNOR
    before = gov.live_bytes
    trie = TRIE_CACHE.get(rel, device_columns(rel, "cpu"), lo)
    assert gov.live_bytes - before == membudget.trie_nbytes(trie)
    rel2 = Relation("S", {"x": rng.integers(0, 50, 2000), "y": rng.integers(0, 50, 2000)})
    with membudget.budget(gov.live_bytes + 64):
        made_room = gov.sheds + gov.evictions
        trie2 = TRIE_CACHE.get(rel2, device_columns(rel2, "cpu"), lo)
        assert trie2.n == 2000
        assert gov.live_bytes <= gov.budget
        assert gov.sheds + gov.evictions > made_room
