"""Port trie build, segmented radix sort, trie cache and executor against
the reference package, on the same numpy inputs.

The reference side runs its jnp / Pallas-interpret implementations on the
CPU; the port runs on the CPU, where each kernel wrapper takes its plain
PyTorch version. Every comparison is exact (integer outputs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiled as jcompiled
from repro.core.capacity import plan_capacities as jplan_capacities
from repro.core.plan import binary2fj as jbinary2fj
from repro.core.plan import factor as jfactor
from repro.kernels import ref as jref
from repro.kernels.radix_sort import segmented_sort as jsegmented_sort
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch.core import compiled
from repro_torch.core.carry import (
    capacity_plan_from_reference,
    relations_from_numpy,
    trie_from_arrays,
)
from repro_torch.core.compiled import TRIE_CACHE, _LevelOps, build_trie, device_columns
from repro_torch.core.plan import binary2fj, factor
from repro_torch.kernels import ref
from repro_torch.kernels.radix_sort import segmented_sort
from repro_torch.relational.schema import Atom, Query


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def assert_same(got, want, path="trie"):
    """Exact structural equality of a port value and a reference value:
    dicts, lists/tuples, None, and tensors against jax/numpy arrays."""
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert got is not None and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def fields(trie):
    """The port trie's fields, in the reference StaticTrie's flatten order."""
    return (
        trie.cols, trie.mult_col, trie.total_mult, trie.order, trie.sorted_cols, trie.g,
        trie.kpos, trie.child_base, trie.child_counts, trie.row_count, trie.row_weight,
        None if trie.tables is None else [None if t is None else tuple(t) for t in trie.tables],
    )


def ref_fields(jtrie):
    children = jax.device_get(jtrie.tree_flatten()[0])
    tables = children[-1]
    return children[:-1] + (
        None if tables is None else [None if t is None else tuple(t) for t in tables],
    )


# ---- the segmented radix sort (K4's caller) ------------------------------------


@pytest.mark.parametrize(
    "n,doms", [(1, (4,)), (64, (16, 300)), (1000, (7, 5, 900)), (4096, (2, 2))]
)
def test_segmented_sort_vs_lexsort_and_pallas(n, doms, rng):
    cols = [rng.integers(0, d, n).astype(np.int32) for d in doms]
    bits = tuple(max(1, int(d - 1).bit_length()) for d in doms)
    got = segmented_sort([t32(c) for c in cols], bits)
    np.testing.assert_array_equal(got.numpy(), ref.segmented_sort_ref([t32(c) for c in cols]))
    want = jsegmented_sort([jnp.asarray(c) for c in cols], bits, impl="pallas_interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segmented_sort_presorted_prefix(rng):
    """Seeding with a cached prefix order must land on the full sort."""
    n = 777
    c0 = t32(rng.integers(0, 30, n))
    c1 = t32(rng.integers(0, 500, n))
    full = segmented_sort([c0, c1], (5, 9))
    pre = segmented_sort([c0], (5,))
    seeded = segmented_sort([c0, c1], (5, 9), init_order=pre, presorted=1)
    np.testing.assert_array_equal(seeded.numpy(), full.numpy())
    both = segmented_sort([c0, c1], (5, 9), init_order=full, presorted=2)
    np.testing.assert_array_equal(both.numpy(), full.numpy())
    jpre = jsegmented_sort([jnp.asarray(c0.numpy())], (5,), impl="pallas_interpret")
    jseeded = jsegmented_sort(
        [jnp.asarray(c0.numpy()), jnp.asarray(c1.numpy())], (5, 9), impl="pallas_interpret",
        init_order=jpre, presorted=1,
    )
    np.testing.assert_array_equal(seeded.numpy(), np.asarray(jseeded))


def test_segmented_sort_duplicate_heavy(rng):
    n = 2048
    cols = [np.zeros(n, np.int32), rng.integers(0, 3, n).astype(np.int32)]
    got = segmented_sort([t32(c) for c in cols], (1, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.segmented_sort_ref(cols)))


# ---- the trie build ------------------------------------------------------------


TRIE_CASES = [
    # (levels, probed, weighted, rows)
    ((("x",), ("y",)), (True, False), False, 300),
    ((("x", "y"),), (False,), False, 200),
    ((("y",), ("x",)), (True, True), False, 500),
    ((("x",), ("y",)), (True, False), True, 257),
    ((("x",), ("y",)), (True, False), False, 0),
]


@pytest.mark.parametrize("levels,probed,weighted,n", TRIE_CASES)
def test_build_trie_bit_for_bit(levels, probed, weighted, n, rng):
    cols = {"x": rng.integers(0, 20, n).astype(np.int32),
            "y": rng.integers(0, 50, n).astype(np.int32)}
    mult = rng.integers(0, 3, n).astype(np.int32) if weighted else None
    bits = None if weighted or n == 0 else tuple(
        max(1, int(cols[v].max()).bit_length()) for lv in levels for v in lv
    )
    jtrie = jcompiled.build_trie(
        {v: jnp.asarray(c) for v, c in cols.items()}, jcompiled._LevelOps(levels, probed),
        impl="jnp", mult=None if mult is None else jnp.asarray(mult), key_bits=bits,
    )
    trie = build_trie({v: t32(c) for v, c in cols.items()}, _LevelOps(levels, probed),
                      mult=None if mult is None else t32(mult), key_bits=bits)
    assert (trie.n, trie.empty, trie.trivial) == (jtrie.n, jtrie.empty, jtrie.trivial)
    assert_same(fields(trie), ref_fields(jtrie))


def test_trie_from_arrays_round_trip(rng):
    cols = {"x": rng.integers(0, 9, 100), "y": rng.integers(0, 9, 100)}
    lops = _LevelOps((("x",), ("y",)), (True, True))
    built = build_trie({v: t32(c) for v, c in cols.items()}, lops)
    carried = trie_from_arrays(lops, [
        None if f is None else jax.tree_util.tree_map(lambda a: a.numpy(), f)
        for f in fields(built)
    ], device="cpu")
    assert_same(fields(carried), fields(built))
    assert (carried.n, carried.L, carried.trivial) == (built.n, built.L, built.trivial)


# ---- the trie cache --------------------------------------------------------------


def test_trie_cache_hits_lazy_tables_and_order_sharing(rng):
    rel = relations_from_numpy({"R": {"x": rng.integers(0, 30, 400),
                                      "y": rng.integers(0, 40, 400)}})["R"]
    dev = device_columns(rel, "cpu")
    assert device_columns(rel, "cpu")["x"] is dev["x"], "uploads are cached per column"
    c0 = (TRIE_CACHE.builds, TRIE_CACHE.table_builds, TRIE_CACHE.hits, TRIE_CACHE.order_shares)
    a = TRIE_CACHE.get(rel, dev, _LevelOps((("x",), ("y",)), (False, True)))
    TRIE_CACHE.get(rel, dev, _LevelOps((("x",), ("y",)), (False, True)))  # hit
    b = TRIE_CACHE.get(rel, dev, _LevelOps((("x",), ("y",)), (True, True)))  # lazy table
    TRIE_CACHE.get(rel, dev, _LevelOps((("x", "y"),), (True,)))  # shares the order
    c1 = (TRIE_CACHE.builds, TRIE_CACHE.table_builds, TRIE_CACHE.hits, TRIE_CACHE.order_shares)
    assert tuple(x - y for x, y in zip(c1, c0)) == (2, 1, 1, 1)
    assert a.tables[0] is None and b.tables[0] is not None
    assert b.order is a.order


# ---- the executor on a reference-built trie and capacity plan ----------------------


def _triangle_inputs(rng, n=80, dom=9):
    cols = {
        "R": {"x": rng.integers(0, dom, n), "y": rng.integers(0, dom, n)},
        "S": {"y": rng.integers(0, dom, n), "z": rng.integers(0, dom, n)},
        "T": {"z": rng.integers(0, dom, n), "x": rng.integers(0, dom, n)},
    }
    jq = JQuery([JAtom("R", ("x", "y")), JAtom("S", ("y", "z")), JAtom("T", ("z", "x"))])
    q = Query([Atom("R", ("x", "y")), Atom("S", ("y", "z")), Atom("T", ("z", "x"))])
    return cols, jq, q


@pytest.mark.parametrize("agg", ["count", None])
@pytest.mark.parametrize("squeeze", [False, True])
def test_executor_on_carried_trie_and_plan(agg, squeeze, rng):
    cols, jq, q = _triangle_inputs(rng)
    jrels = {a: JRelation(a, c) for a, c in cols.items()}
    jfj = jfactor(jbinary2fj(jq.atoms, jq))
    jcp = jplan_capacities(jfj, jrels, block=128)
    if squeeze:  # force a (too small) compaction: its need must be reported
        jcp = jcp.__class__(capacities=jcp.capacities, compact_to=(64,) + jcp.compact_to[1:],
                            compact_probe=jcp.compact_probe, block=128)
    jsched = jcompiled._static_schedule(jfj)
    jtries = {
        a: jcompiled.TRIE_CACHE.get(jrels[a], jcompiled.device_columns(jrels[a]), lo)
        for a, lo in jsched.level_ops.items()
    }
    jfn = jcompiled.make_executor(jfj, jcp.capacities, compact_to=jcp.compact_to,
                                  compact_probe=jcp.compact_probe, agg=agg, schedule=jsched)
    want = jax.device_get(jax.jit(jfn)(jtries))

    fj = factor(binary2fj(q.atoms, q))
    assert str(fj) == str(jfj)
    cp = capacity_plan_from_reference(jcp)
    assert str(cp) == str(jcp)
    tries = {
        a: trie_from_arrays(lo, ref_fields(jtries[a]), empty=jtries[a].empty, device="cpu")
        for a, lo in jsched.level_ops.items()
    }
    fn = compiled.make_executor(fj, cp.capacities, compact_to=cp.compact_to,
                                compact_probe=cp.compact_probe, agg=agg)
    got = fn(tries)
    if agg == "count":
        assert int(got[0]) == int(want[0])
    else:
        assert_same(got[0], want[0], "bound")
        for g, w, name in zip(got[1:3], want[1:3], ("valid", "mult")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(got[-2].numpy(), np.asarray(want[-2]), err_msg="need_expand")
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]), err_msg="need_compact")
    if squeeze:
        assert int(got[-1][0]) > 64, "the overflowing compaction reports its live need"
