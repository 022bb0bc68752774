"""The port's delta trie builds over mutating relations, against the
reference package on the same mutation sequence.

Each workload is built twice from the same numpy columns, once as the
reference's relations and once as the port's, and every mutation
(relcache.append / delete / compact) is applied to both. After each step
the port (`ExecOptions(device="cpu")`, every kernel's plain version) must
give exactly the reference's compiled result and the reference eager
engine's result over the live snapshot (counts and agg=None tuples), and
its trie cache must move exactly as the reference's does: an append is one
delta merge per cached layout and no build, a delete one tombstone refresh.
A reference trie-cache entry carried into the port (core/carry.py) must
merge an append, and retire a delete, into the same arrays bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import compiled as jcompiled
from repro.core import relcache as jrelcache
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch.core import TRIE_CACHE, ExecOptions, compiled_free_join, relcache, to_sorted_tuples
from repro_torch.core.carry import trie_cache_entry_from_arrays
from repro_torch.core.compiled import _LevelOps, device_columns
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query

CPU = ExecOptions(device="cpu")
TRIANGLE = [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x"))]
PATH = [("R", ("x", "y")), ("S", ("y", "z"))]
COUNTERS = ("builds", "delta_merges", "tombstone_refreshes")


def counters(cache):
    return tuple(getattr(cache, c) for c in COUNTERS)


class Pair:
    """One workload as two relation sets (reference and port) that start
    from the same numpy columns and take the same mutations."""

    def __init__(self, atoms, cols):
        self.q = Query([Atom(a, vs) for a, vs in atoms])
        self.jq = JQuery([JAtom(a, vs) for a, vs in atoms])
        self.rels = {a: Relation(a, {v: c.copy() for v, c in cs.items()}) for a, cs in cols.items()}
        self.jrels = {a: JRelation(a, {v: c.copy() for v, c in cs.items()})
                      for a, cs in cols.items()}

    @classmethod
    def random(cls, rng, atoms, n, dom):
        return cls(atoms, {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in atoms})

    def append(self, alias, delta):
        relcache.append(self.rels[alias], {v: c.copy() for v, c in delta.items()})
        jrelcache.append(self.jrels[alias], {v: c.copy() for v, c in delta.items()})

    def delete(self, alias, rows):
        relcache.delete(self.rels[alias], rows)
        jrelcache.delete(self.jrels[alias], rows)

    def compact(self, alias):
        assert relcache.compact(self.rels[alias]) == jrelcache.compact(self.jrels[alias])

    def oracle(self, agg):
        live = {a: jrelcache.live_relation(r) for a, r in self.jrels.items()}
        return J.free_join(self.jq, live, agg=agg)

    def check(self, agg="count"):
        """Port == reference compiled == reference eager over live rows; the
        port's trie-cache counters move exactly as the reference's. Returns
        the port's counter deltas."""
        c0, j0 = counters(TRIE_CACHE), counters(jcompiled.TRIE_CACHE)
        got = compiled_free_join(self.q, self.rels, agg=agg, options=CPU)
        want = J.compiled_free_join(self.jq, self.jrels, agg=agg)
        moved = tuple(b - a for a, b in zip(c0, counters(TRIE_CACHE)))
        assert moved == tuple(b - a for a, b in zip(j0, counters(jcompiled.TRIE_CACHE)))
        oracle = self.oracle(agg)
        if agg == "count":
            assert got == want == oracle
        else:
            tuples = to_sorted_tuples(got, self.q.head)
            assert tuples == J.to_sorted_tuples(want, self.jq.head)
            assert tuples == J.to_sorted_tuples(oracle, self.jq.head)
        for a, rel in self.rels.items():
            assert relcache.live_size(rel) == jrelcache.live_size(self.jrels[a])
        return dict(zip(COUNTERS, moved))

    def check_both(self):
        self.check("count")
        self.check(None)


def delta(rng, vars_, n, dom):
    return {v: rng.integers(0, dom, n).astype(np.int32) for v in vars_}


# ---- parity under random interleaved mutations ----------------------------


def test_interleaved_mutations_match_reference(rng):
    """Random appends, deletes and forced compactions on all three triangle
    relations; both packages agree with the live oracle at every step."""
    p = Pair.random(rng, TRIANGLE, 120, 8)
    p.check_both()  # cold build before any mutation
    aliases = list(p.rels)
    for _step in range(12):
        alias = aliases[int(rng.integers(len(aliases)))]
        rel = p.rels[alias]
        op = int(rng.integers(3))
        if op == 0:
            p.append(alias, delta(rng, rel.schema, int(rng.integers(1, 60)), 8))
        elif op == 1:
            n = rel.num_rows
            k = int(rng.integers(1, max(2, n // 4)))
            p.delete(alias, rng.choice(n, size=min(k, n), replace=False))
        else:
            p.compact(alias)
        p.check_both()


def test_append_new_keys_surface_in_tuples(rng):
    """Appended rows with never-before-seen keys appear in agg=None output
    (the distinct/key-bits memo priming)."""
    p = Pair.random(rng, PATH, 50, 6)
    p.check_both()
    p.append("R", {"x": np.int32([777]), "y": np.int32([888])})
    p.append("S", {"y": np.int32([888]), "z": np.int32([999])})
    p.check_both()
    got = compiled_free_join(p.q, p.rels, agg=None, options=CPU)
    assert (777, 888, 999) in to_sorted_tuples(got, p.q.head)


# ---- incrementality counters ----------------------------------------------


def test_append_is_one_delta_merge_zero_rebuilds(rng):
    """A warm append costs one delta merge per cached layout of the
    appended relation and no full build (the first one adopts the trie
    built before the mutation)."""
    p = Pair.random(rng, TRIANGLE, 200, 9)
    p.check()  # cold: builds
    for _ in range(3):
        p.append("R", delta(rng, ("x", "y"), 40, 9))
        moved = p.check()
        assert moved["builds"] == 0, "append must not trigger a full trie build"
        assert moved["delta_merges"] >= 1


def test_delete_is_tombstone_refresh_zero_rebuilds(rng):
    """A delete above the compaction threshold refreshes cached weights:
    no build, no delta merge, one tombstone refresh."""
    p = Pair.random(rng, TRIANGLE, 200, 9)
    p.check()
    p.delete("S", np.arange(10))
    moved = p.check()
    assert moved["builds"] == 0, "tombstone delete must not rebuild the trie"
    assert moved["delta_merges"] == 0
    assert moved["tombstone_refreshes"] >= 1


def test_auto_compaction_below_live_ratio(rng):
    """Deleting past the live/total threshold compacts: the physical
    relation shrinks to its live rows and results still match."""
    p = Pair.random(rng, PATH, 100, 6)
    p.check()
    p.delete("R", np.arange(80))  # live/total = 0.2 < default 0.5
    st = relcache.mutation_state(p.rels["R"])
    assert st is not None and st.compactions >= 1
    assert p.rels["R"].num_rows == 20, "compaction must drop dead rows physically"
    assert len(next(iter(p.rels["R"].columns.values()))) == 20
    p.check_both()


# ---- shape stability -------------------------------------------------------


def test_steady_state_appends_build_nothing_new(rng):
    """Within one capacity bucket, same-size appends reuse everything: the
    runner builds no new executor and the trie cache no new trie (the
    reference: its merge program does not retrace)."""
    p = Pair.random(rng, PATH, 300, 9)
    p.check()

    def delta16():
        # pin the delta's max key, so every delta sorts with the same width
        d = delta(rng, ("x", "y"), 16, 9)
        return {v: np.concatenate([c[:-1], np.int32([8])]) for v, c in d.items()}

    info = {}
    for _ in range(2):  # warmup: adoption merge + first steady-state merge
        p.append("R", delta16())
        p.check()
    compiled_free_join(p.q, p.rels, agg="count", options=CPU, info=info)
    runner = info["runner"]
    executors0, builds0 = len(runner._cache), TRIE_CACHE.builds
    jsize = getattr(jcompiled._merge_append_jit, "_cache_size", lambda: None)
    jsize0 = jsize()
    for _ in range(4):
        p.append("R", delta16())
        assert p.check()["delta_merges"] >= 1
    compiled_free_join(p.q, p.rels, agg="count", options=CPU, info=info)
    assert info["runner"] is runner
    assert len(runner._cache) == executors0, "steady-state append built a new executor"
    assert TRIE_CACHE.builds == builds0, "steady-state append built a trie"
    assert jsize() == jsize0


# ---- mutation-state bookkeeping -------------------------------------------


def test_live_relation_and_size_track_mutations(rng):
    cols = {"x": rng.integers(0, 5, 40), "y": rng.integers(0, 5, 40)}
    rel = Relation("R", {v: c.copy() for v, c in cols.items()})
    jrel = JRelation("R", {v: c.copy() for v, c in cols.items()})
    dev = device_columns(rel, "cpu")
    for r, rc in ((rel, relcache), (jrel, jrelcache)):
        rc.append(r, {"x": np.int32([1, 2]), "y": np.int32([3, 4])})
        assert rc.live_size(r) == 42
        rc.delete(r, np.int32([0, 1]))
        assert rc.live_size(r) == 40
    live, jlive = relcache.live_relation(rel), jrelcache.live_relation(jrel)
    for v in cols:
        np.testing.assert_array_equal(live.columns[v], jlive.columns[v])
    assert relcache.live_relation(rel) is live, "the snapshot is cached per version"
    # the append primed the device upload: a concatenation on the device,
    # served from the memo for the new column object, not a re-upload
    ns = relcache.REGISTRY.namespace(rel, "dev_cols")
    for v in cols:
        host, primed = ns[("cpu", v)]
        assert host is rel.columns[v]
        assert device_columns(rel, "cpu")[v] is primed
        np.testing.assert_array_equal(primed.numpy(), rel.columns[v])
        assert torch.equal(primed[:40], dev[v])
    st, jst = relcache.mutation_state(rel), jrelcache.mutation_state(jrel)
    assert (st.version, st.total, st.live) == (jst.version, jst.total, jst.live)
    np.testing.assert_array_equal(st.mult, jst.mult)


# ---- one merge from a carried reference entry --------------------------------


def trie_fields(trie):
    """The trie's fields in the reference StaticTrie's flatten order, as
    numpy (port tensors or reference jax arrays)."""
    if hasattr(trie, "tree_flatten"):
        children = jax.device_get(trie.tree_flatten()[0])
    else:
        children = (trie.cols, trie.mult_col, trie.total_mult, trie.order, trie.sorted_cols,
                    trie.g, trie.kpos, trie.child_base, trie.child_counts, trie.row_count,
                    trie.row_weight, trie.tables)
    return jax.tree_util.tree_map(
        np.asarray, children[:-1] + ([None if t is None else tuple(t) for t in children[-1]]
                                     if children[-1] is not None else None,),
        is_leaf=lambda x: isinstance(x, torch.Tensor),
    )


def assert_same_arrays(got, want, path="trie"):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want), path
    for (kp, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                          jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{path}{jax.tree_util.keystr(kp)}")


@pytest.mark.parametrize("levels,probed", [
    ((("x",), ("y",)), (True, True)),
    ((("y",), ("x",)), (False, True)),
    ((("x", "y"),), (True,)),
    ((("x", "y"),), (False,)),  # trivial: no order, columns and mult only
])
@pytest.mark.parametrize("first,second", [(300, 40), (1000, 100)])  # in bucket / bucket growth
def test_carried_entry_merge_and_retire_bit_for_bit(levels, probed, first, second, rng):
    """Start both packages from the reference's padded, weighted trie of a
    mutated relation (carried into the port's trie cache), apply the same
    append, then the same delete: the port's merged and retired trie
    equals the reference's array for array, and equals the port's own
    (uncarried) delta path too."""
    cols = {"x": rng.integers(0, 30, first), "y": rng.integers(0, 50, first)}
    d1 = delta(rng, ("x", "y"), 16, 30)
    d2 = delta(rng, ("x", "y"), second, 60)
    gone = rng.choice(first, size=first // 8, replace=False)
    jrel = JRelation("R", {v: c.copy() for v, c in cols.items()})
    carried = Relation("R", {v: c.copy() for v, c in cols.items()})
    own = Relation("R", {v: c.copy() for v, c in cols.items()})
    jlops, lops = jcompiled._LevelOps(levels, probed), _LevelOps(levels, probed)

    def jget():
        jcompiled.TRIE_CACHE.get(jrel, jcompiled.device_columns(jrel), jlops)
        key = (levels, "jnp", 32, lops.probed == (False,))
        return jrelcache.REGISTRY.namespace(jrel, "tries")[key]

    def get(rel):
        TRIE_CACHE.get(rel, device_columns(rel, "cpu"), lops)
        return relcache.REGISTRY.namespace(rel, "tries")[TRIE_CACHE.entry_key(lops, "cpu", 32)]

    for r, rc in ((jrel, jrelcache), (carried, relcache), (own, relcache)):
        rc.append(r, {v: c.copy() for v, c in d1.items()})
    jentry = jget()  # the reference's padded weighted rebuild at version 1
    assert jentry["version"] == 1 and jentry["n_real"] == first + 16
    trie_cache_entry_from_arrays(carried, lops, trie_fields(jentry["trie"]),
                                 n_real=jentry["n_real"], version=jentry["version"],
                                 device="cpu")
    assert_same_arrays(trie_fields(get(own)["trie"]), trie_fields(jentry["trie"]), "rebuild")
    for step, (mutate, counter) in enumerate((
        (lambda r, rc: rc.append(r, {v: c.copy() for v, c in d2.items()}), "delta_merges"),
        (lambda r, rc: rc.delete(r, gone), "tombstone_refreshes"),
    )):
        for r, rc in ((jrel, jrelcache), (carried, relcache), (own, relcache)):
            mutate(r, rc)
        jentry = jget()
        c0 = counters(TRIE_CACHE)
        entry = get(carried)
        moved = dict(zip(COUNTERS, (b - a for a, b in zip(c0, counters(TRIE_CACHE)))))
        assert moved["builds"] == 0 and moved[counter] == 1
        assert entry["n_real"] == jentry["n_real"] and entry["version"] == jentry["version"]
        want = trie_fields(jentry["trie"])
        assert_same_arrays(trie_fields(entry["trie"]), want, f"carried step {step}")
        assert_same_arrays(trie_fields(get(own)["trie"]), want, f"own step {step}")
