"""The port's distributed HyperCube Free Join (`repro_torch.core.distributed`)
on the CPU, against the reference (`repro.core.distributed`).

Both packages get the same numpy relations, and every comparison is exact:
mix64, the share assignment and its memo, the partition shard by shard,
the dense padding and the pad masks, and distributed_join_host's counts
and rows element for element.

The reference's own SPMD path runs its shards under shard_map, which the
installed JAX rejects (tests/test_compiled_distributed.py::test_spmd_*
fail). `reference_spmd` below replays that path's per-shard pipeline
without shard_map: each shard's _mask_pad, StaticTrie and make_executor
(impl="jnp") from the reference, the count summed and the needs
max-reduced over the shards, and the reference's overflows/grow_to retry
loop. The port's spmd_count is held to that replay in the four cases of
the reference's SPMD tests, and across gloo ranks in spawned processes.
"""
import json
from dataclasses import dataclass, replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import repro.core as J
from repro.core import compiled as jcompiled
from repro.core import distributed as JD
from repro.core.capacity import CapacityPlan as JCapacityPlan
from repro.core.capacity import plan_capacities as jplan_capacities
from repro.core.optimizer import Stats as JStats
from repro.relational.npkit import mix64 as jmix64
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery
from repro_torch.core import distributed as D
from repro_torch.core import free_join, optimize
from repro_torch.core.plan import BinaryPlan, binary2fj, factor
from repro_torch.relational.npkit import mix64
from repro_torch.relational.oracle import join_oracle
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from tests.torch_dist_ranks import rank_main, spmd_records, workload

QUERIES = {
    "triangle": [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "x"))],
    "clover": [("R", ("x", "a")), ("S", ("x", "b")), ("T", ("x", "c"))],
    "four_cycle": [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("z", "w")), ("U", ("w", "x"))],
    "star": [("R", ("x", "y")), ("S", ("y", "z")), ("T", ("y", "w"))],
    "zero_vars": [("R", ())],
}


class Case:
    """One workload built twice from the same numpy columns: for the port
    and for the reference."""

    def __init__(self, atoms, cols):
        self.q = Query([Atom(a, vs) for a, vs in atoms])
        self.jq = JQuery([JAtom(a, vs) for a, vs in atoms])
        self.rels = {a: Relation(a, c) for a, c in cols.items()}
        self.jrels = {a: JRelation(a, c) for a, c in cols.items()}

    def plans(self):
        return (factor(binary2fj(self.q.atoms, self.q)),
                J.factor(J.binary2fj(self.jq.atoms, self.jq)))


def random_case(rng, name, n, dom) -> Case:
    atoms = QUERIES[name]
    return Case(atoms, {a: {v: rng.integers(0, dom, n) for v in vs} for a, vs in atoms})


@pytest.fixture(autouse=True)
def fresh_plan_cache():
    """Grown plans persist per (plan, sizes, shards), not per relation
    object: start each test with neither package's memo."""
    D._cap_plan_cache.clear()
    JD._cap_plan_cache.clear()


def test_mix64_matches_reference(rng):
    info = np.iinfo(np.int64)
    edge = np.array([0, 1, -1, 2**31 - 1, -(2**31), 2**32, info.max, info.min, info.min + 1])
    cols = [np.concatenate([edge, rng.integers(info.min, info.max, 500, dtype=np.int64)]),
            np.concatenate([edge[::-1], rng.integers(-1000, 1000, 500)])]
    for k in (1, 2):
        got, want = mix64(cols[:k]), jmix64(cols[:k])
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    assert mix64([]).shape == jmix64([]).shape == (0,)


@pytest.mark.parametrize("name", list(QUERIES))
@pytest.mark.parametrize("num_shards", [1, 2, 4, 8])
def test_hypercube_shares_match_reference(name, num_shards, rng):
    case = random_case(rng, name, 10, 4)
    for sizes in ({a.alias: 100 for a in case.q.atoms},
                  {a.alias: int(rng.integers(1, 10_000)) for a in case.q.atoms}):
        assert D.hypercube_shares(case.q, sizes, num_shards) == JD.hypercube_shares(
            case.jq, sizes, num_shards)


def test_hypercube_shares_memo_hands_out_copies():
    q = Query([Atom(a, vs) for a, vs in QUERIES["triangle"]])
    sizes = {"R": 12345, "S": 23456, "T": 34567}
    first = D.hypercube_shares(q, sizes, 8)
    entries = len(D._shares_cache)
    again = D.hypercube_shares(q, sizes, 8)
    assert again == first and len(D._shares_cache) == entries, "the second call hits the memo"
    again["x"] = 99
    assert D.hypercube_shares(q, sizes, 8) == first
    with pytest.raises(ValueError):
        D.hypercube_shares(q, sizes, 6)


@pytest.mark.parametrize("name", ["triangle", "four_cycle", "star"])
@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_partition_matches_reference(name, num_shards, rng):
    case = random_case(rng, name, 120, 1000)
    sizes = {a.alias: r.num_rows for a, r in zip(case.q.atoms, case.rels.values())}
    shares = D.hypercube_shares(case.q, sizes, num_shards)
    got = D.partition(case.q, case.rels, shares, num_shards)
    want = JD.partition(case.jq, case.jrels, shares, num_shards)
    assert len(got) == len(want) == num_shards
    for mine, theirs in zip(got, want):
        assert mine.keys() == theirs.keys()
        for alias in mine:
            assert mine[alias].schema == theirs[alias].schema
            for v in mine[alias].schema:
                np.testing.assert_array_equal(mine[alias].columns[v], theirs[alias].columns[v])
    # every row lands on exactly prod(shares of the vars it lacks) shards
    for a in case.q.atoms:
        fan_out = num_shards // int(np.prod([shares[v] for v in a.vars]))
        assert sum(s[a.alias].num_rows for s in got) == fan_out * case.rels[a.alias].num_rows


@pytest.mark.parametrize("empty", [False, True])
def test_pad_and_mask_match_reference(empty, rng):
    case = random_case(rng, "triangle", 90, 30)
    if empty:  # an all-pad relation: every shard's fragment is empty
        for rels, R in ((case.rels, Relation), (case.jrels, JRelation)):
            rels["S"] = R("S", {"y": np.zeros(0, np.int64), "z": np.zeros(0, np.int64)})
    shares = {"x": 2, "y": 2, "z": 2}
    dense, counts = D.pad_shards_to_dense(D.partition(case.q, case.rels, shares, 8), case.q)
    jdense, jcounts = JD.pad_shards_to_dense(JD.partition(case.jq, case.jrels, shares, 8), case.jq)
    assert dense.keys() == jdense.keys() and counts.keys() == jcounts.keys()
    for a in dense:
        np.testing.assert_array_equal(counts[a], jcounts[a])
        for v in dense[a]:
            assert dense[a][v].dtype == jdense[a][v].dtype == np.int32
            np.testing.assert_array_equal(dense[a][v], jdense[a][v])
    for s in range(8):
        masked = D._mask_pad(
            {a: {v: torch.as_tensor(arr[s]) for v, arr in c.items()} for a, c in dense.items()},
            {a: torch.as_tensor(c[s]) for a, c in counts.items()})
        jmasked = JD._mask_pad(
            {a: {v: jnp.asarray(arr[s]) for v, arr in c.items()} for a, c in jdense.items()},
            {a: jnp.asarray(c[s]) for a, c in jcounts.items()})
        for a in masked:
            for v in masked[a]:
                assert masked[a][v].dtype == torch.int32
                np.testing.assert_array_equal(masked[a][v].numpy(), np.asarray(jmasked[a][v]))
                pad = masked[a][v][int(counts[a][s]):]
                assert bool((pad < 0).all()), "pad rows carry negative sentinels"


def four_cycle_bushy(rng):
    case = random_case(rng, "four_cycle", 50, 6)
    tree, jtree = optimize(case.q, case.rels, bad=True), J.optimize(case.jq, case.jrels, bad=True)
    assert isinstance(tree, BinaryPlan) and isinstance(tree.right, BinaryPlan)
    return case, tree, jtree


@pytest.mark.parametrize("num_shards", [4, 8])
@pytest.mark.parametrize("workload_name", ["triangle", "four_cycle_bushy"])
def test_distributed_join_host_matches_reference(num_shards, workload_name, rng):
    if workload_name == "triangle":
        case, tree, jtree = random_case(rng, "triangle", 60, 8), None, None
    else:
        case, tree, jtree = four_cycle_bushy(rng)
    want_count = len(join_oracle(case.q, case.rels))
    got = D.distributed_join_host(case.q, case.rels, num_shards, tree, agg="count", device="cpu")
    assert got == JD.distributed_join_host(case.jq, case.jrels, num_shards, jtree,
                                           agg="count") == want_count
    rows = D.distributed_join_host(case.q, case.rels, num_shards, tree, device="cpu")
    jrows = JD.distributed_join_host(case.jq, case.jrels, num_shards, jtree)
    assert rows.keys() == jrows.keys() == set(case.q.head)
    for v in case.q.head:
        assert len(rows[v]) == want_count
        np.testing.assert_array_equal(rows[v], jrows[v])
    got_rows = sorted(zip(*(rows[v].tolist() for v in case.q.head)))
    assert got_rows == sorted(join_oracle(case.q, case.rels))


# ---------------------------------------------------------------------------
# the SPMD path against the reference's per-shard pipeline
# ---------------------------------------------------------------------------


@dataclass
class Replay:
    count: int
    first_needs: tuple  # (need_expand, need_compact) of the first run
    shares: dict
    cap_plan: object
    retries: int
    compiles: int


def reference_spmd(case: Case, capacities=None, *, num_shards: int, safety: float = 2.0,
                   max_retries: int = 12) -> Replay:
    """The reference's SpmdCounter without shard_map: its partition, dense
    padding and capacity plan, then per shard _mask_pad + StaticTrie(...,
    "jnp", 32) + make_executor(impl="jnp", agg="count"), the count summed
    and the needs max-reduced over shards in place of psum/pmax, and its
    host retry loop (overflows, grow_to)."""
    _, jfj = case.plans()
    sizes = {a.alias: case.jrels[a.alias].num_rows for a in case.jq.atoms}
    shares = JD.hypercube_shares(case.jq, sizes, num_shards)
    dense, counts = JD.pad_shards_to_dense(
        JD.partition(case.jq, case.jrels, shares, num_shards), case.jq)
    schedule = jcompiled._static_schedule(jfj)
    if capacities is None:
        frag = {a: next(iter(cols.values())).shape[1] for a, cols in dense.items()}
        cp = jplan_capacities(jfj, stats=JD._ShardStats(JStats(case.jrels), shares, frag),
                              schedule=schedule, safety=safety)
        cp = replace(cp, compact_to=(None,) * len(cp.capacities))
    else:
        n = len(schedule)
        cp = JCapacityPlan(capacities=tuple(int(c) for c in capacities[:n]),
                           compact_to=(None,) * n, schedule=schedule)
    tries = []
    for s in range(num_shards):
        cols = JD._mask_pad(
            {a: {v: jnp.asarray(arr[s]) for v, arr in c.items()} for a, c in dense.items()},
            {a: jnp.asarray(c[s]) for a, c in counts.items()})
        tries.append({a: jcompiled.StaticTrie(cols[a], schedule.level_ops[a], "jnp", 32)
                      for a in schedule.level_ops})
    seen, first, retries = set(), None, 0
    for _ in range(max_retries + 1):
        local = jcompiled.make_executor(jfj, cp.capacities, impl="jnp", agg="count",
                                        schedule=schedule)
        seen.add(cp.capacities)
        outs = [local(t) for t in tries]
        total = sum(int(c) for c, _, _ in outs)
        ne = np.max([np.asarray(e) for _, e, _ in outs], axis=0)
        nc = np.max([np.asarray(c) for _, _, c in outs], axis=0)
        if first is None:
            first = (ne, nc)
        oe, oc = jcompiled.overflows(cp, ne, nc)
        if not (oe.any() or oc.any()):
            return Replay(total, first, shares, cp, retries, len(seen))
        for i in np.flatnonzero(oc):
            cp = cp.grow_to(int(i), int(nc[i]), compaction=True)
        for i in np.flatnonzero(oe):
            cp = cp.grow_to(int(i), int(ne[i]))
        retries += 1
    raise AssertionError("the replay's retry loop did not settle")


def assert_matches_replay(info: dict, count: int, want: Replay):
    assert count == want.count
    assert info["shares"] == want.shares
    assert str(info["cap_plan"]) == str(want.cap_plan)
    assert info["retries"] == want.retries
    assert info["compiles"] == want.compiles


def assert_first_needs(case: Case, capacities, num_shards: int, want: Replay, **kw):
    """The port's first run, at the same initial plan, reduces to the
    replay's first needs."""
    fj, _ = case.plans()
    counter = D.SpmdCounter(case.q, case.rels, fj, capacities, num_shards=num_shards,
                            device="cpu", **kw)
    _, ne, nc = counter.run_once(counter.cap_plan)
    np.testing.assert_array_equal(ne, want.first_needs[0])
    np.testing.assert_array_equal(nc, want.first_needs[1])


@pytest.mark.parametrize("num_shards,seed", [(1, 0), (4, 0), (8, 0), (8, 1)])
def test_spmd_count_planner_capacities(num_shards, seed):
    # seed 1: the largest need is not the last shard's, so the needs must
    # be max-reduced over shards to match
    case = random_case(np.random.default_rng(seed), "triangle", 80, 10)
    want = reference_spmd(case, num_shards=num_shards)
    assert want.count == len(join_oracle(case.q, case.rels))
    assert_first_needs(case, None, num_shards, want)
    fj, _ = case.plans()
    info = {}
    got = D.spmd_count(case.q, case.rels, fj, None, num_shards=num_shards, device="cpu",
                       info=info)
    assert_matches_replay(info, got, want)
    assert info["retries"] == 0, "planner capacities should not overflow here"
    assert info["cap_plan"].schedule is not None


@pytest.mark.parametrize("num_shards", [1, 4])
def test_spmd_overflow_retry_exact_count(num_shards, rng):
    """An undersized initial plan never leaks a sentinel: the retry loop
    grows the offending node to its reported need."""
    case = random_case(rng, "triangle", 80, 10)
    want = reference_spmd(case, [16] * 4, num_shards=num_shards)
    assert want.count == free_join(case.q, case.rels, agg="count", device="cpu")
    assert_first_needs(case, [16] * 4, num_shards, want)
    fj, _ = case.plans()
    info = {}
    got = D.spmd_count(case.q, case.rels, fj, [16] * 4, num_shards=num_shards, device="cpu",
                       info=info)
    assert_matches_replay(info, got, want)
    assert info["retries"] >= 1 and max(info["cap_plan"].capacities) > 16
    assert info["retries"] <= len(info["cap_plan"].capacities)


@pytest.mark.parametrize("num_shards", [1, 4])
def test_spmd_count_empty_relation(num_shards, rng):
    case = random_case(rng, "triangle", 40, 8)
    for rels, R in ((case.rels, Relation), (case.jrels, JRelation)):
        rels["S"] = R("S", {"y": np.zeros(0, np.int64), "z": np.zeros(0, np.int64)})
    want = reference_spmd(case, num_shards=num_shards)
    assert want.count == 0
    assert_first_needs(case, None, num_shards, want)
    fj, _ = case.plans()
    info = {}
    got = D.spmd_count(case.q, case.rels, fj, None, num_shards=num_shards, device="cpu",
                       info=info)
    assert_matches_replay(info, got, want)


def test_spmd_caches_persist_across_instances(rng):
    """The partition (device fragments), the per-shard tries and the grown
    CapacityPlan persist process-wide across SpmdCounter instances over the
    very same relation objects; different relation objects re-partition."""
    case = random_case(rng, "triangle", 300, 8)
    fj, _ = case.plans()
    # a tiny safety factor undersizes the planned capacities, forcing the
    # first instance to learn (grow) the plan through the retry loop
    want = reference_spmd(case, num_shards=1, safety=1e-6)
    assert_first_needs(case, None, 1, want, safety=1e-6)
    c1 = D.SpmdCounter(case.q, case.rels, fj, None, num_shards=1, device="cpu", safety=1e-6)
    assert c1() == want.count == free_join(case.q, case.rels, agg="count", device="cpu")
    assert c1.retries == want.retries >= 1, "the undersized plan must actually grow"
    assert str(c1.cap_plan) == str(want.cap_plan) and c1.compiles == want.compiles
    c2 = D.SpmdCounter(case.q, case.rels, fj, None, num_shards=1, device="cpu", safety=1e-6)
    assert c2._dense is c1._dense, "partition must be served from the cache"
    assert c2._tries is c1._tries, "per-shard tries must be served from the cache"
    assert c2.cap_plan == c1.cap_plan, "the grown plan must persist"
    assert c2() == want.count
    assert c2.retries == 0, "a persisted plan re-learns nothing"
    rels2 = {a: Relation(a, dict(r.columns)) for a, r in case.rels.items()}
    c3 = D.SpmdCounter(case.q, rels2, fj, None, num_shards=1, device="cpu", safety=1e-6)
    assert c3._dense is not c1._dense
    assert c3._tries is not c1._tries
    assert c3() == want.count


def test_spmd_num_shards_and_group_rules(rng):
    case = random_case(rng, "triangle", 40, 8)
    fj, _ = case.plans()
    counter = D.SpmdCounter(case.q, case.rels, fj, None, device="cpu")
    assert (counter.rank, counter.world, counter.num_shards) == (0, 1, 1)
    assert counter.device == torch.device("cpu")
    before = D.COLLECTIVES
    assert counter() == len(join_oracle(case.q, case.rels))
    assert D.COLLECTIVES == before, "a world of one with no group reduces nothing"
    for bad in (0, 3):
        with pytest.raises(ValueError):
            D.SpmdCounter(case.q, case.rels, fj, None, num_shards=bad, device="cpu")
    # the entry points run on the card unless asked for the CPU
    assert D.SpmdCounter.__init__.__kwdefaults__["device"] == "cuda"
    assert D.spmd_count.__kwdefaults__["device"] == "cuda"
    assert D.distributed_join_host.__defaults__[-1] == "cuda"


def run_ranks(tmp_path, world: int, num_shards: int, seed: int, timeout: float = 120.0):
    """spawn `world` gloo ranks; each writes its records to a JSON file."""
    ctx = tmp.get_context("spawn")
    store = str(tmp_path / f"store_{world}")
    outs = [str(tmp_path / f"rank_{world}_{r}.json") for r in range(world)]
    procs = [ctx.Process(target=rank_main, args=(r, world, store, num_shards, seed, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        assert not any(p.is_alive() for p in procs), f"a rank of {world} hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def test_spmd_count_across_gloo_ranks(tmp_path):
    """2 ranks x 4 shards and 4 ranks x 2 shards give the count, capacity
    plan and retries of 1 rank x 8 shards, and every rank reads the same."""
    seed = 3
    q, rels, fj = workload(seed)
    want = spmd_records(q, rels, fj, num_shards=8)
    assert want[0]["count"] == want[1]["count"] == len(join_oracle(q, rels))
    assert want[1]["retries"] >= 1
    for world, shards_per_rank in ((2, 4), (4, 2)):
        for r, res in enumerate(run_ranks(tmp_path, world, world * shards_per_rank, seed)):
            assert res["records"] == want, f"rank {r} of {world}"
            # two all_reduce calls per run: one run per call plus each retry
            runs = sum(1 + rec["retries"] for rec in want)
            assert res["collectives"] == 2 * runs
