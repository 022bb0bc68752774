"""The compiled executor's key blocks (core/compiled._KeyBlock): each probe
hands K1 its group ids and keys as a column-major view of one block, and
the gathers that make a frontier write each probe key where K1 reads it.
TRACE.key_cols_in_place and key_cols_copied count the columns K1 read,
each weighted by its rows: a copy only where a key was not made at the
probe's node (a tile's view of its relation, a seeded lane's constant).

On the CPU (every kernel's plain version): q1 on GAP's urand graph and
on its hub-skewed kron graph (a lane-choice node and tiles), counted
against the JAX reference and the benchmark's plain triangle count, the
counters against a hand count; the eager and tuple engines, whose
probes stack their columns into one (K, Q) block, against the reference.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from perfbench import reference_triangles
from perfbench.datasets import gap_kron, gap_urand
from perfbench.harness import manifest
from perfbench.harness.record import Record
from repro_torch.core import api, capacity, compiled, membudget
from repro_torch.core.api import ExecOptions, compiled_free_join, free_join
from repro_torch.core.compiled import _KeyBlock, make_executor
from repro_torch.core.plan import binary2fj, factor, seed_plan
from repro_torch.core.trace import TRACE
from repro_torch.core.tuple_engine import execute_tuples
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query
from repro.core.tuple_engine import execute_tuples as jexecute_tuples
from repro.relational.relation import Relation as JRelation
from repro.relational.schema import Atom as JAtom
from repro.relational.schema import Query as JQuery

from perfbench.tests.conftest import ROOT

CPU = ExecOptions(device="cpu")
ATOMS = [("knows", ("a", "b")), ("knows", ("b", "c")), ("knows", ("c", "a"))]
Q1 = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2"),
            Atom("knows", ("c", "a"), "K3")])
KRON = {"degree": 16, "initiator": {"A": 0.57, "B": 0.19, "C": 0.19, "D": 0.05},
        "structure_seed": 0}


def graph(kind: str, scale: int, seed: int = 7) -> dict:
    if kind == "kron":
        return gap_kron.generate({**KRON, "scale": scale}, seed)["knows"]
    return gap_urand.generate({"scale": scale, "degree": 16, "structure_seed": 0}, seed)["knows"]


JQ1 = JQuery([JAtom(t, vs, f"K{i + 1}") for i, (t, vs) in enumerate(ATOMS)])


def views(cols: dict, rel=Relation) -> dict:
    """q1's three views of one edge table, as the benchmark's Port makes them."""
    a, b = cols["a"], cols["b"]
    return {"K1": rel("knows", {"a": a, "b": b}), "K2": rel("knows", {"b": a, "c": b}),
            "K3": rel("knows", {"c": a, "a": b})}


def counted(fn, *args, **kwargs):
    """fn's result and the key columns (in place, copied) it handed K1."""
    before = TRACE.key_cols_in_place, TRACE.key_cols_copied
    out = fn(*args, **kwargs)
    return out, TRACE.key_cols_in_place - before[0], TRACE.key_cols_copied - before[1]


def test_key_block_views_are_column_major():
    """Probe j's view is columns [at[j], at[j] + width) of one column-major
    block; a var two probes read gets the first probe's column as its
    destination, and the second probe's column is its own."""
    plan = factor(binary2fj(Q1.atoms, Q1))
    probes = plan.nodes[1][1:] + plan.nodes[0][1:]  # K3(c,a), then K2(b)
    kb = _KeyBlock(probes, 11, "cpu")
    assert kb.q.shape == (11, 5) and kb.q.stride() == (1, 11) and kb.at == [0, 3]
    assert kb.query(0, 3).shape == (11, 3) and kb.query(1, 2).stride() == (1, 11)
    assert set(kb.dest) == {"c", "a", "b"}
    assert kb.dest["c"].data_ptr() == kb.cols[1].data_ptr()
    assert kb.dest["b"].data_ptr() == kb.cols[4].data_ptr()
    twice = _KeyBlock([probes[0], probes[0]], 5, "cpu")
    assert twice.dest["a"].data_ptr() == twice.cols[2].data_ptr()  # the first probe's


@pytest.mark.parametrize("scale", [6, 8])
def test_urand_q1_reads_every_key_in_place(scale):
    """q1's plan [[K1(a,b), K2(b)], [K2(c), K3(c,a)], [K3()]] at its needs:
    node 0 hands K1 (group id, b) over its rows, node 1 (group id, c, a)
    over its two-paths, all written by the gathers: nothing copied. The
    count is the reference's, and the compiled path's too."""
    cols = graph("urand", scale)
    rels = views(cols)
    plan = factor(binary2fj(Q1.atoms, Q1))
    assert str(plan) == "[[K1(a,b), K2(b)], [K2(c), K3(c,a)], [K3()]]"
    data = compiled.relations_to_cols(plan, rels, "cpu")
    n, deg = len(cols["a"]), np.bincount(cols["a"])
    caps = (n, int((deg.astype(np.int64) ** 2).sum()), 1)  # the rows, the two-paths
    (count, *_rest, ne, _nc), in_place, copied = counted(make_executor(plan, caps), data)
    assert [int(x) for x in ne[:2]] == list(caps[:2])
    want = reference_triangles.count(ATOMS, {"knows": cols})
    assert int(count) == want
    assert (in_place, copied) == (2 * caps[0] + 3 * caps[1], 0)
    (got, in_place, copied) = counted(compiled_free_join, Q1, rels, options=CPU)
    assert got == want and copied == 0 and in_place > 0
    assert got == int(J.free_join(JQ1, views(cols, JRelation), agg="count"))


def test_kron_q1_tiles_copy_only_the_tile_views(monkeypatch):
    """q1 on kron takes the lane-choice plan [[K1(a,b), K2(b), K3(a)],
    {K2(c), K3(c)}, [K3()]]. In 3 tiles, node 0's probes K2(b) and K3(a)
    read b and a from the tile's view of K1's rows: copied, 2 columns over
    the rows; their group ids in place. Node 1 runs each cover's lanes,
    each probing the other cover with (group id, c), both written by the
    cover's expansion: 2 columns x 2 covers x its capacity a tile, in
    place. Counts are the reference's, tiled or not, and the compiled
    path's under a budget that tiles it copies the same 2 columns a row."""
    cols = graph("kron", 8)
    rels = views(cols)
    want = reference_triangles.count(ATOMS, {"knows": cols})
    info = {}
    assert compiled_free_join(Q1, rels, options=CPU, info=info) == want
    plan = info["runner"].plan
    assert plan.lane_choice == (1,) and str(plan).startswith(
        "[[K1(a,b), K2(b), K3(a)], {K2(c), K3(c)}")
    data = compiled.relations_to_cols(plan, rels, "cpu")
    n, deg = len(cols["a"]), np.bincount(cols["a"])
    *_c, ne, _nc = make_executor(plan, (n, int((deg.astype(np.int64) ** 2).sum()), 1),
                                 tiles=3)(data)
    caps = (n, int(ne[1]), 1)  # a cover's largest need over the tiles
    (count, *_rest), in_place, copied = counted(make_executor(plan, caps, tiles=3), data)
    assert int(count) == want
    assert (in_place, copied) == (2 * n + 3 * 2 * 2 * caps[1], 2 * n)
    # the compiled path, tiled under a memory budget
    monkeypatch.setattr(capacity, "TILE_MIN_LANES", 1)
    runner, *_rest = api._acquire_runner(Q1, rels, None, agg="count", options=CPU)
    est = max(e.expand for e in runner.cap_plan.estimates)
    rels = views(cols)  # new relation objects: a runner planned under the budget
    with membudget.budget(int(est / 3) * capacity.LANE_BYTES + capacity.LANE_BYTES):
        got = compiled_free_join(Q1, rels, options=CPU, info=info)
        assert info["cap_plan"].tiles == 3
        (warm, in_place, copied) = counted(compiled_free_join, Q1, rels, options=CPU, info=info)
    assert got == warm == want
    assert copied == 2 * n and in_place > 2 * n


def test_seeded_lanes_copy_their_constants():
    """The served point query fof on seeded lanes: its seed node probes
    K1(a) from the lanes' constants, copied into the key block, one column
    a lane; node 1 expands K1(b) and probes K2(b), its key written by the
    expansion. Each lane's count is its constant's two-hop count."""
    cols = graph("urand", 6)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)  # noqa: E731
    data = {"K1": {"a": t(cols["a"]), "b": t(cols["b"])},
            "K2": {"b": t(cols["a"]), "c": t(cols["b"])}}
    fof = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2")])
    plan = seed_plan(factor(binary2fj(fof.atoms, fof)), ("a",))
    assert str(plan) == "seeded [[K1(a)], [K1(b), K2(b)], [K2(c)]]"
    consts = np.unique(cols["a"])[:5, None].astype(np.int32)
    lanes, deg = len(consts), np.bincount(cols["a"])
    need = int(deg[consts[:, 0]].sum())  # the lanes' one-hop rows
    fn = make_executor(plan, (lanes, need, 1), filters=(("a", 0),))
    (got, ne, _nc), in_place, copied = counted(fn, data, None, t(consts))
    assert int(ne[0, 1]) == need
    assert (in_place, copied) == (lanes + 2 * need, lanes)
    assert got.tolist() == [int(deg[cols["b"][cols["a"] == c]].sum()) for c in consts[:, 0]]


@pytest.mark.parametrize("mode", ["colt", "slt", "simple"])
def test_eager_and_tuple_engines_unchanged(mode):
    """The eager engines' probes stack their key columns into one (K, Q)
    block, read column-major: free_join's count in each trie mode and
    execute_tuples' rows equal the reference's."""
    cols = graph("urand", 5)
    want = J.free_join(JQ1, views(cols, JRelation), agg="count", mode=mode)
    assert free_join(Q1, views(cols), agg="count", mode=mode, device="cpu") == want
    fj = factor(binary2fj(Q1.atoms, Q1))
    jfj = J.factor(J.binary2fj(JQ1.atoms, JQ1))
    got = execute_tuples(fj, views(cols), mode=mode, batch_size=64, device="cpu")
    assert sorted(got) == sorted(jexecute_tuples(jfj, views(cols, JRelation), mode=mode,
                                                 batch_size=64))
    assert len(got) == want


def test_key_copy_share_reads_the_counters():
    """exec.key_copy_share: copied over all the key columns; nothing on a
    program without the counters (both read 0)."""
    reader = manifest.load(ROOT, "urand18-q1-warm").reader("exec.key_copy_share")
    assert set(reader.COUNTERS) == {"trace_key_cols_in_place", "trace_key_cols_copied"}
    run = Record(completed=2, counters={"trace_key_cols_in_place": 300,
                                        "trace_key_cols_copied": 100})
    assert reader.read(run) == 0.25
    assert reader.read(Record(completed=2, counters=dict.fromkeys(reader.COUNTERS, 0))) is None
    assert "exec.key_copy_share" in {m["name"] for m in manifest.load(
        ROOT, "kron18-q1-warm").per_layer}
