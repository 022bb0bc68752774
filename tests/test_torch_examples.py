"""The port's examples (examples/torch_*.py) and its last API repairs,
against the reference package, on the CPU.

The four examples run once, through chip_smoke.examples_path("cpu", ...):
the chip script's examples phase, which runs each example's main() with
--device cpu (every kernel's plain version, counted in plain calls), holds
every result against its numpy oracles and requires K1, K2 and K4 calls
during the quickstart. The phase makes no torch.cuda call on the CPU, so
nothing needs patching. Each example's result is then held against the
reference package on inputs the test builds itself, in the reference
examples' order and from their seeds:

* the quickstart's counts against the reference's eager free_join (its
  compiled path is not run here: its jit compiles take minutes on a CPU),
  the clover's rows against the reference's to_sorted_tuples;
* the analytics pipeline's kept documents against the reference's
  select_corpus_samples, its shares against the reference's
  hypercube_shares, its triangle count against join_oracle;
* torch_serve_lm.run on the reference's seeded demo-serve parameters,
  carried across, against the reference engine on the same 24 requests;
* torch_train_lm at 30 steps with --resume-demo: the resume bit for bit,
  its checkpoint in the reference's restore.
"""
import functools
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.core import free_join as r_free_join
from repro.core import relcache as r_relcache
from repro.core import to_sorted_tuples as r_sorted
from repro.core.distributed import hypercube_shares as r_shares
from repro.core.plan import BinaryPlan as RBinaryPlan
from repro.models import transformer as r_tf
from repro.relational.oracle import join_oracle
from repro.relational.relation import Relation as RRelation
from repro.relational.schema import Atom as RAtom
from repro.relational.schema import Query as RQuery
from repro.relational.schema import clover_query as r_clover_query
from repro.relational.schema import triangle_query as r_triangle_query
from repro.train import checkpoint as r_ckpt
from repro.train import optimizer as r_opt
from repro.train.data import select_corpus_samples as r_select
from repro_torch.core import ExecOptions, compiled_free_join
from repro_torch.core import api as p_api
from repro_torch.core import relcache as p_relcache
from repro_torch.models.carry import params_from_numpy, params_to_numpy
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query, triangle_query
from repro_torch.serve import DecodeServeEngine
from repro_torch.train import AdamWConfig, TrainConfig, checkpoint
from repro_torch.train.trainer import init_train_state
from tests.test_bushy_compiled import three_stage_case
from tests.test_torch_decode_serve import GAP, SyncedEngine

import chip_smoke

CPU = ExecOptions(device="cpu")


@pytest.fixture(scope="module")
def phase():
    """The examples phase on the CPU: (record, kernel counts, results)."""
    rec, _seen, total, outs = chip_smoke.examples_path("cpu", 0, lambda: None)
    return rec, total, outs


def to_port(rels: dict) -> dict:
    return {a: Relation(r.name, dict(r.columns)) for a, r in rels.items()}


# ---------------------------------------------------------------------------
# the API repairs
# ---------------------------------------------------------------------------


def triangle(n=300, dom=6):
    """tests/test_serving.py's _triangle on default_rng(0), in both packages."""
    rng = np.random.default_rng(0)
    q = r_triangle_query()
    rels = {a.alias: RRelation(a.alias, {v: rng.integers(0, dom, n) for v in a.vars})
            for a in q.atoms}
    return q, rels, triangle_query(), to_port(rels)


def test_loose_kwargs_warn_and_match_options():
    rq, rrels, q, rels = triangle()
    with pytest.warns(DeprecationWarning, match="budget"):
        c_legacy = compiled_free_join(q, rels, options=CPU, budget=16)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the options path is silent
        c_opts = compiled_free_join(q, rels, options=ExecOptions(device="cpu", budget=16))
    assert c_legacy == c_opts == r_free_join(rq, rrels, agg="count")


def test_loose_kwargs_warning_names_the_caller_and_every_kwarg():
    _rq, _rrels, q, rels = triangle()
    with pytest.warns(DeprecationWarning) as rec:
        compiled_free_join(q, rels, options=CPU, safety=3.0, compact_threshold=0.5)
    assert len(rec) == 1 and rec[0].filename == __file__
    assert "['compact_threshold', 'safety']" in str(rec[0].message)
    with pytest.warns(DeprecationWarning, match="safety"):
        opts = p_api._resolve_options(CPU, {"safety": 3.0})
    assert opts == ExecOptions(device="cpu", safety=3.0)


def test_loose_chain_stages_matches_oracle():
    """The bushy case of tests/test_bushy_compiled.py:125, chain_stages=False
    given loose: the hybrid baseline, equal to the oracle."""
    rq, tree, rrels = three_stage_case(np.random.default_rng(0))
    want = len(join_oracle(rq, rrels))
    q = Query([Atom(a.name, a.vars, a.alias) for a in rq.atoms])
    at = {a.alias: a for a in q.atoms}

    def port_tree(t):
        if isinstance(t, RBinaryPlan):
            return p_api.BinaryPlan(port_tree(t.left), port_tree(t.right))
        return at[t.alias]

    with pytest.warns(DeprecationWarning, match="chain_stages"):
        got = compiled_free_join(q, to_port(rrels), port_tree(tree), agg="count",
                                 options=CPU, chain_stages=False)
    assert got == want


@pytest.mark.parametrize("kwarg", [{"impl": "pallas"}, {"jit": False}])
def test_impl_and_jit_raise(kwarg):
    _rq, _rrels, q, rels = triangle()
    with pytest.raises(TypeError, match=r"ExecOptions\(device=\.\.\.\)"):
        compiled_free_join(q, rels, options=CPU, **kwarg)


def test_private_stage_aliases_stay_importable():
    from repro_torch.core.api import _decompose, _stage_plans
    from repro_torch.core.plan import decompose_tree, stage_plans

    assert _decompose is decompose_tree and _stage_plans is stage_plans


MUTATION_SCRIPTS = {
    # appends and deletes, the last delete compacting
    "mixed": [("append", 6), ("delete", 5), ("append", 3), ("delete", 7), ("delete", 6),
              ("append", 4), ("delete", 9), ("delete", 8), ("delete", 4)],
    # deletes that take live/total below COMPACT_RATIO, twice
    "compacts": [("delete", 12), ("append", 8), ("delete", 15), ("delete", 9),
                 ("append", 20), ("delete", 18), ("delete", 14)],
    # more log entries than MAX_LOG: the oldest versions cannot be replayed
    "prunes": [("append", 1)] * 70 + [("delete", 3)] * 4,
    # a compaction (the log starts again at its version), then pruning
    "compacts_then_prunes": [("delete", 25)] + [("append", 2), ("delete", 1)] * 36,
}


def mutation_script(rel_cls, relcache, steps):
    """`steps` appends and deletes under the default mutation state; after
    each, (version, base_version, live, total, compactions, and which
    versions deltas_since can still replay and how far)."""
    rng = np.random.default_rng(0)
    rel = rel_cls("R", {"x": rng.integers(0, 50, 40), "y": rng.integers(0, 50, 40)})
    trace = []
    for kind, n in steps:
        if kind == "append":
            st = relcache.append(rel, {"x": rng.integers(0, 50, n), "y": rng.integers(0, 50, n)})
        else:
            st = relcache.delete(rel, rng.choice(rel.num_rows, n, replace=False))
        since = [None if (d := st.deltas_since(v)) is None else [(e[0], e[1]) for e in d]
                 for v in range(st.version + 1)]
        trace.append((st.version, st.base_version, st.live, st.total, st.compactions, since))
    return trace


@pytest.mark.parametrize("script", sorted(MUTATION_SCRIPTS))
def test_mutation_state_matches_reference(script):
    """The port keeps COMPACT_RATIO and MAX_LOG as module constants (nothing
    sets the reference's per-state knobs); at those values the port's state
    compacts and prunes at the same steps as the reference's."""
    assert (p_relcache.COMPACT_RATIO, p_relcache.MAX_LOG) == (0.5, 64)
    got = mutation_script(Relation, p_relcache, MUTATION_SCRIPTS[script])
    assert got == mutation_script(RRelation, r_relcache, MUTATION_SCRIPTS[script])
    compactions, base_version = got[-1][4], got[-1][1]
    assert {"mixed": compactions == 1, "compacts": compactions == 2,
            "prunes": compactions == 0 and base_version > 0,
            "compacts_then_prunes": compactions == 1 and base_version > 1}[script]


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------


def quickstart_inputs():
    """The reference quickstart's inputs, in its order and from its seeds."""
    rng = np.random.default_rng(0)
    q = r_triangle_query()

    def tri():
        return {a.alias: RRelation(a.alias, {v: rng.integers(0, 100, 5000) for v in a.vars})
                for a in q.atoms}

    first = tri()
    n = 5000
    ar = np.arange(n, dtype=np.int64)
    clover = {
        rel: RRelation(rel, {"x": np.r_[0, np.full(n, x1), np.full(n, x2)],
                             v: np.r_[0, ar, ar + n]})
        for rel, v, x1, x2 in (("R", "a", 1, 2), ("S", "b", 2, 3), ("T", "c", 3, 1))
    }
    rng = np.random.default_rng(0)
    second = tri()
    qb = RQuery([RAtom("A", ("x", "y")), RAtom("B", ("y", "z")), RAtom("C", ("z", "w")),
                 RAtom("D", ("w", "u"))])
    chain = {a.alias: RRelation(a.alias, {v: rng.integers(0, 500, 1500) for v in a.vars})
             for a in qb.atoms}
    dense = {
        "A": RRelation("A", {"x": rng.integers(0, 1500, 1500), "y": rng.integers(0, 1500, 1500)}),
        "B": RRelation("B", {"y": rng.integers(0, 1500, 1500), "z": rng.integers(0, 12, 1500)}),
        "C": RRelation("C", {"z": rng.integers(0, 12, 1500), "w": rng.integers(0, 1500, 1500)}),
        "D": RRelation("D", {"w": rng.integers(0, 1500, 1500), "u": rng.integers(0, 1500, 1500)}),
    }
    deltas = [{"x": rng.integers(0, 200, 256), "y": rng.integers(0, 200, 256)}
              for _ in range(3)]
    return q, qb, {"triangle": first, "triangle_again": second, "clover": clover,
                   "chain": chain, "dense_chain": dense, "deltas": deltas}


@pytest.fixture(scope="module")
def quickstart(phase):
    return phase[2]["torch_quickstart"], quickstart_inputs()


def test_quickstart_inputs_are_the_reference_examples(quickstart):
    out, (_q, _qb, ref) = quickstart
    assert all(np.array_equal(ref["triangle"][a].columns[v], ref["triangle_again"][a].columns[v])
               for a in "RST" for v in ref["triangle"][a].schema)
    for section in ("triangle", "clover", "chain", "dense_chain"):
        got = out["inputs"][section]
        assert sorted(got) == sorted(ref[section])
        for a, rel in ref[section].items():
            assert sorted(got[a]) == sorted(rel.schema)
            assert all(np.array_equal(got[a][v], rel.columns[v]) for v in rel.schema)
    for got, want in zip(out["inputs"]["deltas"], ref["deltas"], strict=True):
        assert all(np.array_equal(got[v], want[v]) for v in "xy")


def test_quickstart_triangle_and_compiled_counts(quickstart):
    out, (q, _qb, ref) = quickstart
    want = r_free_join(q, ref["triangle"], agg="count")
    assert out["triangle"] == dict.fromkeys(("free join", "binary join", "generic join"), want)
    assert out["compiled"]["cold"] == want and out["compiled"]["warm"] == [want] * 3
    assert out["compiled"]["eager"] == want


def test_quickstart_clover_rows(quickstart):
    out, (_q, _qb, ref) = quickstart
    qc = r_clover_query()
    want = r_sorted(r_free_join(qc, ref["clover"]), qc.head)
    assert want == [(0, 0, 0, 0)]
    assert out["clover"] == {"free join": want, "binary join": want}


def test_quickstart_bushy_levels_and_verify(quickstart):
    out, (_q, qb, ref) = quickstart
    bushy = RBinaryPlan(RBinaryPlan(qb.atoms[0], qb.atoms[1]),
                        RBinaryPlan(qb.atoms[2], qb.atoms[3]))
    assert out["bushy"]["count"] == r_free_join(qb, ref["chain"], bushy, agg="count")
    want = r_free_join(qb, ref["dense_chain"], agg="count")
    assert out["optimize_level"] == {0: want, 2: want} and out["verified"] == want


def test_quickstart_serving_and_resilience(quickstart):
    out, (q, _qb, ref) = quickstart
    want = {c: r_free_join(q, ref["triangle"], agg="count", filters={"x": c})
            for c in (3, 17, 41, 88)}
    assert out["serving"]["counts"] == want and out["serving"]["dispatches"] == 1
    res = out["resilience"]
    assert res["counts"] == {c: want[c] for c in (3, 17)}
    assert res["faults_absorbed"] == 1 and res["fired"] == 1
    assert set(res["degraded_to"].values()) <= {"halved", "unbatched", "eager"}


def test_quickstart_streaming(quickstart):
    out, (q, _qb, ref) = quickstart
    st, rels = out["streaming"], dict(ref["triangle"])
    assert st["registered"] == r_free_join(q, rels, agg="count")
    want = []
    for delta in ref["deltas"]:
        r = rels["R"].columns
        rels["R"] = RRelation("R", {v: np.concatenate([r[v], delta[v]]) for v in "xy"})
        want.append(r_free_join(q, rels, agg="count"))
    assert st["ingests"] == want
    rels["R"] = RRelation("R", {v: c[64:] for v, c in rels["R"].columns.items()})
    assert st["deleted"] == r_free_join(q, rels, agg="count")
    assert st["builds_after_register"] == 0
    assert st["delta_merges"] >= 3 and st["tombstone_refreshes"] >= 1


def test_examples_phase_counts_kernels(phase):
    rec, total, _outs = phase
    launches = rec["torch_quickstart"]["launches"]
    assert all(launches[k] > 0 for k in ("hash_probe", "csr_expand", "radix_rank"))
    assert rec["torch_analytics_pipeline"]["launches"]["hash_probe"] > 0
    assert not any(rec["torch_serve_lm"]["launches"].values())
    assert not any(rec["torch_train_lm"]["launches"].values())
    assert total == {k: sum(rec[name]["launches"][k] for name in
                            ("torch_quickstart", "torch_analytics_pipeline", "torch_serve_lm",
                             "torch_train_lm")) for k in total}


# ---------------------------------------------------------------------------
# the analytics pipeline
# ---------------------------------------------------------------------------


def test_analytics_pipeline_matches_reference(phase):
    out = phase[2]["torch_analytics_pipeline"]
    rng = np.random.default_rng(0)
    n = 200_000
    doc = np.arange(n, dtype=np.int64)
    docs = RRelation("Docs", {"doc": doc, "shard": rng.integers(0, 64, n),
                              "lang": rng.integers(0, 30, n)})
    quality = RRelation("Quality", {"doc": doc, "score": rng.integers(0, 100, n)})
    canonical = doc.copy()
    dup = rng.random(n) < 0.2
    canonical[dup] = rng.integers(0, n, int(dup.sum()))
    dedup = RRelation("Dedup", {"doc": doc, "canonical": canonical})
    np.testing.assert_array_equal(out["kept"], r_select(docs, quality, dedup, min_quality=60))
    knows = RRelation("knows", {"a": rng.integers(0, 8000, 60_000),
                                "b": rng.integers(0, 8000, 60_000)})
    assert all(np.array_equal(out["relations"]["knows"].columns[v], knows.columns[v])
               for v in "ab")
    q = RQuery([RAtom("knows", ("a", "b"), "K1"), RAtom("knows", ("b", "c"), "K2"),
                RAtom("knows", ("c", "a"), "K3")])
    rels = {"K1": knows, "K2": knows.rename({"a": "b", "b": "c"}),
            "K3": knows.rename({"a": "c", "b": "a"})}
    assert out["shares"] == r_shares(q, {k: 60_000 for k in rels}, 8)
    assert out["triangles"] == len(join_oracle(q, rels))
    assert out["batch_shapes"] == {"inputs": (8, 64), "labels": (8, 64)}


# ---------------------------------------------------------------------------
# torch_serve_lm
# ---------------------------------------------------------------------------


def test_serve_lm_matches_reference_engine(phase, monkeypatch):
    mod = chip_smoke.load_example("torch_serve_lm")
    kw = {f: getattr(mod.CFG, f) for f in ("name", "num_layers", "d_model", "num_heads",
                                           "num_kv_heads", "d_ff", "vocab", "compute_dtype",
                                           "remat")}
    r_cfg = r_tf.ModelConfig(**kw)
    r_params = r_tf.init_params(jax.random.PRNGKey(7), r_cfg)
    r_eng = SyncedEngine(r_params, r_cfg, slots=8, max_len=256)
    r_reqs = mod.requests(r_cfg)
    for r in r_reqs:
        r_eng.submit(r)
    r_eng.run()

    gaps = {}  # (rid, position in out) -> the emitted token's top-2 gap

    def on_emit(req, pos, logits):
        top2 = torch.topk(logits, 2).values
        gaps[req.rid, len(req.out) - 1] = float(top2[0] - top2[1])

    monkeypatch.setattr(mod, "DecodeServeEngine",
                        functools.partial(DecodeServeEngine, on_emit=on_emit))
    p_params = params_from_numpy(jax.tree.map(np.asarray, r_params), mod.CFG, "cpu")
    out = mod.run(p_params, mod.CFG, "cpu")
    assert out["steps"] == r_eng.steps
    assert out["free_pages"] == len(r_eng.pages.free) == out["num_pages"]
    assert out["done"] == 24 and out["new_tokens"] == 24 * 32
    # tokens equal up to each request's first near-tie: a top-2 gap at or
    # under GAP, where rounding may pick either token and the rest of that
    # request may follow it (two of the 768 tokens here)
    ties = 0
    for rid, (got, want) in enumerate(zip(out["tokens"], [r.out for r in r_reqs],
                                          strict=True)):
        cut = next((i for i in range(32) if gaps[rid, i] <= GAP), 32)
        ties += cut < 32
        assert len(got) == len(want) == 32 and got[:cut] == want[:cut]
    assert ties <= 3
    # the phase's own run, on the port's seeded parameters, served all
    assert phase[0]["torch_serve_lm"]["counts"]["free_pages"] == out["num_pages"]


# ---------------------------------------------------------------------------
# torch_train_lm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    out = chip_smoke.load_example("torch_train_lm").main(
        ["--device", "cpu", "--steps", "30", "--resume-demo", "--ckpt-dir", str(d)])
    return out, str(d)


def test_train_lm_losses_fall_and_resume_is_exact(trained):
    out, d = trained
    losses = np.asarray(out["losses"])
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean()
    assert out["resume"] == {"at_step": 16, "restored_step": 16, "bit_exact": True}
    assert checkpoint.latest_step(d) == 16


def test_train_lm_checkpoint_restores_in_reference(trained):
    out, d = trained
    mod = chip_smoke.load_example("torch_train_lm")
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=30, total_steps=30))
    # the port's own restore into a fresh state
    params, opt = init_train_state(mod.CFG, tcfg, seed=3, device="cpu")
    checkpoint.restore(d, 16, {"params": params, "opt": opt}, mod.CFG)
    kw = {f: getattr(mod.CFG, f) for f in ("name", "num_layers", "d_model", "num_heads",
                                           "num_kv_heads", "d_ff", "vocab", "compute_dtype",
                                           "remat")}
    r_cfg = r_tf.ModelConfig(**kw)
    like_p = jax.eval_shape(lambda: r_tf.init_params(jax.random.PRNGKey(0), r_cfg))
    like_o = jax.eval_shape(lambda: r_opt.init_state(r_opt.AdamWConfig(), like_p))
    restored = r_ckpt.restore(d, 16, {"params": like_p, "opt": like_o})
    assert int(restored["opt"]["step"]) == int(opt["step"]) == 16
    for got, want in ((restored["params"], params), (restored["opt"]["m"], opt["m"]),
                      (restored["opt"]["v"], opt["v"])):
        want = params_to_numpy(want, mod.CFG)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(np.asarray(a), b)


def test_train_lm_phase_learned(phase):
    rec = phase[0]["torch_train_lm"]["counts"]
    assert rec["verdict"] == "LEARNED" and rec["steps"] == 150
    assert rec["resume"] == {"at_step": 76, "restored_step": 76, "bit_exact": True}


def test_examples_want_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the examples run on it")
    for name in ("torch_quickstart", "torch_analytics_pipeline", "torch_serve_lm",
                 "torch_train_lm"):
        with pytest.raises((RuntimeError, AssertionError)):
            chip_smoke.load_example(name).main([])
