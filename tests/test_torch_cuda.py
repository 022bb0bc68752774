"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Marked `cuda`: these tests need an NVIDIA GPU with nvcc, and skip without
one. Run them on the card with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Every output is an integer, so every comparison is exact. The file
imports no JAX, so it runs where only PyTorch is installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import TRIE_CACHE, ExecOptions, compiled_free_join, relcache
from repro_torch.core.compiled import _LevelOps, device_columns
from repro_torch.kernels import compact, csr_expand, hash_probe, intersect, ops, radix_sort
from repro_torch.relational.datagen import lowsel_star
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import triangle_query

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(device, a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def assert_kernel_matches_plain(module, name, *args):
    launches = module.launches
    got = getattr(module, name)(*args)
    assert module.launches == launches + 1, "one launch per wrapper call on the card"
    want = getattr(module, f"{name}_plain")(*args)
    torch.cuda.synchronize()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,k,q", [(1, 1, 5), (300, 3, 700), (3000, 2, 1033), (200_000, 2, 300_001)])
def test_hash_probe_kernel(cuda, n, k, q, rng):
    keys = np.unique(rng.integers(0, 1 << 24, (2 * n + 1, k)), axis=0)[:n]
    table = ops.build_table(on(cuda, keys))
    hits = keys[rng.integers(0, n, q // 2)]
    qs = np.vstack([hits, rng.integers(-1, 1 << 24, (q - q // 2, k))])
    assert_kernel_matches_plain(hash_probe, "hash_probe", table.slots, table.keys, on(cuda, qs), 32)
    dead = on(cuda, np.full((q, k), -1))
    assert_kernel_matches_plain(hash_probe, "hash_probe", table.slots, table.keys, dead, 32)


# fan-outs a tiled merge gets wrong (the kernel merges 2,304 items a block)
def shaped_counts(rng, shape):
    counts = rng.integers(0, 7, 60_000)
    if shape == "hub":  # one row over 100,000 slots
        counts[31_337] = 100_000
    else:  # "zero_run": 50,000 zero-count rows in a row
        counts[5_000:55_000] = 0
    return counts


@pytest.mark.parametrize("f,cap", [(1, 1029), (777, 1500), (100_000, 1 << 20),
                                   ("hub", 300_001), ("hub", 200_000), ("zero_run", 40_000),
                                   (1, 3)])
@pytest.mark.parametrize("total_zero", [False, True])
def test_csr_expand_kernel(cuda, f, cap, total_zero, rng):
    counts = shaped_counts(rng, f) if isinstance(f, str) else rng.integers(0, 7, f)
    f = len(counts)
    cum = np.cumsum(counts)
    total = 0 if total_zero else int(cum[-1])
    assert_kernel_matches_plain(csr_expand, "csr_expand", on(cuda, cum - counts),
                                on(cuda, rng.integers(0, 1 << 20, f)), on(cuda, [total]), cap)


@pytest.mark.parametrize("n,cap,p", [(1, 3, 1.0), (513, 1024, 0.0), (3001, 1011, 0.3),
                                     (1 << 20, 1 << 19, 0.4), (1 << 20, 100_003, 0.4),
                                     ("invalid_run", 9_000, 0.5), (1, 3, 0.0)])
def test_compact_kernel(cuda, n, cap, p, rng):
    if n == "invalid_run":  # 50,000 dead lanes in a row
        valid = rng.random(60_000) < p
        valid[5_000:55_000] = False
    else:
        valid = rng.random(n) < p
    csum = np.cumsum(valid)
    assert_kernel_matches_plain(compact, "compact", on(cuda, csum), on(cuda, [int(csum[-1])]), cap)


@pytest.mark.parametrize("n", [1, 1013, 1 << 20])
def test_radix_rank_kernel(cuda, n, rng):
    digit = rng.integers(0, radix_sort.RADIX, n)
    csum = np.cumsum(np.arange(radix_sort.RADIX)[:, None] == digit[None, :], axis=1)
    kd = rng.integers(0, radix_sort.RADIX, n)
    kt = rng.integers(0, n // radix_sort.RADIX + 3, n)
    assert_kernel_matches_plain(radix_sort, "radix_rank", on(cuda, csum), on(cuda, kd), on(cuda, kt))


def test_segmented_sort_on_card(cuda, rng):
    cols = [rng.integers(0, 300, 100_000), rng.integers(0, 70_000, 100_000)]
    got = radix_sort.segmented_sort([on(cuda, c) for c in cols], (9, 17))
    np.testing.assert_array_equal(got.cpu().numpy(), np.lexsort(tuple(reversed(cols))))


@pytest.mark.parametrize("agg", ["count", None])
def test_slice_on_card_matches_cpu(cuda, agg, rng):
    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 40, 3000) for v in a.vars})
            for a in q.atoms}
    sq, srels = lowsel_star(n=50_000, dom=5_000, sel=0.02, seed=3)
    for query, relations in ((q, rels), (sq, srels)):
        before = (hash_probe.launches, csr_expand.launches, compact.launches)
        got = compiled_free_join(query, relations, agg=agg, options=ExecOptions(device="cuda"))
        want = compiled_free_join(query, relations, agg=agg, options=ExecOptions(device="cpu"))
        after = (hash_probe.launches, csr_expand.launches, compact.launches)
        assert all(x > y for x, y in zip(after[:2], before[:2]))
        if agg == "count":
            assert got == want
        else:
            for v in query.head:
                np.testing.assert_array_equal(got[0][v], want[0][v])
            np.testing.assert_array_equal(got[1], want[1])


I32_MIN, I32_MAX = -(2**31), 2**31 - 1
# K5's bucket directory: the cases it could get wrong
INTERSECT_HARD = ("full_span", "n1", "n2", "dense_outlier", "contiguous", "at_ends", "q1",
                  "ragged")


def intersect_hard_case(name, rng):
    """(a, b) int32 numpy arrays: b over the whole int32 range (its span,
    b[N-1] - b[0], is 2^32 - 1), N = 1 (span 0) and N = 2, a dense run of
    50,000 keys with one outlier at 2^31 - 1 (nearly every key in one
    bucket), 300,000 consecutive keys (every bucket full, 32 keys, most
    across two warps of the pre-pass), queries equal to b[0] and b[N-1],
    Q = 1, and a Q of 4,099 (a multiple of no tile)."""
    keys = np.unique(rng.integers(0, 300_000, 40_000))
    if name == "full_span":
        b = np.unique(np.concatenate([[I32_MIN, I32_MAX], rng.integers(I32_MIN, I32_MAX, 3000)]))
        a = np.concatenate([b[rng.integers(0, len(b), 500)], rng.integers(I32_MIN, I32_MAX, 500),
                            [I32_MIN, I32_MAX, 0, -1]])
    elif name == "n1":
        a, b = [7, 3, -1, 8, I32_MAX, I32_MIN], [7]
    elif name == "n2":
        a, b = [I32_MIN, I32_MAX, 0, -5, I32_MIN + 1, I32_MAX - 1], [I32_MIN, I32_MAX]
    elif name == "dense_outlier":
        b = np.append(np.arange(1000, 51_000), I32_MAX)
        a = np.concatenate([rng.integers(0, 60_000, 3000), [I32_MAX, I32_MAX - 1, 1000, 50_999,
                                                             51_000]])
    elif name == "contiguous":
        b = np.arange(17, 300_017)
        a = np.concatenate([rng.integers(0, 300_100, 3000), [16, 17, 300_016, 300_017]])
    elif name == "at_ends":
        b = keys
        a = [b[0], b[-1], b[0] - 1, b[-1] + 1, b[-1], b[0]]
    elif name == "q1":
        b, a = keys, keys[[17]]
    else:  # ragged
        b = keys
        a = np.concatenate([b[rng.integers(0, len(b), 2050)], rng.integers(-5, 300_005, 2049)])
    return np.asarray(a, np.int32), np.asarray(b, np.int32)


@pytest.mark.parametrize("m,n", [(1, 1), (1025, 500), (300_001, 300_100)])
def test_intersect_kernel(cuda, m, n, rng):
    b = np.unique(rng.integers(0, 1 << 22, 2 * n))[:n]
    a = np.concatenate([b[rng.integers(0, n, m // 2)],
                        rng.integers(-5, (1 << 22) + 5, m - m // 2)])
    assert_kernel_matches_plain(intersect, "intersect", on(cuda, a), on(cuda, b))
    got = ops.intersect_sorted(on(cuda, a), on(cuda, b))
    want = ops.intersect_sorted(on("cpu", a), on("cpu", b))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("name", INTERSECT_HARD)
def test_intersect_kernel_hard_cases(cuda, name, rng):
    """The bucket directory's hard cases: kernel against its plain version
    and numpy's searchsorted, exactly."""
    a, b = intersect_hard_case(name, rng)
    assert_kernel_matches_plain(intersect, "intersect", on(cuda, a), on(cuda, b))
    mask, pos = intersect.intersect(on(cuda, a), on(cuda, b))
    want = np.searchsorted(b, a)
    hit = (want < len(b)) & (b[np.minimum(want, len(b) - 1)] == a)
    np.testing.assert_array_equal(mask.cpu().numpy(), hit)
    np.testing.assert_array_equal(pos.cpu().numpy(), np.where(hit, want, -1))


def test_lex_searchsorted_on_card(cuda, rng):
    rows = rng.integers(0, 50, (20_000, 2))
    rows = rows[np.lexsort(rows.T[::-1])]
    qs = rng.integers(-1, 52, (7_000, 2))
    got = radix_sort.lex_searchsorted([on(cuda, rows[:, 0]), on(cuda, rows[:, 1])],
                                      [on(cuda, qs[:, 0]), on(cuda, qs[:, 1])])
    want = radix_sort.lex_searchsorted([on("cpu", rows[:, 0]), on("cpu", rows[:, 1])],
                                       [on("cpu", qs[:, 0]), on("cpu", qs[:, 1])])
    assert torch.equal(got.cpu(), want)


def test_delta_merge_and_retire_on_card_match_cpu(cuda, rng):
    """One append (a delta merge) and one delete (a tombstone refresh) on
    the card give the same trie arrays as on the CPU."""
    lops = _LevelOps((("x",), ("y",)), (True, True))
    cols = {"x": rng.integers(0, 300, 50_000), "y": rng.integers(0, 900, 50_000)}
    rels = {d: Relation("R", {v: c.copy() for v, c in cols.items()}) for d in ("cuda", "cpu")}
    tries = {}
    for dev, rel in rels.items():
        TRIE_CACHE.get(rel, device_columns(rel, dev), lops)
    d1 = {v: rng.integers(0, 1000, 4_096).astype(np.int32) for v in cols}
    gone = rng.choice(50_000, 3_000, replace=False)
    for mutate, counter in ((lambda r: relcache.append(r, d1), "delta_merges"),
                            (lambda r: relcache.delete(r, gone), "tombstone_refreshes")):
        for dev, rel in rels.items():
            mutate(rel)
            before = (TRIE_CACHE.builds, getattr(TRIE_CACHE, counter))
            tries[dev] = TRIE_CACHE.get(rel, device_columns(rel, dev), lops)
            assert (TRIE_CACHE.builds, getattr(TRIE_CACHE, counter)) == (before[0], before[1] + 1)
        torch.cuda.synchronize()
        gpu, cpu = tries["cuda"], tries["cpu"]
        for name in ("order", "mult_col", "total_mult"):
            assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
        for name in ("g", "kpos", "row_count", "row_weight"):
            for g, c in zip(getattr(gpu, name), getattr(cpu, name)):
                assert torch.equal(g.cpu(), c), name
        for g, c in zip(gpu.tables, cpu.tables):
            assert torch.equal(g.slots.cpu(), c.slots)


ENGINES = ("free_join", "binary_join", "generic_join")


@pytest.mark.parametrize("engine", ENGINES)
def test_eager_engine_on_card_matches_cpu(cuda, engine, rng):
    """The eager engines on the card give the CPU's (bound, mult), element
    for element, and the count; each of K1-K4 launches on the way."""
    from repro_torch import core

    run = getattr(core, engine)
    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 60, 5000) for v in a.vars})
            for a in q.atoms}
    sq, srels = lowsel_star(n=50_000, dom=5_000, sel=0.02, seed=3)
    mods = (hash_probe, csr_expand, compact, radix_sort)
    for query, relations in ((q, rels), (sq, srels)):
        before = [m.launches for m in mods]
        got = run(query, relations, device="cuda")
        launched = [m.launches - b for m, b in zip(mods, before)]
        want = run(query, relations, device="cpu")
        assert set(got[0]) == set(want[0])
        for v in want[0]:
            np.testing.assert_array_equal(got[0][v], want[0][v])
        np.testing.assert_array_equal(got[1], want[1])
        assert run(query, relations, agg="count", device="cuda") == int(want[1].sum())
        assert all(n > 0 for n in launched[:2]), launched
        if query is q:
            assert all(n > 0 for n in launched), f"K1-K4 launches {launched}"


def test_hybrid_baseline_on_card_matches_cpu(cuda, rng):
    from repro_torch.core.plan import BinaryPlan
    from repro_torch.relational.schema import Atom, Query

    q = Query([Atom("A", ("x", "y")), Atom("B", ("y", "z")), Atom("C", ("z", "w")),
               Atom("D", ("w", "u"))])
    tree = BinaryPlan(BinaryPlan(q.atoms[0], q.atoms[1]), BinaryPlan(q.atoms[2], q.atoms[3]))
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 300, 4000) for v in a.vars})
            for a in q.atoms}
    got = compiled_free_join(q, rels, tree, options=ExecOptions(device="cuda",
                                                                chain_stages=False))
    assert got == compiled_free_join(q, rels, tree, options=ExecOptions(device="cpu",
                                                                        chain_stages=False))
    assert got == compiled_free_join(q, rels, tree, options=ExecOptions(device="cuda"))


def _batched_pair(device, rels, q, batch):
    """An unfiltered runner and a batched mask-mode runner over the triangle
    on `device`, the batch filtering on the plan's first bound variable (so
    both runners have the same schedule), each warmed by one call."""
    from repro_torch.core import api

    opts = ExecOptions(device=device)
    plain, *_ = api._acquire_runner(q, rels, None, agg="count", options=opts)
    plain.run_relations(rels)
    var = plain.schedule.entries[0][1].vars[0]
    batched, *_ = api._acquire_runner(q, rels, None, agg="count", options=opts,
                                      filter_vars=(var,), batch=batch)
    consts = np.arange(batch, dtype=np.int32)[:, None] * 7
    batched.run_relations(rels, filter_consts=consts)
    return plain, batched, var, consts


def test_batched_dispatch_on_card_equals_kill_mode_calls(cuda, rng):
    """One mask-mode dispatch of 8 lanes on the card equals 8 kill-mode
    calls on the card and the same dispatch on the CPU; a JoinServeEngine
    drain on the card equals one on the CPU, agg=None included."""
    from repro_torch.serve import JoinServeEngine

    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 60, 5000) for v in a.vars})
            for a in q.atoms}
    _plain, batched, var, consts = _batched_pair("cuda", rels, q, 8)
    got = batched.run_relations(rels, filter_consts=consts)
    want = [compiled_free_join(q, rels, filters={var: int(c)}, options=ExecOptions(device="cuda"))
            for c in consts[:, 0]]
    assert got.tolist() == want
    _p, cpu_batched, _v, _c = _batched_pair("cpu", rels, q, 8)
    assert cpu_batched.run_relations(rels, filter_consts=consts).tolist() == want
    results = {}
    for device in ("cuda", "cpu"):
        eng = JoinServeEngine(slots=4, options=ExecOptions(device=device))
        reqs = [eng.submit(q, rels, {"x": c}, agg=agg) for agg in ("count", None)
                for c in (1, 5, 9, 5, 30)]
        eng.run()
        assert all(r.error is None and r.degraded_to is None for r in reqs)
        results[device] = [r.result if isinstance(r.result, int) else
                           (sorted(zip(*(r.result[0][v].tolist() for v in q.head))),
                            sorted(r.result[1].tolist())) for r in reqs]
    assert results["cuda"] == results["cpu"]


def test_mask_path_launches_like_one_unfiltered_call(cuda, rng):
    """The batched dispatch runs the probe pipeline once for all lanes: as
    many K1, K2 and K3 launches as one warm unfiltered call, and no K4."""
    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 60, 5000) for v in a.vars})
            for a in q.atoms}
    plain, batched, _var, consts = _batched_pair("cuda", rels, q, 16)
    mods = (hash_probe, csr_expand, compact, radix_sort)

    def launches(fn):
        before = [m.launches for m in mods]
        fn()
        return [m.launches - b for m, b in zip(mods, before)]

    one = launches(lambda: plain.run_relations(rels))
    many = launches(lambda: batched.run_relations(rels, filter_consts=consts))
    assert many == one and one[1] > 0 and one[3] == 0, (one, many)


def sync_debug_count(fn) -> int:
    """Host synchronizations `fn` makes, as torch.cuda.set_sync_debug_mode
    ("warn") reports them (its one-time prototype notice is not one)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


@pytest.mark.parametrize("name", ["star", "bushy", "star-filtered", "star-batched"])
def test_audit_syncs_equal_sync_debug_mode(cuda, name):
    """The launch audit's host syncs of a warm corpus call are the ones
    the card's sync debug mode counts, and the call audits clean with K1
    launched once per probe."""
    from repro_torch.analysis import corpus, launch_audit

    case = {c.name: c for c in corpus.corpus_cases()}[name]
    runner, rels = corpus.build_runner(case, device="cuda")
    runner.run_relations(rels, filter_consts=case.filter_consts)
    box = []
    n = sync_debug_count(lambda: box.append(
        launch_audit.trace_runner(runner, rels, filter_consts=case.filter_consts)))
    trace = box[0]
    assert trace.syncs == n, trace.sync_sites
    rep = launch_audit.audit_runner(runner, rels, trace=trace)
    assert rep.rules() <= {"small-uploads"}, str(rep)
    limits = launch_audit.runner_limits(runner)
    assert trace.launches["hash_probe"] == trace.kernel_calls["hash_probe"] == limits["probes"]


def test_verify_and_count_query_on_card(cuda, rng):
    from repro_torch.core.compiled import count_query
    from repro_torch.core.plan import binary2fj, factor

    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, 40, 3000) for v in a.vars})
            for a in q.atoms}
    got = compiled_free_join(q, rels, options=ExecOptions(device="cuda", verify=True))
    assert got == compiled_free_join(q, rels, options=ExecOptions(device="cpu"))
    fj = factor(binary2fj(q.atoms, q))
    assert count_query(fj, rels, [1 << 20] * 3) == (got, False)
    assert count_query(fj, rels, [4] * 3)[1] is True
