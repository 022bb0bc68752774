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
from repro_torch.kernels import (_build, compact, csr_expand, hash_probe, intersect, ops,
                                 radix_sort, ref, seg_scan)
from repro_torch.relational.datagen import lowsel_star
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import triangle_query

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(device, a) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def assert_kernel_matches_plain(module, name, *args):
    launches = getattr(module, _build.counter(name))
    got = getattr(module, name)(*args)
    assert getattr(module, _build.counter(name)) == launches + 1, \
        "one launch per wrapper call on the card"
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


def k1_layout_cases(*calls):
    """(k, offset, [call,] layout) over K1's query layouts
    (chip_smoke.K1_LAYOUTS); the row-major cases keep the ids they had
    before the layout was a parameter."""
    return [pytest.param(k, offset, *call, layout,
                         id="-".join(map(str, (k, offset, *call)))
                         + ("" if layout == "rows" else f"-{layout}"))
            for layout in chip_smoke.K1_LAYOUTS for call in ([(c,) for c in calls] or [()])
            for offset in (0, 1) for k in range(1, 6)]


@pytest.mark.parametrize("k,offset,call,layout", k1_layout_cases("small", "large"))
def test_hash_probe_kernel_corners(cuda, k, offset, call, layout):
    """test_torch_kernels.py::test_hash_probe_contract_corners' inputs on
    the card: the kernel against its plain version and the contract, as
    they are (a small call, probe_sector) and tiled to a large call
    (chip_smoke.K1_LARGE_CALL rows, probe_rows), the query rows in each of
    K1's layouts (chip_smoke.query_layout). One launch a call, and the
    wrapper allocates nothing but its (Q,) output: a strided query is read
    where it lies, never copied."""
    slots, keys, qs, want = chip_smoke.hash_probe_corners(k)
    if call == "large":
        reps = -(-chip_smoke.K1_LARGE_CALL // len(qs))
        qs, want = np.tile(qs, (reps, 1)), np.tile(want, reps)
    args = (chip_smoke.offset_view(slots, cuda, offset), on(cuda, keys),
            chip_smoke.query_layout(qs, cuda, layout), 32)
    assert_kernel_matches_plain(hash_probe, "hash_probe", *args)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = hash_probe.hash_probe(*args)
    torch.cuda.synchronize()
    out_bytes = -(-4 * len(qs) // 512) * 512  # the allocator's 512-byte blocks
    assert torch.cuda.max_memory_allocated() - before == out_bytes
    assert np.array_equal(got.cpu().numpy(), want)


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


# the scans' sizes: one row, part of a warp's 32-row step, a 4,096-row tile
# and a row, and many tiles
SCAN_SIZES = [1, 31, 4097, (1 << 20) + 7]
SCAN_VALUES = ["random", "negative", "monotone", "constant"]


def scan_values(kind: str, n: int, rng) -> np.ndarray:
    """A max-scan input: uniform over int32, uniform just above INT32_MIN
    (the running maximum moves often), a random walk up from -n (it moves
    at most rows), or one negative value."""
    if kind == "random":
        return rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64)
    if kind == "negative":
        return -(2**31) + rng.integers(0, n + 1, n)
    if kind == "monotone":
        return np.cumsum(rng.integers(0, 3, n)) - n
    return np.full(n, -7)


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("digits", ["uniform", "equal"])
def test_digit_counts_kernel(cuda, n, digits, rng):
    """Both digit-major count tables, bit for bit."""
    digit = rng.integers(0, seg_scan.RADIX, n) if digits == "uniform" else np.full(n, 11)
    assert_kernel_matches_plain(seg_scan, "digit_counts", on(cuda, digit))


def test_digit_counts_kernel_tables_past_2_gib(cuda, rng):
    """At 2^25 + 7 rows each (16, N) table passes 2^31 bytes: the kernel's
    offsets into it are 64-bit."""
    n = (1 << 25) + 7
    assert 16 * n * 4 > 2**31
    assert_kernel_matches_plain(seg_scan, "digit_counts", on(cuda, rng.integers(0, 16, n)))


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("values", SCAN_VALUES)
def test_max_scan_kernel(cuda, n, values, rng):
    assert_kernel_matches_plain(seg_scan, "max_scan", on(cuda, scan_values(values, n, rng)))


@pytest.mark.parametrize("case", ["one_segment", "singletons", "presorted"])
def test_segmented_sort_cases_on_card(cuda, case, rng):
    """The sort's permutation equals np.lexsort's where the first var is one
    segment of every row, where every segment holds one row (a unique
    first var), and from a presorted first var; the scans launch."""
    n = 50_000
    if case == "one_segment":
        cols, bits = [rng.integers(0, 1 << 20, n)], (20,)
    elif case == "singletons":
        cols, bits = [rng.permutation(n), rng.integers(0, 1000, n)], (16, 10)
    else:
        cols, bits = [rng.integers(0, 300, n), rng.integers(0, 70_000, n)], (9, 17)
    dev = [on(cuda, c) for c in cols]
    launches = (seg_scan.digit_counts_launches, seg_scan.max_scan_launches)
    if case == "presorted":
        first = radix_sort.segmented_sort(dev[:1], bits[:1])
        got = radix_sort.segmented_sort(dev, bits, init_order=first, presorted=1)
    else:
        got = radix_sort.segmented_sort(dev, bits)
    assert seg_scan.digit_counts_launches > launches[0]
    assert seg_scan.max_scan_launches > launches[1]
    want = ref.segmented_sort_ref([on("cpu", c) for c in cols])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n,k", [(1, 1), (4097, 2), (300_000, 3)])
def test_build_table_on_card_matches_cpu(cuda, n, k, rng):
    """The hash table's slots and max displacement, card against CPU, its
    displacement scan one max_scan launch."""
    keys = np.unique(rng.integers(-(1 << 24), 1 << 24, (2 * n + 1, k)), axis=0)[:n]
    rng.shuffle(keys)
    launches = (seg_scan.digit_counts_launches, seg_scan.max_scan_launches)
    card = ops.build_table(on(cuda, keys))
    assert (seg_scan.digit_counts_launches, seg_scan.max_scan_launches) == (
        launches[0], launches[1] + 1)
    cpu = ops.build_table(on("cpu", keys))
    assert torch.equal(card.slots.cpu(), cpu.slots)
    assert int(card.max_disp) == int(cpu.max_disp)


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


# ---------------------------------------------------------------------------
# the distributed driver (core/distributed.py) on the card
# ---------------------------------------------------------------------------


def test_hash_probe_kernel_negative_keys(cuda, rng):
    """The distributed driver's pad rows carry negative sentinels, -(offset
    + row) - 1: K1 hashes and compares them as the plain version does."""
    pads = -(np.arange(5000) + 1)
    keys = np.unique(np.concatenate([pads, rng.integers(0, 1 << 20, 5000),
                                     [I32_MIN, I32_MIN + 1, -(2**30)]]))
    for k in (1, 3):
        table_keys = np.stack([np.roll(keys, j) for j in range(k)], axis=1)
        table = ops.build_table(on(cuda, table_keys))
        qs = np.vstack([table_keys[rng.integers(0, len(keys), 3000)],
                        np.stack([-rng.integers(1, 2**31, 3000)] * k, axis=1),
                        table_keys[-5:] + 1])
        assert_kernel_matches_plain(hash_probe, "hash_probe", table.slots, table.keys,
                                    on(cuda, qs), 32)


def _spmd_case(rng, n=3000, dom=40):
    from repro_torch.core.plan import binary2fj, factor

    q = triangle_query()
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, dom, n) for v in a.vars})
            for a in q.atoms}
    return q, rels, factor(binary2fj(q.atoms, q))


@pytest.mark.parametrize("num_shards", [1, 4, 8])
@pytest.mark.parametrize("capacities", [None, [64] * 4])
def test_spmd_count_on_card_matches_cpu(cuda, num_shards, capacities, rng):
    from repro_torch.core import distributed as D

    q, rels, fj = _spmd_case(rng)
    results = {}
    for device in ("cpu", "cuda"):
        D._cap_plan_cache.clear()
        info = {}
        count = D.spmd_count(q, rels, fj, capacities, num_shards=num_shards, device=device,
                             info=info)
        results[device] = (count, info["shares"], str(info["cap_plan"]), info["retries"],
                           info["compiles"])
    assert results["cuda"] == results["cpu"]
    host = D.distributed_join_host(q, rels, num_shards, agg="count", device="cuda")
    assert host == results["cpu"][0]


def test_spmd_warm_call_syncs_and_launches(cuda, rng):
    """A warm SpmdCounter call makes one host sync (the count and needs
    read-back) at every shard count, and launches K1/K2 once per shard
    for each launch of the 1-shard call."""
    from repro_torch.core import distributed as D

    q, rels, fj = _spmd_case(rng)
    syncs, launches = {}, {}
    for num_shards in (1, 4):
        ctr = D.SpmdCounter(q, rels, fj, num_shards=num_shards, device="cuda")
        want, retries = ctr(), ctr.retries
        before = (hash_probe.launches, csr_expand.launches)
        box = []
        syncs[num_shards] = sync_debug_count(lambda c=ctr: box.append(c()))
        launches[num_shards] = (hash_probe.launches - before[0], csr_expand.launches - before[1])
        assert box == [want] and ctr.retries == retries, "a warm call retries nothing"
    assert syncs[1] == syncs[4] == 1, syncs
    assert launches[4] == tuple(4 * n for n in launches[1]) and launches[1][0] > 0, launches


# ---------------------------------------------------------------------------
# the LM stack (repro_torch.models, serve.DecodeServeEngine): no kernel of
# its own, but its products and masks must give the CPU's answer on the card
# ---------------------------------------------------------------------------


def _lm_case(arch, seed, device):
    """The arch's reduced config (MoE capacity 8) and its parameters made on
    the CPU from `seed`: (cfg, params on the CPU, the same on `device`)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = get_arch(arch).reduced
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    params = tf.init_params(cfg, seed=seed, device="cpu")
    return cfg, params, copy.deepcopy(params).to(device)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b", "rwkv6-1.6b"])
def test_reduced_lm_on_card_matches_cpu(cuda, arch):
    """apply_model's logits and 8 decode steps (logits and every cache
    leaf) on the card against the CPU, fp32 with TF32 off, atol 1e-4."""
    from repro_torch.models import transformer as tf

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu_params, params = _lm_case(arch, 0, cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    x, x_cpu = on(cuda, toks), on("cpu", toks)
    tol = dict(atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(tf.apply_model(params, cfg, x).cpu(),
                               tf.apply_model(cpu_params, cfg, x_cpu), **tol)
    cache = tf.init_cache(cfg, 2, 8, device=cuda)
    cache_cpu = tf.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        got, cache = tf.decode_step(params, cfg, x[:, t:t + 1], cache, t)
        want, cache_cpu = tf.decode_step(cpu_params, cfg, x_cpu[:, t:t + 1], cache_cpu, t)
        torch.testing.assert_close(got.cpu(), want, **tol)
        for a, b in zip([l for pos in cache for l in pos], [l for pos in cache_cpu for l in pos]):
            torch.testing.assert_close(a.cpu(), b, **tol)


def test_decode_serve_engine_on_card_matches_cpu(cuda):
    """The same requests through DecodeServeEngine on the card and on the
    CPU give the same tokens, steps and allocator state."""
    from repro_torch.serve import DecodeServeEngine, Request

    cfg, cpu_params, params = _lm_case("mixtral-8x22b", 1, cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (3, 9, 1, 14, 5, 7)]
    max_new = [6, 20, 3, 12, 30, 4]
    engines, gaps = [], []

    def on_emit(req, pos, logits):
        top2 = torch.topk(logits, 2).values
        gaps.append(float(top2[0] - top2[1]))

    for p in (params, cpu_params):
        eng = DecodeServeEngine(p, cfg, slots=3, max_len=24, on_emit=on_emit)
        reqs = [Request(rid=i, prompt=pr, max_new=m)
                for i, (pr, m) in enumerate(zip(prompts, max_new))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        engines.append((eng, [r.out for r in reqs]))
    (card, card_out), (cpu, cpu_out) = engines
    assert card.device.type == "cuda"
    assert min(gaps) > 1e-3, "exact equality of tokens needs clear top-2 gaps"
    assert card_out == cpu_out
    assert card.steps == cpu.steps
    assert card.pages.owner == cpu.pages.owner and card.pages.free == cpu.pages.free


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x22b", "rwkv6-1.6b"])
def test_reduced_train_step_on_card_matches_cpu(cuda, arch):
    """The same parameters and batch on the card and on the CPU, fp32 with
    TF32 off: the loss within 1e-5 relative, every gradient leaf within
    1e-4 * max|g| + 1e-6 of the CPU's; after one make_train_step step the
    parameters within rtol 1e-4 where |g| is above ten times that bound,
    and within 2 lr everywhere (AdamW's first update is g / (|g| + eps):
    where g is rounding noise, so is the update, in [-1, 1])."""
    from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_state
    from repro_torch.train.trainer import _loss_and_grads

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, cpu_params, params = _lm_case(arch, 2, cuda)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9))
    batches = [{"inputs": on(d, toks[:, :-1]), "labels": on(d, toks[:, 1:])}
               for d in (cuda, "cpu")]
    grads = []
    for p, b in zip((params, cpu_params), batches):
        p.requires_grad_()
        grads.append(_loss_and_grads(p, cfg, b["inputs"], b["labels"]))
    (loss, g_card), (want_loss, g_cpu) = grads
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    bounds = [1e-4 * float(g.abs().max()) + 1e-6 for g in g_cpu]
    for a, b, bound in zip(g_card, g_cpu, bounds):
        assert float((a.cpu() - b).abs().max()) <= bound
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10))
    step = make_train_step(cfg, tcfg)
    for p, b in zip((params, cpu_params), batches):
        step(p, init_state(tcfg.adamw, p), b)
    for a, b, g, bound in zip(params.parameters(), cpu_params.parameters(), g_cpu, bounds):
        a, b = a.detach().cpu(), b.detach()
        signal = g.abs() > 10 * bound
        torch.testing.assert_close(a[signal], b[signal], atol=1e-6, rtol=1e-4)
        assert float((a - b).abs().max()) <= 2 * tcfg.adamw.lr


def test_corpus_selection_on_card_matches_numpy(cuda):
    """select_corpus_samples on the card (its default device) launches K1
    and equals the numpy oracle."""
    from repro_torch.train.data import select_corpus_samples

    n = 200_000
    rng = np.random.default_rng(0)
    docs = Relation("Docs", {"doc": np.arange(n), "shard": rng.integers(0, 64, n),
                             "lang": rng.integers(0, 30, n)})
    quality = Relation("Quality", {"doc": np.arange(n), "score": rng.integers(0, 100, n)})
    canonical = np.arange(n)
    dup = rng.random(n) < 0.2
    canonical[dup] = rng.integers(0, n, int(dup.sum()))
    dedup = Relation("Dedup", {"doc": np.arange(n), "canonical": canonical})
    before = hash_probe.launches
    got = select_corpus_samples(docs, quality, dedup, 60)
    assert hash_probe.launches > before
    want = np.flatnonzero((quality.columns["score"] >= 60) & (canonical == np.arange(n)))
    np.testing.assert_array_equal(got, want)


def test_checkpoint_restores_on_card(cuda, tmp_path):
    """A card train state saved and restored into a fresh one on the card:
    every leaf bit for bit, bf16 moments included."""
    from repro_torch.train import AdamWConfig, TrainConfig, checkpoint
    from repro_torch.train.trainer import init_train_state

    cfg, _, _ = _lm_case("jamba-1.5-large-398b", 0, cuda)
    tcfg = TrainConfig(adamw=AdamWConfig(moment_dtype="bfloat16"))
    params, opt = init_train_state(cfg, tcfg, seed=1, device=cuda)
    for t in (*opt["m"].parameters(), *opt["v"].parameters()):
        t.copy_(torch.randn(t.shape, device=cuda))
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": opt}, cfg)
    fresh = init_train_state(cfg, tcfg, seed=2, device=cuda)
    checkpoint.restore(str(tmp_path), 3, {"params": fresh[0], "opt": fresh[1]}, cfg)
    for a, b in zip([*params.parameters(), *opt["m"].parameters(), *opt["v"].parameters()],
                    [*fresh[0].parameters(), *fresh[1]["m"].parameters(),
                     *fresh[1]["v"].parameters()]):
        assert b.is_cuda and torch.equal(a, b)


def test_spans_share_the_profilers_clock(cuda, rng):
    """Under a CPU + CUDA profiler the port's spans lie on the device
    trace's clock: each launch of the port's own kernels (K1-K3) in a warm
    triangle count lies inside an `exec.node` range, and the `needs`
    read-back's `exec.sync` range ends after the device operation before
    its copy, and after the copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    e = rng.integers(0, 5000, (200_000, 2))
    rels = {"R": Relation("R", {"x": e[:, 0], "y": e[:, 1]}),
            "S": Relation("S", {"y": e[:, 0], "z": e[:, 1]}),
            "T": Relation("T", {"z": e[:, 0], "x": e[:, 1]})}
    q, opts = triangle_query(), ExecOptions(device="cuda")
    want = compiled_free_join(q, rels, options=opts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        assert compiled_free_join(q, rels, options=opts) == want
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [x for x in events if x.device_type() != DeviceType.CUDA]
    device = [x for x in events if x.device_type() == DeviceType.CUDA]

    def interval(x):
        return x.start_ns(), x.start_ns() + x.duration_ns()

    nodes = [interval(x) for x in host if x.name() == "exec.node"]
    launches = {x.correlation_id(): x for x in host if x.name() == "cudaLaunchKernel"}
    ours = [x for x in device
            if any(k in x.name() for k in ("probe_rows", "probe_sector", "csr_expand", "compact"))]
    assert nodes and ours
    for k in ours:
        s, t = interval(launches[k.correlation_id()])
        assert any(a <= s and t <= b for a, b in nodes), k.name()
    needs = [x for x in host if x.name() == "exec.sync" and x.kwinputs().get("what") == "needs"]
    assert len(needs) == 1
    a, b = interval(needs[0])
    copies = [x for x in device if x.name().startswith("Memcpy DtoH") and a <= x.start_ns() <= b]
    assert copies
    copy = copies[0]
    before = [x for x in device if interval(x)[1] <= copy.start_ns()]
    assert before and max(interval(x)[1] for x in before) <= b
    assert interval(copy)[1] <= b
