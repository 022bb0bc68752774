"""Port kernels (plain PyTorch versions, CPU) against the reference Pallas
kernels in interpret mode and the brute-force oracles.

Inputs are made with a seeded numpy generator and handed to both sides as
numpy arrays. Every output is an integer, so every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import radix_sort as jradix_sort
from repro.kernels import ref as jref
from repro.kernels.compact import compact_pallas
from repro.kernels.csr_expand import csr_expand_pallas
from repro.kernels.hash_probe import QBLK, hash_probe_pallas
from repro.kernels.hash_probe import mix32 as jmix32
from repro.kernels.radix_sort import radix_rank_pallas
from repro_torch.kernels import (compact, csr_expand, hash_probe, intersect, ops, radix_sort, ref,
                                 seg_scan)
from test_torch_cuda import (INTERSECT_HARD, SCAN_VALUES, intersect_hard_case, k1_layout_cases,
                             scan_values)

import chip_smoke

BLK = 1024  # the Pallas kernels' output block (OBLK/CBLK)


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def pad_to(n: int, block: int) -> int:
    return n + (-n) % block


def unique_keys(rng, n, k, lo=0, hi=10**6):
    return np.unique(rng.integers(lo, hi, (2 * n + 1, k)).astype(np.int32), axis=0)[:n]


def probe_queries(rng, keys, q):
    k = keys.shape[1]
    hits = keys[rng.integers(0, len(keys), q // 2)]
    misses = rng.integers(10**6, 2 * 10**6, (q - q // 2, k)).astype(np.int32)
    return np.vstack([hits, misses])


# ---- K1: hash probe + the table build --------------------------------------


def test_mix32_bit_for_bit(rng):
    keys = rng.integers(-(2**31), 2**31, (4096, 3), dtype=np.int64).astype(np.int32)
    keys[:4] = [[0, 0, 0], [-1, -1, -1], [2**31 - 1, -(2**31), 1], [1, 2, 3]]
    for k in (1, 2, 3):
        want = np.asarray(jmix32(jnp.asarray(keys[:, :k])))
        np.testing.assert_array_equal(hash_probe.mix32(t32(keys[:, :k])).numpy(), want)


@pytest.mark.parametrize("n,k", [(0, 2), (1, 1), (17, 2), (300, 3), (1000, 1), (5000, 2)])
def test_build_table_bit_for_bit(n, k, rng):
    keys = unique_keys(rng, n, k, lo=-(10**6)).reshape(n, k)
    want = jops.build_table(jnp.asarray(keys))
    got = ops.build_table(t32(keys))
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    assert int(got.max_disp) == int(want.max_disp)


def test_build_table_adversarial_same_slot():
    keys = (np.arange(512, dtype=np.int32) * 64)[:, None]
    want = jops.build_table(jnp.asarray(keys))
    got = ops.build_table(t32(keys))
    np.testing.assert_array_equal(got.slots.numpy(), np.asarray(want.slots))
    np.testing.assert_array_equal(ops.probe(got, t32(keys)).numpy(), np.arange(512))


@pytest.mark.parametrize(
    "n,k,q", [(1, 1, 5), (17, 2, 64), (300, 3, 700), (1000, 1, 2048), (3000, 2, 1033)]
)
def test_hash_probe_vs_pallas(n, k, q, rng):
    keys = unique_keys(rng, n, k)
    qs = probe_queries(rng, keys, q)
    table = jops.build_table(jnp.asarray(keys))
    padded = np.zeros((pad_to(q, QBLK), k), np.int32)
    padded[:q] = qs
    want = np.asarray(
        hash_probe_pallas(table.slots, table.keys, jnp.asarray(padded), interpret=True)
    )[:q]
    ttable = ops.build_table(t32(keys))
    got = hash_probe.hash_probe(ttable.slots, ttable.keys, t32(qs), hash_probe.PROBE_BUDGET)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.hash_probe_ref(t32(keys), t32(qs)).numpy(), want)


@pytest.mark.parametrize("k,offset,layout", k1_layout_cases())
def test_hash_probe_contract_corners(k, offset, layout):
    """The probe's contract at its corners (chip_smoke.hash_probe_corners:
    a match after an empty slot, a match only at h + budget, duplicate
    rows in one chain, home slots in the last 8 slots of cap, a clamped
    candidate, negative and INT32_MIN keys, dead lanes), key widths 1-5,
    `slots` also a view one element into its storage, the query rows
    row-major, column-major and as a column-major view into a larger
    buffer (chip_smoke.query_layout): the plain version against the
    reference's Pallas kernel and the contract's answers."""
    slots, keys, qs, want = chip_smoke.hash_probe_corners(k)
    padded = np.zeros((pad_to(len(qs), QBLK), k), np.int32)
    padded[: len(qs)] = qs
    pallas = np.asarray(hash_probe_pallas(jnp.asarray(slots), jnp.asarray(keys),
                                          jnp.asarray(padded), interpret=True))[: len(qs)]
    tslots = chip_smoke.offset_view(slots, "cpu", offset)
    assert tslots.storage_offset() == offset
    tq = chip_smoke.query_layout(qs, "cpu", layout)
    assert tq.shape == (len(qs), k) and tq.is_contiguous() == (layout == "rows" or k == 1)
    got = hash_probe.hash_probe(tslots, t32(keys), tq, hash_probe.PROBE_BUDGET)
    np.testing.assert_array_equal(pallas, want)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hash_probe_edge_lanes(rng):
    """A one-row table, all -1 query lanes (dead frontier lanes probe with
    group id -1), and an empty query batch."""
    one = ops.build_table(t32([[5, 9]]))
    qs = t32([[5, 9], [9, 5], [-1, 9], [5, 8]])
    np.testing.assert_array_equal(ops.probe(one, qs).numpy(), [0, -1, -1, -1])
    keys = unique_keys(rng, 700, 2)
    table = ops.build_table(t32(keys))
    dead = t32(np.full((1033, 2), -1))
    want = jops.probe(jops.build_table(jnp.asarray(keys)), jnp.asarray(np.asarray(dead)),
                      impl="pallas_interpret")
    np.testing.assert_array_equal(ops.probe(table, dead).numpy(), np.asarray(want))
    assert ops.probe(table, t32(np.zeros((0, 2)))).shape == (0,)


# ---- K2: CSR expansion -------------------------------------------------------


# fan-outs a tiled merge gets wrong (the CUDA kernel merges 2,304 items a
# block): one hub row wider than a block, or a run of zero-count rows
# longer than one, in 3,000 rows
def shaped_counts(rng, shape):
    counts = rng.integers(0, 5, 3000).astype(np.int32)
    if shape == "hub":
        counts[1234] = 5000
    else:  # "zero_run"
        counts[200:2800] = 0
    return counts


def expand_case(rng, f, zero_frac=0.3):
    if isinstance(f, str):
        counts = shaped_counts(rng, f)
    else:
        counts = rng.integers(0, 7, f).astype(np.int32)
        counts[rng.random(f) < zero_frac] = 0
    cum = np.cumsum(counts).astype(np.int32)
    base = rng.integers(0, 10**5, len(counts)).astype(np.int32)
    return (cum - counts).astype(np.int32), base, int(cum[-1])


@pytest.mark.parametrize("f,cap", [(1, 1024), (8, 1024), (100, 2048), (777, 1500), (37, 3000),
                                   ("hub", 12_345), ("hub", 4096), ("zero_run", 1500),
                                   (1, 3)])
@pytest.mark.parametrize("total_zero", [False, True])
def test_csr_expand_vs_pallas(f, cap, total_zero, rng):
    starts, base, total = expand_case(rng, f)
    total = 0 if total_zero else total
    want = csr_expand_pallas(
        jnp.asarray(starts), jnp.asarray(base), jnp.asarray([total], jnp.int32),
        capacity=pad_to(cap, BLK), interpret=True,
    )
    fr, member = csr_expand.csr_expand(t32(starts), t32(base), t32([total]), cap)
    np.testing.assert_array_equal(fr.numpy(), np.asarray(want[0])[:cap])
    np.testing.assert_array_equal(member.numpy(), np.asarray(want[1])[:cap])


@pytest.mark.parametrize("g,f,cap", [(5, 8, 1024), (50, 100, 2048), (1, 1, 7)])
def test_csr_expand_capped_vs_oracles(g, f, cap, rng):
    counts = rng.integers(0, 7, g).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    groups = rng.integers(0, g, f).astype(np.int32)
    got = ops.csr_expand_capped(t32(offsets), t32(groups), cap)
    want = ref.csr_expand_ref(t32(offsets), t32(groups), cap)
    jwant = jops.csr_expand_capped(jnp.asarray(offsets), jnp.asarray(groups), cap)
    for a, b, c in zip(got, want, jwant):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_expand_counted_zero_counts():
    fr, member, valid, total = ops.expand_counted(t32([0, 5, 9]), t32([2, 0, 3]), 8)
    assert int(total) == 5
    np.testing.assert_array_equal(fr.numpy(), [0, 0, 2, 2, 2, -1, -1, -1])
    np.testing.assert_array_equal(member.numpy(), [0, 1, 9, 10, 11, -1, -1, -1])
    np.testing.assert_array_equal(valid.numpy(), [True] * 5 + [False] * 3)


# ---- K3: compaction ----------------------------------------------------------


@pytest.mark.parametrize(
    "n,cap,p", [(1, 1024, 0.3), (1000, 1024, 0.3), (4096, 2048, 0.3), (777, 1500, 0.5),
                (513, 1024, 0.0), (4000, 1024, 0.5), ("invalid_run", 1500, 0.5), (1, 3, 1.0)]
)
def test_compact_vs_pallas(n, cap, p, rng):
    if n == "invalid_run":  # 3,400 dead lanes in a row, longer than a block's 1,792 items
        valid = rng.random(4000) < p
        valid[300:3700] = False
    else:
        valid = rng.random(n) < p
    csum = np.cumsum(valid).astype(np.int32)
    live = int(csum[-1])
    want = compact_pallas(
        jnp.asarray(csum), jnp.asarray([live], jnp.int32), capacity=pad_to(cap, BLK),
        interpret=True,
    )
    got = compact.compact(t32(csum), t32([live]), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:cap])
    src, got_live = ops.compact_indices(torch.from_numpy(valid), cap)
    ref_src, ref_live = ref.compact_ref(torch.from_numpy(valid), cap)
    np.testing.assert_array_equal(src.numpy(), ref_src.numpy())
    assert int(got_live) == int(ref_live) == live


def test_compact_indices_empty_frontier():
    src, live = ops.compact_indices(torch.zeros(0, dtype=torch.bool), 5)
    np.testing.assert_array_equal(src.numpy(), [-1] * 5)
    assert int(live) == 0


# ---- K4: radix rank ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 64, 1013, 4096])
def test_radix_rank_vs_pallas(n, rng):
    digit = rng.integers(0, radix_sort.RADIX, n)
    onehot = (digit[:, None] == np.arange(radix_sort.RADIX)[None, :]).astype(np.int32)
    csum = np.cumsum(onehot, axis=0).astype(np.int32)
    kd = rng.integers(0, radix_sort.RADIX, n).astype(np.int32)
    kt = rng.integers(0, n // radix_sort.RADIX + 3, n).astype(np.int32)
    want = radix_rank_pallas(jnp.asarray(csum), jnp.asarray(kd), jnp.asarray(kt), interpret=True)
    got = radix_sort.radix_rank(t32(csum.T), t32(kd), t32(kt))  # the port is digit-major
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---- the trie build's scans (seg_scan) ------------------------------------------

# one row, part of a warp's 32-row step, a 4,096-row tile and a row, many tiles
SCAN_SIZES = [1, 31, 4097, 70_001]


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("digits", ["uniform", "equal"])
def test_digit_counts_plain_vs_numpy(n, digits, rng):
    """Both tables are numpy's cumsum over the one-hot, along the rows and
    then along the digits."""
    digit = rng.integers(0, seg_scan.RADIX, n) if digits == "uniform" else np.full(n, 11)
    onehot = np.arange(seg_scan.RADIX)[:, None] == digit[None, :]
    csum, pcs = seg_scan.digit_counts(t32(digit))
    assert csum.dtype == pcs.dtype == torch.int32
    np.testing.assert_array_equal(csum.numpy(), np.cumsum(onehot, axis=1))
    np.testing.assert_array_equal(pcs.numpy(), np.cumsum(np.cumsum(onehot, axis=1), axis=0))


@pytest.mark.parametrize("n", SCAN_SIZES)
@pytest.mark.parametrize("values", SCAN_VALUES)
def test_max_scan_plain_vs_numpy(n, values, rng):
    x = scan_values(values, n, rng).astype(np.int32)
    got = seg_scan.max_scan(t32(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.maximum.accumulate(x))


def test_scan_wrappers_reject_bad_inputs_and_count_only_launches():
    """An empty column gives empty tables and calls nothing; a CPU tensor
    runs the plain version, counted as a plain call of its own entry point,
    never as a launch."""
    from repro_torch.kernels import _build

    names = ("digit_counts", "max_scan")
    launches = [getattr(seg_scan, _build.counter(k)) for k in names]
    plain = [_build.plain_calls[k] for k in names]
    csum, pcs = seg_scan.digit_counts(t32([]))
    assert csum.shape == pcs.shape == (seg_scan.RADIX, 0)
    assert seg_scan.max_scan(t32([])).shape == (0,)
    assert [_build.plain_calls[k] for k in names] == plain
    seg_scan.digit_counts(t32([1, 2]))
    assert [_build.plain_calls[k] for k in names] == [plain[0] + 1, plain[1]]
    seg_scan.max_scan(t32([1, 2]))
    assert [_build.plain_calls[k] for k in names] == [plain[0] + 1, plain[1] + 1]
    with pytest.raises(ValueError, match="int32"):
        seg_scan.max_scan(t32([1, 2]).long())
    with pytest.raises(ValueError, match=r"\(N,\)"):
        seg_scan.digit_counts(t32([[1, 2]]))
    with pytest.raises(ValueError, match="contiguous"):
        seg_scan.max_scan(t32([1, 0, 1, 0])[::2])
    assert [getattr(seg_scan, _build.counter(k)) for k in names] == launches


# ---- K5: sorted-set intersection ---------------------------------------------


def intersect_case(rng, m, n):
    """The reference kernel test's inputs: b sorted unique, a half hits
    (with repeats) and half misses above b's range, unsorted."""
    b = np.unique(rng.integers(0, 10**5, n).astype(np.int32))
    a = np.concatenate([
        b[rng.integers(0, len(b), m // 2 + 1)] if len(b) else np.zeros(0, np.int32),
        rng.integers(10**5, 2 * 10**5, m // 2).astype(np.int32),
    ])[:m]
    return a, b


@pytest.mark.parametrize("case", [
    *(pytest.param((m, n), id=f"{m}-{n}")
      for m, n in [(1, 1), (100, 37), (1000, 999), (1025, 500), (0, 50), (40, 0)]),
    *INTERSECT_HARD,
])
def test_intersect_vs_pallas(case, rng):
    """K5's plain version (through ops.intersect_sorted) against the Pallas
    kernel in interpret mode and both brute-force oracles. `case` is (m, n)
    for intersect_case (Q = 1025 is not a multiple of the Pallas block, and
    m = 0 / n = 0 take the empty shortcut of ops.intersect_sorted) or the
    name of one of the bucket directory's hard cases
    (test_torch_cuda.intersect_hard_case)."""
    if isinstance(case, str):
        a, b = intersect_hard_case(case, rng)
    else:
        a, b = intersect_case(rng, *case)
    m, n = len(a), len(b)
    wm, wp = jops.intersect_sorted(jnp.asarray(a), jnp.asarray(b), impl="pallas_interpret")
    gm, gp = ops.intersect_sorted(t32(a), t32(b))
    assert gm.dtype == torch.bool and gp.dtype == torch.int32
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    if m and n:
        jm, jp = jref.intersect_ref(jnp.asarray(a), jnp.asarray(b))
        rm, rp = ref.intersect_ref(t32(a), t32(b))
        for got, want in ((gm, jm), (gp, jp), (rm, jm), (rp, jp)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_intersect_edge_keys():
    """Keys below b[0] and above b[-1], all hits, all misses, and N = 1."""
    b = np.int32([3, 8, 20, 41, 77])
    for a in ([-5, 0, 2, 3, 77, 78, 2**31 - 1, -(2**31)], [3, 8, 20, 41, 77, 77, 3],
              [1, 4, 9, 21, 100]):
        a = np.int32(a)
        wm, wp = jops.intersect_sorted(jnp.asarray(a), jnp.asarray(b), impl="pallas_interpret")
        gm, gp = intersect.intersect_plain(t32(a), t32(b))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    gm, gp = intersect.intersect(t32([6, 7, 8]), t32([7]))
    np.testing.assert_array_equal(gm.numpy(), [False, True, False])
    np.testing.assert_array_equal(gp.numpy(), [-1, 0, -1])


@pytest.mark.parametrize("n,bits", [(1, 1), (2, 1), (3, 2), (4, 2), (5, 3), (39_932, 16),
                                    (1 << 14, 14), ((1 << 14) + 1, 15), (2_097_152, 21)])
def test_intersect_directory_bits(n, bits):
    """2^r buckets for N keys: the power of two at or above N (2^bits), at
    least 2, at most 2^MAX_DIRECTORY_BITS. The kernel's scratch holds
    2^r + 1 pairs of int32."""
    r = min(bits, intersect.MAX_DIRECTORY_BITS)
    assert intersect.directory_bits(n) == r
    assert intersect.directory_words(r) == 2 * ((1 << r) + 1)


# ---- lex_searchsorted (the delta merge's rank) ------------------------------------


@pytest.mark.parametrize("ncols,n,q,dom", [(1, 50, 40, 9), (2, 300, 128, 6), (3, 257, 99, 4),
                                           (2, 1, 17, 3), (2, 0, 10, 5)])
def test_lex_searchsorted_vs_reference(ncols, n, q, dom, rng):
    """Sorted rows with heavy duplication (a small domain), queries inside
    and outside it, and an empty sorted run (n = 0)."""
    rows = rng.integers(0, dom, (n, ncols)).astype(np.int32)
    rows = rows[np.lexsort(rows.T[::-1])] if n else rows
    qs = rng.integers(-1, dom + 1, (q, ncols)).astype(np.int32)
    want = jradix_sort.lex_searchsorted([jnp.asarray(rows[:, c]) for c in range(ncols)],
                                        [jnp.asarray(qs[:, c]) for c in range(ncols)])
    got = radix_sort.lex_searchsorted([t32(rows[:, c]) for c in range(ncols)],
                                      [t32(qs[:, c]) for c in range(ncols)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    brute = [sum(tuple(r) < tuple(x) for r in rows.tolist()) for x in qs.tolist()]
    np.testing.assert_array_equal(got.numpy(), brute)


# ---- the wrappers' contract ----------------------------------------------------


def test_wrappers_reject_bad_inputs_and_count_only_launches():
    csum = t32([1, 1, 2])
    before = (hash_probe.launches, csr_expand.launches, compact.launches, radix_sort.launches,
              intersect.launches)
    compact.compact(csum, t32([2]), 4)  # a CPU tensor runs the plain version
    intersect.intersect(t32([1, 2]), t32([2]))
    with pytest.raises(ValueError, match="int32"):
        compact.compact(csum.long(), t32([2]), 4)
    with pytest.raises(ValueError, match="contiguous"):
        compact.compact(t32([1, 0, 1, 0])[::2], t32([2]), 4)
    with pytest.raises(ValueError, match="several devices"):
        compact.compact(csum, torch.tensor([2], dtype=torch.int32, device="meta"), 4)
    with pytest.raises(ValueError, match="starts and base"):
        csr_expand.csr_expand(t32([]), t32([]), t32([0]), 8)
    with pytest.raises(ValueError, match="power of two"):
        hash_probe.hash_probe(t32(np.full(43, -1)), t32([[1]]), t32([[1]]), 32)
    with pytest.raises(ValueError, match="kd and kt"):
        radix_sort.radix_rank(t32(np.zeros((16, 3))), t32([0, 0]), t32([0, 0]))
    with pytest.raises(ValueError, match="N >= 1"):
        intersect.intersect(t32([1]), t32([]))
    with pytest.raises(ValueError, match="int32"):
        intersect.intersect(t32([1]).long(), t32([1]))
    after = (hash_probe.launches, csr_expand.launches, compact.launches, radix_sort.launches,
             intersect.launches)
    assert after == before, "plain CPU runs are not kernel launches"


def test_kernel_library_path_follows_every_header(tmp_path, monkeypatch):
    """A kernel's library is named by a digest of its source and of every
    header under csrc/, so an edited or added header means a rebuild."""
    from repro_torch.kernels import _build

    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    names = ("csr_expand", "compact", "hash_probe")
    before = {name: _build._lib_path(name) for name in names}
    assert before == {name: _build._lib_path(name) for name in names}  # stable
    header = tmp_path / "load_balance.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build._lib_path(name) for name in names}
    assert all(edited[name] != before[name] for name in names)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    added = {name: _build._lib_path(name) for name in names}
    assert all(added[name] != edited[name] for name in names)
    (tmp_path / "compact.cu").write_text((tmp_path / "compact.cu").read_text() + "\n")
    assert _build._lib_path("compact") != added["compact"]
    assert _build._lib_path("csr_expand") == added["csr_expand"]
