"""Inputs come from --seed: the same seed gives the same inputs, and every
seed the same work in another order."""
import numpy as np
import pytest

from perfbench.harness.loops import loop_class
from perfbench.harness.program import Port
from perfbench.tests.small import small_cell

CELLS = ["urand18-q1-warm", "ssb10-q33-warm", "ssb10-q33-cold", "urand18-serve-zipf"]


def tables_of(workload, seed):
    cell = small_cell(workload)
    return cell, cell.dataset().generate(cell.config, seed)


@pytest.mark.parametrize("workload", CELLS)
def test_same_seed_same_tables(workload):
    _c, a = tables_of(workload, 2**31 + 11)
    _c, b = tables_of(workload, 2**31 + 11)
    for t in a:
        for v in a[t]:
            assert np.array_equal(a[t][v], b[t][v])


@pytest.mark.parametrize("workload", CELLS)
def test_other_seed_same_work_relabeled(workload):
    _c, a = tables_of(workload, 5)
    _c, b = tables_of(workload, 6)
    for t in a:
        for v in a[t]:
            assert not np.array_equal(a[t][v], b[t][v])
            # the same multiset of value frequencies: a relabeling
            fa = np.sort(np.unique(a[t][v], return_counts=True)[1])
            fb = np.sort(np.unique(b[t][v], return_counts=True)[1])
            assert np.array_equal(fa, fb)


def test_fresh_tables_depend_on_the_index_alone():
    cell, tables = tables_of("ssb10-q33-cold", 5)
    ds = cell.dataset()
    one = ds.redraw(cell.config, tables, 5, 3)
    again = ds.redraw(cell.config, tables, 5, 3)
    other = ds.redraw(cell.config, tables, 5, 4)
    assert np.array_equal(one["customer"]["c"], again["customer"]["c"])
    assert not np.array_equal(one["customer"]["c"], other["customer"]["c"])
    lo, fresh = tables["lineorder"]["c"], one["lineorder"]["c"]
    assert fresh is not lo and np.array_equal(fresh, lo)


def test_open_loop_schedule():
    cell = small_cell("urand18-serve-zipf")
    plans = {}
    for seed in (3, 3, 4):
        _c, tables = tables_of("urand18-serve-zipf", seed)
        loop = loop_class(cell)(cell, tables, Port("cpu"), seed)
        loop.plan(2.0)
        plans.setdefault(seed, []).append(loop.requests)
    assert plans[3][0] == plans[3][1]
    due = [r[0] for r in plans[3][0]]
    assert len(due) == 80 and due == sorted(due) and abs(due[-1] - 2.0) < 1e-9
    gaps3 = np.sort(np.diff([0.0] + due))
    gaps4 = np.sort(np.diff([0.0] + [r[0] for r in plans[4][0]]))
    assert np.allclose(gaps3, gaps4)  # the same gaps, in another order
    assert [r[0] for r in plans[4][0]] != due
