"""The plain reference against nested loops at tiny sizes."""
import numpy as np
import pytest

from perfbench import reference as R

TRIANGLE = [("E", ("a", "b")), ("E", ("b", "c")), ("E", ("c", "a"))]
TWO_HOP = [("E", ("a", "b")), ("E", ("b", "c"))]
STAR = [("R", ("x", "y")), ("S", ("y", "a")), ("T", ("y", "b"))]


def tables(seed: int, n: int = 40, dom: int = 7):
    rng = np.random.default_rng(seed)
    col = lambda: rng.integers(0, dom, n)  # noqa: E731
    return {"E": {"a": col(), "b": col()}, "R": {"x": col(), "y": col()},
            "S": {"y": col(), "a": col()}, "T": {"y": col(), "b": col()}}


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("query", [TRIANGLE, TWO_HOP, STAR], ids=["triangle", "two_hop", "star"])
def test_count_is_brute_force(query, seed):
    t = tables(seed)
    assert R.count(query, t) == R.brute_force(query, t)


@pytest.mark.parametrize("query", [TRIANGLE, TWO_HOP], ids=["triangle", "two_hop"])
def test_point_counts_are_brute_force(query):
    t = tables(11)
    point = R.point_counts(query, t, "a")
    for c in range(8):
        assert point(c) == R.brute_force(query, t, {"a": c})


def test_memo_serves_unchanged_tables():
    t = tables(3)
    memo = {}
    first = R.count(STAR, t, memo=memo)
    t2 = {**t, "S": tables(4)["S"]}
    assert R.count(STAR, t2, memo=memo) == R.brute_force(STAR, t2)
    assert R.count(STAR, t, memo=memo) == first


def test_duplicates_count():
    t = {"E": {"a": np.array([0, 0, 1, 2]), "b": np.array([1, 1, 2, 0])}}
    assert R.count(TRIANGLE, t) == R.brute_force(TRIANGLE, t) == 6
