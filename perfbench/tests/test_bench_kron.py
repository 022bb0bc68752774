"""The kron cell (kron18-q1-warm): GAP's kron graph under q1, checked
against its own named reference (perfbench/reference_triangles.py)
through the closed_ownref loop. At a small size on the CPU the sampled
control fails the cell's check and the port passes it; the generator's
graph repeats for a seed; the harness finds every part of the cell by
name; the new readers read nothing on a program without their counters."""
import numpy as np
import pytest

from perfbench.harness import manifest, port_counters
from perfbench.harness.control import Control
from perfbench.harness.program import Port
from perfbench.harness.record import Record
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import run_small, small_cell

CELL = "kron18-q1-warm"
NEW = ("exec.expanded_lanes_per_query", "exec.second_cover_share", "exec.tiles_per_query")


def small():
    return small_cell(CELL, scale=9)


def test_control_is_not_correct():
    result, checks, _rec = run_small(small(), Control("sampled"), seconds=0.3)
    assert not result["correct"] and checks["wrong_answers"][0] > 0


def test_port_is_correct():
    result, checks, _rec = run_small(small(), Port("cpu"), seconds=0.5, traced=True)
    assert result["correct"] and result["failed"] == 0 and checks["answers"][0] >= 1
    metrics = result["metrics"]
    assert metrics["exec.expanded_lanes_per_query"]["value"] > 0
    assert 0.3 < metrics["exec.second_cover_share"]["value"] < 0.7


def test_generator_repeats_for_a_seed():
    cell = small()
    gen = cell.dataset()
    one, two = (gen.generate(cell.config, 11)["knows"] for _ in range(2))
    other = gen.generate(cell.config, 12)["knows"]
    for v in "ab":
        assert np.array_equal(one[v], two[v])
    # another seed relabels and reorders the same graph
    degrees = [np.sort(np.bincount(g["a"])[np.bincount(g["a"]) > 0]) for g in (one, other)]
    assert len(one["a"]) == len(other["a"]) and np.array_equal(*degrees)
    assert not np.array_equal(one["a"], other["a"])
    assert not (one["a"] == one["b"]).any()
    deg = np.bincount(one["a"])
    assert deg.max() > 8 * deg[deg > 0].mean()  # hubs: Kronecker skew


def test_the_harness_finds_the_cell_by_name():
    cell = manifest.load(ROOT, CELL)
    assert cell.config["reference"] == "reference_triangles" and cell.chips == 1
    assert cell.traffic["loop"] == "closed_ownref"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "queries_per_s",
                                                     "device_peak_mib"}
    assert set(NEW) <= {m["name"] for m in cell.per_layer}
    for m in cell.per_layer + cell.end_to_end:
        assert callable(cell.reader(m["name"]).read)
    assert cell.part("loops", "closed_ownref").Loop.reference


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_without_their_counters(name, monkeypatch):
    from repro_torch.core import trace

    class Bare:  # a tracer of a program without these counters and spans
        pass

    monkeypatch.setattr(trace, "TRACE", Bare())
    reader = manifest.load(ROOT, CELL).reader(name)
    for target in reader.COUNTERS.values():
        module, path = target.split(":")
        assert module == "perfbench.harness.port_counters"
        owner = port_counters
        for attr in path.split("."):
            owner = getattr(owner, attr)
        assert owner == 0
    run = Record(completed=3, counters={k: 0 for k in reader.COUNTERS})
    assert reader.read(run) is None
