"""The readers of the port's spans and lane counters: their COUNTERS resolve
to the port's tracer, read() works on a Record, a traced run of each cell
prints exactly the metrics its cells list, and a program without the
tracer reads nothing and does not raise."""
import json
import sys

import pytest

from perfbench.harness import manifest
from perfbench.harness.program import Port
from perfbench.harness.record import Hooks, Record, resolve
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import run_small, small_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = ["exec.enqueue_ms_per_query", "exec.sync_wait_ms_per_query", "exec.lane_fill_share",
           "plan.distinct_ms_per_query", "serve.engine_ms_per_dispatch"]
CELLS = ["urand18-q1-warm", "ssb10-q33-warm", "ssb10-q33-cold", "urand18-serve-zipf"]


def reader(name):
    return manifest.module(ROOT / "perfbench" / "metrics" / f"{name}.py", f"reader_{name}")


@pytest.mark.parametrize("name", READERS)
def test_counters_resolve_to_the_port_tracer(name):
    from repro_torch.core.trace import TRACE

    for target in reader(name).COUNTERS.values():
        owner, attr = resolve(target)
        value = getattr(owner, attr)
        assert isinstance(value, int) and value >= 0
        path = target.split(":")[1].split(".")[1:]
        want = TRACE
        for p in path:
            want = getattr(want, p)
        assert value == want


@pytest.mark.parametrize("name", READERS)
def test_read_on_a_record(name):
    r = reader(name)
    rec = Record(completed=4)
    assert r.read(rec) is None  # nothing moved: nothing to read
    for key in r.COUNTERS:
        rec.add(key, 8_000_000)
    got = r.read(rec)
    # 8 ms over 4 queries; over 8,000,000 dispatches; 8,000,000 lanes of as many
    want = {"exec.lane_fill_share": 1.0, "serve.engine_ms_per_dispatch": 1e-6}
    assert got == pytest.approx(want.get(name, 2.0))


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_prints_the_cells_metrics(workload):
    result, _checks, _rec = run_small(small_cell(workload), Port("cpu"), seconds=0.5,
                                      traced=True)
    listed = {m["name"] for m in BENCH["per_layer"]
              if m["name"] in READERS and workload in m["workloads"]}
    assert listed and {k for k in result["metrics"] if k in READERS} == listed
    share = result["metrics"].get("exec.lane_fill_share")
    assert share is None or 0 < share["value"] <= 1


def test_a_program_without_the_tracer_reads_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.core.trace", None)  # import fails
    readers = [reader(n) for n in READERS]
    rec = Record(completed=3)
    with Hooks(readers, rec):
        pass
    assert all(v == 0 for v in rec.counters.values())
    assert all(r.read(rec) is None for r in readers)
