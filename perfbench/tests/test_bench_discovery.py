"""A configuration, a traffic mix (with a loop, an arrival process or a call
of the port of its own) and a metric are added as new files plus new
entries in BENCHMARK.json, with no edit to a file the harness has."""
import json
import shutil

import pytest

from perfbench.harness.control import Control
from perfbench.harness.program import Port
from perfbench.tests.conftest import ROOT
from perfbench.tests.small import run_small, small_cell

FILES = {
    # an open mix with an arrival process of its own: on/off bursts
    "perfbench/traffic/serve-burst.json": json.dumps({
        "loop": "open", "rate_per_s": 40, "arrivals": "onoff", "on_s": 0.1, "off_s": 0.1,
        "constants": "zipf", "constants_zipf_a": 1.3, "templates": ["fof"], "tenants": 2,
        "slots": 4, "drain_s": 10}),
    "perfbench/arrivals/onoff.py": (
        "import numpy as np\n\n\n"
        "def due(n, seconds, structure, run, params):\n"
        "    on, off = params['on_s'], params['off_s']\n"
        "    t = np.sort(structure.uniform(0, seconds * on / (on + off), n))\n"
        "    return t + (t // on) * off\n"),
    # a data-only closed mix over another query
    "perfbench/traffic/warm-fof.json": json.dumps({
        "loop": "closed", "query": "fof", "fresh_tables": False, "warmup_calls": 2}),
    # a mix with a loop of its own that needs a call Port lacks: eager free_join
    "perfbench/traffic/eager.json": json.dumps({
        "loop": "eager", "query": "main", "fresh_tables": False, "warmup_calls": 1}),
    "perfbench/loops/eager.py": (
        "from perfbench.loops.closed import Loop as Closed\n\n\n"
        "class Loop(Closed):\n"
        "    def _call(self, rels):\n"
        "        import time\n"
        "        t = time.perf_counter()\n"
        "        out = self.program.eager_count(self.query, rels)\n"
        "        return out, time.perf_counter() - t, 0\n"),
    "perfbench/port/eager_count.py": (
        "def port(program, query, rels):\n"
        "    from repro_torch.core import free_join\n"
        "    return int(free_join(query, rels, agg='count', device=program.device))\n\n\n"
        "def control(control, query, rels):\n"
        "    return control.count(query, rels)[0]\n"),
    "perfbench/metrics/answers_per_s.py": (
        "def read(run):\n    return run.completed / run.window_s\n"),
}
CELLS = {"urand8-serve-burst": "serve-burst", "urand8-fof-warm": "warm-fof",
         "urand8-q1-eager": "eager"}


@pytest.fixture(scope="module")
def grown(tmp_path_factory):
    """A checkout with the new files and entries beside the harness's own."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in FILES.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_text(text)
    cfg = json.loads((ROOT / "perfbench/configs/gap-urand-s18.json").read_text())
    cfg.update(name="gap-urand-s8", scale=8)
    (root / "perfbench/configs/gap-urand-s8.json").write_text(json.dumps(cfg))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "gap-urand-s8", "source": "test",
                             "file": "perfbench/configs/gap-urand-s8.json",
                             "reduced": ["scale"], "why": "test"})
    for cell, mix in CELLS.items():
        bench["workloads"].append({"name": cell, "config": "gap-urand-s8", "traffic": mix,
                                   "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "answers_per_s", "unit": "queries/s",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "queries_per_s", "workloads": list(CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_new_cell_runs_without_edits(grown, workload, traced):
    cell = small_cell(workload, root=grown)
    assert cell.dataset().__file__.startswith(str(grown))
    result, checks, _rec = run_small(cell, Port("cpu", root=grown), traced=traced, seconds=0.5)
    assert result["correct"] and checks["wrong_answers"] == (0, 0)
    assert ("answers_per_s" in result["metrics"]) == traced
    assert ("queries_per_s" in result["metrics"]) != traced


def test_new_loop_drives_the_control_through_its_port_call(grown):
    cell = small_cell("urand8-q1-eager", root=grown)
    result, _checks, _rec = run_small(cell, Control("sampled", root=grown), seconds=0.3)
    assert not result["correct"]


def test_burst_arrivals_come_from_their_file(grown):
    from perfbench.harness.loops import loop_class

    cell = small_cell("urand8-serve-burst", root=grown)
    loop = loop_class(cell)(cell, cell.dataset().generate(cell.config, 3), Port("cpu"), 3)
    loop.plan(1.0)
    due = [r[0] for r in loop.requests]
    assert len(due) == 40 and due == sorted(due)
    assert not any(0.1 < d % 0.2 < 0.2 - 1e-9 for d in due)  # nothing due while off
