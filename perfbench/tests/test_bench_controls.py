"""The comparison that decides `correct` fails the control (the reference
with a guarantee broken, put in the program's place) and a run whose timed
path is broken underneath, and passes the port."""
import numpy as np
import pytest

from perfbench.harness.control import Control
from perfbench.harness.program import Port
from perfbench.tests.small import run_small, small_cell

CELLS = ["urand18-q1-warm", "ssb10-q33-warm", "ssb10-q33-cold", "urand18-serve-zipf"]
# a size at which every cold query's two cities meet rows
CONTROL_SIZE = {"ssb10-q33-cold": {"sf": 1}}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    cell = small_cell(workload, **CONTROL_SIZE.get(workload, {}))
    result, checks, _rec = run_small(cell, Control(cell.config["control"]), seconds=0.3)
    assert not result["correct"] and checks["wrong_answers"][0] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_port_is_correct(workload):
    result, _checks, _rec = run_small(small_cell(workload), Port("cpu"), seconds=0.5)
    assert result["correct"] and result["failed"] == 0


def _break(monkeypatch, how):
    """The executor's results altered where they are produced."""
    from repro_torch.core.compiled import AdaptiveExecutor

    orig = AdaptiveExecutor.run_relations

    def broken(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        if isinstance(out, np.ndarray):  # a batched dispatch's lanes
            out = out.copy()
            if how == "altered":
                out[0] += 1
            else:  # half of the batch left out: its lanes get the others' answers
                half = len(out) // 2
                out[half:] = out[:len(out) - half]
            return out
        return out + 1

    monkeypatch.setattr(AdaptiveExecutor, "run_relations", broken)


@pytest.mark.parametrize("workload", CELLS)
def test_answer_altered_is_not_correct(workload, monkeypatch):
    _break(monkeypatch, "altered")
    result, checks, _rec = run_small(small_cell(workload), Port("cpu"), seconds=0.5)
    assert not result["correct"] and checks["wrong_answers"][0] > 0


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    _break(monkeypatch, "half")
    cell = small_cell("urand18-serve-zipf")
    cell.traffic["rate_per_s"] = 400  # full batches
    result, checks, _rec = run_small(cell, Port("cpu"), seconds=0.5)
    assert not result["correct"] and checks["wrong_answers"][0] > 0
