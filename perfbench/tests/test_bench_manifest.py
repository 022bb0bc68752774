"""BENCHMARK.json against the contract's shape, and its files."""
import json
import re

import pytest

from perfbench.harness import manifest
from perfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer") + (("source",) if section == "configs" else ()):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if manifest.reports(m, w["name"])]
        layer = [m["name"] for m in BENCH["per_layer"] if manifest.reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer, w["name"]


def test_layer_metrics_move_what_their_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", [c["name"] for c in BENCH["workloads"]]):
            assert manifest.reports(moved, w), (m["name"], w)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_files_exist_and_configs_are_used():
    cells = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in cells
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key)
        assert (ROOT / "perfbench" / "datasets" / f"{cfg['dataset']}.py").exists()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        mix = json.loads((ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "perfbench" / "loops" / f"{mix['loop']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_command_stays_under_paths():
    cmd = BENCH["command"]
    assert len(cmd) <= 32
    for word in cmd:
        assert not word.startswith("/") and ".." not in word
    assert cmd[1].startswith("perfbench/")
