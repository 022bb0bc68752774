"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration and a traffic mix. The configuration is its
`file` in BENCHMARK.json (configs/<config>.json), whose `dataset` names the
generator perfbench/datasets/<dataset>.py; the traffic mix is
perfbench/traffic/<traffic>.json, whose `loop` names perfbench/loops/<loop>.py
(harness/loops.py); a metric is perfbench/metrics/<name>.py. Every such part
is perfbench/<kind>/<name>.py under the checkout's root, found by name, so
adding any of them is adding files and entries: nothing here lists them.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent  # perfbench/


def module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def extension(obj, name: str, role: str):
    """`role` ("port" or "control") of perfbench/port/<name>.py under
    obj.root, bound to obj: a call of the system under test that a loop
    needs beyond harness/program.Port's. AttributeError where there is none."""
    path = Path(obj.root) / "perfbench" / "port" / f"{name}.py"
    if name.startswith("_") or not path.exists():
        raise AttributeError(name)
    fn = getattr(module(path, f"perfbench_port_{name}"), role, None)
    if fn is None:
        raise AttributeError(f"perfbench/port/{name}.py has no {role}()")
    return functools.partial(fn, obj)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]  # the metrics this cell reports untraced
    per_layer: list[dict]  # and traced
    root: Path = field(default=HERE.parent)
    _parts: dict = field(default_factory=dict, repr=False)

    def part(self, kind: str, name: str):
        """The module perfbench/<kind>/<name>.py of this cell's checkout."""
        key = (kind, name)
        if key not in self._parts:
            tag = name.replace(".", "_").replace("-", "_")
            self._parts[key] = module(self.root / "perfbench" / kind / f"{name}.py",
                                      f"perfbench_{kind}_{tag}")
        return self._parts[key]

    def dataset(self):
        """The configuration's generator, perfbench/datasets/<dataset>.py."""
        return self.part("datasets", self.config["dataset"])

    def reader(self, name: str):
        """The module of metric `name`, perfbench/metrics/<name>.py. It
        holds read(run) -> a number or None, and may declare SPANS,
        COUNTERS and KERNEL for the harness to install
        (harness/record.py)."""
        return self.part("metrics", name)


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether `cell` reports `metric`: every cell, unless it lists cells."""
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: Path, workload: str, manifest: dict | None = None) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, with its configuration
    and traffic mix read. Raises KeyError for an unknown cell."""
    bench = manifest or load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if reports(m, workload)], root=root,
    )
