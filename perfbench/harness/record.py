"""What a run records for the metric readers (metrics/<name>.py).

A reader is a module with `read(run) -> number or None` (None: nothing to
read in this cell, and the metric is left out of the line). It may declare
what the harness installs for it in the traced run:

* SPANS = {span: {"target": "module:attr.path", "sync": bool}}: host-clock
  spans around each call of that function of the program while the window
  runs (`sync`: the device is synchronized at both ends, so the span holds
  the device work the call enqueued);
* COUNTERS = {name: "module:attr.path"}: a counter of the program, read
  before and after the window;
* KERNEL = {"wrapper": "module:attr", "hold": fn, "work": fn}: the launches
  of that kernel wrapper are bracketed in one more query after the window
  (harness/trace.bracketed); hold(args) keeps what work(held) -> (bytes,
  operations) needs, and the launch is held to that bound
  (harness/bounds.py). Its reading is under run.launches[wrapper].
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field


@dataclass
class Record:
    setup_s: float = 0.0
    window_s: float = 0.0
    completed: int = 0  # answers completed in the window
    attempted: int = 0
    latencies_s: list = field(default_factory=list)
    waits_s: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)  # deltas over the window
    spans: dict = field(default_factory=dict)  # span -> [seconds]
    peak_bytes: int | None = None
    stretch: object = None  # harness/trace.Stretch of the traced run
    launches: dict = field(default_factory=dict)  # wrapper -> [(bound s, device s)]
    notes: dict = field(default_factory=dict)

    def add(self, name: str, n: float) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def per_query(self, value):
        return value / self.completed if self.completed and value is not None else None


def resolve(target: str):
    """(owner, attribute) of "module:attr.path"."""
    module, path = target.split(":")
    owner = importlib.import_module(module)
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, attr


class Hooks:
    """The spans and counters the cell's readers declare, installed for the
    window of a traced run."""

    def __init__(self, readers, rec: Record, sync=None):
        self.rec, self.sync = rec, sync
        self.spans = {}
        self.counters = {}
        for r in readers:
            self.spans.update(getattr(r, "SPANS", {}))
            self.counters.update(getattr(r, "COUNTERS", {}))
        self._patched = []
        self._before = {}

    def _read(self, target: str):
        owner, attr = resolve(target)
        return getattr(owner, attr)

    def __enter__(self):
        for span, spec in self.spans.items():
            owner, attr = resolve(spec["target"])
            orig = getattr(owner, attr)
            had = attr in getattr(owner, "__dict__", {})
            sync = self.sync if spec.get("sync") else None
            times = self.rec.spans.setdefault(span, [])

            def timed(*args, _orig=orig, _times=times, _sync=sync, **kwargs):
                if _sync:
                    _sync()
                t = time.perf_counter()
                try:
                    return _orig(*args, **kwargs)
                finally:
                    if _sync:
                        _sync()
                    _times.append(time.perf_counter() - t)

            setattr(owner, attr, timed)
            self._patched.append((owner, attr, orig, had))
        self._before = {n: self._read(t) for n, t in self.counters.items()}
        return self

    def __exit__(self, *exc):
        for n, t in self.counters.items():
            self.rec.add(n, self._read(t) - self._before[n])
        for owner, attr, orig, had in reversed(self._patched):
            if had or not hasattr(type(owner), attr):
                setattr(owner, attr, orig)
            else:
                delattr(owner, attr)
        return False
