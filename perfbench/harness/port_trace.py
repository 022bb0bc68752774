"""The port's own spans and lane counters (repro_torch.core.trace.TRACE),
for the metric readers' COUNTERS: `perfbench.harness.port_trace:TRACE.
<span>.<total>` (a span's "." written "_": `TRACE.exec_sync.ns`) or
`TRACE.<counter>`. A program without that tracer reads 0 on each, so its
readers find nothing to read and the traced run goes on."""
from __future__ import annotations

import importlib

MODULE = "repro_torch.core.trace"


class _Zero(int):
    """0, whose every total is 0: a span the program lacks."""

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return 0


class _Trace:
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            trace = importlib.import_module(MODULE)
        except ModuleNotFoundError as e:
            if e.name != MODULE:
                raise
            return _Zero()
        return getattr(trace.TRACE, name)


TRACE = _Trace()
