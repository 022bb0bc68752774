"""The port's spans and counters in repro_torch.core.trace.TRACE that
metric readers added after harness/port_trace.py read, for their
COUNTERS: `perfbench.harness.port_counters:TRACE.<counter>` or
`TRACE.<span>.<total>` (a span's "." written "_"). A program without the
tracer, or with a tracer that lacks the span or counter, reads 0 on it,
so its readers find nothing to read and the traced run goes on."""
from __future__ import annotations

import importlib

from perfbench.harness.port_trace import MODULE, _Zero


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
        return getattr(trace.TRACE, name, _Zero())


TRACE = _Trace()
