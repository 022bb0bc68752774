"""The serving engine's own host milliseconds a dispatch: the self time of
the port's `serve.step` spans (a step's queue walks, grouping and
admission, without its runner acquisition and dispatches) over the count
of its `serve.dispatch` spans, both over the traced run's window."""
COUNTERS = {"trace_step_self_ns": "perfbench.harness.port_trace:TRACE.serve_step.self_ns",
            "trace_dispatch_spans": "perfbench.harness.port_trace:TRACE.serve_dispatch.count"}


def read(run):
    dispatches = run.counters.get("trace_dispatch_spans")
    return run.counters.get("trace_step_self_ns", 0) / 1e6 / dispatches if dispatches else None
