"""Live lanes over allocated lanes of the executor's frontier buffers (each
expansion's capacity, each compaction's target), every run of the window,
reruns included: the port's lane counters (repro_torch.core.trace)."""
COUNTERS = {"trace_lanes_live": "perfbench.harness.port_trace:TRACE.lanes_live",
            "trace_lanes_allocated": "perfbench.harness.port_trace:TRACE.lanes_allocated"}


def read(run):
    allocated = run.counters.get("trace_lanes_allocated")
    return run.counters.get("trace_lanes_live", 0) / allocated if allocated else None
