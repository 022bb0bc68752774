"""Lanes the executor's expansions made, every node and sub-run of every
run of the window, reruns included, over the window's queries: the port's
counter of expansion totals (repro_torch.core.trace TRACE.lanes_expanded).
Nothing on a program without it."""
COUNTERS = {"trace_lanes_expanded": "perfbench.harness.port_counters:TRACE.lanes_expanded"}


def read(run):
    n = run.counters.get("trace_lanes_expanded")
    return run.per_query(n) if n else None
