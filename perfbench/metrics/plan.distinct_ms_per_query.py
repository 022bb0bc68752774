"""Host milliseconds a query spent counting distinct column values for the
planner (np.unique on a registry miss): the port's `plan.distinct` spans,
over the window's queries."""
COUNTERS = {"trace_distinct_ns": "perfbench.harness.port_trace:TRACE.plan_distinct.ns"}


def read(run):
    ns = run.counters.get("trace_distinct_ns")
    return run.per_query(ns / 1e6) if ns else None
