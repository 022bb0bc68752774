"""Host milliseconds a query spent in its blocking host/device copies: the
port's `exec.sync` spans (every read-back and upload through
core/transfers.TRANSFERS; a read-back waits for the device's queue to
drain), over the window's queries."""
COUNTERS = {"trace_sync_ns": "perfbench.harness.port_trace:TRACE.exec_sync.ns"}


def read(run):
    ns = run.counters.get("trace_sync_ns")
    return run.per_query(ns / 1e6) if ns else None
