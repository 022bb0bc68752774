"""Host milliseconds a query spent enqueueing its device work: the port's
`exec.enqueue` spans (repro_torch.core.trace), one per call of the built
chain executor, reruns included, over the window's queries."""
COUNTERS = {"trace_enqueue_ns": "perfbench.harness.port_trace:TRACE.exec_enqueue.ns"}


def read(run):
    ns = run.counters.get("trace_enqueue_ns")
    return run.per_query(ns / 1e6) if ns else None
