"""The 95th percentile of every latency of the window's queries: closed
loop, from the call to its read-back; open loop, from the request's due
time to the return of the step that retired it. Host clock."""
from perfbench.harness.stats import percentile


def read(run):
    return percentile(run.latencies_s, 95) * 1e3 if run.latencies_s else None
