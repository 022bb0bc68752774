"""The 95th percentile of the wait from a request's due time to the start
of the step that retired it (harness spans)."""
from perfbench.harness.stats import percentile


def read(run):
    return percentile(run.waits_s, 95) * 1e3 if run.waits_s else None
