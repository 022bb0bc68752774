"""Host milliseconds a query spent acquiring its runner: plan choice and
capacity plan (a span around core.api._acquire_runner), over the queries."""
SPANS = {"plan": {"target": "repro_torch.core.api:_acquire_runner"}}


def read(run):
    spans = run.spans.get("plan")
    return run.per_query(sum(spans) * 1e3) if spans else None
