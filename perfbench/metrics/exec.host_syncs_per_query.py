"""Blocking host/device copies of the compiled path (core/transfers
TRANSFERS.syncs; the launch audit shows it equals the card's host
synchronizations), over the window's queries."""
COUNTERS = {"host_syncs": "repro_torch.core.transfers:TRANSFERS.syncs"}


def read(run):
    return run.per_query(run.counters.get("host_syncs"))
