"""Of the key columns the compiled executor's probes handed K1 (group ids
included, each weighted by its rows), the share copied into the probe's
key block before K1 read it, over the window: the port's counters
key_cols_copied over key_cols_in_place + key_cols_copied
(repro_torch.core.trace). The rest K1 read where the gathers that made
the frontier wrote them. Nothing where the program lacks the counters."""
COUNTERS = {"trace_key_cols_in_place": "perfbench.harness.port_counters:TRACE.key_cols_in_place",
            "trace_key_cols_copied": "perfbench.harness.port_counters:TRACE.key_cols_copied"}


def read(run):
    copied = run.counters.get("trace_key_cols_copied", 0)
    total = run.counters.get("trace_key_cols_in_place", 0) + copied
    return copied / total if total else None
