"""Tiles a query ran its first node's rows in: the count of the port's
`exec.tile` spans (repro_torch.core.trace), one a tile of a tiled call,
reruns included, over the window's queries. Nothing where no call tiled."""
COUNTERS = {"trace_tiles": "perfbench.harness.port_counters:TRACE.exec_tile.count"}


def read(run):
    n = run.counters.get("trace_tiles")
    return run.per_query(n) if n else None
