"""Of the lanes expanded at lane-choice nodes, where each lane iterates
whichever of its node's covers holds the fewest keys under it, the share
that a cover other than the first listed made, over the window: the
port's counters lanes_other_cover over lanes_multi_cover
(repro_torch.core.trace). Nothing where no such node ran."""
COUNTERS = {"trace_lanes_multi_cover": "perfbench.harness.port_counters:TRACE.lanes_multi_cover",
            "trace_lanes_other_cover": "perfbench.harness.port_counters:TRACE.lanes_other_cover"}


def read(run):
    multi = run.counters.get("trace_lanes_multi_cover")
    return run.counters.get("trace_lanes_other_cover", 0) / multi if multi else None
