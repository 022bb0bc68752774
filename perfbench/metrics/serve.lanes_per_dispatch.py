"""Requests the serving engine retired over its dispatches in the window:
how full its batches ran (of `slots`)."""


def read(run):
    d = run.counters.get("dispatches")
    return run.counters.get("retired", 0) / d if d else None
