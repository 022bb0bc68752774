"""Answers completed in the window over the window's seconds. Host clock."""


def read(run):
    return run.completed / run.window_s if run.window_s > 0 and run.completed else None
