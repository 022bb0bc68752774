"""1 - (union of the device's operation intervals / the traced stretch's
seconds), over a steady stretch of the window (torch.profiler)."""


def read(run):
    s = run.stretch
    return 1 - s.busy_s / s.window_s if s is not None and s.window_s > 0 else None
