"""torch.cuda.max_memory_allocated() over set-up and window, in MiB: what a
deployment has to leave free on the card beside its data."""


def read(run):
    return run.peak_bytes / 2**20 if run.peak_bytes else None
