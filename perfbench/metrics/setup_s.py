"""Set-up: from the process's start to the window's first query (imports,
kernel load or build, data generation and upload, warm-up). Host clock."""


def read(run):
    return run.setup_s
