"""Size torch's CPU thread pool to each pytest-xdist worker's share of the CPUs.

Each xdist worker is its own process, and torch gives every process a pool of
as many threads as the host has CPUs. Six workers on eight CPUs would run 48
torch threads, and every parallel region would wait at its barrier for threads
that are not running. So in a worker the pool gets ``cpu_count // workers``
threads (at least one), and ``OMP_NUM_THREADS`` says the same to the processes
the tests spawn (gloo ranks, fake worlds, launch children), so that each of
them does not start a full pool either.

A single pytest process, with no workers, keeps torch's default. The JAX
reference's own thread pool is left as it is.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers is not None:
    _threads = max(1, (os.cpu_count() or 1) // int(_workers))
    os.environ["OMP_NUM_THREADS"] = str(_threads)
    import torch

    torch.set_num_threads(_threads)
