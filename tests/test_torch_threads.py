"""The size of torch's CPU thread pool under the test runner.

In a pytest-xdist worker the root conftest.py gives torch's pool the worker's
share of the CPUs, and says the same to spawned processes through
OMP_NUM_THREADS. Without it every worker starts as many threads as the host
has CPUs, and the parallel regions of six workers wait on each other's
threads. This test stops a later module or fixture from enlarging the pool
again. Run in a single pytest process, it checks that torch's default was
left as it is."""
import os
import subprocess
import sys

import torch


def _child_threads():
    """The pool a fresh process gets under this process's environment."""
    out = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        check=True, capture_output=True, text=True, timeout=120)
    return int(out.stdout.split()[-1])


def test_torch_pool_fits_the_worker_share_of_the_cpus():
    threads = torch.get_num_threads()
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        assert threads == _child_threads()
        return
    assert threads == 1 or threads * int(workers) <= os.cpu_count()
    assert os.environ["OMP_NUM_THREADS"] == str(threads)
    assert _child_threads() == threads
