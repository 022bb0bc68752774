import numpy as np
import pytest

from repro.relational.relation import Relation


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight model/train/serve tests, deselected by default "
        '(run them with -m slow, or everything with -m "slow or not slow")',
    )
    config.addinivalue_line(
        "markers",
        "chaos: fault-injection resilience tests (selected by default; CI "
        "also runs them standalone with -m chaos)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (skips without one; run them on the card "
        "with -m cuda tests/test_torch_cuda.py)",
    )


def pytest_collection_modifyitems(config, items):
    # No pytest.ini in this repo: default to -m "not slow" here so the
    # tier-1 suite stays fast. Any explicit -m on the command line wins.
    if config.option.markexpr:
        return
    selected, deselected = [], []
    for item in items:
        (deselected if "slow" in item.keywords else selected).append(item)
    if deselected:
        config.hook.pytest_deselected(items=deselected)
        items[:] = selected


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def rand_rel(rng, name, vars_, n, dom):
    return Relation(name, {v: rng.integers(0, dom, n) for v in vars_})
