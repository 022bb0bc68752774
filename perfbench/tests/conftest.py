"""CPU tests of the benchmark harness. Run them from the repository root:

    PYTHONPATH=src python -m pytest -q perfbench/tests

The repository's own test run (testpaths = tests) does not collect them.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
