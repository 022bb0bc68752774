"""The benchmark's cells at sizes a CPU test run holds."""
import time

from perfbench.harness import cell as cell_run
from perfbench.harness import manifest
from perfbench.tests.conftest import ROOT

# ten cities, so that a small lineorder still meets the star's filters
SMALL = {"gap-urand-s18": {"scale": 10},
         "ssb-sf10": {"sf": 0.1, "cities": [231, 235, 12, 47, 88, 103, 150, 177, 204, 249]}}


def small_cell(workload: str, root=ROOT, **config):
    cell = manifest.load(root, workload)
    cell.config.update(SMALL.get(cell.config["name"], {}), **config)
    if cell.traffic["loop"] == "open":
        cell.traffic["rate_per_s"] = 40
    return cell


def run_small(cell, program, seed: int = 7, seconds: float = 1.0, traced: bool = False):
    return cell_run.run(cell, seed, seconds, traced, program, time.perf_counter())
