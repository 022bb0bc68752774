#!/usr/bin/env python3
"""The control readings of a cell: its run with the configuration's control
(harness/control.py, the reference with one guarantee broken) in the
program's place, at the cell's own sizes and load, on each seed given. The
numbers compared read above their limits where the comparison works. The
control computes on the card where there is one (plain torch), on the
CPU otherwise.

    python3 perfbench/controls.py --workload ssb10-q33-warm --seeds 1,2,3 --seconds 10
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import cell as cell_run
    from perfbench.harness import manifest
    from perfbench.harness.control import Control

    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = manifest.load(ROOT, args.workload)
        result, checks, _rec = cell_run.run(cell, seed % 2**64, args.seconds, False,
                                            Control(cell.config["control"], device),
                                            time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cell.config["control"], "correct": result["correct"],
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
