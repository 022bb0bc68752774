#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. With --trace 0 the result's metrics are the
cell's end-to-end metrics, with --trace 1 its per-layer metrics. The last
line of standard output is the result (JSON); the last lines of standard
error are the numbers compared with the reference, each beside its limit.
The run exits with 2, printing no result, without enough CUDA devices, and
with 3 if a module of the JAX stack or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout
    cache = ROOT / "build" / "perfbench-cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from perfbench.harness import cell as cell_run
    from perfbench.harness import guard, manifest

    cell = manifest.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"run: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from perfbench.harness.program import Port

    seed = args.seed % 2**64
    result, checks, rec = cell_run.run(cell, seed, args.seconds, bool(args.trace),
                                       Port("cuda"), T0)
    found = guard.banned_modules()
    if found:
        print(f"run: modules of the JAX stack or package were loaded: {found}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, "memory_peak_bytes": int(rec.peak_bytes)}
    if args.trace and rec.stretch is not None:
        result["device"].update(busy_s=rec.stretch.busy_s, window_s=rec.stretch.window_s)
    notes = result.pop("notes")
    print("run: " + json.dumps({"cell": cell.name, "seed": args.seed, **notes}), file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        print(f"check: {k} {v}" + ("" if limit is None else f" limit {limit}"), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
