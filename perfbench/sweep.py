#!/usr/bin/env python3
"""Find the highest rate an open-loop cell sustains: one set-up, then one
window at each rate in turn, each reporting its completed queries/s,
latency percentiles and the backlog (requests due and not yet retired) at
the window's middle and end. A rate whose backlog grows from the middle to
the end is past the knee. On the card, from the root of a checkout:

    python3 perfbench/sweep.py --workload urand18-serve-zipf --seed 7 --seconds 10 \\
        --rates 2000,3000,4000
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench.harness import manifest
    from perfbench.harness.loops import loop_class
    from perfbench.harness.program import Port
    from perfbench.harness.record import Record
    from perfbench.harness.stats import percentile

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.load(ROOT, args.workload)
    tables = cell.dataset().generate(cell.config, args.seed % 2**64, device="cuda")
    loop = loop_class(cell)(cell, tables, Port("cuda"), args.seed % 2**64)
    loop.setup()
    for rate in (float(r) for r in args.rates.split(",")):
        loop.rate = rate
        rec = Record()
        t = time.perf_counter()
        loop.window(rec, args.seconds)
        lat = rec.latencies_s
        print(json.dumps({
            "rate": rate, "queries_per_s": rec.completed / args.seconds,
            "p50_ms": percentile(lat, 50) * 1e3, "p95_ms": percentile(lat, 95) * 1e3,
            "p99_ms": percentile(lat, 99) * 1e3,
            "lanes_per_dispatch": (rec.counters.get("retired", 0)
                                   / max(1, rec.counters["dispatches"])),
            "backlog": rec.notes["backlog"], "lateness_ms": rec.notes["lateness_ms"],
            "wall_s": time.perf_counter() - t}), flush=True)
        checks = loop.check()
        if checks["wrong_answers"][0] or checks["missing_answers"][0]:
            print(f"sweep: rate {rate}: {checks}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
