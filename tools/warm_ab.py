#!/usr/bin/env python3
"""Warm compiled_free_join on one NVIDIA GPU, for comparing two trees.

Run from the repository root, one process per tree, alternating, e.g. with
the parent commit unpacked into build/parent (git archive):

    python3 tools/warm_ab.py --src build/parent/src --label parent
    python3 tools/warm_ab.py --src src --label change
    python3 tools/warm_ab.py --src src --label change
    python3 tools/warm_ab.py --src build/parent/src --label parent

Each process imports repro_torch from --src, builds LSQB q1 at SF 10
(`knows`, 1,800,200 rows), makes one call of compiled_free_join with
agg="count" and one with agg=None to warm them, then times `--reps` more
calls of each, each ending in torch.cuda.synchronize(), and prints one
JSON line: the label, the card's name and power limit, and per agg the
median, min and max host milliseconds. It fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("warm_ab: no CUDA device visible", file=sys.stderr)
        return 2
    from repro_torch.core import ExecOptions, compiled_free_join
    from repro_torch.relational.datagen import lsqb_knows, lsqb_q1

    q, rels = lsqb_q1(lsqb_knows(sf=10, seed=1))
    opts = ExecOptions(device="cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    out = {"label": args.label, "card": card}
    for agg in ("count", None):
        compiled_free_join(q, rels, agg=agg, options=opts)
        ms = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            compiled_free_join(q, rels, agg=agg, options=opts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        out[f"agg={agg}"] = {"median_ms": float(np.median(ms)), "min_ms": min(ms),
                             "max_ms": max(ms)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
