#!/usr/bin/env python3
"""The LM dry-run's records as one markdown table, both meshes side by side.

Run from the repository root after `python -m repro_torch.launch.dryrun
--all` and `--all --multi-pod` have written their records:

    python3 tools/dryrun_table.py [--dir build/dryrun]

One row per (arch, shape); each column holds "single pod / multi-pod":
per-device flops and bytes accessed, collective bytes by kind (all-gather,
all-reduce, reduce-scatter, all-to-all), the arguments plus the
temporaries (at microbatches=8 for a train cell) in GB beside the H100's
80 GB, the dominant roofline term and the useful-compute ratio from
repro_torch.launch.roofline.analyse. Skipped and failed cells get a row
saying so. Nothing here is measured: the records count fake tensors, and
the roofline divides them by H100 data-sheet rates.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.launch.roofline import analyse, load  # noqa: E402

KINDS = (("all-gather", "AG"), ("all-reduce", "AR"), ("reduce-scatter", "RS"),
         ("all-to-all", "A2A"))


def _e(x: float) -> str:
    return f"{x:.2e}"


def _gb(rec) -> str:
    """Arguments plus temporaries in GB: the microbatches=8 temporaries for
    a train cell (its production config), else the step's."""
    temps = (rec.get("memory_mb8") or rec["memory"]).get("temp_size_in_bytes") or 0
    return f"{(rec['memory']['argument_size_in_bytes'] + temps) / 1e9:.1f}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    recs = {mp: {(r["arch"], r["shape"]): r for r in load(args.dir, mp)} for mp in (False, True)}
    print("| cell | flops/dev | bytes/dev | collective B/dev " + " / ".join(k for _, k in KINDS)
          + " | args + temps GB (of 80) | dominant | useful |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for arch in ARCHS:
        for shape in SHAPES:
            pair = [recs[mp].get((arch, shape)) for mp in (False, True)]
            if any(r is None for r in pair):
                print(f"| {arch} {shape} | missing record | | | | | |")
                continue
            status = {r["status"] for r in pair}
            if status != {"ok"}:
                why = "; ".join(f"{r['status']}: {r.get('why', r.get('error', ''))}"[:60]
                                for r in pair)
                print(f"| {arch} {shape} | {why} | | | | | |")
                continue
            an = [analyse(r) for r in pair]
            coll = " ; ".join(" / ".join(_e(r["collective_bytes"].get(k, 0)) for k, _ in KINDS)
                              for r in pair)
            print(f"| {arch} {shape} | " + " / ".join(_e(r["flops"]) for r in pair)
                  + " | " + " / ".join(_e(r["bytes_accessed"]) for r in pair)
                  + f" | {coll} | " + " / ".join(_gb(r) for r in pair)
                  + " | " + " / ".join(a["dominant"] for a in an)
                  + " | " + " / ".join(f"{a['useful_ratio']:.3f}" for a in an) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
