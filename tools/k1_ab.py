#!/usr/bin/env python3
"""K1 (the hash probe) from several sources, timed in turns on one NVIDIA GPU.

Run from the repository root on the card, e.g. with the parent commit
unpacked into build/parent (git archive):

    python3 tools/k1_ab.py \\
        --tree old=build/parent/src/repro_torch/kernels/csrc/hash_probe.cu \\
        --tree new=src/repro_torch/kernels/csrc/hash_probe.cu --order old,new,new,old

Each `--tree LABEL=FILE` is a version of hash_probe.cu with the same C
launcher (tools/k1_variants/ holds the measured alternatives). All are
compiled at once by the port's own build (kernels/_build.compile_sources,
csrc/ on the include path) into build/k1_ab/, ptxas' register, spill and
shared-memory lines are printed per tree, and each tree is launched
through the port's wrapper, hash_probe.hash_probe, with its library swapped in
(_build.use_library).

The inputs are chip_smoke.py's: its K1 edge cases (among them the
hand-built corners of the probe's contract, hash_probe_corners, at widths
1 to 5, `slots` also one element into its storage), the main path's
largest K1 input (chip_smoke.main_path: LSQB q1 at SF 10 and the
6,000,000-row star), the star's probe of its largest table, the largest
K1 call of one eager free_join of q1, and of chip_smoke's eager path
(chip_smoke.eager_path) the first call in the power-of-two size bucket of
its median call and in the buckets nearest 2^15, 2^18 and 2^20 query rows (the
spread of its calls is printed). Every tree's
output on every input must equal hash_probe_plain's, or the run fails.
The inputs are saved to build/k1_ab_inputs.pt; `--inputs FILE` times
saved ones instead, `--only NAMES` some of them. Then, in a child process
for each timed input (a long-lived process's profiler sessions lose
events), each tree in --order is timed 3 times warm and 3 times cold
(chip_smoke.spread: torch.profiler device time of 20 calls, cold ones
behind a write of twice the L2), and a `k1_ab:` JSON line per input and
turn gives the min/median/max ms, the query stream's bytes over
the cold median (GB/s), the mean probe steps a lane and the share of dead
(-1) lanes. The last lines give each tree's warm and cold medians, one a
turn, and the card's name and power limit; everything is also written to
--out. It fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts the repository's src/ on the path)


def parse_tree(spec: str) -> tuple[str, Path]:
    label, _, src = spec.partition("=")
    if not label or not src.endswith(".cu"):
        raise SystemExit(f"k1_ab: --tree wants LABEL=FILE.cu, got {spec!r}")
    return label, Path(src)


def build(trees) -> dict:
    """Compile each tree's source (all nvcc processes at once); returns
    label -> its library's path."""
    from repro_torch.kernels import _build

    out_dir = ROOT / "build" / "k1_ab"
    libs = {label: out_dir / f"lib{label}.so" for label, _src in trees}
    logs = _build.compile_sources({label: (src, libs[label]) for label, src in trees},
                                  verbose=True)
    for label, log in logs.items():
        for kernel, line in chip_smoke.ptxas_report(log):
            print(f"build: {label}: {kernel}: {line}", flush=True)
    return libs


def inputs(seed: int) -> tuple[dict, dict]:
    """(edge cases, timed): name -> (slots, keys, queries, budget) on the card."""
    import numpy as np
    import torch
    from repro_torch.core import free_join

    edges = {f"edge case {i}": args
             for i, args in enumerate(chip_smoke.edge_cases("cuda")["hash_probe"])}
    sync = torch.cuda.synchronize
    workloads = chip_smoke.main_path("cuda", seed, sf=10, star_n=6_000_000, star_dom=300_000,
                                     sync=sync)
    timed = {"main": chip_smoke.capture_main_path_inputs(workloads)["hash_probe"],
             "star_small": chip_smoke.capture_star_probe(workloads)}
    with chip_smoke.capture_largest() as seen:
        free_join(*workloads[:2], device="cuda")
    timed["eager_q1"] = seen["hash_probe"][1]

    # the whole eager path's K1 calls: every size, and the first call of
    # each power-of-two size bucket, cloned
    sizes, first = [], {}

    def record(name, args) -> bool:
        if name == "hash_probe":
            rows = args[2].shape[0]
            sizes.append(rows)
            first.setdefault(rows.bit_length(), tuple(
                a.clone() if isinstance(a, torch.Tensor) else a for a in args))
        return False

    ref = chip_smoke.eager_oracles(seed, workloads, sync)
    with chip_smoke.capture_largest(record):
        chip_smoke.eager_path("cuda", seed, workloads, ref, sync)
    sizes = np.sort(sizes)
    pct = {p: int(np.percentile(sizes, p, method="lower")) for p in (50, 90)}
    print(f"k1_ab: the eager path makes {sizes.size} K1 calls, query rows min {sizes[0]} "
          f"p50 {pct[50]} p90 {pct[90]} max {sizes[-1]}; calls a power-of-two bucket "
          + json.dumps({f"<{1 << b}": int(((sizes >> (b - 1)) == 1).sum()) if b else
                        int((sizes == 0).sum()) for b in sorted(first)}), flush=True)
    timed["eager_p50"] = first[pct[50].bit_length()]
    for target in (15, 18, 20):  # mid-size calls: the buckets nearest 2^15, 2^18, 2^20 rows
        b = min((b for b in first if b > 10), key=lambda b: abs(b - target), default=None)
        if b is not None:
            timed[f"eager_2^{b - 1}"] = first[b]
    return edges, timed


def step_stats(steps, queries) -> dict:
    """How the probe steps (chip_smoke.probe_reach's, one a query row)
    spread over the lanes: quantiles, the dead lanes' mean, and the mean
    over groups of 32 and 128 consecutive rows of the group's largest (a
    warp's steps at one and four rows a thread)."""
    steps = steps.float()
    dead = queries[:, 0] == -1
    out = {f"p{q}": float(steps.quantile(q / 100)) for q in (50, 90, 99)}
    out["max"] = float(steps.max())
    out["dead_mean"] = float(steps[dead].mean()) if bool(dead.any()) else None
    for g in (32, 128):
        n = steps.numel() // g * g
        out[f"group{g}_max_mean"] = (float(steps[:n].view(-1, g).max(dim=1).values.mean())
                                     if n else None)
    return out


def check(libs, cases) -> None:
    """Every tree's output on every case equals hash_probe_plain's."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_probe import hash_probe, hash_probe_plain

    for name, args in cases.items():
        want = hash_probe_plain(*args)
        for label, lib in libs.items():
            _build.use_library("hash_probe", lib)
            got = hash_probe(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                chip_smoke.fail(f"k1_ab: {label} differs from hash_probe_plain on {name} "
                                f"in {bad} of {want.numel()} rows")
        print(f"k1_ab: every tree exact on {name} {[list(a.shape) for a in args[:3]]}",
              flush=True)


def time_turns(a, libs, order, facts) -> list[dict]:
    """Each tree of `order` timed in turn on input `a`: 3 times warm and 3
    times cold (chip_smoke.spread). `facts` (input name, probe steps a
    lane, ...) go into every record."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.hash_probe import hash_probe

    records = []
    for turn, label in enumerate(order):
        _build.use_library("hash_probe", libs[label])
        warm = chip_smoke.spread(lambda: hash_probe(*a), 20, 3, cold=False)
        cold = chip_smoke.spread(lambda: hash_probe(*a), 20, 3, cold=True)
        rec = {**facts, "turn": turn, "label": label, "warm": warm, "cold": cold,
               "stream_GBps_cold": facts["stream_bytes"] / cold["median"] / 1e6}
        records.append(rec)
        print("k1_ab: " + json.dumps(rec), flush=True)
    return records


def child(plan_file: str) -> int:
    """One input's turns in a process of its own (a long-lived process's
    profiler sessions lose events, see chip_smoke.profiled)."""
    import torch

    plan = json.loads(Path(plan_file).read_text())
    a = torch.load(plan["inputs"], weights_only=False)["timed"][plan["facts"]["input"]]
    records = time_turns(a, plan["libs"], plan["order"], plan["facts"])
    Path(plan["out"]).write_text(json.dumps(records))
    print("k1_ab child profiler: " + json.dumps(chip_smoke.PROFILE_STATS), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", help="LABEL=FILE.cu")
    ap.add_argument("--order", help="comma-separated labels, timed in turn")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inputs", help="time the inputs an earlier run saved here, not new ones")
    ap.add_argument("--only", help="comma-separated names of the timed inputs to time")
    ap.add_argument("--out", default=str(ROOT / "build" / "k1_ab.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("k1_ab: no CUDA device visible", file=sys.stderr)
        return 2
    if args.child:
        return child(args.child)
    if not args.tree or not args.order:
        raise SystemExit("k1_ab: --tree and --order are required")
    trees = [parse_tree(s) for s in args.tree]
    order = args.order.split(",")
    if unknown := set(order) - {label for label, _s in trees}:
        raise SystemExit(f"k1_ab: --order names no tree {sorted(unknown)}")
    t0 = time.perf_counter()
    libs = build(trees)
    print(f"k1_ab: built {len(libs)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    saved = Path(args.inputs) if args.inputs else ROOT / "build" / "k1_ab_inputs.pt"
    if args.inputs:
        data = torch.load(saved, weights_only=False)
        edges, timed = data["edges"], data["timed"]
    else:
        edges, timed = inputs(args.seed)
        torch.save({"edges": edges, "timed": timed}, saved)
    if args.only:
        timed = {name: timed[name] for name in args.only.split(",")}
    check(libs, edges)
    check(libs, timed)

    records = []
    for name, a in timed.items():
        queries = a[2]
        steps, reached = chip_smoke.probe_reach(*a)
        print(f"k1_ab: {name} steps " + json.dumps(step_stats(steps, queries)), flush=True)
        q = queries.shape[0]
        facts = {"input": name, "shape": [list(x.shape) for x in a[:3]],
                 "stream_bytes": queries.numel() * 4 + 4 * q,
                 "steps_per_lane": int(steps.sum()) / q, "reached_table_bytes": reached,
                 "dead_lanes": int((queries[:, 0] == -1).sum()) / q}
        plan, part = ROOT / "build" / "k1_ab_plan.json", ROOT / "build" / "k1_ab_part.json"
        plan.write_text(json.dumps({"inputs": str(saved), "libs": {k: str(v) for k, v in
                                                                   libs.items()},
                                    "order": order, "facts": facts, "out": str(part)}))
        rc = subprocess.run([sys.executable, __file__, "--child", str(plan)], cwd=ROOT,
                            timeout=900).returncode
        if rc != 0:
            chip_smoke.fail(f"k1_ab: the timing child of {name} exited {rc}")
        records += json.loads(part.read_text())
    summary = {f"{name} {label}": {kind: [r[kind]["median"] for r in records
                                          if r["input"] == name and r["label"] == label]
                                   for kind in ("warm", "cold")}
               for name in timed for label in dict.fromkeys(order)}
    card = chip_smoke.card_line()
    print("k1_ab summary: " + json.dumps(summary), flush=True)
    print(f"card: {card}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "trees": [[lb, str(s)] for lb, s
                                                                  in trees],
                                          "order": order, "records": records,
                                          "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
