#!/usr/bin/env python3
"""Where one warm (or cold) query of a benchmark cell spends the card's time.

Run from the repository root on the card:

    python3 tools/op_breakdown.py urand18-q1-warm [kron18-q1-warm ssb10-q33-cold ...]

For each cell it generates the cell's tables on the card (its dataset at
the configuration's own size, seed --seed), makes the port's relations as
the benchmark's harness does (perfbench/harness/program.Port), warms the
main query up, times 3 warm calls, and traces one more under
torch.profiler with shapes. It prints the query's plan, the warm times,
the process's peak memory so far, the device time of each kernel name,
and, per aten op and its input shapes, the device time of the kernels that
op launched itself (a copy inside `aten::index` is listed as
`aten::copy_`, with the index's shape). A session opens with throwaway
fills, since the profiler can drop a session's first device events.
In a cell whose traffic loads fresh tables (`fresh_tables`, the cold
cell) every call runs over fresh relations, the dataset's redraw as the
cold loop makes it, outside the call's time: the warm-up, the timed
calls and the traced one are cold queries.
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def breakdown(cell_name: str, seed: int, top: int = 14) -> None:
    import torch

    from perfbench.harness import manifest
    from perfbench.harness.loops import atoms_of
    from perfbench.harness.program import Port

    cell = manifest.load(ROOT, cell_name)
    t0 = time.perf_counter()
    tables = cell.dataset().generate(cell.config, seed, device="cuda")
    port = Port("cuda")
    atoms = atoms_of(cell.config, cell.config["main_query"])
    query, rels = port.query(atoms), port.relations(atoms, tables)
    cold, redrawn = bool(cell.traffic.get("fresh_tables")), itertools.count()

    def fresh():  # the next call's relations: new ones for a cold call
        if not cold:
            return rels
        return port.relations(atoms, cell.dataset().redraw(cell.config, tables, seed,
                                                           next(redrawn)))

    for _ in range(4):
        count, info = port.count(query, fresh())
    torch.cuda.synchronize()
    print(f"== {cell_name}: count {count}, set-up {time.perf_counter() - t0:.1f} s")
    print("plan", info["runner"].plan)
    warm = []
    for _ in range(3):
        call_rels = fresh()
        t = time.perf_counter()
        port.count(query, call_rels)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t)
        del call_rels
    print("cold s" if cold else "warm s", warm,
          "peak MiB", torch.cuda.max_memory_allocated() / 2**20)
    call_rels = fresh()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        lead = torch.zeros(64, dtype=torch.int16, device="cuda")
        for _ in range(8):
            lead.fill_(1)
        torch.cuda.synchronize()
        port.count(query, call_rels)
        torch.cuda.synchronize()
    kernels = defaultdict(lambda: [0.0, 0])
    ops = defaultdict(lambda: [0.0, 0, set()])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels[e.name[:90]]
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
        elif e.name.startswith("aten::") and e.kernels:
            o = ops[e.name]
            o[0] += sum(k.duration for k in e.kernels)
            o[1] += 1
            o[2].add(str(e.input_shapes)[:80])
    print(f"device total {sum(v[0] for v in kernels.values()) / 1e3:.3f} ms")
    print("-- kernels")
    for name, (us, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{us / 1e3:9.3f} ms {n:5d}  {name}")
    print("-- aten ops (device ms of the kernels each launched)")
    for name, (us, n, shapes) in sorted(ops.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{us / 1e3:9.3f} ms {n:5d}  {name:24s} {sorted(shapes)[:2]}")
    del tables, rels, call_rels, port
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=987654321987)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch

    if not torch.cuda.is_available():
        print("op_breakdown: no CUDA device visible", file=sys.stderr)
        return 2
    print(torch.__version__, torch.cuda.get_device_name())
    for name in args.cells:
        breakdown(name, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
