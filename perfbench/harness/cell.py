"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line."""
from __future__ import annotations

import gc
import time
import warnings

from perfbench.harness import bounds, manifest, trace
from perfbench.harness.loops import loop_class
from perfbench.harness.record import Hooks, Record, resolve

STRETCH_S = 2.0  # traced stretch of the window, at most this or a quarter of it


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, program,
        t0: float) -> tuple[dict, dict, Record]:
    """Run `cell` once against `program` (harness/program.Port on the card,
    or a stand-in). t0: the process's start on the host clock. Returns
    (the result line without its device and checks, the checks: name ->
    (value, limit or None), the run's Record)."""
    cuda = program.device == "cuda"
    if cuda:
        import torch

        sync = torch.cuda.synchronize
        warnings.filterwarnings("ignore", message="Profiler clears events")
    else:
        sync = None
    phases = {"start": time.perf_counter() - t0}
    tables = cell.dataset().generate(cell.config, seed, device=program.device)
    phases["generate"] = time.perf_counter() - t0
    loop = loop_class(cell)(cell, tables, program, seed)
    phases["relations"] = time.perf_counter() - t0
    loop.setup(seconds)
    if sync:
        sync()
    phases["warm_up"] = time.perf_counter() - t0
    rec = Record()
    rec.notes["setup_phases_s"] = phases
    metrics = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: cell.reader(m["name"]) for m in metrics}
    stretch = None
    if traced and cuda:
        trace.markers()  # the marker kernels are named before the window opens

        def stretch(iterate):
            rec.stretch = trace.stretch(iterate, min(STRETCH_S, seconds / 4))
            return rec.stretch.window_s
    # The set-up's garbage is not the window's to collect, and what imports
    # and set-up made lives for the whole run: frozen out of later full
    # collections, as a serving process does after start-up. Unfrozen, one
    # full collection stalls a step for 130-180 ms on the card's host (and
    # 50-80 ms frozen), and one such stall can decide a window's p95.
    gc.collect()
    gc.freeze()
    rec.setup_s = time.perf_counter() - t0
    if traced:
        with Hooks(readers.values(), rec, sync=sync):
            loop.window(rec, seconds, stretch)
    else:
        loop.window(rec, seconds, stretch)
    if cuda:
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    kernels = {r.KERNEL["wrapper"]: r.KERNEL for r in readers.values() if hasattr(r, "KERNEL")}
    if traced and cuda and kernels:
        wrappers = {w: (*resolve(w), spec["hold"]) for w, spec in kernels.items()}
        launches, _ = trace.bracketed(loop.one_more, wrappers)
    loop.release()
    if traced and cuda and kernels:  # bounds once the program's state is freed
        rec.launches = {w: [(bounds.seconds(*kernels[w]["work"](held)), dev) for held, dev in calls]
                        for w, calls in launches.items()}
        del launches
    checks = loop.check()
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    wrong = sum(v for k, (v, limit) in checks.items() if limit is not None)
    correct = all(v <= limit for v, limit in checks.values() if limit is not None)
    result = {"correct": bool(correct), "attempted": int(rec.attempted),
              "failed": int(wrong), "metrics": values, "device": {}}
    if traced and rec.stretch is not None:
        result["breakdown"] = {"device_ops": rec.stretch.ops, "idle_gaps": rec.stretch.gaps}
    result["notes"] = {**rec.notes, "window_s": rec.window_s, "completed": rec.completed}
    return result, checks, rec
