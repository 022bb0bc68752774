#!/usr/bin/env python3
"""Where K2's and K3's time goes on one NVIDIA GPU: per-block phase clocks.

Run from the repository root:  python3 tools/merge_path_phases.py [--seed 0]

Builds csr_expand.cu (K2) and compact.cu (K3) once more with
-DREPRO_LB_TRACE (load_balance.cuh: thread 0 of each block writes clock64
after each phase and globaltimer at its start and end), drives the main
path of chip_smoke.py to record the kernels' largest inputs, holds the
traced kernels exact against their plain versions there, then runs each
once and prints, for the blocks that write slots, the mean cycles of the
searches, the window copy, the merge and the writes; the blocks' lifetimes,
how many were alive at once on average, and the span from the first
block's start to the last one's end. The last lines are the `phases:`
JSON record and the card's name and power limit. The shipped libraries
are not built this way; this is a one-off measurement, not a check.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

MERGE_PATH = ("csr_expand", "compact")  # the kernels on the merge-path core
TRACE_BLOCKS = 1 << 14  # load_balance.cuh kTraceBlocks


def build_traced():
    """One nvcc for each kernel, started together; returns name -> library."""
    from repro_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in MERGE_PATH:
        out = _build.BUILD_DIR / f"lib{name}-traced.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-DREPRO_LB_TRACE", "-Xptxas", "-v",
               "-o", str(out), str(_build.CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), out)
    libs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name} (traced) failed to build:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name} (traced): {line.strip()}")
        lib = ctypes.CDLL(str(out))
        lib.lb_trace_clear.restype = lib.lb_trace_read.restype = ctypes.c_int
        lib.lb_trace_read.argtypes = (ctypes.c_void_p,)
        libs[name] = lib
    return libs


@contextmanager
def launching(name, lib):
    """Route the kernel's wrapper to the traced library while open."""
    from repro_torch.kernels import _build

    symbol, argtypes = _build._SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.repro_error_string.argtypes = (ctypes.c_int,)
    lib.repro_error_string.restype = ctypes.c_char_p
    shipped = _build.launcher(name)
    _build._launchers[name] = (fn, lib.repro_error_string)
    try:
        yield
    finally:
        _build._launchers[name] = shipped


def breakdown(name, lib, run):
    """Clear the trace, run the kernel once, summarise the blocks' marks."""
    import torch

    buf = np.zeros((TRACE_BLOCKS, 8), np.uint64)
    if lib.lb_trace_clear() != 0:
        raise RuntimeError(f"{name}: clearing the trace buffer failed")
    run()
    torch.cuda.synchronize()
    if lib.lb_trace_read(buf.ctypes.data) != 0:
        raise RuntimeError(f"{name}: reading the trace buffer failed")
    b = buf[buf[:, 5] != 0].astype(np.int64)  # the blocks that ran
    if int(b[:, 7].max()) > TRACE_BLOCKS:
        raise RuntimeError(f"{name}: {int(b[:, 7].max())} blocks, more than the trace holds")
    merged = b[:, 2] != 0
    span = int(b[:, 6].max() - b[:, 5].min())
    life = b[:, 6] - b[:, 5]

    def cycles(i, j, rows=merged):
        return float(np.mean(b[rows, j] - b[rows, i])) if rows.any() else 0.0

    return {
        "blocks": len(b), "merging_blocks": int(merged.sum()), "span_us": span / 1e3,
        "blocks_alive_mean": float(life.sum() / span),
        "merging_block_us": float(life[merged].mean()) / 1e3,
        "cycles": {"searches": cycles(0, 1), "window": cycles(1, 2),
                   "merge": cycles(2, 3), "writes": cycles(3, 4),
                   "blocks_without_slots": cycles(0, 4, ~merged)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("merge_path_phases: no CUDA device visible", file=sys.stderr)
        return 2
    libs = build_traced()
    workloads = chip_smoke.main_path("cuda", args.seed, sf=10, star_n=6_000_000,
                                     star_dom=300_000, sync=torch.cuda.synchronize)
    captured = chip_smoke.capture_main_path_inputs(workloads)
    mods = chip_smoke.kernel_modules()
    out = {}
    for name in MERGE_PATH:
        kernel, kargs = chip_smoke.wrapper_of(mods, name), captured[name]
        with launching(name, libs[name]):
            got = kernel(*kargs)
            torch.cuda.synchronize()
            if chip_smoke.max_abs_err(got, chip_smoke.plain_of(mods, name)(*kargs)) != 0:
                raise RuntimeError(f"{name} (traced build) differs from its plain version")
            out[name] = breakdown(name, libs[name], lambda k=kernel, a=kargs: k(*a))
    print("phases: " + json.dumps(out), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
