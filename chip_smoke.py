#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):
  1. Build: compile the four CUDA kernels (K1-K4) from src/repro_torch/
     kernels/csrc, one nvcc each, in parallel; print ptxas's register and
     spill lines.
  2. Main path: repro_torch.core.compiled_free_join on the card, with the
     kernels' launch counters set to 0 just before and read just after:
     LSQB q1 (the triangle over `knows` at SF 10: 1,800,200 rows, 300,100
     persons) with agg="count" and agg=None, and the low-selectivity star
     (n = 6,000,000, dom = 300,000, sel = 0.02) with agg="count". Each runs
     cold, then warm; the warm call must build no trie and retry nothing.
     Results are held against independent numpy oracles, and every kernel
     must have launched.
  3. Kernel parity: each kernel against its plain PyTorch version on the
     card, on inputs captured from the main path plus edge cases (a ragged
     size, a one-row table, all -1 lanes, total = 0). Equality is exact:
     every output is an integer (tolerance 0).
  4. Where a cold call's time goes: plan choice, uploads + trie builds,
     and the adaptive run, timed separately on fresh relation objects.
  5. Timing: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call, as device time from
     torch.profiler after warm-up, beside the least time the card could
     take (bound); CUDA-event wall times per call beside them.

The last line is {"ok": true, "device": {...}}; the line before it the
`kernels` JSON record, and before that the card's name and power limit.
It needs one card, and fails when there is none.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): device memory rate, and the float32
# rate outside the tensor cores, the listed rate closest to the kernels'
# int32 compare-and-select work (no int32 rate is listed).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

KERNELS = {
    # name: (module, source, the Pallas kernel it replaces)
    "hash_probe": ("hash_probe", "src/repro_torch/kernels/csrc/hash_probe.cu",
                   "src/repro/kernels/hash_probe.py:49"),
    "csr_expand": ("csr_expand", "src/repro_torch/kernels/csrc/csr_expand.cu",
                   "src/repro/kernels/csr_expand.py:27"),
    "compact": ("compact", "src/repro_torch/kernels/csrc/compact.cu",
                "src/repro/kernels/compact.py:29"),
    "radix_rank": ("radix_sort", "src/repro_torch/kernels/csrc/radix_rank.cu",
                   "src/repro/kernels/radix_sort.py:60"),
}


def fail(msg: str):
    raise RuntimeError(msg)


def kernel_modules():
    import importlib

    return {k: importlib.import_module(f"repro_torch.kernels.{m}")
            for k, (m, _s, _r) in KERNELS.items()}


# ---------------------------------------------------------------------------
# oracles (numpy, independent of the port)
# ---------------------------------------------------------------------------


def triangle_oracle(a: np.ndarray, b: np.ndarray):
    """Bag triangles of knows(a,b), knows(b,c), knows(c,a): enumerate the
    row-level 2-paths (a,b,c) and count the closing edges (c,a) of each.
    Returns (count, rows (M, 3) with multiplicity expanded)."""
    order = np.argsort(a, kind="stable")
    a_s, b_s = a[order], b[order]
    lo = np.searchsorted(a_s, b, "left")
    cnt = np.searchsorted(a_s, b, "right") - lo
    first = np.repeat(np.arange(len(a)), cnt)
    offs = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    pa, pb, pc = a[first], b[first], b_s[lo[first] + offs]
    width = int(max(a.max(), b.max())) + 1
    ekeys, ecount = np.unique(a * width + b, return_counts=True)
    want = pc * width + pa
    pos = np.clip(np.searchsorted(ekeys, want), 0, len(ekeys) - 1)
    close = np.where(ekeys[pos] == want, ecount[pos], 0)
    rows = np.repeat(np.stack([pa, pb, pc], axis=1), close, axis=0)
    return int(close.sum()), rows, int(cnt.sum())


def star_oracle(rels, dom: int) -> int:
    cnt = [np.bincount(rels[a].columns["y"], minlength=dom).astype(np.int64) for a in "RST"]
    return int((cnt[0] * cnt[1] * cnt[2]).sum())


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------


def main_path(device: str, seed: int, sf: float, star_n: int, star_dom: int, sync):
    """Drive compiled_free_join cold and warm over the two workloads, each
    result held against its numpy oracle. Returns the workloads."""
    from repro_torch.core import TRIE_CACHE, ExecOptions, compiled_free_join
    from repro_torch.core.api import materialize
    from repro_torch.relational.datagen import lowsel_star, lsqb_knows, lsqb_q1

    # knows takes seed + 1: at --seed 0 that is the reference benchmark's
    # own default seed for the LSQB tables
    knows = lsqb_knows(sf=sf, seed=seed + 1)
    q1, q1_rels = lsqb_q1(knows)
    star, star_rels = lowsel_star(n=star_n, dom=star_dom, sel=0.02, seed=seed)
    t0 = time.perf_counter()
    tri_count, tri_rows, two_paths = triangle_oracle(knows.columns["a"], knows.columns["b"])
    star_count = star_oracle(star_rels, star_dom)
    print(f"data: knows {knows.num_rows} rows, {two_paths} row-level 2-paths; star R "
          f"{star_rels['R'].num_rows} S {star_rels['S'].num_rows} T {star_rels['T'].num_rows} "
          f"rows; numpy oracles {time.perf_counter() - t0:.3f} s", flush=True)
    opts = ExecOptions(device=device)
    runs = [
        ("q1_triangle", q1, q1_rels, "count"),
        ("q1_triangle", q1, q1_rels, None),
        ("star_lowsel", star, star_rels, "count"),
    ]
    for name, q, rels, agg in runs:
        rec = {"query": name, "agg": agg}
        retries = 0
        for phase in ("cold", "warm"):
            builds, info = TRIE_CACHE.builds, {}
            t = time.perf_counter()
            out = compiled_free_join(q, rels, agg=agg, options=opts, info=info)
            sync()
            rec[f"{phase}_s"] = time.perf_counter() - t
            rec[f"{phase}_builds"] = TRIE_CACHE.builds - builds
            rec[f"{phase}_retries"] = info["retries"] - retries
            retries = info["retries"]
            if agg == "count":
                want = tri_count if name == "q1_triangle" else star_count
                if out != want:
                    fail(f"{name} {phase}: count {out} != oracle {want}")
                rec["count"] = out
            else:
                bound, mult = out
                cols = materialize(bound, mult, q.head)
                got = sorted_rows(np.stack([cols[v] for v in q.head], axis=1))
                if got.shape != tri_rows.shape or not np.array_equal(got, sorted_rows(tri_rows)):
                    fail(f"{name} {phase}: {len(got)} rows differ from the oracle's "
                         f"{len(tri_rows)}")
                rec["rows"] = len(got)
        rec["plan"] = str(info["cap_plan"])
        rec["compiles"] = info["compiles"]
        if rec["warm_builds"] or rec["warm_retries"]:
            fail(f"{name} agg={agg}: warm call built {rec['warm_builds']} tries, "
                 f"retried {rec['warm_retries']} times")
        print("main path: " + json.dumps(rec), flush=True)
    return q1, q1_rels, star, star_rels, opts


# ---------------------------------------------------------------------------
# phase 3: kernel inputs from the main path, parity
# ---------------------------------------------------------------------------


@contextmanager
def capture_largest():
    """Record (cloned) the largest call of each kernel wrapper made while
    the context is open, at the sites the main path calls them from; an
    expansion's size is its capacity times its search depth."""
    import torch
    from repro_torch.kernels import ops, radix_sort

    seen: dict[str, tuple] = {}

    def wrap(owner, attr, name, size_of):
        orig = getattr(owner, attr)

        def recorder(*args):
            size = size_of(*args)
            if name not in seen or size > seen[name][0]:
                seen[name] = (size, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                          for a in args))
            return orig(*args)

        setattr(owner, attr, recorder)
        return owner, attr, orig

    patched = [
        wrap(ops, "hash_probe", "hash_probe", lambda s, k, q, b: q.shape[0]),
        wrap(ops, "csr_expand", "csr_expand", lambda s, b, t, c: c * s.shape[0].bit_length()),
        wrap(ops, "compact", "compact", lambda c, live, cap: cap),
        wrap(radix_sort, "radix_rank", "radix_rank", lambda c, kd, kt: kd.shape[0]),
    ]
    try:
        yield seen
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)


def capture_main_path_inputs(workloads):
    """One more warm call of each query (probe, expand, compact) and one
    cold sort of the largest relation's levels (radix rank), with the
    kernels' largest inputs recorded."""
    from repro_torch.core import compiled_free_join
    from repro_torch.core.compiled import build_trie, device_columns, _LevelOps

    q1, q1_rels, star, star_rels, opts = workloads
    with capture_largest() as seen:
        compiled_free_join(q1, q1_rels, agg="count", options=opts)
        compiled_free_join(star, star_rels, agg="count", options=opts)
        rel = q1_rels["K1"]
        bits = tuple(max(1, int(rel.columns[v].max()).bit_length()) for v in ("a", "b"))
        build_trie(device_columns(rel, opts.device), _LevelOps((("a",), ("b",)), (True, False)),
                   key_bits=bits)
    return {name: args for name, (_size, args) in seen.items()}


def edge_cases(device):
    """Per kernel, inputs the main path may not reach: ragged sizes, a
    one-row table, all -1 query lanes, and total/live = 0."""
    import torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
    one = ops.build_table(t([[5, 9]]))
    many = ops.build_table(t(np.unique(rng.integers(0, 1 << 20, (3000, 2)), axis=0)))
    ragged_q = np.vstack([np.asarray(many.keys.cpu())[:500], rng.integers(0, 1 << 20, (533, 2))])
    cases = {
        "hash_probe": [
            (one.slots, one.keys, t([[5, 9], [9, 5], [-1, 9]]), 32),
            (many.slots, many.keys, t(np.full((1033, 2), -1)), 32),
            (many.slots, many.keys, t(ragged_q), 32),
        ],
    }
    counts = rng.integers(0, 5, 777)
    cum = np.cumsum(counts)
    starts, base = t(cum - counts), t(rng.integers(0, 10**6, 777))
    cases["csr_expand"] = [
        (starts, base, t([int(cum[-1])]), 1500),
        (starts, base, t([0]), 1037),
        (t([0]), t([3]), t([5]), 1024 + 5),
    ]
    valid = rng.random(3001) < 0.3
    csum = np.cumsum(valid)
    cases["compact"] = [
        (t(csum), t([int(csum[-1])]), 1000 + 11),
        (t(np.zeros(513)), t([0]), 1024),
        (t([1]), t([1]), 3),
    ]
    digit = rng.integers(0, 16, 1013)
    rcsum = np.cumsum(np.arange(16)[:, None] == digit[None, :], axis=1)  # digit-major
    cases["radix_rank"] = [
        (t(rcsum), t(digit), t(rng.integers(0, 70, 1013))),
        (t(rcsum[:, :1]), t([digit[0]]), t([1])),
    ]
    return cases


def plain_of(mods, name):
    return getattr(mods[name], f"{name}_plain")


def wrapper_of(mods, name):
    return getattr(mods[name], name)


def as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def max_abs_err(got, want) -> int:
    errs = [int((g.long() - w.long()).abs().max()) if g.numel() else 0
            for g, w in zip(as_list(got), as_list(want))]
    return max(errs)


def parity(mods, captured, device):
    """Exact equality of each kernel and its plain version, on the main
    path's inputs and the edge cases. Returns name -> max abs error on
    the main path's inputs."""
    errors = {}
    cases = edge_cases(device)
    for name in KERNELS:
        if name not in captured:
            fail(f"{name}: the main path gave it no input to compare on")
        for i, args in enumerate([captured[name]] + cases[name]):
            got = wrapper_of(mods, name)(*args)
            want = plain_of(mods, name)(*args)
            shapes_ok = all(g.shape == w.shape and g.dtype == w.dtype
                            for g, w in zip(as_list(got), as_list(want)))
            err = max_abs_err(got, want) if shapes_ok else None
            if err != 0:
                fail(f"{name}: kernel differs from its plain version on case {i} (err {err})")
            if i == 0:
                errors[name] = err
        print(f"parity: {name} exact on the main path's input and "
              f"{len(cases[name])} edge cases", flush=True)
    return errors


# ---------------------------------------------------------------------------
# phase 4: timing and bounds
# ---------------------------------------------------------------------------


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Per-call time between CUDA events around `iters` calls after
    warm-up. For a kernel of a few microseconds this is the host's enqueue
    rate (Python wrapper, ctypes), not the kernel's duration."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> tuple[float, str]:
    """Per-call device time: the summed durations of every kernel (and
    device copy or fill) the call ran, from torch.profiler's CUDA trace.
    Returns (ms, timer). Where the trace holds no device time, the time
    between CUDA events (wall_ms) stands in, and `timer` says so."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    if total_us <= 0:
        return wall_ms(fn, iters, warmup), "cuda_events"
    return total_us / iters / 1e3, "profiler_device_time"


def probe_steps(slots, keys, queries, budget) -> int:
    """Linear-probing steps this run's queries take (each lane stops at
    its first hit or empty slot): the data-dependent work of K1."""
    import torch
    from repro_torch.kernels.hash_probe import mix32

    h = (mix32(queries) & (slots.shape[0] - budget - 1)).long()
    done = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    steps = torch.zeros((), dtype=torch.int64, device=h.device)
    for p in range(budget):
        steps += (~done).sum()
        cand = slots[h + p]
        hit = (cand >= 0) & (keys[cand.clamp(min=0).long()] == queries).all(dim=-1)
        done |= hit | (cand < 0)
    return int(steps)


def bounds(name, args) -> tuple[float, float]:
    """(bytes, operations) the kernel's function needs on these inputs:
    each input read once and each output written once; operations as
    compare/select/arithmetic steps of the searches this data needs."""
    nb = lambda t: t.numel() * t.element_size()  # noqa: E731
    if name == "hash_probe":
        slots, keys, q, budget = args
        k = q.shape[1]
        steps = probe_steps(slots, keys, q, budget)
        return (nb(slots) + nb(keys) + nb(q) + 4 * q.shape[0],
                q.shape[0] * 6 * k + steps * (k + 3))
    if name == "csr_expand":
        starts, base, total, cap = args
        live = min(cap, int(total))
        return (nb(starts) + nb(base) + 4 + 8 * cap,
                live * 4 * starts.shape[0].bit_length() + cap)
    if name == "compact":
        csum, live, cap = args
        n_live = min(cap, int(live))
        return nb(csum) + 4 + 4 * cap, n_live * 4 * csum.shape[0].bit_length() + cap
    csum, kd, kt = args
    return (nb(csum) + nb(kd) + nb(kt) + 4 * kd.shape[0],
            kd.shape[0] * 4 * kd.shape[0].bit_length())


def library_call(name, args):
    """One PyTorch call computing the same function, where there is one."""
    import torch

    if name == "csr_expand":
        starts, _base, _total, cap = args
        j = torch.arange(cap, dtype=torch.int32, device=starts.device)
        return lambda: torch.searchsorted(starts, j, right=True)
    if name == "compact":
        csum, _live, cap = args
        target = torch.arange(1, cap + 1, dtype=torch.int32, device=csum.device)
        return lambda: torch.searchsorted(csum, target)
    return None


def timing(mods, captured, launches, errors):
    """Device time of each kernel, its plain version and the library call
    on the main path's largest input, beside the bound; the CUDA-event time
    per call beside them. L2 is warm: the same inputs are reused across
    the timed calls."""
    records = []
    for name, (_m, source, replaces) in KERNELS.items():
        args = captured[name]
        kernel, plain = wrapper_of(mods, name), plain_of(mods, name)
        lib = library_call(name, args)
        ms, timer = device_ms(lambda f=kernel, a=args: f(*a))
        plain_ms, _ = device_ms(lambda f=plain, a=args: f(*a), iters=5, warmup=1)
        nbytes, ops = bounds(name, args)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "parity": "exact", "max_abs_err": errors[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": device_ms(lib)[0] if lib is not None else None,
            "timer": timer,
            "wall_ms": wall_ms(lambda f=kernel, a=args: f(*a)),
            "plain_wall_ms": wall_ms(lambda f=plain, a=args: f(*a), iters=5, warmup=1),
            "shape": [list(a.shape) if hasattr(a, "shape") else a for a in args],
        })
    return records


def cold_breakdown(workloads, sync):
    """Where a cold call's time goes, layer by layer, on fresh relation
    objects (same columns, new identities, so every cache misses): plan
    choice + capacity plan (host), column uploads + trie builds (device),
    and the adaptive run with its retries and tightening (device)."""
    from repro_torch.core import TRIE_CACHE
    from repro_torch.core.api import _acquire_runner
    from repro_torch.core.compiled import _base_aliases, device_columns
    from repro_torch.relational.relation import Relation

    q1, q1_rels, star, star_rels, opts = workloads
    out = {}
    for name, q, rels in (("q1_triangle", q1, q1_rels), ("star_lowsel", star, star_rels)):
        fresh = {a: Relation(r.name, dict(r.columns)) for a, r in rels.items()}
        t0 = time.perf_counter()
        runner, _tree = _acquire_runner(q, fresh, None, agg="count", options=opts)
        t1 = time.perf_counter()
        data = {}
        for a in sorted(_base_aliases(runner.stages)):
            lo = runner._alias_lops[a]
            data[a] = TRIE_CACHE.get(fresh[a], device_columns(fresh[a], opts.device), lo,
                                     budget=opts.budget)
        sync()
        t2 = time.perf_counter()
        count = int(runner(data))
        t3 = time.perf_counter()
        out[name] = {"plan_s": t1 - t0, "upload_build_s": t2 - t1, "run_s": t3 - t2,
                     "runs": 1 + runner.retries + runner.reshapes, "count": count}
        print(f"cold breakdown: {name} " + json.dumps(out[name]), flush=True)
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    device = "cuda"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t:.3f} s (parallel nvcc)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    workloads = main_path(device, args.seed, sf=10, star_n=6_000_000, star_dom=300_000,
                          sync=torch.cuda.synchronize)
    launches = {name: m.launches for name, m in mods.items()}
    print("main path launches: " + json.dumps(launches), flush=True)
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name}: the main path never launched the kernel")

    captured = capture_main_path_inputs(workloads)
    errors = parity(mods, captured, device)
    cold_breakdown(workloads, torch.cuda.synchronize)
    kernels = timing(mods, captured, launches, errors)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
