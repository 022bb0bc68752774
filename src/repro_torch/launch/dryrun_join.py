"""Dry-run the distributed Free Join engine itself on the production mesh.

One rank's program of the HyperCube count, run for real on this process's
device inside a fake world of 256 (single pod) or 512 (multi-pod) ranks:
the tries of rank 0's fragment (built as TrieCache builds them, with the
segmented radix sort), their compiled count (`compiled.make_count_fn`;
the CUDA kernels on the card), then the two all-reduces the reference psums,
the count and the overflow flag as int32 (no sentinel reaches the caller,
as in distributed.spmd_count). The fake backend moves nothing, so the
count is rank 0's local count. Queries: the triangle and the clover.

Rank 0's fragment is `rows_per_shard` int32 rows per relation, drawn
uniformly from `--seed` over a domain of `DOMAIN` values, where no node
of either query comes near `cap` (the largest, the clover's last join,
needs about rows^3 / DOMAIN^2 = 262,144 at the default rows).

  python -m repro_torch.launch.dryrun_join [--multi-pod] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.compiled import _static_schedule, build_trie, make_count_fn
from repro_torch.core.plan import binary2fj, factor
from repro_torch.launch.mesh import fake_world, production_layout
from repro_torch.relational.schema import clover_query, triangle_query

DOMAIN = 32768


def kernel_counts() -> dict[str, int]:
    """K1-K5's and the trie build's scans' launches on the card, their
    plain versions' calls on the CPU."""
    from repro_torch.kernels import (_build, compact, csr_expand, hash_probe, intersect,
                                     radix_sort, seg_scan)

    mods = {"hash_probe": hash_probe, "csr_expand": csr_expand, "compact": compact,
            "radix_rank": radix_sort, "intersect": intersect, "digit_counts": seg_scan,
            "max_scan": seg_scan}
    return {name: getattr(m, _build.counter(name)) + _build.plain_calls[name]
            for name, m in mods.items()}


def fragment(q, rows: int, seed: int, domain: int = DOMAIN) -> dict[str, dict[str, np.ndarray]]:
    """Rank 0's columns: {alias: {var: (rows,) int32}}, uniform over domain."""
    rng = np.random.default_rng(seed)
    return {a.alias: {v: rng.integers(0, domain, rows, dtype=np.int32) for v in a.vars}
            for a in q.atoms}


def _device_ms(fn, device) -> float | None:
    """Summed device time of one call from torch.profiler's CUDA trace
    (None on the CPU or where the trace holds no device time)."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 if total_us > 0 else None


def join_cell(q, multi_pod: bool, shards: int, rows_per_shard: int, cap: int, device: str,
              seed: int, warm: int = 5, domain: int = DOMAIN) -> dict:
    """One query's record; the caller has opened the fake world."""
    from torch.distributed.tensor.debug import CommDebugMode

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fj = factor(binary2fj(q.atoms, q))
    local = make_count_fn(fj, [cap] * 4)
    level_ops = _static_schedule(fj).level_ops
    host = fragment(q, rows_per_shard, seed, domain)
    cols = {a: {v: torch.from_numpy(c).to(dev) for v, c in host[a].items()} for a in level_ops}
    # each level var's key width, as TrieCache reads it from host columns:
    # the tries' sorts take the segmented radix sort (K4)
    bits = {a: tuple(max(1, int(host[a][v].max()).bit_length())
                     for lv in lo.levels for v in lv) for a, lo in level_ops.items()}

    def step():
        tries = {a: build_trie(cols[a], lo, key_bits=bits[a]) for a, lo in level_ops.items()}
        c, ovf = local(tries)
        ovf = ovf.to(torch.int32)
        dist.all_reduce(c)
        dist.all_reduce(ovf)
        return c, ovf

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = kernel_counts()
    t0 = time.perf_counter()
    with CommDebugMode() as comm:
        c, ovf = step()
    sync()
    compile_s = time.perf_counter() - t0  # the cold call: no compiler, first launches
    launches = {k: v - before[k] for k, v in kernel_counts().items()}
    count, overflow = int(c.item()), int(ovf.item())
    times = []
    for _ in range(warm):
        t0 = time.perf_counter()
        step()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    arg_bytes = sum(t.numel() * t.element_size() for vs in cols.values() for t in vs.values())
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    comm_counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return {
        "query": str(q),
        "multi_pod": multi_pod,
        "shards": shards,
        "rows_per_shard": rows_per_shard,
        "device": str(dev),
        "compile_s": compile_s,
        "count": count,
        "overflow": overflow,
        "warm_ms": statistics.median(times),
        "device_ms": _device_ms(step, device),
        "peak_mib": None if peak is None else peak / 2**20,
        "launches": launches,
        "collectives": comm_counts,
        "collective_bytes": {"all-reduce": c.element_size() + ovf.element_size()},
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "temp_size_in_bytes": None if peak is None else peak - arg_bytes},
    }


def lower_join(multi_pod: bool = False, rows_per_shard: int = 65536, cap: int = 1 << 20,
               device: str = "cuda", *, seed: int = 0) -> list[dict]:
    """Rank 0's HyperCube count of the triangle and the clover in a fake
    world of the production mesh's size; a record per query."""
    shape, _axes = production_layout(multi_pod)
    return count_world(math.prod(shape), multi_pod, rows_per_shard, cap, device, seed)


def count_world(shards: int, multi_pod: bool, rows_per_shard: int, cap: int, device: str,
                seed: int, *, warm: int = 5, domain: int = DOMAIN) -> list[dict]:
    """lower_join's records in a fake world of `shards` ranks, the warm
    time the median of `warm` calls, the fragment drawn over `domain`."""
    out = []
    with fake_world(shards):
        for q in (triangle_query(), clover_query()):
            rec = join_cell(q, multi_pod, shards, rows_per_shard, cap, device, seed, warm, domain)
            out.append(rec)
            print(f"[ok] join dry-run {q} shards={shards} count={rec['count']} "
                  f"overflow={rec['overflow']} warm={rec['warm_ms']:.3f}ms "
                  f"cold={rec['compile_s']:.3f}s", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="build/dryrun_join.json")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device visible; pass --device cpu to run on the CPU", file=sys.stderr)
        return 2
    recs = lower_join(args.multi_pod, device=args.device, seed=args.seed)
    existing = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(existing + recs, f, indent=1)
    return 1 if any(r["overflow"] for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
