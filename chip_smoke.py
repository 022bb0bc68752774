#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py [--seed 0]

Phases (any failure raises, and the script exits non-zero):
  1. Build: compile the five CUDA kernels (K1-K5) from src/repro_torch/
     kernels/csrc, one nvcc each, in parallel; print ptxas's register,
     spill and shared-memory lines for each kernel function (K5 has two:
     the directory pre-pass and the search).
  2. Main path: repro_torch.core.compiled_free_join on the card, with the
     kernels' launch counters set to 0 just before and read just after:
     LSQB q1 (the triangle over `knows` at SF 10: 1,800,200 rows, 300,100
     persons) with agg="count" and agg=None, and the low-selectivity star
     (n = 6,000,000, dom = 300,000, sel = 0.02) with agg="count". Each runs
     cold, then warm; the warm call must build no trie and retry nothing.
     Results are held against independent numpy oracles, and K1-K4 must
     have launched.
  3. Streaming path (counters set to 0 before, read after; K1-K4 must
     launch): a standing LSQB q1 at SF 10 through StandingQueryEngine,
     8 ingests of 16,384 new knows edges (another seed), then a delete of
     16,384 random rows; the count equals the numpy oracle on the live
     rows after the first batch, after the delete and after a final no-op
     refresh; no trie is built after registration, each batch is one
     delta merge per cached layout, the delete tombstone refreshes; median
     and first ingest latency. The triangle count barely moves under
     these mutations, so at the end every cached trie (11 appends merged,
     one delete retired) must equal a full rebuild over the same rows,
     array for array. Then the stage replay: the reference's
     streaming workload (benchmarks/bench_streaming.py), a standing bushy
     count over a 4-chain (n = 60,000, dom = 4,000) with batches of 2,048
     R rows, 3 warm and 12 timed; after every batch the count equals a
     compiled_free_join over fresh copies and the T-U stage was replayed;
     the final count equals the numpy oracle; sustained updates and rows
     per second.
  3a. Serving path (counters set to 0 before, read after; K1-K4 must
     launch): repro_torch.serve.JoinServeEngine (slots = 16) against serial
     compiled_free_join, on the main path's `knows` at SF 10. Two
     templates, friends of friends (knows(a,b), knows(b,c), an LDBC SNB
     Interactive-style 2-hop point query) and LSQB q1's triangle, each
     with a = c; 16 tenants spell each with their own aliases and atom
     order; 256 requests alternate between the templates, constants
     Zipf(1.3)-skewed over the persons with friends (hubs recur). The
     trace is drained through the engine (mask-mode batched dispatches)
     and serially (one kill-mode compiled_free_join(filters=) a request),
     each once to warm and once timed; every result equals an independent
     numpy oracle (2-hop: the sum of out-degree(y) over c's rows;
     triangle: sorted-set intersection) and the two drains equal each
     other. Per drain: queries/s, p50/p99 latency, dispatches, K1-K5
     launches, peak MiB; degraded and faults_absorbed must be 0. For one
     warm batched dispatch of each template beside one warm unfiltered
     call: host syncs, host ms and device ms; for the triangle's, its
     device idle share and host functions (torch.profiler, cProfile).
     Then the stage replay's
     4-chain as a batched template (slots = 8) with 8 constants on e,
     bound only in the T-U stage (the per-lane path), each count held
     against chain4_oracle. The `serving:` line holds it all.
  3b. Chaos path (counters set to 0 before, read after): q1 at SF 1
     through JoinServeEngine(slots = 8), 8 requests, each case on a fresh
     runner cache: one fault of each kind armed once (compile_fail, also
     three times to reach the eager rung; device_oom; slow_dispatch with
     a 20 ms deadline on a request of the other template; overflow_storm
     on lane 2; mutation_skew), and once under a memory budget of a
     quarter of the bytes of the tries it reads. Every request is
     answered and equals the oracle (or is the one evicted / reaped
     request). Then a StandingQueryEngine(engine=...) on the triangle and
     on friends of friends of the busiest person (a count that is not
     0), with a device_oom in the refresh of each: the eager engine on
     the card answers (degraded_to "eager"), the next refresh is
     compiled again.
     The `chaos:` line holds each case's rungs and counters. After it the
     main path's queries are planned again (the serial drain's 32
     spellings fill the runner cache).
  4. Eager path (counters set to 0 before, read after; K1-K4 must launch):
     the eager engine on the card. LSQB q1 at SF 10 (the main path's
     `knows`) through free_join in modes colt, slt and simple,
     binary_join and generic_join with agg="count", and free_join with
     agg=None (rows equal to the oracle's and compiled_free_join's); the
     main path's star through free_join and binary_join; the stage
     replay's 4-chain through compiled_free_join with ExecOptions(
     chain_stages=False) (the hybrid: eager non-root stages, compiled
     root) and eager free_join; execute_tuples at batch 1000 on q1 at SF
     0.1; and free_join(agg=None) on q1 at SF 1 on the card and on the
     CPU, equal element for element. Every count equals its numpy oracle.
     Per engine: first and median host ms, peak device memory and
     launches, the compiled path's warm ms beside them (timed outside the
     count); for one eager q1 call the device idle share (torch.profiler)
     and its host synchronizations. The `eager path:` line holds them.
  4a. Analysis path (counters set to 0 before, read after; K1-K4 must
     launch): repro_torch.analysis on the card. compiled_free_join with
     ExecOptions(verify=True) on LSQB q1 at SF 10 and on the star, over
     new relation objects, cold then warm, each count equal to its numpy
     oracle; the planning pass's seconds (plan_s) beside the verifier's
     own milliseconds (lint_chain timed alone on the same chain). q1
     planned with no plan tree under JoinOrderOptimizer(debug_lint=True):
     every finalist lints clean (finalists, lint ms). The launch audit
     (trace_runner + audit_runner) of four warm runners: q1 count, q1
     agg=None, the star count and the serving phase's batched q1 template
     at 16 lanes (acquired as JoinServeEngine acquires it), each call also
     counted by sync_count; no ERROR, and the audit's host syncs equal
     sync_count's; per runner syncs, K1-K4 launches, tensor ops per
     schedule op and the upload inventory. A JoinServeEngine(slots = 16)
     rejects a query with an unbound head variable and one with an
     unknown filter variable, then serves a valid request (the top hub's
     triangle count) equal to the numpy oracle. count_query on q1 with
     the planner's capacities: equal to the oracle, no overflow. The
     corpus gate, python -m repro_torch.analysis --device cuda, in
     process: exit 0. The `analysis:` line holds it all.
  4b. Distributed path (counters set to 0 before, read after; K1 and K2
     must launch): repro_torch.core.distributed under an NCCL process
     group of one rank (FileStore under build/), with every run reduced
     through all_reduce (COLLECTIVES must move). spmd_count on LSQB q1 at
     SF 10 (the main path's `knows`) at 1, 4 and 8 shards and on the
     main path's star at 4 shards (its shares fall on y: the distributed
     hash join), planner capacities. Each runs cold over new relation
     objects (partition, shard trie builds and planning timed apart, then
     the first call) and warm over the main path's relations: a new
     SpmdCounter re-partitions nothing and builds no trie, its calls
     retry nothing; median-of-3 ms, one warm call's host syncs
     (sync_count, equal at every shard count and at most 2), its
     crossings (one read-back), K1/K2 launches (against num_shards times
     the 1-shard call's) and device ms (torch.profiler), the frontier
     one warm run needs per node, the padded fragment rows per alias
     against the mean, and peak MiB. Every count equals the numpy
     oracle, and the 1-shard count compiled_free_join's. Then
     distributed_join_host on q1 and on friends of friends (knows(a,b),
     knows(b,c): q1 at SF 1 may have no triangle) at SF 1, 8 shards, on
     the card: each count and the sorted rows equal the oracle's. The
     `distributed:` line holds it all, beside the card's name and power
     limit.
  4c. Model path (counters set to 0 before, read after; the LM stack runs
     none of K1-K5, and its `model_launches` say so): the decode serving
     stack of repro_torch.models and repro_torch.serve.DecodeServeEngine,
     eager, with TF32 off for matmuls (checked). The ten reduced configs
     in fp32 on the card against the same parameters on the CPU:
     apply_model's logits and 8 decode_steps (logits and every cache
     leaf), atol 1e-4. qwen2-1.5b whole (28 layers, d 1536, 12 heads and
     2 kv heads, d_ff 8960, vocab 151,936; 1.544 B parameters, random
     from --seed): at compute_dtype float32, a 16-token prompt's logits on
     the card and on the CPU within 2e-3; DecodeServeEngine(slots = 4,
     max_len = 256) serves 8 requests (prompts of 8-64 ids from --seed,
     max_new 16), and every emitted token is the argmax of apply_model
     over its prompt plus the tokens before it wherever that top-2 gap is
     at least 1e-3 (the others are counted as skipped), its decode logits
     the prefill's within 2e-3. Then the config's own dtypes (fp32
     weights, bf16 compute, cast once by the engine) on the same trace:
     requests, tokens, engine steps and decode calls, wall s, tokens/s,
     the median decode step; in steady state (4 slots busy) one step's
     host syncs (sync_count), device ms, device ops and idle share
     (torch.profiler); peak MiB; the step's bound (the bytes it must read,
     every weight at its read dtype and the cache, over 3.35 TB/s).
     rwkv6-1.6b whole (1.584 B) and mixtral-8x22b at full width with 2 of
     its 56 layers (5.41 B, 10.8 GB of bf16 weights; the whole model is
     282 GB): the same bf16 run, and the fp32 decode-vs-prefill check at 2
     requests (mixtral with capacity_factor 4, so a prefill drops no
     token; rwkv6 with each request alone in an engine, since the engine's
     batched steps advance a recurrent slot's state, its card-vs-CPU
     prefill and its decode-vs-prefill held to a fixed 5e-2: fp32
     rounding amplified by the depth of the network, measured by
     tools/rwkv6_drift.py).
     jamba-1.5-large-398b runs only reduced: one 8-layer pattern unit at
     full width holds about 77 GB of expert weights. The `model:` line
     holds it all, beside the card's name and power limit.
  4d. Train path (counters set to 0 before, read after; K1 must launch):
     repro_torch.train on the card, TF32 off for the fp32 checks. The ten
     reduced configs in fp32: the loss and every gradient leaf on the card
     against the same weights and batch on the CPU (loss within 5e-5
     relative, each leaf within 1e-4 of its largest value + 1e-6).
     qwen2-1.5b whole, with the model phase's parameters: in fp32 at B = 1,
     S = 16, the card's loss (1e-5 relative), global gradient norm (1e-4)
     and every gradient leaf (1e-3 of its largest value) against the CPU's;
     then at the config's own dtypes (fp32 weights, bf16 compute, remat
     on), AdamW with fp32 moments, markov_batch at seq 4,096 and batch 2:
     2 warm-up steps and 8 timed on one fixed batch, every loss finite and
     the last below the first and below ln(vocab); step ms (median), tokens
     per s, peak MiB, host syncs of a warm step, MFU (model_flops over the
     step over 989 TFLOP/s), and one profiled step's device ms, device
     ops, idle share and top kernels. qwen2's reduced config: 4 steps, a
     checkpoint, a restore into a fresh state (every leaf bit for bit), 4
     more steps, against 8 uninterrupted steps within 1e-6. One
     compressed_psum under an NCCL group of one rank. python -m
     repro_torch.launch.train --device cuda --steps 20 in a subprocess with
     a temporary --ckpt-dir. select_corpus_samples over 10,000,000
     documents (Docs, Quality, Dedup made from --seed as
     examples/analytics_pipeline.py makes them) through the eager Free
     Join on the card, equal to the numpy oracle, its largest kernel calls
     recorded for the parity phase. The `train:` line holds it all, beside
     the card's name and power limit.
  4e. Launch path (counters set to 0 before, read after; K1, K2 and K4
     must launch): repro_torch.launch, each fake world in a child process
     (python3 chip_smoke.py --launch-child ...; one default process group
     a process). dryrun_join on the card at 256 and then 512 shards: rank
     0's HyperCube count of the triangle and the clover over 65,536 rows a
     relation from --seed, each count equal to a numpy oracle on the same
     fragment, overflow 0, two all-reduces a query (CommDebugMode), cold
     s, warm ms, device ms, peak MiB, launches; the child's launch counts
     are added to this process's, and its kernels' largest inputs join
     the parity phase. Beside it on the host, the LM dry-run of
     qwen2-1.5b train_4k and mixtral-8x22b decode_32k at full width on the
     single-pod mesh of 256 fake ranks with fake cuda tensors (flops,
     bytes, collective bytes, memory; the microbatches=8 trace skipped).
     Then, in this process, make_host_mesh() over the card under an NCCL
     group of one rank and one qwen2-1.5b full-width train step with
     DTensor parameters on a (1, 1) mesh placed by param_shardings, its
     loss and gradient norm against the plain step's (LAUNCH_TOL). The
     `launch:` lines hold it all, beside the card's name and power limit.
  5. K5's path (counter set to 0 before, read after): ops.intersect_sorted
     of the 1,800,200 knows destinations into the sorted distinct knows
     sources, held against numpy.
  6. Kernel parity: each kernel against its plain PyTorch version on the
     card, on the largest input of each kind its paths give it (the main
     path's; for K1-K4 also one standing-q1 ingest's, with 16,384-row
     delta sorts and probes of the merged 2,097,152-row tables, the
     stage replay's registration and first batch, one batched dispatch
     of each serving template, one eager free_join(agg=None) of q1 at
     SF 10, and the train path's corpus selection at 10,000,000
     documents) plus edge cases (a ragged
     size, a one-row table or key set, all -1 lanes, total = 0, all hits,
     all misses, keys outside the key range; for K2 and K3 the shapes a
     tiled merge gets wrong: a hub row over 100,000 slots, 50,000 empty
     rows or dead lanes in a row, total or live above the capacity; for
     K5 the bucket directory's: b over the whole int32 range, N = 1 and 2,
     a dense run with one far outlier, 300,000 consecutive keys, queries
     at b[0] and b[N-1], Q = 1).
     K5 also on its two other shapes: the reference's kern.intersect.100k
     (100,000 sorted queries into the distinct keys of 100,000 draws from
     [0, 2^30)) and large N (4,194,304 queries, half members, into
     2,097,152 distinct keys from [0, 2^24)); every K5 input is held
     against numpy's searchsorted too. Equality is exact: every output is
     an integer (tolerance 0).
  7. Where a cold call's time goes: plan choice, uploads + trie builds,
     and the adaptive run, timed separately on fresh relation objects.
  8. Timing: each kernel, its plain version and, where one PyTorch call
     computes the same function, that call, as device time from
     torch.profiler after warm-up (all kernels of one call summed),
     beside the least time the card could take (bound); CUDA-event wall
     times per call beside them. K5's record holds its two other shapes
     under "shapes"; every record its launches on its path ("launches"),
     on the eager path ("eager_launches"), the serving path
     ("serving_launches"), the chaos path ("chaos_launches"), the
     analysis path ("analysis_launches"), the distributed path
     ("distributed_launches"), the model path ("model_launches"), the
     train path ("train_launches") and the launch path
     ("launch_launches").

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
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet), the
# listed rate closest to the kernels' int32 compare-and-select work (no
# int32 rate is listed). The memory rate and the bf16 tensor-core peak are
# repro_torch.launch.roofline's HBM_BW and PEAK_FLOPS.
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
    "intersect": ("intersect", "src/repro_torch/kernels/csrc/intersect.cu",
                  "src/repro/kernels/intersect.py:26"),
}
# the kernels compiled_free_join and the streaming path launch; K5's path
# is the kernel-op entry point ops.intersect_sorted
JOIN_KERNELS = ("hash_probe", "csr_expand", "compact", "radix_rank")


def fail(msg: str):
    raise RuntimeError(msg)


def ptxas_report(log: str):
    """(kernel function, line) for ptxas's register, spill and shared-memory
    lines in an nvcc -Xptxas -v log."""
    import re

    fn = "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            m = re.search(r"\d([a-z_]+_kernel)", line)
            fn = m.group(1) if m else line.split()[-1][:40]
        elif "registers" in line or "spill" in line:
            yield fn, line.strip()


def kernel_modules():
    import importlib

    return {k: importlib.import_module(f"repro_torch.kernels.{m}")
            for k, (m, _s, _r) in KERNELS.items()}


# ---------------------------------------------------------------------------
# oracles (numpy, independent of the port)
# ---------------------------------------------------------------------------


def two_paths(a: np.ndarray, b: np.ndarray):
    """The row-level 2-paths (a, b, c) of knows(a,b), knows(b,c), one per
    pair of rows (bag semantics), as three columns."""
    order = np.argsort(a, kind="stable")
    a_s, b_s = a[order], b[order]
    lo = np.searchsorted(a_s, b, "left")
    cnt = np.searchsorted(a_s, b, "right") - lo
    first = np.repeat(np.arange(len(a)), cnt)
    offs = np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return a[first], b[first], b_s[lo[first] + offs]


def triangle_oracle(a: np.ndarray, b: np.ndarray):
    """Bag triangles of knows(a,b), knows(b,c), knows(c,a): enumerate the
    row-level 2-paths (a,b,c) and count the closing edges (c,a) of each.
    Returns (count, rows (M, 3) with multiplicity expanded, 2-paths)."""
    pa, pb, pc = two_paths(a, b)
    width = int(max(a.max(), b.max())) + 1
    ekeys, ecount = np.unique(a * width + b, return_counts=True)
    want = pc * width + pa
    pos = np.clip(np.searchsorted(ekeys, want), 0, len(ekeys) - 1)
    close = np.where(ekeys[pos] == want, ecount[pos], 0)
    rows = np.repeat(np.stack([pa, pb, pc], axis=1), close, axis=0)
    return int(close.sum()), rows, len(pa)


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
# the streaming path: standing queries over ingest
# ---------------------------------------------------------------------------


def chain4_oracle(rels) -> int:
    """Count of R(a,b) S(b,c) T(c,d) U(d,e): per S row, the R rows ending
    at its b times the (T, U) paths leaving its c."""
    c = {a: r.columns for a, r in rels.items()}
    width = int(max(int(col.max()) for cols in c.values() for col in cols.values())) + 1
    r_into_b = np.bincount(c["R"]["b"], minlength=width).astype(np.int64)
    u_from_d = np.bincount(c["U"]["d"], minlength=width).astype(np.int64)
    tu_from_c = np.bincount(c["T"]["c"], weights=u_from_d[c["T"]["d"]], minlength=width)
    return int((r_into_b[c["S"]["b"]] * tu_from_c[c["S"]["c"]].astype(np.int64)).sum())


def streaming_triangle(device: str, seed: int, sf: float, sync, batches: int = 8,
                       batch: int = 16_384, deletes: int = 16_384):
    """A standing LSQB q1 (triangle count over knows at scale factor sf)
    through StandingQueryEngine, then `batches` ingests of `batch` new
    edges each (knows_inserts, another seed; the same edges go into all
    three views of knows) and one delete of `deletes` random rows. The
    count is held against the numpy oracle on the live rows after the
    first batch, after the delete, and after a final no-op refresh. After
    registration no trie is built: every append is one delta merge per
    cached layout, the delete tombstone refreshes. The triangle count
    barely moves under these mutations (the generator's source and
    destination hubs are different persons), so at the end every cached
    trie is also held against a full rebuild over the same rows. One more
    ingest runs with the kernels' inputs recorded; returns them."""
    from repro_torch.core import TRIE_CACHE, ExecOptions, relcache
    from repro_torch.relational.datagen import knows_inserts, lsqb_knows, lsqb_q1
    from repro_torch.serve import StandingQueryEngine

    knows = lsqb_knows(sf=sf, seed=seed + 1)
    q1, rels = lsqb_q1(knows)
    views = [rels[a] for a in ("K1", "K2", "K3")]  # three renamings of one table
    # + 2 profiled batches + 1 recorded
    edges = knows_inserts(sf, (batches + 3) * batch, seed=seed + 2, table_seed=seed + 1)
    rng = np.random.default_rng(seed + 3)

    def check(when):
        live = relcache.live_relation(views[0])
        want = triangle_oracle(live.columns["a"], live.columns["b"])[0]
        if sq.result != want:
            fail(f"standing q1 {when}: count {sq.result} != oracle {want}")
        return want

    eng = StandingQueryEngine(options=ExecOptions(device=device))
    t = time.perf_counter()
    sq = eng.register(q1, rels, agg="count")
    sync()
    rec = {"rows": knows.num_rows, "register_s": time.perf_counter() - t,
           "registered_count": check("at registration")}
    builds = TRIE_CACHE.builds
    layouts = sum(len(relcache.REGISTRY.namespace(v, "tries")) for v in views)
    lat, appends, merges = [], [], []

    def ingest(i):
        """Batch i into all three views; returns (wall s, host append s of
        the two views appended directly)."""
        part = slice(i * batch, (i + 1) * batch)
        m0 = TRIE_CACHE.delta_merges
        t = time.perf_counter()
        for v in views[1:]:
            relcache.append(v, {v.schema[0]: edges["a"][part], v.schema[1]: edges["b"][part]})
        t_append = time.perf_counter() - t
        eng.ingest(views[0], {"a": edges["a"][part], "b": edges["b"][part]})  # then refresh
        sync()
        merges.append(TRIE_CACHE.delta_merges - m0)
        if merges[-1] != layouts:
            fail(f"standing q1 batch {i}: {merges[-1]} delta merges for {layouts} cached layouts")
        return time.perf_counter() - t, t_append

    for i in range(batches):
        wall, t_append = ingest(i)
        lat.append(wall)
        appends.append(t_append)
        if i == 0:
            rec["count_after_first_batch"] = check("after the first batch")
    rows = rng.choice(relcache.mutation_state(views[0]).total, deletes, replace=False)
    tomb = TRIE_CACHE.tombstone_refreshes
    t = time.perf_counter()
    for v in views:
        relcache.delete(v, rows)
    eng.refresh()
    sync()
    rec["delete_s"] = time.perf_counter() - t
    rec["count_after_delete"] = check("after the delete")
    rec["tombstone_refreshes"] = TRIE_CACHE.tombstone_refreshes - tomb
    recomputed = eng.stages_recomputed
    if eng.refresh() or eng.stages_recomputed != recomputed:
        fail("standing q1: a refresh with no mutation recomputed a stage")
    rec["count_at_end"] = check("at the end")
    rec["profile"] = profile_run(lambda: ingest(batches), lambda: ingest(batches + 1))
    rec["count_after_profiled_batches"] = check("after the profiled batches")
    with capture_largest() as seen:
        ingest(batches + 2)
    rec["tries_equal_rebuild"] = check_cached_tries(views)
    rec["builds_after_registration"] = TRIE_CACHE.builds - builds
    if rec["builds_after_registration"] or rec["tombstone_refreshes"] <= 0:
        fail(f"standing q1: {rec['builds_after_registration']} trie builds after registration, "
             f"{rec['tombstone_refreshes']} tombstone refreshes")
    rec.update(live_rows=relcache.live_size(views[0]), cached_layouts=layouts,
               delta_merges_per_batch=merges, first_ingest_ms=lat[0] * 1e3,
               median_ingest_ms=float(np.median(lat)) * 1e3, ingest_ms=[x * 1e3 for x in lat],
               host_append_ms_two_views=[x * 1e3 for x in appends])
    print("streaming q1: " + json.dumps(rec), flush=True)
    return {name: args for name, (_size, args) in seen.items()}


def check_cached_tries(views) -> int:
    """Hold every cached trie of the views (appends merged, deletes
    retired) against a full padded, weighted rebuild over the same
    physical rows and liveness mask, the trie cache's own rebuild branch.
    Every array must be equal except `order`, which may order rows with
    equal keys differently (a merge puts delta rows first among equals):
    it must be a permutation that sorts the columns. A cover-only
    (trivial) trie has only its columns and weights. Returns the number of
    tries checked."""
    import torch
    from repro_torch.core import relcache
    from repro_torch.core.compiled import PAD_KEY, _bucket, _LevelOps, build_trie

    checked = 0
    for view in views:
        st = relcache.mutation_state(view)
        for key, entry in relcache.REGISTRY.namespace(view, "tries").items():
            got = entry["trie"]
            if entry.get("version") != st.version:
                fail(f"cached trie {key[0]} of {view.name}: version {entry.get('version')} "
                     f"of {st.version}")
            dev = got.mult_col.device
            cap, pad = _bucket(st.total), _bucket(st.total) - st.total
            flat = [v for lv in got.levels for v in lv]
            cols = {v: torch.as_tensor(np.concatenate(
                [view.columns[v], np.full(pad, PAD_KEY)]).astype(np.int32)).to(dev) for v in flat}
            mult = np.concatenate([st.mult if st.mult is not None else np.ones(st.total),
                                   np.zeros(pad)]).astype(np.int32)
            lops = got.lops if got.trivial else _LevelOps(
                got.levels, tuple(t is not None for t in got.tables))
            want = build_trie(cols, lops, budget=got.budget, mult=torch.as_tensor(mult).to(dev))
            pairs = [("n", got.n == want.n == cap), ("total_mult", got.total_mult == want.total_mult),
                     ("mult_col", torch.equal(got.mult_col, want.mult_col))]
            pairs += [(f"cols[{v}]", torch.equal(got.cols[v], want.cols[v])) for v in flat]
            if got.trivial:
                flat = ()  # no order, groups or tables
            pairs += [(f"sorted_cols[{v}]", torch.equal(got.sorted_cols[v], want.sorted_cols[v])
                       and torch.equal(got.cols[v][got.order.long()], got.sorted_cols[v]))
                      for v in flat]
            for arr in ("g", "kpos", "child_base", "child_counts", "row_count", "row_weight"):
                a, b = getattr(got, arr) or [], getattr(want, arr) or []
                pairs += [(arr, len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)))]
            if not got.trivial:
                pairs += [("order is a permutation", torch.equal(
                    torch.sort(got.order).values, torch.arange(cap, dtype=torch.int32, device=dev)))]
            for d, (a, b) in enumerate(zip(got.tables or [], want.tables or [])):
                pairs += [(f"tables[{d}]", (a is None) == (b is None) and (a is None or (
                    torch.equal(a.slots, b.slots) and torch.equal(a.keys, b.keys))))]
            bad = [name for name, ok in pairs if not bool(ok)]
            if bad:
                fail(f"cached trie {key[0]} of {view.name} differs from a rebuild in {bad}")
            checked += 1
    return checked


def profile_run(device_run, host_run, top: int = 8):
    """Where one run's time goes (an ingest, an eager query). `device_run`
    runs under torch.profiler:
    its wall time, the summed device time of every kernel it launched (the
    device's busy time; one stream, so nothing overlaps) and the idle
    share, with the kernels taking most device time. `host_run` runs under
    cProfile: the host functions with the most time of their own."""
    import cProfile
    import pstats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = device_run()[0]
    dev = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(us for _k, us, _n in dev) / 1e3
    out = {"profiled_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "idle_share": 1 - busy_ms / (wall * 1e3),
           "device_ops": sum(n for _k, _us, n in dev),
           "top_device_ms": [[k[:60], us / 1e3, n]
                             for k, us, n in sorted(dev, key=lambda x: -x[1])[:top]]}
    prof_host = cProfile.Profile()
    prof_host.enable()
    wall = host_run()[0]
    prof_host.disable()
    stats = pstats.Stats(prof_host).stats  # (file, line, fn) -> (cc, nc, tt, ct, callers)
    own = sorted(((tt, nc, f"{Path(f).name}:{fn}") for (f, _l, fn), (_c, nc, tt, _ct, _cl)
                  in stats.items()), reverse=True)[:top]
    out.update(cprofiled_wall_ms=wall * 1e3,
               top_host_self_ms=[[name, tt * 1e3, nc] for tt, nc, name in own])
    return out


def stage_replay(device: str, seed: int, sync, n: int = 60_000, dom: int = 4_000,
                 batch: int = 2_048, warm: int = 3, n_meas: int = 12):
    """The reference's streaming workload (benchmarks/bench_streaming.py,
    same draws from the same seed): a standing bushy count over the chain
    R(a,b) S(b,c) T(c,d) U(d,e), plan (R⋈S) ⋈ (T⋈U), with batches of new R
    rows. After every batch the count equals a compiled_free_join over
    fresh copies of the relations (the rebuild-per-batch answer) and the
    T⋈U stage was replayed, not recomputed; the final count equals the
    numpy oracle. Ingests after the `warm` first are timed. Registration
    (the one cold run of the T⋈U stage, which compacts) and the first
    ingest run with the kernels' inputs recorded; returns them."""
    from repro_torch.core import ExecOptions, compiled_free_join
    from repro_torch.core.plan import BinaryPlan
    from repro_torch.relational.relation import Relation
    from repro_torch.relational.schema import Atom, Query
    from repro_torch.serve import StandingQueryEngine

    rng = np.random.default_rng(seed)
    q = Query([Atom("R", ("a", "b")), Atom("S", ("b", "c")), Atom("T", ("c", "d")),
               Atom("U", ("d", "e"))])
    at = {a.alias: a for a in q.atoms}
    tree = BinaryPlan(BinaryPlan(at["R"], at["S"]), BinaryPlan(at["T"], at["U"]))
    cols = {a.alias: {v: rng.integers(0, dom, n).astype(np.int32) for v in a.vars}
            for a in q.atoms}
    deltas = [{v: rng.integers(0, dom, batch).astype(np.int32) for v in ("a", "b")}
              for _ in range(warm + n_meas)]
    rels = {a: Relation(a, {v: c.copy() for v, c in cs.items()}) for a, cs in cols.items()}
    opts = ExecOptions(device=device)
    eng = StandingQueryEngine(options=opts)
    timed = []

    def step(i):
        skipped = eng.stages_skipped
        t = time.perf_counter()
        eng.ingest(rels["R"], deltas[i])
        sync()
        if i >= warm:
            timed.append(time.perf_counter() - t)
        if eng.stages_skipped - skipped != len(sq.states) - 1:
            fail(f"stage replay batch {i}: {eng.stages_skipped - skipped} stages replayed")

    def check(i):
        fresh = {a: Relation(a, {v: c.copy() for v, c in r.columns.items()})
                 for a, r in rels.items()}
        want = compiled_free_join(q, fresh, tree, agg="count", options=opts)
        if sq.result != want:
            fail(f"stage replay batch {i}: standing count {sq.result} != rebuild {want}")

    with capture_largest() as seen:
        sq = eng.register(q, rels, agg="count", plan_tree=tree)
        step(0)
    check(0)
    for i in range(1, len(deltas)):
        step(i)
        check(i)
    oracle = chain4_oracle(rels)
    if sq.result != oracle:
        fail(f"stage replay: final count {sq.result} != oracle {oracle}")
    wall = sum(timed)
    rec = {"n": n, "dom": dom, "batch": batch, "warm": warm, "timed_batches": n_meas,
           "stages": len(sq.states), "final_count": sq.result,
           "stages_skipped": eng.stages_skipped, "stages_recomputed": eng.stages_recomputed,
           "timed_s": wall, "updates_per_s": n_meas / wall,
           "rows_per_s": n_meas * batch / wall}
    print("stage replay: " + json.dumps(rec), flush=True)
    return {name: args for name, (_size, args) in seen.items()}


# ---------------------------------------------------------------------------
# the serving path: JoinServeEngine against serial compiled_free_join
# ---------------------------------------------------------------------------


def point_oracles(knows):
    """Independent numpy answers per person c of the two serving templates
    over knows(a, b): friends of friends, knows(a,b), knows(b,c) with a = c
    (the sum of out-degree(y) over the rows (c, y)), and LSQB q1's triangle
    with a = c (for each row (c, y), the rows (y, z) whose z is a source of
    a row (z, c), by sorted-set intersection; bag semantics throughout).
    Returns (fof counts per person, triangle(c) function, persons with
    friends by out-degree, hubs first)."""
    a = knows.columns["a"].astype(np.int64)
    b = knows.columns["b"].astype(np.int64)
    width = int(max(a.max(), b.max())) + 2
    out_deg = np.bincount(a, minlength=width)
    fof = np.zeros(width, np.int64)
    np.add.at(fof, a, out_deg[b])
    by_a = np.argsort(a, kind="stable")
    b_s = b[by_a]
    starts = np.searchsorted(a[by_a], np.arange(width + 1))
    by_b = np.argsort(b, kind="stable")
    a_by_b = a[by_b]
    in_starts = np.searchsorted(b[by_b], np.arange(width + 1))

    def triangle_at(c: int) -> int:
        ys = b_s[starts[c]:starts[c + 1]]
        zs, zc = np.unique(a_by_b[in_starts[c]:in_starts[c + 1]], return_counts=True)
        if not len(ys) or not len(zs):
            return 0
        lo = starts[ys]
        cnt = starts[ys + 1] - lo
        idx = np.repeat(lo, cnt) + np.arange(int(cnt.sum())) - np.repeat(np.cumsum(cnt) - cnt,
                                                                         cnt)
        z = b_s[idx]
        pos = np.clip(np.searchsorted(zs, z), 0, len(zs) - 1)
        return int(np.where(zs[pos] == z, zc[pos], 0).sum())

    persons = np.flatnonzero(out_deg)
    persons = persons[np.argsort(-out_deg[persons], kind="stable")]
    return fof, triangle_at, persons


def serving_trace(q1_rels, persons, seed: int, tenants: int = 16, requests: int = 256):
    """The serving trace over the main path's three views of knows: two
    templates, friends of friends (knows(a,b), knows(b,c), a LDBC SNB
    Interactive-style 2-hop point query) and LSQB q1's triangle, each with
    a = c; every tenant spells each with its own aliases and atom order
    (as benchmarks/bench_serving.py does). Requests alternate between the
    templates; tenant i // 2 mod 16; constants Zipf(1.3)-skewed over the
    persons with friends, hubs first, so hubs recur. Returns
    [(tenant, template, query, relations, filters)]."""
    from repro_torch.relational.schema import Atom, Query

    rng = np.random.default_rng(seed + 4)
    shapes = {"fof": (("K1", ("a", "b")), ("K2", ("b", "c"))),
              "q1": (("K1", ("a", "b")), ("K2", ("b", "c")), ("K3", ("c", "a")))}
    spelled = {}
    for t in range(tenants):
        for name, atoms in shapes.items():
            mine = [Atom("knows", vs, f"t{t}_{alias}") for alias, vs in atoms]
            q = Query([mine[i] for i in rng.permutation(len(mine))])
            spelled[t, name] = (q, {f"t{t}_{alias}": q1_rels[alias] for alias, _ in atoms})
    consts = persons[(rng.zipf(1.3, requests) - 1) % len(persons)]
    trace = []
    for i, c in enumerate(consts):
        t, name = (i // 2) % tenants, ("fof", "q1")[i % 2]
        trace.append((f"tenant{t}", name, *spelled[t, name], {"a": int(c)}))
    return trace


def drain_serial(trace, opts):
    """One kill-mode compiled_free_join per request, in arrival order; each
    ends in its count's read-back. Returns (per-request s, results)."""
    from repro_torch.core import compiled_free_join

    lat, out = [], []
    for _tenant, _name, q, rels, filters in trace:
        t = time.perf_counter()
        out.append(compiled_free_join(q, rels, agg="count", filters=filters, options=opts))
        lat.append(time.perf_counter() - t)
    return lat, out


def drain_batched(trace, opts, slots: int):
    """The trace through one JoinServeEngine: every request submitted, then
    step() until the queue is empty. A request's latency is its dispatch's
    (every rider pays the whole batch; each step ends in the results'
    read-back). Returns (per-request s, results, engine, per-template
    dispatch s)."""
    from repro_torch.serve import JoinServeEngine

    eng = JoinServeEngine(slots=slots, options=opts)
    reqs = [eng.submit(q, rels, filters, tenant=tenant) for tenant, _n, q, rels, filters in trace]
    names = {id(r): name for r, (_t, name, *_rest) in zip(reqs, trace)}
    lat, per_template = [], {"fof": [], "q1": []}
    while eng.queue:
        t = time.perf_counter()
        retired = eng.step()
        dt = time.perf_counter() - t
        lat.extend([dt] * len(retired))
        per_template[names[id(retired[0])]].append(dt)
    for r in reqs:
        if not r.done or r.error is not None:
            fail(f"serving: request {r.rid} not answered ({r.error!r})")
    return lat, [r.result for r in reqs], eng, per_template


def serving_path(device: str, seed: int, workloads, sync, slots: int = 16):
    """The serving phase (see the module docstring): the 256-request trace
    drained through JoinServeEngine and serially, each drain once to warm
    and once timed, every result held against the numpy oracle and the two
    drains against each other; then the 4-chain as a batched template with
    its filter in a non-root stage. Returns the kernels' largest inputs of
    one warm batched dispatch of each template."""
    import torch

    from repro_torch.core import compiled_free_join
    from repro_torch.serve import JoinServeEngine

    q1, q1_rels, _star, _star_rels, opts = workloads
    mods = kernel_modules()
    fof, triangle_at, persons = point_oracles(q1_rels["K1"])
    trace = serving_trace(q1_rels, persons, seed)
    want, tri_memo = [], {}
    for _t, name, _q, _r, filters in trace:
        c = filters["a"]
        if name == "fof":
            want.append(int(fof[c]))
        else:
            want.append(tri_memo.setdefault(c, triangle_at(c)))
    rec = {"requests": len(trace), "slots": slots, "tenants": 16,
           "distinct_constants": len({f["a"] for *_x, f in trace}),
           "hub_share": float(np.mean([f["a"] == persons[0] for *_x, f in trace]))}
    results = {}
    for mode in ("batched", "serial"):
        t = time.perf_counter()
        if mode == "batched":
            drain_batched(trace, opts, slots)
        else:
            drain_serial(trace, opts)
        sync()
        cold_s = time.perf_counter() - t
        before = {k: m.launches for k, m in mods.items()}
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        if mode == "batched":
            lat, out, eng, per_template = drain_batched(trace, opts, slots)
        else:
            lat, out = drain_serial(trace, opts)
        sync()
        wall = time.perf_counter() - t
        if out != want:
            bad = [i for i, (g, w) in enumerate(zip(out, want)) if g != w]
            fail(f"serving {mode}: {len(bad)} results differ from the oracle, first request "
                 f"{bad[0]}: {out[bad[0]]} != {want[bad[0]]}")
        results[mode] = out
        r = {"warm_up_drain_s": cold_s, "wall_s": wall, "queries_per_s": len(trace) / wall,
             "p50_ms": float(np.percentile(lat, 50)) * 1e3,
             "p99_ms": float(np.percentile(lat, 99)) * 1e3,
             "dispatches": eng.dispatches if mode == "batched" else len(trace),
             "launches": {k: m.launches - before[k] for k, m in mods.items()},
             "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
        if mode == "batched":
            r.update(degraded=eng.degraded, faults_absorbed=eng.faults_absorbed,
                     deadline_rejected=eng.deadline_rejected,
                     dispatch_ms_median={k: float(np.median(v)) * 1e3
                                         for k, v in per_template.items()})
            if sum(eng.degraded.values()) or eng.faults_absorbed:
                fail(f"serving: degraded {eng.degraded}, {eng.faults_absorbed} faults absorbed")
        rec[mode] = r
    if results["batched"] != results["serial"]:
        fail("serving: the batched and the serial drains differ")
    rec["batched_over_serial_qps"] = (rec["batched"]["queries_per_s"]
                                      / rec["serial"]["queries_per_s"])

    # one warm batched dispatch of each template against one warm
    # unfiltered call of the same query: host syncs, host ms, device ms
    def one_dispatch(name):
        eng = JoinServeEngine(slots=slots, options=opts)
        picks = [x for x in trace if x[1] == name][:slots]

        def step():
            for tenant, _n, q, rels, filters in picks:
                eng.submit(q, rels, filters, tenant=tenant)
            eng.step()
        return step

    with capture_largest() as seen:
        for name in ("fof", "q1"):
            one_dispatch(name)()
    _tenant, _name, q_fof, fof_rels, _filters = trace[0]  # requests start with fof
    for name, q, rels in (("q1", q1, q1_rels), ("fof", q_fof, fof_rels)):
        step = one_dispatch(name)
        unfiltered = lambda q=q, rels=rels: compiled_free_join(q, rels, agg="count",
                                                               options=opts)
        unfiltered()
        rec[f"{name}_one_dispatch"] = {
            "host_syncs": sync_count(step),
            "device_ms": device_ms(step, iters=5, warmup=1)[0],
            "host_ms": wall_ms(step, iters=5, warmup=1),
            "unfiltered_call_device_ms": device_ms(unfiltered, iters=5, warmup=1)[0],
            "unfiltered_call_host_ms": wall_ms(unfiltered, iters=5, warmup=1),
            "unfiltered_call_host_syncs": sync_count(unfiltered)}

    def timed(fn):
        def run():
            t = time.perf_counter()
            fn()
            sync()
            return (time.perf_counter() - t,)
        return run

    # where one warm batched q1 dispatch's time goes: device busy time and
    # idle share (torch.profiler), host functions by own time (cProfile)
    step = one_dispatch("q1")
    step()
    rec["q1_one_dispatch"]["profile"] = profile_run(timed(step), timed(step), top=6)

    # the 4-chain as a batched template whose filter var e is bound only in
    # the T-U stage: from that stage's output on, every lane runs alone
    q, tree, rels = chain4_workload(seed)
    rng = np.random.default_rng(seed + 5)
    es = [int(e) for e in rng.choice(rels["U"].columns["e"], 8, replace=False)]
    eng = JoinServeEngine(slots=8, options=opts)
    reqs = [eng.submit(q, rels, {"e": e}, plan_tree=tree) for e in es]
    t = time.perf_counter()
    eng.run()
    sync()
    chain_s = time.perf_counter() - t
    counts = []
    for r, e in zip(reqs, es):
        sel = rels["U"].columns["e"] == e
        only = dict(rels, U=type(rels["U"])("U", {v: c[sel] for v, c in
                                                  rels["U"].columns.items()}))
        want_e = chain4_oracle(only)
        if r.error is not None or r.result != want_e:
            fail(f"serving chain4 e={e}: {r.result!r} ({r.error!r}) != oracle {want_e}")
        counts.append(r.result)
    rec["chain4_filter_e"] = {"constants": es, "counts": counts, "dispatches": eng.dispatches,
                              "cold_s": chain_s, "degraded": eng.degraded}
    print("serving: " + json.dumps(rec), flush=True)
    return {name: args for name, (_size, args) in seen.items()}


def rewarm(workloads):
    """The serial drain's 32 tenant spellings fill the LRU runner cache
    (32 entries): plan the main path's queries again, so the phases after
    the serving path meet them warm, as before it."""
    from repro_torch.core import compiled_free_join

    q1, q1_rels, star, star_rels, opts = workloads
    for q, rels, agg in ((q1, q1_rels, "count"), (q1, q1_rels, None), (star, star_rels, "count")):
        compiled_free_join(q, rels, agg=agg, options=opts)


def chaos_path(device: str, seed: int, sync, slots: int = 8, sf: float = 1):
    """The chaos phase (see the module docstring): q1 at SF 1 through a
    JoinServeEngine(slots=8) with 8 requests, one fault of each kind armed
    at a time (each case on a fresh runner cache, so a new executor is
    made), and once under a memory budget below the working set; then a
    standing triangle and a standing friends-of-friends count sharing the
    engine's options, with a device_oom in one refresh of each. Every
    answer is held against the numpy oracle."""
    import warnings

    from repro_torch.core import ExecOptions, faults, membudget, relcache
    from repro_torch.core.relcache import KeyedCache
    from repro_torch.relational.datagen import knows_inserts, lsqb_knows, lsqb_q1
    from repro_torch.relational.schema import Atom, Query
    from repro_torch.serve import JoinServeEngine, StandingQueryEngine

    opts = ExecOptions(device=device)
    knows = lsqb_knows(sf=sf, seed=seed + 1)
    q1, rels = lsqb_q1(knows)
    fof_q = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2")])
    fof, triangle_at, persons = point_oracles(knows)
    rng = np.random.default_rng(seed + 6)
    consts = [int(c) for c in rng.choice(persons[:2000], slots, replace=False)]
    want = {c: triangle_at(c) for c in consts}
    faults.reset_stats()
    cases = {}

    def serve(kind=None, budget=None, deadline=False, **kw):
        """The 8 requests through a fresh engine and runner cache with one
        fault armed (or a memory budget, or nothing). With deadline=True
        the last request is a friends-of-friends one (another template,
        dispatched after the triangle's) with a 20 ms deadline."""
        eng = JoinServeEngine(slots=slots, options=opts, cache=KeyedCache())
        eng.backoff_base_ms = 0.5
        if kind is not None:
            arm = faults.inject(kind, **kw)
        elif budget is not None:
            arm = membudget.budget(budget)
        else:
            arm = nullcontext()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with arm as f:
                reqs = [eng.submit(q1, rels, {"a": c}) for c in consts[:-1]]
                if deadline:
                    reqs.append(eng.submit(fof_q, {"K1": rels["K1"], "K2": rels["K2"]},
                                           {"a": consts[-1]}, deadline_ms=20.0))
                else:
                    reqs.append(eng.submit(q1, rels, {"a": consts[-1]}))
                t = time.perf_counter()
                eng.run()
                sync()
                wall = time.perf_counter() - t
                governed = membudget.GOVERNOR.live_bytes
        if budget is not None and governed > budget:
            fail(f"chaos memory_budget: {governed} governed bytes above the budget {budget}")
        expected = [want[c] for c in consts[:-1]] + [
            int(fof[consts[-1]]) if deadline else want[consts[-1]]]
        rungs, errors = [], []
        for r, c, w in zip(reqs, consts, expected):
            if not r.done:
                fail(f"chaos {kind or budget}: request {r.rid} not answered")
            reason = getattr(r.error, "reason", None)
            errors.append(None if r.error is None else f"{type(r.error).__name__}:{reason}")
            rungs.append(r.degraded_to)
            if r.error is None:
                if r.result != w:
                    fail(f"chaos {kind or budget}: a={c}: {r.result} != oracle {w}")
            elif not ((kind == "overflow_storm" and type(r.error).__name__ ==
                       "CapacityQuotaError") or (deadline and reason == "deadline")):
                fail(f"chaos {kind or budget}: a={c} failed with {r.error!r}")
        return {"fired": getattr(f, "fired", None), "rungs": rungs, "errors": errors,
                "served": eng.served, "dispatches": eng.dispatches, "degraded": eng.degraded,
                "faults_absorbed": eng.faults_absorbed,
                "deadline_rejected": eng.deadline_rejected, "wall_s": wall,
                "governed_bytes": governed,
                "warnings": sorted({w.category.__name__ for w in seen})}

    warm = serve()  # builds the SF 1 tries; no fault armed
    if warm["faults_absorbed"] or any(warm["rungs"]):
        fail(f"chaos: the fault-free warm-up degraded: {warm}")
    cases["compile_fail"] = serve("compile_fail", times=1)
    cases["compile_fail_x3"] = serve("compile_fail", times=3)
    cases["device_oom"] = serve("device_oom", times=1)
    cases["slow_dispatch"] = serve("slow_dispatch", deadline=True, times=1, delay_s=0.25)
    cases["overflow_storm"] = serve("overflow_storm", times=1, lanes=(2,))
    cases["mutation_skew"] = serve("mutation_skew", rel=knows)
    # the governed bytes of the tries the triangle reads (the working set
    # without the frontier); the budget is a quarter of it
    gov = membudget.GOVERNOR
    tries = sum(membudget.trie_nbytes(e["trie"]) for a in ("K1", "K2", "K3")
                for e in relcache.REGISTRY.namespace(rels[a], "tries").values())
    ev, sh = gov.evictions, gov.sheds
    cases["memory_budget"] = serve(budget=tries // 4)
    cases["memory_budget"].update(budget=tries // 4, tries_bytes=tries,
                                  evictions=gov.evictions - ev, sheds=gov.sheds - sh)
    expect = {"compile_fail": {"halved"}, "compile_fail_x3": {"eager"}, "device_oom": {"halved"}}
    for kind, rungs in expect.items():
        if set(cases[kind]["rungs"]) != rungs:
            fail(f"chaos {kind}: rungs {cases[kind]['rungs']}, expected {rungs}")
    if cases["slow_dispatch"]["deadline_rejected"] != 1:
        fail("chaos slow_dispatch: the tight deadline was not reaped")
    if sum(e is not None for e in cases["overflow_storm"]["errors"]) != 1:
        fail("chaos overflow_storm: not exactly one lane evicted")

    # a standing triangle sharing the engine's options: a device_oom in
    # one refresh answers from the eager engine, the next goes back
    views = [rels[a] for a in ("K1", "K2", "K3")]
    st = StandingQueryEngine(engine=JoinServeEngine(slots=slots, options=opts))
    sq = st.register(q1, rels, agg="count")
    # beside it, friends of friends of the busiest person: a count that
    # is not 0 whatever the draw
    hub = int(persons[0])
    sq_fof = st.register(fof_q, {"K1": rels["K1"], "K2": rels["K2"]}, {"a": hub})
    edges = knows_inserts(sf, 2048, seed=seed + 7, table_seed=seed + 1)

    def live_count():
        live = relcache.live_relation(views[0])
        return triangle_oracle(live.columns["a"], live.columns["b"])[0]

    def live_fof():
        return int(point_oracles(relcache.live_relation(views[0]))[0][hub])

    def append(part):
        for v in views[1:]:
            relcache.append(v, {v.schema[0]: edges["a"][part], v.schema[1]: edges["b"][part]})
        relcache.append(views[0], {"a": edges["a"][part], "b": edges["b"][part]})

    append(slice(0, 1024))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with faults.inject("device_oom", times=2) as f:  # one for each query's refresh
            st.refresh()
    standing = {"fired": f.fired, "degraded_refreshes": st.degraded_refreshes,
                "after_fault": [(s.degraded_to, s.result, want) for s, want in
                                ((sq, live_count()), (sq_fof, live_fof()))]}
    append(slice(1024, 2048))
    st.refresh()
    standing["next_refresh"] = [(s.degraded_to, s.result, want) for s, want in
                                ((sq, live_count()), (sq_fof, live_fof()))]
    if (standing["fired"] != 2
            or any(rung != "eager" or got != w for rung, got, w in standing["after_fault"])
            or any(rung is not None or got != w for rung, got, w in standing["next_refresh"])):
        fail(f"chaos standing: {standing}")
    rec = {"sf": sf, "rows": knows.num_rows, "slots": slots, "constants": consts,
           "cases": cases, "standing": standing, "firings": dict(faults.STATS)}
    print("chaos: " + json.dumps(rec), flush=True)


# ---------------------------------------------------------------------------
# the analysis path: plan verification and the launch/sync audit
# ---------------------------------------------------------------------------


def fresh_copy(rels):
    """The same columns under new relation objects: every cache misses."""
    from repro_torch.relational.relation import Relation

    return {a: Relation(r.name, dict(r.columns)) for a, r in rels.items()}


def analysis_path(device: str, seed: int, workloads, ref, sync):
    """The analysis phase (see the module docstring): verify=True cold and
    warm, debug_lint, the launch audit of four warm runners against
    sync_count, the submit-time lint, count_query, and the corpus gate.
    Returns the record printed on the `analysis:` line."""
    from repro_torch.analysis import PlanVerificationError
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis.launch_audit import (
        audit_runner,
        runner_limits,
        schedule_ops,
        trace_runner,
    )
    from repro_torch.analysis.planlint import lint_chain
    from repro_torch.core import (
        TRIE_CACHE,
        ExecOptions,
        JoinOrderOptimizer,
        Stats,
        compiled_free_join,
        plan_chain_capacities,
        relcache,
    )
    from repro_torch.core.api import _acquire_runner, _runner_cache
    from repro_torch.core.compiled import count_query
    from repro_torch.core.plan import stage_plans
    from repro_torch.relational.schema import Query
    from repro_torch.serve import JoinServeEngine
    from repro_torch.serve.templates import canonicalize

    q1, q1_rels, star, star_rels, opts = workloads
    verify = ExecOptions(device=device, verify=True)
    rec = {"verify": {}, "audit": {}}

    # ExecOptions(verify=True), cold (new relation objects) then warm
    for name, q, rels, want in (("q1", q1, q1_rels, ref["q1_count"]),
                                ("star", star, star_rels, ref["star_count"])):
        fresh = fresh_copy(rels)
        t0 = time.perf_counter()
        runner, _rels, _cacheable, _tree = _acquire_runner(q, fresh, None, agg="count",
                                                           options=verify)
        t1 = time.perf_counter()
        # the verifier's share of that planning pass: the same lint, timed
        # alone on the same freshly planned chain
        lint_chain(runner.stages, runner._as_chain(runner.cap_plan)).raise_errors()
        t2 = time.perf_counter()
        r = {"plan_s": t1 - t0, "verify_ms": (t2 - t1) * 1e3}
        for phase in ("cold", "warm"):
            builds, info = TRIE_CACHE.builds, {}
            t = time.perf_counter()
            out = compiled_free_join(q, fresh, agg="count", options=verify, info=info)
            sync()
            r[f"{phase}_s"] = time.perf_counter() - t
            r[f"{phase}_builds"] = TRIE_CACHE.builds - builds
            if out != want:
                fail(f"analysis: {name} under verify=True {phase}: {out} != oracle {want}")
        if info["runner"] is not runner or r["warm_builds"]:
            fail(f"analysis: {name} under verify=True re-planned or rebuilt when warm")
        r["count"] = out
        rec["verify"][name] = r

    # JoinOrderOptimizer(debug_lint=True) on q1 with no plan tree
    fresh = fresh_copy(q1_rels)
    opt = JoinOrderOptimizer(level=opts.optimize_level, safety=opts.safety,
                             compact_threshold=opts.compact_threshold,
                             feedback=relcache.FEEDBACK, debug_lint=True)
    t = time.perf_counter()
    tree = opt.choose(q1, fresh, stats=Stats(fresh, cached=True))
    choose_ms = (time.perf_counter() - t) * 1e3
    if opt.linted < 1:
        fail("analysis: debug_lint linted no finalist")
    rec["debug_lint"] = {"finalists": opt.linted, "lint_ms": opt.lint_s * 1e3,
                         "choose_ms": choose_ms, "tree": str(tree)}
    del fresh

    # the launch audit of four warm runners, each call also counted by
    # torch.cuda.set_sync_debug_mode
    t_q1 = canonicalize(q1, q1_rels, {"a": 0}, options=opts)[0]
    runners = {
        "q1 count": _acquire_runner(q1, q1_rels, None, agg="count", options=opts)[0],
        "q1 agg=None": _acquire_runner(q1, q1_rels, None, agg=None, options=opts)[0],
        "star count": _acquire_runner(star, star_rels, None, agg="count", options=opts)[0],
        # the serving phase's batched q1 template, acquired as JoinServeEngine does
        "q1 batched x16": _acquire_runner(
            t_q1.query, t_q1.relations, t_q1.plan_tree, agg="count", options=opts,
            filter_vars=t_q1.filter_vars, batch=16,
            cache=_runner_cache.scoped("join-templates"))[0],
    }
    for name, runner in runners.items():
        rels = t_q1.relations if runner.batch else (star_rels if "star" in name else q1_rels)
        consts = np.zeros((16, 1), np.int32) if runner.batch else None
        runner.run_relations(rels, filter_consts=consts)  # warm: capacities settle
        box = []
        syncs = sync_count(lambda r=runner, rl=rels, c=consts: box.append(
            trace_runner(r, rl, filter_consts=c)))
        trace = box[0]
        rep = audit_runner(runner, rels, name=name, trace=trace)
        n_ops = sum(trace.ops.values()) + sum(trace.kernel_calls.values())
        rec["audit"][name] = {
            "syncs": trace.syncs, "sync_count": syncs, "read_backs": runner.warm_read_backs,
            "sync_sites": trace.sync_sites,
            "launches": {k: trace.launches[k] for k in JOIN_KERNELS},
            "ops": n_ops, "ops_limit": runner_limits(runner)["ops"],
            "ops_per_schedule_op": n_ops / schedule_ops(runner),
            "uploads": trace.uploads, "findings": [str(d) for d in rep]}
        if not rep.ok:
            fail(f"analysis: the audit of {name} found errors:\n{rep}")
        if trace.syncs != syncs:
            fail(f"analysis: {name}: the audit counted {trace.syncs} host syncs, "
                 f"set_sync_debug_mode {syncs}")

    # the submit-time lint: two invalid requests rejected, a valid one served
    _fof, triangle_at, persons = point_oracles(q1_rels["K1"])
    c = int(persons[0])
    eng = JoinServeEngine(slots=16, options=opts)
    bad = eng.submit(Query(q1.atoms, head=(*q1.head, "__alien")), q1_rels, {"a": c},
                     tenant="t0")
    unknown = eng.submit(q1, q1_rels, {"__nope": 1}, tenant="t1")
    queued = len(eng.queue)
    ok = eng.submit(q1, q1_rels, {"a": c}, tenant="t0")
    eng.run()
    if not (bad.done and isinstance(bad.error, PlanVerificationError)
            and "unbound-head-var" in bad.error.report.rules()):
        fail(f"analysis: the unbound head var was not rejected ({bad.error!r})")
    if not (unknown.done and isinstance(unknown.error, ValueError)) or queued:
        fail(f"analysis: the unknown filter var was not rejected ({unknown.error!r})")
    if ok.error is not None or ok.result != triangle_at(c):
        fail(f"analysis: the valid request after two rejections: {ok.result!r} "
             f"({ok.error!r}) != oracle {triangle_at(c)}")
    rec["submit"] = {"rejected": eng.admission.rejected,
                     "reasons": eng.admission.rejected_reasons,
                     "errors": [type(bad.error).__name__, type(unknown.error).__name__],
                     "served": {"a": c, "count": ok.result}}

    # count_query on q1 with the planner's capacities
    stats = Stats(q1_rels, cached=True)
    tree = JoinOrderOptimizer(level=opts.optimize_level, safety=opts.safety,
                              compact_threshold=opts.compact_threshold,
                              feedback=relcache.FEEDBACK).choose(q1, q1_rels, stats=stats)
    stages = stage_plans(q1, tree)
    cp = plan_chain_capacities(stages, stats=stats, safety=opts.safety,
                               compact_threshold=opts.compact_threshold,
                               feedback=relcache.FEEDBACK).stages[-1]
    if len(stages) != 1:
        fail(f"analysis: q1 planned as {len(stages)} stages, count_query takes one plan")
    t = time.perf_counter()
    count, overflow = count_query(stages[0][1], q1_rels, cp.capacities, device=device)
    rec["count_query"] = {"count": count, "overflow": overflow, "capacities": cp.capacities,
                          "s": time.perf_counter() - t}
    if overflow or count != ref["q1_count"]:
        fail(f"analysis: count_query {count} (overflow {overflow}) != oracle {ref['q1_count']}")

    # the corpus gate on the card, in process
    t = time.perf_counter()
    rc = analysis_cli.main(["--device", device])
    rec["corpus_gate"] = {"exit": rc, "s": time.perf_counter() - t}
    if rc != 0:
        fail(f"analysis: python -m repro_torch.analysis --device {device} exited {rc}")
    print("analysis: " + json.dumps(rec), flush=True)
    return rec


# ---------------------------------------------------------------------------
# the distributed path: HyperCube partition + SpmdCounter under NCCL
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def clock_line() -> str:
    """The card's SM and memory clocks (MHz), power draw and temperature
    now, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()


def spmd_cell(name, q, rels, num_shards: int, want: int, group, device: str, sync) -> dict:
    """One workload at one shard count: cold over new relation objects
    (the constructor, split into its own set-up steps, then the first
    call), then warm over the cached relations: a second SpmdCounter must
    re-partition nothing, build no trie and retry nothing; median-of-3 ms,
    one warm call's host syncs, crossings, launches and device ms, the
    needs of one warm run, and the padded fragment rows against the mean."""
    import torch

    from repro_torch.core import distributed as D
    from repro_torch.core.plan import binary2fj, factor
    from repro_torch.core.transfers import TRANSFERS

    mods = kernel_modules()
    fj = factor(binary2fj(q.atoms, q))
    fresh = fresh_copy(rels)
    D._cap_plan_cache.clear()
    torch.cuda.reset_peak_memory_stats()
    misses = (D._partition_cache.misses, D._shard_trie_cache.misses)
    t0 = time.perf_counter()
    cold = D.SpmdCounter(q, fresh, fj, num_shards=num_shards, group=group, device=device)
    sync()
    t1 = time.perf_counter()
    got = cold()
    t2 = time.perf_counter()
    if got != want:
        fail(f"distributed {name} x{num_shards} cold: {got} != oracle {want}")
    if (D._partition_cache.misses - misses[0], D._shard_trie_cache.misses - misses[1]) != (1, 1):
        fail(f"distributed {name} x{num_shards}: a cold counter over new relations did not "
             "partition and build its tries once")
    rec = {"shards": num_shards, "shares": cold.shares, "count": got,
           "cold_s": {**cold.setup_s, "constructor": t1 - t0, "first_call": t2 - t1,
                      "total": t2 - t0},
           "cold_retries": cold.retries, "cold_compiles": cold.compiles,
           "cap_plan": list(cold.cap_plan.capacities)}
    del cold, fresh
    # warm: the main path's relation objects, partitioned and planned once
    D.spmd_count(q, rels, fj, num_shards=num_shards, group=group, device=device)
    misses = (D._partition_cache.misses, D._shard_trie_cache.misses)
    ctr = D.SpmdCounter(q, rels, fj, num_shards=num_shards, group=group, device=device)
    if (D._partition_cache.misses, D._shard_trie_cache.misses) != misses:
        fail(f"distributed {name} x{num_shards}: a warm counter re-partitioned or rebuilt")
    times = []
    for i in range(4):
        t = time.perf_counter()
        got = ctr()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        if got != want:
            fail(f"distributed {name} x{num_shards} warm call {i}: {got} != oracle {want}")
    before = {k: m.launches for k, m in mods.items()}
    with TRANSFERS.record() as crossings:
        syncs = sync_count(ctr)
    launches = {k: m.launches - before[k] for k, m in mods.items()}
    # the frontier one warm run needs per node (max over shards) beside
    # its capacities, and the device time of one warm call
    _count, need_expand, _nc = ctr.run_once(ctr.cap_plan)
    dev_ms, timer = device_ms(ctr, iters=3, warmup=1)
    if ctr.retries or ctr.compiles != 1:
        fail(f"distributed {name} x{num_shards}: warm calls retried {ctr.retries} times, "
             f"built {ctr.compiles} executors")
    if [kind for kind, _w, _n in crossings] != ["read"]:
        fail(f"distributed {name} x{num_shards}: a warm call crossed {crossings}")
    shards = D.partition(q, rels, ctr.shares, num_shards)
    shard_rows = {}
    for a in q.atoms:
        rows = np.array([s[a.alias].num_rows for s in shards])
        shard_rows[a.alias] = {"padded": int(rows.max(initial=1)),
                               "mean": float(rows.sum()) / num_shards}
    rec.update(warm_ms=float(np.median(times[1:])), warm_first_ms=times[0], syncs=syncs,
               crossings=[what for _kind, what, _n in crossings], device_ms=dev_ms,
               timer=timer,
               need_expand=need_expand.tolist(),
               launches={k: launches[k] for k in JOIN_KERNELS}, shard_rows=shard_rows,
               skew={a: r["padded"] / r["mean"] if r["mean"] else None
                     for a, r in shard_rows.items()},
               peak_mib=torch.cuda.max_memory_allocated() / 2**20)
    return rec


def distributed_path(device: str, seed: int, workloads, ref, sync, host_sf: float = 1):
    """The distributed phase (see the module docstring): an NCCL group of
    one rank; spmd_count on q1 at SF 10 at 1, 4 and 8 shards and on the
    star at 4, cold then warm; distributed_join_host on q1 and friends of
    friends at SF 1, 8 shards. Prints the `distributed:` line and returns
    the kernels' largest inputs on the path: path name -> capture_largest's
    record."""
    import torch.distributed as dist

    from repro_torch.core import compiled_free_join
    from repro_torch.core import distributed as D
    from repro_torch.core.plan import binary2fj, factor
    from repro_torch.relational.datagen import lsqb_knows, lsqb_q1
    from repro_torch.relational.schema import Atom, Query

    q1, q1_rels, star, star_rels, opts = workloads
    store_path = ROOT / "build" / "nccl_store"
    store_path.parent.mkdir(exist_ok=True)
    store_path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1)
    try:
        if dist.get_backend() != "nccl":
            fail(f"distributed: the group's backend is {dist.get_backend()}, not nccl")
        group = dist.group.WORLD
        collectives = D.COLLECTIVES
        rec = {"card": card_line(), "backend": dist.get_backend(), "q1": [], "star": []}
        for num_shards in (1, 4, 8):
            rec["q1"].append(spmd_cell("q1", q1, q1_rels, num_shards, ref["q1_count"], group,
                                       device, sync))
            print(f"distributed: q1 x{num_shards} " + json.dumps(rec["q1"][-1]), flush=True)
        single = compiled_free_join(q1, q1_rels, agg="count", options=opts)
        if single != rec["q1"][0]["count"]:
            fail(f"distributed: 1 shard counted {rec['q1'][0]['count']}, "
                 f"compiled_free_join {single}")
        rec["star"].append(spmd_cell("star", star, star_rels, 4, ref["star_count"], group,
                                     device, sync))
        # the kernels' inputs on the padded configurations (1 shard pads
        # nothing), for parity: one more warm call of each, outside the
        # timed calls; and the largest probe of a table that holds pad keys
        with capture_largest() as spmd_seen, capture_largest(keep=probes_pad_key) as pad_seen:
            for query, rels, n, want in ((q1, q1_rels, 4, ref["q1_count"]),
                                         (q1, q1_rels, 8, ref["q1_count"]),
                                         (star, star_rels, 4, ref["star_count"])):
                got = D.spmd_count(query, rels, factor(binary2fj(query.atoms, query)),
                                   num_shards=n, group=group, device=device)
                if got != want:
                    fail(f"distributed x{n}: {got} != oracle {want}")
        if "hash_probe" not in pad_seen:
            fail("distributed: no probe of the padded shards held a pad key")
        rec["collectives"] = D.COLLECTIVES - collectives
        if rec["collectives"] <= 0:
            fail("distributed: no all_reduce ran under the NCCL group")
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    syncs = {c["shards"]: c["syncs"] for c in rec["q1"]}
    if len(set(syncs.values())) != 1 or max(syncs.values()) > 2:
        fail(f"distributed: warm host syncs by shard count {syncs}")
    one = rec["q1"][0]["launches"]
    rec["launch_ratio"] = {
        c["shards"]: {k: c["launches"][k] / one[k] if one[k] else None
                      for k in ("hash_probe", "csr_expand")}
        for c in rec["q1"]}

    # the host path: partition + the eager engine per shard, on the card;
    # q1, and friends of friends, whose rows are never few
    knows = lsqb_knows(sf=host_sf, seed=seed + 1)
    q, rels = lsqb_q1(knows)
    fof = Query([Atom("knows", ("a", "b"), "K1"), Atom("knows", ("b", "c"), "K2")])
    _count, tri_rows, _ = triangle_oracle(knows.columns["a"], knows.columns["b"])
    fof_rows = np.stack(two_paths(knows.columns["a"], knows.columns["b"]), axis=1)
    rec["host_path"] = {"sf": host_sf, "rows": knows.num_rows, "shards": 8}
    for name, query, want in (("q1", q, tri_rows), ("fof", fof, fof_rows)):
        t = time.perf_counter()
        got = D.distributed_join_host(query, rels, 8, agg="count", device=device)
        t_count = time.perf_counter() - t
        t = time.perf_counter()
        cols = D.distributed_join_host(query, rels, 8, device=device)
        t_rows = time.perf_counter() - t
        got_rows = head_rows(cols, query.head)
        if got != len(want) or not np.array_equal(got_rows, sorted_rows(want)):
            fail(f"distributed_join_host {name}: {got} / {len(got_rows)} rows != oracle "
                 f"{len(want)}")
        rec["host_path"][name] = {"count": got, "count_s": t_count, "rows_s": t_rows}
    with capture_largest() as host_seen:
        D.distributed_join_host(q, rels, 8, device=device)
    print("distributed: " + json.dumps(rec), flush=True)
    return {path: {name: args for name, (_size, args) in seen.items()}
            for path, seen in (("distributed SPMD", spmd_seen),
                               ("distributed SPMD pad-key probe", pad_seen),
                               ("distributed host path", host_seen))}


# ---------------------------------------------------------------------------
# phase 4e: the launch layer (fake worlds of 256 and 512 ranks)
# ---------------------------------------------------------------------------

# the LM dry-run cells traced at full width in this phase
LAUNCH_CELLS = (("qwen2-1.5b", "train_4k"), ("mixtral-8x22b", "decode_32k"))
# the (1, 1)-mesh DTensor train step against the plain step, both on the
# card: the vocab-parallel loss takes its log-sum-exp in another order than
# log_softmax (fp32 rounding of the loss), and the gradient of the logits
# differs by that rounding before the bf16 backward reads it. Measured on
# an H100 80GB HBM3 (700 W): the loss equal, the gradient norm 3.4e-4
# relative
LAUNCH_TOL = {"loss": 1e-5, "grad_norm": 1e-3}


def join_oracle(query: str, cols, dom: int) -> int:
    """Bag count of the "triangle" R(x,y) S(y,z) T(z,x) (trace of R S T
    over sparse adjacency counts) or the "clover" R(x,a) S(x,b) T(x,c)
    (the sum over x of the three degrees' product) on numpy columns."""
    import scipy.sparse as sp

    if query == "triangle":
        def m(a, b):
            return sp.csr_matrix((np.ones(len(a), np.int64), (a, b)), shape=(dom, dom))
        r, s_, t = m(cols["R"]["x"], cols["R"]["y"]), m(cols["S"]["y"], cols["S"]["z"]), \
            m(cols["T"]["z"], cols["T"]["x"])
        return int((r @ s_).multiply(t.T).sum())
    d = [np.bincount(cols[a]["x"], minlength=dom).astype(np.int64) for a in "RST"]
    return int((d[0] * d[1] * d[2]).sum())


def launch_child(what: str, out: str, seed: int) -> int:
    """Body of `chip_smoke.py --launch-child WHAT OUT`: one fake world in
    this process. "join": dryrun_join at 256 and then 512 shards on the
    card, with the kernels' launch counts set to 0 before and read after,
    their largest inputs recorded; "ARCH:SHAPE": the LM dry-run of that
    cell at full width on the single-pod mesh, fake cuda tensors (its
    microbatches=8 trace skipped). Writes its result to OUT."""
    import torch

    if what == "join":
        from repro_torch.launch import dryrun_join

        mods = kernel_modules()
        for m in mods.values():
            m.launches = 0
        with capture_largest() as seen:
            recs = (dryrun_join.lower_join(False, seed=seed)
                    + dryrun_join.lower_join(True, seed=seed))
        torch.save({"recs": recs, "launches": {name: m.launches for name, m in mods.items()},
                    "seen": {name: tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                                         for a in args)
                             for name, (_size, args) in seen.items()}}, out)
        return 0
    from repro_torch.launch import dryrun

    arch, shape = what.split(":")
    rec = dryrun.lower_cell(arch, shape, False, "cuda", mb8=False)
    Path(out).write_text(json.dumps(rec))
    return 0 if rec["status"] == "ok" else 1


def dtensor_step(device: str, seed: int, store_path: Path) -> dict:
    """make_host_mesh() over the one card under an NCCL group of one rank,
    then one qwen2-1.5b full-width train step (bf16 compute, fp32 AdamW
    moments, B = 2, S = 512) with DTensor parameters on a (1, 1) ("data",
    "model") mesh placed by param_shardings, against the plain step from
    the same seed on the same batch."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train.trainer import TrainConfig, init_train_state, make_train_step

    cfg, tcfg = get_arch("qwen2-1.5b").model, TrainConfig()
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 512)).astype(np.int32)).to(device)
             for k in ("inputs", "labels")}
    params, state = init_train_state(cfg, tcfg, seed=seed, device=device)
    _, _, want = make_train_step(cfg, tcfg)(params, state, batch)
    plain = {"loss": float(want["loss"]), "grad_norm": float(want["grad_norm"])}
    del params, state, want
    torch.cuda.empty_cache()
    store_path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1)
    try:
        host = make_host_mesh()
        if host.size() != torch.cuda.device_count() or host.mesh_dim_names != ("data",):
            fail(f"launch: make_host_mesh gave {host} over {torch.cuda.device_count()} card(s)")
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        params = dryrun.distribute_model(init_params(cfg, seed=seed, device=device), mesh)
        params.requires_grad_()
        state = opt.init_state(tcfg.adamw, params)
        dbatch = {k: dryrun.place_batch(v, mesh) for k, v in batch.items()}
        t = time.perf_counter()
        with implicit_replication():
            _, _, got = make_train_step(cfg, tcfg)(params, state, dbatch)
        sharded = {k: float(got[k].full_tensor() if hasattr(got[k], "full_tensor") else got[k])
                   for k in ("loss", "grad_norm")}
        step_s = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    rel = {k: abs(sharded[k] - plain[k]) / abs(plain[k]) for k in plain}
    for k, tol in LAUNCH_TOL.items():
        if not np.isfinite(sharded[k]) or rel[k] > tol:
            fail(f"launch: the DTensor step's {k} {sharded[k]} differs from the plain "
                 f"step's {plain[k]} by {rel[k]:.3e} (tolerance {tol})")
    return {"plain": plain, "dtensor": sharded, "rel_diff": rel, "tol": LAUNCH_TOL,
            "bitwise": all(sharded[k] == plain[k] for k in plain), "dtensor_step_s": step_s,
            "host_mesh": {"names": list(host.mesh_dim_names), "size": host.size()}}


def launch_path(device: str, seed: int) -> dict:
    """The launch phase (see the module docstring). Each fake world runs
    in a child process (one default process group a process): the join
    dry-run alone on the card first, the two LM cells on the host beside
    it; then the (1, 1)-mesh DTensor step here. The children's kernel
    launch counts are added to this process's counters, so the phase's
    counts hold them. Prints the `launch:` lines, the last with all of
    it, and returns the kernels' largest inputs on the join dry-run. No
    child outlives the phase."""
    import torch

    from repro_torch.launch import dryrun_join
    from repro_torch.relational.schema import clover_query, triangle_query

    out_dir = ROOT / "build" / "launch_phase"
    out_dir.mkdir(parents=True, exist_ok=True)
    children = []

    def start(what):
        name = what.replace(":", "_")
        log = open(out_dir / f"{name}.log", "w")
        proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--seed",
                                 str(seed), "--launch-child", what, str(out_dir / f"{name}.out")],
                                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
        children.append((proc, log))
        return what, proc

    def finish(child, timeout) -> Path:
        what, proc = child
        name = what.replace(":", "_")
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            rc = "a timeout"
        if rc != 0:
            tail = (out_dir / f"{name}.log").read_text()[-3000:]
            fail(f"launch: child {what} exited with {rc}:\n{tail}")
        return out_dir / f"{name}.out"

    t = time.perf_counter()
    try:
        cells = [start(f"{a}:{s}") for a, s in LAUNCH_CELLS]
        joined = torch.load(finish(start("join"), 600), weights_only=False)
        rec = {"card": card_line(), "join": [], "lm": [], "join_s": time.perf_counter() - t}
        mods = kernel_modules()
        for name, n in joined["launches"].items():
            mods[name].launches += n
        queries = {str(q): (name, q) for name, q in (("triangle", triangle_query()),
                                                      ("clover", clover_query()))}
        for r in joined["recs"]:
            name, q = queries[r["query"]]
            want = join_oracle(name, dryrun_join.fragment(q, r["rows_per_shard"], seed),
                               dryrun_join.DOMAIN)
            if r["count"] != want or r["overflow"] != 0:
                fail(f"launch: join dry-run {r['query']} at {r['shards']} shards counted "
                     f"{r['count']} (overflow {r['overflow']}), numpy oracle {want}")
            if r["collectives"] != {"c10d.allreduce_": 2}:
                fail(f"launch: join dry-run {r['query']}: collectives {r['collectives']}, "
                     "not two all-reduces")
            rec["join"].append({**r, "oracle": want})
            print("launch: join " + json.dumps(rec["join"][-1]), flush=True)
        rec["dtensor_step"] = dtensor_step(device, seed, ROOT / "build" / "nccl_store")
        print("launch: dtensor step " + json.dumps(rec["dtensor_step"]), flush=True)
        keep = ("arch", "shape", "status", "mesh", "seconds_to_compile", "flops",
                "bytes_accessed", "collective_bytes", "memory", "params_total")
        for child in cells:
            cell = json.loads(finish(child, 900).read_text())
            rec["lm"].append({k: cell[k] for k in keep})
            print("launch: lm " + json.dumps(rec["lm"][-1]), flush=True)
    finally:
        for proc, log in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    rec["took_s"] = time.perf_counter() - t
    print("launch: " + json.dumps(rec), flush=True)
    return {"launch path": {name: tuple(a.to(device) if isinstance(a, torch.Tensor) else a
                                        for a in args)
                            for name, args in joined["seen"].items()}}


# ---------------------------------------------------------------------------
# phase 4c: the model path (the LM stack's decode serving)
# ---------------------------------------------------------------------------

MODEL_TOL = {"reduced": 1e-4, "full": 2e-3,
             # rwkv6-1.6b at full width: fp32 rounding, amplified by the
             # depth of the network. tools/rwkv6_drift.py on an H100 80GB
             # HBM3 (700 W): each layer alone differs from a float64
             # evaluation by 5e-7 to 9e-6 on the card and on the CPU alike,
             # and so does the head (final norm and unembedding), the
             # card's float64 equals the CPU's to 2e-11, and over 24
             # layers the logits drift to 1.84e-2 (card) and 5.9e-3 (CPU)
             # from float64, 1.26e-2 from each other, largest at the first
             # 8 positions. About four times that difference:
             "rwkv6_full": 5e-2,
             # its decode logits against its prefill's, both on the card:
             # 4.2e-3 in every run of the same tool and sequences. About
             # three and a half times that; the argmax gap is twice it
             "rwkv6_decode": 1.5e-2}
GAP = 1e-3  # top-2 logit gap under which an argmax is not held to a tie-break


def max_err(a, b) -> float:
    return float((a.float().cpu() - b.float().cpu()).abs().max())


def moved(params, device):
    """A copy of a model's parameters on `device`."""
    import copy

    return copy.deepcopy(params).to(device)


def reduced_on_card(device: str, seed: int) -> dict:
    """Every reduced config in fp32: apply_model's logits and 8 decode steps
    (logits and every cache leaf) on the card against the same parameters
    on the CPU. Returns arch -> max abs error."""
    import torch

    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import transformer as tf

    errors = {}
    for i, arch in enumerate(sorted(ARCHS)):
        spec = get_arch(arch)
        cfg = spec.reduced
        cpu = tf.init_params(cfg, seed=seed + i, device="cpu")
        card = moved(cpu, device)
        rng = np.random.default_rng(seed + i)
        if spec.modality == "text":
            x = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))
        else:
            x = torch.from_numpy(rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
        err = max_err(tf.apply_model(card, cfg, x.to(device)), tf.apply_model(cpu, cfg, x))
        caches = tf.init_cache(cfg, 2, 8, device=device), tf.init_cache(cfg, 2, 8, device="cpu")
        for t in range(8):
            got, c_card = tf.decode_step(card, cfg, x[:, t:t + 1].to(device), caches[0], t)
            want, c_cpu = tf.decode_step(cpu, cfg, x[:, t:t + 1], caches[1], t)
            err = max(err, max_err(got, want),
                      *(max_err(a, b) for pa, pb in zip(c_card, c_cpu) for a, b in zip(pa, pb)))
        if not err <= MODEL_TOL["reduced"]:
            fail(f"model path: reduced {arch} on the card differs from the CPU by {err}")
        errors[arch] = err
    return errors


def serve_trace(vocab: int, seed: int, n: int = 8, max_new: int = 16):
    """n requests, prompts of 8-64 token ids from `seed`."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(8, 65))).astype(np.int32), max_new)
            for _ in range(n)]


def serve(params, cfg, trace, slots: int = 4, max_len: int = 256, on_emit=None,
          timed: bool = False):
    """Serve `trace` through one DecodeServeEngine. Returns (engine, outs,
    wall s, the host ms of each step that made one decode call)."""
    import torch

    from repro_torch.serve import DecodeServeEngine, Request

    class CountingEngine(DecodeServeEngine):
        decode_calls = 0

        def _decode(self):
            self.decode_calls += 1
            return super()._decode()

    eng = CountingEngine(params, cfg, slots=slots, max_len=max_len, on_emit=on_emit)
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(trace)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steady = []
    while eng.queue or any(eng.active):
        calls, t = eng.decode_calls, time.perf_counter()
        eng.step()  # ends in the argmax read-back: a host clock brackets the device work
        if timed and eng.decode_calls == calls + 1:
            steady.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.out) == r.max_new for r in reqs):
        fail(f"model path: {cfg.name}: a request was not served to max_new")
    return eng, [r.out for r in reqs], wall, steady


def prefill_check(params, cfg, trace, isolate: bool, tol: float = MODEL_TOL["full"],
                  gap: float = GAP, cpu_params=None, cpu_tol: float | None = None) -> dict:
    """The engine's tokens and logits against apply_model over each prompt
    plus the tokens before: its decode logits are the prefill's within
    `tol`, and every emitted token is the prefill's argmax wherever the
    prefill's top-2 gap is at least `gap`.

    With `cpu_params` (the same weights on the CPU), the card's fp32
    prefill of each sequence is also held to the CPU's within `cpu_tol`. With
    `isolate` each request
    is served alone by a fresh engine: a recurrent mixer's state is
    advanced by the steps the engine makes for the other slots (the
    reference engine's behaviour, kept), so only a lone request is the
    model's own sequence."""
    import torch

    from repro_torch.models import transformer as tf

    rows, outs = {}, []
    for group in ([item] for item in trace) if isolate else [trace]:
        def on_emit(req, pos, logits, base=len(outs)):
            rows.setdefault(base + req.rid, []).append((pos, logits))

        outs += serve(params, cfg, group, on_emit=on_emit)[1]
    device = next(params.parameters()).device
    fulls, card_vs_cpu = [], 0.0
    for (prompt, _m), out in zip(trace, outs):
        seq = torch.from_numpy(np.concatenate([prompt, np.asarray(out, np.int32)]))[None]
        fulls.append(tf.apply_model(params, cfg, seq.to(device))[0])
        if cpu_params is not None:
            card_vs_cpu = max(card_vs_cpu,
                              max_err(fulls[-1], tf.apply_model(cpu_params, cfg, seq)[0]))
    if cpu_params is not None and not card_vs_cpu <= cpu_tol:
        fail(f"model path: {cfg.name}: fp32 prefill card vs CPU {card_vs_cpu} > {cpu_tol}")
    checked = skipped = 0
    err = 0.0
    for rid, (full, out) in enumerate(zip(fulls, outs)):
        if len(rows[rid]) != len(out):
            fail(f"model path: {cfg.name} request {rid}: {len(rows[rid])} rows for "
                 f"{len(out)} tokens")
        for (pos, logits), tok in zip(rows[rid], out):
            want = full[pos]
            err = max(err, max_err(logits, want))
            top2 = torch.topk(want, 2).values
            if float(top2[0] - top2[1]) < gap:
                skipped += 1
            elif int(torch.argmax(want)) != tok:
                fail(f"model path: {cfg.name} request {rid} at {pos}: token {tok} != "
                     f"prefill argmax {int(torch.argmax(want))}")
            else:
                checked += 1
    if not err <= tol:
        fail(f"model path: {cfg.name}: decode logits differ from prefill by {err} > {tol}")
    rec = {"requests": len(trace), "tokens_checked": checked, "tokens_skipped_gap": skipped,
           "decode_vs_prefill_max_abs_err": err, "tol": tol, "gap": gap, "isolated": isolate}
    if cpu_params is not None:
        rec["prefill_card_vs_cpu_max_abs_err"] = card_vs_cpu
        rec["cpu_tol"] = cpu_tol
    return rec


def step_bytes(eng) -> int:
    """The bytes one decode step must move: every weight at the dtype the
    step reads it at (the unembedding's whole table; of an untied
    embedding table only the slots' rows) and the cache, read once."""
    cfg, params = eng.cfg, eng.params
    total = sum(p.numel() * p.element_size() for p in params.parameters())
    if not cfg.tie_embeddings:
        table = params["embed"]["table"]
        total -= table.numel() * table.element_size()
        total += eng.slots * table.shape[1] * table.element_size()
    total += sum(leaf.numel() * leaf.element_size() for pos in eng.cache for leaf in pos)
    return total


def step_ops(eng) -> int:
    """2 x slots x the product weights a step multiplies by (the embedding
    gather multiplies nothing), the attention over the cache aside."""
    table = eng.params["embed"]["table"]
    n = sum(p.numel() for p in eng.params.parameters())
    if not eng.cfg.tie_embeddings:
        n -= table.numel()
    return 2 * eng.slots * n


def steady_step(eng, trace, sync) -> dict:
    """One engine in steady decode: a new batch of requests admitted (one
    step), then one step's host syncs (sync_count), its device ms and the
    kernels it launched (torch.profiler, 5 steps), and the host ms of 5
    more steps without the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Request

    base = 1000
    for i, (prompt, _m) in enumerate(trace[:eng.slots]):
        eng.submit(Request(rid=base + i, prompt=prompt, max_new=64))
    eng.step()
    syncs = sync_count(eng.step)
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.step()
        sync()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 5 / 1e3
    if device_ms <= 0:
        fail("model path: torch.profiler recorded no device time for a decode step")
    kernels = sum(e.count for e in events) / 5
    times = []
    for _ in range(5):
        t = time.perf_counter()
        eng.step()
        times.append((time.perf_counter() - t) * 1e3)
    host_ms = float(np.median(times))
    if any(r is None for r in eng.active):
        fail("model path: a slot emptied during the steady-state steps")
    return {"syncs": syncs, "device_ms": device_ms, "device_ops": kernels, "step_ms": host_ms,
            "idle_share": 1 - device_ms / host_ms}


def bf16_cell(name, params, cfg, seed: int, sync, trace=None) -> dict:
    """The config's own dtypes: serve the 8-request trace, timed; then one
    engine in steady state; the step's bound from its bytes and ops."""
    import torch

    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    trace = trace or serve_trace(cfg.vocab, seed)
    torch.cuda.reset_peak_memory_stats()
    eng, outs, wall, steady = serve(params, cfg, trace, timed=True)
    tokens = sum(len(o) for o in outs)
    rec = {"requests": len(trace), "prompt_tokens": int(sum(len(p) for p, _m in trace)),
           "tokens": tokens, "engine_steps": eng.steps, "decode_calls": eng.decode_calls,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "median_decode_step_ms": float(np.median(steady)), "decode_steps_timed": len(steady)}
    rec["steady"] = steady_step(eng, trace, sync)
    rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    nbytes, ops = step_bytes(eng), step_ops(eng)
    bytes_ms, ops_ms = nbytes / HBM_BW * 1e3, ops / PEAK_FLOPS * 1e3
    rec["bound"] = {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "share_of_step": max(bytes_ms, ops_ms) / rec["median_decode_step_ms"]}
    print(f"model path: {name} bf16 " + json.dumps(rec), flush=True)
    return rec, outs


def full_model(name: str, seed: int, device: str, **cut):
    """A config at full width (depth cut where `cut` says), its parameters
    made on the card from `seed`. Returns (cfg, params, record)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf

    cfg = dataclasses.replace(get_arch(name).model, **cut)
    t = time.perf_counter()
    params = tf.init_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    rec = {"layers": cfg.num_layers, "d_model": cfg.d_model, "heads": cfg.num_heads,
           "kv_heads": cfg.num_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "params": n, "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
           "param_gb": sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9,
           "init_s": time.perf_counter() - t}
    return cfg, params, rec


def model_path(device: str, seed: int, sync) -> tuple:
    """The model phase (see the module docstring): the ten reduced configs
    on the card against the CPU; qwen2-1.5b whole (fp32 checks, then the
    bf16 serve); rwkv6-1.6b whole and mixtral-8x22b at full width with 2 of
    its 56 layers (bf16 serve, fp32 decode-vs-prefill at 2 requests). Prints
    the `model:` line; returns (its record, qwen2-1.5b's parameters)."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as tf

    if torch.backends.cuda.matmul.allow_tf32:
        fail("model path: TF32 is on for matmuls; the fp32 checks need it off")
    rec = {"card": card_line(), "torch": torch.__version__}
    t = time.perf_counter()
    rec["reduced_max_abs_err"] = reduced_on_card(device, seed)
    rec["reduced_s"] = time.perf_counter() - t

    # qwen2-1.5b, whole: fp32 first, then the config's own dtypes
    cfg, params, rec["qwen2-1.5b"] = full_model("qwen2-1.5b", seed, device)
    q = rec["qwen2-1.5b"]
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompt = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, (1, 16)))
    on_card = tf.apply_model(params, f32, prompt.to(device))
    cpu = moved(params, "cpu")
    q["fp32_prefill_card_vs_cpu"] = max_err(on_card, tf.apply_model(cpu, f32, prompt))
    del cpu
    if not q["fp32_prefill_card_vs_cpu"] <= MODEL_TOL["full"]:
        fail(f"model path: qwen2-1.5b fp32 prefill card vs CPU {q['fp32_prefill_card_vs_cpu']}")
    trace = serve_trace(cfg.vocab, seed)
    q["fp32_serve"] = prefill_check(params, f32, trace, isolate=False)
    print("model path: qwen2-1.5b fp32 " + json.dumps(q["fp32_serve"]), flush=True)
    q["bf16"], _outs = bf16_cell("qwen2-1.5b", params, cfg, seed, sync, trace)
    qwen2, params = params, None  # kept for the train path

    # rwkv6-1.6b, whole: the O(1)-state decode path. At full width its fp32
    # logits carry the depth's amplified rounding: the card's prefill is
    # held to the CPU's within MODEL_TOL["rwkv6_full"], the decode to the
    # prefill within MODEL_TOL["rwkv6_decode"], and a token to the argmax
    # where the top-2 gap is at least twice the latter
    cfg, params, rec["rwkv6-1.6b"] = full_model("rwkv6-1.6b", seed, device)
    cpu = moved(params, "cpu")
    tol = MODEL_TOL["rwkv6_decode"]
    rec["rwkv6-1.6b"]["fp32_serve"] = prefill_check(
        params, dataclasses.replace(cfg, compute_dtype="float32"),
        serve_trace(cfg.vocab, seed + 1, n=2), isolate=True, tol=tol, gap=2 * tol,
        cpu_params=cpu, cpu_tol=MODEL_TOL["rwkv6_full"])
    del cpu
    print("model path: rwkv6-1.6b fp32 " + json.dumps(rec["rwkv6-1.6b"]["fp32_serve"]),
          flush=True)
    rec["rwkv6-1.6b"]["bf16"], _outs = bf16_cell("rwkv6-1.6b", params, cfg, seed, sync)
    del params

    # mixtral-8x22b at full width, 2 of its 56 layers (the whole is 282 GB)
    cfg, params, rec["mixtral-8x22b"] = full_model("mixtral-8x22b", seed, device, num_layers=2)
    m = rec["mixtral-8x22b"]
    m["cut"] = "num_layers 56 -> 2"
    # every expert can take every token of a prefill (capacity = tokens), so
    # prefill drops nothing where decode's per-token capacity of 4 drops nothing
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    m["fp32_serve"] = prefill_check(params, f32, serve_trace(cfg.vocab, seed + 2, n=2),
                                    isolate=False)
    print("model path: mixtral-8x22b fp32 " + json.dumps(m["fp32_serve"]), flush=True)
    torch.cuda.empty_cache()
    m["bf16"], _outs = bf16_cell("mixtral-8x22b", params, cfg, seed, sync)
    del params
    torch.cuda.empty_cache()
    print("model: " + json.dumps(rec), flush=True)
    return rec, qwen2


# ---------------------------------------------------------------------------
# phase 4d: the train path (LM training; corpus selection through the eager
# Free Join)
# ---------------------------------------------------------------------------

TRAIN_TOL = {
    # the reduced configs, card vs CPU: the CPU tests' port-vs-jax.grad bounds
    "reduced_loss_rel": 5e-5, "reduced_grad_rel": 1e-4, "reduced_grad_abs": 1e-6,
    # qwen2-1.5b whole, fp32, B=1 S=16, card vs CPU: 28 layers at full width
    # (its fp32 prefill logits agree with the CPU's to 7.2e-6; its worst
    # gradient leaf read 6.1e-6 of the leaf's largest value on an H100,
    # so the leaf bound is about sixteen times that)
    "full_loss_rel": 1e-5, "full_grad_norm_rel": 1e-4, "full_leaf_rel": 1e-4,
    # resume from a checkpoint against an uninterrupted run, on the card
    "resume": 1e-6,
}
TRAIN_STEPS = {"warmup": 2, "timed": 8}


def train_inputs(spec, cfg, rng, shape):
    """(inputs, labels) as CPU tensors: token ids, or the stub frontend's
    float embeddings; labels with one masked (-100) position a row."""
    import torch

    if spec.modality == "text":
        x = torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(np.int32))
    else:
        x = torch.from_numpy(rng.standard_normal((*shape, cfg.d_model)).astype(np.float32))
    y = rng.integers(0, cfg.vocab, shape).astype(np.int32)
    y[:, 1] = -100
    return x, torch.from_numpy(y)


def grads_card_vs_cpu(card, cpu, cfg, x, y, device):
    """fp32 loss and gradients of the same weights and batch on the card
    and on the CPU: (card loss, CPU loss, [(card grad, CPU grad)])."""
    from repro_torch.train.trainer import _loss_and_grads

    loss, g_card = _loss_and_grads(card.requires_grad_(), cfg, x.to(device), y.to(device))
    want, g_cpu = _loss_and_grads(cpu.requires_grad_(), cfg, x, y)
    return float(loss), float(want), [(a.cpu(), b) for a, b in zip(g_card, g_cpu)]


def reduced_grads_on_card(device: str, seed: int) -> dict:
    """Every reduced config in fp32: the loss and every gradient leaf on the
    card against the same weights and batch on the CPU."""
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import transformer as tf

    out = {}
    for i, arch in enumerate(sorted(ARCHS)):
        spec = get_arch(arch)
        cfg = spec.reduced
        cpu = tf.init_params(cfg, seed=seed + i, device="cpu")
        card = moved(cpu, device)
        x, y = train_inputs(spec, cfg, np.random.default_rng(seed + i), (2, 8))
        loss, want, grads = grads_card_vs_cpu(card, cpu, cfg, x, y, device)
        if not abs(loss - want) <= TRAIN_TOL["reduced_loss_rel"] * abs(want):
            fail(f"train path: reduced {arch} loss {loss} on the card, {want} on the CPU")
        worst = 0.0
        for a, b in grads:
            bound = TRAIN_TOL["reduced_grad_rel"] * float(b.abs().max()) + \
                TRAIN_TOL["reduced_grad_abs"]
            err = float((a - b).abs().max())
            if not err <= bound:
                fail(f"train path: reduced {arch} gradient differs by {err} > {bound}")
            worst = max(worst, err / bound)
        out[arch] = {"loss_rel_err": abs(loss - want) / abs(want), "worst_grad_err_of_bound": worst}
    return out


def full_grads_on_card(params, cfg, device: str, seed: int) -> dict:
    """qwen2-1.5b whole in fp32, B=1 S=16: the card's loss, global gradient
    norm and every gradient leaf against the CPU's on the same weights."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    cpu = moved(params, "cpu")
    x, y = train_inputs(get_arch("qwen2-1.5b"), f32, np.random.default_rng(seed), (1, 16))
    loss, want, grads = grads_card_vs_cpu(params, cpu, f32, x, y, device)
    del cpu
    norm = float(torch.sqrt(sum(torch.sum(a.double() ** 2) for a, _ in grads)))
    want_norm = float(torch.sqrt(sum(torch.sum(b.double() ** 2) for _, b in grads)))
    leaf = max(float((a - b).abs().max()) / float(b.abs().max()) for a, b in grads)
    rec = {"loss": loss, "cpu_loss": want, "loss_rel_err": abs(loss - want) / abs(want),
           "grad_norm": norm, "grad_norm_rel_err": abs(norm - want_norm) / want_norm,
           "worst_leaf_err_of_leaf_max": leaf}
    if not rec["loss_rel_err"] <= TRAIN_TOL["full_loss_rel"]:
        fail(f"train path: qwen2-1.5b fp32 loss card {loss} vs CPU {want}")
    if not rec["grad_norm_rel_err"] <= TRAIN_TOL["full_grad_norm_rel"]:
        fail(f"train path: qwen2-1.5b fp32 gradient norm card {norm} vs CPU {want_norm}")
    if not leaf <= TRAIN_TOL["full_leaf_rel"]:
        fail(f"train path: qwen2-1.5b fp32 gradient leaf differs by {leaf} of its max")
    return rec


def timed_training(params, cfg, device: str, seed: int, sync, seq: int = 4096,
                   batch: int = 2) -> dict:
    """qwen2-1.5b whole at the config's own dtypes (fp32 parameters, bf16
    compute, remat on), AdamW with fp32 moments, markov_batch at seq 4,096
    and batch 2: 2 warm-up steps then 8 timed, all on one fixed batch (the
    loss must fall); one step's host syncs and one profiled step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import SHAPES
    from repro_torch.launch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.train.data import DataConfig, markov_batch
    from repro_torch.train.optimizer import init_state

    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=1000))
    step = make_train_step(cfg, tcfg)
    data = markov_batch(DataConfig(cfg.vocab, seq, batch, seed), 0)
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    params.requires_grad_()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(tcfg.adamw, params)
    losses, times, syncs = [], [], None
    for i in range(TRAIN_STEPS["warmup"] + TRAIN_STEPS["timed"]):
        t = time.perf_counter()
        if i == 1:  # a warm step, the first's one-time set-up done
            syncs = sync_count(lambda: losses.append(step(params, state, data)[2]["loss"]))
        else:
            losses.append(step(params, state, data)[2]["loss"])
        sync()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(params, state, data)
        sync()
        profiled_ms = (time.perf_counter() - t) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        fail(f"train path: qwen2-1.5b loss not finite: {losses}")
    if not (losses[-1] < losses[0] and losses[-1] < np.log(cfg.vocab)):
        fail(f"train path: qwen2-1.5b loss did not fall on one batch: {losses}")
    step_ms = float(np.median(times[TRAIN_STEPS["warmup"]:]))
    tokens = seq * batch
    shape_seq, shape_batch, _kind = SHAPES["train_4k"]
    flops = model_flops("qwen2-1.5b", "train_4k") / (shape_seq * shape_batch) * tokens
    return {"seq": seq, "batch": batch, "tokens_per_step": tokens, "losses": losses,
            "step_ms": step_ms, "step_ms_all": times, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_mib": peak, "host_syncs_per_step": syncs, "model_flops": flops,
            "mfu": flops / (step_ms / 1e3) / PEAK_FLOPS,
            "profiled_step": {"host_ms": profiled_ms, "device_ms": device_ms,
                              "device_ops": sum(e.count for e in events),
                              "idle_share": 1 - device_ms / profiled_ms,
                              "top_kernels_ms": {e.key[:80]: e.self_device_time_total / 1e3
                                                 for e in top}}}


def checkpoint_resume(device: str, seed: int) -> dict:
    """qwen2's reduced config on the card: 4 steps, save, restore into a
    fresh state (every leaf bit for bit), 4 more steps, against 8
    uninterrupted steps."""
    import tempfile

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train import AdamWConfig, TrainConfig, checkpoint, make_train_step
    from repro_torch.train.data import DataConfig, markov_batch
    from repro_torch.train.trainer import init_train_state

    cfg = get_arch("qwen2-1.5b").reduced
    tcfg = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8))
    step = make_train_step(cfg, tcfg)
    dcfg = DataConfig(cfg.vocab, 32, 4, seed)

    def run(params, state, steps):
        for i in steps:
            batch = {k: torch.from_numpy(v).to(device) for k, v in markov_batch(dcfg, i).items()}
            step(params, state, batch)

    def leaves(params, state):
        return [*params.parameters(), *state["m"].parameters(), *state["v"].parameters(),
                state["step"]]

    whole = init_train_state(cfg, tcfg, seed=seed, device=device)
    run(*whole, range(8))
    part = init_train_state(cfg, tcfg, seed=seed, device=device)
    run(*part, range(4))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        checkpoint.save(d, 4, {"params": part[0], "opt": part[1]}, cfg)
        fresh = init_train_state(cfg, tcfg, seed=seed + 1, device=device)
        checkpoint.restore(d, 4, {"params": fresh[0], "opt": fresh[1]}, cfg)
    if not all(torch.equal(a, b) for a, b in zip(leaves(*part), leaves(*fresh))):
        fail("train path: a restored leaf differs from the saved one")
    run(*fresh, range(4, 8))
    err = max(float((a.detach().float() - b.detach().float()).abs().max())
              for a, b in zip(leaves(*whole), leaves(*fresh)))
    if not err <= TRAIN_TOL["resume"]:
        fail(f"train path: resumed run differs from the uninterrupted one by {err}")
    return {"steps": 8, "saved_at": 4, "max_abs_err": err}


def compression_on_card(device: str) -> dict:
    """One compressed_psum over an NCCL group of one rank: the mean of one
    rank is its own gradient, to within the int8 step."""
    import torch
    import torch.distributed as dist

    from repro_torch.train.compression import compressed_psum, init_error

    store_path = ROOT / "build" / "nccl_store_train"
    store_path.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store_path), 1), rank=0,
                            world_size=1)
    try:
        g = {"w": torch.randn(1024, 1024, device=device)}
        out, err = compressed_psum(g, init_error(g))
        step = float(g["w"].abs().max()) / 127
        gap = float((out["w"] - g["w"]).abs().max())
        if not (dist.get_backend() == "nccl" and gap <= step / 2 * 1.001
                and torch.equal(out["w"] + err["w"], g["w"])):
            fail(f"train path: compressed_psum off by {gap} (int8 step {step})")
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    return {"backend": "nccl", "max_abs_err": gap, "int8_step": step}


def launch_train(device: str) -> dict:
    """python -m repro_torch.launch.train --device cuda --steps 20 on the
    reduced config, with a temporary --ckpt-dir: it runs, logs, saves."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device", device,
             "--steps", "20", "--ckpt-dir", d, "--ckpt-every", "10", "--log-every", "10"],
            capture_output=True, text=True, timeout=300, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        wall = time.perf_counter() - t
        saved = sorted(os.listdir(d))
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines or lines[-1] != "done" or \
            saved != ["step_00000010", "step_00000020"]:
        fail(f"train path: launch.train exited {res.returncode}: {res.stderr[-2000:]}")
    return {"wall_s": wall, "log": lines[-3:-1], "checkpoints": saved}


def corpus_relations(n: int, seed: int):
    """Docs/Quality/Dedup of n documents, made as examples/analytics_pipeline.py
    makes them (20 % of documents duplicates of another)."""
    from repro_torch.relational.relation import Relation

    rng = np.random.default_rng(seed)
    doc = np.arange(n, dtype=np.int64)
    docs = Relation("Docs", {"doc": doc, "shard": rng.integers(0, 64, n),
                             "lang": rng.integers(0, 30, n)})
    quality = Relation("Quality", {"doc": doc, "score": rng.integers(0, 100, n)})
    canonical = doc.copy()
    dup = rng.random(n) < 0.2
    canonical[dup] = rng.integers(0, n, int(dup.sum()))
    return docs, quality, Relation("Dedup", {"doc": doc, "canonical": canonical})


def corpus_selection(device: str, seed: int, sync, n: int = 10_000_000,
                     min_quality: int = 60):
    """select_corpus_samples over n documents on `device`, equal to the
    numpy oracle; the largest kernel calls recorded."""
    from repro_torch.train.data import select_corpus_samples

    rels = corpus_relations(n, seed)
    with capture_largest() as seen:
        t = time.perf_counter()
        keep = select_corpus_samples(*rels, min_quality, device=device)
        sync()
        ms = (time.perf_counter() - t) * 1e3
    score, canonical = rels[1].columns["score"], rels[2].columns["canonical"]
    want = np.flatnonzero((score >= min_quality) & (canonical == rels[2].columns["doc"]))
    if not np.array_equal(keep, want):
        fail(f"train path: corpus selection kept {len(keep)} docs, the oracle {len(want)}")
    return ({"docs": n, "min_quality": min_quality, "kept": len(keep), "ms": ms},
            {name: args for name, (_size, args) in seen.items()})


def train_path(device: str, seed: int, sync, qwen2) -> tuple:
    """The train phase (see the module docstring). `qwen2` is qwen2-1.5b's
    full-width parameters from the model phase. Prints the `train:` line;
    returns (its record, the corpus join's largest kernel inputs)."""
    import torch

    from repro_torch.configs import get_arch

    if torch.backends.cuda.matmul.allow_tf32:
        fail("train path: TF32 is on for matmuls; the fp32 checks need it off")
    cfg = get_arch("qwen2-1.5b").model
    rec = {"card": card_line(), "torch": torch.__version__}
    parts = [("reduced", lambda: reduced_grads_on_card(device, seed)),
             ("qwen2_fp32_grads", lambda: full_grads_on_card(qwen2, cfg, device, seed)),
             ("qwen2_timed", lambda: timed_training(qwen2, cfg, device, seed, sync)),
             ("checkpoint_resume", lambda: checkpoint_resume(device, seed)),
             ("compressed_psum", lambda: compression_on_card(device)),
             ("launch_train", lambda: launch_train(device))]
    for name, part in parts:
        t = time.perf_counter()
        rec[name] = part()
        rec[name + "_s"] = time.perf_counter() - t
        print(f"train path: {name} " + json.dumps(rec[name]), flush=True)
    del qwen2
    torch.cuda.empty_cache()
    rec["corpus"], seen = corpus_selection(device, seed, sync)
    print("train: " + json.dumps(rec), flush=True)
    return rec, seen


# ---------------------------------------------------------------------------
# the eager path: free_join, binary_join, generic_join, the hybrid baseline
# ---------------------------------------------------------------------------


def sync_count(fn) -> int:
    """Host synchronizations `fn` makes: the warnings of
    torch.cuda.set_sync_debug_mode("warn"), one per synchronizing call
    (torch's one-time notice that the mode is a prototype is not one)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(w.message) for w in seen)


def timed_calls(name, fn, want, sync, reps: int = 3) -> dict:
    """fn() once, then `reps` times more, each call ending in a synchronize
    and its result held against `want`. Returns the first call's host ms,
    the median of the later calls', peak device memory and the kernels
    launched."""
    import torch

    mods = kernel_modules()
    before = {k: m.launches for k, m in mods.items()}
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(reps + 1):
        t = time.perf_counter()
        out = fn()
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        if out != want:
            fail(f"{name} call {i}: {out} != oracle {want}")
    return {"first_ms": times[0], "median_ms": float(np.median(times[1:])),
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
            "launches": {k: m.launches - before[k] for k, m in mods.items()}}


def chain4_workload(seed: int, n: int = 60_000, dom: int = 4_000):
    """The stage replay's 4-chain (the draws of stage_replay's relations,
    those of benchmarks/bench_streaming.py): R(a,b) S(b,c) T(c,d) U(d,e),
    plan (R⋈S)⋈(T⋈U). Returns (query, plan, relations)."""
    from repro_torch.core.plan import BinaryPlan
    from repro_torch.relational.relation import Relation
    from repro_torch.relational.schema import Atom, Query

    rng = np.random.default_rng(seed)
    q = Query([Atom("R", ("a", "b")), Atom("S", ("b", "c")), Atom("T", ("c", "d")),
               Atom("U", ("d", "e"))])
    at = {a.alias: a for a in q.atoms}
    tree = BinaryPlan(BinaryPlan(at["R"], at["S"]), BinaryPlan(at["T"], at["U"]))
    rels = {a.alias: Relation(a.alias, {v: rng.integers(0, dom, n).astype(np.int32)
                                        for v in a.vars}) for a in q.atoms}
    return q, tree, rels


def eager_oracles(seed: int, workloads, sync) -> dict:
    """What the eager path is held against and timed beside: the numpy
    oracles of q1 (count and rows), the star and the 4-chain, and the
    compiled path on the same queries (its warm q1 count and rows, the
    chained 4-chain count). Runs outside the eager path's launch count."""
    from repro_torch.core import compiled_free_join, materialize

    q1, q1_rels, star, star_rels, opts = workloads
    knows = q1_rels["K1"]
    tri_count, tri_rows, _ = triangle_oracle(knows.columns["a"], knows.columns["b"])
    star_dom = 1 + max(int(r.columns["y"].max()) for r in star_rels.values())
    chain = chain4_workload(seed)
    ref = {"q1_count": tri_count, "q1_rows": sorted_rows(tri_rows),
           "star_count": star_oracle(star_rels, star_dom), "chain4": chain,
           "chain4_count": chain4_oracle(chain[2])}
    ref["q1 compiled_free_join (warm)"] = timed_calls(
        "q1 compiled_free_join", lambda: compiled_free_join(q1, q1_rels, agg="count",
                                                            options=opts), tri_count, sync)
    q, tree, rels = chain
    ref["chain4 compiled_free_join (chained)"] = timed_calls(
        "chain4 compiled_free_join", lambda: compiled_free_join(q, rels, tree, agg="count",
                                                                options=opts),
        ref["chain4_count"], sync)
    bound, mult = compiled_free_join(q1, q1_rels, agg=None, options=opts)
    ref["q1_compiled_rows"] = head_rows(materialize(bound, mult, q1.head), q1.head)
    return ref


def head_rows(cols, head) -> np.ndarray:
    """Materialized result columns as sorted (M, len(head)) rows."""
    return sorted_rows(np.stack([cols[v] for v in head], axis=1))


def eager_path(device: str, seed: int, workloads, ref, sync, tuples_sf: float = 0.1,
               parity_sf: float = 1.0):
    """The eager engine on the card, every result held against a numpy
    oracle (`ref`, from eager_oracles). LSQB q1 at SF 10 (the main path's
    `knows`) through free_join in modes colt, slt and simple, binary_join
    and generic_join (counts), and free_join(agg=None), whose rows must
    equal the oracle's and compiled_free_join's; the low-selectivity star
    (the main path's) through free_join and binary_join; the stage
    replay's 4-chain through the hybrid
    compiled_free_join(ExecOptions(chain_stages=False)) and eager
    free_join; execute_tuples at batch 1000 on q1 at SF `tuples_sf`, whose
    tuples must equal free_join's; and eager free_join(agg=None) on q1 at
    SF `parity_sf` on the card and on the CPU (the kernels' plain
    versions), equal element for element, with the 2-path over the same
    table beside it. Per engine (timed_calls): first
    and median host ms, peak device memory, kernels launched; the compiled
    path's warm ms beside them; for one eager q1 count its device idle
    share, device ops and host profile (profile_run), and its host
    synchronizations. One more eager q1 call runs with the kernels' inputs
    recorded; returns them."""
    from repro_torch.core import (
        ExecOptions,
        binary2fj,
        binary_join,
        compiled_free_join,
        factor,
        free_join,
        generic_join,
        materialize,
        optimize,
        to_sorted_tuples,
    )
    from repro_torch.core.tuple_engine import execute_tuples
    from repro_torch.relational.datagen import lsqb_knows, lsqb_q1
    from repro_torch.relational.schema import Query

    q1, q1_rels, star, star_rels, _opts = workloads
    rec = {"q1_rows": q1_rels["K1"].num_rows, "q1_count": ref["q1_count"],
           "star_count": ref["star_count"], "chain4_count": ref["chain4_count"]}

    def timed(name, fn, want):
        rec[name] = timed_calls(f"eager path: {name}", fn, want, sync)

    for mode in ("colt", "slt", "simple"):
        timed(f"q1 free_join {mode}", lambda: free_join(q1, q1_rels, mode=mode, agg="count",
                                                        device=device), ref["q1_count"])
    # the same call with the plan given: the engine without the host's
    # plan choice (optimize np.unique's every column, every call)
    q1_tree = optimize(q1, q1_rels)
    timed("q1 free_join colt, plan given",
          lambda: free_join(q1, q1_rels, q1_tree, agg="count", device=device), ref["q1_count"])
    timed("q1 binary_join", lambda: binary_join(q1, q1_rels, agg="count", device=device),
          ref["q1_count"])
    timed("q1 generic_join", lambda: generic_join(q1, q1_rels, agg="count", device=device),
          ref["q1_count"])
    rec["q1 compiled_free_join (warm)"] = ref["q1 compiled_free_join (warm)"]
    bound, mult = free_join(q1, q1_rels, device=device)
    got = head_rows(materialize(bound, mult, q1.head), q1.head)
    for name, want in (("the oracle's", ref["q1_rows"]),
                       ("compiled_free_join's", ref["q1_compiled_rows"])):
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"eager path: q1 free_join(agg=None) rows differ from {name}")
    rec["q1_result_rows"] = len(got)

    def one_call():
        t = time.perf_counter()
        free_join(q1, q1_rels, agg="count", device=device)
        sync()
        return (time.perf_counter() - t,)

    rec["q1 free_join colt profile"] = profile_run(one_call, one_call)
    rec["q1 free_join colt host syncs"] = sync_count(one_call)

    timed("star free_join", lambda: free_join(star, star_rels, agg="count", device=device),
          ref["star_count"])
    timed("star binary_join", lambda: binary_join(star, star_rels, agg="count", device=device),
          ref["star_count"])
    star_tree = optimize(star, star_rels)
    timed("star free_join, plan given",
          lambda: free_join(star, star_rels, star_tree, agg="count", device=device),
          ref["star_count"])

    q, tree, chain = ref["chain4"]
    hybrid = ExecOptions(device=device, chain_stages=False)
    timed("chain4 hybrid compiled_free_join",
          lambda: compiled_free_join(q, chain, tree, agg="count", options=hybrid),
          ref["chain4_count"])
    timed("chain4 free_join", lambda: free_join(q, chain, tree, agg="count", device=device),
          ref["chain4_count"])
    rec["chain4 compiled_free_join (chained)"] = ref["chain4 compiled_free_join (chained)"]

    small_q, small_rels = lsqb_q1(lsqb_knows(sf=tuples_sf, seed=seed + 1))
    fj = factor(binary2fj(small_q.atoms, small_q))
    t = time.perf_counter()
    tuples = sorted(execute_tuples(fj, small_rels, batch_size=1000, device=device))
    rec["execute_tuples"] = {"sf": tuples_sf, "rows": small_rels["K1"].num_rows,
                             "batch": 1000, "s": time.perf_counter() - t,
                             "tuples": len(tuples)}
    if tuples != to_sorted_tuples(free_join(small_q, small_rels, device=device), small_q.head):
        fail("eager path: execute_tuples' tuples differ from free_join's")

    # q1 at SF 1 and, since its triangles are few (or none), the 2-path
    # knows(a,b), knows(b,c) over the same table: a result that is not
    # empty, through expansions, probes, compactions and sorts
    mid_q, mid_rels = lsqb_q1(lsqb_knows(sf=parity_sf, seed=seed + 1))
    two_path = Query(list(mid_q.atoms[:2]))
    rec["card_equals_cpu"] = {"sf": parity_sf, "rows": mid_rels["K1"].num_rows}
    for name, q in (("q1", mid_q), ("2-path", two_path)):
        t = time.perf_counter()
        (gb, gm), (cb, cm) = (free_join(q, mid_rels, device=dev) for dev in (device, "cpu"))
        if set(gb) != set(cb) or not all(np.array_equal(gb[v], cb[v]) for v in cb) \
                or not np.array_equal(gm, cm):
            fail(f"eager path: free_join of {name} on the card differs from the CPU's")
        rec["card_equals_cpu"][name] = {"result_rows": len(cm), "mult_sum": int(cm.sum()),
                                        "s": time.perf_counter() - t}
    print("eager path: " + json.dumps(rec), flush=True)
    with capture_largest() as seen:
        free_join(q1, q1_rels, device=device)
    return {name: args for name, (_size, args) in seen.items()}


# ---------------------------------------------------------------------------
# K5's path: ops.intersect_sorted
# ---------------------------------------------------------------------------


def intersect_shapes(seed: int, device) -> dict[str, tuple]:
    """K5's two shapes besides the knows one, as device tensors (queries a,
    sorted distinct keys b): the reference's kern.intersect.100k
    (benchmarks/bench_kernels.py:48, Generic Join's sorted case: 100,000
    sorted draws from [0, 2^30) into the sorted distinct keys of 100,000
    more; bound by the launch) and large N (4,194,304 queries, half drawn
    from b and half from [0, 2^24), into 2,097,152 distinct keys from
    [0, 2^24): b is 8 MB, larger than any shared memory)."""
    import torch

    rng = np.random.default_rng(seed)
    a = np.sort(rng.integers(0, 2**30, 100_000).astype(np.int32))
    shapes = {"sorted_100k": (a, np.unique(rng.integers(0, 2**30, 100_000).astype(np.int32)))}
    b = np.sort(rng.permutation(1 << 24)[: 1 << 21]).astype(np.int32)
    a = np.concatenate([b[rng.integers(0, len(b), 1 << 21)],
                        rng.integers(0, 1 << 24, 1 << 21).astype(np.int32)])
    shapes["large_n"] = (rng.permutation(a), b)
    return {k: tuple(torch.as_tensor(x).to(device) for x in ab) for k, ab in shapes.items()}


def intersect_numpy(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K5's function from numpy's searchsorted: (mask, pos)."""
    pos = np.searchsorted(b, a)
    mask = (pos < len(b)) & (b[np.minimum(pos, len(b) - 1)] == a)
    return mask, np.where(mask, pos, -1)


def intersect_path(knows, device):
    """ops.intersect_sorted(a, b) at the size LSQB SF 10 gives it: b the
    sorted distinct knows sources, a every knows destination. Checked
    against numpy. Returns the arguments the kernel was launched with."""
    import torch
    from repro_torch.kernels import ops

    b_host = np.unique(knows.columns["a"]).astype(np.int32)
    a_host = knows.columns["b"].astype(np.int32)
    a, b = torch.as_tensor(a_host).to(device), torch.as_tensor(b_host).to(device)
    mask, pos = ops.intersect_sorted(a, b)
    want_mask, want_pos = intersect_numpy(a_host, b_host)
    if not (np.array_equal(mask.cpu().numpy(), want_mask)
            and np.array_equal(pos.cpu().numpy(), want_pos)):
        fail("intersect_sorted differs from numpy's searchsorted on the knows input")
    print(f"intersect path: {len(a_host)} queries into {len(b_host)} sorted keys, "
          f"{int(want_mask.sum())} members", flush=True)
    return a, b


# ---------------------------------------------------------------------------
# phase 3: kernel inputs from the main path, parity
# ---------------------------------------------------------------------------


@contextmanager
def capture_largest(keep=None):
    """Record (cloned) the largest call of each kernel wrapper made while
    the context is open, at the sites the main path calls them from; an
    expansion's size is its capacity times its search depth. `keep(name,
    args)`, if given, picks the calls that may be recorded."""
    import torch
    from repro_torch.kernels import ops, radix_sort

    seen: dict[str, tuple] = {}

    def wrap(owner, attr, name, size_of):
        orig = getattr(owner, attr)

        def recorder(*args):
            size = size_of(*args)
            if (name not in seen or size > seen[name][0]) and (keep is None or keep(name, args)):
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
        # the same pass's segment starts and digits, for K4's library call
        wrap(radix_sort, "_radix_pass", "radix_pass", lambda p, st, sl, d: p.shape[0]),
    ]
    try:
        yield seen
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)


def probes_pad_key(name, args) -> bool:
    """Whether a call is a probe of a table holding a key with a negative
    column: the SPMD path's pad sentinels, which no other path has."""
    return name == "hash_probe" and bool((args[1] < 0).any())


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
    one-row table, all -1 query lanes, a table of negative (pad) keys, and
    total/live = 0."""
    import torch
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32)).to(device)  # noqa: E731
    one = ops.build_table(t([[5, 9]]))
    many = ops.build_table(t(np.unique(rng.integers(0, 1 << 20, (3000, 2)), axis=0)))
    ragged_q = np.vstack([np.asarray(many.keys.cpu())[:500], rng.integers(0, 1 << 20, (533, 2))])
    # a padded shard's table: real keys, then the SPMD path's pad sentinels
    # -(offset + row) - 1 in every column, and the most negative int32 key
    sentinels = -(1_000 + np.arange(2_000)) - 1
    padded_keys = np.vstack([np.asarray(many.keys.cpu())[:1000],
                             np.stack([sentinels, sentinels], axis=1),
                             [[np.iinfo(np.int32).min, 7]]])
    padded = ops.build_table(t(padded_keys))
    padded_q = np.vstack([padded_keys[::3], padded_keys[:3000:5] - 1, -padded_keys[1000:3000:7]])
    cases = {
        "hash_probe": [
            (one.slots, one.keys, t([[5, 9], [9, 5], [-1, 9]]), 32),
            (many.slots, many.keys, t(np.full((1033, 2), -1)), 32),
            (many.slots, many.keys, t(ragged_q), 32),
            (padded.slots, padded.keys, t(padded_q), 32),
        ],
    }
    counts = rng.integers(0, 5, 777)
    cum = np.cumsum(counts)
    starts, base = t(cum - counts), t(rng.integers(0, 10**6, 777))

    def expand(counts, cap):
        cum = np.cumsum(counts)
        return t(cum - counts), t(rng.integers(0, 10**6, len(counts))), t([int(cum[-1])]), cap

    # the shapes a tiled merge gets wrong (K2 merges 2,304 items a block, K3 1,792)
    hub = rng.integers(0, 7, 60_000)
    hub[31_337] = 100_000  # one row over 100,000 slots
    empty_run = rng.integers(0, 7, 60_000)
    empty_run[5_000:55_000] = 0  # 50,000 zero-count rows in a row
    cases["csr_expand"] = [
        (starts, base, t([int(cum[-1])]), 1500),
        (starts, base, t([0]), 1037),
        (t([0]), t([3]), t([5]), 1024 + 5),
        expand(hub, int(hub.sum()) + 1001),
        expand(hub, 200_000),  # total > capacity
        expand(empty_run, int(empty_run.sum()) + 7),
    ]
    valid = rng.random(3001) < 0.3
    csum = np.cumsum(valid)
    dead_run = rng.random(60_000) < 0.5
    dead_run[5_000:55_000] = False  # 50,000 dead lanes in a row
    dcsum = np.cumsum(dead_run)
    cases["compact"] = [
        (t(csum), t([int(csum[-1])]), 1000 + 11),
        (t(np.zeros(513)), t([0]), 1024),
        (t([1]), t([1]), 3),
        (t(dcsum), t([int(dcsum[-1])]), int(dcsum[-1]) + 3),
        (t(dcsum), t([int(dcsum[-1])]), 1000),  # live > capacity
    ]
    digit = rng.integers(0, 16, 1013)
    rcsum = np.cumsum(np.arange(16)[:, None] == digit[None, :], axis=1)  # digit-major
    cases["radix_rank"] = [
        (t(rcsum), t(digit), t(rng.integers(0, 70, 1013))),
        (t(rcsum[:, :1]), t([digit[0]]), t([1])),
    ]
    b = np.unique(rng.integers(0, 1 << 20, 10_000))[:5000]
    lo32, hi32 = -(2**31), 2**31 - 1
    full = np.unique(np.concatenate([[lo32, hi32], rng.integers(lo32, hi32, 3000)]))
    dense = np.append(np.arange(1000, 51_000), hi32)  # 50,000 keys and one far outlier
    cases["intersect"] = [
        (t([7, 3, -1, 8, hi32, lo32]), t([7])),  # N = 1 (span 0)
        (t([lo32, hi32, 0, -5, lo32 + 1, hi32 - 1]), t([lo32, hi32])),  # N = 2, span 2^32 - 1
        (t(rng.integers(0, 1 << 20, 1033)), t(b)),  # Q not a multiple of any tile
        (t(b[rng.integers(0, len(b), 3001)]), t(b)),  # all hits
        (t(np.setdiff1d(rng.integers(0, 1 << 20, 2000), b)), t(b)),  # all misses
        (t(np.concatenate([rng.integers(-(2**31), int(b[0]), 500),
                           rng.integers(int(b[-1]) + 1, 2**31 - 1, 500)])), t(b)),  # outside
        (t(np.concatenate([full[rng.integers(0, len(full), 4000)],
                           rng.integers(lo32, hi32, 4099), [lo32, hi32, 0, -1]])), t(full)),
        (t(np.concatenate([rng.integers(0, 60_000, 5000), [hi32, hi32 - 1, 1000, 50_999,
                                                            51_000]])), t(dense)),
        (t(np.arange(0, 300_100, 3)), t(np.arange(17, 300_017))),  # full 32-id buckets
        (t([b[0], b[-1], b[0] - 1, b[-1] + 1, b[-1], b[0]]), t(b)),  # at b[0] and b[N-1]
        (t([b[17]]), t(b)),  # Q = 1
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


def parity(mods, captured, streamed, eager, paths, k5_shapes, device):
    """Exact equality of each kernel and its plain version, on the largest
    input its path gave it (`captured`; `paths` names the path), the
    streaming path's largest (`streamed`: one standing-q1 ingest's, and
    the stage replay's registration and first batch's), the eager path's
    (`eager`: one free_join(agg=None) of q1 at SF 10), for K5 its other
    shapes (`k5_shapes`), and the edge cases; every K5 result also equals
    numpy's. Returns name -> max abs error on the `captured` input, and
    "intersect <shape>" -> that on each of K5's other shapes."""
    errors = {}
    cases = edge_cases(device)
    for name in JOIN_KERNELS:
        if not any(name in seen for seen in streamed.values()):
            fail(f"{name}: the streaming path gave it no input to compare on")
        if name not in eager:
            fail(f"{name}: the eager path gave it no input to compare on")
    streamed = {**streamed, "eager q1": eager}
    for name in KERNELS:
        if name not in captured:
            fail(f"{name}: the {paths[name]} gave it no input to compare on")
        where = [(paths[name], captured[name])] + [
            (path, seen[name]) for path, seen in streamed.items() if name in seen]
        if name == "intersect":
            where += [(f"{shape} shape", args) for shape, args in k5_shapes.items()]
        for i, args in enumerate([args for _p, args in where] + cases[name]):
            got = wrapper_of(mods, name)(*args)
            want = plain_of(mods, name)(*args)
            shapes_ok = all(g.shape == w.shape and g.dtype == w.dtype
                            for g, w in zip(as_list(got), as_list(want)))
            err = max_abs_err(got, want) if shapes_ok else None
            if err != 0:
                fail(f"{name}: kernel differs from its plain version on case {i} (err {err})")
            if name == "intersect" and not all(
                    np.array_equal(g.cpu().numpy(), w) for g, w in
                    zip(got, intersect_numpy(*(x.cpu().numpy() for x in args)))):
                fail(f"intersect: kernel differs from numpy's searchsorted on case {i}")
            if i == 0:
                errors[name] = err
            elif i < len(where) and where[i][0].endswith(" shape"):
                errors[f"{name} {where[i][0].removesuffix(' shape')}"] = err
        inputs = ", ".join(f"the {p}'s largest input" if "shape" not in p else f"the {p}"
                           for p, _a in where)
        print(f"parity: {name} exact on {inputs} and {len(cases[name])} edge cases", flush=True)
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
    compare/select/arithmetic steps of the work this data needs. K2 and K3
    compute ub(j), the count of a monotone array's entries <= j, for
    consecutive slots: one compare and one select per entry and per slot,
    whatever implements it."""
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
        return nb(starts) + nb(base) + 4 + 8 * cap, 2 * (starts.shape[0] + max(live, 0))
    if name == "compact":
        csum, live, cap = args
        n_live = min(cap, int(live))
        return nb(csum) + 4 + 4 * cap, 2 * (csum.shape[0] + max(n_live, 0))
    if name == "intersect":
        a, b = args
        q, n = a.shape[0], b.shape[0]
        # a read, b read, mask (1 byte) and pos (4 bytes) written; a
        # compare, a select and two index updates per search step
        return 4 * q + 4 * n + q + 4 * q, q * (4 * n.bit_length() + 3)
    csum, kd, kt = args
    return (nb(csum) + nb(kd) + nb(kt) + 4 * kd.shape[0],
            kd.shape[0] * 4 * kd.shape[0].bit_length())


def library_call(name, args, captured=None):
    """One PyTorch call computing the same function, where there is one.
    K4's is a stable argsort over the pass's composite (segment, digit)
    key, which must give the kernel's permutation; K5's a searchsorted
    plus the gather, compare and select that make it the same function."""
    import torch

    if name == "radix_rank":
        _perm, starts, _seg_last, digit = captured["radix_pass"]
        key = starts.to(torch.int64) * 16 + digit.to(torch.int64)  # segments ascend
        if not torch.equal(torch.argsort(key, stable=True).to(torch.int32),
                           wrapper_of(kernel_modules(), name)(*args)):
            fail("radix_rank: argsort over (segment, digit) is not the kernel's permutation")
        return lambda: torch.argsort(key, stable=True)
    if name == "intersect":
        a, b = args
        n = b.shape[0]

        def searchsorted_membership():
            pos = torch.searchsorted(b, a, out_int32=True)
            hit = (pos < n) & (b[pos.clamp(max=n - 1)] == a)
            return hit, torch.where(hit, pos, -1)

        return searchsorted_membership
    if name == "csr_expand":
        starts, _base, _total, cap = args
        j = torch.arange(cap, dtype=torch.int32, device=starts.device)
        return lambda: torch.searchsorted(starts, j, right=True)
    if name == "compact":
        csum, _live, cap = args
        target = torch.arange(1, cap + 1, dtype=torch.int32, device=csum.device)
        return lambda: torch.searchsorted(csum, target)
    return None


def time_kernel(mods, name, args, captured=None) -> dict:
    """Device time of kernel `name`, its plain version and the library
    call on one input, beside the bound; the CUDA-event time per call
    beside them. L2 is warm: the same inputs are reused across the timed
    calls."""
    from repro_torch.launch.roofline import HBM_BW

    kernel, plain = wrapper_of(mods, name), plain_of(mods, name)
    lib = library_call(name, args, captured)
    ms, timer = device_ms(lambda: kernel(*args))
    plain_ms, _ = device_ms(lambda: plain(*args), iters=5, warmup=1)
    nbytes, ops = bounds(name, args)
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": device_ms(lib)[0] if lib is not None else None,
        "timer": timer,
        "wall_ms": wall_ms(lambda: kernel(*args)),
        "plain_wall_ms": wall_ms(lambda: plain(*args), iters=5, warmup=1),
        "shape": [list(a.shape) if hasattr(a, "shape") else a for a in args],
    }


def timing(mods, captured, launches, other_launches, errors, paths, k5_shapes):
    """One record per kernel, timed on the largest input of its path; K5's
    record also holds its other shapes, each timed the same way.
    `other_launches` maps a record key ("eager_launches", ...) to the
    kernels' counts on that path."""
    records = []
    for name, (_m, source, replaces) in KERNELS.items():
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name],
               **{key: counts[name] for key, counts in other_launches.items()},
               "path": paths[name],
               "parity": "exact", "max_abs_err": errors[name]}
        rec.update(time_kernel(mods, name, captured[name], captured))
        if name == "intersect":
            rec["shapes"] = [{"name": shape, "max_abs_err": errors[f"{name} {shape}"],
                              **time_kernel(mods, name, args)}
                             for shape, args in k5_shapes.items()]
        records.append(rec)
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
        runner, _rels, _cacheable, _tree = _acquire_runner(q, fresh, None, agg="count",
                                                           options=opts)
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
    ap.add_argument("--launch-child", nargs=2, metavar=("WHAT", "OUT"), default=None,
                    help=argparse.SUPPRESS)  # the launch phase's fake worlds
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if args.launch_child:
        return launch_child(*args.launch_child, args.seed)
    from repro_torch.kernels import _build

    device = "cuda"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t = time.perf_counter()
    logs = _build.build(verbose=True)
    print(f"build: {len(logs)} kernels in {time.perf_counter() - t:.3f} s (parallel nvcc)")
    for name, log in logs.items():
        for fn, line in ptxas_report(log):
            print(f"build: {name}: {fn}: {line}")

    mods = kernel_modules()

    def drive(path, kernels, fn, *fargs, **fkw):
        """Run one path with every launch count set to 0 just before it and
        read just after; fail if a kernel of the path never launched."""
        for m in mods.values():
            m.launches = 0
        t = time.perf_counter()
        out = fn(*fargs, **fkw)
        counts = {name: m.launches for name, m in mods.items()}
        print(f"{path} launches: " + json.dumps(counts), flush=True)
        print(f"{path} took {time.perf_counter() - t:.1f} s", flush=True)
        for name in kernels:
            if counts[name] <= 0:
                fail(f"{name}: the {path} never launched the kernel")
        return out, counts

    sync = torch.cuda.synchronize
    workloads, launches = drive("main path", JOIN_KERNELS, main_path, device, args.seed,
                                sf=10, star_n=6_000_000, star_dom=300_000, sync=sync)
    paths = dict.fromkeys(JOIN_KERNELS, "main path")
    # the streaming path: the standing SF 10 triangle and the stage replay
    (q1_seen, replay_seen), _ = drive("streaming path", JOIN_KERNELS, lambda: (
        streaming_triangle(device, args.seed, sf=10, sync=sync),
        stage_replay(device, args.seed, sync=sync)))
    # the serving path: batched and serial drains at SF 10, then chaos at SF 1
    serving_seen, serving_launches = drive("serving path", JOIN_KERNELS, serving_path, device,
                                           args.seed, workloads, sync)
    _, chaos_launches = drive("chaos path", JOIN_KERNELS, chaos_path, device, args.seed, sync)
    rewarm(workloads)
    eager_ref = eager_oracles(args.seed, workloads, sync)
    eager_seen, eager_launches = drive("eager path", JOIN_KERNELS, eager_path, device,
                                       args.seed, workloads, eager_ref, sync)
    _, analysis_launches = drive("analysis path", JOIN_KERNELS, analysis_path, device,
                                 args.seed, workloads, eager_ref, sync)
    distributed_seen, distributed_launches = drive("distributed path",
                                                   ("hash_probe", "csr_expand"),
                                                   distributed_path, device, args.seed,
                                                   workloads, eager_ref, sync)
    # the LM stack launches none of K1-K5: its counts say so
    (_, qwen2), model_launches = drive("model path", (), model_path, device, args.seed, sync)
    if any(model_launches.values()):
        fail(f"model path: launched a join kernel: {model_launches}")
    # training launches none either; its corpus selection is a Free Join
    (_, train_seen), train_launches = drive("train path", ("hash_probe",), train_path, device,
                                            args.seed, sync, qwen2)
    del qwen2
    # the launch layer: fake worlds in child processes, K1, K2 and K4 on the
    # join dry-run's trie builds, probes and expansions
    launch_seen, launch_launches = drive("launch path", ("hash_probe", "csr_expand",
                                                         "radix_rank"),
                                         launch_path, device, args.seed)
    k5_args, k5_counts = drive("intersect path", ("intersect",), intersect_path,
                               workloads[1]["K1"], device)
    launches["intersect"], paths["intersect"] = k5_counts["intersect"], "intersect path"

    captured = capture_main_path_inputs(workloads)
    captured["intersect"] = k5_args
    k5_shapes = intersect_shapes(args.seed, device)
    errors = parity(mods, captured, {"standing-q1 ingest": q1_seen,
                                     "stage replay": replay_seen,
                                     "batched dispatch": serving_seen, **distributed_seen,
                                     "train path": train_seen, **launch_seen},
                    eager_seen, paths, k5_shapes, device)
    cold_breakdown(workloads, sync)
    print(f"clocks before timing: {clock_line()}", flush=True)
    kernels = timing(mods, captured, launches, {"eager_launches": eager_launches,
                                                "serving_launches": serving_launches,
                                                "chaos_launches": chaos_launches,
                                                "analysis_launches": analysis_launches,
                                                "distributed_launches": distributed_launches,
                                                "model_launches": model_launches,
                                                "train_launches": train_launches,
                                                "launch_launches": launch_launches},
                     errors, paths, k5_shapes)
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
