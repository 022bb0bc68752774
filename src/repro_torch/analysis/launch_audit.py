"""launch audit — checks over what one warm call of a runner does on the
device, not over the plan.

planlint proves the plan right; it says nothing about what a call of the
runner built from it sends to the device. The reference audits the jaxpr
of its compiled program (repro/analysis/jaxpr_audit.py). PyTorch runs
eagerly and has no program to read, so the port records one warm call
instead, and checks in what the call did the three defect classes the
reference checks in its program:

* **host synchronizations** (the counterpart of host callbacks): a warm
  call may wait for the device only for its documented read-backs (the
  need vectors, then the count or the rows). One more `.item()`,
  read-back or data-dependent shape (a boolean mask, `nonzero`, `unique`)
  serializes the host against the device on every call, and once per
  dispatch of B tenants on the batched serving path. Uploads from
  pageable memory block too: the trace counts every one in `syncs`, the
  total the card's torch.cuda.set_sync_debug_mode reports. The deliberate
  ones go through core/transfers.py (the filter constants', on every
  filtered call) and are judged by size under the third rule, so that one
  defect is named by one rule; an upload made anywhere else (a Python
  scalar written into a device tensor copies one element from the host)
  is a hidden wait like any other.
* **probe loops unrolled into straight-line launches** (the bug class of
  the reference's PR 2): K1 must run once per probe of the schedule, and
  the tensor ops dispatched around the kernels must stay a small constant
  per schedule op. A loop over probe rounds in Python multiplies both.
* **captured buffers** (the counterpart of relation-sized consts): a warm
  call must build no trie, make no new executor, and copy no host buffer
  larger than `max(32768, 4 x the largest planned capacity)` elements to
  the device: relation-sized data belongs in the registry's device columns
  and the trie cache, uploaded once. The small deliberate uploads (the
  filter constants) are listed at INFO.

`trace_runner` records one warm call exactly as the warm path makes it
(`run_relations`: registry device columns, cached base tries, zero filter
constants by default): the kernels' launch counters (on the CPU, the calls
of their plain versions, which stand in for launches), the tensor ops
dispatched outside the kernels and the counted copies (a
TorchDispatchMode), the host synchronizations and uploads (the compiled
path's counted copies, core/transfers.py, plus every synchronizing op or
host-to-device copy the recorder sees outside them), and the trie
builds and runner compiles before and after. `audit_trace` checks a
trace against limits; `audit_runner` sizes the limits from the runner's
schedules and planned capacities and audits one recorded warm call.
Recording needs no knob: the counters exist on every call, and the
recorder exists only inside `trace_runner`. Nothing here catches an
error: a call that cannot be recorded raises.
"""
from __future__ import annotations

import importlib
from collections import Counter
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.diagnostics import Report
from repro_torch.core.transfers import TRANSFERS
from repro_torch.kernels import _build

# launcher name (as in _build._SIGNATURES) -> the module holding its wrapper
_KERNEL_MODULES = {
    "hash_probe": "hash_probe",
    "csr_expand": "csr_expand",
    "compact": "compact",
    "radix_rank": "radix_sort",
    "intersect": "intersect",
    "digit_counts": "seg_scan",
    "max_scan": "seg_scan",
}

# Ops whose output shape or value the host must read from the device: each
# synchronizes on the card (the CPU dispatches them too, so a CPU run
# counts what the card would).
SYNC_OPS = frozenset(
    {
        "_local_scalar_dense",  # .item(), int(t), bool(t)
        "nonzero",
        "masked_select",
        "_unique",
        "_unique2",
        "unique_dim",
        "unique_consecutive",
        "equal",
    }
)

# A host-to-device copy above this many elements is a relation-sized
# buffer, not a deliberate small upload. audit_runner raises it to clear
# four times the runner's largest planned capacity, as the reference does
# for baked consts.
UPLOAD_ELEMS_THRESHOLD = 32768

# The ops limit of one warm call: tensor ops dispatched plus kernel calls,
# per schedule op (one cover expansion or one probe, counted once per lane
# where a stage runs per lane), per stage-output trie the call builds (a
# bushy chain's weighted tries: sort, group structure, hash table), plus a
# flat allowance for the call's fixed work (the needs' packing, the fold).
# Measured on the analysis corpus (python -m repro_torch.analysis -v
# prints each call's ops and limit): single-stage calls 64-81 ops on the
# CPU and 68-97 on an H100 (one allocation more per launch), 13-25 per
# schedule op; a stage-output trie ~180 ops more (chain-selective 311 on
# the CPU, bushy 525; 333 and 562 on the H100). The limits leave about 2x
# slack. A probe loop unrolled over its 32 rounds in tensor ops adds ~8
# ops a round, ~250 a probe, which no limit here absorbs.
OPS_PER_SCHEDULE_OP = 40
OPS_PER_STAGE_TRIE = 400
OPS_FLAT = 64


@dataclass
class LaunchTrace:
    """What one recorded call did (see the module docstring)."""

    launches: dict[str, int]  # CUDA kernel launches, by kernel
    kernel_calls: dict[str, int]  # launches on the card, plain calls on the CPU
    ops: Counter = field(default_factory=Counter)  # tensor ops outside kernels and copies
    syncs: int = 0  # every blocking copy and synchronizing op
    counted_uploads: int = 0  # the uploads through core/transfers.py among them
    sync_sites: list[str] = field(default_factory=list)
    uploads: list[tuple[str, int]] = field(default_factory=list)  # (what, elements)
    builds: int = 0  # trie builds + lazy table builds
    compiles: int = 0  # executors made


def _crossing(name: str, args, kwargs, out):
    """(direction, elements, blocking) of a copy between host and device
    that a dispatched op makes, else None."""
    if name == "_to_copy":
        src, dst, non_blocking = args[0], out, kwargs.get("non_blocking", False)
    elif name == "copy_":
        dst, src = args[0], args[1]
        non_blocking = args[2] if len(args) > 2 else kwargs.get("non_blocking", False)
    else:
        return None
    if not (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)):
        return None
    kinds = (src.device.type, dst.device.type)
    if kinds == ("cpu", "cuda"):
        return "upload", src.numel(), not (non_blocking and src.is_pinned())
    if kinds == ("cuda", "cpu"):
        return "read", src.numel(), not non_blocking
    return None


def _syncs_on_device(name: str, args, kwargs) -> bool:
    if name in SYNC_OPS:
        return True
    if name in ("index", "index_put_", "index_put"):  # a boolean mask: nonzero inside
        indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in indices)
    if name == "repeat_interleave":  # without output_size the host reads the total
        repeats = args[1] if len(args) > 1 else args[0]
        return isinstance(repeats, torch.Tensor) and kwargs.get("output_size") is None
    return False


class _Recorder(TorchDispatchMode):
    """Counts every tensor op dispatched outside the kernels' plain versions
    and the counted copies; notes the synchronizing ops and host-to-device
    copies among them.

    A tensor made from host data (torch.tensor, or a Python scalar that
    indexing wraps, `t[0] = 1`) stays on the host; copying it into a
    device tensor is a blocking upload. On the CPU both tensors are on the
    host and no copy crosses, so the recorder counts such a copy there as
    the upload it is on the card."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.sync_sites: list[str] = []
        self.uploads: list[tuple[str, int]] = []
        # tensors made from host data in this call, by id (held, so no id
        # is reused while the call is recorded)
        self._host_made: dict[int, torch.Tensor] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if TRANSFERS.crossing or _build.in_plain():
            return out
        name = func.overloadpacket.__name__
        self.ops[name] += 1
        if name == "lift_fresh":
            self._host_made[id(out)] = out
        elif name == "copy_" and args[0].device.type == "cpu" and id(args[1]) in self._host_made:
            self.uploads.append(("uncounted host write (copy_)", int(args[1].numel())))
            self.sync_sites.append("uncounted upload (host write)")
            return out
        copy = _crossing(name, args, kwargs, out)
        if copy is not None:
            kind, elements, blocking = copy
            if kind == "upload":
                self.uploads.append((f"uncounted {name}", int(elements)))
            if blocking:
                self.sync_sites.append(f"uncounted {kind} ({name})")
        elif _syncs_on_device(name, args, kwargs):
            self.sync_sites.append(f"op {name}")
        return out


def _modules():
    return {
        k: importlib.import_module(f"repro_torch.kernels.{m}") for k, m in _KERNEL_MODULES.items()
    }


def trace_runner(runner, relations, *, filter_consts=None) -> LaunchTrace:
    """Record one warm call of an AdaptiveExecutor (or anything with its
    surface) over `relations`, exactly as the warm path makes it:
    run_relations with registry device columns and cached base tries.
    `filter_consts` defaults to zeros of the runner's constants shape,
    (batch, F) or (F,), as in the reference's trace."""
    from repro_torch.core.compiled import TRIE_CACHE

    if filter_consts is None and runner.filter_vars:
        shape = (runner.batch, len(runner.filter_vars)) if runner.batch else (
            len(runner.filter_vars),
        )
        filter_consts = np.zeros(shape, np.int32)
    mods = _modules()
    launches0 = {k: getattr(m, _build.counter(k)) for k, m in mods.items()}
    plain0 = dict(_build.plain_calls)
    builds0 = TRIE_CACHE.builds + TRIE_CACHE.table_builds
    compiles0 = runner.compiles
    with TRANSFERS.record() as crossings, _Recorder() as rec:
        runner.run_relations(relations, filter_consts=filter_consts)
    launches = {k: getattr(m, _build.counter(k)) - launches0[k] for k, m in mods.items()}
    counted = [f"{kind} {what}" for kind, what, _n in crossings]
    counted_uploads = [(what, n) for kind, what, n in crossings if kind == "upload"]
    return LaunchTrace(
        launches=launches,
        kernel_calls={k: launches[k] + _build.plain_calls[k] - plain0[k] for k in mods},
        ops=rec.ops,
        syncs=len(counted) + len(rec.sync_sites),
        counted_uploads=len(counted_uploads),
        sync_sites=counted + rec.sync_sites,
        uploads=counted_uploads + rec.uploads,
        builds=TRIE_CACHE.builds + TRIE_CACHE.table_builds - builds0,
        compiles=runner.compiles - compiles0,
    )


def audit_trace(
    trace: LaunchTrace,
    *,
    read_backs: int = 2,
    probes: int | None = None,
    ops: int = OPS_FLAT,
    upload_elems: int = UPLOAD_ELEMS_THRESHOLD,
    name: str = "call",
) -> Report:
    """Check one recorded call against its limits: `read_backs` waits for
    the device (host synchronizations other than the counted uploads of
    core/transfers.py, which are judged by size), `probes` K1
    launches (None: unchecked), `ops` dispatched tensor ops plus kernel
    calls, `upload_elems` elements per host-to-device copy; and no trie
    build and no new executor."""
    rep = Report()
    waits = trace.syncs - trace.counted_uploads
    if waits > read_backs:
        rep.error(
            "host-sync",
            f"{name}.syncs",
            f"{waits} waits for the device in one warm call, {read_backs} documented "
            f"read-backs ({', '.join(trace.sync_sites)}): each extra one stalls the host "
            "on the device every call",
        )
    k1 = trace.kernel_calls.get("hash_probe", 0)
    if probes is not None and k1 > probes:
        rep.error(
            "probe-loop-unrolled",
            f"{name}.launches[hash_probe]",
            f"{k1} K1 launches for {probes} probes: probe rounds run as separate "
            "launches instead of inside the kernel (the reference's PR 2 regression class)",
        )
    n_ops = sum(trace.ops.values()) + sum(trace.kernel_calls.values())
    if n_ops > ops:
        top = ", ".join(f"{op} {n}" for op, n in trace.ops.most_common(4))
        rep.error(
            "probe-loop-unrolled",
            f"{name}.ops",
            f"{n_ops} tensor ops and kernel calls in one warm call (limit {ops}; most: "
            f"{top}): a loop appears unrolled into straight-line ops",
        )
    if trace.builds:
        rep.error(
            "captured-buffer-upload",
            f"{name}.builds",
            f"a warm call built {trace.builds} trie(s) or table(s): its relations' "
            "tries are not served from the trie cache",
        )
    if trace.compiles:
        rep.error(
            "captured-buffer-upload",
            f"{name}.compiles",
            f"a warm call made {trace.compiles} new executor(s): its capacities did "
            "not settle",
        )
    small = []
    for i, (what, n) in enumerate(trace.uploads):
        if n > upload_elems:
            rep.error(
                "captured-buffer-upload",
                f"{name}.upload[{i}]",
                f"upload {i} ({what}) copies {n} elements to the device (limit "
                f"{upload_elems}): a relation-sized buffer re-sent every call instead "
                "of living in the registry's device columns",
            )
        else:
            small.append(f"{what} ({n})")
    if small:
        rep.info(
            "small-uploads",
            f"{name}.uploads",
            f"{len(small)} small upload(s) per call: {', '.join(small)}",
        )
    return rep


def _stage_runs(runner) -> list[int]:
    """How many times each stage runs in one call: once, or once per lane
    for the stages after a batched chain's first filtered non-root stage
    (make_chain_executor's per-lane path)."""
    lanes = runner.batch or 1
    unassigned = set(runner.filter_vars)
    split, runs = False, []
    for i, (_name, plan) in enumerate(runner.stages):
        runs.append(lanes if split else 1)
        mine = {v for v in plan.query.variables if v in unassigned}
        unassigned -= mine
        if runner.batch and mine and i < len(runner.stages) - 1:
            split = True
    return runs


def runner_limits(runner) -> dict:
    """The limits audit_trace holds a warm call of `runner` to: its
    documented read-backs (runner.warm_read_backs), one K1 launch per
    probe, the ops limit, and the upload size cutoff above its largest
    planned capacity."""
    chain = runner._as_chain(runner.cap_plan)
    max_cap = max((c for cp in chain.stages for c in cp.capacities), default=1)
    names = {name for name, _ in runner.stages}
    probes = stage_tries = 0
    for r, (_name, plan), sched, cp in zip(_stage_runs(runner), runner.stages, runner.schedules,
                                           chain.stages):
        probes += r * sum(n * len(p) for n, (_k, _c, p) in zip(sched.runs(cp.tiles),
                                                               sched.entries))
        stage_tries += r * sum(a.alias in names for a in plan.query.atoms)
    return {
        "read_backs": runner.warm_read_backs,
        "probes": probes,
        "ops": OPS_PER_SCHEDULE_OP * schedule_ops(runner)
        + OPS_PER_STAGE_TRIE * stage_tries
        + OPS_FLAT,
        "upload_elems": max(UPLOAD_ELEMS_THRESHOLD, 4 * int(max_cap)),
    }


def schedule_ops(runner) -> int:
    """Schedule ops of one call (cover expansions and probes, per lane
    where a stage runs per lane, per tile and per lane-choice cover where
    the stage runs in sub-runs: StaticSchedule.runs)."""
    chain = runner._as_chain(runner.cap_plan)
    return sum(
        r * n * (1 + len(p))
        for r, sched, cp in zip(_stage_runs(runner), runner.schedules, chain.stages)
        for n, (_k, _c, p) in zip(sched.runs(cp.tiles), sched.entries)
    )


def audit_runner(runner, relations, *, name: str = "runner", filter_consts=None,
                 trace: LaunchTrace | None = None) -> Report:
    """Audit one warm call of an AdaptiveExecutor against limits sized
    from its own schedules and planned capacities (runner_limits).
    `trace` audits a call already recorded by trace_runner instead of
    recording a new one."""
    if trace is None:
        trace = trace_runner(runner, relations, filter_consts=filter_consts)
    return audit_trace(trace, **runner_limits(runner), name=name)
