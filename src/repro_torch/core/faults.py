"""Deterministic fault injection for the resilience layer.

Production brings failure modes no unit test triggers naturally: failures
where a new executor shape is made, device out-of-memory, capacity-overflow
storms across batch lanes, dispatches that stall, and data mutated behind
the cache API's back. This module plants *injection points* at the code
sites where those faults strike (the executor-build site in
AdaptiveExecutor._fn, the dispatch site in AdaptiveExecutor.__call__) and
arms them from tests through one context manager:

    with faults.inject("compile_fail", times=2) as f:
        engine.run()          # the first two executor builds raise
    assert f.fired == 2

Faults are consumed deterministically in arming order, `times` firings
each, and disarm when their context exits: no randomness, no globals left
behind. Kinds and their sites:

* "compile_fail"   (site "compile"):  raises InjectedCompileError before
  an executor build (a miss of AdaptiveExecutor's executor cache).
* "device_oom"     (site "dispatch"): raises InjectedOOMError, the
  allocator's out-of-memory signature.
* "slow_dispatch"  (site "dispatch"): sleeps `delay_s` then proceeds,
  which drives deadline handling without any real contention.
* "overflow_storm" (site "overflow"): raises capacity.CapacityQuotaError
  naming the next lane from `lanes`: a tenant repeatedly blowing its
  growth quota, without needing data that actually overflows.
* "mutation_skew"  (no site): swaps one host column for an equal-valued
  copy at arm time, the out-of-band mutation relcache detects.

`recoverable(exc)` is the degradation ladder's shared classifier: True
for injected faults, MemoryBudgetError (the governor shedding growth) and
torch.OutOfMemoryError (the CUDA allocator out of memory), False for
everything else, so a kernel build error or a CUDA launch error is never
absorbed. `STATS` counts every firing by kind; `python -m
repro_torch.core.faults [--device cpu]` runs a canned recovery scenario
and prints the counters as a markdown summary.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


class InjectedFault(RuntimeError):
    """Base of every injected error — always `recoverable`."""


class InjectedCompileError(InjectedFault):
    """Injected at the executor-build (compile) site."""


class InjectedOOMError(InjectedFault):
    """Injected at the dispatch site with the allocator's signature."""


@dataclasses.dataclass
class Fault:
    """One armed fault: `remaining` firings left, `fired` consumed."""

    kind: str
    site: str
    remaining: int
    fired: int = 0
    delay_s: float = 0.0
    lanes: tuple = ()
    need: int = 1 << 20


_SITE_OF = {
    "compile_fail": "compile",
    "device_oom": "dispatch",
    "slow_dispatch": "dispatch",
    "overflow_storm": "overflow",
    "mutation_skew": "mutation",
}

_ACTIVE: list[Fault] = []

# process-lifetime firing counters by kind (the chaos job's summary)
STATS = dict.fromkeys(_SITE_OF, 0)


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


@contextlib.contextmanager
def inject(
    kind: str,
    *,
    times: int = 1,
    delay_s: float = 0.01,
    lanes: tuple = (),
    need: int = 1 << 20,
    rel=None,
    var: str | None = None,
):
    """Arm one fault for the duration of the block; yields its Fault
    handle (inspect `fired` after). "mutation_skew" acts at arm time —
    it swaps a column of `rel` (var `var`, default the first schema var)
    for an equal-valued copy, the canonical out-of-band mutation."""
    if kind not in _SITE_OF:
        raise ValueError(f"unknown fault kind {kind!r}; one of {sorted(_SITE_OF)}")
    f = Fault(kind, _SITE_OF[kind], remaining=times, delay_s=delay_s,
              lanes=tuple(lanes), need=need)
    if kind == "mutation_skew":
        if rel is None:
            raise ValueError("mutation_skew needs rel=<Relation>")
        v = var if var is not None else next(iter(rel.schema))
        rel.columns[v] = rel.columns[v].copy()
        f.remaining, f.fired = 0, times
        STATS[kind] += times
        yield f
        return
    _ACTIVE.append(f)
    try:
        yield f
    finally:
        _ACTIVE.remove(f)


def fire(site: str, **ctx) -> None:
    """Called at an injection point. Consumes the first armed fault for
    `site` (if any) and acts it out; a no-op when nothing is armed — the
    production path pays one list check."""
    if not _ACTIVE:
        return
    for f in _ACTIVE:
        if f.site != site or f.remaining <= 0:
            continue
        f.remaining -= 1
        f.fired += 1
        STATS[f.kind] += 1
        if f.kind == "compile_fail":
            raise InjectedCompileError("injected compile failure (fault harness)")
        if f.kind == "device_oom":
            raise InjectedOOMError("CUDA out of memory: injected device OOM (fault harness)")
        if f.kind == "slow_dispatch":
            time.sleep(f.delay_s)
            return
        if f.kind == "overflow_storm":
            from repro_torch.core.capacity import CapacityQuotaError

            lane = None
            if ctx.get("batch"):
                seq = f.lanes or (0,)
                lane = int(seq[min(f.fired - 1, len(seq) - 1)])
            raise CapacityQuotaError(
                0, 0, int(f.need), int(ctx.get("max_capacity") or 0), lane=lane
            )
        return


def recoverable(exc: BaseException) -> bool:
    """Should the degradation ladder absorb this error? True for exactly
    three things: injected faults, governor sheds (MemoryBudgetError), and
    the CUDA allocator's out-of-memory error (torch.OutOfMemoryError, which
    is torch.cuda.OutOfMemoryError). Everything else propagates: a failed
    kernel build, a CUDA launch or illegal-address error, a ValueError,
    and CapacityQuotaError, which has its own eviction protocol."""
    from repro_torch.core.membudget import MemoryBudgetError

    return isinstance(exc, (InjectedFault, MemoryBudgetError, torch.OutOfMemoryError))


# ---------------------------------------------------------------------------
# Canned recovery scenario: the chaos CI job's summary (and smoke check)
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    """Run one fault of each kind against a live serving engine and print
    a markdown recovery table. Exits nonzero if any admitted request
    crashed or answered wrong."""
    import argparse

    import numpy as np

    # under `python -m repro_torch.core.faults` this file runs as __main__,
    # a module instance distinct from the repro_torch.core.faults the
    # engine's injection points fire into: arm faults on the canonical one
    from repro_torch.core import faults, membudget
    from repro_torch.core.api import ExecOptions, compiled_free_join, free_join
    from repro_torch.relational.relation import Relation
    from repro_torch.relational.schema import triangle_query
    from repro_torch.serve import JoinServeEngine

    ap = argparse.ArgumentParser(description="fault-recovery scenario")
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device
    opts = ExecOptions(device=device)
    rng = np.random.default_rng(0)
    q = triangle_query()
    rels = {
        a.alias: Relation(a.alias, {v: rng.integers(0, 50, 2000) for v in a.vars})
        for a in q.atoms
    }
    consts = (3, 7)
    oracle = {
        c: free_join(q, rels, agg="count", filters={"x": c}, device=device) for c in consts
    }
    rows = []

    def run_engine(kind, **kw):
        eng = JoinServeEngine(slots=2, options=opts)
        with faults.inject(kind, **kw) as f:
            reqs = [eng.submit(q, rels, {"x": c}) for c in consts]
            eng.run()
        ok = all(
            r.done and r.error is None and r.result == oracle[c]
            for r, c in zip(reqs, consts)
        )
        deg = sum(1 for r in reqs if r.degraded_to)
        rows.append((kind, f.fired, deg, ok))
        return ok

    ok = True
    ok &= run_engine("compile_fail", times=1)
    ok &= run_engine("device_oom", times=1)
    ok &= run_engine("slow_dispatch", times=1, delay_s=0.001)

    with membudget.budget(1 << 20) as gov:
        sheds0, evs0 = gov.sheds, gov.evictions
        for seed in range(4):
            r2 = np.random.default_rng(seed)
            rl = {
                a.alias: Relation(a.alias, {v: r2.integers(0, 40, 1500) for v in a.vars})
                for a in q.atoms
            }
            got = compiled_free_join(q, rl, agg="count", options=opts)
            want = free_join(q, rl, agg="count", device=device)
            ok &= got == want
            ok &= gov.live_bytes <= (1 << 20)
        rows.append(
            ("memory_budget", gov.evictions - evs0 + gov.sheds - sheds0, 0, ok)
        )

    print("### Fault-recovery counters\n")
    print("| fault | fired | degraded requests | recovered |")
    print("|---|---|---|---|")
    for kind, fired, deg, good in rows:
        print(f"| {kind} | {fired} | {deg} | {'yes' if good else 'NO'} |")
    print(f"\nlifetime firings: {dict(faults.STATS)}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
