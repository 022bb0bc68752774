"""Device traces of a run, from torch.profiler (CUPTI), on the card.

Two readings: a stretch of the window traced as it runs (busy and idle
seconds, the device operations taking most time, the longest idle gaps),
and one more query after the window with each launch of chosen kernel
wrappers bracketed by marker kernels, so that every launch's device time
is known by the call that made it (the `<kernel>_roofline` metrics).

The profiler guard is a frozen copy of chip_smoke.py's `markers` and
`profiled`: in a long-running process torch.profiler can drop a session's
first device events, so a session opens with throwaway lead kernels, and
a marker kernel counts the calls the session kept; a session whose
markers are off is not used.
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

PROFILE_TRIES = 5  # sessions of one reading before a run gives up
LEAD = [1]  # lead kernels a session starts with (grows when one loses events)


@dataclass
class Stretch:
    """A traced stretch of the window: its host-clock length, the union of
    its device operations' intervals, and what filled it."""
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)  # [name, seconds], most first
    gaps: list = field(default_factory=list)  # [what, seconds], longest first


def _events(prof):
    """(name, start ns, end ns) of every device operation in the session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)
        out.append((e.name(), start, start + dur))
    out.sort(key=lambda x: x[1])
    return out


@functools.cache
def markers():
    """(marker, marker names, lead, lead names): `marker()` and `lead()`
    each launch one tiny kernel (torch's spin kernel for no cycles, which no
    program code launches, and a fill of an int16 scalar), named as
    torch.profiler names them, found in sessions of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lead_buf = torch.zeros(1, dtype=torch.int16, device="cuda")

    def marker():
        torch.cuda._sleep(0)

    def lead():
        lead_buf.add_(1)

    def session(*fns) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lead()
            torch.cuda.synchronize()
            for fn in fns:
                fn()
            torch.cuda.synchronize()
        names: dict = {}
        for name, _s, _e in _events(prof):
            names[name] = names.get(name, 0) + 1
        return names

    torch.cuda.synchronize()
    for _ in range(3):
        lead_names = frozenset(k for k, n in session(lead, lead).items() if n >= 2)
        marks = {k: n for k, n in session(marker, marker).items() if k not in lead_names}
        if lead_names and sum(marks.values()) == 2:
            return marker, frozenset(marks), lead, lead_names
    raise RuntimeError("profiler: three tries did not name the marker and lead kernels")


def guarded(body, marks_expected):
    """Run body(marker) under a CUDA trace opened with LEAD[0] lead kernels;
    body calls marker() where it likes and returns its result. The session
    counts if it kept `marks_expected(result)` markers; otherwise it runs
    again with 8 times the leads, up to PROFILE_TRIES sessions. Returns
    (device events without leads, marker names, result)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker, marker_names, lead, lead_names = markers()
    for _ in range(PROFILE_TRIES):
        leads = LEAD[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(leads):
                lead()
            torch.cuda.synchronize()
            out = body(marker)
            torch.cuda.synchronize()
        events = [e for e in _events(prof) if e[0] not in lead_names]
        kept = sum(1 for e in events if e[0] in marker_names)
        if kept == marks_expected(out):
            return events, marker_names, out
        LEAD[0] = 8 * leads
    raise RuntimeError(f"profiler: {PROFILE_TRIES} sessions in a row lost device events")


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def stretch(run_query, seconds: float) -> Stretch:
    """Trace whole calls of run_query() for at least `seconds` of their
    own time, a marker before each: the busy share of the stretch, the
    device operations by time and the idle gaps by the operation they
    follow. run_query() returns the seconds it adds to the window (a
    loop's own work between calls, such as loading the next query's
    tables, is not the program's and not counted); its bookkeeping goes on
    as in the untraced window."""
    import torch

    def body(marker):
        torch.cuda.synchronize()
        n, active = 0, 0.0
        while n == 0 or active < seconds:
            marker()
            active += run_query()
            n += 1
        torch.cuda.synchronize()
        return n, active

    events, marker_names, (n, wall) = guarded(body, lambda out: out[0])
    ops = [e for e in events if e[0] not in marker_names]
    busy = _union((s, e) for _n, s, e in ops)
    by_name: dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    gaps: dict[str, float] = {}
    prev_end, prev_name = None, None
    ends = sorted(ops, key=lambda x: x[2])
    j = 0
    for s, e in busy:
        if prev_end is not None and s > prev_end:
            key = f"host, after {prev_name[:80]}"
            gaps[key] = gaps.get(key, 0.0) + (s - prev_end) / 1e9
        while j < len(ends) and ends[j][2] <= e:
            prev_name = ends[j][0]
            j += 1
        prev_end = e
    return Stretch(
        window_s=wall, busy_s=sum(e - s for s, e in busy) / 1e9,
        ops=sorted(([k, v] for k, v in by_name.items()), key=lambda x: -x[1])[:10],
        gaps=sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10],
    )


def bracketed(run_queries, wrappers: dict[str, tuple]):
    """Run run_queries() once under a CUDA trace with each call of the
    named kernel wrappers between two markers. wrappers: kernel ->
    (owner object, attribute, keep(args) -> what to hold for the bound,
    taken after the launch so that it moves no input into the L2 first).
    Returns {kernel: [(held args, device seconds of the launch)]} and
    run_queries' result."""
    calls: list[tuple[str, object]] = []

    def wrap(kernel, owner, attr, keep, marker):
        orig = getattr(owner, attr)

        def recorder(*args):
            marker()
            out = orig(*args)
            marker()
            calls.append((kernel, keep(args)))
            return out

        setattr(owner, attr, recorder)
        return owner, attr, orig

    def body(marker):
        calls.clear()
        patched = [wrap(k, o, a, keep, marker) for k, (o, a, keep) in wrappers.items()]
        try:
            return run_queries()
        finally:
            for owner, attr, orig in patched:
                setattr(owner, attr, orig)

    events, marker_names, out = guarded(body, lambda _out: 2 * len(calls))
    launches: dict[str, list] = {k: [] for k in wrappers}
    inside, spans = None, []
    for name, s, e in events:
        if name in marker_names:
            if inside is None:
                inside = []
            else:
                spans.append(inside)
                inside = None
        elif inside is not None:
            inside.append(e - s)
    if len(spans) != len(calls):
        raise RuntimeError(f"bracketed: {len(spans)} brackets for {len(calls)} calls")
    for (kernel, held), durs in zip(calls, spans):
        if len(durs) > 1:
            raise RuntimeError(f"bracketed: a {kernel} call ran {len(durs)} device operations")
        if durs:  # a call over no rows may launch nothing
            launches[kernel].append((held, durs[0] / 1e9))
    return launches, out
