"""Spans and lane counters of the port, process-wide, in `TRACE`.

A span is a named interval of host time at a layer boundary: a query
(`compiled_free_join`), planning, the trie cache, each call of the built
executor and each of its tiles and nodes, each counted host/device
crossing, and
the serving engine's steps and dispatches (NAMES lists them all). Spans
nest, one stack of open spans per thread, so each knows its parent.

Two tiers, on the same spans:

* Totals, always kept. For each span name: `count`, `ns` (the summed
  duration) and `self_ns` (duration minus what its child spans cover),
  read as `TRACE.<name with "." as "_">`, e.g. `TRACE.exec_sync.ns`, on
  `time.perf_counter_ns`. `last_ns` is the duration of the span's last
  closing, which the serving engine's dispatch-cost average reads.
* A timeline, only while a torch.profiler session is active (the
  profiler's own enabled flag says so; nothing here turns it on). Each
  span then also opens a profiler range of its name, on the profiler's
  clock, so the spans lie on the same timeline as the device's kernels in
  any session with CPU activity. Its keyword arguments, recorded in
  sessions with `record_shapes=True`, name the query (`query=<id>`, fresh
  per `query` span) or the dispatch's requests (`requests="<ids>"`) that
  the span belongs to, plus the span's own argument: `node` on
  `exec.node`, `kind` and `what` on `exec.sync`. The range is torch's
  `_RecordFunctionFast`: `torch.profiler.record_function` carries no
  argument into the trace and costs several times as much, and its
  user-annotation ranges would add device-side annotation events to
  every CUDA trace.

The tracer keeps no event list of its own: a profiler session's events
are the timeline, and `idle_by_span` reads where the device idled from
them. `lanes_live` and `lanes_allocated` count the frontier lanes the
compiled executor filled and allocated (core/compiled.py), and
`lanes_expanded` the lanes its expansions made, its needs' totals summed
over every node and sub-run of every run; `lanes_multi_cover` counts
those made at lane-choice nodes, where each lane iterates its smallest
cover, and `lanes_other_cover` those of them made by a cover other than
the node's first listed. `exec.tile` is one tile of a call that runs its
first node's rows in tiles (none where a call is one tile);
`key_cols_in_place` and `key_cols_copied` count the key columns the
compiled executor's probes handed K1, group ids included, each weighted
by its rows: those K1 read where the gathers that made the frontier wrote
them, and those copied into the probe's key block first (a tile's view of
its relation, a seeded lane's constant, a var two probes of one block
read). `seeded_dispatches` counts the calls of its seeded-lanes runner
(compiled.SeededExecutor), so that over `serve.dispatch`'s count it is the
share of the serving engine's dispatches that took seeded lanes.

Totals are plain integers updated without a lock, as
`core/transfers.TRANSFERS.syncs` is: a run driven from several threads at
once may lose an update.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _profiler

# (name, the keys of its own arguments, whether it names a query or
# requests for the spans under it)
_SPECS = (
    ("query", (), True),
    ("plan.acquire", (), False),
    ("plan.choose", (), False),
    ("plan.capacity", (), False),
    ("plan.distinct", (), False),
    ("exec.run", (), False),
    ("exec.tries", (), False),
    ("tries.build", (), False),
    ("exec.enqueue", (), False),
    ("exec.tile", (), False),
    ("exec.node", ("node",), False),
    ("exec.sync", ("kind", "what"), False),
    ("exec.feedback", (), False),
    ("serve.step", (), False),
    ("serve.dispatch", ("requests",), True),
)
NAMES = tuple(name for name, _keys, _owns in _SPECS)
OUTSIDE = "outside the program"  # idle_by_span's name for time under no span

_Range = torch._C._profiler._RecordFunctionFast
_QUERY_IDS = itertools.count(1)


class _Thread(threading.local):
    def __init__(self):
        # open spans, innermost last: [start ns, child ns, range, owner before]
        self.stack: list[list] = []
        self.owner: dict | None = None  # the query or requests of the open spans


_THREAD = _Thread()


def _value(v):
    """A range argument the profiler records: ints and strings as they
    are, a list of ids as one comma-separated string."""
    if isinstance(v, (list, tuple)):
        return ",".join(str(x) for x in v)
    return v


class Span:
    """One span name and its totals. `with span:` times a block;
    `with span(arg1, arg2):` gives the span's arguments, which only a
    profiler session reads."""

    __slots__ = ("name", "keys", "owns", "count", "ns", "self_ns", "last_ns")

    def __init__(self, name: str, keys: tuple = (), owns: bool = False):
        self.name, self.keys, self.owns = name, keys, owns
        self.count = self.ns = self.self_ns = self.last_ns = 0

    def __call__(self, first=None, second=None):
        if _profiler._is_profiler_enabled:
            return _WithArgs(self, (first, second))
        return self

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._open(())
        else:
            _THREAD.stack.append([perf_counter_ns(), 0, None])
        return self

    def __exit__(self, exc_type, exc, tb):
        end = perf_counter_ns()
        stack = _THREAD.stack
        frame = stack.pop()
        d = end - frame[0]
        self.count += 1
        self.ns += d
        self.self_ns += d - frame[1]
        self.last_ns = d
        if stack:
            stack[-1][1] += d
        if frame[2] is not None:
            frame[2].__exit__(None, None, None)
            _THREAD.owner = frame[3]
        return False

    def _open(self, values) -> None:
        t = _THREAD
        before = t.owner
        args = {k: _value(v) for k, v in zip(self.keys, values) if v is not None}
        if self.owns:
            t.owner = dict(args) if args else {"query": next(_QUERY_IDS)}
        kwargs = {**t.owner, **args} if t.owner else args
        rng = _Range(self.name, (), kwargs)
        rng.__enter__()
        t.stack.append([perf_counter_ns(), 0, rng, before])


class _WithArgs:
    """A span entered with arguments, under a profiler session."""

    __slots__ = ("span", "values")

    def __init__(self, span: Span, values):
        self.span, self.values = span, values

    def __enter__(self):
        self.span._open(self.values)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        return self.span.__exit__(exc_type, exc, tb)


class Tracer:
    """The port's spans, each an attribute named as its span with "_" for
    ".", and its lane counters."""

    def __init__(self):
        self.lanes_live = 0  # frontier lanes filled, every buffer of every run
        self.lanes_allocated = 0  # and allocated
        self.lanes_expanded = 0  # lanes the expansions made
        self.lanes_multi_cover = 0  # of them at lane-choice nodes
        self.lanes_other_cover = 0  # of those by a cover other than the first
        self.key_cols_in_place = 0  # probe key columns K1 read in place, x rows
        self.key_cols_copied = 0  # and those copied into a key block first
        self.seeded_dispatches = 0  # calls of a seeded-lanes runner
        self.spans: dict[str, Span] = {}
        for name, keys, owns in _SPECS:
            span = Span(name, keys, owns)
            self.spans[name] = span
            setattr(self, name.replace(".", "_"), span)

    def totals(self) -> dict[str, tuple[int, int, int]]:
        """{span name: (count, ns, self ns)} so far."""
        return {n: (s.count, s.ns, s.self_ns) for n, s in self.spans.items()}


TRACE = Tracer()


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_by_span(events) -> dict:
    """Seconds the device idled in one profiler session, by the innermost
    program span open on the host meanwhile.

    `events`: a torch.profiler.profile that traced CPU and CUDA activity,
    or its events (`prof.profiler.kineto_results.events()`: objects with
    name(), device_type(), start_ns(), duration_ns() and
    is_user_annotation()). The device's idle time is what the union of its
    operations leaves of the session, from the first event's start to the
    last one's end. Each idle interval is split by the innermost span of
    NAMES open over it (the one opened last, among those open); idle time
    under none goes to OUTSIDE. Returns {name: seconds}, most first."""
    from torch.autograd import DeviceType

    if hasattr(events, "profiler"):
        events = events.profiler.kineto_results.events()
    names = set(NAMES)
    busy, spans = [], []
    lo = hi = None
    for e in events:
        s = e.start_ns()
        t = s + e.duration_ns()
        lo = s if lo is None else min(lo, s)
        hi = t if hi is None else max(hi, t)
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                busy.append((s, t))
        elif e.name() in names:
            spans.append((s, t, e.name()))
    if lo is None:
        return {}
    idle, prev = [], lo
    for s, t in _union(busy):
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, t)
    if prev < hi:
        idle.append((prev, hi))
    # sweep the elementary intervals between every boundary: the innermost
    # open span is the one with the latest start among those not yet ended
    points = sorted({p for s, t, _n in spans for p in (s, t)} | {p for iv in idle for p in iv})
    spans.sort()
    out: dict[str, float] = {}
    heap: list = []
    j = k = 0
    for p, q in zip(points, points[1:]):
        while j < len(spans) and spans[j][0] <= p:
            s, t, name = spans[j]
            heapq.heappush(heap, (-s, t, name))
            j += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        while k < len(idle) and idle[k][1] <= p:
            k += 1
        if k < len(idle) and idle[k][0] <= p:
            name = heap[0][2] if heap else OUTSIDE
            out[name] = out.get(name, 0.0) + (q - p) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
