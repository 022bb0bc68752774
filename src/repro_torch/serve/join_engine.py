"""Multi-tenant join-query serving over the compiled Free Join path.

This engine serves *queries*: fixed-width request slots so the batched
executor never changes shape, a (slots, cap) liveness mask instead of a
varying batch, and a host control plane that admits, groups, dispatches
and retires.

The pipeline per `step()`:

1. **Pick a template, round-robin.** Every submitted request was
   canonicalized on arrival (templates.canonicalize): alpha-renamed
   aliases, constants lifted out. Requests sharing a template key, however
   differently their tenants spelled the query, are batchable against ONE
   runner. Each step serves the *next* queued template in rotation (not
   the head-of-line one): a tenant streaming requests on one template can
   fill the queue front forever, and first-template-wins would starve
   every other template behind it.
2. **Admit.** The runner's capacity plan is known before any run; each
   request is checked against its tenant's measured-cost quota
   (`max_dispatch_us` against the template's dispatch-time EMA, see below)
   and its `max_plan_cells` quota, and rejected with zero device work on
   violation.
3. **Dispatch one batched probe.** Up to `slots` co-template requests run
   as one mask-mode executor call over the shared cached tries: the int32
   constants matrix (slots, F) is the only per-lane input, and the probe
   pipeline (expansions K2, probes K1, compactions K3) runs once for all
   lanes. Dead slots are padded with lane 0's constants (they compute a
   duplicate answer that is simply not read).
4. **Evict on quota.** If the adaptive runner raises CapacityQuotaError,
   the named lane's request is rejected, its slot re-padded, and the
   remaining requests re-dispatched against the same executor:
   co-batched tenants never pay a regrowth for a pathological neighbor.

Filterless templates (F=0) have nothing to vary per lane, so the whole
group is served by ONE unbatched call whose result every member shares.

The engine also keeps a per-template exponential moving average of the
measured dispatch time (`cost_ema_us`, updated on every dispatch, cold
ones included, decayed by later warm dispatches). A dispatch's time ends
at the read-back of its results, which synchronizes the stream, so it is
the card's time, not the enqueue time. Admission consults it beside the
planned cells: planning says what a template *should* cost, the EMA says
what it *did* cost.

**Resilience (the degradation ladder).** A fault the quota machinery has
no protocol for (an executor-build failure, the CUDA allocator's
out-of-memory error, a memory-governor shed, see core.membudget) never
crashes step(). The group descends a ladder instead, each rung recorded
on the served handles as `degraded_to`:

    full-width batch -> halved batch -> unbatched kill mode -> eager

The eager rung is the port's eager `free_join` on the engine's device,
the card by default: there is no CPU rung, so a real out-of-memory error
on that rung propagates. Only what `core.faults.recoverable` names is
absorbed; a kernel build or launch error propagates out of step(). Two
more production guards ride along: per-request `deadline_ms`
(submit-relative; expired requests are rejected with reason "deadline"
rather than dispatched late) and jittered exponential backoff between
quota-eviction rounds (seeded, `random.Random`), so an overflow storm
cannot hot-loop the host while co-batched tenants wait. Eviction retry
budgets are charged to the OFFENDER: a tenant whose lanes keep blowing
the growth quota exhausts its own max_retries and is rejected wholesale;
compliant neighbors are re-dispatched free of charge (the batch strictly
shrinks, so the loop terminates).

The port has no static plan verifier yet (ROADMAP: `analysis/`), so
submit() rejects only what canonicalize refuses (a ValueError).
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque

import numpy as np

from repro_torch.core import api, faults, relcache
from repro_torch.core.api import ExecOptions, _acquire_runner, free_join
from repro_torch.core.capacity import CapacityQuotaError
from repro_torch.core.plan import BinaryPlan
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Query
from repro_torch.serve.admission import AdmissionController, AdmissionError
from repro_torch.serve.templates import PlanTemplate, canonicalize


@dataclasses.dataclass
class JoinRequest:
    rid: int
    tenant: str
    template: PlanTemplate | None  # None: rejected at submit time
    consts: np.ndarray  # (F,) int32 — the lifted selection constants
    result: object = None
    error: Exception | None = None
    done: bool = False
    # which ladder rung served this request, if any ("halved" | "unbatched"
    # | "eager"); None means the full-width fast path answered it
    degraded_to: str | None = None
    # submit-relative deadline: past it the request is rejected (reason
    # "deadline") instead of dispatched late
    deadline_ms: float | None = None
    t_submit: float = 0.0


class JoinServeEngine:
    """Concurrent join serving: submit() canonicalizes, step() batches.

    slots: fixed dispatch width; every batched runner is built at this
    width once and reused for any group size up to it. options: compiled-
    path ExecOptions shared by all templates this engine builds, on the
    card by default (`ExecOptions(device="cpu")` runs every kernel's plain
    version). admission: quota controller (default: no quotas). The engine
    keys its runners in a scoped namespace of the process runner cache, so
    template-canonicalized keys can never collide with
    compiled_free_join's verbatim keys."""

    def __init__(
        self,
        *,
        slots: int = 8,
        options: ExecOptions | None = None,
        admission: AdmissionController | None = None,
        cache=None,
    ):
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.slots = slots
        self.options = options or ExecOptions()
        self.admission = admission or AdmissionController()
        self._cache = (cache if cache is not None else api._runner_cache).scoped("join-templates")
        self.queue: deque[JoinRequest] = deque()
        self._next_rid = 0
        self._rr = 0  # round-robin cursor over queued templates
        self.dispatches = 0  # executor calls made
        self.served = 0  # requests completed successfully
        # template key -> EMA of measured dispatch time (us), each ending at
        # the results' read-back; alpha 0.3 forgets a cold dispatch in a
        # few warm ones
        self.cost_ema_us: dict = {}
        self.ema_alpha = 0.3
        # resilience counters: requests served per ladder rung, faults the
        # ladder absorbed, deadline rejections
        self.degraded = {"halved": 0, "unbatched": 0, "eager": 0}
        self.faults_absorbed = 0
        self.deadline_rejected = 0
        # jittered exponential backoff between quota-eviction rounds: base
        # doubles per eviction up to the cap, jitter is deterministic
        # (seeded) so chaos runs reproduce
        self.backoff_base_ms = 1.0
        self.backoff_cap_ms = 50.0
        self.backoff_jitter = 0.25
        self._jitter_rng = random.Random(0xC0FFEE)

    # ---- intake -------------------------------------------------------
    def submit(
        self,
        query: Query,
        relations: dict[str, Relation],
        filters: dict[str, int] | None = None,
        *,
        tenant: str = "default",
        agg: str | None = "count",
        plan_tree=None,
        deadline_ms: float | None = None,
    ) -> JoinRequest:
        """Canonicalize, statically verify, and enqueue one query; returns
        its JoinRequest handle (result/error/done are filled by step()).

        Verification failures (a PlanVerificationError from the static
        verifier, or a ValueError from canonicalize: an unknown filter var,
        a plan tree that does not match) REJECT the request (error set,
        done=True, admission counter bumped) instead of raising or
        enqueuing: a raise would crash the submitting tenant's whole intake
        loop, and an enqueued invalid plan would fail mid-dispatch inside a
        batch shared with innocent co-template tenants. A rejected handle
        comes back immediately and never touches the serving loop."""
        from repro_torch.analysis.planlint import lint_query, lint_template, lint_tree

        # the ORIGINAL query, pre-canonicalization: canonicalize silently
        # drops head vars no atom binds, so the template would look clean
        rep = lint_query(query)
        rep.extend(lint_tree(query, plan_tree)[0])
        try:
            rep.raise_errors()
            template, consts = canonicalize(
                query, relations, filters, plan_tree=plan_tree, agg=agg,
                options=self.options,
            )
            lint_template(template).raise_errors()
        except ValueError as e:  # PlanVerificationError is a ValueError
            req = JoinRequest(
                rid=self._next_rid, tenant=tenant,
                template=None, consts=np.zeros(0, np.int32),
            )
            self._next_rid += 1
            self.admission.reject_runtime(tenant, reason="invalid")
            self._reject(req, e)
            return req
        req = JoinRequest(
            rid=self._next_rid, tenant=tenant, template=template, consts=consts,
            deadline_ms=deadline_ms, t_submit=time.perf_counter(),
        )
        self._next_rid += 1
        self.queue.append(req)
        return req

    # ---- serving loop -------------------------------------------------
    def step(self) -> list[JoinRequest]:
        """One engine iteration: pick the next queued template in round-robin
        rotation, pull every queued co-template request into up to `slots`
        lanes, and serve them with one dispatch. Returns the requests retired
        this step (completed or rejected).

        Rotation, not head-of-line: with first-template-wins, a tenant
        streaming requests on one template keeps the queue front occupied
        and every other template waits forever. The rotation cursor walks
        the arrival-ordered list of *distinct* queued templates, so k live
        templates each get every k-th dispatch regardless of queue depth."""
        if not self.queue:
            return []
        templates: list[PlanTemplate] = []
        for r in self.queue:
            if r.template not in templates:
                templates.append(r.template)
        chosen = templates[self._rr % len(templates)]
        self._rr += 1
        group: list[JoinRequest] = []
        rest: deque[JoinRequest] = deque()
        while self.queue:
            r = self.queue.popleft()
            if r.template == chosen and len(group) < self.slots:
                group.append(r)
            else:
                rest.append(r)
        self.queue = rest
        self._serve_group(chosen, group)
        return group

    def run(self, max_steps: int = 10_000) -> list[JoinRequest]:
        """Drain the queue; returns every retired request in retire order."""
        out: list[JoinRequest] = []
        steps = 0
        while self.queue and steps < max_steps:
            out.extend(self.step())
            steps += 1
        return out

    # ---- internals ----------------------------------------------------
    def _reject(self, req: JoinRequest, err: Exception) -> None:
        req.error = err
        req.done = True

    def _observe_cost(self, key, dt_us: float) -> None:
        ema = self.cost_ema_us.get(key)
        self.cost_ema_us[key] = (
            dt_us if ema is None else (1 - self.ema_alpha) * ema + self.ema_alpha * dt_us
        )

    def _reap_deadlines(self, reqs: list[JoinRequest]) -> None:
        """Reject (reason "deadline") every live request past its
        submit-relative deadline — called before each dispatch round, so a
        request stuck behind a slow neighbor is refused, not served late."""
        now = time.perf_counter()
        for r in reqs:
            if r.done or r.deadline_ms is None:
                continue
            waited_ms = (now - r.t_submit) * 1e3
            if waited_ms > r.deadline_ms:
                self.deadline_rejected += 1
                self.admission.reject_runtime(r.tenant, reason="deadline")
                self._reject(
                    r,
                    AdmissionError(
                        f"deadline {r.deadline_ms:.0f}ms exceeded "
                        f"({waited_ms:.0f}ms queued)",
                        tenant=r.tenant,
                        reason="deadline",
                    ),
                )

    def _backoff(self, evictions: int) -> None:
        """Jittered exponential backoff between quota-eviction rounds: an
        overflow storm re-dispatches at a decaying rate instead of
        hot-looping the host. Deterministically seeded; set
        backoff_base_ms=0 to disable."""
        if self.backoff_base_ms <= 0:
            return
        delay = min(self.backoff_cap_ms, self.backoff_base_ms * (2 ** (evictions - 1)))
        delay *= 1.0 + self.backoff_jitter * self._jitter_rng.random()
        time.sleep(delay / 1e3)

    def _acquire(self, t: PlanTemplate, *, batch, group):
        runner, rels, _, _ = _acquire_runner(
            t.query,
            t.relations,
            t.plan_tree,
            agg=t.agg,
            options=t.options,
            filter_vars=t.filter_vars,
            batch=batch,
            max_capacity=self._group_capacity_quota(group),
            cache=self._cache,
        )
        return runner, rels

    def _admit(self, t: PlanTemplate, group, cells: int) -> list[JoinRequest]:
        """Pre-run admission: measured cost first (a cost rejection must
        not count as admitted), then the planned-cells check: the capacity
        plan exists, the executor has not run yet, so either violation
        costs zero device work."""
        live: list[JoinRequest] = []
        ema = self.cost_ema_us.get(t.key)
        for req in group:
            try:
                self.admission.check_cost(req.tenant, ema)
                self.admission.check_plan(req.tenant, cells)
            except AdmissionError as e:
                self._reject(req, e)
            else:
                live.append(req)
        return live

    def _serve_group(self, template: PlanTemplate, group: list[JoinRequest]) -> None:
        t = template
        self._reap_deadlines(group)
        group = [r for r in group if not r.done]
        if not group:
            return
        live: list[JoinRequest] | None = None
        try:
            batch = self.slots if t.filter_vars else None
            runner, rels = self._acquire(t, batch=batch, group=group)
            live = self._admit(t, group, runner.cap_plan.cells())
            if not live:
                return
            if not t.filter_vars:
                self._dispatch_filterless(t, runner, rels, live)
            else:
                self._dispatch_batched(t, runner, rels, live, self.slots)
        except Exception as e:
            if not faults.recoverable(e):
                raise
            pending = [r for r in (group if live is None else live) if not r.done]
            if live is None:
                # the fault struck before admission (acquire): the cells
                # check needs a capacity plan that never materialized, so
                # admit on the cost quota alone before degrading
                pending = self._admit(t, pending, 0)
            self.faults_absorbed += 1
            self._degrade(t, pending, e)

    def _dispatch_filterless(self, t, runner, rels, live) -> None:
        # nothing varies per lane: one unbatched call answers everyone
        t0 = time.perf_counter()
        out = runner.run_relations(rels, reuse_tries=True)
        self._observe_cost(t.key, (time.perf_counter() - t0) * 1e6)
        self.dispatches += 1
        for req in live:
            req.result, req.done = out, True
            self.served += 1

    def _dispatch_batched(self, t, runner, rels, live, width: int, label=None) -> None:
        """Serve `live` in chunks of `width` lanes (one mask-mode dispatch
        each). CapacityQuotaError evicts the named lane, charges the
        OFFENDER's retry budget, backs off, and re-dispatches the rest
        against the same executor; the pending set strictly shrinks every
        round, so the loop terminates structurally."""
        evictions = 0
        evicted_by: dict[str, int] = {}
        pending = [r for r in live if not r.done]
        while pending:
            self._reap_deadlines(pending)
            pending = [r for r in pending if not r.done]
            if not pending:
                return
            lanes = pending[:width]
            consts = np.broadcast_to(lanes[0].consts, (width, len(t.filter_vars))).copy()
            for i, req in enumerate(lanes):
                consts[i] = req.consts  # dead slots keep lane 0's constants
            t0 = time.perf_counter()
            try:
                out = runner.run_relations(rels, reuse_tries=True, filter_consts=consts)
            except CapacityQuotaError as e:
                self._observe_cost(t.key, (time.perf_counter() - t0) * 1e6)
                self.dispatches += 1
                victim = (
                    lanes[e.lane]
                    if e.lane is not None and e.lane < len(lanes)
                    else lanes[0]
                )
                self.admission.reject_runtime(victim.tenant)
                self._reject(victim, e)
                pending.remove(victim)
                # the retry budget is the offender's: its max_retries bounds
                # how many eviction rounds ITS lanes may cause in this
                # group; past that, its remaining requests go wholesale
                n = evicted_by.get(victim.tenant, 0) + 1
                evicted_by[victim.tenant] = n
                if n > self.admission.quota(victim.tenant).max_retries:
                    for r in [p for p in pending if p.tenant == victim.tenant]:
                        self.admission.reject_runtime(r.tenant, reason="retries")
                        self._reject(
                            r,
                            AdmissionError(
                                "retry budget exhausted by repeated quota "
                                "evictions",
                                tenant=r.tenant,
                                reason="retries",
                            ),
                        )
                        pending.remove(r)
                evictions += 1
                self._backoff(evictions)
                continue
            self._observe_cost(t.key, (time.perf_counter() - t0) * 1e6)
            self.dispatches += 1
            for i, req in enumerate(lanes):
                req.result = int(out[i]) if t.agg == "count" else out[i]
                req.done = True
                req.degraded_to = label
                self.served += 1
                if label is not None:
                    self.degraded[label] += 1
            pending = [r for r in pending if not r.done]

    def _degrade(self, t, pending: list[JoinRequest], cause: Exception) -> None:
        """Walk the remaining ladder rungs for requests a recoverable fault
        left unserved: halved batch width (a fresh, narrower runner) ->
        unbatched kill mode -> the eager engine on the same device. A
        recoverable fault on the eager rung itself propagates: there is
        no rung below it."""
        half = self.slots // 2
        if t.filter_vars and half >= 1 and pending:
            try:
                runner, rels = self._acquire(t, batch=half, group=pending)
                self._dispatch_batched(t, runner, rels, pending, half, label="halved")
            except Exception as e:
                if not faults.recoverable(e):
                    raise
                self.faults_absorbed += 1
            pending = [r for r in pending if not r.done]
        if t.filter_vars and pending:
            try:
                runner, rels = self._acquire(t, batch=None, group=pending)
                for req in list(pending):
                    if req.done:
                        continue
                    t0 = time.perf_counter()
                    try:
                        out = runner.run_relations(
                            rels, reuse_tries=True, filter_consts=req.consts
                        )
                    except CapacityQuotaError as e:
                        self.admission.reject_runtime(req.tenant)
                        self._reject(req, e)
                        continue
                    self._observe_cost(t.key, (time.perf_counter() - t0) * 1e6)
                    self.dispatches += 1
                    req.result = int(out) if t.agg == "count" else out
                    req.done = True
                    req.degraded_to = "unbatched"
                    self.served += 1
                    self.degraded["unbatched"] += 1
            except Exception as e:
                if not faults.recoverable(e):
                    raise
                self.faults_absorbed += 1
            pending = [r for r in pending if not r.done]
        for req in pending:
            if not req.done:
                self._serve_eager(t, req)

    def _serve_eager(self, t, req: JoinRequest) -> None:
        """Ladder bottom: answer one request on the eager engine over
        live-row snapshots, on the template's device. agg=None results
        follow the eager contract ((bound, mult)) as the compiled one
        does."""
        filters = {v: int(c) for v, c in zip(t.filter_vars, req.consts)}
        tree = t.plan_tree if isinstance(t.plan_tree, BinaryPlan) else None
        rels = {a: relcache.live_relation(r) for a, r in t.relations.items()}
        out = free_join(
            t.query, rels, tree, agg=t.agg, filters=filters or None, device=t.options.device
        )
        req.result = int(out) if t.agg == "count" else out
        req.done = True
        req.degraded_to = "eager"
        self.served += 1
        self.degraded["eager"] += 1

    def _group_capacity_quota(self, group: list[JoinRequest]) -> int | None:
        """The runtime growth quota armed on the group's runner: the max of
        the members' per-node capacity quotas (the loosest bound; a raise
        still names the offending lane). None if no member carries one."""
        caps = [
            q.max_node_capacity
            for q in (self.admission.quota(r.tenant) for r in group)
            if q.max_node_capacity is not None
        ]
        return max(caps) if caps else None
