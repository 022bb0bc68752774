"""Admission control for the join serving engine.

A multi-tenant engine's worst failure mode is not a slow query — it is a
query whose frontier buffers blow past their planned capacities, because
recovery (grow + rebuild + re-run) stalls every co-batched request
behind one tenant's pathology. Admission control converts that stall into
a bounded, attributable rejection, at four layers:

1. **pre-run** (`max_plan_cells`): the capacity planner's total
   buffer-cell count is known before the executor ever runs, so an
   oversized template is rejected with zero device work.
1b. **measured cost** (`max_dispatch_us`): the engine keeps a per-template
   EMA of measured dispatch wall time; a template that has *demonstrated*
   it costs more than the tenant's budget is rejected up front, even when
   its planned footprint looked innocent (planned cells can't see probe
   rounds, retry storms, or host overheads; the measurement can).
2. **runtime growth quota** (`max_node_capacity`): the adaptive runner
   refuses to grow any single node past this bound, raising
   `core.capacity.CapacityQuotaError` naming the offending batch lane;
   the engine evicts that one request and re-dispatches the rest against
   the *existing* executor (no regrowth).
3. **retry budget** (`max_retries`): eviction rounds are charged to the
   tenant that caused them — once a tenant's evictions in one group
   exceed its own max_retries, its remaining queued requests are
   rejected wholesale. Compliant co-batched tenants never pay: each
   eviction strictly shrinks the batch, so the dispatch loop terminates
   without ever spending an innocent tenant's budget.

Quotas are per-tenant (`AdmissionController.quota`), falling back to a
default; counters (`admitted`/`rejected`, and the per-tenant
`rejected_by`/`rejected_reasons` breakdowns) are the observable contract
the serving tests lock.
"""
from __future__ import annotations

from dataclasses import dataclass


class AdmissionError(RuntimeError):
    """A request was refused by admission control (quota violation)."""

    def __init__(self, msg: str, *, tenant: str = "default", reason: str = "quota"):
        super().__init__(msg)
        self.tenant = tenant
        self.reason = reason


@dataclass(frozen=True)
class QueryQuota:
    """Per-query resource quota. None disables a bound.

    max_plan_cells: ceiling on the capacity plan's total buffer cells
    (sum of per-node capacities across all stages), checked before the
    first run. max_node_capacity: ceiling any single frontier buffer
    may grow to at runtime (armed inside the adaptive runner). max_retries:
    quota-eviction rounds allowed per batched dispatch.
    max_dispatch_us: ceiling on the template's *measured* dispatch time
    (the engine's per-template EMA, microseconds) — planned cells say what
    a query should cost, the EMA says what it actually costs, and a
    template whose measured cost blew past the quota is rejected before
    joining another batch. A template's first-ever dispatch has no EMA and
    is admitted on the planned-cost checks alone."""

    max_plan_cells: int | None = None
    max_node_capacity: int | None = None
    max_retries: int = 3
    max_dispatch_us: float | None = None


class AdmissionController:
    """Per-tenant quota book-keeping: `quota(tenant)` resolves the
    effective QueryQuota, `check_plan(...)` performs the pre-run cells
    test, and admitted/rejected count every decision."""

    def __init__(
        self,
        default: QueryQuota | None = None,
        per_tenant: dict[str, QueryQuota] | None = None,
    ):
        self.default = default or QueryQuota()
        self.per_tenant = dict(per_tenant or {})
        self.admitted = 0
        self.rejected = 0
        # attribution: which tenant was rejected, and why (an eviction
        # storm must charge only its offender)
        self.rejected_by: dict[str, int] = {}
        self.rejected_reasons: dict[str, int] = {}

    def quota(self, tenant: str) -> QueryQuota:
        return self.per_tenant.get(tenant, self.default)

    def _count_reject(self, tenant: str, reason: str) -> None:
        self.rejected += 1
        self.rejected_by[tenant] = self.rejected_by.get(tenant, 0) + 1
        self.rejected_reasons[reason] = self.rejected_reasons.get(reason, 0) + 1

    def check_plan(self, tenant: str, plan_cells: int) -> None:
        """Pre-run admission: reject if the planned buffer footprint
        exceeds the tenant's cells quota. Raises AdmissionError (and counts
        the rejection); otherwise counts an admission."""
        q = self.quota(tenant)
        if q.max_plan_cells is not None and plan_cells > q.max_plan_cells:
            self._count_reject(tenant, "plan_cells")
            raise AdmissionError(
                f"plan footprint {plan_cells} cells exceeds tenant {tenant!r} "
                f"quota of {q.max_plan_cells}",
                tenant=tenant,
                reason="plan_cells",
            )
        self.admitted += 1

    def check_cost(self, tenant: str, measured_us: float | None) -> None:
        """Measured-cost admission: reject when the template's measured
        dispatch-time EMA exceeds the tenant's quota. Called BEFORE
        check_plan (a cost rejection must not count as admitted);
        measured_us=None (template never dispatched) always passes."""
        q = self.quota(tenant)
        if (
            q.max_dispatch_us is not None
            and measured_us is not None
            and measured_us > q.max_dispatch_us
        ):
            self._count_reject(tenant, "measured_cost")
            raise AdmissionError(
                f"measured dispatch cost {measured_us:.0f}us exceeds tenant "
                f"{tenant!r} quota of {q.max_dispatch_us:.0f}us",
                tenant=tenant,
                reason="measured_cost",
            )

    def reject_runtime(self, tenant: str, reason: str = "quota") -> None:
        """Count a runtime rejection — a growth-quota eviction (the raise
        site is the adaptive runner; the engine calls this when it evicts
        the lane), an exhausted retry budget, or a missed deadline."""
        self._count_reject(tenant, reason)
