"""Straggler & failure monitoring (host-side control plane).

On a 1000+ node fleet the SPMD program itself cannot skip a slow host —
every collective is a barrier. What the control plane *can* do:
  1. detect stragglers from per-host step-time telemetry (robust z-score
     vs. the fleet median),
  2. decide to evict/replace hosts and trigger an elastic rescale
     (checkpoint -> new mesh -> restore; see checkpoint.py), and
  3. keep goodput accounting so the decision threshold is principled
     (evict when projected restart cost < projected straggler drag).

This module is that decision logic, kept pure/deterministic so it is
unit-testable without a fleet.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerPolicy:
    window: int = 20  # steps of telemetry per decision
    slow_factor: float = 1.5  # flag hosts slower than 1.5x fleet median
    min_flags: int = 3  # consecutive windows before eviction
    restart_cost_steps: float = 50.0  # checkpoint+rescale+restore, in steps


@dataclasses.dataclass
class HostState:
    flags: int = 0


class StragglerMonitor:
    def __init__(self, num_hosts: int, policy: StragglerPolicy | None = None):
        self.policy = policy or StragglerPolicy()
        self.hosts = [HostState() for _ in range(num_hosts)]
        self.history: list[np.ndarray] = []

    def observe(self, step_times: np.ndarray) -> dict:
        """step_times: (num_hosts,) seconds for the last window of steps.
        Returns {"slow": [host ids], "evict": [host ids]}."""
        med = float(np.median(step_times))
        slow = [
            i for i, t in enumerate(step_times) if t > self.policy.slow_factor * med
        ]
        evict = []
        for i, h in enumerate(self.hosts):
            if i in slow:
                h.flags += 1
            else:
                h.flags = 0
            if h.flags >= self.policy.min_flags and self._worth_evicting(step_times, i, med):
                evict.append(i)
                h.flags = 0
        self.history.append(step_times)
        return {"slow": slow, "evict": evict}

    def _worth_evicting(self, t: np.ndarray, host: int, med: float) -> bool:
        # drag per step if we keep the straggler (collectives run at its pace)
        drag = float(t[host]) - med
        if drag <= 0:
            return False
        # steps until restart pays for itself
        payback = self.policy.restart_cost_steps * med / drag
        horizon = 10 * self.policy.restart_cost_steps  # assume long jobs
        return payback < horizon


def reshard_plan(old_hosts: int, new_hosts: int, global_batch: int) -> dict:
    """Elastic rescale bookkeeping: new per-host batch and whether the
    global batch is preserved (it must be, for reproducibility)."""
    if global_batch % new_hosts:
        raise ValueError(f"global batch {global_batch} not divisible by {new_hosts} hosts")
    return {
        "per_host_batch": global_batch // new_hosts,
        "data_restart": "pure-function stream: continue at next step (data.py)",
        "checkpoint": "mesh-independent: restore with new shardings (checkpoint.py)",
    }
