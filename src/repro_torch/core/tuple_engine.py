"""Tuple-at-a-time Free Join (Fig. 7) with optional batched probing
(Fig. 13). This is the paper's literal execution model — recursive, one
tuple (or one batch of `batch_size` tuples) per iteration — kept for the
vectorization ablation (Fig. 18) and as a semantic cross-check of the
full-batch engine. It shares the Colt structures; probes go through the
same batched `probe` with small batches. Each batch's columns, group ids
and probe results are read back to the host once, and the recursion walks
those host copies.
"""
from __future__ import annotations

import torch

from repro_torch.core.colt import Colt
from repro_torch.core.plan import FreeJoinPlan

_I32 = torch.int32


def execute_tuples(
    plan: FreeJoinPlan,
    relations,
    *,
    mode: str | dict = "colt",
    batch_size: int = 1000,
    dynamic_cover: bool = True,
    device="cuda",
):
    """Returns the list of output tuples ordered by plan.query.head."""
    plan.validate()
    parts = plan.partitions()
    modes = mode if isinstance(mode, dict) else {a: mode for a in parts}
    device = torch.device(device)
    tries = {
        alias: Colt(relations[alias], parts[alias], mode=modes.get(alias, "colt"),
                    filtered=False, device=device)
        for alias in parts
    }
    head = plan.query.head
    out: list[tuple] = []
    leaf_host: dict[str, tuple] = {}  # alias -> (leaf_offsets, its host copy)

    def leaf_count(alias: str, g: int) -> int:
        t = tries[alias]
        cached = leaf_host.get(alias)
        if cached is None or cached[0] is not t.leaf_offsets:
            cached = (t.leaf_offsets, t.leaf_offsets.cpu().tolist())
            leaf_host[alias] = cached
        return cached[1][g + 1] - cached[1][g]

    def full(n: int, value: int) -> torch.Tensor:
        return torch.full((n,), value, dtype=_I32, device=device)

    # state: per-alias (depth, gid); bound: var -> value
    def join(k: int, bound: dict, state: dict):
        if k == len(plan.nodes):
            # bag semantics: multiply leftover leaf multiplicities
            m = 1
            for alias, (d, g) in state.items():
                if d == tries[alias].L and g is not None:
                    m *= leaf_count(alias, g)
            row = tuple(bound[v] for v in head)
            out.extend([row] * m)
            return
        subs = [sa for sa in plan.nodes[k] if sa.vars]
        if not subs:
            join(k + 1, bound, state)
            return
        covers = [sa for sa in plan.covers(k) if sa.vars and any(sa is s for s in subs)]
        cover = covers[0]
        if dynamic_cover and len(covers) > 1:
            cover = min(
                covers,
                key=lambda sa: tries[sa.alias].key_count_estimate(state[sa.alias][0]),
            )
        probes = [sa for sa in subs if sa is not cover]
        t = tries[cover.alias]
        d, g = state[cover.alias]
        fr, cols, new_gids = t.iter_expand(d, full(1, g if g is not None else 0))
        n = fr.shape[0]
        # iterate in batches of batch_size (Fig. 13)
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            tup_cols = {v: c[lo:hi] for v, c in zip(cover.vars, cols)}
            alive = torch.ones(hi - lo, dtype=torch.bool, device=device)
            # semijoin-filter vars the cover re-binds (see engine.py)
            for v in cover.vars:
                if v in bound:
                    alive &= tup_cols[v] == bound[v]
            probe_results: dict[str, torch.Tensor] = {}
            for sa in probes:
                pt = tries[sa.alias]
                pd, pg = state[sa.alias]
                keys = [tup_cols[v] if v in tup_cols else full(hi - lo, bound[v])
                        for v in sa.vars]
                res = pt.probe(pd, full(hi - lo, pg if pg is not None else 0), keys)
                alive &= res >= 0
                probe_results[sa.alias] = res
            # one read-back of the batch, then the recursion runs on the host
            h_cols = {v: c.cpu().tolist() for v, c in tup_cols.items()}
            h_ng = new_gids[lo:hi].cpu().tolist() if new_gids is not None else None
            h_alive = alive.cpu().tolist()
            h_res = {a: r.cpu().tolist() for a, r in probe_results.items()}
            for j in range(hi - lo):
                if not h_alive[j]:
                    continue
                b2 = dict(bound)
                for v in cover.vars:
                    b2[v] = h_cols[v][j]
                s2 = dict(state)
                s2[cover.alias] = (d + 1, h_ng[j] if h_ng is not None else None)
                for sa in probes:
                    pd, _ = state[sa.alias]
                    s2[sa.alias] = (pd + 1, h_res[sa.alias][j])
                join(k + 1, b2, s2)

    state0 = {alias: (0, 0) for alias in parts}
    join(0, {}, state0)
    return out
