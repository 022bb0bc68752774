"""State carried into the port from plain arrays and plain fields.

These helpers let a caller hand the port state that was made elsewhere —
host columns, the arrays of an already-built trie, a trie-cache entry of a
mutating relation, a capacity plan — so that the port's executor and its
delta merges can run on exactly the same trie and the same buffer sizes
as another implementation of the system. They read only
numpy arrays and attributes (duck typing); nothing here imports anything
but the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import relcache
from repro_torch.core.capacity import CapacityPlan, ChainCapacityPlan
from repro_torch.core.compiled import StaticTrie, TrieCache, _LevelOps
from repro_torch.core.optimizer import NodeEstimate
from repro_torch.kernels.ops import Table
from repro_torch.relational.relation import Relation


def relations_from_numpy(arrays: dict[str, dict[str, np.ndarray]]) -> dict[str, Relation]:
    """{alias: {var: column}} -> the port's Relations, one per alias."""
    return {alias: Relation(alias, dict(cols)) for alias, cols in arrays.items()}


def _tensor(a, device):
    return None if a is None else torch.as_tensor(np.array(a)).to(device)


def _tensors(seq, device):
    return None if seq is None else [_tensor(a, device) for a in seq]


def trie_from_arrays(lops, arrays, *, budget: int = 32, empty: bool = False,
                     device="cuda") -> StaticTrie:
    """A StaticTrie over given arrays instead of a build.

    lops: anything with `.levels` and `.probed`; arrays: the trie's
    fields, in order (cols, mult_col, total_mult, order, sorted_cols, g,
    kpos, child_base, child_counts, row_count, row_weight, tables), each
    numpy or None, tables as (slots, keys, max_disp) triples or None;
    `empty` marks a zero-row relation's one-sentinel-row trie."""
    (cols, mult_col, total_mult, order, sorted_cols, g, kpos, child_base,
     child_counts, row_count, row_weight, tables) = arrays
    device = torch.device(device)
    t = object.__new__(StaticTrie)
    t.lops = _LevelOps(tuple(tuple(lv) for lv in lops.levels), tuple(lops.probed))
    t.levels = t.lops.levels
    t.L = len(t.levels)
    t.budget = budget
    t.empty = empty
    t.cols = {v: _tensor(a, device) for v, a in cols.items()}
    t.n = next(iter(t.cols.values())).shape[0]
    t.mult_col = _tensor(mult_col, device)
    t.total_mult = _tensor(total_mult, device)
    t.trivial = t.L == 1 and not t.lops.probed[0]
    t.order = _tensor(order, device)
    t.sorted_cols = (
        None if sorted_cols is None else {v: _tensor(a, device) for v, a in sorted_cols.items()}
    )
    t.g = _tensors(g, device)
    t.kpos = _tensors(kpos, device)
    t.child_base = _tensors(child_base, device)
    t.child_counts = _tensors(child_counts, device)
    t.row_count = _tensors(row_count, device)
    t.row_weight = _tensors(row_weight, device)
    t.tables = None if tables is None else [
        None if tb is None else Table(*(_tensor(a, device) for a in tb)) for tb in tables
    ]
    return t


def trie_cache_entry_from_arrays(rel, lops, arrays, *, n_real: int, version: int,
                                 budget: int = 32, device="cuda") -> StaticTrie:
    """Install the trie-cache entry of a mutating relation from given
    arrays: the padded, weighted trie (fields as for trie_from_arrays)
    materialized at mutation `version`, whose first `n_real` rows are real
    (live or tombstoned) and the rest PAD_KEY pads. `rel` must carry a
    relcache mutation state at least at `version`; the next
    TRIE_CACHE.get of `rel` under this layout then replays the deltas
    after `version` onto this trie, exactly as onto one it built itself.
    Returns the installed trie."""
    trie = trie_from_arrays(lops, arrays, budget=budget, device=device)
    key = TrieCache.entry_key(trie.lops, device, budget)
    relcache.REGISTRY.namespace(rel, "tries")[key] = {
        "trie": trie,
        "cols": dict(trie.cols),
        "version": int(version),
        "n_real": int(n_real),
    }
    return trie


def _stage_plan(obj) -> CapacityPlan:
    return CapacityPlan(
        capacities=tuple(int(c) for c in obj.capacities),
        compact_to=tuple(None if c is None else int(c) for c in obj.compact_to),
        compact_probe=tuple(int(c) for c in obj.compact_probe),
        estimates=tuple(
            NodeEstimate(node=e.node, expand=e.expand, after=e.after,
                         probe_after=tuple(e.probe_after))
            for e in obj.estimates
        ),
        agm=tuple(float(a) for a in obj.agm),
        block=int(obj.block),
    )


def capacity_plan_from_reference(obj) -> CapacityPlan | ChainCapacityPlan:
    """Copy a capacity plan field by field: a chain plan (`names` +
    `stages`) or a single-stage plan. The schedule is not carried; the
    port's executor derives its own from the port's plan."""
    if hasattr(obj, "stages") and hasattr(obj, "names"):
        return ChainCapacityPlan(
            names=tuple(obj.names), stages=tuple(_stage_plan(s) for s in obj.stages)
        )
    return _stage_plan(obj)
