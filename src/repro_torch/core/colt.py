"""COLT: Column-Oriented Lazy Trie (Sec 4.2), vectorized, on tensors.

The paper's COLT is a pointer tree whose leaves are vectors of row offsets
into column storage, and whose hash-map nodes materialize lazily on first
`get`. A pointer tree does not vectorize, so each trie *level* is
flattened into contiguous tensors on the device:

  level d (forced):  unique (parent_group, key) pairs, stored as
                     parent[K], key_cols[K]; a hash table (the probe
                     kernel, K1) maps (parent, key) -> key-row; a CSR over
                     parents supports iteration. Key-row r at depth d IS
                     group r at depth d+1.
  leaf (unforced):   row offsets into the base columns, grouped by the
                     deepest forced level's groups (CSR). This is exactly
                     COLT's vector-of-offsets leaf, batched across all
                     sibling nodes of that depth.

Laziness: `force(depth, alive)` groups only the offsets whose parent group
is still alive in the current frontier — the vectorized analogue of COLT
materializing one sub-trie per probed key. Because every trie level is
consumed by exactly one Free Join plan node, a single filtered force per
level is exact. A relation that is only ever iterated at its last level
never builds anything (leaf identity; zero build cost for cover relations).

Variants (Fig. 17 ablation):
  mode="colt"   on-demand + alive-filtered forces (this paper)
  mode="slt"    level 0 forced eagerly, deeper levels on demand, unfiltered
                (simple lazy trie of Freitag et al. [7])
  mode="simple" all levels forced eagerly at build (classic Generic Join trie)

The base columns are the relation's int32 device upload
(compiled.device_columns, cached per relation object); a key column with a
value outside int32 is rejected.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import relcache
from repro_torch.core.compiled import device_columns
from repro_torch.relational.npkit import HashTable, csr_expand, group_by
from repro_torch.relational.relation import Relation

_I32 = torch.int32


def _check_int32(rel: Relation, names) -> None:
    """Raise ValueError if a key column holds a value outside int32 (the
    port's keys, tables and kernels are int32). Checked once per column
    object."""

    def in_range(host):
        return lambda: len(host) == 0 or (
            int(host.min()) >= -(2**31) and int(host.max()) <= 2**31 - 1
        )

    for v in names:
        host = rel.columns[v]
        if not relcache.memo(relcache.REGISTRY, rel, "int32_keys", v, host, in_range(host)):
            raise ValueError(f"relation {rel.name}: key column {v!r} has values outside int32")


class TrieLevel:
    """One forced trie depth: unique (parent, key) rows."""

    __slots__ = ("key_vars", "parent", "keys", "table", "koff", "num_keys")

    def __init__(self, key_vars, parent, keys, num_parents: int):
        self.key_vars = key_vars
        self.parent = parent  # (K,) sorted parent group ids
        self.keys = keys  # list per var, each (K,)
        self.table = HashTable([parent] + keys)
        # CSR: parent group -> contiguous key rows (parent-major lex order)
        self.koff = torch.searchsorted(
            parent, torch.arange(num_parents + 1, dtype=_I32, device=parent.device),
            out_int32=True,
        )
        self.num_keys = parent.shape[0]


class Colt:
    """A lazily-built trie over one relation, shaped by its plan partition."""

    def __init__(
        self,
        rel: Relation,
        level_vars: list[tuple[str, ...]],
        mode: str = "colt",
        filtered: bool = True,
        device="cuda",
    ):
        if mode not in ("colt", "slt", "simple"):
            raise ValueError(f"unknown trie mode {mode!r}")
        self.rel = rel
        self.level_vars = level_vars  # [y_0, ..., y_{L-1}]
        self.L = len(level_vars)
        self.mode = mode
        self.device = torch.device(device)
        _check_int32(rel, [v for lv in level_vars for v in lv])
        self.cols = device_columns(rel, self.device)
        # alive-filtered forcing is only exact when each level is consumed
        # once (full-batch engine); the tuple-at-a-time engine revisits
        # levels across recursive calls and must force whole levels.
        self.filtered = filtered and mode == "colt"
        self.levels: list[TrieLevel] = []  # forced depths 0..f-1
        # unforced leaf: rows grouped by depth-f groups. row_ids=None means
        # the identity [0..n) (no materialization — the base table itself).
        self.leaf_offsets = torch.tensor([0, rel.num_rows], dtype=_I32, device=self.device)
        self.leaf_rows: torch.Tensor | None = None
        self.build_ns = 0  # build-time accounting for the ablation
        if mode == "simple":
            while self.forced_depth < self.L:
                self.force(self.forced_depth)
        elif mode == "slt" and self.L > 0:
            self.force(0)

    # -- introspection ----------------------------------------------------
    @property
    def forced_depth(self) -> int:
        return len(self.levels)

    def num_groups(self, depth: int) -> int:
        if depth == 0:
            return 1
        return self.levels[depth - 1].num_keys

    def key_count_estimate(self, depth: int) -> int:
        """Sec 4.4: # keys if forced, else the vector length as an estimate."""
        if depth < self.forced_depth:
            return self.levels[depth].num_keys
        return self.rel.num_rows if self.leaf_rows is None else self.leaf_rows.shape[0]

    def iter_cost(self, depth: int, gids: torch.Tensor) -> int:
        """Exact number of rows `iter_expand(depth, gids)` would produce —
        the frontier-conditional refinement of Sec 4.4's fewest-keys rule
        (one read of the sum)."""
        if depth < self.forced_depth:
            off = self.levels[depth].koff
        elif depth == self.forced_depth:
            off = self.leaf_offsets
        else:
            raise ValueError("depth beyond frontier")
        return int((off[gids + 1] - off[gids]).sum(dtype=torch.int64))

    def gather(self, names, rows: torch.Tensor) -> list[torch.Tensor]:
        """The base columns `names` at row offsets `rows`."""
        return [self.cols[v][rows] for v in names]

    def _rows_of(self, member: torch.Tensor) -> torch.Tensor:
        return member if self.leaf_rows is None else self.leaf_rows[member]

    # -- forcing ----------------------------------------------------------
    def force(self, depth: int, alive: torch.Tensor | None = None) -> None:
        """Materialize trie depth `depth` (must equal forced_depth). With
        `alive` (sorted unique parent gids), only sub-tries of those parents
        are built — COLT's lazy expansion, batched."""
        t0 = time.perf_counter_ns()
        assert depth == self.forced_depth and depth < self.L
        ng = self.num_groups(depth)
        if alive is None or not self.filtered or alive.shape[0] >= ng:
            # all groups alive (or unfiltered mode): group every row directly
            rows = (
                torch.arange(self.rel.num_rows, dtype=_I32, device=self.device)
                if self.leaf_rows is None
                else self.leaf_rows
            )
            parent_of_row = torch.repeat_interleave(
                torch.arange(ng, dtype=_I32, device=self.device),
                torch.diff(self.leaf_offsets),
                output_size=rows.shape[0],
            )
        else:
            fr, member = csr_expand(self.leaf_offsets, alive)
            parent_of_row = alive[fr]
            rows = self._rows_of(member)
        key_cols = self.gather(self.level_vars[depth], rows)
        uniq, _, order, offsets = group_by([parent_of_row] + key_cols)
        level = TrieLevel(self.level_vars[depth], uniq[0], uniq[1:], ng)
        self.levels.append(level)
        self.leaf_rows = rows[order]
        self.leaf_offsets = offsets
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # time the build, not its enqueue
        self.build_ns += time.perf_counter_ns() - t0

    def _ensure(self, depth: int, alive_gids: torch.Tensor) -> None:
        if depth >= self.forced_depth:
            self.force(depth, torch.unique(alive_gids))

    # -- batched trie ops used by the engine -------------------------------
    def probe(self, depth: int, gids: torch.Tensor, key_cols: list[torch.Tensor]) -> torch.Tensor:
        """Batched get(): (group at `depth`, key) -> group at depth+1, or -1."""
        self._ensure(depth, gids)
        return self.levels[depth].table.probe([gids] + list(key_cols))

    def iter_expand(self, depth: int, gids: torch.Tensor):
        """Batched iter() over the sub-tries `gids` at `depth`.

        Returns (frontier_row_index, bound_cols, new_gids). If `depth` is the
        last level and unforced, iterates base rows directly (zero build) and
        new_gids is None (atom exhausted, multiplicity 1 per row). Otherwise
        iterates unique keys; new_gids index depth+1 groups.
        """
        if depth == self.L - 1 and depth >= self.forced_depth:
            fr, member = csr_expand(self.leaf_offsets, gids)
            return fr, self.gather(self.level_vars[depth], self._rows_of(member)), None
        self._ensure(depth, gids)
        lvl = self.levels[depth]
        fr, krow = csr_expand(lvl.koff, gids)
        return fr, [k[krow] for k in lvl.keys], krow

    def leaf_counts(self, gids: torch.Tensor) -> torch.Tensor:
        """Bag multiplicity below each depth-L group (duplicate tuples)."""
        return self.leaf_offsets[gids + 1] - self.leaf_offsets[gids]

    def subtree_sizes(self, depth: int, gids: torch.Tensor) -> torch.Tensor:
        """Number of base rows below each group at `depth` == the product of
        all remaining enumerations (used for factorized counting)."""
        if depth == self.forced_depth:
            return self.leaf_offsets[gids + 1] - self.leaf_offsets[gids]
        raise ValueError("subtree_sizes only available at the unforced frontier")

