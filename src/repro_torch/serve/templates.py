"""Plan templates: the canonical form a serving engine caches plans under.

Two tenants rarely send byte-identical queries — one writes
``Q() :- Edges1(x,y), Edges2(y,z)`` where another writes
``Q() :- E(x,y), F(y,z)`` over the same base relations, and both carry
their own selection constants (``x = 7`` vs ``x = 42``). Structurally
these are ONE query: same relations, same join shape, same head, same
*set* of filtered variables. `canonicalize` maps every member of that
equivalence class to a single `PlanTemplate`, so they share one binary
plan, one capacity plan, and one compiled executor:

* **alias alpha-renaming** — atoms are sorted by (relation name, vars)
  and re-aliased ``t0..tn`` in that order, erasing whatever names the
  tenant chose. Variables are NOT renamed: they are the relations'
  column names (``rel.columns[v]``), so they are already canonical —
  two queries over the same relations that disagree on variable names
  disagree on real schema, not on spelling.
* **constant lifting** — filters ``{var: const}`` contribute only their
  sorted var tuple to the template; the constants become a runtime
  int32 vector (`consts`) fed to the constant-parameterized executor.
  N queries differing only in constants hit one cache entry.

What does NOT collapse (by construction of `key`): different head
projections, different aggregates, different ExecOptions, a different
explicit plan tree, different filtered-var sets, and different base
relation objects (identity via id(), made safe by the runner cache's
weakref finalizers) all produce distinct templates.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.api import ExecOptions
from repro_torch.core.plan import BinaryPlan
from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query


@dataclass(frozen=True, eq=False)
class PlanTemplate:
    """A canonicalized query ready for template-keyed serving: the
    alpha-renamed query/relations/plan plus the hashable `key` the engine
    groups and caches by. `filter_vars` is the sorted tuple of filtered
    variables; per-request constants live OUTSIDE the template (see
    `canonicalize`'s second return value)."""

    key: tuple
    query: Query = field(hash=False)
    relations: dict[str, Relation] = field(hash=False)
    plan_tree: BinaryPlan | Atom | None = field(hash=False)
    filter_vars: tuple[str, ...]
    agg: str | None
    options: ExecOptions

    def __eq__(self, other):
        return isinstance(other, PlanTemplate) and self.key == other.key

    def __hash__(self):
        return hash(self.key)


def _plan_sig(tree, alias_map: dict[str, str]):
    """Deterministic render of a binary plan tree under canonical aliases
    (None stays None: both sides will let the optimizer pick, and the
    optimizer is deterministic given the canonical query + stats)."""
    if tree is None:
        return None

    def go(node):
        if isinstance(node, Atom):
            return f"{node.name}:{alias_map[node.alias]}({','.join(node.vars)})"
        return f"({go(node.left)} {go(node.right)})"

    return go(tree)


def _rebuild_plan(tree, canon: dict[str, Atom]):
    if tree is None or isinstance(tree, Atom):
        return canon[tree.alias] if isinstance(tree, Atom) else None
    return BinaryPlan(_rebuild_plan(tree.left, canon), _rebuild_plan(tree.right, canon))


def recanonicalize(template: PlanTemplate) -> tuple[PlanTemplate, np.ndarray]:
    """Run `canonicalize` over a template's own canonical query (with
    placeholder constants). Canonicalization must be a fixed point —
    ``recanonicalize(t).key == t.key`` — or two spellings of one query can
    land on distinct template keys and each build their own executor.
    The static verifier (repro_torch.analysis) checks this per template;
    keeping the probe here keeps it honest against the real `canonicalize`."""
    return canonicalize(
        template.query,
        template.relations,
        dict.fromkeys(template.filter_vars, 0),
        plan_tree=template.plan_tree,
        agg=template.agg,
        options=template.options,
    )


def canonicalize(
    query: Query,
    relations: dict[str, Relation],
    filters: dict[str, int] | None = None,
    *,
    plan_tree: BinaryPlan | Atom | None = None,
    agg: str | None = "count",
    options: ExecOptions | None = None,
) -> tuple[PlanTemplate, np.ndarray]:
    """Canonicalize one request into (template, consts).

    `consts` is the request's int32 constant vector in `filter_vars`
    (sorted) order — the only per-request payload left after
    canonicalization, and exactly the `filter_consts` argument of the
    template's compiled runner."""
    options = options or ExecOptions()
    filters = dict(filters or {})
    unknown = set(filters) - set(query.variables)
    if unknown:
        raise ValueError(f"filter vars not in the query: {sorted(unknown)}")
    # alias alpha-renaming: sort atoms structurally, re-alias t0..tn.
    # Ties (true self-joins: same relation name AND same vars) keep input
    # order — the tied atoms are interchangeable precisely when their
    # backing relations match, which the key's id() component checks.
    order = sorted(range(len(query.atoms)),
                   key=lambda i: (query.atoms[i].name, query.atoms[i].vars))
    canon: dict[str, Atom] = {}
    atoms: list[Atom] = []
    for rank, i in enumerate(order):
        a = query.atoms[i]
        ca = Atom(a.name, a.vars, f"t{rank}")
        canon[a.alias] = ca
        atoms.append(ca)
    # head ORDER is an artifact of atom order (the default head lists vars
    # by first appearance), and execution depends only on the head SET —
    # agg=None results are var-keyed dicts, project in any order you like.
    # Re-ordering it into canonical variable order makes two spellings of
    # the same projection one template; a different head *set* still splits.
    hset = set(query.head)
    chead = tuple(v for v in Query(atoms).variables if v in hset)
    cquery = Query(atoms, head=chead)
    crels = {canon[a.alias].alias: relations[a.alias] for a in query.atoms}
    alias_map = {old: ca.alias for old, ca in canon.items()}
    cplan = _rebuild_plan(plan_tree, canon)
    filter_vars = tuple(sorted(filters))
    key = (
        tuple((a.name, a.vars, a.alias) for a in atoms),
        cquery.head,
        agg,
        options,
        filter_vars,
        _plan_sig(plan_tree, alias_map),
        tuple(sorted((al, id(r)) for al, r in crels.items())),
    )
    consts = np.asarray([filters[v] for v in filter_vars], np.int32)
    template = PlanTemplate(
        key=key,
        query=cquery,
        relations=crels,
        plan_tree=cplan,
        filter_vars=filter_vars,
        agg=agg,
        options=options,
    )
    return template, consts
