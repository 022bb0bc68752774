"""Free Join plans (Sec 3.2) and the plan pipeline of Sec 4.1:
binary plan -> binary2fj (Fig. 9) -> factor (Fig. 10).

A plan is a list of *nodes*; each node is a list of *subatoms* R(y).
The nodes must partition every atom's variables (Def 3.5), and a valid plan
(Def 3.7) requires (a) no two subatoms in one node share a relation and
(b) each node has a cover: a subatom containing all vars new to that node.

A *seeded* plan (`seed_plan`) serves a point query: its first node holds
the filter variables, bound by the request's constants before the plan
runs, so that node has no cover and only probes.

A *split* plan (`split_lookups`) cuts a lookup whose variables are partly
bound before its node into its bound part, probed one node earlier, and
its rest, a further cover of the node: `K3(c,a)` under new var `c`
becomes `K3(a)` in the node before and `K3(c)` beside the cover `K2(c)`,
the Generic Join shape of that node. The plan lists such nodes in
`lane_choice`: the executor lets each lane iterate whichever of the
node's covers holds the fewest keys under it and probe the others.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.relational.schema import Atom, Query


@dataclass(frozen=True)
class Subatom:
    alias: str
    vars: tuple[str, ...]

    def __str__(self):
        return f"{self.alias}({','.join(self.vars)})"


@dataclass
class FreeJoinPlan:
    query: Query
    nodes: list[list[Subatom]]
    # node 0 holds vars bound by constants before the plan runs (seed_plan)
    seeded: bool = False
    # nodes whose lanes each iterate the cover with the fewest keys under
    # them (split_lookups), written {...} in str(plan)
    lane_choice: tuple[int, ...] = ()

    def __str__(self):
        def node(k, n):
            body = ", ".join(map(str, n))
            return "{" + body + "}" if k in self.lane_choice else "[" + body + "]"

        body = "[" + ", ".join(node(k, n) for k, n in enumerate(self.nodes)) + "]"
        return "seeded " + body if self.seeded else body

    def choice_covers(self, k: int) -> list[Subatom]:
        """The covers a lane of lane-choice node k chooses among: its
        subatoms whose vars are exactly the node's new vars."""
        new = self.vs(k) - self.avs(k)
        return [sa for sa in self.nodes[k] if sa.vars and set(sa.vars) == new]

    # ---- derived info -------------------------------------------------
    def vs(self, k: int) -> set[str]:
        return {v for sa in self.nodes[k] for v in sa.vars}

    def avs(self, k: int) -> set[str]:
        out: set[str] = set()
        for j in range(k):
            out |= self.vs(j)
        return out

    def covers(self, k: int) -> list[Subatom]:
        """Subatoms of node k containing all vars in vs(k) - avs(k)."""
        new = self.vs(k) - self.avs(k)
        return [sa for sa in self.nodes[k] if new <= set(sa.vars)]

    def partitions(self) -> dict[str, list[tuple[str, ...]]]:
        """alias -> list of var-groups in node order (the GHT schema,
        Sec 3.3 build phase, before the trailing [] / cover-last rule)."""
        out: dict[str, list[tuple[str, ...]]] = {a.alias: [] for a in self.query.atoms}
        for node in self.nodes:
            for sa in node:
                if sa.vars:
                    out[sa.alias].append(sa.vars)
        return out

    # ---- validity (Def 3.5 + Def 3.7) ---------------------------------
    def violations(self):
        """Yield every validity violation as (rule, locus, message) without
        raising: rule is a stable identifier ("plan-not-partitioning" |
        "node-repeats-relation" | "node-missing-cover"), locus the atom
        alias or node index it anchors to. `validate` raises on the first;
        a static verifier can report them all."""
        for atom in self.query.atoms:
            got = [
                v for node in self.nodes for sa in node if sa.alias == atom.alias for v in sa.vars
            ]
            if sorted(got) != sorted(atom.vars) or len(set(got)) != len(got):
                yield (
                    "plan-not-partitioning",
                    atom.alias,
                    f"plan does not partition atom {atom}: got {got} for vars {atom.vars}",
                )
        for k, node in enumerate(self.nodes):
            aliases = [sa.alias for sa in node]
            if len(set(aliases)) != len(aliases):
                yield ("node-repeats-relation", k, f"node {k} repeats a relation: {node}")
            if not (self.seeded and k == 0) and not self.covers(k):
                yield (
                    "node-missing-cover",
                    k,
                    f"node {k} has no cover: new vars {self.vs(k) - self.avs(k)}",
                )
        for k in self.lane_choice:
            if not 0 <= k < len(self.nodes) or (self.seeded and k == 0) or len(
                self.choice_covers(k)
            ) < 2:
                yield (
                    "choice-without-covers",
                    k,
                    f"lane-choice node {k} has fewer than two covers of its new vars",
                )

    def validate(self) -> None:
        for _rule, _locus, message in self.violations():
            raise ValueError(message)

    def is_valid(self) -> bool:
        try:
            self.validate()
            return True
        except ValueError:
            return False


# ---------------------------------------------------------------------------
# Binary plans. A left-deep plan is a list of atoms [R1, ..., Rm].
# A bushy plan is a tree; we decompose it into left-deep stages (Sec 2.2).
# ---------------------------------------------------------------------------


@dataclass
class BinaryPlan:
    """A binary join plan tree. Leaves are atoms; internal nodes join two
    subplans. `decompose()` yields left-deep stages, materializing every
    right child that is itself a join (Sec 2.2)."""

    left: "BinaryPlan | Atom"
    right: "BinaryPlan | Atom"

    def decompose(self) -> list[tuple[str, list]]:
        """Returns stages [(stage_name, [leaf, ...])]. Leaves are Atoms or
        stage names (strings) referring to earlier materialized stages."""
        stages: list[tuple[str, list]] = []
        counter = [0]

        def go(node) -> list:
            if isinstance(node, Atom):
                return [node]
            chain = go(node.left)
            if isinstance(node.right, Atom):
                chain.append(node.right)
                return chain
            sub = go(node.right)
            counter[0] += 1
            name = f"__stage{counter[0]}"
            stages.append((name, sub))
            chain.append(name)
            return chain

        top = go(self)
        stages.append(("__root", top))
        return stages


def linear(atoms: list[Atom]) -> BinaryPlan:
    plan: BinaryPlan | Atom = atoms[0]
    for a in atoms[1:]:
        plan = BinaryPlan(plan, a)
    return plan  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Fig. 9: binary2fj — convert a left-deep plan to an equivalent Free Join plan
# ---------------------------------------------------------------------------


def binary2fj(left_deep: list[Atom], query: Query) -> FreeJoinPlan:
    r = left_deep[0]
    node: list[Subatom] = [Subatom(r.alias, tuple(r.vars))]
    fj: list[list[Subatom]] = []
    avs: set[str] = set(r.vars)
    for s in left_deep[1:]:
        probe_vars = tuple(v for v in s.vars if v in avs)
        node.append(Subatom(s.alias, probe_vars))
        fj.append(node)
        rest = tuple(v for v in s.vars if v not in avs)
        node = [Subatom(s.alias, rest)]
        avs |= set(s.vars)
    fj.append(node)
    plan = FreeJoinPlan(query, fj)
    plan.validate()
    return plan


# ---------------------------------------------------------------------------
# Fig. 10: factor — hoist fully-bound lookups into the previous node.
# Conservative: within a node, stop at the first lookup that cannot move
# (preserves the optimizer's lookup order). The node's cover never moves.
# ---------------------------------------------------------------------------


def factor(plan: FreeJoinPlan) -> FreeJoinPlan:
    nodes = [list(n) for n in plan.nodes]
    out = FreeJoinPlan(plan.query, nodes)
    for i in range(len(nodes) - 1, 0, -1):
        phi, prev = nodes[i], nodes[i - 1]
        avs = out.avs(i)
        for alpha in list(phi[1:]):  # lookups only; phi[0] is the cover
            if set(alpha.vars) <= avs and all(sa.alias != alpha.alias for sa in prev):
                phi.remove(alpha)
                prev.append(alpha)
            else:
                break  # conservative factoring
    out.nodes = [n for n in nodes if n]
    out.validate()
    return out


def seed_plan(plan: FreeJoinPlan, filter_vars) -> FreeJoinPlan | None:
    """The seeded plan of a point query whose `filter_vars` are bound by
    constants, built from its template's plan (no new plan choice): every
    atom whose first subatom holds a filter var has that subatom split,
    the filter vars into a leading node, which probes them from the
    constants, the rest where the subatom was. `t0(a,b)` becomes `t0(a)`,
    probed, then `t0(b)`, iterated under the group the probe found.
    Subatoms and nodes the split empties are dropped. None unless the
    first node's cover binds every filter var."""
    fv = set(filter_vars)
    cover = next(sa for sa in plan.covers(0) if sa.vars)
    if not fv or not fv <= set(cover.vars):
        return None
    first: dict[str, Subatom] = {}
    for node in plan.nodes:
        for sa in node:
            if sa.vars:
                first.setdefault(sa.alias, sa)
    seed: list[Subatom] = []
    nodes: list[list[Subatom]] = []
    kept_at: dict[int, int] = {}  # a node's index in the seeded plan
    for k, node in enumerate(plan.nodes):
        kept = []
        for sa in node:
            held = tuple(v for v in sa.vars if v in fv)
            if held and first[sa.alias] is sa:
                seed.append(Subatom(sa.alias, held))
                sa = Subatom(sa.alias, tuple(v for v in sa.vars if v not in fv))
                if not sa.vars:
                    continue
            kept.append(sa)
        if kept:
            nodes.append(kept)
            kept_at[k] = len(nodes)
    # lane-choice nodes keep their choice where the seed left them
    choice = tuple(kept_at[k] for k in plan.lane_choice if k in kept_at)
    out = FreeJoinPlan(plan.query, [seed] + nodes, seeded=True, lane_choice=choice)
    out.validate()
    return out


def split_lookups(plan: FreeJoinPlan) -> FreeJoinPlan | None:
    """The split form of `plan` (module docstring), or None where no
    lookup splits. A lookup of node k >= 1 splits when its vars hold all of
    the node's new vars and some bound before the node, its atom has no
    subatom in node k - 1, and the node keeps its first cover: the bound
    part is appended to node k - 1 as a probe, the rest stays in node k as
    a further cover, and node k becomes a lane-choice node."""
    if plan.seeded:
        return None
    nodes = [list(n) for n in plan.nodes]
    choice = set(plan.lane_choice)
    for k in range(1, len(nodes)):
        new = plan.vs(k) - plan.avs(k)
        if not new or k in choice:
            continue
        cover = next((sa for sa in plan.nodes[k] if sa.vars and set(sa.vars) == new), None)
        if cover is None:
            continue
        for i, sa in enumerate(nodes[k]):
            bound = tuple(v for v in sa.vars if v not in new)
            if sa is cover or not bound or not new <= set(sa.vars):
                continue
            if any(o.alias == sa.alias for o in nodes[k - 1]):
                continue
            nodes[k - 1].append(Subatom(sa.alias, bound))
            nodes[k][i] = Subatom(sa.alias, tuple(v for v in sa.vars if v in new))
            choice.add(k)
    if choice == set(plan.lane_choice):
        return None
    out = FreeJoinPlan(plan.query, nodes, lane_choice=tuple(sorted(choice)))
    out.validate()
    return out


# ---------------------------------------------------------------------------
# Generic Join plan: a total variable order -> all-singleton-var nodes
# (Example 3.6, Eq. 3).
# ---------------------------------------------------------------------------


def gj_plan(query: Query, var_order: list[str]) -> FreeJoinPlan:
    if sorted(var_order) != sorted(query.variables):
        raise ValueError(f"var order {var_order} != query vars {query.variables}")
    nodes: list[list[Subatom]] = []
    for v in var_order:
        node = [Subatom(a.alias, (v,)) for a in query.atoms if v in a.vars]
        nodes.append(node)
    plan = FreeJoinPlan(query, nodes)
    plan.validate()
    return plan


def var_order_from_fj(plan: FreeJoinPlan) -> list[str]:
    """Free Join defines only a partial order on vars; extend to a total
    order by node sequence then subatom order (Sec 5.1 footnote)."""
    seen: dict[str, None] = {}
    for node in plan.nodes:
        for sa in node:
            for v in sa.vars:
                seen.setdefault(v)
    return list(seen)


# ---------------------------------------------------------------------------
# Stage derivation: a (possibly bushy) binary plan tree -> per-stage Free
# Join plans, root last (Sec 2.2 decomposition + binary2fj + factor per
# stage). Shared by the eager drivers, the compiled chain, and the
# optimizer's device cost model.
# ---------------------------------------------------------------------------


def decompose_tree(plan_tree) -> list:
    """Stages of a plan tree; a bare Atom (single-atom query) is its own
    root stage."""
    if isinstance(plan_tree, Atom):
        return [("__root", [plan_tree])]
    return plan_tree.decompose()


def stage_plans(query: Query, plan_tree, *, factorize: bool = True):
    """Per-stage Free Join plans of a (possibly bushy) binary plan tree:
    [(name, fj_plan)], root last. Each stage's plan is built over its own
    sub-query (fj.query), whose head is the stage's output schema; later
    stages reference earlier ones by name as ordinary atoms."""
    stage_schemas: dict[str, tuple[str, ...]] = {}
    out = []
    for name, leaves in decompose_tree(plan_tree):
        atoms = [
            leaf if isinstance(leaf, Atom) else Atom(leaf, stage_schemas[leaf])
            for leaf in leaves
        ]
        sub_q = Query(atoms)
        fj = binary2fj(atoms, sub_q)
        if factorize:
            fj = factor(fj)
        stage_schemas[name] = sub_q.head
        out.append((name, fj))
    return out
