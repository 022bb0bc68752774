"""Query schemas: atoms, full conjunctive queries, and the query hypergraph
(Sec 2.1). Acyclicity is alpha-acyclicity decided by GYO ear removal."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Atom:
    """An atom R(x1,...,xk). `alias` distinguishes self-joins (the paper
    renames duplicated relation names; we carry an explicit alias)."""

    name: str
    vars: tuple[str, ...]
    alias: str = ""

    def __post_init__(self):
        if not self.alias:
            object.__setattr__(self, "alias", self.name)
        if len(set(self.vars)) != len(self.vars):
            raise ValueError(f"atom {self.name} repeats a variable: {self.vars}")

    def __str__(self):
        return f"{self.alias}({','.join(self.vars)})"


@dataclass
class Query:
    """A full conjunctive query Q(x) :- R1(x1), ..., Rm(xm)."""

    atoms: list[Atom]
    head: tuple[str, ...] = field(default_factory=tuple)

    def __post_init__(self):
        aliases = [a.alias for a in self.atoms]
        if len(set(aliases)) != len(aliases):
            raise ValueError(f"duplicate atom aliases: {aliases}")
        allv = self.variables
        if not self.head:
            self.head = tuple(allv)

    @property
    def variables(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for a in self.atoms:
            for v in a.vars:
                seen.setdefault(v)
        return tuple(seen)

    def atom(self, alias: str) -> Atom:
        for a in self.atoms:
            if a.alias == alias:
                return a
        raise KeyError(alias)

    def hyperedges(self) -> dict[str, frozenset[str]]:
        return {a.alias: frozenset(a.vars) for a in self.atoms}

    def is_acyclic(self) -> bool:
        """GYO reduction: repeatedly remove ears. An edge e is an ear if its
        private vertices (vars in no other edge) plus vertices covered by some
        other single edge w account for all of e."""
        edges = {k: set(v) for k, v in self.hyperedges().items()}
        changed = True
        while changed and len(edges) > 1:
            changed = False
            for k in list(edges):
                others = [v for k2, v in edges.items() if k2 != k]
                rest = set().union(*others) if others else set()
                private = edges[k] - rest
                shared = edges[k] - private
                if not shared or any(shared <= o for o in others):
                    del edges[k]
                    changed = True
                    break
        return len(edges) <= 1

    def __str__(self):
        return ", ".join(str(a) for a in self.atoms)


def triangle_query() -> Query:
    """Q_tri(x,y,z) :- R(x,y), S(y,z), T(z,x)  (Example 2.1)."""
    return Query([Atom("R", ("x", "y")), Atom("S", ("y", "z")), Atom("T", ("z", "x"))])


def clover_query() -> Query:
    """Q_clover(x,a,b,c) :- R(x,a), S(x,b), T(x,c)  (Fig. 3)."""
    return Query([Atom("R", ("x", "a")), Atom("S", ("x", "b")), Atom("T", ("x", "c"))])
