from repro_torch.relational.relation import Relation
from repro_torch.relational.schema import Atom, Query

__all__ = ["Relation", "Atom", "Query"]
