"""Serving on the port.

* **StandingQueryEngine** (standing.py) keeps registered join queries
  *answered* as base relations mutate through the relcache delta API
  (`append`/`delete`): each refresh recomputes only the plan stages whose
  input fingerprints moved (delta-merged tries from the versioned trie
  cache), replaying cached device buffers for the rest.
* **canonicalize** / **PlanTemplate** (templates.py) map alpha-equivalent
  spellings of one query, with their selection constants lifted out, to
  one template key, so they share per-stage runners.
"""
from repro_torch.serve.standing import StandingQuery, StandingQueryEngine
from repro_torch.serve.templates import PlanTemplate, canonicalize

__all__ = ["PlanTemplate", "StandingQuery", "StandingQueryEngine", "canonicalize"]
